"""The compile sites captured since the streamer and link_curve, on the CPU.

``graph.jit``'s inputs as trees: the signature of a call is its structure
and each tensor leaf's shape, strides, dtype and device, so a ``JRCState``
carried from call to call with new tensors keeps one key, and a new shape,
structure or fixed value is a new key. ``apply_targets`` on the scene's
``TargetArrays`` (``Targets.on``, what a captured dwell takes) gives the
tuple form's bits and ``jrc_tpu``'s echo within 1e-5 · max. A gloo mesh runs
the sharded and batched executors op by op (the rule: its collectives move
through the host), and they equal ``jrc_tpu``'s as before
(tests/test_torch_parallel.py holds them against the reference over 2 and 4
ranks). ``doppler_train`` with the captured estimate gives its eager run's
lines and estimates.

The reference app's Doppler estimator (``apps/jrc_trx.py:185-194``) is
compiled once per geometry with the first frame's LTF grid bound as a
default argument, while a DATA frame's LTF rows are precoded with that
frame's steering (``jrc_tpu/ops/precoder.py:282-295``). Two frames with a
burst each, the first on the Fourier fallback and the second steered by the
radar's detection, each with a train of two bursts: the first train's
estimates are the reference app's; on the second the reference estimates
against the first frame's grid and the port against the current one.
"""
import importlib.util
import sys
from contextlib import redirect_stdout
from io import StringIO
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jrc_tpu.models import jrc_trx as jjrc  # noqa: E402
from jrc_tpu.ops import channel as jchannel, cplx as cx, ofdm as jofdm  # noqa: E402
from jrc_tpu.ops import radar as jradar  # noqa: E402
from jrc_tpu_torch.apps import jrc_trx as app  # noqa: E402
from jrc_tpu_torch.config import MCS, PacketType  # noqa: E402
from jrc_tpu_torch.io.backend import SimTrx, TrxSession  # noqa: E402
from jrc_tpu_torch import tables  # noqa: E402
from jrc_tpu_torch.models import comm_link, jrc_trx  # noqa: E402
from jrc_tpu_torch.ops import channel  # noqa: E402
from jrc_tpu_torch.ops.encoder import FrameSpec, make_payload  # noqa: E402
from jrc_tpu_torch.parallel import mesh, streaming as pstream  # noqa: E402
from jrc_tpu_torch.utils import graph  # noqa: E402
from tests.torch_parity import CFG, JCFG, cplx, jit_reference, np_of, t  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SCENE = ((12.0, 5.0), (30.0, 0.0), (25.0, -20.0), (10.0, 3.0))


# ------------------------------------------------------------------ signature


def _key(*args, **kwargs):
    return graph.signature(args, kwargs)[0]


def test_a_carried_state_keeps_its_signature():
    """A JRCState with new tensors of the same shapes is the same key; its
    leaves are found in map_tensors' order."""
    s0 = jrc_trx.init_state(CFG, device="cpu")
    s1 = graph.map_tensors(torch.ones_like, s0)
    payload = torch.zeros(80, dtype=torch.uint8)
    assert _key(s0, payload, comm_noise_var=1e-4) == _key(s1, payload, comm_noise_var=1e-4)
    key, leaves = graph.signature((s1,), {})
    order = []
    graph.map_tensors(order.append, s1)
    assert len(leaves) == len(order) == 7 and all(a is b for a, b in zip(leaves, order))


@pytest.mark.parametrize("change", ["shape", "dtype", "strides", "structure", "fixed value",
                                    "kwarg name", "leaf type"])
def test_a_new_signature_is_a_new_key(change):
    x = torch.zeros(4, 6)
    state = jrc_trx.init_state(CFG, device="cpu")
    base = ((state, x), {"nv": 1e-4})
    args, kwargs = base
    if change == "shape":
        args = (state, torch.zeros(4, 7))
    elif change == "dtype":
        args = (state, x.double())
    elif change == "strides":
        args = (state, torch.zeros(6, 4).T)
    elif change == "structure":
        args = (state._replace(background=tuple(state.background)), x)
    elif change == "fixed value":
        kwargs = {"nv": 2e-4}
    elif change == "kwarg name":
        kwargs = {"noise": 1e-4}
    else:
        args = (state, [x])
    assert graph.signature(args, kwargs)[0] != graph.signature(*base)[0]


def test_a_captured_function_on_the_cpu_runs_eagerly_inside_eager():
    calls = []
    f = graph.jit(lambda s: calls.append(1) or s.frame_count + 1)
    state = jrc_trx.init_state(CFG, device="cpu")
    with graph.eager():
        assert int(f(state)) == 1
    assert int(f(state)) == 1 and calls == [1, 1] and not f._graphs


# ------------------------------------------------------------------ targets


@pytest.mark.parametrize("phase", [False, True], ids=["no-phase", "phase"])
def test_apply_targets_on_target_arrays(phase):
    """The scene as device tensors: the tuple form's bits, and jrc_tpu's echo
    within 1e-5 · max."""
    rng = np.random.default_rng(13)
    tx = cplx(rng, CFG.n_tx, 2160) * 0.1
    pos = channel.virtual_positions(CFG.n_tx, CFG.n_rx, channel.C_LIGHT / CFG.center_freq)
    key = jax.random.PRNGKey(3)
    draws = t(jax.random.uniform(key, (2,), minval=0.0, maxval=2 * np.pi)) if phase else None
    kw = dict(sample_rate=CFG.sample_rate, center_freq=CFG.center_freq, pos_virtual=t(pos),
              phase=draws, t0=1e-4)
    scene = channel.Targets(*SCENE)
    arrays = scene.on("cpu")
    assert isinstance(arrays, channel.TargetArrays) and arrays.ranges.dtype == torch.float32
    got = channel.apply_targets(t(tx), arrays, **kw)
    assert torch.equal(got, channel.apply_targets(t(tx), scene, **kw))
    want = np_of(jchannel.apply_targets(
        cx.from_complex(jnp.asarray(tx)), jchannel.Targets(*SCENE),
        sample_rate=JCFG.sample_rate, center_freq=JCFG.center_freq, pos_virtual=pos,
        rng_key=key if phase else None, t0=1e-4))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_jrc_step_on_target_arrays_equals_the_tuple_form():
    """One dwell with the scene as tensors (and comm_angle_deg the first
    azimuth as a 0-d tensor) gives the tuple form's result in every field."""
    trx = jrc_trx.JRCTrx(CFG, device="cpu")
    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=32, packet_type=PacketType.DATA)
    payload = torch.from_numpy(make_payload(spec, bytes([2]) + b"jrc"))
    n = (CFG.n_sync_words + 1 + CFG.n_ltf + spec.n_ofdm_sym + 8) * CFG.sym_len
    draws = comm_link.Draws(comm_noise=channel.normal_pair(
        (n,), generator=torch.Generator().manual_seed(2)))
    scene = channel.Targets((12.0,), (5.0,), (25.0,), (10.0,))
    out = [graph.signature((trx(trx.init_state(), spec, payload, s, draws=draws,
                                comm_noise_var=1e-4),), {})[1]
           for s in (scene, scene.on("cpu"))]
    assert len(out[0]) == len(out[1]) > 20
    for a, b in zip(*out):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ the mesh rule


def test_a_gloo_mesh_runs_the_executors_op_by_op():
    """On gloo the step is never captured: no captured function on the mesh,
    and the executors decode the bench frame as before."""
    from jrc_tpu_torch import capture
    from jrc_tpu_torch.models.streaming import frame_window_samples
    from jrc_tpu_torch.parallel import batch

    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=64, packet_type=PacketType.DATA)
    frame, _, halo = capture.load_bench_frame()
    cap, n_frames = capture.build_capture(frame, 2**14, halo=halo)
    with mesh.local_group("gloo"):
        tm, bm = mesh.time_mesh(device="cpu"), mesh.batch_mesh(device="cpu")
        block = pstream.local_block(tm, cap[: 2**14], device="cpu")
        assert not pstream.captures(tm, block)
        res = pstream.sharded_rx(CFG, spec, tm, block, max_frames_per_block=8)
        assert int(res.n_frames) == int(res.n_crc_ok) == n_frames
        w = 2**13 + frame_window_samples(CFG, spec) + CFG.fft_len
        counts = batch.batched_rx(bm, CFG, spec, np.stack([cap[:w], cap[2**13 : 2**13 + w]]),
                                  max_frames=4, device="cpu")
        assert counts.shape == (2, 2) and int(counts[:, 1].sum()) > 0
        assert not mesh.captured_steps(tm) and not mesh.captured_steps(bm)


# ------------------------------------------------------------------ the Doppler train


def test_doppler_train_with_the_captured_estimate_equals_eager():
    """A train of 8 bursts of a target at 150 m/s: the captured estimate's
    estimates and printed line are the eager estimate's."""
    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=32, packet_type=PacketType.DATA)
    payload = torch.from_numpy(make_payload(spec, bytes([2]) + b"doppler"))
    tab = tables.from_numpy(CFG, spec, "cpu")
    tx = comm_link.tx_frame(CFG, spec, tab, payload, 1, pad_front=5 * CFG.sym_len,
                            pad_tail=3 * CFG.sym_len)
    rtab = tables.radar_from_numpy(CFG, "cpu")
    out = {}
    for name, estimate in (("eager", app.ltf_estimate),
                           ("captured", graph.jit(app.ltf_estimate))):
        hist = []

        def recorded(*a, estimate=estimate, hist=hist):
            hist.append(estimate(*a))
            return hist[-1]

        session = TrxSession(SimTrx(CFG, channel.Targets((12.0,), (150.0,), (25.0,), (10.0,)),
                                    hw_delay_samps=24, device="cpu"),
                             update_period=0.0, num_delay_samps=24)
        burst = session.frame(tx.samples, 0.0)
        buf = StringIO()
        with redirect_stdout(buf):
            app.doppler_train(CFG, session, tx, burst.rx[..., 5 * CFG.sym_len:], rtab,
                              5 * CFG.sym_len, 24, 8, recorded)
        out[name] = (buf.getvalue(), torch.stack(hist))
    assert out["captured"][0] == out["eager"][0]
    assert out["eager"][0].startswith("  doppler train (8 frames): v=+")
    assert torch.equal(out["captured"][1], out["eager"][1])


def _reference_app():
    before = list(sys.path)
    spec = importlib.util.spec_from_file_location("ref_jrc_trx_sites", ROOT / "apps" / "jrc_trx.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.path[:] = before
    return mod


def test_the_reference_doppler_estimator_reads_the_first_frames_ltf_grid(monkeypatch, tmp_path):
    """Frames 0 and 1 each open a burst and a train of two (update period
    0.005 s, a frame every 0.01 s); frame 0 goes out on the Fourier
    fallback, frame 1 steered at the detected 25°, so their LTF rows differ.
    The reference app's estimator is compiled at frame 0 with frame 0's grid
    bound: on train 1 its estimates are the port's estimator's on the same
    bursts; on train 2 they are estimates against frame 0's grid, not frame
    1's. The port's app hands each train its own frame's grid."""
    jit_reference(monkeypatch)
    argv = ["--cpu", "--frames", "2", "--update-period", "0.005", "--doppler-frames", "2",
            "--target", "12:30:25:10", "--heatmap", ""]
    ref = {"grids": [], "estimators": [], "calls": []}
    real_jit, real_tx = jax.jit, jjrc.jrc_tx

    def recording_jit(fn, **kw):
        compiled = real_jit(fn, **kw)
        if getattr(fn, "__name__", "") != "<lambda>" or not fn.__defaults__:
            return compiled
        ref["estimators"].append(fn)

        def call(r):
            out = compiled(r)
            ref["calls"].append((np_of(r), np_of(out)))
            return out
        return call

    def recording_tx(*a, **kw):
        tx = real_tx(*a, **kw)
        ref["grids"].append(np_of(tx.grid))
        return tx

    monkeypatch.chdir(tmp_path)
    with monkeypatch.context() as mp, redirect_stdout(StringIO()) as buf:
        mp.setattr(jax, "jit", recording_jit)
        mp.setattr(jjrc, "jrc_tx", recording_tx)
        assert _reference_app().main(argv) == 0
    assert buf.getvalue().count("BURST") == 2

    port = {"x_sl": []}

    def recording_estimate(cfg, n_sym, x_sl, r):
        port["x_sl"].append(x_sl.clone())
        return app_estimate(cfg, n_sym, x_sl, r)

    app_estimate = app.ltf_estimate
    with monkeypatch.context() as mp, redirect_stdout(StringIO()) as buf:
        mp.setattr(app, "ltf_estimate", recording_estimate)
        assert app.main(argv, comm_noise=lambda d, n: _noise(d, n)) == 0
    assert buf.getvalue().count("BURST") == 2

    sl = slice(CFG.n_sync_words + 1, CFG.n_sync_words + 1 + CFG.n_ltf)
    grid0, grid1 = (g.transpose(1, 0, 2)[:, sl] for g in ref["grids"])
    assert np.abs(grid1 - grid0).max() > 0.1 * np.abs(grid0).max()  # the steering moved
    (estimator,) = ref["estimators"]  # one compile for the one geometry
    np.testing.assert_array_equal(np_of(estimator.__defaults__[0]), grid0)
    n_sym = ref["grids"][0].shape[0]
    assert len(ref["calls"]) == 4
    for k, (r, h_ref) in enumerate(ref["calls"]):
        grid = grid0 if k < 2 else grid1
        h_port = app.ltf_estimate(CFG, n_sym, t(grid), t(r)).numpy()
        h_now = np_of(jradar.radar_channel_estimate(
            cx.from_complex(jnp.asarray(grid)),
            jofdm.ofdm_demodulate(JCFG, cx.from_complex(jnp.asarray(r)), n_sym)[:, sl]))
        tol = 1e-5 * np.abs(h_now).max()
        np.testing.assert_allclose(h_port, h_now, rtol=0, atol=tol)
        if k < 2:  # train 1: the reference's estimator is the port's
            np.testing.assert_allclose(h_ref, h_port, rtol=0, atol=tol)
        else:  # train 2: the reference's estimates are against frame 0's grid
            assert np.abs(h_ref - h_now).max() > 1e3 * tol
    assert len(port["x_sl"]) == 4
    for k, x_sl in enumerate(port["x_sl"]):
        grid, other = (grid0, grid1) if k < 2 else (grid1, grid0)
        np.testing.assert_allclose(x_sl.numpy(), grid, rtol=0, atol=1e-5 * np.abs(grid).max())
        assert np.abs(x_sl.numpy() - other).max() > 0.1 * np.abs(other).max()


def _noise(d: int, n: int) -> torch.Tensor:
    _, k_comm = jax.random.split(jax.random.PRNGKey(d))
    return torch.from_numpy(np_of(jchannel.awgn(k_comm, cx.zeros((n,)), 2.0)).astype(np.complex64))
