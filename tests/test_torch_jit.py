"""The port's counterpart of ``jax.jit`` on the CPU, and what it needs there.

``utils.graph.jit`` runs a function as it is on CPU tensors (there is no
graph on a CPU); ``BlockStreamer(jit=True, device="cpu")`` gives what
``jit=False`` gives, field for field, on both wires, static and dynamic.
The dynamic demap without its host sync (every MCS branch over the whole
batch, each frame's row selected) against ``jrc_tpu``'s ``lax.switch``
under ``jax.jit(jax.vmap(...))``, as the reference runs it: hard values
exactly, soft LLRs within 1e-4 · max|LLR|. ``channel.awgn`` with the noise
variance as a 0-d float32 tensor (what a captured ``link_curve`` point reads)
gives the float's bits. The reference's two noise options that the port
now takes, ``comm_channel(noise_var=...)`` and ``zero_pad(noise_std=...)``:
the reference's noise, recovered as (its output with the key) − (its output
without) over its scale, handed to the port as ``noise=`` gives the
reference's output within 1e-6 · max. The state constructors resolve
``device=None`` to the card, and raise where there is none.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jrc_tpu.ops import channel as jchannel, cplx as cx, dynamic_rx as jdyn  # noqa: E402
from jrc_tpu.ops import ofdm as jofdm  # noqa: E402
from jrc_tpu_torch import capture, tables  # noqa: E402
from jrc_tpu_torch.config import MCS, PacketType  # noqa: E402
from jrc_tpu_torch.io.stream import BlockStreamer  # noqa: E402
from jrc_tpu_torch.models import jrc_trx  # noqa: E402
from jrc_tpu_torch.ops import channel, decoder, dynamic_rx, ofdm, radar  # noqa: E402
from jrc_tpu_torch.ops.encoder import FrameSpec  # noqa: E402
from jrc_tpu_torch.utils import graph  # noqa: E402
from tests.torch_parity import CFG, cplx, np_of, t  # noqa: E402

MAXP = 96


# ------------------------------------------------------------------ the helper


def test_helper_on_the_cpu_returns_what_the_function_returns():
    calls = []

    def fn(x, y, *, scale):
        calls.append(scale)
        return {"sum": x + y, "parts": (x * scale, [y])}

    jitted = graph.jit(fn)
    x, y = torch.arange(4.0), torch.ones(4)
    got = jitted(x, y, scale=2.0)
    want = fn(x, y, scale=2.0)
    assert calls == [2.0, 2.0]  # run as it is, once a call: no warm-up, no capture
    assert torch.equal(got["sum"], want["sum"]) and torch.equal(got["parts"][0], want["parts"][0])
    assert torch.equal(got["parts"][1][0], y)
    assert jitted.name == "test_helper_on_the_cpu_returns_what_the_function_returns.<locals>.fn"
    with pytest.raises(ValueError, match="one device"):
        jitted(x, y.to("meta"), scale=1.0)


def test_map_tensors_keeps_the_structure():
    res = dynamic_rx.DynamicPre(*(torch.full((2,), float(i))
                                  for i in range(len(dynamic_rx.DynamicPre._fields))))
    out = graph.map_tensors(lambda v: v + 1, {"a": res, "b": [torch.zeros(1), None, 3]})
    assert type(out["a"]) is dynamic_rx.DynamicPre
    assert all(torch.equal(v, torch.full((2,), i + 1.0)) for i, v in enumerate(out["a"]))
    assert out["b"][1] is None and out["b"][2] == 3 and torch.equal(out["b"][0], torch.ones(1))


# ------------------------------------------------------------- the dynamic demap


@pytest.fixture(scope="module")
def reference_values():
    """jrc_tpu's per-frame lax.switch, jitted and vmapped, hard and soft."""
    def run(soft):
        return jax.jit(jax.vmap(lambda zz, m, nb: jdyn.payload_values_dynamic(
            zz, m, nb, MAXP, soft=soft)))
    return {soft: run(soft) for soft in (False, True)}


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_payload_values_dynamic_without_host_sync_matches_the_switch(reference_values, soft):
    """Two frames of each MCS at different lengths, then mcs_idx −1 and 9
    (clamped to BPSK-1/2 and 16-QAM-3/4), in one shuffled batch."""
    rng = np.random.default_rng(31 + soft)
    mcs_idx = np.concatenate([np.repeat(np.arange(len(MCS)), 2), [-1, 9]])
    n_bytes = rng.integers(4, MAXP + 5, len(mcs_idx))
    order = rng.permutation(len(mcs_idx))
    mcs_idx, n_bytes = mcs_idx[order], n_bytes[order]
    max_n_sym = dynamic_rx.max_symbols(MAXP)
    z = cplx(rng, len(mcs_idx), max_n_sym, 48)
    n_sym, _ = jdyn.frame_geometry(jnp.clip(jnp.asarray(mcs_idx), 0, 5), jnp.asarray(n_bytes))
    z[np.arange(max_n_sym)[None, :] >= np.asarray(n_sym)[:, None]] = 0  # masked past n_sym
    tab = tables.from_numpy_dynamic(CFG, MAXP, "cpu")
    got = dynamic_rx.payload_values_dynamic(tab, t(z), t(mcs_idx), t(n_bytes), MAXP,
                                            soft=soft).numpy()
    want = np.asarray(reference_values[soft](cx.from_complex(z), jnp.asarray(mcs_idx, jnp.int32),
                                             jnp.asarray(n_bytes, jnp.int32)))
    assert got.shape == want.shape == (len(mcs_idx), 2 * dynamic_rx.max_trellis_bits(MAXP))
    if soft:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
        np.testing.assert_array_equal(got == 0, want == 0)  # the same erasures
    else:
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- the streamer


def _drain(results):
    return [{f: getattr(r, f).clone() for f in r._fields} for r in results]


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
@pytest.mark.parametrize("wire_name", ["fc32", "sc16"])
def test_streamer_jit_equals_eager_on_the_cpu(dynamic, wire_name):
    """Two superblocks of the bench frame and the flush's zero superblocks
    through jit=True and jit=False: the same results in every field."""
    frame, _, _ = capture.load_bench_frame()
    kw = dict(block_len=2**13, max_frames=4, max_payload=MAXP, wire=wire_name, device="cpu")
    spec = None if dynamic else FrameSpec(MCS.QPSK_3_4, payload_bytes=64,
                                          packet_type=PacketType.DATA)
    out = {}
    for jit in (True, False):
        s = BlockStreamer(CFG, spec, jit=jit, **kw)
        cap, n_frames = capture.build_capture(frame, 2 * s.span, halo=s.halo, seed=5)
        s.push(cap)
        out[jit] = (_drain(s.process_available()) + _drain(s.flush()), s.stats)
    (got, got_stats), (want, want_stats) = out[True], out[False]
    assert len(got) == len(want) >= 3
    for a, b in zip(got, want):
        for f in b:
            assert torch.equal(a[f], b[f]), f
    assert got_stats == want_stats and got_stats.crc_ok == n_frames


# ------------------------------------------------------------------ the noise


@pytest.mark.parametrize("nv", [1e-4, 0.05, 2.0, 3.3e-3])
def test_awgn_tensor_noise_var_gives_the_float_bits(nv):
    rng = np.random.default_rng(int(nv * 1e4))
    x, z = t(cplx(rng, 3, 257)), t(cplx(rng, 3, 257))
    nv32 = float(np.float32(nv))
    want = channel.awgn(x, nv32, noise=z)
    got = channel.awgn(x, torch.full((), nv32, dtype=torch.float32), noise=z)
    assert torch.equal(got, want)


def test_comm_channel_noise_var_matches_the_reference():
    """The reference's AWGN recovered from its outputs with and without a key,
    over sqrt(noise_var/2), through the port's comm_channel as ``noise``."""
    rng = np.random.default_rng(8)
    tx = cplx(rng, 4, 300)
    kw = dict(angle_deg=17.0, path_loss=10.0, noise_var=0.02, cfo=0.003)
    with_key = np_of(jchannel.comm_channel(cx.from_complex(tx), rng_key=jax.random.PRNGKey(4),
                                           **kw))
    without = np_of(jchannel.comm_channel(cx.from_complex(tx), **kw))
    std = np.sqrt(np.float32(0.02) / np.float32(2.0))
    noise = t(((with_key - without) / std).astype(np.complex64))
    got = channel.comm_channel(t(tx), noise=noise, **kw).numpy()
    np.testing.assert_allclose(got, with_key, rtol=0, atol=1e-6 * np.abs(with_key).max())
    # no noise without a draw, as the reference adds none without a key
    np.testing.assert_array_equal(channel.comm_channel(t(tx), **kw).numpy(),
                                  channel.comm_channel(t(tx), **dict(kw, noise_var=0.0)).numpy())
    # drawn from a generator: the same as the generator's normal pairs handed in
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    drawn = channel.comm_channel(t(tx), generator=gen(), **kw)
    given = channel.comm_channel(t(tx), noise=channel.normal_pair((300,), generator=gen()), **kw)
    assert torch.equal(drawn, given)


def test_zero_pad_noise_std_matches_the_reference():
    rng = np.random.default_rng(9)
    x = cplx(rng, 2, 160)
    with_key = np_of(jofdm.zero_pad(cx.from_complex(x), 80, 90, rng_key=jax.random.PRNGKey(6),
                                    noise_std=0.3))
    without = np_of(jofdm.zero_pad(cx.from_complex(x), 80, 90, noise_std=0.3))
    scale = np.float32(0.3 / np.sqrt(2.0))
    pad = (with_key - without) / scale
    noise = t(np.concatenate([pad[:, :80], pad[:, -90:]], axis=-1).astype(np.complex64))
    got = ofdm.zero_pad(t(x), 80, 90, noise_std=0.3, noise=noise).numpy()
    np.testing.assert_allclose(got, with_key, rtol=0, atol=1e-6 * np.abs(with_key).max())
    np.testing.assert_array_equal(got[:, 80:240], x)
    np.testing.assert_array_equal(ofdm.zero_pad(t(x), 80, 90).numpy(), without)
    gen = lambda: torch.Generator().manual_seed(2)  # noqa: E731
    assert torch.equal(ofdm.zero_pad(t(x), 80, 90, generator=gen()),
                       ofdm.zero_pad(t(x), 80, 90, noise=channel.normal_pair((2, 170),
                                                                             generator=gen())))


# ------------------------------------------------------------ device default


@pytest.mark.parametrize("make", [
    lambda device: jrc_trx.init_state(CFG, device=device),
    lambda device: jrc_trx.state_from_numpy(
        jrc_trx.state_to_numpy(jrc_trx.init_state(CFG, device="cpu")), device=device),
    lambda device: radar.init_background(4, CFG.n_virtual, CFG.fft_len, device=device),
    lambda device: decoder.init_stats(device=device),
], ids=["init_state", "state_from_numpy", "init_background", "init_stats"])
def test_state_constructors_default_to_the_card(make):
    """device=None is the CUDA device, as for every entry point: without a
    card that raises (no silent CPU state); device="cpu" builds on the CPU."""
    leaves = graph.map_tensors(lambda v: v.device, tuple(make("cpu")))
    assert all(d == torch.device("cpu") for d in _flat(leaves))
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in _flat(graph.map_tensors(lambda v: v.device,
                                                                      tuple(make(None)))))
    else:
        with pytest.raises(RuntimeError, match="CUDA device"):
            make(None)


def _flat(tree):
    if isinstance(tree, (tuple, list)):
        return [x for item in tree for x in _flat(item)]
    return [tree]
