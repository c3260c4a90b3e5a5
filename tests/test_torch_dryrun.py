"""The port's multi-rank dry run (jrc_tpu_torch.parallel.dryrun), its
teardown (parallel.mesh.teardown) and comm_rx --mesh over torchrun-style
processes, on the CPU.

The dry run's launcher starts 2 and 4 gloo ranks (``--cpu``, one thread
each) once, before the first test, so that they run while the reference
compiles. Rank 0's gathered fields are held against jrc_tpu.parallel's
``sharded_rx``, ``sharded_rx_dynamic``, ``batched_rx`` and
``batched_range_angle_maps`` on the same captures, on a CPU mesh of the
same size (conftest.py's virtual devices), as ``__graft_entry__.
dryrun_multichip`` runs them.

Tolerances: valid, start, CRC, payload, SIG, MCS, packet type, length and
the counts exactly equal; SNRs within 1e-2 dB on valid slots (the frames
lie about 70 dB over the noise, where float32's rounding of the residual
alone moves an estimate by about 2e-3 dB: 2 · 6e-8 · 10^(70/20) in power);
the maps
within 1e-5 · max of the map; the capture within 1e-5 · max|frame| of the
one built with the reference's TX chain.
"""
import os
import socket
import subprocess
import sys
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jrc_tpu.models import comm_link as jcomm  # noqa: E402
from jrc_tpu.ops import channel as jchannel  # noqa: E402
from jrc_tpu.ops.encoder import make_payload as jmake_payload  # noqa: E402
from jrc_tpu.parallel import batch as jbatch, mesh as jmesh, streaming as jps  # noqa: E402
from jrc_tpu_torch.parallel import dryrun, mesh as pmesh, streaming as pstream  # noqa: E402
from jrc_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from tests.torch_parity import CFG, CHILD_ENV, JCFG, specs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLDS = (2, 4)
LIMIT_S = 120  # the launcher's limit for every rank


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Each world's launcher, started together in a thread each → {world:
    (future of its completed process, out npz)}."""
    d = tmp_path_factory.mktemp("dryrun")
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        runs = {}
        for world in WORLDS:
            out = d / f"rank0_{world}.npz"
            runs[world] = (pool.submit(
                subprocess.run, [sys.executable, "-m", "jrc_tpu_torch.parallel.dryrun", "--cpu",
                                 "--world", str(world), "--timeout", str(LIMIT_S), "--out",
                                 str(out)],
                cwd=ROOT, capture_output=True, text=True, timeout=LIMIT_S + 30,
                env=dict(os.environ, **CHILD_ENV)), out)
        yield runs


def _finished(launched, world: int) -> tuple[str, dict]:
    """(the launcher's output, rank 0's fields) once it has exited 0."""
    run, out = launched[world]
    p = run.result()
    text = p.stdout + p.stderr
    assert p.returncode == 0, text[-3000:]
    with np.load(out) as f:
        return text, {k: f[k] for k in f}


def _reference(world: int):
    """jrc_tpu's three steps of dryrun_multichip and its batched maps, on the
    port's captures, over a CPU mesh of ``world`` devices."""
    spec, payload, cap, caps = dryrun.captures(CFG, world)
    jspec = specs(spec.mcs, spec.payload_bytes)[1]
    mesh = jps.make_time_mesh(world)
    return {
        "sharded": jps.sharded_rx(JCFG, jspec, mesh, jnp.asarray(cap), max_frames_per_block=4),
        "dynamic": jps.sharded_rx_dynamic(JCFG, mesh, jnp.asarray(cap), max_frames_per_block=4,
                                          max_payload=dryrun.MAX_PAYLOAD),
        "batched": jbatch.batched_rx(jmesh.batch_mesh(world), JCFG, jspec, jnp.asarray(caps),
                                     max_frames=2),
        "maps": jbatch.batched_range_angle_maps(jmesh.batch_mesh(world),
                                                jnp.asarray(dryrun.channel_estimates(CFG, world))),
    }


@pytest.fixture(scope="module")
def references(launched):
    """Each world's reference, compiled in threads while the ranks run."""
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        yield {world: pool.submit(_reference, world) for world in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_prints_its_line_and_exits(launched, world):
    text, _ = _finished(launched, world)
    rows = ";".join(["1,1"] * world)
    for r in range(world):
        assert (f"DRYRUN_OK rank={r} world={world} backend=gloo frames={world} crc_ok={world} "
                f"dynamic_frames={world} dynamic_crc_ok={world} batched={rows} ") in text, text
    assert f"dry run ok: {world} gloo ranks" in text


@pytest.mark.parametrize("path,fields,floats", [
    ("sharded", ("valid", "start", "crc_ok", "payload", "n_frames", "n_crc_ok"), ("snr_db",)),
    ("dynamic", ("valid", "start", "crc_ok", "payload", "payload_len", "sig_ok", "mcs",
                 "packet_type_bit", "chan_est_ok", "n_frames", "n_crc_ok"),
     ("snr_db", "snr_data_db")),
], ids=["sharded_rx", "sharded_rx_dynamic"])
@pytest.mark.parametrize("world", WORLDS)
def test_gathered_fields_equal_the_reference(launched, references, world, path, fields, floats):
    _, got = _finished(launched, world)
    ref = references[world].result()[path]
    for f in fields:
        np.testing.assert_array_equal(got[f"{path}_{f}"], np.asarray(getattr(ref, f)), err_msg=f)
    valid = got[f"{path}_valid"]
    assert int(valid.sum()) == world
    for f in floats:
        np.testing.assert_allclose(got[f"{path}_{f}"][valid], np.asarray(getattr(ref, f))[valid],
                                   rtol=0, atol=1e-2, err_msg=f)


@pytest.mark.parametrize("world", WORLDS)
def test_batched_rx_and_maps_equal_the_reference(launched, references, world):
    _, got = _finished(launched, world)
    ref = references[world].result()
    np.testing.assert_array_equal(got["batched"], np.asarray(ref["batched"]))
    np.testing.assert_array_equal(got["batched"], np.ones((world, 2)))
    want = np.asarray(ref["maps"])
    assert got["maps"].shape == want.shape == (2 * world, 512, 128)
    np.testing.assert_allclose(got["maps"], want, rtol=0, atol=1e-5 * want.max())


@pytest.mark.parametrize("world", WORLDS)
def test_captures_are_the_reference_dry_runs(world):
    """The port's captures equal those __graft_entry__.dryrun_multichip builds
    with the reference's TX chain, within 1e-5 · max|frame|."""
    spec, payload, cap, caps = dryrun.captures(CFG, world)
    jspec = specs(spec.mcs, spec.payload_bytes)[1]
    jpayload = jmake_payload(jspec, bytes([2]) + b"dryrun")
    np.testing.assert_array_equal(payload, jpayload)
    tx = jcomm.tx_frame(JCFG, jspec, jnp.asarray(jpayload), 1)
    frame = np.asarray(jchannel.comm_channel(tx.samples, angle_deg=0.0, path_loss=5.0,
                                             noise_var=0.0))
    _, _, f = dryrun.frame(CFG)
    assert f.shape == frame.shape
    tol = 1e-5 * np.abs(frame).max()
    np.testing.assert_allclose(f, frame, rtol=0, atol=tol)
    cap_ref, caps_ref = _reference_captures(world, frame, jspec)
    np.testing.assert_allclose(cap, cap_ref, rtol=0, atol=tol)
    np.testing.assert_allclose(caps, caps_ref, rtol=0, atol=tol)


def _reference_captures(world, frame, jspec):
    """__graft_entry__.py:79-118's layout, verbatim, around ``frame``."""
    from jrc_tpu.models import streaming

    block_len = 4096
    rng = np.random.default_rng(0)
    cap = (rng.normal(0, 1e-4, (world * block_len, 2)).view(np.complex128)[:, 0]
           ).astype(np.complex64)
    for d in range(world):
        if d % 2 == 1 and d < world - 1:
            pos = (d + 1) * block_len - len(frame) // 3
        else:
            pos = d * block_len + (d * 977) % (block_len - len(frame) - 8)
        cap[pos : pos + len(frame)] += frame
    halo = streaming.frame_window_samples(JCFG, jspec) + JCFG.fft_len
    caps = np.zeros((world, 2048 + halo), np.complex64)
    for d in range(world):
        caps[d, 64 + 7 * d : 64 + 7 * d + len(frame)] = frame
    return cap, caps


def test_teardown_frees_the_captured_steps_before_the_group_and_is_idempotent(monkeypatch):
    """The steps a mesh holds are freed while the group lives (the order NCCL
    needs), the group is destroyed, and a second call does nothing."""
    class Step:  # stands in for a captured step (gloo captures none)
        pass

    events = []
    destroy = torch.distributed.destroy_process_group

    def recorded():
        events.append("destroy")
        destroy()

    monkeypatch.setattr(torch.distributed, "destroy_process_group", recorded)
    with pmesh.local_group("gloo"):
        tm, bm = pmesh.time_mesh(device="cpu"), pmesh.batch_mesh(device="cpu")
        for m in (tm, bm):
            step = Step()
            step.mesh = m  # a captured step refers to its mesh, as graph.jit's partial does
            weakref.finalize(step, events.append, "freed")
            pmesh.captured_steps(m)["key"] = step
            del step
        pmesh.teardown()
        assert events == ["freed", "freed", "destroy"]
        assert not torch.distributed.is_initialized()
        pmesh.teardown()  # nothing left: nothing happens
    assert events == ["freed", "freed", "destroy"]
    assert not pmesh.captured_steps(tm) and not pmesh.captured_steps(bm)
    assert not torch.distributed.is_initialized()


def _doubled(mesh, x):
    return 2 * x


def test_teardown_frees_a_step_on_a_mesh_it_did_not_build(monkeypatch):
    """A step that streaming.mesh_step caches on a mesh built directly with
    init_device_mesh (not through parallel.mesh) is freed by the teardown
    too, before the group is destroyed."""
    from torch.distributed.device_mesh import init_device_mesh

    monkeypatch.setattr(pstream, "captures", lambda mesh, x: True)  # cache it, as on NCCL
    events = []
    destroy = torch.distributed.destroy_process_group

    def recorded():
        events.append("destroy")
        destroy()

    monkeypatch.setattr(torch.distributed, "destroy_process_group", recorded)
    with pmesh.local_group("gloo"):
        m = init_device_mesh("cpu", (1,), mesh_dim_names=("time",))
        x = torch.arange(4.0)
        assert torch.equal(pstream.mesh_step(_doubled, m, x=x), 2 * x)
        (step,) = pmesh.captured_steps(m).values()
        weakref.finalize(step, events.append, "freed")
        del step
    assert events == ["freed", "destroy"]
    assert not pmesh.captured_steps(m)
    assert not torch.distributed.is_initialized()


def test_a_sharded_step_on_gloo_leaves_nothing_to_free():
    """On gloo a step runs op by op: the mesh keeps no captured step, and the
    group is gone after the teardown."""
    spec, _, cap, _ = dryrun.captures(CFG, 1)
    with pmesh.local_group("gloo"):
        tm = pmesh.time_mesh(device="cpu")
        res = pstream.sharded_rx(CFG, spec, tm, pstream.local_block(tm, cap, device="cpu"),
                                 max_frames_per_block=4)
        assert int(res.n_crc_ok) == 1
        assert not pmesh.captured_steps(tm)
    assert not torch.distributed.is_initialized()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("extra", [[], ["--dynamic", "--max-payload", "96"]],
                         ids=["static", "dynamic"])
def test_comm_rx_mesh_two_torchrun_ranks(extra):
    """Two processes with torchrun's environment run python -m
    jrc_tpu_torch.apps.comm_rx --cpu --demo --mesh 2: both exit 0 after the
    teardown, and rank 0's frames equal those of --mesh 1."""
    argv = [sys.executable, "-m", "jrc_tpu_torch.apps.comm_rx", "--cpu", "--demo", *extra]
    one = subprocess.run([*argv, "--mesh", "1"], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, **CHILD_ENV))
    assert one.returncode == 0, one.stderr[-2000:]
    want = one.stdout.strip().splitlines()[-1]
    assert want.startswith("mesh=1 frames=")
    env = dict(CHILD_ENV, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="2")
    ranks = run_ranks(lambda r: [*argv, "--mesh", "2"], 2, timeout=120, cwd=ROOT,
                      env_of=lambda r: dict(env, RANK=str(r)))
    for r, (code, out) in enumerate(ranks):
        assert code == 0, f"rank {r} exited {code} (None: killed at 120 s):\n{out[-2000:]}"
    got = [ln for ln in ranks[0][1].splitlines() if ln.startswith("mesh=")]
    assert got == [want.replace("mesh=1 ", "mesh=2 ")], (got, want)
    frames, ok = (int(w.split("=")[1]) for w in want.split()[1:])
    assert frames == ok > 32  # more than the 32 slots of one --block-len
    assert not any(ln.startswith("mesh=") for ln in ranks[1][1].splitlines())


def test_run_ranks_kills_a_rank_past_its_limit():
    """The launcher of the dry run, the scaling script, the tests and
    chip_smoke: each rank's code and output, LOCAL_RANK set and env_of's
    variables added; a rank still running at the limit is killed and its
    code is None, while its peer's result is kept."""
    code = ("import os, sys, time; r = int(os.environ['LOCAL_RANK']);"
            " print('rank', r, os.environ['RANK'], flush=True);"
            " time.sleep(60 if r else 0); sys.exit(3)")
    t0 = time.monotonic()
    (c0, out0), (c1, out1) = run_ranks(lambda r: [sys.executable, "-c", code], 2, timeout=3,
                                       env_of=lambda r: {"RANK": f"R{r}"})
    assert time.monotonic() - t0 < 30
    assert (c0, out0) == (3, "rank 0 R0\n")
    assert c1 is None and out1 == "rank 1 R1\n"
