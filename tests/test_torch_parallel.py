"""Parity of the port's sharded executors (jrc_tpu_torch.parallel on
torch.distributed) with jrc_tpu.parallel on the CPU.

Each world size is spawned once: 2 and 4 gloo ranks (tests/torch_mesh_ranks.py,
a process each, one thread each, a ``file://`` store under the test's
temporary directory), started together before the first test so that they
run while the reference compiles. Each rank runs every case: ``sharded_rx``
on bench frames and ``sharded_rx_dynamic`` on mixed frames (BPSK-1/2,
BPSK-3/4, QPSK-1/2 and an NDP frame, max_payload 96), each at block_len
8192 (the flat path) and 8200 (``rx_block``), every block but the last with
a frame across its end (tests/test_streaming.py:62's placement: the trigger
about 60 samples before the boundary), over 25 dB AWGN; then ``batched_rx``
on tests/test_parallel_aux.py:39's captures and ``batched_range_angle_maps``
on random channel estimates. The reference runs on a CPU mesh of the same
size (the 8 virtual devices of conftest.py).

Tolerances: valid, start, CRC, SIG, MCS, packet type, length, chan_est_ok,
payload bytes and the totals exactly equal; SNRs within 1e-3 dB on valid
slots, chan_est within 1e-5 · max|h| where live, the maps within
1e-5 · max of the map (torch.fft against the reference's DFT matmuls).
"""
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jrc_tpu.parallel import batch as jbatch, mesh as jmesh, streaming as jps  # noqa: E402
from jrc_tpu_torch import capture  # noqa: E402
from jrc_tpu_torch.models import streaming as tst  # noqa: E402
from jrc_tpu_torch.parallel import mesh as pmesh, streaming as pstream  # noqa: E402
from jrc_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from tests.torch_parity import CFG, JCFG, np_of, specs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RANKS = ROOT / "tests" / "torch_mesh_ranks.py"
TWIN = ROOT / "scripts" / "multihost_rx_torch.py"
WORLDS = (2, 4)
BLOCK_LENS = (8192, 8200)
MIXED = capture.load_mixed_frames()
BENCH_FRAME = capture.load_bench_frame()[0]
BATCH_FRAME = MIXED[2]  # QPSK-1/2, 64 bytes
MAXP = 96


def _noisy(n: int, placed, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    power = np.mean(np.abs(np.concatenate([f for _, f in placed])) ** 2)
    cap = (rng.normal(0, np.sqrt(power / 10 ** 2.5 / 2), (n, 2)) @ [1, 1j]).astype(np.complex64)
    for pos, f in placed:
        cap[pos : pos + len(f)] += f
    return cap


def _sharded_capture(world: int, block_len: int, dynamic: bool):
    """A frame inside every block and one across the end of every block but
    the last → (capture, frames placed)."""
    placed = []
    for d in range(world):
        frames = [MIXED[k].samples for k in (6, 0, 1, 2)] if dynamic else [BENCH_FRAME]
        placed.append((d * block_len + (2700 if dynamic else 1500), frames[2 * d % len(frames)]))
        if d < world - 1:
            placed.append(((d + 1) * block_len - 100, frames[(2 * d + 1) % len(frames)]))
    return _noisy(world * block_len, placed, seed=world * block_len + dynamic), len(placed)


def _cases(world: int):
    cases, arrays = [], {}
    for dynamic in (False, True):
        for block_len in BLOCK_LENS:
            arrays[f"cap_{len(cases)}"], n_placed = _sharded_capture(world, block_len, dynamic)
            cases.append(dict(block_len=block_len, n_placed=n_placed, mcs=3, payload_bytes=64,
                              max_frames=3 if dynamic else 4, max_payload=MAXP if dynamic else 0))
    arrays.update(captures=_batch_captures()[0], chans=_chans(),
                  batch_spec=np.array([BATCH_FRAME.mcs, len(BATCH_FRAME.payload)]))
    return cases, arrays


def _batch_captures():
    """tests/test_parallel_aux.py:39's layout with four captures: 1, 2, 3, 1
    frames from sample 300, 900 apart, over noise at 1e-4."""
    spec = specs(BATCH_FRAME.mcs, len(BATCH_FRAME.payload))[0]
    halo = tst.frame_window_samples(CFG, spec) + CFG.fft_len
    rng = np.random.default_rng(1234)
    caps = (rng.normal(0, 1e-4, (4, 8192 + halo)) + 1j * rng.normal(0, 1e-4, (4, 8192 + halo)))
    caps = caps.astype(np.complex64)
    n_per = []
    for i in range(4):
        pos = 300
        for _ in range(1 + i % 3):
            caps[i, pos : pos + len(BATCH_FRAME.samples)] += BATCH_FRAME.samples
            pos += len(BATCH_FRAME.samples) + 900
        n_per.append(1 + i % 3)
    return caps, n_per


def _chans():
    rng = np.random.default_rng(5)
    return (rng.normal(size=(4, 8, 64)) + 1j * rng.normal(size=(4, 8, 64))).astype(np.complex64)


def _ranks(argv_of, world: int, timeout: float = 300) -> list[str]:
    """``world`` processes of this interpreter, ``argv_of(rank)`` each, one
    thread each (``launch.run_ranks``) → each one's output; every one must
    exit 0 within ``timeout`` seconds (killed past it)."""
    ranks = run_ranks(lambda r: [sys.executable, *map(str, argv_of(r))], world, timeout=timeout,
                      cwd=ROOT, env_of=lambda r: {"OMP_NUM_THREADS": "1"})
    for rank, (code, out) in enumerate(ranks):
        assert code == 0, f"rank {rank} exited {code} (None: killed at {timeout} s):\n{out[-3000:]}"
    return [out for _, out in ranks]


class _Spawned:
    """Every world size's ranks, started together (a launcher thread each);
    ``results(world)`` waits for them once → (cases, rank 0's results),
    every rank's equal to rank 0's."""

    def __init__(self, d: Path):
        self.runs, self.done = {}, {}
        self.pool = ThreadPoolExecutor(len(WORLDS))
        for world in WORLDS:
            cases, arrays = _cases(world)
            np.savez(d / f"cases{world}.npz", cases=json.dumps(cases), **arrays)
            outs = [d / f"out{world}_{r}.npz" for r in range(world)]
            run = self.pool.submit(
                _ranks, lambda r, world=world, outs=outs: [
                    RANKS, "--store", f"file://{d}/store{world}", "--world", world, "--rank", r,
                    "--cases", d / f"cases{world}.npz", "--out", outs[r]], world)
            self.runs[world] = (cases, arrays, run, outs)

    def results(self, world: int):
        if world not in self.done:
            cases, _, run, outs = self.runs[world]
            run.result()
            got = []
            for path in outs:
                with np.load(path) as f:
                    got.append({k: f[k] for k in f})
            for other in got[1:]:
                assert sorted(other) == sorted(got[0])
                for k, v in other.items():
                    np.testing.assert_array_equal(v, got[0][k], err_msg=k)
            self.done[world] = (cases, got[0])
        return self.done[world]

    def close(self):
        self.pool.shutdown()  # each launcher kills its ranks at its limit


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    ranks = _Spawned(tmp_path_factory.mktemp("mesh"))
    yield ranks
    ranks.close()


def _case(cases, block_len: int, dynamic: bool) -> int:
    return next(i for i, c in enumerate(cases)
                if c["block_len"] == block_len and bool(c["max_payload"]) == dynamic)


def _same(got, i, ref, fields, floats, chan_est=False):
    for f in fields:
        np.testing.assert_array_equal(got[f"{i}_{f}"], np.asarray(getattr(ref, f)), err_msg=f)
    valid = got[f"{i}_valid"]
    for f in floats:
        np.testing.assert_allclose(got[f"{i}_{f}"][valid], np.asarray(getattr(ref, f))[valid],
                                   rtol=0, atol=1e-3, err_msg=f)
    if chan_est:
        live = got[f"{i}_chan_est_ok"]
        assert live.any()
        h_ref = np_of(ref.chan_est)[live]
        np.testing.assert_allclose(got[f"{i}_chan_est"][live], h_ref, rtol=0,
                                   atol=1e-5 * np.abs(h_ref).max())


def _reference(cases, arrays, world: int, i: int):
    """jrc_tpu's sharded step of case ``i`` on a CPU mesh of ``world`` devices."""
    case, cap = cases[i], jnp.asarray(arrays[f"cap_{i}"])
    if case["max_payload"]:
        return jps.sharded_rx_dynamic(JCFG, jps.make_time_mesh(world), cap,
                                      max_frames_per_block=case["max_frames"],
                                      max_payload=case["max_payload"])
    return jps.sharded_rx(JCFG, specs(case["mcs"], case["payload_bytes"])[1],
                          jps.make_time_mesh(world), cap, max_frames_per_block=case["max_frames"])


@pytest.fixture(scope="module")
def references(spawned):
    """Every case's reference, compiled four at a time in threads (XLA
    compiles outside the interpreter lock) while the ranks run →
    {(world, case): future}."""
    with ThreadPoolExecutor(4) as pool:
        futures = {(world, i): pool.submit(_reference, cases, arrays, world, i)
                   for world in WORLDS for cases, arrays in [spawned.runs[world][:2]]
                   for i in range(len(cases))}
        yield futures


@pytest.mark.parametrize("block_len", BLOCK_LENS, ids=["aligned", "unaligned"])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_rx_matches_reference(spawned, references, world, block_len):
    cases = spawned.runs[world][0]
    i = _case(cases, block_len, False)
    ref = references[world, i].result()
    _, got = spawned.results(world)
    _same(got, i, ref, ("payload", "crc_ok", "valid", "start", "n_frames", "n_crc_ok"),
          ("snr_db",))
    assert int(got[f"{i}_n_frames"]) == int(got[f"{i}_n_crc_ok"]) == cases[i]["n_placed"]
    assert got[f"{i}_payload"].shape == (world, 4, 64)


@pytest.mark.parametrize("block_len", BLOCK_LENS, ids=["aligned", "unaligned"])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_rx_dynamic_matches_reference(spawned, references, world, block_len):
    cases = spawned.runs[world][0]
    i = _case(cases, block_len, True)
    ref = references[world, i].result()
    _, got = spawned.results(world)
    _same(got, i, ref, ("payload", "payload_len", "crc_ok", "sig_ok", "mcs", "packet_type_bit",
                        "valid", "start", "chan_est_ok", "n_frames", "n_crc_ok"),
          ("snr_db", "snr_data_db"), chan_est=True)
    assert int(got[f"{i}_n_frames"]) == int(got[f"{i}_n_crc_ok"]) == cases[i]["n_placed"]


@pytest.mark.parametrize("world", WORLDS)
def test_meshes(spawned, world):
    _, got = spawned.results(world)
    np.testing.assert_array_equal(got["time_shape"], [world])
    np.testing.assert_array_equal(got["grid_shape"], [world // 2, 2])
    assert got["names"].tolist() == ["time", "batch", "batch", "time"]


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_stage_clock_on_every_rank(spawned, world):
    """Each sharded step stamps the ``mesh`` stages in order on every rank
    (``results`` holds every rank's equal to rank 0's): one complete row a
    step, and the stages after ``start`` as ``profiling.STAGES`` names them."""
    cases, got = spawned.results(world)
    assert got["mesh_stages"].tolist() == ["halo", "decode", "collect"]
    assert int(got["mesh_rows"]) == len(cases)


@pytest.fixture(scope="module")
def reference_maps():
    return np.asarray(jbatch.batched_range_angle_maps(jmesh.batch_mesh(4),
                                                      jnp.asarray(_chans())))


@pytest.mark.parametrize("world", WORLDS)
def test_batched_rx_and_maps_match_reference(spawned, reference_maps, world):
    """tests/test_parallel_aux.py:24-58's checks: every capture's frames
    found and CRC-clean, and the maps equal to the reference's."""
    _, got = spawned.results(world)
    n_per = _batch_captures()[1]
    np.testing.assert_array_equal(got["batched_rx"], np.stack([n_per, n_per], -1))
    assert got["maps"].shape == reference_maps.shape == (4, 512, 128)
    np.testing.assert_allclose(got["maps"], reference_maps, rtol=0,
                               atol=1e-5 * reference_maps.max())


def test_world_of_one_equals_scan_rx():
    """One rank exchanges nothing (its halos are zeros) and decodes the
    whole capture as ``scan_rx`` with one block does, at an aligned and an
    unaligned length; outside a process group nothing is joined."""
    pmesh.init_distributed(backend="gloo")  # no coordinator anywhere: nothing happens
    assert not torch.distributed.is_initialized()
    cap, _ = _sharded_capture(3, 8200, False)
    spec, _ = specs(3, 64)
    tab = pstream.cached_tables(CFG, spec, 0, torch.device("cpu"))
    with pmesh.local_group("gloo"):
        mesh = pmesh.time_mesh(device="cpu")
        for n in (3 * 8192, 3 * 8200):
            res = pstream.sharded_rx(CFG, spec, mesh, pstream.local_block(mesh, cap[:n],
                                                                          device="cpu"),
                                     max_frames_per_block=8)
            halo = tst.frame_window_samples(CFG, spec) + CFG.fft_len
            want = tst.scan_rx(CFG, spec, tab, torch.from_numpy(
                np.concatenate([cap[:n], np.zeros(halo, np.complex64)])), n, 1,
                max_frames_per_block=8)
            for f in ("payload", "crc_ok", "valid", "start", "snr_db"):
                assert torch.equal(getattr(res, f)[0], getattr(want, f)), (n, f)
            assert int(res.n_frames) == int(res.n_crc_ok) == int(want.valid.sum()) == 5
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("n,step", [(1000, 4096), (4096, 4096), (4097, 4096), (50_000, 4096),
                                    (1 << 24, 1 << 23)])
def test_file_steps_keep_every_trigger_once_inside_its_step(n, step):
    """The steps of a recording: one shape, kept spans that tile [0, n), and
    a kept trigger's frame (``halo``) and look-back (``history``) inside
    its step (the recording's own ends aside)."""
    halo, history = pstream.edges(CFG, None, 3100 if step > 4096 else 64)
    steps = pstream.file_steps(n, step, halo, history)
    assert steps[0].keep_lo == 0 and steps[-1].keep_hi == n and steps[-1].lo + step >= n
    for a, b in zip(steps, steps[1:]):
        assert a.keep_hi == b.keep_lo and b.lo > a.lo
    for st in steps:
        assert st.keep_lo < st.keep_hi
        assert st.keep_lo == 0 or st.keep_lo - history >= st.lo
        assert st.keep_hi == n or st.keep_hi - 1 + halo <= st.lo + step


def test_mesh_entry_points_need_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is it")
    with pytest.raises(RuntimeError, match="CUDA"):
        pmesh.compute_device()
    with pmesh.local_group("gloo"):
        with pytest.raises(RuntimeError, match="CUDA"):
            pmesh.time_mesh()
        with pytest.raises(ValueError, match="every rank"):
            pmesh.time_mesh(2, device="cpu")


@pytest.mark.parametrize("local_rank,rank,n_cards,want", [
    ("1", 1, 1, 0),  # torchrun's second process on a one-card host shares the card
    ("3", 3, 2, 1), ("1", 5, 4, 1), (None, 5, 4, 1), (None, 0, 1, 0)])
def test_compute_device_wraps_onto_the_host_cards(monkeypatch, local_rank, rank, n_cards, want):
    """The default compute device is LOCAL_RANK (else the rank) modulo the
    host's cards (the CUDA queries stubbed, so that it runs on the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: rank)
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    assert pmesh.compute_device() == torch.device("cuda", want)


def test_twin_script_two_processes(tmp_path):
    """scripts/multihost_rx_torch.py as tests/test_multihost.py runs the
    reference script: two processes, a frame across the boundary between
    them, both paths."""
    outs = _ranks(lambda r: [TWIN, "--coordinator", f"file://{tmp_path}/store",
                             "--num-processes", 2, "--process-id", r, "--device", "cpu",
                             "--backend", "gloo", "--dynamic"], 2)
    for rank, out in enumerate(outs):
        assert f"MULTIHOST_OK rank={rank} n_frames=2 crc_ok=2 dynamic=True" in out, out[-2000:]
