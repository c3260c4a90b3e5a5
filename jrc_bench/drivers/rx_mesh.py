"""The time-sharded receiver's step loop over the cards of one host, as

    torchrun --nproc-per-node 4 -m jrc_tpu_torch.apps.comm_rx --dynamic --mesh 4 \\
        --max-payload 3100 <file>

runs it on a recording: every rank a block of the file in time, one
``parallel.streaming.sharded_rx_dynamic`` step a file on a
``parallel.mesh.time_mesh`` of NCCL ranks, each step one captured CUDA graph
(halos, decode, all-reduce, all-gathers).

**Ranks.** The harness's process is rank 0 on ``cuda:0``. Before it makes
the inputs it starts ranks 1 … ``ranks − 1`` as processes of this module
(``python3 -m jrc_bench.drivers.rx_mesh``, rank r on ``cuda:r``), and every
rank joins the group on rank 0's TCP store under one time limit, the window
plus ``MARGIN_S``. A watchdog thread of rank 0 ends the run with exit code
``RANK_FAILED`` where a rank exits with an error or the limit passes (a rank
blocked in a captured collective cannot be woken otherwise); a rank whose
parent has gone or whose limit has passed ends itself. Every rank leaves
through ``parallel.mesh.teardown``.

**Inputs.** A file is one step of the app (``apps/comm_rx --mesh``: a
recording of ``step_samples`` samples, a rank a quarter, its slots 32 a
``block_len`` of its block, the app's ``parallel.streaming.slots_for``).
Rank 0 makes the mix's ``files`` recordings from the seed
(``recordings.py``) while the other ranks start, and broadcasts them after
the join; every rank keeps its block of each in pinned host memory. A step
uploads the rank's block of the current file (the files in turn) and runs
the sharded step; rank 0 then reads every gathered field back to the host,
as ``apps/comm_rx``'s report does, and every rank reads back one count of
its own check, so each rank has one step in flight.

**Set-up.** Every rank times the parts of its set-up: ``start`` (from rank
0's process start, or from its own spawn, to its store), ``recordings``
(rank 0), ``join``, ``inputs`` (the first collective: NCCL's
communicators, the wait for the last rank to arrive, the broadcast),
``mesh`` (the mesh and the pinned blocks), ``capture`` (the first step:
once op by op, captured, replayed) and ``warm`` (the other warm steps);
rank 0 prints every rank's after the run.

**Steps.** All ranks run the same steps without a collective of the
harness's own: rank 0 writes the length of each round of steps to the store
(a host write) and the others read it before the round; a round of 0 ends
the loop. ``warm_steps`` steps warm up (the first captures the graph); the
window's rounds are sized from the pace of the steps before them, at most
``ROUND_S`` seconds each, until the window has closed. ``rx_msps`` counts the
samples of the steps rank 0 read back inside the window. With ``--trace 1``
``trace_steps`` steps more are traced on rank 0's card, one round each.

**Checks.** Every rank keeps the first step of each file on its card and
compares each later step of the file with it bit for bit there, one count a
step (``steps_differ``, every field and the totals). After the loop rank 0
broadcasts its kept steps and every rank counts the elements where its own
differ (``ranks_differ``). Rank 0 then holds each kept step against its
file: every frame found once (``frames_missed``; decodes beyond one, and
CRC-clean decodes where nothing was sent, are ``frames_extra``) with the
MCS, type, length, CRC and payload sent (``frames_wrong``), the frames across
an inner boundary among them (``boundary_frames_missed``), each at the
global start the reference gives (``reference/mesh.py``, ±2 samples) and
inside its rank's block (``starts_wrong``), the all-reduced totals against
the gathered slots and the reference's count of owned triggers
(``totals_differ``); and on frames drawn from the seed (``check_frames``
spread over the frame kinds, so every MCS and the NDP estimate are held)
plus every frame across a boundary, each slot against the reference's
decode of its rank's window, and the NDP estimates and SNRs against the
generator's truth, as the rx cells compare them.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from dataclasses import replace
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from jrc_bench import generate, recordings
from jrc_bench.drivers import rx_stream
from jrc_bench.harness import Cell, Observed, Outcome, checked, now, peak_bytes, per_second_log
from jrc_bench.reference import mesh as ref_mesh
from jrc_bench.reference import phy

ROOT = Path(__file__).resolve().parents[2]
#: seconds a run's ranks may take beyond the window: set-up, the last round, the trace, the exchange
MARGIN_S = 240.0
#: the longest round of steps inside the window, seconds
ROUND_S = 2.0
#: rank 0's exit code where a rank failed or the limit passed
RANK_FAILED = 4
#: the per-slot fields of a rank's block, as ``rx_stream.program_slots`` reads them
SLOT_FIELDS = ("start", "mcs", "packet_type_bit", "payload_len", "crc_ok", "sig_ok",
               "chan_est_ok", "snr_db", "snr_data_db", "chan_est", "payload", "valid")


def _geometry(config: dict):
    """(ranks, samples a step, samples a rank, slots a rank, max_payload): a
    rank's slots by the app's rule, 32 a ``block_len`` of its block."""
    ranks, n = int(config["ranks"]), int(config["step_samples"])
    block = n // ranks
    return ranks, n, block, 32 * -(-block // int(config["block_len"])), int(config["max_payload"])


class _SetUp:
    """A rank's set-up in parts: the seconds from the mark before to each."""

    def __init__(self, t: float):
        self.t, self.parts = t, {}

    def __call__(self, part: str) -> None:
        t = now()
        self.parts[part], self.t = t - self.t, t


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s elements as integers of their width, for a comparison bit for bit."""
    if t.is_complex():
        t = torch.view_as_real(t)
    if t.dtype == torch.bool:
        return t.view(torch.uint8)
    if t.is_floating_point():
        return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
    return t


def _differing(res, ref) -> torch.Tensor:
    """The elements of a step's fields that differ from ``ref``'s, a 0-d tensor
    on the device (no host sync)."""
    return sum((_bits(a) != _bits(b)).sum() for a, b in zip(res, ref))


class _Rank:
    """One rank's side of the loop: its mesh, its blocks, its kept steps."""

    def __init__(self, config: dict, rank: int, device: torch.device, blocks: list):
        from jrc_tpu_torch.config import OFDMConfig
        from jrc_tpu_torch.parallel import mesh as pmesh
        from jrc_tpu_torch.parallel import streaming as pstream

        ranks, _, _, self.slots, self.max_payload = _geometry(config)
        self.config, self.rank, self.device = config, rank, device
        self._rx = pstream.sharded_rx_dynamic
        self.cfg = OFDMConfig()
        self.mesh = pmesh.time_mesh(ranks, device=device)
        on_card = device.type == "cuda"
        self.blocks = [b.pin_memory() if on_card else b for b in blocks]
        self.x = torch.empty_like(self.blocks[0], device=device)
        self.kept: list = [None] * len(blocks)
        self.steps = 0
        self.steps_differ = 0

    def step(self):
        """Upload the current file's block and run the sharded step → its result."""
        self.x.copy_(self.blocks[self.steps % len(self.blocks)], non_blocking=True)
        self.steps += 1
        return self._rx(self.cfg, self.mesh, self.x, max_frames_per_block=self.slots,
                        max_payload=self.max_payload, estimator=self.config["estimator"],
                        soft=bool(self.config["soft"]))

    def check(self, res) -> torch.Tensor:
        """The elements of the last step's result that differ from its file's
        kept step, 0-d on the device (the first step of a file is kept)."""
        f = (self.steps - 1) % len(self.blocks)
        if self.kept[f] is None:
            self.kept[f] = res
            return torch.zeros((), dtype=torch.int64, device=self.device)
        return _differing(res, self.kept[f])

    def exchange(self, setup: dict) -> dict:
        """After the loop, on every rank: the elements where its kept steps
        differ from rank 0's, and what rank 0 reads of it."""
        differ = 0
        for kept in self.kept:
            for t in kept:
                own = _bits(t).contiguous()
                got = own.clone()
                dist.broadcast(got, 0)
                differ += int((got != own).sum())
        return {"rank": self.rank, "steps": self.steps, "steps_differ": self.steps_differ,
                "ranks_differ": differ, "memory_peak_bytes": peak_bytes(self.device),
                "stages": _stage_rows(), "counts": _counts(), "setup": setup}


def _stage_rows() -> dict:
    """This process's stage clocks of the sharded step (``mesh``) and of the
    decode inside it (``rx``): entry → one {stage: ns} a complete call; an
    entry the program does not stamp is left out."""
    from jrc_tpu_torch.utils import profiling

    stages, rows = getattr(profiling, "STAGES", {}), getattr(profiling, "stage_rows", None)
    return {e: [dict(zip(stages[e], row[1:])) for row in rows(e)]
            for e in ("mesh", "rx") if rows is not None and e in stages}


def _counts() -> dict:
    """This process's counts of the decode inside the sharded step: K1's
    ``viterbi_steps``, one (steps, envelope) a complete call; {} on a
    program without the count."""
    from jrc_tpu_torch.utils import profiling

    counts = getattr(profiling, "counts", None)
    return {} if counts is None else {"viterbi_steps": counts("rx", "viterbi_steps")}


def _store(rank: int, world: int, port: int, limit: float):
    """Rank 0's TCP store (rank 0 serves it): the group's rendezvous and the rounds."""
    return dist.TCPStore("127.0.0.1", port, world, is_master=rank == 0,
                         timeout=timedelta(seconds=limit), wait_for_workers=False)


def _join(store, rank: int, world: int, limit: float, device: torch.device) -> None:
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", store=store, rank=rank,
                            world_size=world, timeout=timedelta(seconds=limit))


def _blocks(caps: list | None, files: int, rank: int, config: dict,
            device: torch.device) -> list:
    """Rank 0's ``files`` recordings (``caps`` on rank 0, None elsewhere)
    broadcast to every rank → this rank's block of each, on the host."""
    _, n, block, _, _ = _geometry(config)
    out = []
    for f in range(files):
        wire = (torch.view_as_real(torch.from_numpy(caps[f].samples)).to(device) if caps
                else torch.empty((n, 2), dtype=torch.float32, device=device))
        dist.broadcast(wire, 0)
        out.append(torch.view_as_complex(wire)[rank * block : (rank + 1) * block].cpu())
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Watch(threading.Thread):
    """Rank 0's watchdog over the other ranks (see the module)."""

    def __init__(self, procs: list, logs: list, deadline: float):
        super().__init__(daemon=True)
        self.procs, self.logs, self.deadline = procs, logs, deadline
        self.done = threading.Event()

    def run(self):
        while not self.done.wait(0.5):
            bad = [(r, p.returncode) for r, p in enumerate(self.procs, 1)
                   if p.poll() not in (None, 0)]
            if bad or now() > self.deadline:
                self.fail(f"rank(s) exited with {bad}" if bad else "the run passed its limit")

    def fail(self, why: str):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        print(f"jrc_bench rx_mesh: {why}", file=sys.stderr)
        for r, log in enumerate(self.logs, 1):
            log.seek(0)
            print(f"--- rank {r} ---\n{log.read()[-4000:]}", file=sys.stderr)
        sys.stderr.flush()
        os._exit(RANK_FAILED)


def _spawn(cell: Cell, port: int, limit: float) -> tuple[list, list]:
    ranks = int(cell.config["ranks"])
    logs = [tempfile.TemporaryFile("w+") for _ in range(1, ranks)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "jrc_bench.drivers.rx_mesh", "--rank", str(r), "--port", str(port),
         "--limit", str(limit), "--device", cell.device.type, "--config", json.dumps(cell.config),
         "--files", str(int(cell.mix["files"])), "--spawned", repr(time.time())],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT, text=True)
        for r, log in zip(range(1, ranks), logs)]
    return procs, logs


class _Rounds:
    """Rank 0's plan of the rounds of steps, on the store."""

    def __init__(self, store):
        self.store, self.i = store, 0

    def __call__(self, steps: int) -> None:
        self.store.set(f"round{self.i}", str(steps))
        self.i += 1


def run(cell: Cell) -> Outcome:
    limit = cell.seconds + MARGIN_S
    port = _free_port()
    procs, logs = _spawn(cell, port, limit)
    watch = _Watch(procs, logs, now() + limit)
    watch.start()
    try:
        return _run(cell, port, limit, procs, watch)
    except BaseException:  # a rank left blocked in a collective would hang the exit
        traceback.print_exc()
        watch.fail("rank 0 failed")


def _run(cell: Cell, port: int, limit: float, procs: list, watch: _Watch) -> Outcome:
    from jrc_tpu_torch.parallel import mesh as pmesh

    conf, mix = cell.config, cell.mix
    ranks, n, _, _, _ = _geometry(conf)
    setup = _SetUp(cell.t_start)
    store = _store(0, ranks, port, limit)
    setup("start")
    caps = recordings.recordings(mix, n, cell.seed, cell.device)
    setup("recordings")
    _join(store, 0, ranks, limit, cell.device)
    setup("join")
    blocks = _blocks(caps, len(caps), 0, conf, cell.device)
    setup("inputs")
    me = _Rank(conf, 0, cell.device, blocks)
    setup("mesh")
    rounds = _Rounds(store)
    read_at: list = []
    host_s: dict = {"step": [], "check": [], "readback": []}  # rank 0's host time a step

    def one():
        t = now()
        res = me.step()
        t_step = now()
        differ = me.check(res)
        t_check = now()
        for field in res:  # the report's readback, field by field
            field.cpu()
        me.steps_differ += int(differ)
        read_at.append(now())
        for k, dt in zip(host_s, (t_step - t, t_check - t_step, read_at[-1] - t_check)):
            host_s[k].append(dt)

    warm = int(mix["warm_steps"])
    rounds(warm)
    for i in range(warm):
        one()
        if i == 0:
            setup("capture")
    setup("warm")
    pace = statistics.median(np.diff(read_at))  # the steps after the capture
    read_at.clear()
    t0 = now()
    setup_s = t0 - cell.t_start
    first_window_step = me.steps
    while (left := t0 + cell.seconds - now()) > 0:
        k = max(1, math.ceil(min(left, ROUND_S) / pace))
        rounds(k)
        for _ in range(k):
            one()
        pace = (now() - t0) / (me.steps - first_window_step)
    t_end = t0 + cell.seconds
    window_steps = sum(t <= t_end for t in read_at)
    window_files = [k % len(caps) for k in range(first_window_step,
                                                  first_window_step + window_steps)]
    per_second_log("steps", read_at, t0, cell.seconds)
    if window_steps:
        print("rank 0 host ms a window step (medians): " + " ".join(
            f"{k} {1e3 * statistics.median(v[warm:warm + window_steps]):.4f}"
            for k, v in host_s.items()), file=sys.stderr)
    observed = Observed(calls=window_steps, seconds=cell.seconds)
    if cell.trace:
        from jrc_bench.trace import trace_calls

        def traced_step():
            rounds(1)
            one()

        observed.traced = trace_calls(traced_step, int(mix["trace_steps"]))
    rounds(0)
    kept = [{k: v.cpu().numpy() for k, v in res._asdict().items()} for res in me.kept]
    records = [None] * ranks
    dist.all_gather_object(records, me.exchange(setup.parts))
    pmesh.teardown()
    for r, p in enumerate(procs, 1):
        code = p.wait(timeout=max(1.0, watch.deadline - now()))
        if code != 0:
            watch.fail(f"rank {r} exited with {code}")
    watch.done.set()
    observed.stage_rows = [rec["stages"] for rec in records]
    observed.count_rows = [rec["counts"] for rec in records]
    for rec in records:
        print(f"rank {rec['rank']} set-up s: " + " ".join(
            f"{k} {v:.3f}" for k, v in rec["setup"].items()), file=sys.stderr)
    for rec in records:
        print(f"rank {rec['rank']} stage ms (medians): " + "; ".join(
            f"{entry} " + " ".join(f"{b} {statistics.median((r[b] - r[a]) / 1e6 for r in rows):.4f}"
                                   for a, b in zip(rows[0], list(rows[0])[1:]))
            for entry, rows in rec["stages"].items() if rows), file=sys.stderr)
    del me
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()

    t_check = now()
    numbers: dict = {"steps_differ": sum(rec["steps_differ"] for rec in records),
                     "ranks_differ": sum(rec["ranks_differ"] for rec in records)}
    failed_of, parts = [], []
    for f, (cap, host) in enumerate(zip(caps, kept)):
        slots = program_slots(host)
        ref_starts = ref_mesh.starts(torch.from_numpy(cap.samples), ranks, _halo(conf))
        part = truth(slots, cap, ranks, ref_starts)
        part["totals_differ"] = (abs(int(host["n_frames"]) - int(host["valid"].sum()))
                                 + abs(int(host["n_crc_ok"]) - int(host["crc_ok"].sum()))
                                 + abs(int(host["n_frames"]) - len(ref_starts)))
        failed_of.append(part["frames_missed"] + part["frames_wrong"] + part["frames_extra"])
        for k, v in part.items():
            numbers[k] = numbers.get(k, 0) + v
        chosen = check_frames(cell, cap, f)
        parts.append(numbers_of_check(cell, cap, chosen,
                                      [s for s in slots if frame_of(cap, s["start"]) in chosen]))
    numbers.update(rx_stream.merge_numbers(parts))
    print(f"reference_s {now() - t_check:.2f}", file=sys.stderr)
    memory = max(rec["memory_peak_bytes"] for rec in records)
    attempted = sum(len(caps[f].placed.pos) for f in window_files)
    failed = sum(failed_of[f] for f in window_files)
    e2e = {"rx_msps": window_steps * n / cell.seconds / 1e6}
    return Outcome(setup_s=setup_s, end_to_end=e2e, attempted=attempted, failed=failed,
                   checks=checked(cell, numbers), memory_peak_bytes=memory, observed=observed)


def _halo(config: dict) -> int:
    return rx_stream.halo_samples(int(config["max_payload"]))


def program_slots(host: dict) -> list:
    """The valid slots of a gathered step, every rank's block in turn, as slot
    records with their rank (``start`` is global)."""
    out = []
    for r in range(host["valid"].shape[0]):
        for s in rx_stream.program_slots({k: host[k][r] for k in SLOT_FIELDS}):
            out.append({**s, "rank": r})
    return out


def frame_of(cap, start: int) -> int:
    """The index of the frame sent where a trigger at global ``start`` lies,
    else −1."""
    pos = cap.placed.pos
    idx = int(np.searchsorted(pos, start, side="right")) - 1
    return idx if idx >= 0 and 0 <= start - pos[idx] < rx_stream.TRIGGER_REACH else -1


def truth(slots: list, cap, ranks: int, ref_starts: np.ndarray, frames=None) -> dict:
    """A file's slots (the program's, or the control's in its place) against
    what was sent → the counts (see the module); ``frames``: the indices of
    the frames held (default: every frame of the file)."""
    placed, n = cap.placed, len(cap.samples)
    block = n // ranks
    frames = set(range(len(placed.pos))) if frames is None else set(frames)
    found: dict = {}
    wrong = extra = starts_wrong = 0
    bad: set = set()
    for s in slots:
        g, r = int(s["start"]), int(s["rank"])
        idx = frame_of(cap, g)
        starts_wrong += not r * block <= g < (r + 1) * block
        if idx < 0:
            extra += bool(s["crc_ok"])  # a clean decode where nothing was sent
            continue
        found[idx] = found.get(idx, 0) + 1
        ref = ref_starts[(ref_starts >= placed.pos[idx])
                         & (ref_starts < placed.pos[idx] + rx_stream.TRIGGER_REACH)]
        starts_wrong += len(ref) != 1 or abs(g - int(ref[0])) > 2
        spec = placed.specs[placed.kind[idx]]
        ok = (bool(s["crc_ok"]) and bool(s["sig_ok"])
              and int(s["mcs"]) == phy.MCS_NAMES.index(spec.mcs)
              and int(s["packet_type_bit"]) == int(spec.ptype == "DATA")
              and int(s["payload_len"]) == spec.payload_bytes
              and np.array_equal(s["payload"], placed.payload[idx]))
        wrong += not ok
        if not ok:
            bad.add(idx)
    missed = {i for i in frames if i not in found}
    across = set().union(*map(set, recordings.crossing(cap, ranks).values())) & frames
    return {"frames_missed": len(missed), "frames_wrong": wrong,
            "frames_extra": extra + sum(c - 1 for c in found.values()),
            "boundary_frames_missed": len(across & (missed | bad)),
            "starts_wrong": starts_wrong}


def check_frames(cell: Cell, cap, f: int) -> set:
    """File ``f``'s frames the reference decodes: drawn from the seed, as
    many of each frame kind as ``check_frames`` spread over the kinds needs
    (so every MCS and the NDP estimate are held each run), and every frame
    across an inner boundary."""
    kind = cap.placed.kind
    per = -(-int(cell.mix["check_frames"]) // len(cap.placed.specs))
    r = generate.rng(cell.seed, 20 + f)
    drawn = [r.choice(np.nonzero(kind == k)[0], min(per, int(np.sum(kind == k))), replace=False)
             for k in range(len(cap.placed.specs))]
    across = recordings.crossing(cap, int(cell.config["ranks"])).values()
    return {int(i) for d in drawn for i in d} | {int(i) for a in across for i in a}


def numbers_of_check(cell: Cell, cap, chosen: set, slots: list) -> dict:
    """The slots of the ``chosen`` frames (the program's, or the control's)
    against the float64 reference's decode of the same frames and against
    the generator's truth (``rx_stream.compare_block``, ``truth_block``)."""
    ranks, _, _, slots_per_rank, max_payload = _geometry(cell.config)
    ref = ref_mesh.decode(torch.from_numpy(cap.samples), ranks, _halo(cell.config), max_payload,
                          keep=lambda s: frame_of(cap, s) in chosen)
    # truth_block places a slot at block j · span + start: j = 0 with global starts
    whole = replace(cell, config={**cell.config, "n_blocks": 1, "max_frames": slots_per_rank})
    return {**rx_stream.compare_block(slots, ref), **rx_stream.truth_block(whole, cap, 0, slots)}


def control(cell: Cell, fault: str | None = None) -> dict:
    """The readings of the reference put in the program's place for one seed,
    on every file's check frames (those across a boundary among them),
    compared as the program's kept steps are: computed in bfloat16 (the
    control), or in float64 with a planted ``fault`` of the sharding
    (``reference/mesh.py``: ``halo_dropped``, ``owner_shift``)."""
    if fault is not None and fault not in ref_mesh.FAULTS:
        raise ValueError(f"no fault {fault!r} of rx_mesh: {ref_mesh.FAULTS}")
    ranks, n, _, _, max_payload = _geometry(cell.config)
    prec = phy.Prec(bf16=fault is None)
    numbers: dict = {}
    parts = []
    for f, cap in enumerate(recordings.recordings(cell.mix, n, cell.seed, cell.device)):
        x = torch.from_numpy(cap.samples)
        chosen = check_frames(cell, cap, f)
        slots = ref_mesh.decode(x, ranks, _halo(cell.config), max_payload, prec=prec, fault=fault,
                                keep=lambda s: frame_of(cap, s) in chosen)
        part = truth(slots, cap, ranks, ref_mesh.starts(x, ranks, _halo(cell.config)), chosen)
        for k, v in part.items():
            numbers[k] = numbers.get(k, 0) + v
        parts.append(numbers_of_check(cell, cap, chosen, slots))
    return {**numbers, **rx_stream.merge_numbers(parts)}


def _orphan_watch(parent: int, deadline: float) -> None:
    """A rank's own watchdog: end the process once its parent has gone or
    its limit has passed."""
    while True:
        time.sleep(0.5)
        if os.getppid() != parent or now() > deadline:
            print("jrc_bench rx_mesh: rank 0 has gone or the limit has passed", file=sys.stderr,
                  flush=True)
            os._exit(RANK_FAILED)


def rank_main(argv=None) -> int:
    """Ranks 1 … ``ranks − 1`` of a run: join, take the blocks, follow rank
    0's rounds, exchange, leave."""
    p = argparse.ArgumentParser()
    for name, kind in (("--rank", int), ("--port", int), ("--limit", float), ("--device", str),
                       ("--config", str), ("--files", int), ("--spawned", float)):
        p.add_argument(name, type=kind, required=True)
    a = p.parse_args(argv)
    setup = _SetUp(now() - (time.time() - a.spawned))
    threading.Thread(target=_orphan_watch, args=(os.getppid(), now() + a.limit),
                     daemon=True).start()
    try:
        from jrc_tpu_torch.parallel import mesh as pmesh

        config = json.loads(a.config)
        ranks = int(config["ranks"])
        device = torch.device("cuda", a.rank) if a.device == "cuda" else torch.device("cpu")
        if device.type == "cuda":
            torch.cuda.set_device(device)
        store = _store(a.rank, ranks, a.port, a.limit)
        setup("start")
        _join(store, a.rank, ranks, a.limit, device)
        setup("join")
        blocks = _blocks(None, a.files, a.rank, config, device)
        setup("inputs")
        me = _Rank(config, a.rank, device, blocks)
        setup("mesh")
        i = 0
        while steps := int(store.get(f"round{i}")):
            for k in range(steps):
                me.steps_differ += int(me.check(me.step()))
                if i == k == 0:
                    setup("capture")
            if i == 0:
                setup("warm")
            i += 1
        dist.all_gather_object([None] * ranks, me.exchange(setup.parts))
        pmesh.teardown()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    return 0


if __name__ == "__main__":
    sys.exit(rank_main())
