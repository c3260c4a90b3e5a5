"""The live receiver's window loop, as ``apps/comm_rx --dynamic`` runs it.

Set-up builds the mix's capture from the seed (``generate.rx_capture``) and
the program's ``io.stream.BlockStreamer`` with the configuration's receiver
settings (SIG-driven, ``jit`` as configured), and pushes the capture, round
and round, until ``warm_calls`` calls have come back: the first captures the
call's CUDA graph, the others run the loop as the window will.

The window is a closed loop on one host thread: push the configuration's
``push_samples`` of the capture into the ring (the radio's pushes), then take every call the
streamer can make, each read back field by field to the host as the app's
report does. ``rx_msps`` counts the samples of the calls read back inside the
window; a call's latency runs from the return of the push that completed its
block to the end of its readback.

Checks, after the window: no sample dropped; every frame the calls covered
found once, CRC-clean, with the MCS, packet type, length and payload that
were sent (the seed's truth); on ``check_blocks`` blocks drawn from the
seed, every slot of the program's call against the plain reference's
receiver (``reference/phy.py``, its own detection, sync and decode on the
same samples): the slots and their decoded fields exactly, the SNR fields
and the NDP channel estimate within limits; and on those blocks the
program's NDP channel estimates against the channel the generator applied
(up to a common phase) and the mean bias of its L-LTF SNR against the SNR
of the noiseless frames over the injected noise.
"""
from __future__ import annotations

import gc
import sys

import numpy as np
import torch

from jrc_bench import counts, generate
from jrc_bench.harness import (Cell, Observed, Outcome, checked, now, peak_bytes,
                               per_second_log, quantile_95, rel)
from jrc_bench.reference import phy

#: a frame's trigger lies this far behind its first sample at the most
TRIGGER_REACH = 200
#: where a frame's trigger lies behind its first sample, near enough to say which block owns it
OWN_OFFSET = 40
#: samples before a block the reference's detection starts from (its suppression settles there)
PRE = 4096
#: the first L-LTF copy, samples after a frame's first sample: 2 STF words, then the rotated
#: L-LTF's last 48 samples and the L-LTF's cyclic prefix form one whole L-LTF
LTF_AT = 2 * phy.SYM + phy.FFT // 2


class _TimedRing:
    """The streamer's ring with its pops timed (the ingest span)."""

    def __init__(self, ring, spans: list):
        self._ring, self._spans = ring, spans

    def pop_block(self, *a, **k):
        t = now()
        out = self._ring.pop_block(*a, **k)
        self._spans.append(now() - t)
        return out

    def __getattr__(self, name):
        return getattr(self._ring, name)


class _Record:
    """One call's valid slots as the host read them."""

    __slots__ = ("k", "start", "mcs", "ptype", "plen", "crc", "sig", "payload")

    def __init__(self, k: int, host: dict):
        v = np.nonzero(host["valid"])[0]
        self.k = k
        self.start = host["start"][v]
        self.mcs = host["mcs"][v]
        self.ptype = host["packet_type_bit"][v]
        self.plen = host["payload_len"][v]
        self.crc = host["crc_ok"][v]
        self.sig = host["sig_ok"][v]
        self.payload = [host["payload"][i, : host["payload_len"][i]].copy() for i in v]


def _geometry(cell: Cell):
    c = cell.config
    return int(c["block_len"]), int(c["n_blocks"]), int(c["max_frames"]), int(c["max_payload"])


def _truth(records, cap, span: int):
    """Match every decoded slot of contiguous calls to the frame sent there →
    (attempted, missed, wrong, duplicated, extra)."""
    placed, n = cap.placed, len(cap.samples)
    found: dict = {}
    wrong = extra = 0
    for r in records:
        for i in range(len(r.start)):
            a = r.k * span + int(r.start[i])
            q, pas = a % n, a // n
            idx = int(np.searchsorted(placed.pos, q, side="right")) - 1
            if idx < 0 or not 0 <= q - placed.pos[idx] < TRIGGER_REACH:
                extra += bool(r.crc[i])  # a clean decode where nothing was sent
                continue
            found[(pas, idx)] = found.get((pas, idx), 0) + 1
            spec = placed.specs[placed.kind[idx]]
            ok = (bool(r.crc[i]) and bool(r.sig[i])
                  and int(r.mcs[i]) == phy.MCS_NAMES.index(spec.mcs)
                  and int(r.ptype[i]) == int(spec.ptype == "DATA")
                  and int(r.plen[i]) == spec.payload_bytes
                  and np.array_equal(r.payload[i], placed.payload[idx]))
            wrong += not ok
    lo = records[0].k * span + TRIGGER_REACH
    hi = (records[-1].k + 1) * span - TRIGGER_REACH
    attempted = missed = 0
    for pas in range(lo // n, hi // n + 1):
        for idx, p in enumerate(placed.pos):
            if lo <= pas * n + p and pas * n + p + TRIGGER_REACH <= hi:
                attempted += 1
                missed += (pas, idx) not in found
    duplicated = sum(c - 1 for c in found.values())
    return attempted, missed, wrong, duplicated, extra


def block_input(cap, j: int, span: int, left: int, halo: int) -> np.ndarray:
    """Block ``j`` of the capture as a call reads it in steady state:
    ``[left | span | halo]`` samples, cyclic over the capture."""
    n = len(cap.samples)
    idx = (j * span - left + np.arange(left + span + halo)) % n
    return cap.samples[idx]


def halo_samples(max_payload: int) -> int:
    """Samples a call reads past its block: the window of the largest frame
    the envelope allows (BPSK-1/2), from a trigger, and one FFT more."""
    n_sym = phy.n_symbols(24, max_payload + 4)
    return (phy.N_SYNC * phy.SYM + 2 * phy.FFT + (2 + 1 + phy.N_LTF + n_sym - 2) * phy.SYM
            + 2 * phy.FFT)


def reference_block(cell: Cell, cap, j: int, *, prec: phy.Prec = phy.Prec(),
                    fault: str | None = None) -> list:
    """The plain reference's frames of block ``j``: its own triggers over the
    block (from ``PRE`` samples before it) and each owned frame received →
    slot records (trigger relative to the block). ``prec`` and ``fault``
    make the control and the faults put in the program's place."""
    block_len, n_blocks, _, max_payload = _geometry(cell)
    span = block_len * n_blocks
    n = len(cap.samples)
    idx = (j * span - PRE + np.arange(PRE + span + halo_samples(max_payload))) % n
    x = prec.r(cap.samples[idx].astype(np.complex128))
    trig, coarse = phy.triggers(x)
    own = (trig >= PRE) & (trig < PRE + span)
    out = []
    for t, c in zip(trig[own], coarse[own]):
        fr = phy.receive(x, int(t), float(c), max_payload, prec=prec,
                         late=1 if fault == "late_sync" else 0)
        out.append({"start": int(t) - PRE, "mcs": fr.mcs, "packet_type_bit": fr.ptype_bit,
                    "payload_len": fr.length - 4, "crc_ok": fr.crc_ok, "sig_ok": fr.sig_ok,
                    "chan_est_ok": fr.chan_est_ok,
                    "snr_db": fr.snr_db + (10 * np.log10(2) if fault == "snr_unhalved" else 0),
                    "snr_data_db": fr.snr_data_db, "chan_est": fr.chan_est,
                    "payload": fr.payload})
    return out


def program_slots(host: dict) -> list:
    """The program's valid slots of one call as slot records."""
    out = []
    for i in np.nonzero(host["valid"])[0]:
        r = {f: host[f][i].item() for f in ("start", "mcs", "packet_type_bit", "payload_len",
                                             "crc_ok", "sig_ok", "chan_est_ok", "snr_db",
                                             "snr_data_db")}
        r["chan_est"] = host["chan_est"][i].astype(np.complex128)
        r["payload"] = host["payload"][i, : r["payload_len"]]
        out.append(r)
    return out


FIELDS = ("mcs", "packet_type_bit", "payload_len", "crc_ok", "sig_ok", "chan_est_ok")


def compare_block(prog: list, ref: list) -> dict:
    """The program's slots against the reference's on one block, matched by
    trigger (±2 samples) → unmatched slots, slots whose decoded fields
    differ, the widest SNR gap (dB) and the widest relative error of an NDP
    channel estimate."""
    pairs, used = [], set()
    for p in prog:
        near = [m for m, r in enumerate(ref) if m not in used and abs(r["start"] - p["start"]) <= 2]
        if near:
            used.add(near[0])
            pairs.append((p, ref[near[0]]))
    out = {"slots_unmatched": len(prog) + len(ref) - 2 * len(pairs), "fields_differ": 0,
           "snr_gap_db": 0.0, "chan_est_err": 0.0}
    for p, r in pairs:
        same = all(int(p[f]) == int(r[f]) for f in FIELDS)
        same = same and np.array_equal(p["payload"], r["payload"])
        out["fields_differ"] += not same
        for f in ("snr_db", "snr_data_db"):
            a, b = float(p[f]), float(r[f])
            gap = 0.0 if a == b else abs(a - b)  # equal infinities agree
            out["snr_gap_db"] = max(out["snr_gap_db"], gap if np.isfinite(gap) else np.inf)
        if r["chan_est_ok"]:
            out["chan_est_err"] = max(out["chan_est_err"], rel(
                torch.from_numpy(p["chan_est"]), torch.from_numpy(r["chan_est"])))
    return out


def truth_block(cell: Cell, cap, j: int, slots: list) -> dict:
    """One block's slots against what the generator knows: each NDP channel
    estimate against the channel it applied (N_LTF times each antenna's gain
    1/path_loss at 0°, on the active carriers), up to a common phase, as
    ``chan_truth_err``; and the L-LTF SNR less the SNR of the noiseless frame
    over the injected noise (the mean |FFT|² of its L-LTF's active carriers
    over the noise variance), one gap a frame, under ``snr_truth_gaps``."""
    block_len, n_blocks, _, _ = _geometry(cell)
    span = block_len * n_blocks
    n, placed = len(cap.samples), cap.placed
    h_true = np.full((len(phy.ACTIVE_SC), phy.N_TX), phy.N_LTF / float(cell.mix["path_loss"]))
    err, gaps = 0.0, []
    for s in slots:
        q = (j * span + s["start"]) % n
        k = int(np.searchsorted(placed.pos, q, side="right")) - 1
        if k < 0 or not 0 <= q - placed.pos[k] < TRIGGER_REACH:
            continue
        ltf = cap.clean[placed.pos[k] + LTF_AT : placed.pos[k] + LTF_AT + phy.FFT]
        y = np.fft.fftshift(np.fft.fft(ltf.astype(np.complex128), norm="ortho"))
        gaps.append(float(s["snr_db"]) - 10 * np.log10(
            np.mean(np.abs(y[phy.ACTIVE_SC]) ** 2) / cap.noise_var))
        if s["chan_est_ok"]:
            h = s["chan_est"][phy.ACTIVE_SC]
            ph = np.vdot(h_true, h)
            ph = ph / abs(ph) if ph else 1.0
            err = max(err, float(np.linalg.norm(h - ph * h_true) / np.linalg.norm(h_true)))
    return {"chan_truth_err": err, "snr_truth_gaps": gaps}


def check_blocks(cell: Cell, cap, span: int) -> list[int]:
    """``check_blocks`` block indices drawn from the seed: half among the
    blocks that own a frame, the rest among all."""
    n_blocks = len(cap.samples) // span
    r = generate.rng(cell.seed, 3)
    want = int(cell.mix["check_blocks"])
    with_frames = np.unique((cap.placed.pos + OWN_OFFSET) // span)
    first = r.choice(with_frames, min(len(with_frames), want // 2), replace=False)
    rest = [j for j in r.permutation(n_blocks) if j not in set(first)][: want - len(first)]
    return sorted(int(j) for j in (*first, *rest))


def merge_numbers(parts) -> dict:
    """The numbers of several blocks as one: counts summed, gaps and errors
    the widest, the SNR bias the |mean| of every frame's gap."""
    out: dict = {}
    gaps: list = []
    for p in parts:
        for k, v in p.items():
            if k == "snr_truth_gaps":
                gaps += v
            elif k.startswith(("slots", "fields")):
                out[k] = out.get(k, 0) + v
            else:
                out[k] = max(out.get(k, 0), v)
    if gaps:
        out["snr_truth_bias_db"] = abs(float(np.mean(gaps)))
    return out


def block_numbers(cell: Cell, cap, j: int, slots: list) -> dict:
    """A block's slots (the program's, or the control's in its place) against
    the plain reference and the generator's truth."""
    return {**compare_block(slots, reference_block(cell, cap, j)),
            **truth_block(cell, cap, j, slots)}


def run(cell: Cell) -> Outcome:
    from jrc_tpu_torch.config import OFDMConfig
    from jrc_tpu_torch.io.stream import BlockStreamer

    block_len, n_blocks, slots, max_payload = _geometry(cell)
    conf = cell.config
    span = block_len * n_blocks
    push_n = int(conf["push_samples"])
    cap = generate.rx_capture(cell.mix, cell.seed, cell.device)
    n_cap = len(cap.samples)
    if n_cap % span or n_cap % push_n:
        raise ValueError(f"capture of {n_cap} samples: not a whole number of blocks and pushes")
    n_check = n_cap // span
    check_js = set(check_blocks(cell, cap, span))

    streamer = BlockStreamer(OFDMConfig(), None, block_len=block_len, n_blocks=n_blocks,
                             max_frames=slots, max_payload=max_payload,
                             pipeline_depth=int(conf["pipeline_depth"]), wire=conf["wire"],
                             jit=bool(conf["jit"]), device=cell.device)
    halo = streamer.halo
    pop_spans: list = []
    push_spans: list = []
    if cell.trace:
        streamer.ring = _TimedRing(streamer.ring, pop_spans)

    # p: the next sample of the capture to push; k: calls read back so far; keep: the
    # window has begun
    state = {"p": 0, "k": 0, "keep": False}
    push_returns: list = []
    records: list = []
    kept: dict = {}  # block index → the host result of its first call in the window
    lat: list = []
    read_at: list = []

    def step():
        t = now()
        streamer.push(cap.samples[state["p"] : state["p"] + push_n])
        t_ret = now()
        push_spans.append(t_ret - t)
        state["p"] = (state["p"] + push_n) % n_cap
        push_returns.append(t_ret)
        for res in streamer.process_available():
            host = {f: getattr(res, f).cpu().numpy() for f in res._fields}
            t_read = now()
            k = state["k"]
            state["k"] += 1
            if not state["keep"]:
                continue
            # the push that completed block k: (k + 1)·span + halo samples in
            ready = push_returns[-(-((k + 1) * span + halo) // push_n) - 1]
            lat.append(t_read - ready)
            read_at.append(t_read)
            records.append(_Record(k, host))
            j = k % n_check
            if j in check_js and j not in kept:
                kept[j] = host

    while state["k"] < int(cell.mix["warm_calls"]):  # the graph's capture, then the loop as timed
        step()
    state["keep"] = True
    push_spans.clear()
    pop_spans.clear()
    t0 = now()
    setup_s = t0 - cell.t_start
    while now() - t0 < cell.seconds:
        step()
    t_end = t0 + cell.seconds
    window_calls = sum(t <= t_end for t in read_at)
    per_second_log("calls", read_at, t0, cell.seconds)
    observed = Observed(calls=window_calls, seconds=cell.seconds)
    if cell.trace:
        observed.spans = {"push": list(push_spans), "pop": list(pop_spans)}
        from jrc_bench.trace import trace_calls

        n_trace = int(cell.mix["trace_calls"])
        k_first = state["k"]

        def one_call():
            k = state["k"]
            while state["k"] == k:
                step()

        observed.traced = trace_calls(one_call, n_trace)
        works = [counts.stream_work(counts.rx_stream_samples(block_len, n_blocks, max_payload))
                 for _ in range(state["k"] - k_first)]
        for k in range(k_first, state["k"]):  # the frames the traced calls own
            q = k * span % n_cap
            for idx in np.nonzero((cap.placed.pos + OWN_OFFSET - q) % n_cap < span)[0]:
                works.append(counts.frame_work(cap.placed.specs[cap.placed.kind[idx]]))
        observed.work = counts.merge(works)
    while len(kept) < len(check_js):  # blocks the window did not reach
        step()
    memory = peak_bytes(cell.device)
    dropped = int(streamer.stats.dropped_samples)
    del streamer
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()

    t_check = now()
    attempted, missed, wrong, duplicated, extra = _truth(records, cap, span)
    numbers = {"dropped_samples": dropped, "frames_missed": missed + duplicated,
               "frames_wrong": wrong, "frames_extra": extra}
    numbers.update(merge_numbers(block_numbers(cell, cap, j, program_slots(kept[j]))
                                 for j in sorted(check_js)))
    print(f"reference_s {now() - t_check:.2f}", file=sys.stderr)
    window_lat = [x for x, t in zip(lat, read_at) if t <= t_end]
    e2e = {"rx_msps": window_calls * span / cell.seconds / 1e6,
           "rx_latency_p95_ms": 1e3 * quantile_95(window_lat)}
    return Outcome(setup_s=setup_s, end_to_end=e2e, attempted=attempted,
                   failed=missed + duplicated + wrong, checks=checked(cell, numbers),
                   memory_peak_bytes=memory, observed=observed)


def control(cell: Cell, fault: str | None = None) -> dict:
    """The readings of the reference put in the program's place for one seed,
    on the seed's check blocks, compared as the program is: computed in
    bfloat16 (the control), or in float64 with a planted ``fault``
    (``late_sync``: the frame cut one sample late; ``snr_unhalved``: the
    L-LTF SNR without its factor 1/2)."""
    block_len, n_blocks, _, _ = _geometry(cell)
    span = block_len * n_blocks
    cap = generate.rx_capture(cell.mix, cell.seed, cell.device)
    prec = phy.Prec(bf16=fault is None)
    return merge_numbers(block_numbers(cell, cap, j, reference_block(cell, cap, j, prec=prec,
                                                                     fault=fault))
                         for j in check_blocks(cell, cap, span))
