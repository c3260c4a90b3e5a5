"""The JRC transceiver's dwell loop: ``jrc_step`` captured, the state carried.

Set-up draws the mix's payload and comm-noise pools from the seed
(``generate.dwell_pools``), builds the program's ``models.jrc_trx.JRCTrx``
with the configuration's radar interpolation, wraps it in
``utils.graph.jit`` (one graph for the DATA frame and one for the NDP frame)
and runs the first ``start_dwells`` dwells from the initial state, which
captures both graphs. Dwell d sends the NDP frame where d % ndp_every is
ndp_every − 1, else the DATA frame, with the payload and the noise draw
d % pool of its frame.

The window is a closed loop: call the step, then read in one copy the
results ``apps/jrc_trx`` reads each frame (CRC, SIG, the two SNRs, the
radar detection, power, SNR, range and angle, the steering angle).
``dwells_per_s`` counts the dwells read back inside the window;
``dwell_p95_ms`` is the 95th percentile of call-to-read time.

Checks, after the window, against the plain reference dwell
(``reference/dwell.py``, numpy float64): every DATA dwell of the window
CRC-clean and every NDP dwell's SIG decoded; the start dwells against the
reference run from the initial state on its own state; the program's state
after its last dwell against the reference's own state after as many
dwells modulo 16 (the period of the loop's draws: 16-deep pools, an NDP
every 8th dwell), ``final_dwells`` to ``final_dwells`` + 15 of them, run
with the payloads left undecoded; ``check_dwells`` dwells drawn from the
seed among all the window's dwells, each against the reference run from
the program's state before it; and each detection against the scene's
target (its range and azimuth, in bins of the map). Compared: the flags and
indices exactly (CRC, SIG, detection, range and angle bins, the state's
flags, counts and steering angle), the decoded payload exactly, the
range-angle map relative to its norm, the SNRs, the state's channel
estimate relative to its norm and its background buffer relative to its
largest value.
"""
from __future__ import annotations

import gc
import sys

import numpy as np
import torch

from jrc_bench import counts, generate
from jrc_bench.harness import (Cell, Observed, Outcome, checked, now, peak_bytes,
                               per_second_log, quantile_95)
from jrc_bench.reference import dwell as ref_dwell
from jrc_bench.reference import phy

#: the period of the loop's draws, in dwells
PERIOD = 16


def _specs(mix: dict) -> dict:
    """name → (MCS name, payload bytes, packet type name) of the loop's frames."""
    return {"data": tuple(mix["data"]), "ndp": tuple(mix["ndp"])}


def _kind(cell: Cell, d: int) -> str:
    every = int(cell.config["ndp_every"])
    return "ndp" if every and d % every == every - 1 else "data"


def _step_kwargs(cell: Cell) -> dict:
    t = cell.config
    return dict(radar_aided=bool(t["radar_aided"]), phased_steering=bool(t["phased_steering"]),
                comm_noise_var=float(t["comm_noise_var"]),
                snr_threshold_db=float(t["snr_threshold_db"]))


def _target(cell: Cell) -> tuple:
    """(range m, velocity m/s, azimuth deg, RCS m²) of the scene's one target."""
    return tuple(float(v) for v in cell.config["target"].split(":"))


def _host(res) -> dict:
    """A step result's leaves on the host, by dotted name."""
    out = {}

    def walk(prefix, x):
        if isinstance(x, torch.Tensor):
            out[prefix] = x.detach().cpu().numpy()
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            for f in x._fields:
                walk(f"{prefix}.{f}" if prefix else f, getattr(x, f))

    walk("", res)
    return out


def _state_of(h: dict, prefix: str = "state") -> dict:
    """A reference state from the program's state leaves under ``prefix``."""
    g = {k[len(prefix) + 1:]: v for k, v in h.items() if k.startswith(prefix + ".")}
    return {"chan_est": g["chan_est"].astype(np.complex128), "chan_valid": bool(g["chan_valid"]),
            "radar_angle": float(g["radar_angle"]), "radar_valid": bool(g["radar_valid"]),
            "buffer": g["background.buffer"].astype(np.complex128),
            "count": int(g["background.count"]), "frame_count": int(g["frame_count"])}


class _Reference:
    """The plain reference dwell over the seed's draws (host copies)."""

    def __init__(self, cell: Cell, pools_host: dict, prec: phy.Prec = phy.Prec(),
                 fault: str | None = None):
        self.cell, self.prec, self.fault = cell, prec, fault
        c = cell.config
        self.ax = ref_dwell.radar_axes(int(c["interp_factor_range"]), int(c["interp_factor_angle"]))
        self.kinds = {k: generate.spec_of(v) for k, v in _specs(cell.mix).items()}
        self.target = _target(cell)
        self.pools = pools_host

    def init_state(self) -> dict:
        return ref_dwell.init_state(int(self.cell.config["record_len"]))

    def dwell(self, d: int, state: dict, decode: bool = True) -> ref_dwell.Dwell:
        kind = _kind(self.cell, d)
        i = d % int(self.cell.mix["pool"])
        c = self.cell.config
        return ref_dwell.dwell(state, self.kinds[kind], self.pools["payloads"][kind][i],
                               self.pools["noise"][kind][i], self.target, self.ax,
                               noise_var=float(c["comm_noise_var"]),
                               threshold_db=float(c["snr_threshold_db"]), prec=self.prec,
                               decode=decode, fault=self.fault)


def _ref_leaves(r: ref_dwell.Dwell) -> dict:
    """A reference dwell under the program's leaf names."""
    st = r.state
    return {"comm.decoded.crc_ok": r.comm.crc_ok, "comm.eq.sig_ok": r.comm.sig_ok,
            "comm.eq.snr_legacy": r.comm.snr_db, "comm.eq.snr_data": r.comm.snr_data_db,
            "comm.decoded.payload": r.comm.payload, "radar_est.detected": r.est.detected,
            "radar_est.range_idx": r.est.range_idx, "radar_est.angle_idx": r.est.angle_idx,
            "ra_map": r.ra_map, **_state_leaves(st)}


def _state_leaves(st: dict) -> dict:
    return {"state.chan_valid": st["chan_valid"], "state.radar_valid": st["radar_valid"],
            "state.background.count": st["count"], "state.frame_count": st["frame_count"],
            "state.radar_angle": st["radar_angle"], "state.chan_est": st["chan_est"],
            "state.background.buffer": st["buffer"]}


COUNTS = ("state.background.count", "state.frame_count")
STATE_FLAGS = ("state.chan_valid", "state.radar_valid", *COUNTS, "state.radar_angle")


def _one(x) -> float:
    return float(np.asarray(x).reshape(-1)[0])


def compare_state(prog: dict, ref: dict, counts: bool = True) -> dict:
    """A state's leaves (the program's, or the control's) against the
    reference's: flags, the steering angle and (with ``counts``) the counts
    exactly, the channel estimate relative to its norm, the background
    buffer relative to its largest value."""
    differ = sum(_one(prog[k]) != _one(ref[k]) for k in STATE_FLAGS
                 if counts or k not in COUNTS)
    ce_p, ce_r = np.asarray(prog["state.chan_est"]), np.asarray(ref["state.chan_est"])
    n = np.linalg.norm(ce_r)
    ce = float(np.linalg.norm(ce_p - ce_r) / n) if n else float(np.linalg.norm(ce_p) > 0) * np.inf
    b_p, b_r = np.asarray(prog["state.background.buffer"]), np.asarray(ref["state.background.buffer"])
    top = np.abs(b_r).max()
    bg = float(np.abs(b_p - b_r).max() / top) if top else float(np.abs(b_p).max() > 0) * np.inf
    return {"flags_differ": differ, "chan_est_err": ce, "background_err": bg}


def compare_dwell(prog: dict, ref: dict, with_map: bool = True) -> dict:
    """One dwell's results (the program's leaves, or the control's) against
    the reference's → the compared numbers of that dwell; the map only
    ``with_map`` (see ``check``)."""
    out = compare_state(prog, ref)
    for k in ("comm.decoded.crc_ok", "comm.eq.sig_ok", "radar_est.detected"):
        out["flags_differ"] += bool(_one(prog[k])) != bool(_one(ref[k]))
    if bool(_one(prog["radar_est.detected"])) and bool(_one(ref["radar_est.detected"])):
        for k in ("radar_est.range_idx", "radar_est.angle_idx"):
            out["flags_differ"] += int(_one(prog[k])) != int(_one(ref[k]))
    out["payload_wrong"] = int(not np.array_equal(np.asarray(prog["comm.decoded.payload"]),
                                                  np.asarray(ref["comm.decoded.payload"])))
    gap = 0.0
    for k in ("comm.eq.snr_legacy", "comm.eq.snr_data"):
        a, b = _one(prog[k]), _one(ref[k])
        g = 0.0 if a == b else abs(a - b)
        gap = max(gap, g if np.isfinite(g) else np.inf)
    out["snr_gap_db"] = gap
    if with_map:
        m_p, m_r = np.asarray(prog["ra_map"]), ref["ra_map"]
        out["map_err"] = float(np.linalg.norm(m_p - m_r) / np.linalg.norm(m_r))
    return out


def target_off(cell: Cell, ax, leaves: dict) -> float:
    """How far a detection lies from the scene's target, in bins of the map:
    the larger of the range and the azimuth offsets, each over the bin
    width at the detection (0 where nothing is detected)."""
    if not bool(_one(leaves["radar_est.detected"])):
        return 0.0
    rng, _v, az, _rcs = _target(cell)
    ri, ai = int(_one(leaves["radar_est.range_idx"])), int(_one(leaves["radar_est.angle_idx"]))
    dr = float(ax.ranges[1] - ax.ranges[0])
    j = min(ai, len(ax.angles) - 2)
    da = float(ax.angles[j + 1] - ax.angles[j])
    return max(abs(float(ax.ranges[ri]) - rng) / dr, abs(float(ax.angles[ai]) - az) / da)


def merge_numbers(parts) -> dict:
    out: dict = {}
    for p in parts:
        for k, v in p.items():
            out[k] = out.get(k, 0) + v if k in ("flags_differ", "payload_wrong") \
                else max(out.get(k, 0.0), v)
    return out


def final_dwells(cell: Cell, d_end: int) -> int:
    """The dwell count of the reference's own-state run whose last state the
    program's after ``d_end`` dwells is held against: ``d_end`` modulo the
    period, the first at ``final_dwells`` or more."""
    lo = int(cell.mix["final_dwells"])
    return lo + (d_end - lo) % PERIOD


def check(cell: Cell, ref: _Reference, start_results: list, final: tuple | None,
          checks: list) -> dict:
    """The reference's numbers for one run: ``start_results`` the first
    dwells' leaves from the initial state, ``final`` (dwells done, the state's
    leaves after them), ``checks`` (d, state leaves before d, d's leaves)."""
    state = ref.init_state()
    n_start = len(start_results)
    n_final = final_dwells(cell, final[0]) if final else 0
    ref_start, ref_final = [], None
    for d in range(max(n_start, n_final)):
        r = ref.dwell(d, state, decode=d < n_start)
        state = r.state
        if d < n_start:
            ref_start.append(_ref_leaves(r))
        if d == n_final - 1:
            ref_final = _state_leaves(state)
    parts = [compare_dwell(p, r) for p, r in zip(start_results, ref_start)]
    off = [target_off(cell, ref.ax, p) for p in start_results]
    if final:
        parts.append(compare_state(final[1], ref_final, counts=False))
        # the counts are the dwells done
        parts[-1]["flags_differ"] += sum(int(_one(final[1][k])) != final[0] for k in COUNTS)
    for dd, st_h, res_h in checks:
        # from the program's buffer the map is the reference's estimate less the program's
        # background, so the program's float32 echo no longer cancels in it: not compared
        parts.append(compare_dwell(res_h, _ref_leaves(ref.dwell(dd, _state_of(st_h))),
                                   with_map=False))
        off.append(target_off(cell, ref.ax, res_h))
    numbers = merge_numbers(parts)
    numbers["target_off_bins"] = max(off)
    return numbers


def run(cell: Cell) -> Outcome:
    from jrc_tpu_torch.config import MCS as PMCS
    from jrc_tpu_torch.config import OFDMConfig, PacketType as PType
    from jrc_tpu_torch.models import comm_link, jrc_trx
    from jrc_tpu_torch.ops import channel
    from jrc_tpu_torch.ops.encoder import FrameSpec
    from jrc_tpu_torch.utils import graph

    dev = cell.device
    t = cell.config
    pool = int(cell.mix["pool"])
    kinds = {k: generate.spec_of(v) for k, v in _specs(cell.mix).items()}
    pools = generate.dwell_pools(kinds, pool, cell.seed, dev)
    specs = {k: FrameSpec(PMCS[m], payload_bytes=int(n), packet_type=PType[p])
             for k, (m, n, p) in _specs(cell.mix).items()}
    trx = jrc_trx.JRCTrx(OFDMConfig(), interp_factor_range=int(t["interp_factor_range"]),
                         interp_factor_angle=int(t["interp_factor_angle"]),
                         record_len=int(t["record_len"]), seed=cell.seed & (2**63 - 1),
                         device=dev)
    step = graph.jit(trx, generators=(trx.generator,)) if t["jit"] else trx
    targets = channel.Targets(*((v,) for v in _target(cell))).on(dev)
    kw = _step_kwargs(cell)
    def dwell(d, state):
        kind = _kind(cell, d)
        i = d % pool
        res = step(state, specs[kind], pools.payloads[kind][i], targets,
                   draws=comm_link.Draws(comm_noise=pools.noise[kind][i]), **kw)
        r = res.radar_est
        vals = torch.stack([v.reshape(()).to(torch.float64) for v in (
            res.comm.decoded.crc_ok, res.comm.eq.sig_ok, res.comm.eq.snr_legacy,
            res.comm.eq.snr_data, r.detected, r.power, r.snr_db, r.range_m, r.angle_deg,
            res.state.radar_angle)]).cpu().numpy()
        return res, vals

    n_start = int(cell.mix["start_dwells"])
    state = trx.init_state()
    start_results = []
    for d in range(n_start):
        res, _ = dwell(d, state)
        start_results.append(_host(res))
        state = res.state
    # (d, state before, result) of check_dwells window dwells, a uniform sample
    # drawn from the seed as the window runs (reservoir sampling)
    kept: list = []
    n_keep = int(cell.mix["check_dwells"])
    pick = generate.rng(cell.seed, 4)
    d = n_start
    lat, read_at, failed_dwells, n_data, n_ndp = [], [], 0, 0, 0
    t0 = now()
    setup_s = t0 - cell.t_start

    def one(d, state):
        nonlocal failed_dwells, n_data, n_ndp
        t_call = now()
        res, vals = dwell(d, state)
        t_read = now()
        lat.append(t_read - t_call)
        read_at.append(t_read)
        if _kind(cell, d) == "data":
            n_data += 1
            failed_dwells += not vals[0]
        else:
            n_ndp += 1
            failed_dwells += not vals[1]
        seen = d - n_start + 1
        if len(kept) < n_keep:
            kept.append((d, state, res))
        else:
            j = int(pick.integers(0, seen))
            if j < n_keep:
                kept[j] = (d, state, res)
        return res.state

    while now() - t0 < cell.seconds:
        state = one(d, state)
        d += 1
    t_end = t0 + cell.seconds
    window_dwells = sum(x <= t_end for x in read_at)
    per_second_log("dwells", read_at, t0, cell.seconds)
    observed = Observed(calls=window_dwells, seconds=cell.seconds)
    if cell.trace:
        from jrc_bench.trace import trace_calls

        n_trace = int(cell.mix["trace_calls"])
        box = {"d": d, "state": state}

        def one_traced():
            box["state"] = one(box["d"], box["state"])
            box["d"] += 1

        observed.traced = trace_calls(one_traced, n_trace)
        observed.work = counts.merge(
            [counts.merge([counts.stream_work(counts.dwell_stream_samples(kinds[k])),
                           counts.frame_work(kinds[k])])
             for k in (_kind(cell, x) for x in range(d, d + n_trace))])
        d, state = box["d"], box["state"]
    memory = peak_bytes(dev)
    attempted = n_data + n_ndp
    checks = [(dd, {"state." + k: v for k, v in _host(st).items()}, _host(res))
              for dd, st, res in sorted(kept, key=lambda k: k[0])]
    final = (d, {"state." + k: v for k, v in _host(state).items()})
    pools_host = {"payloads": {k: v.cpu().numpy() for k, v in pools.payloads.items()},
                  "noise": {k: v.cpu().numpy().astype(np.complex128)
                            for k, v in pools.noise.items()}}
    del step, trx, kept, state, pools
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = now()
    numbers = check(cell, _Reference(cell, pools_host), start_results, final, checks)
    print(f"reference_s {now() - t_check:.2f}", file=sys.stderr)
    numbers["dwells_failed"] = failed_dwells
    window_lat = [x for x, tr in zip(lat, read_at) if tr <= t_end]
    e2e = {"dwells_per_s": window_dwells / cell.seconds,
           "dwell_p95_ms": 1e3 * quantile_95(window_lat)}
    return Outcome(setup_s=setup_s, end_to_end=e2e, attempted=attempted, failed=failed_dwells,
                   checks=checked(cell, numbers), memory_peak_bytes=memory, observed=observed)


def control(cell: Cell, fault: str | None = None) -> dict:
    """The readings of the reference put in the program's place for one seed,
    its start dwells from the initial state and its own state after
    ``final_dwells`` dwells, compared as the program's are: computed in
    bfloat16 (the control), or in float64 with a planted ``fault``
    (``range_flip``: the map's range transform taken forward)."""
    kinds = {k: generate.spec_of(v) for k, v in _specs(cell.mix).items()}
    pools = generate.dwell_pools(kinds, int(cell.mix["pool"]), cell.seed, cell.device)
    pools_host = {"payloads": {k: v.cpu().numpy() for k, v in pools.payloads.items()},
                  "noise": {k: v.cpu().numpy().astype(np.complex128)
                            for k, v in pools.noise.items()}}
    put = _Reference(cell, pools_host, prec=phy.Prec(bf16=fault is None), fault=fault)
    state = put.init_state()
    start = []
    n_end = int(cell.mix["final_dwells"])
    for d in range(n_end):
        r = put.dwell(d, state, decode=d < int(cell.mix["start_dwells"]))
        state = r.state
        if d < int(cell.mix["start_dwells"]):
            start.append(_ref_leaves(r))
    return check(cell, _Reference(cell, pools_host), start, (n_end, _state_leaves(state)), [])
