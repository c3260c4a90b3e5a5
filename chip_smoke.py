"""Drive the PyTorch/CUDA port's RX paths, JRC loop, simulation apps, per-block RX,
sharded executors and antenna configurations once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one result line each (more for the kernel checks):
1. device — requires CUDA (there is no CPU path) and prints the card's
   name and power limit;
2. build — compiles the kernels of jrc_tpu_torch/kernels/csrc with nvcc
   (one process per source, in parallel) into build/ and loads them;
3. kernels — each main-path CUDA kernel against its plain PyTorch version
   on the card at the main path's shapes (the fused Viterbi decoder on soft
   values with 20% erasures at (3072, 576), (3072, 24), an odd T, a B that
   is not a multiple of the frames per block, an all-erasure input and a
   24 864-step frame, on both decision routes where both fit: bits exact;
   row gather of 3072 starts, some out of range, int64 and int32, at widths
   383, 1168, 3328 and 7568: exact without ``rot``, within 4e-7 · max|x| with
   it, one launch a call, and one ``extract_frames_batch`` is two launches
   of it and no cos or sin kernel; detection front end over the whole
   bench capture, over an n off every multiple of 128, an n below the
   margin, and at max_peak_distance 320 (the fft_len-128 numerology):
   triggers exact, autocorrelation within rtol = atol = 1e-5), with median
   times (the decoder's with the L2 overwritten before each launch; the
   front end's both ways; the row gather's per width: the wrapped call, the
   kernel alone from a profiler trace, and one advanced-indexing call on
   the same inputs, followed by the derotation expression for ``rot``);
4. main path — StreamingRx over the bench capture (2^15-sample blocks ×
   256, 12 frame slots per block, QPSK-3/4 64-byte frames with CFO and 25 dB
   AWGN, built from the pinned TX frame): every frame must decode with the
   pinned payload, every kernel's launch count must grow in that run, and a
   second run through the plain versions on the card must give identical
   valid/start/crc_ok/payload; samples/s of both;
5. dynamic bench — StreamingRxDynamic (the SIG-driven path) over the same
   capture at max_payload 96: every frame valid and CRC-clean as QPSK-3/4
   with 64 pinned bytes, K1/K2/K3 launched in that run, the plain path
   identical; K1 (3072, 864) and K3 at width 3328 exact against plain;
   K1 there with per-row extents (0, short, 2160, T-7 ... T, past T and
   drawn ones; soft and hard +-1 rows erased past their extents) exact on
   both routes against the plain version with the same extents and the
   full-envelope decode, its time without extents, with them and with every
   row cut to 2160 steps; samples/s of both;
6. mixed traffic — StreamingRxDynamic at max_payload 256 over a 2^23-sample
   capture cycling the seven pinned mixed frames (six MCS and an NDP frame,
   bench CFO, 25 dB AWGN): every placed frame decoded once with its MCS,
   type, length and payload, each NDP frame with a live channel estimate,
   no DATA frame with one; K1 (3072, 2160) and K3 at width 7568 exact
   against plain; the per-row extents check of phase 5 at (3072, 2160)
   and at the receive benchmark's (32, 24 912) (global route); samples/s
   with the kernels and plain;
7. sc16 kernels — K2 and K3 loading the int16 stream of the sc16 wire (the
   bench capture quantized at full scale 1.0) with its scale ``dq``: K2 at
   its four shapes and K3 at the four widths with int32 and int64 starts,
   with and without ``rot``, against their plain versions (exact where the
   fc32 check is exact, within 4e-7 · max|x| for rotated rows) and against
   the same kernels on the pre-dequantized complex64 stream (exact); times
   wrapped and alone, warm and with a cold L2, beside the fc32 ones and the
   two-pass route (one dequantization pass, then the fc32 kernel); K3's
   time right after K2 on each wire (does it find its rows in the L2);
8. sustained ingest — a BlockStreamer (IQ ring → pinned staging → copy
   stream → flat RX) with pipeline_depth 2 and a ring of 4 superblocks on
   the fc32 wire, the sc16 wire and, on fc32, the dynamic path at
   max_payload 96: a warm pass whose one superblock must equal scan_rx on
   the same samples in every field (sc16: the plain-version streamer's),
   then two superblocks pushed and drained inside the clock, five times
   (dynamic: twice): no sample dropped, at least 2·2417 − 1 frames
   CRC-clean each time with the pinned payload, K1-K3 launched, as many
   device kernels a superblock on sc16 as on fc32 (no dequantization
   kernel); samples/s with min-max, the pinned host-to-device rate of one
   superblock, the ring's push and pop time (host clock inside the timed
   runs), launches and device ms a superblock, the ratio sc16 / fc32, and
   the sc16 rate when the samples are pushed as int16 (``push_sc16``);
9. jit — ``BlockStreamer(jit=True)`` (each call one captured CUDA graph,
   ``jrc_tpu_torch.utils.graph``) against ``jit=False`` on the same pushes,
   for the fc32, sc16 and dynamic streamers of phase 8: every field of
   every superblock equal, exactly (the warm one and five runs of two), a
   result kept from superblock k unchanged after two superblocks of zeros
   through the same graph, one graph captured; side by side samples/s with
   min-max, host ms, device ms and kernels a superblock (a profiler trace;
   it sees a graph's kernels), ring push and pop ms, host syncs, memory (a
   run's peak above its start; what the streamer holds: captured, the
   graph's static input and outputs too) and the first superblock's time
   (the capture's cost: their difference); ``flat_rx_dynamic`` at max_payload 96 under
   ``torch.cuda.set_sync_debug_mode("error")``; one BER-sweep curve
   (QPSK-3/4, the sweep's six SNRs, 32 frames of CPU-drawn noise) captured,
   eager and on the CPU, equal frame for frame, with a point's frames/s,
   device ms and host syncs captured against eager. Then the repo's other
   compile sites (``bench.py``'s dwell and loop step, the Doppler train's
   estimate, the sharded step and the batched executors), each against its
   eager run: 8 ``jrc_step`` dwells of one seed (``graph.jit(trx,
   generators=(trx.generator,))``, the state carried, the scene as
   ``Targets.on``) at phase 12's operating point, every field equal bit for
   bit, one graph, the generators equal after, the first call launching
   each of K1-K3 twice as often as an eager dwell (warm-up and capture), a
   replay through no wrapper and its trace holding the eager dwell's
   K1-K3; the pinned jrc_tpu dwells through a captured step; 8
   ``radar_frame`` dwells with a random phase and thermal noise drawn from
   a registered generator; a 64-burst Doppler train's estimates (equal,
   velocity within ±1 bin); on a world of one over NCCL ``sharded_rx`` and
   ``sharded_rx_dynamic`` (bench capture, 2560 slots: 2417 frames
   CRC-clean, equal to scan_rx's), ``batched_rx`` (32 blocks) and
   ``batched_range_angle_maps`` (the 8 radar dwells' estimates), captured
   inside against ``graph.eager()``; steps/s and dwells/s with min-max,
   device ms, launches and host syncs (none in ``jrc_step`` or
   ``radar_frame``), warm-up, capture and instantiation ms, held memory,
   and the world-1 step's wall ms both ways. The earlier phases pass
   ``jit=False`` (and the BER sweep of phase 13 too; phase 15 runs under
   ``graph.eager()``), so that their launch counts and rows stay
   comparable;
10. soft and STA — StreamingRx over the bench capture with soft=True and
   with estimator="sta": every frame CRC-clean with the pinned payload,
   the plain path identical; then ``decoder.decode_frame(soft=True,
   noise_var=v)`` at v = 0.05 and 1e-4 on 3072 copies of the pinned frame's
   data symbols with noise of variance v drawn on the card (seeded): every
   frame CRC-clean with the pinned payload and scrambler seed, K1's bits on
   the scaled LLRs exact against the plain version on both routes, the call
   equal under the plain versions; its K1 launches count in the kernels line;
11. kernel pieces — the profiling entry (jrc_tpu_torch.profiling) once with
   the launch counts read, then every variant of P1-P3 at the TPU scripts'
   shapes against its plain version (P1 state, P2 rows, P3 words and
   metrics at chunk_t 16, 32 and 64: exact), with the wrapped time, the
   kernel alone (its device events in a profiler trace), back to back (20
   calls in a row), the plain version's and, for P2, one ``xp[idx]`` on the
   same inputs (the index built outside the timing); P1 once more at 863 steps,
   where roll8 and concat do not end where they began;
12. jrc — the JRC closed loop through ``models.jrc_trx.JRCTrx`` on the card
   (OFDMConfig(): 4 TX, 2 RX, 24 GHz; DATA frames QPSK-3/4 of 80 B, NDP
   QPSK-1/2 of 24 B; a target at 12 m, 25°, RCS 10 m²; range ×8, angle ×16;
   comm noise variance 1e-4): tx_frame against the four golden frames that
   need no random draw and the pinned bench frame (1e-5 · max|want|); the
   dwells that jrc_tpu pinned in jrc_tpu_torch/data/jrc_dwells.npz with
   their draws (exact fields equal, floats within 1e-5 · max|want|, SNRs
   within 1e-3 dB); the moving-target loop of tests/test_jrc.py (detected
   every dwell within 2.5° and 0.6 m, CRC-clean from dwell 1, radar-aided
   gain over the Fourier fallback ≥ 3 dB on average and > 0 each) and NDP
   → steered DATA; one jrc_step at the operating point with the launch
   counts read, and each of its K1, K2 and K3 calls again against the plain
   version on the same inputs, with times; radar dwells and JRC steps per
   second (median of 20 after a warm-up, min-max), device ms, launches and
   host syncs (none allowed in jrc_step); apps/jrc_trx of the port on the
   card for 16 frames (every burst det=True, CRC-clean from frame 1);
13. sim — the simulation and evaluation apps on the card: apps/ber_sweep's
   sweep at its defaults (6 MCS × 6 SNRs × 32 frames of 64 B, each point one
   batch through ``evaluation.link_curve(jit=False)``: K1 2, K2 1, K3 2
   launches a point; every MCS clean at 22 dB), each point timed alone (frames/s,
   device ms, launches, host syncs), and one point's K1-K3 calls against
   their plain versions with times; link_curve's gates: (a) BPSK-1/2 and
   16-QAM-3/4 at tests/golden_ber.json's SNRs, 8 frames of CPU-drawn noise,
   on the card (a captured curve) and through the plain versions on the CPU: every frame's bit
   errors and CRC flag equal; (b) every golden point with 48 frames of the
   card's own draws, each PER within 4·sqrt(q(1−q)/48) + 2/48 of the
   golden's, q = max(golden, 2/48), and the MCS whose curve 1 dB lower
   would trip the gate counted; apps/comm_sim for 6 frames with SVD
   steering (every DATA frame CRC-clean); apps/radar_sim with two targets
   and --max-targets 3 --cfar --window-range hann (both found within 1 m and
   3°, the CFAR peak bins detected; CLEAN and CFAR on the card equal to the
   CPU on the same map; a dwell's wall and device ms, launches, host
   syncs); apps/jrc_trx --doppler-frames 64 with
   a target at 30 m/s (within ±1 velocity bin), and test_doppler.py's
   64-burst train through SimTrx on the card (within ±1 bin; the
   range-Doppler map and estimate equal to the CPU's on the same history);
   apps/alignment (phase steps within 1° of the expected step, lines equal
   to a CPU run's);
14. block — the per-block RX on the bench capture: the windowed scan (257
   blocks of 32704 samples, a multiple of 64 and not of 128; the capture
   zero-padded to the blocks and their halo) and the sequential scan
   (batched=False, the first 32 blocks of 2^15: a cut in depth only), each
   static and dynamic (max_payload 96), 12 slots a block: every frame whose
   trigger lies in the decoded span (windowed: all 2417) CRC-clean with the
   pinned payload, its start, payload and CRC flag (dynamic: MCS and length)
   equal to the flat path's, its SNR within 1e-4 dB of it, K2 launched once
   a block, the plain versions identical in every field but the floats;
   samples/s, device ms, launches and host syncs of each;
15. mesh — the sharded executors, op by op: a world of one over NCCL (a file store
   in a temporary directory, the group destroyed after) running sharded_rx
   and sharded_rx_dynamic on the bench capture as one block with 2560 slots
   (equal to scan_rx's frames: start, payload, CRC, SIG, MCS, length, type;
   SNR within 1e-4 dB) and batched_rx on 32 blocks of it (equal to rx_block
   block by block); then the capture over two gloo ranks decoding on this
   one card (NCCL takes one rank a card), two scripts/multihost_rx_torch.py
   processes, at block_len 2^22 (flat_rx) and 2^22 + 64 (rx_block): 2417
   frames CRC-clean static and dynamic, global starts equal to scan_rx's;
   then ``python -m jrc_tpu_torch.parallel.dryrun --world 1`` (the dry run
   of the sharded executors on NCCL) as a subprocess with a time limit:
   rank 0's ``DRYRUN_OK`` line, its steps captured and equal to their eager
   runs, and exit code 0 after ``mesh.teardown``;
16. configs — the antenna configurations jrc_tpu accepts beside its default
   (n_tx, n_rx, n_ltf) = (1, 1, 1), (2, 1, 2), (1, 2, 1), (4, 4, 4), (3, 2, 4):
   the __graft_entry__.py dwell (64-B QPSK-3/4, a static target at 12 m and
   25°, radar-aided phased steering) three times in a row, and an NDP frame
   whose estimate steers a DATA frame with radar streams, through JRCTrx on
   the card and on the CPU with the same seeded draws (exact fields equal,
   floats within 1e-5 · max, SNRs within 1e-3 dB), every K1/K2/K3 call of
   the sounding dwells and of one entry dwell (timed) against its plain
   version;
   scan_rx at n_ltf 2 on a 2^20-sample capture of frames the port encodes
   there (every frame CRC-clean with its payload, the plain path's run
   equal); viterbi_decode_chunked (plain torch) against
   K1 at (3072, 576) with 20% erasures (bits equal but on exactly tied
   paths, equal to the CPU's; both timed);
   runtime.mean_power against numpy (1 ulp of float32).
Every run's launched kernels must be the registry's for its path
(``kernels.registry.PATHS``). Then one line per main-path kernel (ms of one
wrapped call, the kernel alone where a trace gave it, bound, share of bound,
launches per run of each path; the row gather's are its rotated calls at the
static path's two widths, summed, its library time indexing followed by the
derotation), one per kernel at the JRC comm leg's shapes and at the BER
sweep's, the launches per path,
the ``{"sustained": ...}``, ``{"jit": ...}``, ``{"jrc": ...}``, ``{"sim": ...}``,
``{"block": ..., "mesh": ...}`` and ``{"configs": ...}`` lines, a JSON line of
per-kernel results (launches summed over the path runs of phases 4-16 and
per registry path, times from phases 3, 7, 11 and 12; K2's and K3's figures
on the int16 stream under ``sc16``, at the JRC shapes under ``jrc``, at the
BER sweep's under ``sim``, at each antenna configuration under ``configs``; bound_ms is the
larger of the bytes each input and output must move once over 3.35 TB/s and
the float32 operations over 67 TFLOP/s, from this run's shapes), the card
line, and the JSON status line. Any failed check raises, and the script
exits non-zero.
"""
from __future__ import annotations

import collections
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from jrc_tpu_torch.capture import ANTENNA_CONFIGS
from jrc_tpu_torch.kernels.registry import (
    KERNELS, launch_counts, plain_kernels, reset_counts, rx_path_kernels,
)
from jrc_tpu_torch.profiling import bound


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def viterbi_bound(b: int, t: int) -> tuple[float, str]:
    """(b, 2t) float32 values in, (b, t) uint8 bits out; 64 states a step,
    each two adds, a compare-select, a compare of the 64-way min and a
    subtract."""
    return bound(b * (8 * t + t), b * t * 64 * 5)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def wall_s(fn, reps: int) -> float:
    """Median host time of ``fn`` with a synchronize around each run."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def counted(fn):
    """Run ``fn`` with every launch count set to 0 just before and read just
    after → (its result, {kernel: launches} of the kernels it launched)."""
    torch.cuda.synchronize()
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: c for k, c in launch_counts().items() if c}


def bench_setup(block_len: int, n_blocks: int, max_frames: int, dev):
    """(cfg, spec, model on dev, capture on dev, n_frames, payload, frame length)."""
    from jrc_tpu_torch.config import MCS, OFDMConfig, PacketType
    from jrc_tpu_torch import capture
    from jrc_tpu_torch.models.streaming import StreamingRx
    from jrc_tpu_torch.ops.encoder import FrameSpec

    cfg = OFDMConfig()
    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=64, packet_type=PacketType.DATA)
    frame, payload, halo = capture.load_bench_frame()
    cap, n_frames = capture.build_capture(frame, block_len * n_blocks, halo=halo)
    model = StreamingRx(cfg, spec, block_len, n_blocks, max_frames_per_block=max_frames, device=dev)
    x = torch.from_numpy(cap).to(dev)
    return cfg, spec, model, x, n_frames, payload, len(frame)


def check_viterbi(v, trellis, what: str, routes=("shared", "global")) -> int:
    """The fused decoder on (B, 2T) values against the plain version, bits
    exactly equal, on each of ``routes`` → max_abs_err (0)."""
    from jrc_tpu_torch.ops import viterbi, viterbi_cuda

    want = viterbi.viterbi_decode_plain(v, trellis)
    err = 0
    for route in routes:
        got = viterbi_cuda.viterbi_decode(v, trellis, route=route)
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == want.dtype, f"viterbi_decode shape ({what})")
        check(torch.equal(got, want), f"viterbi_decode kernel != plain ({what}, {route} route)")
        err = max(err, int((got.int() - want.int()).abs().max()) if got.numel() else 0)
    return err


def soft_values(rng, n_frames: int, t: int, dev):
    """(n_frames, 2t) normal soft values with 20% erasures on ``dev``."""
    vals = rng.normal(0, 1, (n_frames, 2 * t)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.2] = 0.0  # erasures
    return torch.from_numpy(vals).to(dev)


def check_gather(xp, starts, widths, rot=None, dq=None, dequantized=None) -> float:
    """K3 against its plain version at each width: exactly equal without
    ``rot``, within ROT_ATOL · max|x| with it → the largest difference. With
    ``dq`` the stream is int16 pairs and ``dequantized`` its complex64 form:
    the kernel's rows on the two must be exactly equal."""
    from jrc_tpu_torch.ops import gather_cuda

    err = 0.0
    x_max = float((xp if dq is None else dequantized).abs().max())
    for w in widths:
        before = launch_counts()["gather_rows"]
        got = gather_cuda.gather_rows(xp, starts, w, rot=rot, dq=dq)
        check(launch_counts()["gather_rows"] == before + 1, "gather_rows: one launch a call")
        want = gather_cuda.gather_rows_plain(xp, starts, w, rot=rot, dq=dq)
        what = f"width {w}, {starts.dtype} starts{'' if dq is None else ', int16 stream'}"
        if rot is None:
            check(torch.equal(got, want), f"gather_rows kernel != plain at {what}")
        else:
            diff = float((torch.view_as_real(got) - torch.view_as_real(want)).abs().max())
            check(diff <= gather_cuda.ROT_ATOL * x_max,
                  f"rotated gather_rows differs from plain by {diff} at {what}")
            err = max(err, diff)
        if dq is not None:
            check(torch.equal(got, gather_cuda.gather_rows(dequantized, starts, w, rot=rot)),
                  f"gather_rows on int16 != on the dequantized stream at {what}")
    return err


def dynamic_width(cfg, max_payload: int) -> int:
    """extract_frames_batch's symbol window of the dynamic path."""
    from jrc_tpu_torch.ops import dynamic_rx

    n_sym = 3 + cfg.n_ltf + dynamic_rx.max_symbols(max_payload, cfg.n_data_carriers)
    return 2 * cfg.fft_len + (n_sym - 2) * cfg.sym_len


def phase_gather(cfg, model, xp, dev, n_rows: int, reps: int) -> dict:
    """K3 at the three paths' widths against its plain version, its times
    per width, and the launches of one extract_frames_batch."""
    from jrc_tpu_torch.ops import gather_cuda, sync
    from jrc_tpu_torch.profiling import device_events, device_ms, time_ms

    n = xp.shape[0]
    rng = np.random.default_rng(3)
    n_sym = 2 + 1 + cfg.n_ltf + model.spec.n_ofdm_sym
    static_widths = (cfg.n_sync_words * cfg.sym_len + cfg.fft_len - 1,
                     2 * cfg.fft_len + (n_sym - 2) * cfg.sym_len)
    widths = (*static_widths, dynamic_width(cfg, 96), dynamic_width(cfg, 256))
    omega = torch.from_numpy(rng.uniform(-0.02, 0.02, n_rows).astype(np.float32)).to(dev)
    err = 0.0
    for dtype in (np.int32, np.int64):
        starts = torch.from_numpy(rng.integers(-1000, n + 1000, n_rows).astype(dtype)).to(dev)
        n0 = torch.from_numpy(rng.integers(0, 2 * cfg.sym_len, n_rows).astype(dtype)).to(dev)
        check_gather(xp, starts, widths)
        err = max(err, check_gather(xp, starts, widths, rot=(omega, None)),
                  check_gather(xp, starts, widths, rot=(omega, n0)))

    def derotated(rows, w):  # the plain derotation expression on gathered rows
        k = n0.to(torch.float32)[:, None] + torch.arange(w, dtype=torch.float32, device=dev)[None, :]
        return rows * sync.expj(omega[:, None] * k)

    shapes = []
    for w in widths:
        # the yardstick: one advanced-indexing call, its index built outside the timing
        idx = starts.clamp(0, n - w)[:, None] + torch.arange(w, device=dev)
        check(torch.equal(xp[idx], gather_cuda.gather_rows(xp, starts, w)), "library gather differs")
        for rot in (None, (omega, n0)):
            def call():
                return gather_cuda.gather_rows(xp, starts, w, rot=rot)

            kernel_only, launches = device_ms(call)
            check(launches == 1, f"gather_rows is {launches} device launches a call")
            # complex64 rows read and written once, the starts (and omega, n0) read
            bound_ms, bound_by = bound(2 * 8 * n_rows * w + (8 if rot is None else 20) * n_rows, 0)
            sh = {"width": w, "rot": rot is not None, "ms": time_ms(call, reps),
                  "kernel_only_ms": kernel_only, "bound_ms": bound_ms, "bound_by": bound_by,
                  "plain_ms": time_ms(
                      lambda: gather_cuda.gather_rows_plain(xp, starts, w, rot=rot), 5),
                  "library_ms": time_ms((lambda: xp[idx]) if rot is None
                                        else (lambda: derotated(xp[idx], w)), reps)}
            shapes.append(sh)
            print(f"kernels: K3 width {w}{' rot' if sh['rot'] else ''}: wrapped {sh['ms']:.4f} ms, "
                  f"kernel alone {kernel_only:.4f} ms, bound {bound_ms:.4f} ms, plain "
                  f"{sh['plain_ms']:.4f} ms, indexing{' + derotation' if sh['rot'] else ''} "
                  f"{sh['library_ms']:.4f} ms", flush=True)

    # one extract_frames_batch: K3 twice, and no kernel of the old derotation
    trig = starts.clamp(0, n - 4096)
    cfo = omega * 0.01

    def extract():
        return sync.extract_frames_batch(cfg, xp, trig, cfo, n_sym)

    _, counts = counted(extract)
    check(counts == {"gather_rows": 2}, f"extract_frames_batch launched {counts}")
    names = [e["name"] for e in device_events(extract, 1)]
    check(sum("gather_rows_kernel" in nm for nm in names) == 2, "extract_frames_batch: K3 twice")
    for op in ("cos_kernel", "sin_kernel"):  # the derotation's own (ltf_correlate keeps a complex)
        check(not any(op in nm for nm in names), f"extract_frames_batch still launches {op}")
    print(f"kernels: K3 exact at widths {widths} with int64 and int32 starts, rotated within "
          f"{gather_cuda.ROT_ATOL:g} · max|x| (max |err| {err:.3g}); one extract_frames_batch is "
          f"{len(names)} device launches, 2 of them K3, none cos or sin", flush=True)
    # the row's figures: the main path's calls (rotated) at the static path's two widths
    main = [sh for sh in shapes if sh["rot"] and sh["width"] in static_widths]
    total = {key: sum(sh[key] for sh in main)
             for key in ("ms", "kernel_only_ms", "plain_ms", "bound_ms", "library_ms")}
    return dict(max_abs_err=err, **total, bound_by="bytes", shapes=shapes,
                library="x[idx] followed by the derotation expression (several launches); "
                        "where rot is false in shapes, x[idx] alone")


def phase_detect(cfg, xp, dev, reps: int) -> dict:
    """K2 against its plain version over the bench capture and at the edge
    shapes; its time warm and with a cold L2."""
    from jrc_tpu_torch.ops import detect_cuda
    from jrc_tpu_torch.profiling import device_ms, l2_flusher, time_ms

    def kw_of(fft_len, cp_len):
        return dict(threshold=0.6, min_n_peaks=10, max_peak_distance=2 * (fft_len + cp_len),
                    lag=fft_len // 4, win=fft_len // 2, pwin=int(1.5 * (fft_len // 2)))

    kw = kw_of(cfg.fft_len, cfg.cp_len)
    margin = detect_cuda.margin_samples(kw["max_peak_distance"])
    n = xp.shape[0]
    err, triggers = 0.0, {}
    for what, xs, kws in (
            ("bench capture", xp, kw),
            ("n off every multiple of 128", xp[: 3 * 2**15 + 77], kw),
            ("n below the margin", xp[400 : 400 + margin - 50], kw),
            ("max_peak_distance 320", xp[: 2**21 + 5], kw_of(128, 32))):
        before = launch_counts()["detect_front_end"]
        a_k, first_k, count_k = detect_cuda.detect_front_end(xs, **kws)
        check(launch_counts()["detect_front_end"] == before + 1, "detect: one launch a call")
        a_p, first_p, count_p = detect_cuda.detect_front_end_plain(xs, **kws)
        check(torch.equal(first_k, first_p), f"detect seg_first kernel != plain ({what})")
        check(torch.equal(count_k, count_p), f"detect seg_count kernel != plain ({what})")
        ar_k, ar_p = torch.view_as_real(a_k), torch.view_as_real(a_p)
        torch.testing.assert_close(ar_k, ar_p, rtol=1e-5, atol=1e-5)
        err = max(err, float((ar_k - ar_p).abs().max()))
        triggers[what] = int(count_k.sum())
    check(triggers["bench capture"] > 0 and triggers["max_peak_distance 320"] > 0,
          f"detect: no trigger to compare ({triggers})")
    # complex64 samples in, autocorrelation out, two int32 per 128-sample segment;
    # per sample a complex product (6), |x|^2 (3), the two running sums (6), the
    # normalized magnitude and its compare (5)
    bound_ms, bound_by = bound(16 * n + 8 * -(-n // 128), 20 * n)

    def call():
        return detect_cuda.detect_front_end(xp, **kw)

    kernel_only, launches = device_ms(call)
    check(launches == 1, f"detect_front_end is {launches} device launches a call (a padded copy?)")
    res = dict(max_abs_err=err, ms=time_ms(call, reps), cold_ms=time_ms(call, reps, l2_flusher(dev)),
               kernel_only_ms=kernel_only,
               plain_ms=time_ms(lambda: detect_cuda.detect_front_end_plain(xp, **kw), reps),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    print(f"kernels: K2 over {n} samples and at the edge shapes {triggers}: first/count exact, "
          f"max |a err| {err:.3g}; {res['ms']:.4f} ms warm, {res['cold_ms']:.4f} ms with a cold L2, "
          f"kernel alone {kernel_only:.4f} ms (one launch, no padded copy) vs plain "
          f"{res['plain_ms']:.4f} ms", flush=True)
    return res


#: K2's trigger selection at the receive benchmark's shapes: (what, block_len, max_frames)
SELECTION_SHAPES = (("the live receiver's block (rx_mixed_*)", 2**16, 32),
                    ("a sharded rank's block (rx_sharded4)", 2**21, 1024))


def phase_selection(cfg, dev, reps: int) -> list:
    """K2 with its trigger selection (``detect_cuda.Rows.blocks``, one row)
    at ``SELECTION_SHAPES``, each block behind the detector's history and
    ahead of the 3100-B halo, over the mixed frames: the four fields of
    ``sync.Detections`` exactly equal to the plain version's, and so over
    the same K2 outputs with a trigger in every segment (the 4·max_frames
    cut bites); the selection kernel's time alone in the call, the call's
    device time, and the PyTorch composition it replaced → a row per shape."""
    from jrc_tpu_torch import capture
    from jrc_tpu_torch.models.streaming import frame_window_samples_dynamic, left_history_samples
    from jrc_tpu_torch.ops import detect_cuda
    from jrc_tpu_torch.profiling import device_ms, time_ms

    left = left_history_samples(cfg)
    halo = frame_window_samples_dynamic(cfg, 3100) + cfg.fft_len
    ignore_gap = (cfg.n_sync_words + cfg.n_tx) * cfg.sym_len
    lag = cfg.fft_len // 4
    kw = dict(threshold=0.6, min_n_peaks=10, max_peak_distance=2 * cfg.sym_len, lag=lag,
              win=cfg.fft_len // 2, pwin=int(1.5 * (cfg.fft_len // 2)))
    frames = [f.samples for f in capture.load_mixed_frames()]
    rows_out = []
    for what, block_len, max_frames in SELECTION_SHAPES:
        cap, placed = capture.build_mixed_capture(frames, left + block_len, halo=halo)
        x = torch.from_numpy(cap).to(dev)
        rows = detect_cuda.Rows.blocks(left, block_len, 1, ignore_gap=ignore_gap,
                                       max_frames=max_frames)
        before = launch_counts()["detect_front_end"]
        got = detect_cuda.detect_front_end(x, **kw, rows=rows)
        check(launch_counts()["detect_front_end"] == before + 1,
              f"selection: one wrapped call a detection ({what})")
        want = detect_cuda.detect_front_end_plain(x, **kw, rows=rows)
        for name, g, w in zip(got._fields, got, want):
            check(g.dtype == w.dtype and torch.equal(g, w),
                  f"K2's trigger selection kernel != plain in {name} at {what}")
        n_valid = int(got.valid.sum())
        check(n_valid > max_frames // 4, f"selection: {n_valid} triggers at {what}")
        # the same K2 outputs with a trigger in every segment but the last
        a, first, count = detect_cuda.detect_front_end(x, **kw)
        gen = torch.Generator(device=dev).manual_seed(block_len)
        full = torch.randint(0, detect_cuda.SEG, first.shape, device=dev, generator=gen,
                             dtype=torch.int32)
        full[-1] = detect_cuda.SEG
        check(rows.span - 1 > 4 * max_frames, f"selection: no cut at {what}")
        g_full = detect_cuda.select(a, full, torch.ones_like(count), rows, lag)
        w_full = detect_cuda.select_plain(a, full, torch.ones_like(count), rows, lag)
        for name, g, w in zip(g_full._fields, g_full, w_full):
            check(torch.equal(g, w), f"K2's trigger selection != plain in {name} at {what}, "
                                     f"a trigger in every segment")

        def call():
            return detect_cuda.detect_front_end(x, **kw, rows=rows)

        def old():
            return detect_cuda.select_plain(*detect_cuda.detect_front_end(x, **kw), rows, lag)

        call_ms, launches = device_ms(call)
        check(launches == 2, f"K2 with its selection is {launches} device launches ({what})")
        row = dict(what=what, block_len=block_len, max_frames=max_frames, segments=rows.span,
                   frames_placed=len(placed), triggers=n_valid, symbol="select_kernel",
                   select_ms=device_ms(call, name="select_kernel")[0],
                   k2_ms=device_ms(lambda: detect_cuda.detect_front_end(x, **kw))[0],
                   call_ms=call_ms, ms=time_ms(call, reps), old_ms=time_ms(old, 3))
        rows_out.append(row)
        print(f"kernels: K2 with its trigger selection at {what} ({block_len} samples, "
              f"{max_frames} slots, {rows.span} segments, {len(placed)} frames placed, "
              f"{n_valid} triggers): start/cfo/valid/n_candidates exact, and exact with a "
              f"trigger in every segment; select_kernel alone {row['select_ms']:.4f} ms, "
              f"K2 alone {row['k2_ms']:.4f} ms, the call {call_ms:.4f} ms in 2 launches "
              f"({row['ms']:.4f} ms between events) vs the PyTorch composition "
              f"{row['old_ms']:.4f} ms", flush=True)
        del x
    return rows_out


def phase_kernels(cfg, model, x, dev, n_frames_k1: int, t_k1: int, reps: int) -> dict:
    """Each kernel against its plain version on ``dev`` at the main path's
    shapes; returns {name: {max_abs_err, ms, plain_ms, bound_ms, bound_by,
    library_ms}}."""
    from jrc_tpu_torch.models.streaming import left_history_samples
    from jrc_tpu_torch.ops import viterbi, viterbi_cuda
    from jrc_tpu_torch.profiling import l2_flusher, time_ms, warm_up

    results = {}
    trellis = model.constants().trellis
    rng = np.random.default_rng(0)
    v = soft_values(rng, n_frames_k1, t_k1, dev)
    err = check_viterbi(v, trellis, f"({n_frames_k1}, {t_k1})")
    # the SIG call, an odd T, a B off the frames per block, every compare a tie
    err = max(err, check_viterbi(soft_values(rng, n_frames_k1, 24, dev), trellis,
                                 f"({n_frames_k1}, 24)"))
    err = max(err, check_viterbi(soft_values(rng, 64, 333, dev), trellis, "(64, 333)"))
    b_odd = 4 * viterbi_cuda.FRAMES_PER_BLOCK + 1
    err = max(err, check_viterbi(soft_values(rng, b_odd, 100, dev), trellis, f"({b_odd}, 100)"))
    err = max(err, check_viterbi(torch.zeros(b_odd, 2 * t_k1, device=dev), trellis,
                                 "all erasures"))
    # a 3100-byte BPSK-1/2 frame: too long for shared memory, the scratch route
    t_long = 16 + 8 * (3100 + 4) + 16
    check(viterbi_cuda.decision_route(5, t_long) == "global",
          "a long frame takes the scratch route")
    err = max(err, check_viterbi(soft_values(rng, 5, t_long, dev), trellis, f"(5, {t_long})",
                                 routes=("global",)))
    flush = l2_flusher(dev)
    warm_up(lambda: viterbi_cuda.viterbi_decode(v, trellis))
    bound_ms, bound_by = viterbi_bound(n_frames_k1, t_k1)
    results["viterbi_decode"] = dict(
        max_abs_err=err, ms=time_ms(lambda: viterbi_cuda.viterbi_decode(v, trellis), reps, flush),
        plain_ms=time_ms(lambda: viterbi.viterbi_decode_plain(v, trellis), 3),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    print(f"kernels: K1 fused decode exact on both routes at ({n_frames_k1}, {t_k1}), "
          f"({n_frames_k1}, 24), (64, 333), ({b_odd}, 100), all erasures, and (5, {t_long}) on the "
          f"scratch route; ({n_frames_k1}, {t_k1}) {results['viterbi_decode']['ms']:.4f} ms (cold "
          f"L2) vs plain {results['viterbi_decode']['plain_ms']:.4f} ms", flush=True)

    xp = torch.cat([torch.zeros(left_history_samples(cfg), dtype=x.dtype, device=dev), x])
    results["gather_rows"] = phase_gather(cfg, model, xp, dev, n_frames_k1, reps)
    results["detect_front_end"] = phase_detect(cfg, xp, dev, reps)
    results["detect_front_end"]["selection"] = phase_selection(cfg, dev, reps)
    return results


def check_main_path_counts(counts: dict, path: str) -> None:
    for name in rx_path_kernels():
        check(counts.get(name, 0) > 0, f"kernel {name} was not launched on the {path}")


def check_bench_frames(res, n_frames: int, payload, frame_len: int, path: str) -> np.ndarray:
    """Every bench frame valid and CRC-clean with the pinned payload, its
    trigger inside its STF → the valid mask."""
    valid = res.valid.cpu().numpy()
    n_crc = int(res.crc_ok.sum())
    check(valid.sum() == n_crc == n_frames,
          f"{path}: valid {valid.sum()} / crc_ok {n_crc} / frames {n_frames}")
    got = res.payload.cpu().numpy()[valid][:, : len(payload)]
    check((got == payload[None, :]).all(), f"{path}: payload differs from the pinned payload")
    # frames sit at 500 + k·(len + 2111); the trigger fires inside the STF
    true_pos = 500 + np.arange(n_frames) * (frame_len + 2111)
    starts = np.sort(res.start.cpu().numpy()[valid])
    check(((starts - true_pos >= 0) & (starts - true_pos <= 64)).all(),
          f"{path}: trigger positions off the placed frames")
    return valid


def check_same(res, res_plain, fields, path: str) -> None:
    for field in fields:
        check(torch.equal(getattr(res, field), getattr(res_plain, field)),
              f"{path}: kernel path and plain path differ in {field}")


def phase_main_path(model, x, n_frames: int, payload, frame_len: int, reps: int):
    """Drive StreamingRx, check it, compare with the plain path; returns
    (launch counts of the checked run, kernel-path s, plain-path s)."""
    n_samples = model.block_len * model.n_blocks
    model(x)  # warm-up (cuFFT plans, allocator)
    res, counts = counted(lambda: model(x))
    check_main_path_counts(counts, "main path")

    valid = check_bench_frames(res, n_frames, payload, frame_len, "main path")
    snr = res.snr_db.cpu().numpy()[valid]
    check(np.isfinite(snr).all(), "non-finite SNR")

    with plain_kernels():
        res_p = model(x)
    torch.cuda.synchronize()
    check_same(res, res_p, ("valid", "start", "crc_ok", "payload"), "main path")
    t_k = wall_s(lambda: model(x), reps)
    with plain_kernels():
        t_p = wall_s(lambda: model(x), reps)
    print(f"main path: {n_frames} frames, valid == crc_ok == {int(valid.sum())}, payloads ok, "
          f"SNR {snr.mean():.2f} dB; launches {counts}; plain path identical; "
          f"{n_samples / t_k:.6g} samples/s (kernels, {t_k * 1e3:.3f} ms) vs "
          f"{n_samples / t_p:.6g} samples/s (plain, {t_p * 1e3:.3f} ms) over {n_samples} samples",
          flush=True)
    return counts, t_k, t_p


def viterbi_extents(rng, b: int, t: int) -> np.ndarray:
    """(b,) per-row extents in shuffled order: 0, short ones, the dense mix's
    longest frame (2160 steps), T-7 ... T and past T, the rest drawn from
    [0, T]."""
    fixed = [0, 1, 5, 6, 7, 100, 2160, *range(t - 7, t + 1), t + 100]
    ext = rng.integers(0, t + 1, b)
    ext[:min(b, len(fixed))] = fixed[:b]
    return rng.permutation(ext)


def check_viterbi_extents(rng, b: int, t: int, trellis, dev, k1_shapes: list) -> str:
    """K1 with per-row extents (``viterbi_extents``) on every route that fits
    (b, t), over soft and hard +-1 rows (ties) that are erasures past their
    extents, against the plain version with the same extents and against
    the full-envelope decode, bits exactly equal; the times of the build
    without extents, with them and with every row cut to 2160 steps (cold L2)
    go to ``k1_shapes``."""
    from jrc_tpu_torch.ops import viterbi, viterbi_cuda
    from jrc_tpu_torch.profiling import l2_flusher, time_ms, warm_up

    v = soft_values(rng, b, t, dev)
    v[::2] = torch.sign(v[::2])  # hard rows: ties everywhere
    ext = viterbi_extents(rng, b, t)
    past = torch.arange(t, device=dev)[None, :] >= torch.from_numpy(ext).to(dev)[:, None]
    v = v.reshape(b, t, 2).masked_fill(past[..., None], 0.0).reshape(b, 2 * t)
    n = torch.from_numpy(ext).to(dev)
    what = f"({b}, {t}) with extents"
    full = viterbi.viterbi_decode_plain(v, trellis)
    check(torch.equal(viterbi.viterbi_decode_plain(v, trellis, n_steps=n), full),
          f"viterbi_decode_plain with extents != full envelope {what}")
    routes = [r for r in ("shared", "global")
              if r == "global" or viterbi_cuda.shared_block_bytes(t) <= viterbi_cuda.MAX_BLOCK_SMEM]
    for route in routes:
        for steps in (None, n):
            got = viterbi_cuda.viterbi_decode(v, trellis, route=route, n_steps=steps)
            torch.cuda.synchronize()
            check(torch.equal(got, full), f"viterbi_decode kernel (extents: {steps is not None}) "
                                          f"!= plain full envelope {what}, {route} route")
    short = n.clamp_max(2160)
    flush = l2_flusher(dev)
    warm_up(lambda: viterbi_cuda.viterbi_decode(v, trellis, n_steps=n))
    bound_ms, bound_by = viterbi_bound(b, t)
    k1_shapes.append({
        "B": b, "T": t, "route": viterbi_cuda.decision_route(b, t),
        "ms": time_ms(lambda: viterbi_cuda.viterbi_decode(v, trellis), 20, flush),
        "ms_extents": time_ms(lambda: viterbi_cuda.viterbi_decode(v, trellis, n_steps=n), 20,
                              flush),
        "ms_extents_2160": time_ms(
            lambda: viterbi_cuda.viterbi_decode(v, trellis, n_steps=short), 20, flush),
        "bound_ms": bound_ms, "bound_by": bound_by})
    sh = k1_shapes[-1]
    return (f"K1 {what} exact on the {' and '.join(routes)} route(s), {sh['ms']:.4f} ms without "
            f"extents, {sh['ms_extents']:.4f} ms with them (longest row T), "
            f"{sh['ms_extents_2160']:.4f} ms with every row at most 2160 steps (cold L2)")


def check_dynamic_shapes(model, x, rng, dev, k1_shapes: list) -> str:
    """K1 at the model's (slots, max_trellis_bits), on both decision routes,
    without extents and with the per-row extents the dynamic path passes,
    and K3 at its extraction width against the plain versions (shapes the
    static path never runs); K1's times there (cold L2) go to ``k1_shapes``."""
    from jrc_tpu_torch.ops import dynamic_rx

    cfg = model.cfg
    n_slots = model.n_blocks * model.max_frames_per_block
    t = dynamic_rx.max_trellis_bits(model.max_payload, cfg.n_data_carriers)
    trellis = model.constants().trellis
    check_viterbi(soft_values(rng, n_slots, t, dev), trellis, f"({n_slots}, {t})")
    k1 = check_viterbi_extents(rng, n_slots, t, trellis, dev, k1_shapes)
    width = dynamic_width(cfg, model.max_payload)
    check_gather(x, torch.from_numpy(rng.integers(-1000, x.shape[0] + 1000, n_slots)).to(dev),
                 (width,))
    return f"K1 ({n_slots}, {t}) exact on both routes; {k1}; and K3 width {width} exact"


def phase_dynamic_bench(cfg, x, n_frames: int, payload, frame_len: int, dev, reps: int,
                        block_len: int, n_blocks: int, k1_shapes: list):
    """StreamingRxDynamic over the bench capture at max_payload 96 (the
    reference bench's dynamic_sps configuration) → launch counts."""
    from jrc_tpu_torch.config import MCS
    from jrc_tpu_torch.models.streaming import StreamingRxDynamic

    model = StreamingRxDynamic(cfg, block_len, n_blocks, max_frames_per_block=12,
                               max_payload=96, device=dev)
    n_samples = model.block_len * model.n_blocks
    model(x)  # warm-up
    res, counts = counted(lambda: model(x))
    check_main_path_counts(counts, "dynamic path")
    valid = check_bench_frames(res, n_frames, payload, frame_len, "dynamic path")
    check((res.mcs.cpu().numpy()[valid] == int(MCS.QPSK_3_4)).all(), "dynamic: MCS not QPSK-3/4")
    check((res.payload_len.cpu().numpy()[valid] == len(payload)).all(), "dynamic: payload_len")

    with plain_kernels():
        res_p = model(x)
    torch.cuda.synchronize()
    check_same(res, res_p, ("valid", "start", "crc_ok", "payload", "mcs"), "dynamic path")
    shapes = check_dynamic_shapes(model, x, np.random.default_rng(1), dev, k1_shapes)
    t_k = wall_s(lambda: model(x), reps)
    with plain_kernels():
        t_p = wall_s(lambda: model(x), 2)
    print(f"dynamic bench: max_payload 96, {n_frames} frames, valid == crc_ok == "
          f"{int(valid.sum())}, all QPSK-3/4 64 B with the pinned payload; launches {counts}; "
          f"plain path identical; {shapes}; {n_samples / t_k:.6g} samples/s (kernels, "
          f"{t_k * 1e3:.3f} ms) vs {n_samples / t_p:.6g} samples/s (plain, {t_p * 1e3:.3f} ms)",
          flush=True)
    return counts


def phase_mixed(cfg, dev, reps: int, block_len: int, n_blocks: int, k1_shapes: list):
    """StreamingRxDynamic at max_payload 256 over a capture of n_blocks
    blocks cycling the seven pinned mixed frames → launch counts."""
    from jrc_tpu_torch import capture
    from jrc_tpu_torch.models.streaming import StreamingRxDynamic, frame_window_samples_dynamic
    from jrc_tpu_torch.ops import dynamic_rx

    max_payload = 256
    frames = capture.load_mixed_frames()
    halo = frame_window_samples_dynamic(cfg, max_payload) + cfg.fft_len
    cap, placed = capture.build_mixed_capture([f.samples for f in frames], block_len * n_blocks,
                                              halo=halo)
    x = torch.from_numpy(cap).to(dev)
    model = StreamingRxDynamic(cfg, block_len, n_blocks, max_frames_per_block=12,
                               max_payload=max_payload, device=dev)
    model(x)  # warm-up
    res, counts = counted(lambda: model(x))
    check_main_path_counts(counts, "mixed-traffic path")

    r = {f: getattr(res, f).cpu().numpy() for f in res._fields}
    valid = r["valid"]
    check(valid.sum() == len(placed), f"mixed: {valid.sum()} valid slots for {len(placed)} frames")
    slots = np.nonzero(valid)[0][np.argsort(r["start"][valid], kind="stable")]
    pos, kind = placed[:, 0], placed[:, 1]
    off = r["start"][slots] - pos
    check(((off >= 0) & (off <= 64)).all(), "mixed: trigger positions off the placed frames")
    check(r["crc_ok"][slots].all() and r["sig_ok"][slots].all(), "mixed: a frame failed SIG or CRC")
    want = {f: np.array([getattr(frames[k], f) for k in kind]) for f in ("mcs", "packet_type_bit")}
    check((r["mcs"][slots] == want["mcs"]).all(), "mixed: MCS differs")
    check((r["packet_type_bit"][slots] == want["packet_type_bit"]).all(), "mixed: packet type")
    lens = np.array([len(frames[k].payload) for k in kind])
    check((r["payload_len"][slots] == lens).all(), "mixed: payload_len differs")
    for k, f in enumerate(frames):
        rows = r["payload"][slots[kind == k], : len(f.payload)]
        check((rows == f.payload[None, :]).all(), f"mixed: payload of frame kind {k} differs")
    is_ndp = want["packet_type_bit"] == 0
    check((r["chan_est_ok"][slots] == is_ndp).all(), "mixed: chan_est_ok != (frame is NDP)")
    check(r["chan_est_ok"].sum() == is_ndp.sum(), "mixed: chan_est_ok outside placed NDP frames")
    h_active = np.abs(r["chan_est"][slots[is_ndp]][:, cfg.active_carrier_idx])
    check(np.isfinite(h_active).all() and h_active.min() > 0.1,
          "mixed: NDP channel estimate not live on the active carriers")

    shapes = check_dynamic_shapes(model, x, np.random.default_rng(2), dev, k1_shapes)
    # the receive benchmark's K1: 32 slots over the 3100-B envelope
    t_rx = dynamic_rx.max_trellis_bits(3100, cfg.n_data_carriers)
    shapes += "; " + check_viterbi_extents(np.random.default_rng(3), 32, t_rx,
                                           model.constants().trellis, dev, k1_shapes)
    n_samples = block_len * n_blocks
    t_k = wall_s(lambda: model(x), reps)
    with plain_kernels():
        res_p = model(x)
        t_p = wall_s(lambda: model(x), 1)
    torch.cuda.synchronize()
    check_same(res, res_p, ("valid", "start", "crc_ok", "payload", "mcs", "packet_type_bit",
                            "chan_est_ok"), "mixed-traffic path")
    per_kind = np.bincount(kind, minlength=len(frames)).tolist()
    print(f"mixed traffic: max_payload 256, {len(placed)} frames (per kind {per_kind}; "
          f"{int(is_ndp.sum())} NDP), each decoded once with its MCS/type/length/payload, "
          f"NDP chan_est live (min |h| {h_active.min():.3g}); launches {counts}; plain path "
          f"identical; {shapes}; {n_samples / t_k:.6g} samples/s (kernels, {t_k * 1e3:.3f} ms) "
          f"vs {n_samples / t_p:.6g} samples/s (plain, {t_p * 1e3:.3f} ms)", flush=True)
    return counts


def kernel_alone_after(first, second, name: str, flush, runs: int = 10) -> float:
    """Mean device ms of the kernel ``name`` launched by ``second`` when it
    runs right after ``first`` (or alone where ``first`` is None), the L2
    overwritten before each pair."""
    from jrc_tpu_torch.profiling import device_events

    def pair():
        flush()
        if first is not None:
            first()
        second()

    pair()
    durs = [e["dur"] for e in device_events(pair, runs) if name in e["name"]]
    check(len(durs) == runs, f"{len(durs)} {name} launches in a trace of {runs} calls")
    return sum(durs) / runs / 1e3


def phase_sc16_kernels(cfg, model, xp, dev, n_rows: int, reps: int) -> dict:
    """K2 and K3 on the int16 form of the bench stream against their plain
    versions and against themselves on the dequantized stream; times beside
    the two-pass route → {kernel name: figures on the int16 stream}."""
    from jrc_tpu_torch.ops import detect_cuda, gather_cuda, wire
    from jrc_tpu_torch.profiling import device_ms, l2_flusher, time_ms
    from jrc_tpu_torch.runtime import quantize_sc16

    n = xp.shape[0]
    dq = wire.dq_scale(1.0)
    q = torch.from_numpy(quantize_sc16(xp.cpu().numpy())).to(dev)
    xd = wire.dequantize(q, dq)
    check(float((xd - xp).abs().max()) <= 0.75 * dq
          and float(torch.view_as_real(xp).abs().max()) < 1.0,
          "the bench stream does not fit the sc16 full scale")
    flush = l2_flusher(dev)

    def two_pass(fn):  # the route the fused loads avoid: one dequantization pass, then fc32
        return lambda: fn(torch.view_as_complex(q.to(torch.float32) * dq))

    # ---- K2
    def kw_of(fft_len, cp_len):
        return dict(threshold=0.6, min_n_peaks=10, max_peak_distance=2 * (fft_len + cp_len),
                    lag=fft_len // 4, win=fft_len // 2, pwin=int(1.5 * (fft_len // 2)))

    kw = kw_of(cfg.fft_len, cfg.cp_len)
    margin = detect_cuda.margin_samples(kw["max_peak_distance"])
    triggers = {}
    for what, lo, hi, kws in (
            ("bench capture", 0, n, kw), ("n off every multiple of 128", 0, 3 * 2**15 + 77, kw),
            ("n below the margin", 400, 400 + margin - 50, kw),
            ("max_peak_distance 320", 0, 2**21 + 5, kw_of(128, 32))):
        before = launch_counts()["detect_front_end"]
        got = detect_cuda.detect_front_end(q[lo:hi], dq=dq, **kws)
        check(launch_counts()["detect_front_end"] == before + 1, "detect: one launch a call")
        want = detect_cuda.detect_front_end_plain(q[lo:hi], dq=dq, **kws)
        on_float = detect_cuda.detect_front_end(xd[lo:hi], **kws)
        for name, g, w, f in zip(("a", "seg_first", "seg_count"), got, want, on_float):
            check(torch.equal(g, f), f"detect {name} on int16 != on the dequantized stream ({what})")
            if name == "a":
                torch.testing.assert_close(torch.view_as_real(g), torch.view_as_real(w),
                                           rtol=1e-5, atol=1e-5)
            else:
                check(torch.equal(g, w), f"detect {name} kernel != plain on int16 ({what})")
        triggers[what] = int(got[2].sum())
    check(triggers["bench capture"] > 0 and triggers["max_peak_distance 320"] > 0,
          f"detect on int16: no trigger to compare ({triggers})")
    err_a = float((torch.view_as_real(got[0]) - torch.view_as_real(want[0])).abs().max())

    def k2():
        return detect_cuda.detect_front_end(q, dq=dq, **kw)

    def k2_fc32(x=xp):
        return detect_cuda.detect_front_end(x, **kw)

    kernel_only, launches = device_ms(k2)
    check(launches == 1, f"detect_front_end on int16 is {launches} device launches a call")
    # int16 pairs in (4 B a sample), autocorrelation out, two int32 per segment
    bound_ms, bound_by = bound(12 * n + 8 * -(-n // 128), 20 * n)
    out = {"detect_front_end": dict(
        max_abs_err=err_a, ms=time_ms(k2, reps), cold_ms=time_ms(k2, reps, flush),
        kernel_only_ms=kernel_only, bound_ms=bound_ms, bound_by=bound_by,
        plain_ms=time_ms(lambda: detect_cuda.detect_front_end_plain(q, dq=dq, **kw), reps),
        library_ms=time_ms(two_pass(k2_fc32), reps), fc32_ms=time_ms(k2_fc32, reps),
        fc32_cold_ms=time_ms(k2_fc32, reps, flush), fc32_kernel_only_ms=device_ms(k2_fc32)[0],
        library="q.to(float32) * dq viewed as complex, then the fc32 kernel (two passes)")}
    r = out["detect_front_end"]
    print(f"sc16 kernels: K2 on the int16 stream at {triggers}: exact against plain and against "
          f"the dequantized stream (max |a - plain a| {err_a:.3g}); {r['ms']:.4f} ms warm, "
          f"{r['cold_ms']:.4f} ms cold L2, kernel alone {kernel_only:.4f} ms, bound "
          f"{bound_ms:.4f} ms; fc32 {r['fc32_ms']:.4f} / {r['fc32_cold_ms']:.4f} ms, alone "
          f"{r['fc32_kernel_only_ms']:.4f} ms; two-pass route {r['library_ms']:.4f} ms; plain "
          f"{r['plain_ms']:.4f} ms", flush=True)

    # ---- K3
    rng = np.random.default_rng(4)
    n_sym = 2 + 1 + cfg.n_ltf + model.spec.n_ofdm_sym
    static_widths = (cfg.n_sync_words * cfg.sym_len + cfg.fft_len - 1,
                     2 * cfg.fft_len + (n_sym - 2) * cfg.sym_len)
    widths = (*static_widths, dynamic_width(cfg, 96), dynamic_width(cfg, 256))
    omega = torch.from_numpy(rng.uniform(-0.02, 0.02, n_rows).astype(np.float32)).to(dev)
    err = 0.0
    for dtype in (np.int32, np.int64):
        starts = torch.from_numpy(rng.integers(-1000, n + 1000, n_rows).astype(dtype)).to(dev)
        n0 = torch.from_numpy(rng.integers(0, 2 * cfg.sym_len, n_rows).astype(dtype)).to(dev)
        for rot in (None, (omega, None), (omega, n0)):
            err = max(err, check_gather(q, starts, widths, rot=rot, dq=dq, dequantized=xd))
    shapes = []
    for w in widths:
        for rot in (None, (omega, n0)):
            def k3(x=q, d=dq):
                return gather_cuda.gather_rows(x, starts, w, rot=rot, dq=d)

            def k3_fc32(x=xp):
                return gather_cuda.gather_rows(x, starts, w, rot=rot)

            kernel_only, launches = device_ms(k3)
            check(launches == 1, f"gather_rows on int16 is {launches} device launches a call")
            # int16 rows read (4 B a sample), complex64 rows written, starts (omega, n0) read
            bound_ms, bound_by = bound(12 * n_rows * w + (8 if rot is None else 20) * n_rows, 0)
            sh = {"width": w, "rot": rot is not None, "ms": time_ms(k3, reps),
                  "cold_ms": time_ms(k3, reps, flush), "kernel_only_ms": kernel_only,
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "plain_ms": time_ms(
                      lambda: gather_cuda.gather_rows_plain(q, starts, w, rot=rot, dq=dq), 5),
                  "library_ms": time_ms(two_pass(k3_fc32), reps),
                  "fc32_ms": time_ms(k3_fc32, reps), "fc32_cold_ms": time_ms(k3_fc32, reps, flush),
                  "fc32_kernel_only_ms": device_ms(k3_fc32)[0]}
            if rot is not None:  # does K3 find in the L2 what K2 just read?
                name = "gather_rows_kernel"
                sh["after_k2_ms"] = kernel_alone_after(k2, k3, name, flush)
                sh["alone_cold_ms"] = kernel_alone_after(None, k3, name, flush)
                sh["fc32_after_k2_ms"] = kernel_alone_after(k2_fc32, k3_fc32, name, flush)
                sh["fc32_alone_cold_ms"] = kernel_alone_after(None, k3_fc32, name, flush)
            shapes.append(sh)
            l2 = (f"; kernel alone after K2 / cold {sh['after_k2_ms']:.4f} / "
                  f"{sh['alone_cold_ms']:.4f} ms (fc32 {sh['fc32_after_k2_ms']:.4f} / "
                  f"{sh['fc32_alone_cold_ms']:.4f})" if rot is not None else "")
            print(f"sc16 kernels: K3 width {w}{' rot' if sh['rot'] else ''} on int16: wrapped "
                  f"{sh['ms']:.4f} ms warm, {sh['cold_ms']:.4f} cold, kernel alone "
                  f"{kernel_only:.4f} ms, bound {bound_ms:.4f} ms ("
                  f"{100 * bound_ms / kernel_only:.1f}%); fc32 {sh['fc32_ms']:.4f} / "
                  f"{sh['fc32_cold_ms']:.4f} ms, alone {sh['fc32_kernel_only_ms']:.4f} ms; "
                  f"two-pass route {sh['library_ms']:.4f} ms; plain {sh['plain_ms']:.4f} ms{l2}",
                  flush=True)
    print(f"sc16 kernels: K3 on the int16 stream exact against plain at widths {widths} with int64 "
          f"and int32 starts (rotated within {gather_cuda.ROT_ATOL:g} · max|x|, max |err| "
          f"{err:.3g}) and exactly its rows on the dequantized stream", flush=True)
    main = [sh for sh in shapes if sh["rot"] and sh["width"] in static_widths]
    total = {key: sum(sh[key] for sh in main) for key in (
        "ms", "cold_ms", "kernel_only_ms", "plain_ms", "bound_ms", "library_ms", "fc32_ms",
        "fc32_kernel_only_ms")}
    out["gather_rows"] = dict(
        max_abs_err=err, **total, bound_by="bytes", shapes=shapes,
        library="q.to(float32) * dq viewed as complex, then the fc32 kernel (two passes)")
    return out


def result_fields(res) -> dict:
    return {f: getattr(res, f) for f in res._fields}


def check_sustained_frames(results, n_frames: int, payload, path: str, mcs=None) -> int:
    """The results of two superblocks: at least 2·n_frames − 1 frames valid
    and CRC-clean (the ring keeps the last straddling frame pending), every
    one with the pinned payload → the CRC-clean count."""
    n_crc = 0
    for res in results:
        ok = res.crc_ok.cpu().numpy()
        check((ok == res.valid.cpu().numpy()).all(), f"{path}: a detected frame failed its CRC")
        got = res.payload.cpu().numpy()[ok][:, : len(payload)]
        check((got == payload[None, :]).all(), f"{path}: payload differs from the pinned payload")
        if mcs is not None:
            check((res.mcs.cpu().numpy()[ok] == mcs).all(), f"{path}: MCS differs")
            check((res.payload_len.cpu().numpy()[ok] == len(payload)).all(), f"{path}: length")
        n_crc += int(ok.sum())
    check(n_crc >= 2 * n_frames - 1, f"{path}: {n_crc} CRC-clean frames of {2 * n_frames}")
    return n_crc


def clock_ring(streamer) -> dict:
    """Wrap the streamer's ring passes (push, push_sc16, pop_block) so that
    each adds its host time to the returned {name: seconds}."""
    ring_s = {"push": 0.0, "push_sc16": 0.0, "pop_block": 0.0}

    def clocked(name):
        fn = getattr(streamer.ring, name)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            ring_s[name] += time.perf_counter() - t0
            return out
        return timed

    for name in ring_s:
        if hasattr(streamer.ring, name):
            setattr(streamer.ring, name, clocked(name))
    return ring_s


def phase_sustained(cfg, spec, cap: np.ndarray, reference, n_frames: int, payload, dev,
                    block_len: int, n_blocks: int, wire: str, reps: int, max_payload: int = 96):
    """One BlockStreamer configuration: warm pass held against ``reference``
    (a function of the streamer giving the result its first superblock must
    equal), then ``reps`` timed runs of two superblocks → (launch counts of
    one timed run, figures)."""
    from jrc_tpu_torch.config import MCS
    from jrc_tpu_torch.io.stream import BlockStreamer
    from jrc_tpu_torch.profiling import device_events
    from jrc_tpu_torch.runtime import quantize_sc16

    n_samples = block_len * n_blocks
    path = f"sustained {'dynamic' if spec is None else 'static'} {wire}"
    streamer = BlockStreamer(cfg, spec, block_len=block_len, n_blocks=n_blocks, max_frames=12,
                             max_payload=max_payload, pipeline_depth=2,
                             ring_capacity=4 * n_samples, wire=wire, jit=False)
    check(streamer.push(cap) == len(cap), f"{path}: the warm push dropped samples")
    (warm,) = list(streamer.process_available())
    want, exact = reference(streamer)
    for f, got in result_fields(warm).items():
        w = getattr(want, f)
        if exact or not (got.is_floating_point() or got.is_complex()):
            check(torch.equal(got, w), f"{path}: the warm superblock differs in {f}")
        else:  # against the plain versions: the rotated rows' stated tolerance
            torch.testing.assert_close(got[warm.valid], w[warm.valid], rtol=1e-4, atol=1e-3)
    check(int(warm.crc_ok.sum()) == n_frames, f"{path}: warm pass decoded {int(warm.crc_ok.sum())}")
    mcs = int(MCS.QPSK_3_4) if spec is None else None

    ring_s = clock_ring(streamer)  # the host clock around the ring's passes, in the timed runs

    def run(push=streamer.push, block=cap[:n_samples]):
        check(push(block) == n_samples and push(block) == n_samples,
              f"{path}: a push dropped samples")
        return list(streamer.process_available())

    def timed_runs(run_once):
        """→ (wall s of each run, ring push s and pop s of each, CRC-clean frames)."""
        walls, pushes, pops, n_ok = [], [], [], None
        for _ in range(reps):
            ring_s.update(dict.fromkeys(ring_s, 0.0))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = run_once()
            walls.append(time.perf_counter() - t0)  # the last readback closed the pipeline
            pushes.append(ring_s["push"] + ring_s["push_sc16"])
            pops.append(ring_s["pop_block"])
            check(len(results) == 2, f"{path}: {len(results)} superblocks from two pushes")
            n_ok = check_sustained_frames(results, n_frames, payload, path, mcs)
        return walls, pushes, pops, n_ok

    walls, pushes, pops, n_crc = timed_runs(run)
    results, counts = counted(run)
    check_main_path_counts(counts, path)
    check_sustained_frames(results, n_frames, payload, path, mcs)
    events = device_events(run, 3)  # six superblocks
    kernels = sorted(e["name"].split("<")[0] for e in events if e.get("cat") == "kernel")
    check(streamer.stats.dropped_samples == 0, f"{path}: {streamer.stats.dropped_samples} dropped")

    # the transfer leg alone: one superblock, pinned, on the streamer's own buffers
    slot = streamer._slots[0]
    h2d = wall_s(lambda: slot.dev.copy_(slot.host, non_blocking=True), 5)
    n_bytes = slot.host.numel() * slot.host.element_size()
    wall = statistics.median(walls)
    fig = {
        "samples_per_s": 2 * n_samples / wall, "samples_per_s_min": 2 * n_samples / max(walls),
        "samples_per_s_max": 2 * n_samples / min(walls), "wall_ms_per_superblock": 1e3 * wall / 2,
        "crc_ok": n_crc, "h2d_MBps": n_bytes / h2d / 1e6, "h2d_ms": 1e3 * h2d,
        "ring_push_ms": 1e3 * statistics.median(pushes) / 2,
        "ring_pop_ms": 1e3 * statistics.median(pops) / 2,
        "device_ms_per_superblock": sum(
            e["dur"] for e in events if e.get("cat") != "gpu_memcpy") / 6e3,
        "copy_engine_ms_per_superblock": sum(
            e["dur"] for e in events if e.get("cat") == "gpu_memcpy") / 6e3,
        "kernels_per_superblock": len(kernels) / 6, "kernel_names": kernels}
    fig["ring_share"] = (fig["ring_push_ms"] + fig["ring_pop_ms"]) / fig["wall_ms_per_superblock"]
    native = ""
    if wire == "sc16":  # what a radio that delivers int16 sees: no quantizing pass in the push
        q = quantize_sc16(cap[:n_samples])
        walls_n, pushes_n, _, _ = timed_runs(lambda: run(streamer.push_sc16, q))
        fig["native_push_samples_per_s"] = 2 * n_samples / statistics.median(walls_n)
        fig["native_push_samples_per_s_min"] = 2 * n_samples / max(walls_n)
        fig["native_push_samples_per_s_max"] = 2 * n_samples / min(walls_n)
        fig["native_ring_push_ms"] = 1e3 * statistics.median(pushes_n) / 2
        check(streamer.stats.dropped_samples == 0, f"{path}: native pushes dropped samples")
        native = (f"; pushed as int16 (push_sc16, no quantizing pass) "
                  f"{fig['native_push_samples_per_s']:.6g} samples/s (min "
                  f"{fig['native_push_samples_per_s_min']:.6g}, max "
                  f"{fig['native_push_samples_per_s_max']:.6g}), ring push "
                  f"{fig['native_ring_push_ms']:.3f} ms")
    print(f"{path}: warm superblock equal to {'scan_rx' if exact else 'the plain-version streamer'}"
          f" ({n_frames} frames); {reps} runs of two superblocks: {n_crc} of {2 * n_frames} frames "
          f"CRC-clean with the pinned payload, no sample dropped, launches {counts}; "
          f"{fig['samples_per_s']:.6g} samples/s (min {fig['samples_per_s_min']:.6g}, max "
          f"{fig['samples_per_s_max']:.6g}), {fig['wall_ms_per_superblock']:.3f} ms a superblock: "
          f"ring push {fig['ring_push_ms']:.3f} + pop {fig['ring_pop_ms']:.3f} ms "
          f"({100 * fig['ring_share']:.1f}% of it), pinned h2d {fig['h2d_ms']:.3f} ms = "
          f"{fig['h2d_MBps']:.6g} MB/s, device {fig['device_ms_per_superblock']:.3f} ms in "
          f"{fig['kernels_per_superblock']:.0f} kernels and "
          f"{fig['copy_engine_ms_per_superblock']:.3f} ms of copies in the trace{native}",
          flush=True)
    return counts, fig


def phase_ingest(cfg, spec, model, x, n_frames: int, payload, dev, block_len: int, n_blocks: int):
    """The three sustained configurations → ({path: launch counts}, figures)."""
    from jrc_tpu_torch.io.stream import BlockStreamer
    from jrc_tpu_torch.models.streaming import StreamingRxDynamic

    cap = x.cpu().numpy()

    def scan_rx_of(m):  # the same samples through the entry point: equal in every field
        return lambda streamer: (m(x[: m.block_len * m.n_blocks + streamer.halo]), True)

    def plain_streamer(streamer):  # the sc16 wire through the plain versions on the card
        with plain_kernels():
            p = BlockStreamer(cfg, spec, block_len=block_len, n_blocks=n_blocks, max_frames=12,
                              wire="sc16", jit=False)
            p.push(cap)
            (res,) = list(p.process_available())
        return res, False

    dyn = StreamingRxDynamic(cfg, block_len, n_blocks, max_frames_per_block=12, max_payload=96,
                             device=dev)
    counts, figs = {}, {}
    for name, sp, wire, ref, reps in (
            ("sustained_fc32", spec, "fc32", scan_rx_of(model), 5),
            ("sustained_sc16", spec, "sc16", plain_streamer, 5),
            ("sustained_dynamic", None, "fc32", scan_rx_of(dyn), 2)):
        counts[name], figs[name] = phase_sustained(cfg, sp, cap, ref, n_frames, payload, dev,
                                                   block_len, n_blocks, wire, reps)
    fc32, sc16 = figs["sustained_fc32"], figs["sustained_sc16"]
    check(sc16["kernel_names"] == fc32["kernel_names"],
          "the sc16 wire launches other kernels than the fc32 wire (a dequantization pass?)")
    check(counts["sustained_sc16"] == counts["sustained_fc32"], "sc16 and fc32 launch counts differ")
    for fig in figs.values():
        del fig["kernel_names"]
    ratio = sc16["samples_per_s"] / fc32["samples_per_s"]
    print(f"sustained: sc16 / fc32 = {ratio:.3f}; the sc16 wire runs the same "
          f"{sc16['kernels_per_superblock']:.0f} kernels a superblock as fc32 (no dequantization "
          f"kernel); dynamic / static on fc32 = "
          f"{figs['sustained_dynamic']['samples_per_s'] / fc32['samples_per_s']:.3f}", flush=True)
    return counts, dict(figs, sustained_wire_speedup=ratio)


def superblock_fields_equal(got: list, want: list, what: str) -> None:
    """Two runs' superblocks equal in every field, exactly."""
    check(len(got) == len(want), f"{what}: {len(got)} superblocks against {len(want)}")
    for k, (a, b) in enumerate(zip(got, want)):
        for f, v in result_fields(b).items():
            check(torch.equal(getattr(a, f), v), f"{what}: superblock {k} differs in {f}")


def sync_count(run) -> int:
    """Host syncs of one ``run`` (warnings of the sync debug mode)."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message).lower() for w in caught)


def phase_jit(cfg, spec, x, n_frames: int, payload, dev, block_len: int, n_blocks: int,
              reps: int) -> dict:
    """``jit=True`` (one captured CUDA graph a call) against ``jit=False`` on
    the same pushes: the fc32, sc16 and dynamic streamers at the sustained
    phase's shapes, every field of every superblock equal, a kept result
    unchanged after two more superblocks, the figures side by side; the
    dynamic flat pass under the sync debug mode "error"; one BER-sweep curve
    captured against eager and against the CPU frame for frame → figures."""
    from jrc_tpu_torch import tables
    from jrc_tpu_torch.apps import ber_sweep
    from jrc_tpu_torch.config import MCS
    from jrc_tpu_torch.io.stream import BlockStreamer
    from jrc_tpu_torch.models import comm_link, evaluation, streaming as st
    from jrc_tpu_torch.ops import channel
    from jrc_tpu_torch.profiling import device_events
    from jrc_tpu_torch.utils import graph

    n = block_len * n_blocks
    cap = x.cpu().numpy()
    left = st.left_history_samples(cfg)
    xp = torch.cat([torch.zeros(left, dtype=x.dtype, device=dev), x])
    tab = tables.from_numpy_dynamic(cfg, 96, dev)
    flat_dyn = lambda: st.flat_rx_dynamic(cfg, tab, xp, block_len, n_blocks, left,  # noqa: E731
                                          max_frames=12, max_payload=96)
    flat_dyn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = flat_dyn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(int(res.crc_ok.sum()) == n_frames, "flat_rx_dynamic under the sync check: frames lost")
    print(f"jit: flat_rx_dynamic at max_payload 96 over the bench capture ran under "
          f"set_sync_debug_mode('error'): no host sync, {n_frames} frames CRC-clean", flush=True)
    del xp, res

    figs = {}
    for name, sp, wire in (("fc32", spec, "fc32"), ("sc16", spec, "sc16"),
                           ("dynamic", None, "fc32")):
        what = f"jit {name}"
        modes = {}
        for jit in (False, True):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            s = BlockStreamer(cfg, sp, block_len=block_len, n_blocks=n_blocks, max_frames=12,
                              max_payload=96, pipeline_depth=2, ring_capacity=4 * n, wire=wire,
                              jit=jit)
            t0 = time.perf_counter()
            check(s.push(cap) == len(cap), f"{what}: the warm push dropped samples")
            (warm,) = list(s.process_available())
            first_ms = 1e3 * (time.perf_counter() - t0)
            torch.cuda.synchronize()
            # what the streamer holds: staging buffers; captured, the graph's static input and
            # outputs too (its pool's free blocks are not counted: the capture empties the cache,
            # so a reserved figure would not isolate them)
            held = torch.cuda.memory_allocated() - base
            modes[jit] = dict(streamer=s, warm=warm, first_ms=first_ms, held=held, peak=0,
                              ring=clock_ring(s), walls=[], pushes=[], pops=[])
        superblock_fields_equal([modes[True]["warm"]], [modes[False]["warm"]], f"{what} warm")

        def run(s):
            check(s.push(cap[:n]) == n and s.push(cap[:n]) == n, f"{what}: a push dropped samples")
            return list(s.process_available())

        for _ in range(reps):  # in turns, eager then captured, on the same pushes
            out = {}
            for jit, m in modes.items():
                m["ring"].update(dict.fromkeys(m["ring"], 0.0))
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                out[jit] = run(m["streamer"])
                m["walls"].append(time.perf_counter() - t0)
                m["peak"] = max(m["peak"], torch.cuda.max_memory_allocated() - before)
                m["pushes"].append(m["ring"]["push"])
                m["pops"].append(m["ring"]["pop_block"])
            superblock_fields_equal(out[True], out[False], what)
            check_sustained_frames(out[True], n_frames, payload, what,
                                   int(MCS.QPSK_3_4) if sp is None else None)
        row = {}
        for jit, m in modes.items():
            s = m["streamer"]
            events = device_events(lambda: run(s), 1)  # it sees the kernels of a replay too
            wall = statistics.median(m["walls"])
            # the compute stream's work: kernels and device-to-device copies (the graph's static
            # input, the clones), not the copy stream's uploads nor the readback
            device = [e for e in events if e.get("cat") != "gpu_memcpy" or "DtoD" in e["name"]]
            row["captured" if jit else "eager"] = dict(
                samples_per_s=2 * n / wall, samples_per_s_min=2 * n / max(m["walls"]),
                samples_per_s_max=2 * n / min(m["walls"]), host_ms_per_superblock=1e3 * wall / 2,
                device_ms_per_superblock=sum(e["dur"] for e in device) / 2e3,
                kernels_per_superblock=sum(e.get("cat") == "kernel" for e in events) / 2,
                ring_push_ms=1e3 * statistics.median(m["pushes"]) / 2,
                ring_pop_ms=1e3 * statistics.median(m["pops"]) / 2,
                host_syncs_per_superblock=sync_count(lambda: run(s)) / 2,
                run_peak_gib=m["peak"] / 2**30, held_gib=m["held"] / 2**30,
                first_superblock_ms=m["first_ms"])
            check(s.stats.dropped_samples == 0, f"{what}: samples dropped")
        e, c = row["eager"], row["captured"]
        row["capture_ms"] = c["first_superblock_ms"] - e["first_superblock_ms"]
        row["speedup"] = c["samples_per_s"] / e["samples_per_s"]
        # a result kept from superblock k, then two superblocks of zeros through the same graph
        s = modes[True]["streamer"]
        (kept, _) = run(s)
        snapshot = {f: v.clone() for f, v in result_fields(kept).items()}
        check(s.push(np.zeros(2 * n, np.complex64)) == 2 * n, f"{what}: the zero push dropped")
        later = list(s.process_available())
        check(len(later) == 2 and int(later[-1].valid.sum()) == 0,
              f"{what}: the zero superblocks decoded frames")
        for f, v in snapshot.items():
            check(torch.equal(getattr(kept, f), v), f"{what}: a kept result changed in {f}")
        check(len(s._rx._graphs) == 1, f"{what}: {len(s._rx._graphs)} graphs captured, not one")
        print(f"{what}: {reps} runs of two superblocks, every field of every superblock equal "
              f"captured and eager; a result kept from superblock k unchanged after k+2; "
              f"eager / captured: {e['samples_per_s']:.6g} / {c['samples_per_s']:.6g} samples/s "
              f"(min-max {e['samples_per_s_min']:.6g}-{e['samples_per_s_max']:.6g} / "
              f"{c['samples_per_s_min']:.6g}-{c['samples_per_s_max']:.6g}), host "
              f"{e['host_ms_per_superblock']:.3f} / {c['host_ms_per_superblock']:.3f} ms a "
              f"superblock, device {e['device_ms_per_superblock']:.4f} / "
              f"{c['device_ms_per_superblock']:.4f} ms in {e['kernels_per_superblock']:.0f} / "
              f"{c['kernels_per_superblock']:.0f} kernels seen by the trace, ring push "
              f"{e['ring_push_ms']:.3f} / {c['ring_push_ms']:.3f} + pop {e['ring_pop_ms']:.3f} / "
              f"{c['ring_pop_ms']:.3f} ms, host syncs {e['host_syncs_per_superblock']:g} / "
              f"{c['host_syncs_per_superblock']:g} a superblock, memory above a run's start "
              f"{e['run_peak_gib']:.3f} / {c['run_peak_gib']:.3f} GiB, held by the streamer "
              f"{e['held_gib']:.3f} / {c['held_gib']:.3f} GiB, "
              f"first superblock {e['first_superblock_ms']:.1f} / "
              f"{c['first_superblock_ms']:.1f} ms (capture {row['capture_ms']:.1f} ms); "
              f"captured / eager {row['speedup']:.3f}", flush=True)
        figs[f"sustained_{name}"] = row
        del modes, s, kept, later

    # one curve of the BER sweep: captured, eager, and the CPU, on the same CPU-drawn noise
    args = ber_sweep.parser().parse_args([])
    mcs = "QPSK_3_4"
    spec_q, tab_q, pay = golden_frame(mcs, args.payload_bytes, dev)
    _, tab_cpu, pay_cpu = golden_frame(mcs, args.payload_bytes, "cpu")
    gen = torch.Generator().manual_seed(12)
    noise = [channel.normal_pair((args.frames, comm_link.loopback_samples(cfg, spec_q)),
                                 generator=gen) for _ in args.snrs]
    curve = lambda t, p, pts, jit: evaluation.link_curve(  # noqa: E731
        cfg, spec_q, t, p, args.snrs, n_frames=args.frames, noise=noise, points=pts, jit=jit)
    pts = {"captured": [], "eager": [], "cpu": []}  # each point's PointResult, first curve
    curves, walls = {}, {"captured": [], "eager": []}
    for i in range(reps):
        for label, jit in (("eager", False), ("captured", True)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            curves[label] = curve(tab_q, pay, pts[label] if i == 0 else None, jit)
            walls[label].append(time.perf_counter() - t0)
    check(curves["captured"] == curves["eager"], "link_curve: captured != eager")
    curve(tab_cpu, pay_cpu, pts["cpu"], False)
    for snr, a, b, c in zip(args.snrs, pts["captured"], pts["eager"], pts["cpu"]):
        for f in ("bit_errors", "crc_ok"):
            check(torch.equal(getattr(a, f), getattr(b, f)), f"link_curve {snr} dB: captured "
                                                             f"!= eager in {f}")
            check(torch.equal(getattr(a, f).cpu(), getattr(c, f)), f"link_curve {snr} dB: "
                                                                   f"card != CPU in {f}")
    # one point alone, as the curve replays it: the graph's replay and the point's two reads
    clean = evaluation.clean_waveform(cfg, spec_q, tab_q, pay)
    nv, z = evaluation.point_inputs(clean, 10.0, args.frames, 1)
    nv_t = torch.full((), nv, dtype=torch.float32, device=dev)
    point = lambda z_, nv_: evaluation.link_point(cfg, spec_q, tab_q, pay, clean,  # noqa: E731
                                                  nv_, z_)
    captured = graph.jit(point, name="link_point")
    timing = {}
    for label, fn in (("eager", point), ("captured", captured)):
        def read(fn=fn):
            r = fn(z, nv_t)
            return int(r.bit_errors.sum()), int(r.crc_ok.sum())
        timing[label] = jrc_timing(read, reps)
        timing[label]["frames_per_s"] = args.frames * 1e3 / timing[label]["wall_ms"]
        timing[label]["curve_ms"] = 1e3 * statistics.median(walls[label])
    e, c = timing["eager"], timing["captured"]
    print(f"jit: link_curve {mcs} at {len(args.snrs)} SNRs x {args.frames} frames (CPU-drawn "
          f"noise): captured = eager = CPU frame for frame; a curve {e['curve_ms']:.2f} / "
          f"{c['curve_ms']:.2f} ms eager / captured (the capture at its first point included); "
          f"a point at 10 dB {e['frames_per_s']:.1f} / {c['frames_per_s']:.1f} frames/s "
          f"({e['wall_ms']:.3f} / {c['wall_ms']:.3f} ms, min-max {e['wall_ms_min']:.3f}-"
          f"{e['wall_ms_max']:.3f} / {c['wall_ms_min']:.3f}-{c['wall_ms_max']:.3f}), device "
          f"{e['device_ms']:.4f} / {c['device_ms']:.4f} ms in {e['launches']:.0f} / "
          f"{c['launches']:.0f} device events, host syncs {e['host_syncs']} / {c['host_syncs']}",
          flush=True)
    figs["ber_point"] = timing
    return figs


JIT_DWELLS = 8  # dwells of one seed held captured against eager
#: the kernels' symbols in a profiler trace, which sees a graph's kernels where no wrapper counts
KERNEL_SYMBOLS = {"viterbi_decode": "viterbi_decode_kernel", "detect_front_end": "detect_kernel",
                  "gather_rows": "gather_rows_kernel"}


def tensor_leaves(tree) -> list:
    """The tensors of a result tree in ``graph.map_tensors``'s order."""
    from jrc_tpu_torch.utils import graph

    return graph.signature((tree,), {})[1]


def check_leaves_equal(got, want, what: str) -> None:
    """Two result trees equal in every tensor, exactly (floats too)."""
    a, b = tensor_leaves(got), tensor_leaves(want)
    check(len(a) == len(b), f"{what}: {len(a)} tensors against {len(b)}")
    for k, (u, v) in enumerate(zip(a, b)):
        check(u.shape == v.shape and torch.equal(u, v), f"{what}: tensor {k} of the result differs")


def traced_kernels(run) -> dict:
    """{kernel: launches} of K1-K3 in a profiler trace of one ``run``: a
    replay's kernels, which no wrapper counts."""
    from jrc_tpu_torch.profiling import device_events

    events = device_events(run, 1)
    seen = {k: sum(sym in e["name"] for e in events) for k, sym in KERNEL_SYMBOLS.items()}
    return {k: c for k, c in seen.items() if c}


def capture_cost(first) -> tuple[float, float]:
    """(host ms, GiB held after) of ``first``, a first captured call: the
    reserved memory it leaves behind (its graph's pool, the static inputs and
    outputs) once the cache's free blocks are returned."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    first()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.empty_cache()
    return ms, (torch.cuda.memory_reserved() - before) / 2**30


def timing_line(what: str, e: dict, c: dict, per: str) -> str:
    return (f"{what}: eager / captured {e['per_s']:.6g} / {c['per_s']:.6g} {per}/s, "
            f"{e['wall_ms']:.4f} ({e['wall_ms_min']:.4f}-{e['wall_ms_max']:.4f}) / "
            f"{c['wall_ms']:.4f} ({c['wall_ms_min']:.4f}-{c['wall_ms_max']:.4f}) ms, device "
            f"{e['device_ms']:.4f} / {c['device_ms']:.4f} ms in {e['launches']:.0f} / "
            f"{c['launches']:.0f} device events (idle {100 * e['idle_share']:.1f}% / "
            f"{100 * c['idle_share']:.1f}%), host syncs {e['host_syncs']} / {c['host_syncs']}")


def jit_jrc(cfg, dev, reps: int) -> dict:
    """``jrc_step`` through ``graph.jit(trx, generators=(trx.generator,))``: 8
    dwells of one seed with the state carried, at phase 12's operating point,
    equal to 8 eager dwells of a second JRCTrx of the same seed in every
    field, one graph, K1-K3 inside; then the pinned jrc_tpu dwells with
    their draws; steps/s, device ms, launches and host syncs (none) of both,
    capture ms and held memory."""
    from jrc_tpu_torch import capture
    from jrc_tpu_torch.models import jrc_trx
    from jrc_tpu_torch.ops import channel
    from jrc_tpu_torch.utils import graph

    eager, trx = jrc_trx.JRCTrx(cfg, seed=7), jrc_trx.JRCTrx(cfg, seed=7)
    step = graph.jit(trx, generators=(trx.generator,))
    spec, payload = jrc_frames(cfg, trx, dev)["data"]
    scene = channel.Targets((12.0,), (5.0,), (25.0,), (10.0,)).on(dev)
    kw = dict(comm_noise_var=JRC_NOISE_VAR)
    s_e, s_c = eager.init_state(), trx.init_state()
    held = {}
    for d in range(JIT_DWELLS):
        r_e, eager_counts = counted(lambda: eager(s_e, spec, payload, scene, **kw))
        call = lambda: step(s_c, spec, payload, scene, **kw)  # noqa: E731
        if d == 0:  # the warm-up and the capture launch through the wrappers, a replay does not
            (held["ms"], held["gib"]), first = counted(lambda: capture_cost(
                lambda: held.update(r=call())))
            r_c = held.pop("r")
            check(first == {k: 2 * c for k, c in eager_counts.items()},
                  f"captured jrc_step: the first call launched {first}, not twice {eager_counts}")
        else:
            r_c, replay = counted(call)
            check(not replay, f"captured jrc_step: a replay went through a wrapper: {replay}")
        check_leaves_equal(r_c, r_e, f"captured jrc_step, dwell {d}")
        check(bool(r_c.radar_est.detected) and (d == 0 or bool(r_c.comm.decoded.crc_ok)),
              f"captured jrc_step, dwell {d}: no detection or a CRC failure")
        s_e, s_c = r_e.state, r_c.state
    check(len(step._graphs) == 1, f"captured jrc_step: {len(step._graphs)} graphs for "
                                  f"{JIT_DWELLS} dwells")
    check(torch.equal(eager.generator.get_state(), trx.generator.get_state()),
          "captured jrc_step: the generator's state differs from eager's after the dwells")
    timings = next(iter(step.timings.values()))
    seen = traced_kernels(lambda: step(s_c, spec, payload, scene, **kw))
    check(seen == eager_counts, f"captured jrc_step: a replay's trace holds {seen}, eager "
                                f"{eager_counts}")
    pinned = jrc_trx.JRCTrx(cfg, seed=0)
    pinned_step = graph.jit(pinned, generators=(pinned.generator,))
    state = pinned.init_state()
    for i, dw in enumerate(capture.pinned_jrc_dwells()):
        sp, pl, targets, draws, opts = capture.pinned_step_args(dw, dev)
        r = pinned_step(state, sp, pl, targets.on(dev), draws=draws, **opts)
        bad = capture.jrc_mismatches(capture.step_record(r), capture.jrc_record(dw.want))
        check(not bad, f"captured jrc_step, pinned dwell {i}: {bad}")
        state = r.state
    loops = {"eager": [eager, s_e], "captured": [step, s_c]}
    figs = {}
    for label, loop in loops.items():
        def run(loop=loop):
            loop[1] = loop[0](loop[1], spec, payload, scene, **kw).state
        figs[label] = jrc_timing(run, max(reps, 20))
    e, c = figs["eager"], figs["captured"]
    check(e["host_syncs"] == c["host_syncs"] == 0, "jrc_step synchronizes with the host")
    figs.update(capture_ms=timings.capture_ms, instantiate_ms=timings.instantiate_ms,
                warmup_ms=timings.warmup_ms, first_call_ms=held["ms"], held_gib=held["gib"],
                speedup=c["per_s"] / e["per_s"], kernel_launches=eager_counts)
    print(f"jit: jrc_step captured (state carried as an input tree, generator registered): "
          f"{JIT_DWELLS} dwells of one seed equal to eager in every field, bit for bit, one "
          f"graph, the generators equal after; K1-K3 inside ({eager_counts} a replay, from the "
          f"trace); {len(capture.JRC_DWELLS)} pinned jrc_tpu dwells reproduced with their draws; "
          + timing_line("JRC steps", e, c, "steps")
          + f"; warm-up {timings.warmup_ms:.1f} ms, capture {timings.capture_ms:.1f} ms, "
            f"instantiation {timings.instantiate_ms:.1f} ms, first call {held['ms']:.1f} ms, held "
            f"{held['gib']:.3f} GiB; captured / eager {figs['speedup']:.3f}", flush=True)
    return figs


def jit_radar(cfg, dev, reps: int) -> tuple[dict, torch.Tensor]:
    """``radar_frame`` through ``graph.jit`` (tables and generator in the
    partial): 8 dwells of one seed with a random phase a target and thermal
    noise, equal to eager in every field; then the bench dwell (no draws)
    timed both ways → (figures, the 8 dwells' channel estimates)."""
    from functools import partial

    from jrc_tpu_torch import tables
    from jrc_tpu_torch.models import radar_chain
    from jrc_tpu_torch.ops import channel
    from jrc_tpu_torch.utils import graph

    spec, payload = jrc_frames(cfg, None, dev)["data"]
    tab, rtab = tables.from_numpy(cfg, spec, dev), tables.radar_from_numpy(cfg, dev)
    scene = channel.Targets((12.0,), (5.0,), (25.0,), (10.0,)).on(dev)
    gens = [torch.Generator(device=dev).manual_seed(9) for _ in range(2)]
    kw = dict(random_phase=True, noise_var=channel.thermal_noise_var(cfg.sample_rate))
    eager = partial(radar_chain.radar_frame, cfg, spec, tab, rtab, generator=gens[0], **kw)
    frame = graph.jit(partial(radar_chain.radar_frame, cfg, spec, tab, rtab, generator=gens[1],
                              **kw), generators=(gens[1],))
    chans = []
    for d in range(JIT_DWELLS):
        got, want = frame(payload, scene), eager(payload, scene)
        check_leaves_equal(got, want, f"captured radar_frame, dwell {d}")
        check(bool(got.estimate.detected) and abs(float(got.estimate.range_m) - 12.0) < 0.6,
              f"captured radar_frame, dwell {d}: the target missed")
        chans.append(got.chan)
    check(len(frame._graphs) == 1 and torch.equal(gens[0].get_state(), gens[1].get_state()),
          "captured radar_frame: more than one graph, or the generators differ after")
    bench = partial(radar_chain.radar_frame, cfg, spec, tab, rtab)
    captured = graph.jit(bench, name="radar_frame")
    first_ms, held = capture_cost(lambda: captured(payload, scene))
    timings = next(iter(captured.timings.values()))
    figs = {label: jrc_timing(lambda fn=fn: fn(payload, scene), max(reps, 20))
            for label, fn in (("eager", bench), ("captured", captured))}
    e, c = figs["eager"], figs["captured"]
    check(c["host_syncs"] == 0, "captured radar_frame synchronizes with the host")
    figs.update(capture_ms=timings.capture_ms, instantiate_ms=timings.instantiate_ms,
                warmup_ms=timings.warmup_ms, first_call_ms=first_ms, held_gib=held,
                speedup=c["per_s"] / e["per_s"])
    print(f"jit: radar_frame captured: {JIT_DWELLS} dwells of one seed (random phase, thermal "
          f"noise from the registered generator) equal to eager in every field, one graph; the "
          f"bench dwell (no draws): " + timing_line("radar dwells", e, c, "dwells")
          + f"; capture {timings.capture_ms:.1f} ms, instantiation {timings.instantiate_ms:.1f} "
            f"ms, held {held:.3f} GiB; captured / eager {figs['speedup']:.3f}", flush=True)
    return figs, torch.stack(chans)


def jit_doppler(cfg, dev, reps: int) -> dict:
    """One 64-burst train of the simulated radio (a target at 12 m, 30 m/s,
    20°) estimated burst by burst through apps/jrc_trx's captured estimate
    and eagerly: every estimate equal, the velocity within ±1 bin."""
    from jrc_tpu_torch.apps import jrc_trx as app
    from jrc_tpu_torch.io.backend import SimTrx, TrxSession
    from jrc_tpu_torch.models import comm_link
    from jrc_tpu_torch import tables
    from jrc_tpu_torch.ops import channel, radar
    from jrc_tpu_torch.utils import graph

    n_frames, v_true = 64, 30.0
    spec, payload = jrc_frames(cfg, None, dev)["data"]
    tab = tables.from_numpy(cfg, spec, dev)
    tx = comm_link.tx_frame(cfg, spec, tab, payload, 1, pad_tail=3 * cfg.sym_len)
    session = TrxSession(SimTrx(cfg, channel.Targets((12.0,), (v_true,), (20.0,), (10.0,))),
                         update_period=0.0)
    sl = slice(cfg.n_sync_words + 1, cfg.n_sync_words + 1 + cfg.n_ltf)
    x_sl, n_sym = tx.grid.transpose(0, 1)[:, sl], tx.grid.shape[0]
    bursts = [session.frame(tx.samples, 0.0).rx for _ in range(n_frames)]
    h_of = graph.jit(app.ltf_estimate, name="doppler_train estimate")
    hist = torch.stack([h_of(cfg, n_sym, x_sl, r) for r in bursts])
    want = torch.stack([app.ltf_estimate(cfg, n_sym, x_sl, r) for r in bursts])
    check(torch.equal(hist, want), "captured doppler estimate differs from eager")
    check(len(h_of._graphs) == 1, f"doppler estimate: {len(h_of._graphs)} graphs")
    vb = radar.velocity_axis(n_frames, tx.samples.shape[-1] / cfg.sample_rate, cfg.center_freq)
    est = radar.range_doppler_estimate(
        radar.range_doppler_map(hist), torch.from_numpy(radar.range_axis(
            cfg.fft_len, cfg.sample_rate)).to(dev), torch.from_numpy(vb).to(dev))
    bin_mps = float(vb[1] - vb[0])
    check(bool(est.detected) and abs(float(est.velocity_mps) - v_true) <= bin_mps,
          f"captured doppler train: {float(est.velocity_mps)} m/s (bin {bin_mps:.3f})")
    figs = {label: jrc_timing(lambda fn=fn: fn(cfg, n_sym, x_sl, bursts[0]), reps)
            for label, fn in (("eager", app.ltf_estimate), ("captured", h_of))}
    print(f"jit: doppler_train estimate captured: {n_frames} bursts, every estimate equal to "
          f"eager, one graph, v {float(est.velocity_mps):.3f} m/s (bin {bin_mps:.3f}) at "
          f"{float(est.range_m):.3f} m; one estimate: "
          + timing_line("estimates", figs["eager"], figs["captured"], "estimates"), flush=True)
    figs["v_mps"] = float(est.velocity_mps)
    return figs


def jit_mesh(cfg, spec, model, x, dev, chans, reps: int) -> dict:
    """A world of one on NCCL: sharded_rx and sharded_rx_dynamic on the bench
    capture as one block with 2560 slots, captured inside, against the same
    calls under ``graph.eager()``: every field equal, 2417 frames CRC-clean,
    equal to scan_rx's; then batched_rx on 32 blocks and
    batched_range_angle_maps on the radar dwells' estimates, the same way;
    wall ms captured against eager, capture and instantiation ms."""
    from jrc_tpu_torch.parallel import batch, mesh, streaming as pstream
    from jrc_tpu_torch.models.streaming import frame_window_samples
    from jrc_tpu_torch.utils import graph

    n = model.block_len * model.n_blocks
    flat, flat_dyn = flat_frames(cfg, model, x, dev)
    halo = frame_window_samples(cfg, spec) + cfg.fft_len
    bl = model.block_len
    caps = torch.stack([x[b * bl : (b + 1) * bl + halo] for b in range(N_BATCH)])
    figs = {}
    with mesh.local_group("nccl"):
        tm, bm = mesh.time_mesh(1), mesh.batch_mesh(1)
        block = pstream.local_block(tm, x[:n])
        check(pstream.captures(tm, block), "an NCCL mesh does not capture")
        for name, m, run, want, fields in (
                ("sharded_rx", tm, lambda: pstream.sharded_rx(cfg, spec, tm, block,
                                                              max_frames_per_block=2560),
                 flat, ("payload", "crc_ok")),
                ("sharded_rx_dynamic", tm, lambda: pstream.sharded_rx_dynamic(
                    cfg, tm, block, max_frames_per_block=2560, max_payload=96),
                 flat_dyn, ("payload", "crc_ok", "sig_ok", "mcs", "payload_len",
                            "packet_type_bit")),
                ("batched_rx", bm, lambda: batch.batched_rx(bm, cfg, spec, caps, max_frames=12),
                 None, ()),
                ("batched_range_angle_maps", bm,
                 lambda: batch.batched_range_angle_maps(bm, chans), None, ())):
            before = len(mesh.captured_steps(m))  # the eager run adds its entry
            with graph.eager():
                ref, eager_counts = counted(run)
                eager_ms = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    run()
                    torch.cuda.synchronize()
                    eager_ms.append(1e3 * (time.perf_counter() - t0))
            out = {}
            (first_ms, held), first = counted(lambda: capture_cost(lambda: out.update(got=run())))
            got = out["got"]
            check(first == {k: 2 * c for k, c in eager_counts.items()},
                  f"captured {name}: the first call launched {first}, not twice {eager_counts}")
            f = list(mesh.captured_steps(m).values())[before]
            (t,) = f.timings.values()
            check_leaves_equal(got, ref, f"captured {name}")
            _, c_replay = counted(run)
            check(not c_replay, f"{name}: a replay went through a wrapper: {c_replay}")
            seen = traced_kernels(run)
            check(seen == eager_counts, f"{name}: a replay's trace holds {seen}, eager "
                                        f"{eager_counts}")
            if want is not None:
                check(int(got.n_frames) == int(got.n_crc_ok) == len(want["start"]),
                      f"captured {name}: {int(got.n_frames)} frames, {int(got.n_crc_ok)} clean")
                check_same_frames(frames_of(got), want, fields, f"captured {name}")
            cap_ms = []
            for _ in range(max(reps, 5)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                cap_ms.append(1e3 * (time.perf_counter() - t0))
            fig = dict(eager_ms=statistics.median(eager_ms), eager_ms_min=min(eager_ms),
                       eager_ms_max=max(eager_ms), captured_ms=statistics.median(cap_ms),
                       captured_ms_min=min(cap_ms), captured_ms_max=max(cap_ms),
                       warmup_ms=t.warmup_ms, capture_ms=t.capture_ms,
                       instantiate_ms=t.instantiate_ms, first_call_ms=first_ms, held_gib=held,
                       kernel_launches=eager_counts)
            figs[name] = fig
            print(f"jit: {name} over NCCL, world 1, captured inside: every field equal to its "
                  f"eager run" + (f", {len(want['start'])} frames CRC-clean, equal to scan_rx's"
                                  if want is not None else "")
                  + f"; K1-K3 in a replay {eager_counts}; wall eager / captured "
                    f"{fig['eager_ms']:.3f} ({fig['eager_ms_min']:.3f}-{fig['eager_ms_max']:.3f}) / "
                    f"{fig['captured_ms']:.3f} ({fig['captured_ms_min']:.3f}-"
                    f"{fig['captured_ms_max']:.3f}) ms; warm-up {t.warmup_ms:.1f} ms, capture "
                    f"{t.capture_ms:.1f} ms, instantiation {t.instantiate_ms:.1f} ms, first call "
                    f"{first_ms:.1f} ms, held {held:.3f} GiB", flush=True)
    return figs


def phase_jit_sites(cfg, spec, model, x, dev, reps: int) -> dict:
    """The compile sites of the repo beyond the streamer and link_curve,
    captured against eager (``jit_jrc``, ``jit_radar``, ``jit_doppler``,
    ``jit_mesh``) → figures."""
    figs = {"jrc_step": jit_jrc(cfg, dev, reps)}
    figs["radar_frame"], chans = jit_radar(cfg, dev, reps)
    figs["doppler_estimate"] = jit_doppler(cfg, dev, reps)
    figs["mesh"] = jit_mesh(cfg, spec, model, x, dev, chans, reps=5)
    return figs


def phase_soft_sta(cfg, spec, x, n_frames: int, payload, frame_len: int, dev, block_len: int,
                   n_blocks: int) -> dict:
    """StreamingRx with soft=True and with estimator="sta" over the bench
    capture → {name: launch counts}."""
    from jrc_tpu_torch.models.streaming import StreamingRx

    out = {}
    for name, kw in (("soft", dict(soft=True)), ("sta", dict(estimator="sta"))):
        m = StreamingRx(cfg, spec, block_len, n_blocks, max_frames_per_block=12, device=dev, **kw)
        m(x)  # warm-up
        res, counts = counted(lambda: m(x))
        check_main_path_counts(counts, f"{name} path")
        check_bench_frames(res, n_frames, payload, frame_len, f"{name} path")
        with plain_kernels():
            res_p = m(x)
        torch.cuda.synchronize()
        check_same(res, res_p, ("valid", "start", "crc_ok", "payload"), f"{name} path")
        t = wall_s(lambda: m(x), 3)
        print(f"{name} path ({kw}): {n_frames} of {n_frames} frames CRC-clean with the pinned "
              f"payload, plain path identical; launches {counts}; "
              f"{block_len * n_blocks / t:.6g} samples/s ({t * 1e3:.3f} ms)", flush=True)
        out[name] = counts
    return out


#: decode_frame(soft=True, noise_var=v): LLRs 20× and 1e4× those at unit variance reach K1
SOFT_NOISE_VARS = (0.05, 1e-4)
SOFT_SEED = 93  # the scrambler seed of the frames decoded at SOFT_NOISE_VARS


def phase_soft_noise_var(cfg, spec, payload, dev, n_frames: int) -> dict:
    """decode_frame(soft=True, noise_var=v) at each of SOFT_NOISE_VARS on
    ``n_frames`` copies of the pinned bench frame's data symbols (unit
    points, as the equalizer restores them) plus complex noise of variance v
    drawn on the card: every frame CRC-clean with the pinned payload and
    seed, K1's bits on both routes exactly the plain version's, and the
    whole call equal under plain_kernels() → {run: launch counts}."""
    from jrc_tpu_torch import tables
    from jrc_tpu_torch.ops import decoder, encoder

    tab = tables.from_numpy(cfg, spec, dev)
    pl = torch.from_numpy(payload).to(dev)
    z0 = encoder.encode_frame(spec, tab, pl, SOFT_SEED) * 2  # QPSK's TX half undone
    gen = torch.Generator(device=dev).manual_seed(0)
    counts, err, llr_max = collections.Counter(), 0, []
    for v in SOFT_NOISE_VARS:
        noise = torch.randn((n_frames, *z0.shape), generator=gen, dtype=torch.complex64,
                            device=dev)
        z = z0 + noise * float(np.sqrt(v))
        res, c = counted(lambda: decoder.decode_frame(spec, tab, z, soft=True, noise_var=v))
        check(c == {"viterbi_decode": 1}, f"decode_frame at noise_var {v} launched {c}")
        counts.update(c)
        check(bool(res.crc_ok.all()), f"noise_var {v}: {int((~res.crc_ok).sum())} of {n_frames} "
                                      f"frames fail the CRC")
        check(bool((res.payload == pl).all()), f"noise_var {v}: payload differs from the pinned one")
        check(bool((res.scrambler_seed == SOFT_SEED).all()), f"noise_var {v}: scrambler seed")
        values = decoder.frame_values(spec, tab, z, soft=True, noise_var=v)
        llr_max.append(float(values.abs().max()))
        err = max(err, check_viterbi(values, tab.trellis, f"LLRs at noise_var {v}"))
        with plain_kernels():
            res_p = decoder.decode_frame(spec, tab, z, soft=True, noise_var=v)
        torch.cuda.synchronize()
        check_same(res, res_p, res._fields, f"decode_frame at noise_var {v}")
    print(f"soft noise_var: decode_frame(soft=True) of {n_frames} pinned QPSK-3/4 frames at "
          f"noise_var {' / '.join(map(str, SOFT_NOISE_VARS))} (max |LLR| "
          f"{' / '.join(f'{m:.6g}' for m in llr_max)}): every frame CRC-clean with the pinned "
          f"payload and seed, K1 bits on both routes against plain max |err| {err}, the plain "
          f"call identical; launches {dict(counts)}; {gpu_line()}", flush=True)
    return {"soft_noise_var": dict(counts)}


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def phase_pieces(dev, reps: int):
    """The profiling entry's run of P1-P3 with the launch counts read, then
    each variant against its plain version → (counts, {piece: {max_abs_err,
    ms, kernel_only_ms, kernel_only_cold_ms, back_to_back_ms, plain_ms,
    bound_ms, bound_by, library_ms, variants}}), the times and bounds summed
    over the piece's variants. kernel_only_ms is the kernel's device time in
    a trace of calls back to back, where a case's inputs may stay in the L2;
    kernel_only_cold_ms the same with the L2 overwritten before each call."""
    from jrc_tpu_torch import profiling
    from jrc_tpu_torch.ops import shuffle_pieces

    cases = profiling.cases(dev)
    flush = profiling.l2_flusher(dev)
    _, counts = counted(lambda: [case.run() for case in cases])
    for piece in ("shuffle_pieces", "gather_pieces", "viterbi_pieces"):
        check(counts.get(piece, 0) > 0, f"kernel {piece} was not launched by the profiling entry")
    results = {}
    for case in cases:
        got, want = _outputs(case.run()), _outputs(case.plain())
        for g, w in zip(got, want):
            check(torch.equal(g, w), f"{case.piece} [{case.label.strip()}] kernel != plain")
        err = max(float((g.double() - w.double()).abs().max()) if not g.is_complex()
                  else float((g - w).abs().max()) for g, w in zip(got, want))
        bound_ms, bound_by = bound(case.n_bytes, case.n_ops)
        library = profiling.library_call(case)
        if library is not None:
            check(torch.equal(library(), got[0]), f"{case.piece} [{case.label.strip()}]: the "
                                                  f"library call differs")
        v = {"ms": profiling.time_ms(case.run, reps),
             "kernel_only_ms": profiling.device_ms(case.run, name=profiling.PIECES_KERNEL)[0],
             "kernel_only_cold_ms": profiling.device_ms(case.run, 10, profiling.PIECES_KERNEL,
                                                        flush)[0],
             "back_to_back_ms": profiling.back_to_back_ms(case.run, 20),
             "plain_ms": profiling.time_ms(case.plain, 3), "bound_ms": bound_ms,
             "bound_by": bound_by,
             "library_ms": None if library is None else profiling.time_ms(library, reps)}
        row = results.setdefault(case.piece, dict(
            max_abs_err=0.0, ms=0.0, kernel_only_ms=0.0, kernel_only_cold_ms=0.0,
            back_to_back_ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_by=bound_by, library_ms=None,
            variants={}))
        row["variants"][case.label.strip()] = v
        row["max_abs_err"] = max(row["max_abs_err"], err)
        for key in ("ms", "kernel_only_ms", "kernel_only_cold_ms", "back_to_back_ms", "plain_ms",
                    "bound_ms"):
            row[key] += v[key]
        if library is not None:
            row["library_ms"] = (row["library_ms"] or 0.0) + v["library_ms"]
        print(f"pieces: {case.piece} {case.label} exact; {v['ms']:.4f} ms wrapped, kernel alone "
              f"{v['kernel_only_ms']:.4f} ms ({v['kernel_only_cold_ms']:.4f} cold L2), back to back "
              f"{v['back_to_back_ms']:.4f} ms, plain {v['plain_ms']:.4f} ms; bound {bound_ms:.4f} ms "
              f"({bound_by})"
              + ("" if library is None else f"; xp[idx] {v['library_ms']:.4f} ms"), flush=True)
    # 864 steps bring roll8 and concat back to where they began, so a wrong
    # permutation would pass there: P1 once more at an odd step count
    steps = profiling.SHUFFLE_STEPS - 1
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 1, (64, profiling.SHUFFLE_B))
                         .astype(np.float32)).to(dev)
    for v in shuffle_pieces.VARIANTS:
        check(torch.equal(shuffle_pieces.shuffle_pieces(x, v, steps)[0],
                          shuffle_pieces.shuffle_pieces_plain(x, v, steps)[0]),
              f"shuffle_pieces [{v}] kernel != plain at {steps} steps")
    print(f"pieces: shuffle_pieces every variant exact at {steps} steps", flush=True)
    return counts, results


JRC_NOISE_VAR = 1e-4  # the comm leg's noise variance at the reference's operating point
#: the configs phase's runs: the dwells at each antenna configuration, scan_rx at n_ltf 2
CONFIG_RUNS = tuple("configs_" + "x".join(map(str, c)) for c in ANTENNA_CONFIGS)
CONFIG_SCAN = "configs_scan"
#: the registry's paths (the kernels each launches) and the runs of this script that drive them
RUNS_OF_PATH = {
    "static": ("static", "soft", "sta"),
    "dynamic": ("dynamic", "mixed", "sustained_dynamic"),
    "stream": ("sustained_fc32", "sustained_sc16"),
    "jrc": ("jrc_step", "jrc_app", "jrc_doppler"),
    "sim": ("ber_sweep", "comm_sim"),
    "block": ("windowed", "windowed_dynamic", "sequential", "sequential_dynamic"),
    "mesh": ("mesh_static", "mesh_dynamic", "batched_rx"),
    "configs": CONFIG_RUNS + (CONFIG_SCAN,),
}


WINDOWED = (32704, 257)  # (block_len, n_blocks): a multiple of 64, not of 128
SEQUENTIAL = (2**15, 32)  # the first 32 blocks of the bench capture, one after the other
N_BATCH = 32  # blocks of the bench capture that batched_rx decodes as independent captures


def frames_of(res) -> dict:
    """The valid slots of a result (block or sharded), ordered by trigger →
    {field: numpy array} (every per-slot field but the channel estimate)."""
    fields = {f: getattr(res, f) for f in res._fields
              if f not in ("n_frames", "n_crc_ok", "chan_est")}
    fields = {f: (v.reshape(-1, v.shape[-1]) if f == "payload" else v.reshape(-1)).cpu().numpy()
              for f, v in fields.items()}
    valid = fields["valid"]
    order = np.argsort(fields["start"][valid], kind="stable")
    return {f: v[valid][order] for f, v in fields.items()}


def check_same_frames(got: dict, want: dict, fields, path: str) -> float:
    """The same frames (by trigger) with the same ``fields``; → the largest
    SNR difference in dB (held within 1e-4 dB: the slots are batched
    otherwise, and a reduction may round by batch)."""
    check(len(got["start"]) == len(want["start"]),
          f"{path}: {len(got['start'])} frames where the flat path has {len(want['start'])}")
    for f in ("start", *fields):
        check((got[f] == want[f]).all(), f"{path}: {f} differs from the flat path's")
    err = float(np.abs(got["snr_db"] - want["snr_db"]).max()) if len(got["start"]) else 0.0
    check(err <= 1e-4, f"{path}: SNR {err} dB off the flat path's")
    return err


def flat_frames(cfg, model, x, dev) -> tuple[dict, dict]:
    """The flat path's frames of the bench capture, static and dynamic
    (max_payload 96): what the block and mesh phases are held to."""
    from jrc_tpu_torch.models.streaming import StreamingRxDynamic

    dyn = StreamingRxDynamic(cfg, model.block_len, model.n_blocks, max_frames_per_block=12,
                             max_payload=96, device=dev)
    return frames_of(model(x)), frames_of(dyn(x))


def check_same_exact(res, res_plain, path: str) -> None:
    """Every field but the floats (SNRs, channel estimate) identical."""
    check_same(res, res_plain, [f for f in res._fields if f not in ("snr_db", "snr_data_db",
                                                                     "chan_est")], path)


def phase_block(cfg, spec, x, payload, flat, flat_dyn, dev, reps: int):
    """The per-block RX on the card: the windowed scan (WINDOWED, the bench
    capture zero-padded to its blocks and halo) and the sequential scan
    (SEQUENTIAL, batched=False), static and dynamic (max_payload 96), each
    held frame for frame against the flat path, then through the plain
    versions (identical) → ({run: launch counts}, {run: figures})."""
    from jrc_tpu_torch.config import MCS
    from jrc_tpu_torch.models.streaming import (
        StreamingRx, StreamingRxDynamic, frame_window_samples, frame_window_samples_dynamic,
    )

    counts, figs = {}, {}
    for name, (block_len, n_blocks), dynamic in (
            ("windowed", WINDOWED, False), ("windowed_dynamic", WINDOWED, True),
            ("sequential", SEQUENTIAL, False), ("sequential_dynamic", SEQUENTIAL, True)):
        kw = dict(max_frames_per_block=12, batched=name.startswith("windowed"), device=dev)
        if dynamic:
            m = StreamingRxDynamic(cfg, block_len, n_blocks, max_payload=96, **kw)
            halo = frame_window_samples_dynamic(cfg, 96) + cfg.fft_len
        else:
            m = StreamingRx(cfg, spec, block_len, n_blocks, **kw)
            halo = frame_window_samples(cfg, spec) + cfg.fft_len
        n = block_len * n_blocks + halo
        xs = torch.cat([x, torch.zeros(max(0, n - len(x)), dtype=x.dtype, device=dev)])[:n]
        m(xs)  # warm-up
        res, counts[name] = counted(lambda: m(xs))
        check_main_path_counts(counts[name], f"{name} path")
        check(counts[name]["detect_front_end"] == n_blocks, f"{name}: K2 not once a block")
        span = block_len * n_blocks
        got, flat_frames = frames_of(res), (flat_dyn if dynamic else flat)
        in_span = flat_frames["start"] < span
        want = {f: v[in_span] for f, v in flat_frames.items()}
        n_frames = len(want["start"])
        check(got["crc_ok"].all() and (got["payload"][:, : len(payload)] == payload).all(),
              f"{name}: a frame not CRC-clean with the pinned payload")
        fields = ("payload", "crc_ok", "sig_ok") + (("mcs", "payload_len") if dynamic else ())
        snr_err = check_same_frames(got, want, fields, name)
        if dynamic:
            check((got["mcs"] == int(MCS.QPSK_3_4)).all(), f"{name}: MCS not QPSK-3/4")
        with plain_kernels():
            res_p = m(xs)
        torch.cuda.synchronize()
        check_same_exact(res, res_p, name)
        fig = jrc_timing(lambda: m(xs), reps)
        fig.update(samples_per_s=span / (fig["wall_ms"] / 1e3), frames=n_frames,
                   block_len=block_len, n_blocks=n_blocks, snr_err_db=snr_err)
        figs[name] = fig
        print(f"block: {name} ({n_blocks} blocks of {block_len}): {n_frames} of {n_frames} frames "
              f"in the span CRC-clean with the pinned payload, start/payload/crc"
              f"{'/MCS/length' if dynamic else ''} equal to the flat path's (SNR within "
              f"{snr_err:.2g} dB), plain path identical; launches {counts[name]}; "
              f"{fig['samples_per_s']:.6g} samples/s ({fig['wall_ms']:.3f} ms, min "
              f"{fig['wall_ms_min']:.3f}, max {fig['wall_ms_max']:.3f}), device "
              f"{fig['device_ms']:.3f} ms in {fig['launches']:.0f} launches, idle "
              f"{100 * fig['idle_share']:.1f}%, {fig['host_syncs']} host syncs", flush=True)
        del m, xs, res, res_p
    check(figs["windowed"]["frames"] == len(flat["start"]),
          "the windowed span misses frames of the capture")
    return counts, figs


def mesh_ranks(block_len: int, tmp: str, n_frames: int) -> np.ndarray:
    """The bench capture over two gloo ranks decoding on this one card
    (scripts/multihost_rx_torch.py, a process each, static and dynamic) →
    the global starts of rank 0's gathered valid slots."""
    import os

    from jrc_tpu_torch.parallel.launch import run_ranks

    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                          "multihost_rx_torch.py")
    out = os.path.join(tmp, f"starts_{block_len}.npz")
    ranks = run_ranks(
        lambda r: [sys.executable, script, "--coordinator", f"file://{tmp}/store_{block_len}",
                   "--num-processes", "2", "--process-id", str(r), "--device", "cuda",
                   "--backend", "gloo", "--capture", "bench", "--block-len", str(block_len),
                   "--dynamic", "--out", out], 2, timeout=400)
    for r, (code, text) in enumerate(ranks):
        check(code == 0, f"mesh rank {r} at block_len {block_len} exited {code} (None: killed "
                         f"at 400 s):\n{text[-3000:]}")
        check(f"MULTIHOST_OK rank={r} n_frames={n_frames} crc_ok={n_frames} dynamic=True" in text,
              f"mesh rank {r} at block_len {block_len}: {text[-2000:]}")
    with np.load(out) as f:
        return f["start"]


def phase_mesh(cfg, spec, model, x, flat, flat_dyn, dev, reps: int):
    """The sharded executors on the card, op by op (``graph.eager``): a world
    of one over NCCL (a file store in a temporary directory, destroyed
    after) running sharded_rx and sharded_rx_dynamic on the bench capture in one block, and batched_rx on
    ``N_BATCH`` of its blocks, each also through the plain versions
    (identical); then the capture over two gloo ranks on this card at a
    SEG-aligned and a non-aligned block_len → ({run: counts}, figures)."""
    import tempfile

    from jrc_tpu_torch.models.streaming import frame_window_samples, rx_block
    from jrc_tpu_torch.parallel import batch, mesh, streaming as pstream
    from jrc_tpu_torch.utils import graph

    n = model.block_len * model.n_blocks
    counts, figs = {}, {}
    # op by op: its runs are counted and held against the plain versions, and a
    # replay goes through no wrapper (phase 9 holds the captured step against this eager one)
    with mesh.local_group("nccl"), graph.eager():
        tm = mesh.time_mesh(1)
        block = pstream.local_block(tm, x[:n])
        for name, run, want, fields in (
                ("mesh_static", lambda: pstream.sharded_rx(cfg, spec, tm, block,
                                                           max_frames_per_block=2560),
                 flat, ("payload", "crc_ok")),
                ("mesh_dynamic", lambda: pstream.sharded_rx_dynamic(
                    cfg, tm, block, max_frames_per_block=2560, max_payload=96),
                 flat_dyn, ("payload", "crc_ok", "sig_ok", "mcs", "payload_len",
                            "packet_type_bit"))):
            run()  # warm-up
            res, counts[name] = counted(run)
            check_main_path_counts(counts[name], f"{name} path")
            check(int(res.n_frames) == int(res.n_crc_ok) == len(flat["start"]),
                  f"{name}: {int(res.n_frames)} frames, {int(res.n_crc_ok)} CRC-clean")
            snr_err = check_same_frames(frames_of(res), want, fields, name)
            with plain_kernels():
                res_p = run()
            torch.cuda.synchronize()
            check_same_exact(res, res_p, name)
            del res_p
            fig = jrc_timing(run, reps)
            fig.update(samples_per_s=n / (fig["wall_ms"] / 1e3), snr_err_db=snr_err)
            figs[name] = fig
            print(f"mesh: {name} over NCCL, world 1, one block of {n}: {int(res.n_frames)} frames "
                  f"== crc_ok, equal to scan_rx's frames (SNR within {snr_err:.2g} dB), plain "
                  f"path identical; launches "
                  f"{counts[name]}; {fig['samples_per_s']:.6g} samples/s ({fig['wall_ms']:.3f} "
                  f"ms), device {fig['device_ms']:.3f} ms in {fig['launches']:.0f} launches, "
                  f"{fig['host_syncs']} host syncs", flush=True)
        halo = frame_window_samples(cfg, spec) + cfg.fft_len
        bl = model.block_len
        caps = torch.stack([x[b * bl : (b + 1) * bl + halo] for b in range(N_BATCH)])
        bm = mesh.batch_mesh(1)
        run = lambda: batch.batched_rx(bm, cfg, spec, caps, max_frames=12)  # noqa: E731
        got, counts["batched_rx"] = counted(run)
        check_main_path_counts(counts["batched_rx"], "batched_rx")
        with plain_kernels():
            got_p = run()
        check(torch.equal(got, got_p), "batched_rx: kernel path and plain path differ")
        tab = model.constants()
        per_block = torch.stack([torch.stack([r.valid.sum(), r.crc_ok.sum()]).float() for r in (
            rx_block(cfg, spec, tab, caps[b], bl, max_frames=12) for b in range(N_BATCH))])
        check(torch.equal(got, per_block), "batched_rx differs from rx_block block by block")
        print(f"mesh: batched_rx over {N_BATCH} blocks of the bench capture: "
              f"{int(got[:, 0].sum())} frames, equal to rx_block block by block, plain path "
              f"identical; launches "
              f"{counts['batched_rx']}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for block_len in (2**22, 2**22 + 64):
            t0 = time.perf_counter()
            starts = np.sort(mesh_ranks(block_len, tmp, len(flat["start"])))
            check((starts == flat["start"]).all(),
                  f"two gloo ranks at block_len {block_len}: starts differ from scan_rx's")
            figs[f"gloo_2_ranks_{block_len}"] = {"s": time.perf_counter() - t0}
            print(f"mesh: 2 gloo ranks on this card at block_len {block_len} "
                  f"({'flat_rx' if block_len % 128 == 0 else 'rx_block'}): {len(starts)} frames == "
                  f"crc_ok (static and dynamic), global starts equal to scan_rx's; two processes "
                  f"in {time.perf_counter() - t0:.1f} s", flush=True)
    figs["dryrun_world_1"] = phase_dryrun()
    return counts, figs


def phase_dryrun() -> dict:
    """The dry run of the sharded executors (``python -m
    jrc_tpu_torch.parallel.dryrun``) at a world of one over NCCL, its
    launcher a subprocess with a time limit: rank 0's ``DRYRUN_OK`` line and
    exit code 0, the captured steps equal to their eager runs (checked in the
    rank), and the rank left through ``mesh.teardown`` after its graphs."""
    import os

    t0 = time.perf_counter()
    try:
        run = subprocess.run([sys.executable, "-m", "jrc_tpu_torch.parallel.dryrun", "--world", "1",
                              "--timeout", "240"], capture_output=True, text=True, timeout=300,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"mesh: the world-1 dry run outlived its limit:\n{e.stdout}") from e
    text = run.stdout + run.stderr
    line = next((ln for ln in run.stdout.splitlines() if ln.startswith("DRYRUN_OK rank=0 ")), "")
    check(run.returncode == 0 and "world=1 backend=nccl" in line and "captured=True" in line,
          f"mesh: the world-1 NCCL dry run exited {run.returncode}:\n{text[-3000:]}")
    s = time.perf_counter() - t0
    print(f"mesh: dry run over NCCL, world 1, through its launcher: {line}; exit 0 after "
          f"the teardown, {s:.1f} s", flush=True)
    return {"s": s, "line": line}


def rel_err(got: torch.Tensor, want) -> float:
    """max |got − want| / max |want|."""
    want = torch.as_tensor(np.asarray(want)).to(got.device)
    return float((got - want).abs().max() / want.abs().max())


def jrc_frames(cfg, trx, dev):
    """{"data": (spec, payload), "ndp": (spec, payload)} of the reference's
    JRC tests: QPSK-3/4 DATA frames of 80 B, QPSK-1/2 NDP frames of 24 B."""
    from jrc_tpu_torch.config import MCS, PacketType
    from jrc_tpu_torch.ops.encoder import FrameSpec, make_payload

    out = {}
    for name, mcs, n_bytes, ptype, data in (
            ("data", MCS.QPSK_3_4, 80, PacketType.DATA, b"\x02jrc data frame"),
            ("ndp", MCS.QPSK_1_2, 24, PacketType.NDP, b"\x01")):
        spec = FrameSpec(mcs, payload_bytes=n_bytes, packet_type=ptype)
        out[name] = (spec, torch.from_numpy(make_payload(spec, data)).to(dev))
    return out


def check_tx_frames(cfg, trx, dev) -> float:
    """The port's tx_frame on the card against the four frames of
    tests/golden_tx_frames.npz that need no random draw, and the pinned
    bench frame rebuilt through tx_frame and comm_channel (angle 0, path
    loss 5, CFO 0.02·2π/fft_len): each within 1e-5 · max|want| → the worst."""
    from pathlib import Path

    from jrc_tpu_torch import capture
    from jrc_tpu_torch.config import MCS, PacketType
    from jrc_tpu_torch.models import comm_link
    from jrc_tpu_torch.ops import channel, precoder
    from jrc_tpu_torch.ops.encoder import FrameSpec

    golden = np.load(Path(__file__).resolve().parent / "tests" / "golden_tx_frames.npz")
    h = np.zeros((cfg.fft_len, cfg.n_tx), np.complex64)  # the sounded channel: a ULA at 18°
    h[cfg.active_carrier_idx] = np.exp(1j * np.pi * np.sin(np.deg2rad(18.0)) * np.arange(cfg.n_tx))
    errs = {}
    for case in ("data_fourier", "data_steered_phased", "data_mean_svd", "ndp"):
        spec = FrameSpec(MCS(int(golden[f"{case}_mcs"])),
                         payload_bytes=int(golden[f"{case}_payload_bytes"]),
                         packet_type=PacketType(int(golden[f"{case}_ptype"])))
        tab = trx.tables(spec)
        ht = torch.from_numpy(h).to(dev)
        kw = {}
        if case == "data_steered_phased":
            kw["steering"] = precoder.steering_from_chan_est(cfg, tab, ht, phased=True)[0]
        elif case == "data_mean_svd":
            kw["mean_steering"] = precoder.steering_from_chan_est(cfg, tab, ht, phased=False)[1]
        payload = torch.from_numpy(golden[f"{case}_payload"]).to(dev)
        tx = comm_link.tx_frame(cfg, spec, tab, payload, 1, **kw)
        errs[case] = rel_err(tx.samples, golden[f"{case}_wave"])
    frame, payload, _ = capture.load_bench_frame()
    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=len(payload), packet_type=PacketType.DATA)
    tx = comm_link.tx_frame(cfg, spec, trx.tables(spec), torch.from_numpy(payload).to(dev), 1)
    errs["bench frame"] = rel_err(channel.comm_channel(
        tx.samples, angle_deg=0.0, path_loss=5.0,
        cfo=0.02 * 2 * np.pi / cfg.fft_len), frame)
    for case, err in errs.items():
        check(err <= 1e-5, f"tx_frame on the card: {case} off by {err:.3g} · max|want|")
    print(f"jrc: tx_frame on the card reproduces the golden frames and the pinned bench frame "
          f"(error / max|want|: {', '.join(f'{c} {e:.3g}' for c, e in errs.items())})", flush=True)
    return max(errs.values())


def check_pinned_dwells(trx, dev) -> dict:
    """JRCTrx over the dwells jrc_tpu's jrc_step pinned in
    jrc_tpu_torch/data/jrc_dwells.npz, with their draws, from the initial
    state: each dwell's record within capture.jrc_mismatches' tolerances."""
    from jrc_tpu_torch import capture
    from jrc_tpu_torch.models import jrc_trx

    state = trx.init_state()
    worst = dict.fromkeys(capture.JRC_RELATIVE, 0.0)
    worst_db = 0.0
    for i, dw in enumerate(capture.pinned_jrc_dwells()):
        spec, payload, targets, draws, opts = capture.pinned_step_args(dw, dev)
        r = trx(state, spec, payload, targets, draws=draws, **opts)
        got, want = capture.step_record(r), capture.jrc_record(dw.want)
        bad = capture.jrc_mismatches(got, want)
        check(not bad, f"pinned dwell {i} on the card: {bad}")
        for k in capture.JRC_RELATIVE:
            w = np.asarray(want[k])
            worst[k] = max(worst[k], float(np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-30)))
        worst_db = max(worst_db, *(abs(float(got[k]) - float(want[k])) for k in capture.JRC_DB))
        state = r.state
    print(f"jrc: {len(capture.JRC_DWELLS)} pinned dwells reproduced on the card (exact fields "
          f"equal; error / max|want| {', '.join(f'{k} {v:.3g}' for k, v in worst.items())}; "
          f"SNRs within {worst_db:.3g} dB)", flush=True)
    return dict(relative=worst, db=worst_db)


def check_closed_loop(cfg, trx, frames, dev) -> dict:
    """The moving-target scenario of tests/test_jrc.py: five dwells from 24°
    to 8°, 8 m/s, background frozen, each against the Fourier fallback on
    the same comm noise; then an NDP frame and the DATA frames steered from
    its estimate (Householder per subcarrier, phased mean)."""
    from jrc_tpu_torch.models import comm_link
    from jrc_tpu_torch.ops import channel

    spec, payload = frames["data"]
    n = trx.tables(spec).sync_freq.shape[0]  # the frame and jrc_step's padding of 5 + 3 symbols
    n = (n + 1 + cfg.n_ltf + spec.n_ofdm_sym + 8) * cfg.sym_len
    state, fresh = trx.init_state(), trx.init_state()
    gains, angles = [], (24.0, 20.0, 16.0, 12.0, 8.0)
    for d, az in enumerate(angles):
        tgt = channel.Targets((12.0,), (8.0,), (az,), (10.0,))
        draws = comm_link.Draws(comm_noise=channel.normal_pair((n,), generator=trx.generator,
                                                               device=dev))
        kw = dict(draws=draws, radar_aided=True, background_record=False,
                  comm_noise_var=JRC_NOISE_VAR)
        r = trx(state, spec, payload, tgt, **kw)
        est = r.radar_est
        check(bool(est.detected), f"closed loop dwell {d}: no detection")
        check(abs(float(est.angle_deg) - az) < 2.5, f"dwell {d}: angle {float(est.angle_deg)} vs {az}")
        check(abs(float(est.range_m) - 12.0) < 0.6, f"dwell {d}: range {float(est.range_m)} vs 12")
        if d > 0:  # steered by the previous dwell's angle
            check(bool(r.comm.decoded.crc_ok), f"closed loop dwell {d}: CRC failed")
            rf = trx(fresh, spec, payload, tgt, **kw)
            gains.append(20 * np.log10(float(r.comm.eq.chan_mean[0].abs())
                                       / float(rf.comm.eq.chan_mean[0].abs())))
        state = r.state
    check(np.mean(gains) >= 3.0 and min(gains) > 0.0, f"radar-aided gains {gains} dB")
    ndp_spec, ndp_payload = frames["ndp"]
    targets = channel.Targets((12.0,), (0.0,), (25.0,), (10.0,))
    rn = trx(trx.init_state(), ndp_spec, ndp_payload, targets, radar_aided=False,
             comm_noise_var=JRC_NOISE_VAR)
    check(bool(rn.state.chan_valid), "the NDP frame did not set the channel estimate")
    for what, kw in (("Householder per subcarrier", dict(phased_steering=False)),
                     ("phased mean", dict(phased_steering=True, smoothing=True))):
        rd = trx(rn.state, spec, payload, targets, radar_aided=False, comm_noise_var=JRC_NOISE_VAR,
                 **kw)
        check(bool(rd.comm.decoded.crc_ok), f"DATA after NDP, {what} steering: CRC failed")
    print(f"jrc: closed loop, target 24° → 8° at 8 m/s: detected in 5 of 5 dwells within 2.5° "
          f"and 0.6 m, CRC-clean from dwell 1, radar-aided gain over the Fourier fallback "
          f"{', '.join(f'{g:.2f}' for g in gains)} dB (mean {np.mean(gains):.2f}); NDP → "
          f"Householder and phased-mean DATA CRC-clean", flush=True)
    return dict(gains_db=gains)


def check_kernel_call(name: str, args, kw, what: str) -> tuple[float, tuple]:
    """One recorded kernel call (``registry.recorded_calls``) again through
    the kernel and through its plain version on the same inputs: K1 bits and
    K2 triggers exact, K2's autocorrelation within 1e-5 (with a row layout:
    every field of its trigger selection exact), K3's rows within
    ROT_ATOL · max|x| (exact without a rotation) → (max |err|, shape)."""
    from jrc_tpu_torch.kernels.registry import plain, wrapper
    from jrc_tpu_torch.ops import gather_cuda

    k = next(k for k in KERNELS if k.name == name)
    got, want = wrapper(k)(*args, **kw), plain(k)(*args, **kw)
    torch.cuda.synchronize()
    if name == "viterbi_decode":
        check(torch.equal(got, want), f"{what}: K1 kernel != plain at {tuple(args[0].shape)}")
        return 0.0, tuple(args[0].shape)  # (2T,) for one frame
    if name == "detect_front_end" and kw.get("rows") is not None:
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"{what}: K2's trigger selection kernel != plain")
        return 0.0, (args[0].shape[0],)
    if name == "detect_front_end":
        check(torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]),
              f"{what}: K2 triggers kernel != plain")
        torch.testing.assert_close(torch.view_as_real(got[0]), torch.view_as_real(want[0]),
                                   rtol=1e-5, atol=1e-5)
        return float((got[0] - want[0]).abs().max()), (args[0].shape[0],)
    x, starts, w = args[:3]
    rot = kw.get("rot")
    err = float((torch.view_as_real(got) - torch.view_as_real(want)).abs().max())
    tol = 0.0 if rot is None else gather_cuda.ROT_ATOL * float(x.abs().max())
    check(err <= tol, f"{what}: K3 kernel differs from plain by {err} at width {w}")
    return err, (starts.shape[0], w)


def check_recorded_kernels(calls, reps: int, what: str = "jrc", where: str = "the comm leg",
                           per: str = "step") -> dict:
    """Each kernel call of one run (``registry.recorded_calls``: a jrc_step,
    a link_curve point) held against its plain version (``check_kernel_call``);
    the kernel's time (wrapped, alone), plain time, bound and library time per
    call, summed over the run's calls → {kernel: row}, the calls a run under
    ``launches_per_<per>``."""
    from jrc_tpu_torch.kernels.registry import plain, wrapper
    from jrc_tpu_torch.ops import sync
    from jrc_tpu_torch.profiling import device_ms, time_ms

    by_name = {k.name: k for k in KERNELS}
    rows = {}
    for name, args, kw in calls:
        k = by_name[name]
        fn, fn_plain = wrapper(k), plain(k)
        err, shape = check_kernel_call(name, args, kw, what)
        library = None
        if name == "viterbi_decode":
            bound_ms, bound_by = viterbi_bound(int(np.prod(shape[:-1])), shape[-1] // 2)
        elif name == "detect_front_end":
            n = shape[0]
            bound_ms, bound_by = bound(16 * n + 8 * -(-n // 128), 20 * n)
        else:
            x, starts, w = args[:3]
            rot = kw.get("rot")
            bound_ms, bound_by = bound(2 * 8 * starts.shape[0] * w + 20 * starts.shape[0], 0)
            idx = starts.clamp(0, x.shape[0] - w)[:, None] + torch.arange(w, device=x.device)
            kk = torch.arange(w, dtype=torch.float32, device=x.device)[None, :]
            if rot is not None and rot[1] is not None:
                kk = rot[1].to(torch.float32)[:, None] + kk
            library = time_ms((lambda: x[idx]) if rot is None
                              else (lambda: x[idx] * sync.expj(rot[0][:, None] * kk)), reps)

        def call():
            return fn(*args, **kw)

        alone, _ = device_ms(call)
        sh = dict(shape=shape, ms=time_ms(call, reps), kernel_only_ms=alone,
                  plain_ms=time_ms(lambda: fn_plain(*args, **kw), reps), bound_ms=bound_ms,
                  bound_by=bound_by, library_ms=library, max_abs_err=err)
        row = rows.setdefault(name, {f"launches_per_{per}": 0, "max_abs_err": 0.0, "ms": 0.0,
                                     "kernel_only_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                                     "bound_by": bound_by, "library_ms": None, "shapes": []})
        row[f"launches_per_{per}"] += 1
        row["shapes"].append(sh)
        for key in ("ms", "kernel_only_ms", "plain_ms", "bound_ms"):
            row[key] += sh[key]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if library is not None:
            row["library_ms"] = (row["library_ms"] or 0.0) + library
    for name, row in rows.items():
        print(f"{what}: {name} on {where}, {row[f'launches_per_{per}']} calls a {per} at "
              f"{[sh['shape'] for sh in row['shapes']]}: kernel == plain (max |err| "
              f"{row['max_abs_err']:.3g}); {row['ms']:.4f} ms wrapped, {row['kernel_only_ms']:.4f} "
              f"ms alone, bound {row['bound_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms", flush=True)
    return rows


def jrc_timing(run, reps: int) -> dict:
    """Wall time of ``run`` (median of ``reps`` runs after three warm-up runs,
    each ended by a synchronize, with min-max), its device ms and launches
    a run (a profiler trace of 3 runs) and its host syncs (warnings of the
    sync debug mode over one run)."""
    import warnings

    from jrc_tpu_torch.profiling import device_events

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    events = device_events(run, 3)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = statistics.median(times)
    device = sum(e["dur"] for e in events) / 1e3 / 3
    return dict(wall_ms=wall, wall_ms_min=min(times), wall_ms_max=max(times), per_s=1e3 / wall,
                device_ms=device, idle_share=1 - device / wall, launches=len(events) / 3,
                host_syncs=sum("synchroniz" in str(w.message).lower() for w in caught))


def phase_jrc_app(dev) -> tuple[dict, dict]:
    """apps/jrc_trx of the port on the card, 16 frames, logs in a temporary
    directory: every burst detects the target, every DATA frame from frame 1
    on is CRC-clean (frame 0 goes out on the Fourier fallback, as in the
    reference app) → (launch counts, figures)."""
    import contextlib
    import io
    import tempfile

    from jrc_tpu_torch.apps import jrc_trx as app

    n_frames = 16
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--frames", str(n_frames), "--heatmap", "", "--radar-log", f"{tmp}/radar_log.csv",
                "--comm-log", f"{tmp}/comm_log.csv"]
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc, counts = counted(lambda: app.main(argv))
        wall = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    check(rc == 0, f"apps/jrc_trx returned {rc}")
    frames = [ln for ln in lines if ln.startswith("frame ")]
    check(len(frames) == n_frames, f"apps/jrc_trx printed {len(frames)} frame lines")
    bursts = [ln for ln in frames if "BURST" in ln]
    check(bursts and all("det=True" in ln for ln in bursts), f"apps/jrc_trx bursts: {bursts}")
    data = [ln for ln in frames if "[DATA]" in ln]
    check(all("crc=True" in ln for ln in data[1:]), "apps/jrc_trx: a DATA frame after frame 0 "
          "failed its CRC")
    n_ok = sum("crc=True" in ln for ln in data)
    summary = lines[-1]
    check(f"PER: {100.0 * (1 - n_ok / len(data)):.1f}% over {len(data)} DATA frames" in summary
          and "missed=0" in summary, f"apps/jrc_trx summary: {summary}")
    print(f"jrc: apps/jrc_trx on the card, {n_frames} frames: {len(bursts)} bursts, each det=True; "
          f"'{summary}' (frame 0 on the Fourier fallback: {data[0].split(': ')[1].split()[0]}); "
          f"launches {counts}; {1e3 * wall / n_frames:.3f} ms a frame", flush=True)
    return counts, dict(frames=n_frames, bursts=len(bursts), summary=summary,
                        ms_per_frame=1e3 * wall / n_frames)


def phase_jrc(dev, reps: int) -> tuple[dict, dict, dict]:
    """The JRC closed loop on the card → ({run: launch counts}, {kernel: row
    at the comm leg's shapes}, figures)."""
    from jrc_tpu_torch.config import OFDMConfig
    from jrc_tpu_torch.kernels.registry import recorded_calls
    from jrc_tpu_torch.models import jrc_trx, radar_chain
    from jrc_tpu_torch.ops import channel

    cfg = OFDMConfig()
    trx = jrc_trx.JRCTrx(cfg, seed=0)  # the card: the module's default device
    check(trx.device.type == "cuda", f"JRCTrx built on {trx.device}")
    frames = jrc_frames(cfg, trx, dev)
    figs = dict(tx_err=check_tx_frames(cfg, trx, dev), pinned=check_pinned_dwells(trx, dev))
    figs["closed_loop"] = check_closed_loop(cfg, trx, frames, dev)

    # one dwell at the operating point: DATA, radar-aided steering from a detection
    spec, payload = frames["data"]
    targets = channel.Targets((12.0,), (5.0,), (25.0,), (10.0,))
    state = trx(trx.init_state(), spec, payload, targets, comm_noise_var=JRC_NOISE_VAR).state

    def step():
        return trx(state, spec, payload, targets, comm_noise_var=JRC_NOISE_VAR)

    step()
    r, counts = counted(step)
    check(bool(r.radar_est.detected) and bool(r.comm.decoded.crc_ok),
          "jrc_step at the operating point: no detection or a CRC failure")
    calls = []
    with recorded_calls(calls):
        step()
    kernel_rows = check_recorded_kernels(calls, reps)
    check({n: row["launches_per_step"] for n, row in kernel_rows.items()} == counts,
          f"the recorded calls {kernel_rows.keys()} are not the step's launches {counts}")

    # rates at the reference's operating point (bench.py: bench_radar_jrc)
    tab, rtab = trx.tables(spec), trx.radar_tables()
    _, radar_counts = counted(lambda: radar_chain.radar_frame(cfg, spec, tab, rtab, payload,
                                                              targets))
    radar = jrc_timing(lambda: radar_chain.radar_frame(cfg, spec, tab, rtab, payload, targets),
                       max(reps, 20))
    loop = {"state": state}

    def loop_step():
        loop["state"] = trx(loop["state"], spec, payload, targets,
                            comm_noise_var=JRC_NOISE_VAR).state

    steps = jrc_timing(loop_step, max(reps, 20))
    figs.update(radar_dwell=dict(radar, kernel_launches=radar_counts),
                jrc_step=dict(steps, kernel_launches=counts))
    for what, fig in (("radar dwell (radar_frame)", figs["radar_dwell"]),
                      ("JRC step (jrc_step)", figs["jrc_step"])):
        print(f"jrc: {what}: {fig['per_s']:.6g} /s, {fig['wall_ms']:.4f} ms "
              f"({fig['wall_ms_min']:.4f}-{fig['wall_ms_max']:.4f}), device {fig['device_ms']:.4f} ms "
              f"in {fig['launches']:.0f} launches (idle {100 * fig['idle_share']:.1f}%), "
              f"{fig['host_syncs']} host syncs, kernel launches {fig['kernel_launches']}", flush=True)
    check(figs["jrc_step"]["host_syncs"] == 0, "jrc_step synchronizes with the host")
    app_counts, figs["app"] = phase_jrc_app(dev)
    return {"jrc_step": counts, "radar_frame": radar_counts, "jrc_app": app_counts}, kernel_rows, figs

SIM_POINT = ("QPSK_3_4", 10.0)  # the BER-sweep point whose kernel calls are held and timed
GOLDEN_BER = "tests/golden_ber.json"


def golden_frame(name: str, payload_bytes: int, dev):
    """(spec, tables on dev, payload on dev) of tests/golden_ber.json's frames:
    DATA at ``name``, the payload a type byte then zeros."""
    from jrc_tpu_torch import tables
    from jrc_tpu_torch.config import MCS, OFDMConfig, PacketType
    from jrc_tpu_torch.ops.encoder import FrameSpec, make_payload

    spec = FrameSpec(MCS[name], payload_bytes=payload_bytes, packet_type=PacketType.DATA)
    payload = torch.from_numpy(make_payload(spec, bytes([2]) + bytes(payload_bytes - 1)))
    return spec, tables.from_numpy(OFDMConfig(), spec, dev), payload.to(dev)


def per_tolerance(golden_per: float, n: int) -> float:
    """The statistical gate on a PER of n frames drawn from another generator
    than the golden's: 4·sqrt(q(1−q)/n) + 2/n with q = max(golden, 2/n)."""
    q = max(golden_per, 2.0 / n)
    return 4.0 * float(np.sqrt(q * (1.0 - q) / n)) + 2.0 / n


def check_link_gates(cfg, dev, golden: dict) -> dict:
    """link_curve's two gates. (a) exact: BPSK-1/2 and 16-QAM-3/4 at their
    golden SNRs, 8 frames, noise from a seeded CPU generator, on the card
    and on the CPU through the plain versions: every frame's bit errors and
    CRC flag equal. (b) statistical: every golden point with the golden's 48
    frames on the card (the card's generators, seeded with the golden seed),
    each PER within ``per_tolerance`` of the golden's."""
    from jrc_tpu_torch.models import comm_link, evaluation
    from jrc_tpu_torch.ops import channel

    n_exact = 0
    for name in ("BPSK_1_2", "QAM16_3_4"):
        snrs = [p["snr_db"] for p in golden["curves"][name]]
        spec, tab, payload = golden_frame(name, golden["payload_bytes"], dev)
        gen = torch.Generator().manual_seed(golden["seed"])
        n = comm_link.loopback_samples(cfg, spec)
        noise = [channel.normal_pair((8, n), generator=gen) for _ in snrs]
        on_card, on_cpu = [], []
        evaluation.link_curve(cfg, spec, tab, payload, snrs, n_frames=8, noise=noise,
                              points=on_card)
        _, tab_cpu, payload_cpu = golden_frame(name, golden["payload_bytes"], "cpu")
        evaluation.link_curve(cfg, spec, tab_cpu, payload_cpu, snrs, n_frames=8, noise=noise,
                              points=on_cpu)
        for snr, a, b in zip(snrs, on_card, on_cpu):
            check(torch.equal(a.bit_errors.cpu(), b.bit_errors) and torch.equal(a.crc_ok.cpu(),
                                                                                b.crc_ok),
                  f"link_curve {name} at {snr} dB: card {a} != CPU {b}")
            n_exact += 8
    print(f"sim: link_curve on the card equals the CPU's plain path frame for frame (bit errors "
          f"and CRC flags of {n_exact} frames, BPSK_1_2 and QAM16_3_4 at the golden SNRs, the "
          f"same CPU-drawn noise)", flush=True)

    n_frames, margins = golden["n_frames"], []
    for name, pts in golden["curves"].items():
        spec, tab, payload = golden_frame(name, golden["payload_bytes"], dev)
        got = evaluation.link_curve(cfg, spec, tab, payload, [p["snr_db"] for p in pts],
                                    n_frames=n_frames, seed=golden["seed"])
        for want, pt in zip(pts, got):
            tol = per_tolerance(want["per"], n_frames)
            margin = tol - abs(pt.per - want["per"])
            margins.append(dict(mcs=name, snr_db=pt.snr_db, per=pt.per, golden=want["per"],
                                ber=pt.ber, tolerance=tol, margin=margin))
            print(f"sim: golden {name} {pt.snr_db:4.1f} dB: PER {pt.per:.4f} (golden "
                  f"{want['per']:.4f}, tolerance {tol:.4f}, margin {margin:.4f}), BER {pt.ber:.3e}",
                  flush=True)
    bad = [m for m in margins if m["margin"] < 0]
    check(not bad, f"link_curve PER outside the golden gate at {bad}")
    # the gate's power: the same curves 1 dB lower, held against the same goldens
    tripped = []
    for name, pts in golden["curves"].items():
        spec, tab, payload = golden_frame(name, golden["payload_bytes"], dev)
        got = evaluation.link_curve(cfg, spec, tab, payload, [p["snr_db"] - 1.0 for p in pts],
                                    n_frames=n_frames, seed=golden["seed"])
        if any(abs(pt.per - w["per"]) > per_tolerance(w["per"], n_frames)
               for w, pt in zip(pts, got)):
            tripped.append(name)
    print(f"sim: the golden gate at every point held (least margin "
          f"{min(m['margin'] for m in margins):.4f}); the same curves 1 dB lower trip it in "
          f"{len(tripped)} of {len(golden['curves'])} MCS ({', '.join(tripped)})", flush=True)
    return dict(exact_frames=n_exact, golden=margins, tripped_1db=tripped)


def sim_point(cfg, spec, tab, payload, snr_db: float, n_frames: int, seed: int):
    """One link_curve point with its noise drawn beforehand → a function that
    runs it as link_curve does (``link_point`` on a batch of n_frames, then
    its two host reads)."""
    from jrc_tpu_torch.models import evaluation

    clean = evaluation.clean_waveform(cfg, spec, tab, payload)
    nv, z = evaluation.point_inputs(clean, snr_db, n_frames, seed)

    def point():
        r = evaluation.link_point(cfg, spec, tab, payload, clean, nv, z)
        return int(r.bit_errors.sum()), int(r.crc_ok.sum())

    return point


def phase_ber_sweep(cfg, dev, reps: int) -> tuple[dict, dict, dict]:
    """apps/ber_sweep's sweep at its defaults on the card (6 MCS × 6 SNRs × 32
    frames of 64 B) with the launch counts read, then each point timed alone,
    then one point's kernel calls held against the plain versions →
    (launch counts of the sweep, {kernel: row at the sweep's shapes}, figures)."""
    import contextlib
    import io

    from jrc_tpu_torch.apps import ber_sweep
    from jrc_tpu_torch.config import MCS
    from jrc_tpu_torch.kernels.registry import recorded_calls

    args = ber_sweep.parser().parse_args([])
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        results, counts = counted(lambda: ber_sweep.sweep(
            cfg, list(MCS), args.snrs, frames=args.frames, payload_bytes=args.payload_bytes,
            soft=False, device=dev, jit=False))
    wall = time.perf_counter() - t0
    n_points = sum(len(pts) for pts in results.values())
    for line in out.getvalue().splitlines():
        print(f"sim: ber_sweep {line}", flush=True)
    for name, pts in results.items():
        check(pts[-1].per == 0.0 and pts[-1].ber == 0.0,
              f"ber_sweep: {name} not clean at {pts[-1].snr_db} dB: {pts[-1]}")
    check(results["QAM16_3_4"][0].per == 1.0, "ber_sweep: QAM16_3_4 decodes at 2 dB")
    check(all(c == n_points * k for c, k in zip(
        (counts.get("viterbi_decode"), counts.get("detect_front_end"), counts.get("gather_rows")),
        (2, 1, 2))), f"ber_sweep launches {counts} over {n_points} points: not K1 2, K2 1, "
                     f"K3 2 a point")
    print(f"sim: ber_sweep at its defaults, {n_points} points of {args.frames} frames: "
          f"{n_points * args.frames / wall:.1f} frames/s in all ({wall:.3f} s), launches {counts}",
          flush=True)

    points = []
    for mcs in MCS:
        spec, tab, payload = golden_frame(mcs.name, args.payload_bytes, dev)
        for i, snr in enumerate(args.snrs):
            fig = jrc_timing(sim_point(cfg, spec, tab, payload, snr, args.frames, 1000 * i), reps)
            fig["frames_per_s"] = args.frames * 1e3 / fig["wall_ms"]
            pt = next(p for p in results[mcs.name] if p.snr_db == snr)
            points.append(dict(mcs=mcs.name, snr_db=snr, ber=pt.ber, per=pt.per, **fig))
            print(f"sim: point {mcs.name} {snr:4.1f} dB: BER {pt.ber:.3e} PER {pt.per:.3f}, "
                  f"{fig['frames_per_s']:.1f} frames/s ({fig['wall_ms']:.3f} ms, "
                  f"{fig['wall_ms_min']:.3f}-{fig['wall_ms_max']:.3f}), device "
                  f"{fig['device_ms']:.4f} "
                  f"ms in {fig['launches']:.0f} launches (idle {100 * fig['idle_share']:.1f}%), "
                  f"{fig['host_syncs']} host syncs", flush=True)

    spec, tab, payload = golden_frame(SIM_POINT[0], args.payload_bytes, dev)
    point = sim_point(cfg, spec, tab, payload, SIM_POINT[1], args.frames, 1)
    calls = []
    with recorded_calls(calls):
        point()
    rows = check_recorded_kernels(calls, max(reps // 4, 3), what="sim",
                                  where=f"a BER-sweep point ({SIM_POINT[0]}, {SIM_POINT[1]} dB, "
                                        f"{args.frames} frames)", per="point")
    return counts, rows, dict(points=points, sweep_s=wall, n_points=n_points)


def phase_comm_sim(dev) -> tuple[dict, dict]:
    """apps/comm_sim on the card: 6 frames, SVD steering refreshed by an NDP
    frame every third frame; every DATA frame CRC-clean → (launch counts,
    figures)."""
    import contextlib
    import io
    import tempfile

    from jrc_tpu_torch.apps import comm_sim

    with tempfile.TemporaryDirectory() as tmp:
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc, counts = counted(lambda: comm_sim.main([
                "--frames", "6", "--steering", "svd", "--ndp-every", "3",
                "--comm-log", f"{tmp}/comm_log.csv"]))
        wall = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    check(rc == 0, f"apps/comm_sim returned {rc}")
    data = [ln for ln in lines if "crc=" in ln]
    check(len(data) == 4 and all("crc=True" in ln for ln in data), f"apps/comm_sim: {lines}")
    check(sum("steering refreshed (svd)" in ln for ln in lines) == 2, f"apps/comm_sim: {lines}")
    print(f"sim: apps/comm_sim on the card, 6 frames: 4 DATA frames CRC-clean, 2 NDP soundings; "
          f"'{data[-1]}'; launches {counts}; {1e3 * wall / 6:.3f} ms a frame", flush=True)
    return counts, dict(ms_per_frame=1e3 * wall / 6, last=data[-1])


def _extras_equal(got, want, what: str) -> float:
    """Card result ``got`` against the CPU's ``want`` (NamedTuples): integer and
    flag fields equal, floats within 1e-5 · max|want| (SNRs 1e-3 dB) → the
    worst float error relative to max|want|."""
    worst = 0.0
    for f, a, b in zip(want._fields, got, want):
        a = a.cpu()
        if a.is_floating_point() and "idx" not in f and f not in ("range_m", "angle_deg",
                                                                      "velocity_mps", "freq",
                                                                      "blind_zone_mps"):
            err = float((a - b).abs().max())
            if "snr" in f:
                check(err <= 1e-3, f"{what}.{f} card vs CPU: {err} dB")
            else:
                rel = err / max(float(b.abs().max()), 1e-30)
                check(rel <= 1e-5, f"{what}.{f} card vs CPU: {rel:.3g} · max")
                worst = max(worst, rel)
        else:
            check(torch.equal(a, b), f"{what}.{f} card {a} != CPU {b}")
    return worst


def phase_radar_sim(cfg, dev, reps: int) -> tuple[dict, dict]:
    """apps/radar_sim on the card with two targets (12 m / 25°, 5 m / −20°),
    --max-targets 3 --cfar --window-range hann: both targets found within 1 m
    and 3°, the peak bin a CFAR detection; the extras on the card against the
    CPU on the same map (range_angle_estimate_multi, cfar_detect), a dwell
    timed (``jrc_timing``) → (launch counts, figures)."""
    import contextlib
    import io
    import tempfile

    from jrc_tpu_torch.apps import radar_sim
    from jrc_tpu_torch.ops import radar

    with tempfile.TemporaryDirectory() as tmp:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc, counts = counted(lambda: radar_sim.main([
                "--dwells", "2", "--targets", "12:0:25:10", "5:0:-20:10", "--max-targets", "3",
                "--cfar", "--window-range", "hann", "--heatmap", "",
                "--radar-log", f"{tmp}/radar_log.csv"]))
    lines = out.getvalue().splitlines()
    check(rc == 0 and not counts, f"apps/radar_sim returned {rc}, launched {counts}")
    found = []
    for ln in lines[-5:]:
        if ln.strip().startswith("target"):
            found.append((float(ln.split("range=")[1].split()[0]),
                          float(ln.split("angle=")[1].split()[0])))
    for r, a in ((12.0, 25.0), (5.0, -20.0)):
        check(any(abs(fr - r) <= 1.0 and abs(fa - a) <= 3.0 for fr, fa in found),
              f"apps/radar_sim: no target at {r} m / {a}° in {found}")
    check(all("peak bin detected=True" in ln for ln in lines if "cfar:" in ln),
          f"apps/radar_sim: {lines}")

    sc = radar_sim.scene(cfg, dev, [(12.0, 0.0, 25.0, 10.0), (5.0, 0.0, -20.0, 10.0)],
                         window_range="hann")
    kw = dict(guard=radar_sim.CFAR_GUARD, train=radar_sim.CFAR_TRAIN, pfa=1e-4)

    def dwell():
        return radar_sim.dwell(cfg, sc, max_targets=3, cfar_pfa=kw["pfa"])

    res, multi, cf = dwell()
    m_cpu = res.ra_map.cpu()
    axes = sc.rtab.range_axis.cpu(), sc.rtab.angle_axis.cpu()
    err = _extras_equal(multi, radar.range_angle_estimate_multi(m_cpu, *axes, max_targets=3),
                        "range_angle_estimate_multi")
    p_cpu = m_cpu.real ** 2 + m_cpu.imag ** 2
    cf_cpu = radar.cfar_detect(p_cpu, **kw)
    scale = float(p_cpu.max()) * 1e-5
    check(float((cf.noise.cpu() - cf_cpu.noise).abs().max()) <= scale
          and float((cf.threshold.cpu() - cf_cpu.threshold).abs().max())
          <= scale * float((cf_cpu.threshold / cf_cpu.noise.clamp_min(1e-30)).max()),
          "cfar_detect noise / threshold card vs CPU")
    differ = cf.detections.cpu() != cf_cpu.detections
    near = (p_cpu - cf_cpu.threshold).abs() <= 1e-4 * cf_cpu.threshold
    check(not bool((differ & ~near).any()), "cfar_detect detections card vs CPU off the threshold")
    fig = jrc_timing(dwell, max(reps, 20))
    print(f"sim: apps/radar_sim on the card: targets {found}, every CFAR peak bin detected; the "
          f"extras on the card equal the CPU's on the same map (multi floats {err:.3g} · max, "
          f"{int(differ.sum())} CFAR cells flipped within 1e-4 of the threshold); a dwell "
          f"(radar_frame + 3-target CLEAN + CFAR): {fig['wall_ms']:.4f} ms "
          f"({fig['wall_ms_min']:.4f}-{fig['wall_ms_max']:.4f}), device {fig['device_ms']:.4f} ms in {fig['launches']:.0f} "
          f"launches (idle {100 * fig['idle_share']:.1f}%), {fig['host_syncs']} host syncs",
          flush=True)
    return counts, dict(targets=found, cfar_flipped=int(differ.sum()), multi_err=err, dwell=fig)


def phase_doppler(cfg, dev) -> tuple[dict, dict]:
    """apps/jrc_trx --doppler-frames 64 on the card with a target at 30 m/s
    (tests/test_doppler.py's scene): the velocity within ±1 bin of the
    app's velocity axis (plus the 0.05 m/s of its print) and the range
    within 0.6 m; then test_doppler.py's 64-burst train through SimTrx on
    the card: the estimate within ±1 bin, and the range-Doppler map and
    estimate equal to the CPU's on the same history → (launch counts,
    figures)."""
    import contextlib
    import io
    import tempfile

    from jrc_tpu_torch import tables
    from jrc_tpu_torch.apps import jrc_trx as app
    from jrc_tpu_torch.config import MCS, PacketType
    from jrc_tpu_torch.io.backend import SimTrx, TrxSession
    from jrc_tpu_torch.models import comm_link
    from jrc_tpu_torch.ops import channel, ofdm, radar
    from jrc_tpu_torch.ops.encoder import FrameSpec, make_payload

    n_frames, v_true = 64, 30.0
    with tempfile.TemporaryDirectory() as tmp:
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc, counts = counted(lambda: app.main([
                "--frames", "1", "--doppler-frames", str(n_frames), "--target",
                f"12:{v_true}:20:10", "--heatmap", "", "--radar-log", f"{tmp}/radar_log.csv",
                "--comm-log", f"{tmp}/comm_log.csv"]))
        wall = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    check(rc == 0, f"apps/jrc_trx --doppler-frames returned {rc}")
    train = [ln for ln in lines if "doppler train" in ln]
    check(len(train) == 1 and f"({n_frames} frames)" in train[0], f"apps/jrc_trx: {lines}")
    v = float(train[0].split("v=")[1].split()[0])
    r = float(train[0].split("@ ")[1].split()[0])
    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=80, packet_type=PacketType.DATA)
    n_samples = (cfg.n_sync_words + 1 + cfg.n_ltf + spec.n_ofdm_sym + 5 + 3) * cfg.sym_len
    v_axis = radar.velocity_axis(n_frames, n_samples / cfg.sample_rate, cfg.center_freq)
    v_bin = float(v_axis[1] - v_axis[0])
    check(abs(v - v_true) <= v_bin + 0.05 and abs(r - 12.0) <= 0.6,
          f"apps/jrc_trx doppler train: v={v} (bin {v_bin:.3f}), range {r}")

    nspec = FrameSpec(MCS.QPSK_1_2, payload_bytes=30, packet_type=PacketType.NDP)
    payload = torch.from_numpy(make_payload(nspec, bytes([1]) + bytes(26))).to(dev)
    session = TrxSession(SimTrx(cfg, channel.Targets((12.0,), (v_true,), (20.0,), (10.0,))),
                         update_period=0.0)
    tab = tables.from_numpy(cfg, nspec, dev)
    tx = comm_link.tx_frame(cfg, nspec, tab, payload, 1, pad_tail=3 * cfg.sym_len)
    sl = slice(cfg.n_sync_words + 1, cfg.n_sync_words + 1 + cfg.n_ltf)
    x_ref, n_sym = tx.grid.transpose(0, 1)[:, sl], tx.grid.shape[0]
    hist = torch.stack([radar.radar_channel_estimate(
        x_ref, ofdm.ofdm_demodulate(cfg, session.frame(tx.samples, 0.0).rx, n_sym)[:, sl])
        for _ in range(n_frames)])
    t_dwell = tx.samples.shape[-1] / cfg.sample_rate
    vb = radar.velocity_axis(n_frames, t_dwell, cfg.center_freq)
    rb = radar.range_axis(cfg.fft_len, cfg.sample_rate)
    rd = radar.range_doppler_map(hist)
    est = radar.range_doppler_estimate(rd, torch.from_numpy(rb).to(dev),
                                       torch.from_numpy(vb).to(dev))
    rd_cpu = radar.range_doppler_map(hist.cpu())
    map_err = float((rd.cpu() - rd_cpu).abs().max() / rd_cpu.abs().max())
    check(map_err <= 1e-5, f"range_doppler_map card vs CPU: {map_err:.3g} · max")
    est_err = _extras_equal(est, radar.range_doppler_estimate(rd.cpu(), torch.from_numpy(rb),
                                                              torch.from_numpy(vb)),
                            "range_doppler_estimate")
    vb_bin = float(vb[1] - vb[0])
    check(bool(est.detected) and abs(float(est.velocity_mps) - v_true) <= vb_bin
          and abs(float(est.range_m) - 12.0) <= 0.6,
          f"SimTrx train: {float(est.velocity_mps)} m/s (bin {vb_bin:.3f}) at "
          f"{float(est.range_m)} m")
    print(f"sim: apps/jrc_trx --doppler-frames {n_frames} on the card, target at {v_true} m/s: "
          f"'{train[0].strip()}' (bin {v_bin:.3f} m/s), {1e3 * wall:.1f} ms; test_doppler's "
          f"train through SimTrx on the card: v {float(est.velocity_mps):.3f} m/s at "
          f"{float(est.range_m):.3f} m (bin {vb_bin:.3f}), map and estimate equal to the CPU's "
          f"(map {map_err:.3g} · max, estimate floats {est_err:.3g} · max); launches {counts}",
          flush=True)
    return counts, dict(v_app=v, v_bin=v_bin, v_train=float(est.velocity_mps), map_err=map_err,
                        ms=1e3 * wall)


def phase_alignment(dev) -> dict:
    """apps/alignment on the card: every virtual-array phase step within 1°
    of the expected step, and the printed lines those of a CPU run."""
    import contextlib
    import io

    from jrc_tpu_torch.apps import alignment

    runs = {}
    for where, argv in (("card", []), ("cpu", ["--cpu"])):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            check(alignment.main(argv) == 0, f"apps/alignment on the {where} failed")
        runs[where] = out.getvalue().splitlines()
    lines = runs["card"]
    steps = [float(x) for x in lines[-2].split("[")[1].rstrip("]").split()]
    expected = float(lines[-1].split(":")[1].split()[0])
    worst = max(abs(x - expected) for x in steps)
    check(len(steps) == 7 and worst <= 1.0, f"apps/alignment steps {steps} vs {expected}")
    check(lines == runs["cpu"], f"apps/alignment card {lines} != CPU {runs['cpu']}")
    print(f"sim: apps/alignment on the card: phase steps {steps} deg, expected {expected} "
          f"(worst {worst:.2f} deg off), lines equal to the CPU run's", flush=True)
    return dict(steps=steps, expected=expected, worst=worst)


def phase_sim(cfg, dev, reps: int) -> tuple[dict, dict, dict]:
    """The simulation and evaluation apps on the card → ({run: launch counts},
    {kernel: row at the BER sweep's shapes}, figures)."""
    import json as _json
    from pathlib import Path

    golden = _json.loads((Path(__file__).resolve().parent / GOLDEN_BER).read_text())
    sweep_counts, rows, figs = phase_ber_sweep(cfg, dev, reps)
    figs["gates"] = check_link_gates(cfg, dev, golden)
    comm_counts, figs["comm_sim"] = phase_comm_sim(dev)
    radar_counts, figs["radar_sim"] = phase_radar_sim(cfg, dev, reps)
    doppler_counts, figs["doppler"] = phase_doppler(cfg, dev)
    figs["alignment"] = phase_alignment(dev)
    return ({"ber_sweep": sweep_counts, "comm_sim": comm_counts, "radar_sim": radar_counts,
             "jrc_doppler": doppler_counts}, rows, figs)


def phase_configs(dev, reps: int) -> tuple[dict, dict, dict]:
    """The antenna configurations beside the default and the last functions
    of the port on the card → ({run: launch counts}, {kernel: {config:
    row}}, figures):

    - at each (n_tx, n_rx, n_ltf) of ``capture.ANTENNA_CONFIGS``, the dwell
      sequences ``capture.ENTRY_DWELLS`` (the ``__graft_entry__.py`` dwell
      three times) and ``SOUNDING_DWELLS`` (NDP, then a DATA frame steered
      from its estimate with radar streams) through ``JRCTrx`` on the card
      and on the CPU with the same seeded draws: every exact field equal,
      floats within ``capture.jrc_mismatches``' tolerances, launches counted;
      every K1/K2/K3 call of the counted sounding dwells, and of one more
      entry dwell (timed), against its plain version;
    - ``scan_rx`` at n_ltf 2 (2 TX, 1 RX) on a 2^20-sample capture of frames
      the port encodes there: valid == crc_ok == the frames placed, every
      payload the encoded one, the plain path's run equal to it;
    - ``viterbi_decode_chunked`` (plain torch) against K1 at (3072, 576) with
      20% erasures: bits equal but where two paths cost exactly the same, and
      equal to the chunked decoder on the CPU; both timed;
    - ``runtime.mean_power`` on that capture against numpy's float64 mean:
      within 1 ulp of float32."""
    from jrc_tpu_torch import capture, runtime
    from jrc_tpu_torch.kernels.registry import recorded_calls
    from jrc_tpu_torch.models import comm_link, jrc_trx
    from jrc_tpu_torch.models.streaming import StreamingRx, frame_window_samples
    from jrc_tpu_torch.ops import coding, viterbi, viterbi_cuda
    from jrc_tpu_torch.profiling import time_ms

    counts, rows, figs = {}, {}, {"dwells": {}}
    rng = np.random.default_rng(10)
    sequences = {"entry": capture.ENTRY_DWELLS, "sounding": capture.SOUNDING_DWELLS}
    for c in ANTENNA_CONFIGS:
        name = "x".join(map(str, c))
        cfg = capture.antenna_config(*c)
        trx, trx_cpu = jrc_trx.JRCTrx(cfg), jrc_trx.JRCTrx(cfg, device="cpu")
        check(trx.device.type == "cuda", f"JRCTrx at {name} built on {trx.device}")
        draws = {seq: capture.config_draws(cfg, dwells, rng) for seq, dwells in sequences.items()}
        want = {seq: capture.config_dwells(trx_cpu, dwells, *draws[seq])
                for seq, dwells in sequences.items()}
        run_calls = {seq: [] for seq in sequences}

        def run():
            out = {}
            for seq, dwells in sequences.items():
                with recorded_calls(run_calls[seq]):
                    out[seq] = capture.config_dwells(trx, dwells, *draws[seq])
            return out

        got, counts[f"configs_{name}"] = counted(run)
        called = collections.Counter(k for calls in run_calls.values() for k, _, _ in calls)
        check(called == +collections.Counter(counts[f"configs_{name}"]),
              f"configs {name}: wrapper calls {dict(called)} != launches "
              f"{counts[f'configs_{name}']}")
        # the NDP and steered DATA dwells' calls against plain; the entry dwell's
        # shapes are held (and timed) on one more dwell below
        for k_name, args, kw in run_calls["sounding"]:
            check_kernel_call(k_name, args, kw, f"configs {name} sounding")
        n_sounding = len(run_calls["sounding"])
        del run_calls
        for seq in sequences:
            for i, (g, w) in enumerate(zip(got[seq], want[seq])):
                bad = capture.jrc_mismatches(g, w)
                check(bad == [], f"configs {name} {seq} dwell {i}: card != CPU: {bad}")
        check(bool(got["sounding"][0]["chan_valid"]) and bool(got["sounding"][1]["crc_ok"]),
              f"configs {name}: the sounding frame did not steer a clean DATA frame")
        spec, payload, targets, options = capture.dwell_args(capture.ENTRY_DWELLS[0], dev)
        calls = []
        with recorded_calls(calls):
            trx(trx.init_state(), spec, payload, targets, draws=comm_link.Draws(
                comm_noise=torch.from_numpy(draws["entry"][0][0]).to(dev)), **options)
        for k_name, row in check_recorded_kernels(calls, reps, what=f"configs {name}",
                                                  where=f"the comm leg at {name}").items():
            rows.setdefault(k_name, {})[name] = row
        figs["dwells"][name] = {seq: [dict(detected=bool(g["detected"]), range_m=float(g["range_m"]),
                                           angle_deg=float(g["angle_deg"]), crc_ok=bool(g["crc_ok"]))
                                      for g in recs] for seq, recs in got.items()}
        print(f"configs: {name} (n_tx x n_rx x n_ltf) jrc_step on the card == CPU over the entry "
              f"dwells {figs['dwells'][name]['entry']} and the sounding dwells "
              f"{figs['dwells'][name]['sounding']}; launches {counts[f'configs_{name}']}; the "
              f"sounding dwells' {n_sounding} kernel calls == plain",
              flush=True)

    # scan_rx at n_ltf 2 on a 2^20-sample capture the port encodes there
    cfg = capture.antenna_config(2, 1, 2)
    spec = capture.dwell_args(capture.ENTRY_DWELLS[0], "cpu")[0]
    frame, payload = capture.config_frame(cfg, spec, b"n_ltf 2")
    block_len, n_blocks = 2**15, 32
    cap, n_frames = capture.build_capture(
        frame, block_len * n_blocks, halo=frame_window_samples(cfg, spec) + cfg.fft_len)
    model = StreamingRx(cfg, spec, block_len, n_blocks, max_frames_per_block=12, device=dev)
    x = torch.from_numpy(cap).to(dev)
    model(x)
    res, counts[CONFIG_SCAN] = counted(lambda: model(x))
    with plain_kernels():
        res_p = model(x)
    check_same(res, res_p, ("valid", "start", "crc_ok", "payload"), "configs scan_rx at n_ltf 2")
    del res_p
    valid = res.valid.cpu().numpy()
    check(int(valid.sum()) == int(res.crc_ok.sum()) == n_frames,
          f"configs scan_rx at n_ltf 2: valid {int(valid.sum())}, crc_ok "
          f"{int(res.crc_ok.sum())}, placed {n_frames}")
    check((res.payload.cpu().numpy()[valid] == payload).all(),
          "configs scan_rx at n_ltf 2: a payload is not the encoded one")
    figs["scan_n_ltf2"] = dict(samples=len(cap), frames=n_frames, crc_ok=int(res.crc_ok.sum()),
                               ms=1e3 * wall_s(lambda: model(x), reps))
    print(f"configs: scan_rx at n_ltf 2 (2 TX, 1 RX) over {len(cap)} samples: {n_frames} of "
          f"{n_frames} frames valid and CRC-clean with the encoded payload, plain path "
          f"identical, {figs['scan_n_ltf2']['ms']:.3f} ms a run; launches {counts[CONFIG_SCAN]}",
          flush=True)

    # the chunk-parallel Viterbi (plain torch) against K1 at the static path's shape: equal
    # but where two paths cost exactly the same (jrc_tpu's chunked decoder breaks such a tie
    # the other way too), and bit for bit the port's chunked decoder on the CPU
    v = soft_values(rng, 3072, 576, dev)
    torch.cuda.reset_peak_memory_stats()
    got = viterbi.viterbi_decode_chunked(v)
    peak = torch.cuda.max_memory_allocated() / 2**30
    k1 = viterbi_cuda.viterbi_decode(v, None)
    n_cpu = 256
    check(torch.equal(got[:n_cpu].cpu(), viterbi.viterbi_decode_chunked(v[:n_cpu].cpu())),
          "viterbi_decode_chunked on the card != on the CPU")
    parted = (got != k1).any(-1)

    def cost(bits):  # −Σ v · (2c − 1) over the re-encoded path, float64
        c = coding.conv_encode(bits).to(torch.float64)
        return -(v.to(torch.float64) * (2 * c - 1)).sum(-1)

    gap = float((cost(got) - cost(k1)).abs().max())
    check(gap <= 1e-6, f"viterbi_decode_chunked on the card: a path {gap} costlier than K1's")
    figs["chunked_viterbi"] = dict(
        shape=[3072, 576], chunk_len=128, frames_tied_apart=int(parted.sum()), cost_gap=gap,
        ms=time_ms(lambda: viterbi.viterbi_decode_chunked(v), reps),
        k1_ms=time_ms(lambda: viterbi_cuda.viterbi_decode(v, None), reps), peak_gib=peak)
    print(f"configs: viterbi_decode_chunked (plain torch, L = 128) at (3072, 576), 20% erasures: "
          f"bits == K1's but in {int(parted.sum())} frames whose two paths cost the same "
          f"(largest cost gap {gap}), == the CPU's on {n_cpu} frames; "
          f"{figs['chunked_viterbi']['ms']:.4f} ms against K1's "
          f"{figs['chunked_viterbi']['k1_ms']:.4f} ms, peak {peak:.3f} GiB", flush=True)

    got = runtime.mean_power(cap)
    want = np.float32(np.mean(np.abs(cap.astype(np.complex128)) ** 2))
    check(abs(np.float32(got) - want) <= np.spacing(want),
          f"mean_power {got} vs numpy {want}")
    figs["mean_power"] = dict(samples=len(cap), value=got, numpy=float(want))
    print(f"configs: runtime.mean_power over {len(cap)} samples {got!r} == numpy's {want!r} "
          f"within 1 ulp", flush=True)
    return counts, rows, figs


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    from jrc_tpu_torch import kernels  # fails outside a checkout of the repo

    dev = torch.device("cuda:0")
    card = gpu_line()
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; {card}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    kernels.lib()
    print(f"build: {kernels.library_path()} built and loaded in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    block_len, n_blocks = 2**15, 256
    cfg, spec, model, x, n_frames, payload, frame_len = bench_setup(block_len, n_blocks, 12, dev)
    results = phase_kernels(cfg, model, x, dev, n_frames_k1=n_blocks * 12,
                            t_k1=spec.packet_params.n_data_bits, reps=20)
    k1_shapes = []  # the decoder's times at the dynamic paths' shapes
    paths = {"static": phase_main_path(model, x, n_frames, payload, frame_len, reps=5)[0]}
    paths["dynamic"] = phase_dynamic_bench(cfg, x, n_frames, payload, frame_len, dev, 5,
                                           block_len, n_blocks, k1_shapes)
    paths["mixed"] = phase_mixed(cfg, dev, 3, block_len, n_blocks, k1_shapes)
    from jrc_tpu_torch.models.streaming import left_history_samples

    xp = torch.cat([torch.zeros(left_history_samples(cfg), dtype=x.dtype, device=dev), x])
    for name, row in phase_sc16_kernels(cfg, model, xp, dev, n_blocks * 12, reps=20).items():
        results[name]["sc16"] = row
    del xp
    ingest_counts, sustained = phase_ingest(cfg, spec, model, x, n_frames, payload, dev,
                                            block_len, n_blocks)
    paths.update(ingest_counts)
    jit = phase_jit(cfg, spec, x, n_frames, payload, dev, block_len, n_blocks, reps=5)
    jit.update(phase_jit_sites(cfg, spec, model, x, dev, reps=20))
    paths.update(phase_soft_sta(cfg, spec, x, n_frames, payload, frame_len, dev, block_len,
                                n_blocks))
    paths.update(phase_soft_noise_var(cfg, spec, payload, dev, n_frames=n_blocks * 12))
    paths["profiling"], pieces = phase_pieces(dev, reps=10)
    results.update(pieces)
    results["viterbi_decode"]["shapes"] = k1_shapes
    jrc_counts, jrc_rows, jrc = phase_jrc(dev, reps=20)
    paths.update(jrc_counts)
    for name, row in jrc_rows.items():
        results[name]["jrc"] = row
    sim_counts, sim_rows, sim = phase_sim(cfg, dev, reps=5)
    paths.update(sim_counts)
    for name, row in sim_rows.items():
        results[name]["sim"] = row
    flat, flat_dyn = flat_frames(cfg, model, x, dev)
    block_counts, block = phase_block(cfg, spec, x, payload, flat, flat_dyn, dev, reps=3)
    paths.update(block_counts)
    mesh_counts, mesh = phase_mesh(cfg, spec, model, x, flat, flat_dyn, dev, reps=3)
    paths.update(mesh_counts)
    config_counts, config_rows, configs = phase_configs(dev, reps=5)
    paths.update(config_counts)
    for name, row in config_rows.items():
        results[name]["configs"] = row
    for path, runs in RUNS_OF_PATH.items():  # each run launches its path's kernels, no other
        for run in runs:
            launched = {name for name, c in paths[run].items() if c}
            check(launched == set(rx_path_kernels(path)),
                  f"the {run} run launched {sorted(launched)}, the registry's {path} path "
                  f"{sorted(rx_path_kernels(path))}")

    table = []
    for k in KERNELS:
        row = {"name": k.name, "route": "cuda", "source": k.source,
               "replaces": ", ".join(k.replaces),
               "launches": sum(c.get(k.name, 0) for c in paths.values()),
               "launches_per_path": {path: sum(paths[run].get(k.name, 0) for run in runs)
                                     for path, runs in RUNS_OF_PATH.items()},
               **results[k.name]}
        table.append(row)
        library = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms"
        if k.paths:
            per_path = " / ".join(str(paths[p].get(k.name, 0))
                                  for p in ("static", "dynamic", "mixed"))
            per_path += "; a superblock on the fc32 / sc16 / dynamic streamer " + " / ".join(
                str(paths[p].get(k.name, 0) // 2)
                for p in ("sustained_fc32", "sustained_sc16", "sustained_dynamic"))
            per_path += (f"; a radar_frame / jrc_step / apps/jrc_trx run of "
                         f"{jrc['app']['frames']} frames " + " / ".join(
                             str(paths[p].get(k.name, 0))
                             for p in ("radar_frame", "jrc_step", "jrc_app")))
            in_sweep = paths["ber_sweep"].get(k.name, 0)
            per_path += (f"; a BER-sweep point {in_sweep // sim['n_points']} ({in_sweep} over "
                         f"{sim['n_points']} points)")
            per_path += "; a windowed / sequential run static " + " / ".join(
                str(paths[p].get(k.name, 0)) for p in ("windowed", "sequential"))
            per_path += ", dynamic " + " / ".join(
                str(paths[p].get(k.name, 0)) for p in ("windowed_dynamic", "sequential_dynamic"))
            per_path += "; a sharded_rx / sharded_rx_dynamic / batched_rx run " + " / ".join(
                str(paths[p].get(k.name, 0)) for p in ("mesh_static", "mesh_dynamic", "batched_rx"))
            per_path += ("; the entry and sounding dwells at " + " / ".join(CONFIG_RUNS)
                         + " " + " / ".join(str(paths[p].get(k.name, 0)) for p in CONFIG_RUNS)
                         + f", scan_rx at n_ltf 2 {paths[CONFIG_SCAN].get(k.name, 0)}")
            alone = (f", kernel alone {row['kernel_only_ms']:.4f} ms"
                     if "kernel_only_ms" in row else "")
            print(f"summary: {k.name} {row['ms']:.4f} ms{alone}, bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']}), {100 * row['bound_ms'] / row['ms']:.1f}% of bound, "
                  f"launches per run static / dynamic / mixed {per_path}, library call {library}",
                  flush=True)
        else:  # the profiling kernels, on no path: launched by the profiling entry alone
            print(f"summary: {k.name} {row['ms']:.4f} ms wrapped, kernel alone "
                  f"{row['kernel_only_ms']:.4f} ms ({row['kernel_only_cold_ms']:.4f} cold L2), "
                  f"back to back {row['back_to_back_ms']:.4f} ms ({len(row['variants'])} variants "
                  f"summed), bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
                  f"{100 * row['bound_ms'] / row['kernel_only_cold_ms']:.1f}% of bound alone with "
                  f"a cold L2, launches per path 0 (profiling entry "
                  f"{paths['profiling'].get(k.name, 0)}), library call {library}", flush=True)
    for sh in k1_shapes:
        print(f"summary: viterbi_decode ({sh['B']}, {sh['T']}) {sh['ms']:.4f} ms ({sh['route']} "
              f"route), bound {sh['bound_ms']:.4f} ms ({sh['bound_by']}), "
              f"{100 * sh['bound_ms'] / sh['ms']:.1f}% of bound; with extents "
              f"{sh['ms_extents']:.4f} ms (longest row T), {sh['ms_extents_2160']:.4f} ms "
              f"(every row at most 2160 steps)", flush=True)
    for sel in results["detect_front_end"]["selection"]:
        print(f"summary: detect_front_end's {sel['symbol']} at {sel['what']} "
              f"({sel['max_frames']} slots over {sel['segments']} segments) "
              f"{sel['select_ms']:.4f} ms alone, K2 {sel['k2_ms']:.4f} ms, the call "
              f"{sel['call_ms']:.4f} ms, the PyTorch composition {sel['old_ms']:.4f} ms",
              flush=True)
    for k_name in ("detect_front_end", "gather_rows"):
        r = results[k_name]["sc16"]
        print(f"summary: {k_name} on the int16 stream {r['ms']:.4f} ms, kernel alone "
              f"{r['kernel_only_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"{100 * r['bound_ms'] / r['ms']:.1f}% ({100 * r['bound_ms'] / r['kernel_only_ms']:.1f}"
              f"%) of bound, two-pass route {r['library_ms']:.4f} ms", flush=True)
    for k_name, r in jrc_rows.items():
        print(f"summary: {k_name} on the JRC comm leg, {r['launches_per_step']} a jrc_step: "
              f"{r['ms']:.4f} ms wrapped, kernel alone {r['kernel_only_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms", flush=True)
    for k_name, r in sim_rows.items():
        print(f"summary: {k_name} on the BER sweep, {r['launches_per_point']} a point: "
              f"{r['ms']:.4f} ms wrapped, kernel alone {r['kernel_only_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms", flush=True)
    print("summary: launches per path " + json.dumps(
        {path: {k.name: sum(paths[run].get(k.name, 0) for run in runs) for k in KERNELS
                if k.paths} for path, runs in RUNS_OF_PATH.items()}), flush=True)
    print(json.dumps({"sustained": sustained}))
    print(json.dumps({"jit": jit}))
    print(json.dumps({"jrc": {key: jrc[key] for key in ("radar_dwell", "jrc_step", "app",
                                                         "closed_loop", "pinned", "tx_err")}}))
    print(json.dumps({"sim": sim}))
    print(json.dumps({"block": block, "mesh": mesh}))
    print(json.dumps({"configs": configs}))
    print(json.dumps({"kernels": table}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
