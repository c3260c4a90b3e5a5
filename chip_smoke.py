"""Drive the PyTorch/CUDA port's RX main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one result line each:
1. device — requires CUDA (there is no CPU path) and prints the card's
   name and power limit;
2. build — compiles the kernels of jrc_tpu_torch/kernels/csrc with nvcc
   into build/ and loads them;
3. kernels — each CUDA kernel against its plain PyTorch version on the
   card at the main path's shapes (Viterbi (3072, 576) soft values with 20%
   erasures: exact; row gather of 3072 clamped starts at widths 383 and
   1168: exact; detection front end over the whole bench capture: triggers
   exact, autocorrelation within rtol = atol = 1e-5), with median times;
4. main path — StreamingRx over the bench capture (2^15-sample blocks ×
   256, 12 frame slots per block, QPSK-3/4 64-byte frames with CFO and 25 dB
   AWGN, built from the pinned TX frame): every frame must decode with the
   pinned payload, every kernel's launch count must grow in that run, and a
   second run through the plain versions on the card must give identical
   valid/start/crc_ok/payload; samples/s of both.
Then a JSON line of per-kernel results, the card line, and the JSON status
line. Any failed check raises, and the script exits non-zero.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events, after
    one warm-up run)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


@contextlib.contextmanager
def plain_kernels():
    """Route the main path's kernel wrappers to their plain versions."""
    from jrc_tpu_torch.ops import detect_cuda, gather_cuda, viterbi, viterbi_cuda

    saved = [
        (viterbi_cuda, "viterbi_acs", viterbi.viterbi_acs_plain),
        (viterbi_cuda, "viterbi_traceback", viterbi.viterbi_traceback_plain),
        (detect_cuda, "detect_front_end", detect_cuda.detect_front_end_plain),
        (gather_cuda, "gather_rows", gather_cuda.gather_rows_plain),
    ]
    originals = [(mod, name, getattr(mod, name)) for mod, name, _ in saved]
    try:
        for mod, name, plain in saved:
            setattr(mod, name, plain)
        yield
    finally:
        for mod, name, orig in originals:
            setattr(mod, name, orig)


def launch_counts() -> dict:
    from jrc_tpu_torch.ops import detect_cuda, gather_cuda, viterbi_cuda

    return {
        "viterbi_acs": viterbi_cuda.viterbi_acs.launches,
        "viterbi_traceback": viterbi_cuda.viterbi_traceback.launches,
        "detect_front_end": detect_cuda.detect_front_end.launches,
        "gather_rows": gather_cuda.gather_rows.launches,
    }


def reset_counts() -> None:
    from jrc_tpu_torch.ops import detect_cuda, gather_cuda, viterbi_cuda

    for fn in (viterbi_cuda.viterbi_acs, viterbi_cuda.viterbi_traceback,
               detect_cuda.detect_front_end, gather_cuda.gather_rows):
        fn.launches = 0


KERNELS = {
    "viterbi_acs": ("jrc_tpu_torch/kernels/csrc/viterbi.cu", "jrc_tpu/ops/viterbi_pallas.py:95"),
    "viterbi_traceback": ("jrc_tpu_torch/kernels/csrc/viterbi.cu", "jrc_tpu/ops/viterbi_pallas.py:151"),
    "detect_front_end": ("jrc_tpu_torch/kernels/csrc/detect.cu", "jrc_tpu/ops/detect_pallas.py:89"),
    "gather_rows": ("jrc_tpu_torch/kernels/csrc/gather.cu", "jrc_tpu/ops/gather_pallas.py:32"),
}


def bench_setup(block_len: int, n_blocks: int, max_frames: int, dev):
    """(cfg, spec, model on dev, capture on dev, n_frames, payload, frame length)."""
    from jrc_tpu.config import MCS, OFDMConfig, PacketType
    from jrc_tpu_torch import capture
    from jrc_tpu_torch.models.streaming import StreamingRx
    from jrc_tpu_torch.ops.encoder import FrameSpec

    cfg = OFDMConfig()
    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=64, packet_type=PacketType.DATA)
    frame, payload, halo = capture.load_bench_frame()
    cap, n_frames = capture.build_capture(frame, block_len * n_blocks, halo=halo)
    model = StreamingRx(cfg, spec, block_len, n_blocks, max_frames_per_block=max_frames).to(dev)
    x = torch.from_numpy(cap).to(dev)
    return cfg, spec, model, x, n_frames, payload, len(frame)


def phase_kernels(cfg, model, x, dev, n_frames_k1: int, t_k1: int, reps: int) -> dict:
    """Each kernel against its plain version on ``dev`` at the main path's
    shapes; returns {name: (max_abs_err, ms, plain_ms)}."""
    from jrc_tpu_torch.models.streaming import left_history_samples
    from jrc_tpu_torch.ops import detect_cuda, gather_cuda, viterbi, viterbi_cuda

    results = {}
    trellis = model.constants().trellis
    rng = np.random.default_rng(0)
    vals = rng.normal(0, 1, (n_frames_k1, 2 * t_k1)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.2] = 0.0  # erasures
    v = torch.from_numpy(vals).to(dev)
    words_k, end_k = viterbi_cuda.viterbi_acs(v, trellis)
    words_p, end_p = viterbi.viterbi_acs_plain(v, trellis)
    check(torch.equal(words_k, words_p) and torch.equal(end_k, end_p),
          "viterbi_acs kernel != plain")
    bits_k = viterbi_cuda.viterbi_traceback(words_p, end_p)
    bits_p = viterbi.viterbi_traceback_plain(words_p, end_p)
    check(torch.equal(bits_k, bits_p), "viterbi_traceback kernel != plain")
    err_acs = max(int((words_k.long() - words_p.long()).abs().max()),
                  int((end_k.long() - end_p.long()).abs().max()))
    err_tb = int((bits_k.int() - bits_p.int()).abs().max())
    results["viterbi_acs"] = (err_acs, time_ms(lambda: viterbi_cuda.viterbi_acs(v, trellis), reps),
                              time_ms(lambda: viterbi.viterbi_acs_plain(v, trellis), 3))
    results["viterbi_traceback"] = (
        err_tb, time_ms(lambda: viterbi_cuda.viterbi_traceback(words_p, end_p), reps),
        time_ms(lambda: viterbi.viterbi_traceback_plain(words_p, end_p), 3))
    print(f"kernels: K1 ({n_frames_k1}, {t_k1}) bits exact; acs "
          f"{results['viterbi_acs'][1]:.4f} ms vs plain {results['viterbi_acs'][2]:.4f} ms; "
          f"traceback {results['viterbi_traceback'][1]:.4f} ms vs plain "
          f"{results['viterbi_traceback'][2]:.4f} ms", flush=True)

    xp = torch.cat([torch.zeros(left_history_samples(cfg), dtype=x.dtype, device=dev), x])
    n = xp.shape[0]
    starts = torch.from_numpy(rng.integers(-1000, n + 1000, n_frames_k1)).to(dev)
    n_sym = 2 + 1 + cfg.n_ltf + model.spec.n_ofdm_sym
    widths = (cfg.n_sync_words * cfg.sym_len + cfg.fft_len - 1,
              2 * cfg.fft_len + (n_sym - 2) * cfg.sym_len)
    ms, plain_ms = 0.0, 0.0
    for w in widths:
        out_k = gather_cuda.gather_rows(xp, starts, w)
        out_p = gather_cuda.gather_rows_plain(xp, starts, w)
        check(torch.equal(out_k, out_p), f"gather_rows kernel != plain at width {w}")
        ms += time_ms(lambda: gather_cuda.gather_rows(xp, starts, w), reps)
        plain_ms += time_ms(lambda: gather_cuda.gather_rows_plain(xp, starts, w), reps)
    results["gather_rows"] = (0.0, ms, plain_ms)
    print(f"kernels: K3 {n_frames_k1} rows at widths {widths} exact; "
          f"{ms:.4f} ms vs plain {plain_ms:.4f} ms (both widths)", flush=True)

    kw = dict(threshold=0.6, min_n_peaks=10, max_peak_distance=2 * cfg.sym_len,
              lag=cfg.fft_len // 4, win=cfg.fft_len // 2, pwin=int(1.5 * (cfg.fft_len // 2)))
    a_k, first_k, count_k = detect_cuda.detect_front_end(xp, **kw)
    a_p, first_p, count_p = detect_cuda.detect_front_end_plain(xp, **kw)
    check(torch.equal(first_k, first_p), "detect seg_first kernel != plain")
    check(torch.equal(count_k, count_p), "detect seg_count kernel != plain")
    ar_k, ar_p = torch.view_as_real(a_k), torch.view_as_real(a_p)
    torch.testing.assert_close(ar_k, ar_p, rtol=1e-5, atol=1e-5)
    err = float((ar_k - ar_p).abs().max())
    results["detect_front_end"] = (err, time_ms(lambda: detect_cuda.detect_front_end(xp, **kw), reps),
                                   time_ms(lambda: detect_cuda.detect_front_end_plain(xp, **kw), reps))
    print(f"kernels: K2 over {n} samples: {int(count_k.sum())} triggers, first/count exact, "
          f"max |a err| {err:.3g}; {results['detect_front_end'][1]:.4f} ms vs plain "
          f"{results['detect_front_end'][2]:.4f} ms", flush=True)
    return results


def phase_main_path(model, x, n_frames: int, payload, frame_len: int, reps: int):
    """Drive StreamingRx, check it, compare with the plain path; returns
    (launch counts of the checked run, kernel-path s, plain-path s)."""
    n_samples = model.block_len * model.n_blocks
    model(x)  # warm-up (cuFFT plans, allocator)
    torch.cuda.synchronize()
    reset_counts()
    res = model(x)
    torch.cuda.synchronize()
    counts = launch_counts()
    for name, c in counts.items():
        check(c > 0, f"kernel {name} was not launched on the main path")

    valid = res.valid.cpu().numpy()
    crc_ok = res.crc_ok.cpu().numpy()
    check(valid.sum() == crc_ok.sum() == n_frames,
          f"valid {valid.sum()} / crc_ok {crc_ok.sum()} / frames {n_frames}")
    got = res.payload.cpu().numpy()[valid]
    check((got == payload[None, :]).all(), "decoded payload differs from the pinned payload")
    # frames sit at 500 + k·(len + 2111); the trigger fires inside the STF
    true_pos = 500 + np.arange(n_frames) * (frame_len + 2111)
    starts = np.sort(res.start.cpu().numpy()[valid])
    check(((starts - true_pos >= 0) & (starts - true_pos <= 64)).all(),
          "trigger positions off the placed frames")
    snr = res.snr_db.cpu().numpy()[valid]
    check(np.isfinite(snr).all(), "non-finite SNR")

    with plain_kernels():
        res_p = model(x)
    torch.cuda.synchronize()
    for field in ("valid", "start", "crc_ok", "payload"):
        check(torch.equal(getattr(res, field), getattr(res_p, field)),
              f"kernel path and plain path differ in {field}")
    t_k = wall_s(lambda: model(x), reps)
    with plain_kernels():
        t_p = wall_s(lambda: model(x), reps)
    print(f"main path: {n_frames} frames, valid == crc_ok == {int(valid.sum())}, payloads ok, "
          f"SNR {snr.mean():.2f} dB; launches {counts}; plain path identical; "
          f"{n_samples / t_k:.6g} samples/s (kernels, {t_k * 1e3:.3f} ms) vs "
          f"{n_samples / t_p:.6g} samples/s (plain, {t_p * 1e3:.3f} ms) over {n_samples} samples",
          flush=True)
    return counts, t_k, t_p


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

    cfg, spec, model, x, n_frames, payload, frame_len = bench_setup(2**15, 256, 12, dev)
    results = phase_kernels(cfg, model, x, dev, n_frames_k1=256 * 12,
                            t_k1=spec.packet_params.n_data_bits, reps=20)
    counts, _, _ = phase_main_path(model, x, n_frames, payload, frame_len, reps=5)

    table = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": results[name][0],
         "ms": results[name][1], "plain_ms": results[name][2]}
        for name, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": table}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
