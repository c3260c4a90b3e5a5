"""Where the time of the port's RX paths and of its streaming ingest goes on
a CUDA device.

    python scripts/profile_torch_paths.py [--runs N] [--parent DIR]

Drives the paths of chip_smoke.py (StreamingRx on the bench capture,
StreamingRxDynamic at max_payload 96 on the same capture and at max_payload
256 on the mixed capture; 2^15-sample blocks x 256, 12 frame slots a block)
and, where the tree has ``jrc_tpu_torch.io.stream``, the static path with
``soft=True`` and with ``estimator="sta"`` and the two sustained
configurations (a BlockStreamer with pipeline_depth 2 and a ring of four
superblocks on the fc32 and on the sc16 wire; one run pushes two
2^23-sample superblocks of the bench capture and drains them, and every
figure is given per superblock); where it has ``jrc_tpu_torch.models.jrc_trx``,
a radar dwell (``radar_frame``) and a step of the JRC loop (``jrc_step``,
the state carried over) at the reference's operating point, with
``dwells_per_s`` (``samples`` there is the frame's length per antenna); where it has
``jrc_tpu_torch.models.evaluation``, a point of apps/ber_sweep (QPSK-3/4, 10 dB,
32 frames in one batch, with ``frames_per_s``) and a dwell of apps/radar_sim
(two targets, 3-target CLEAN, CFAR, Hann range taper, with ``dwells_per_s``);
where it has ``jrc_tpu_torch.parallel``, the windowed scan (257 blocks of
32704 samples, the capture zero-padded), the sequential scan
(``batched=False``, the first 32 blocks of 2^15) and ``sharded_rx`` over a
world of one on NCCL (the capture as one block, 2560 slots); where it has
``jrc_tpu_torch.utils.graph``, the same static, dynamic, mixed, sustained
and BER-point runs again as captured CUDA graphs (rows ``<name>_jit``: the
model call or ``link_point`` through ``graph.jit``, the streamers with
``jit=True``), beside the eager rows (the streamers with ``jit=False``);
where it has ``graph.eager``, also ``radar_dwell_jit`` and ``jrc_step_jit``
(``radar_frame`` and the ``JRCTrx`` step through ``graph.jit``, the scene as
``Targets.on``, the state carried) and ``sharded_world1_jit`` (the sharded
step as it runs on NCCL, captured inside), the row ``sharded_world1`` then
running under ``graph.eager()``.
``--parent DIR`` names a checkout of an
earlier commit (a ``git archive`` unpacked under ``build/``): each tree is
then profiled in a process of its own, in the order parent, this, this,
parent, so that both come from one card. One JSON object per path:

* ``wall_ms``: median host time of N runs, each ended by a synchronize;
* ``device_ms``, ``launches``: kernel, memcpy and memset events of a
  ``torch.profiler`` trace over 3 runs, per run (read from the exported
  trace's device events, so no kernel is counted under its operator too);
* ``idle_share``: 1 - device_ms / wall_ms;
* ``viterbi_ms``: the share of ``device_ms`` spent in the fused decoder;
* ``host_syncs``: warnings of ``torch.cuda.set_sync_debug_mode("warn")``
  over one run;
* ``peak_gib``: ``torch.cuda.max_memory_allocated`` over one run.

Then one object with the device kernels of one ``extract_frames_batch`` call
at the static path's shapes, by name: the row gather twice and no ``cos`` or
``sin`` kernel.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import inspect
import json
import re
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

BLOCK_LEN, N_BLOCKS, MAX_FRAMES = 2**15, 256, 12
WINDOWED = (32704, 257)  # block_len a multiple of 64, not of 128; the capture zero-padded
SEQUENTIAL = (2**15, 32)  # batched=False over the first 32 blocks


def paths(dev, stack: contextlib.ExitStack):
    """({name: factory}, the static model, its capture): a factory makes one
    configuration on the device and returns (run, samples a run, superblocks
    a run), so that each is built, measured and dropped in
    turn and one's staging buffers do not count in another's peak memory."""
    import torch

    from jrc_tpu_torch import capture
    from jrc_tpu_torch.config import MCS, OFDMConfig, PacketType
    from jrc_tpu_torch.models.streaming import (
        StreamingRx, StreamingRxDynamic, frame_window_samples, frame_window_samples_dynamic,
    )
    from jrc_tpu_torch.ops.encoder import FrameSpec

    cfg = OFDMConfig()
    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=64, packet_type=PacketType.DATA)
    frame, _, halo = capture.load_bench_frame()
    cap, _ = capture.build_capture(frame, BLOCK_LEN * N_BLOCKS, halo=halo)
    x = torch.from_numpy(cap).to(dev)
    mixed, _ = capture.build_mixed_capture(
        [f.samples for f in capture.load_mixed_frames()], BLOCK_LEN * N_BLOCKS,
        halo=frame_window_samples_dynamic(cfg, 256) + cfg.fft_len)
    kw = dict(max_frames_per_block=MAX_FRAMES, device=dev)
    n = BLOCK_LEN * N_BLOCKS
    static = StreamingRx(cfg, spec, BLOCK_LEN, N_BLOCKS, **kw)

    def of_model(make, capture_of=lambda: x, samples=n):
        def build():
            model, xs = make(), capture_of()
            return (lambda: model(xs)), samples, 1
        return build

    models = {  # name: (model factory, capture factory)
        "static": (lambda: static, lambda: x),
        "dynamic": (lambda: StreamingRxDynamic(cfg, BLOCK_LEN, N_BLOCKS, max_payload=96, **kw),
                    lambda: x),
        "mixed": (lambda: StreamingRxDynamic(cfg, BLOCK_LEN, N_BLOCKS, max_payload=256, **kw),
                  lambda: torch.from_numpy(mixed).to(dev)),
    }
    out = {name: of_model(*factories) for name, factories in models.items()}
    try:
        from jrc_tpu_torch.io.stream import BlockStreamer
    except ImportError:  # an earlier tree: no ingest path, no soft decisions, no STA
        return out, static, x
    out["static_soft"] = of_model(lambda: StreamingRx(cfg, spec, BLOCK_LEN, N_BLOCKS, soft=True,
                                                      **kw))
    out["static_sta"] = of_model(lambda: StreamingRx(cfg, spec, BLOCK_LEN, N_BLOCKS,
                                                     estimator="sta", **kw))

    def sustained(wire, **jit):
        streamer = BlockStreamer(cfg, spec, block_len=BLOCK_LEN, n_blocks=N_BLOCKS,
                                 max_frames=MAX_FRAMES, pipeline_depth=2, ring_capacity=4 * n,
                                 wire=wire, **jit)
        streamer.push(cap)  # fills the left history and the first halo
        list(streamer.process_available())

        def run():
            if streamer.push(cap[:n]) != n or streamer.push(cap[:n]) != n:
                raise RuntimeError(f"sustained {wire}: a push dropped samples")
            results = list(streamer.process_available())
            if len(results) != 2:
                raise RuntimeError(f"sustained {wire}: {len(results)} superblocks from two pushes")
            return results

        return run, 2 * n, 2

    # an earlier tree's streamer takes no jit= and makes every launch itself
    eager = {"jit": False} if "jit" in inspect.signature(BlockStreamer).parameters else {}
    out["sustained_fc32"] = functools.partial(sustained, "fc32", **eager)
    out["sustained_sc16"] = functools.partial(sustained, "sc16", **eager)
    try:
        from jrc_tpu_torch.models import jrc_trx, radar_chain
    except ImportError:  # an earlier tree: no TX, no radar
        return out, static, x
    out["radar_dwell"] = functools.partial(jrc_dwell, cfg, dev, jrc_trx, radar_chain, False)
    out["jrc_step"] = functools.partial(jrc_dwell, cfg, dev, jrc_trx, radar_chain, True)
    try:
        from jrc_tpu_torch.models import evaluation
    except ImportError:  # an earlier tree: no link evaluation, no radar extras
        return out, static, x
    out["ber_point"] = functools.partial(ber_point, cfg, dev, evaluation)
    out["radar_sim_dwell"] = functools.partial(radar_sim_dwell, cfg, dev)
    try:
        from jrc_tpu_torch.utils import graph
    except ImportError:  # an earlier tree: no captured graphs
        pass
    else:
        for name, (make, capture_of) in models.items():
            out[f"{name}_jit"] = of_model(lambda make=make, name=name: graph.jit(make(), name=name),
                                          capture_of)
        out["sustained_fc32_jit"] = functools.partial(sustained, "fc32", jit=True)
        out["sustained_sc16_jit"] = functools.partial(sustained, "sc16", jit=True)
        out["ber_point_jit"] = functools.partial(ber_point, cfg, dev, evaluation, graph.jit)
        if hasattr(graph, "eager"):  # a tree that captures the JRC dwell and radar dwell
            out["radar_dwell_jit"] = functools.partial(jrc_dwell, cfg, dev, jrc_trx, radar_chain,
                                                       False, graph.jit)
            out["jrc_step_jit"] = functools.partial(jrc_dwell, cfg, dev, jrc_trx, radar_chain,
                                                    True, graph.jit)
    try:
        from jrc_tpu_torch.parallel import mesh as pmesh, streaming as pstream
    except ImportError:  # an earlier tree: no per-block RX, no sharded executors
        return out, static, x
    halo = frame_window_samples(cfg, spec) + cfg.fft_len
    (w_len, w_blocks), (s_len, s_blocks) = WINDOWED, SEQUENTIAL
    padded = torch.cat([x, torch.zeros(w_len * w_blocks + halo - len(x), dtype=x.dtype,
                                       device=dev)])
    out["windowed"] = of_model(lambda: StreamingRx(cfg, spec, w_len, w_blocks, **kw),
                               lambda: padded, w_len * w_blocks)
    out["sequential"] = of_model(
        lambda: StreamingRx(cfg, spec, s_len, s_blocks, batched=False, **kw),
        lambda: x[: s_len * s_blocks + halo], s_len * s_blocks)

    held = {}

    def sharded(captured: bool):
        """sharded_rx over a world of one on NCCL: the capture as one block,
        2560 slots (the process group lives until the script ends); op by op
        under ``graph.eager`` where the tree captures the step on NCCL."""
        if not held:
            stack.enter_context(pmesh.local_group("nccl"))
            held["mesh"] = pmesh.time_mesh(1)
            held["block"] = pstream.local_block(held["mesh"], x[:n])
        eager = contextlib.nullcontext
        if not captured:
            try:
                from jrc_tpu_torch.utils.graph import eager
            except ImportError:  # an earlier tree: the step runs op by op anyway
                pass

        def run():
            with eager():
                return int(pstream.sharded_rx(cfg, spec, held["mesh"], held["block"],
                                              max_frames_per_block=2560).n_frames)

        return run, n, 1

    out["sharded_world1"] = functools.partial(sharded, False)
    if hasattr(pstream, "captures"):
        out["sharded_world1_jit"] = functools.partial(sharded, True)
    return out, static, x


def ber_point(cfg, dev, evaluation, jit=None):
    """One point of apps/ber_sweep at its defaults, as link_curve runs it:
    QPSK-3/4 64-B frames at 10 dB, 32 noise realizations decoded as one batch,
    then the point's two reads (bit errors, CRC count). ``samples`` is the
    32 bursts' length. With ``jit`` (``graph.jit``), ``link_point`` is
    captured with the noise and the variance (a 0-d tensor) its inputs, as a
    captured ``link_curve`` replays it."""
    import torch

    from jrc_tpu_torch import tables
    from jrc_tpu_torch.config import MCS, PacketType
    from jrc_tpu_torch.ops.encoder import FrameSpec, make_payload

    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=64, packet_type=PacketType.DATA)
    payload = torch.from_numpy(make_payload(spec, bytes([2]) + b"ber sweep")).to(dev)
    tab = tables.from_numpy(cfg, spec, dev)
    clean = evaluation.clean_waveform(cfg, spec, tab, payload)
    nv, z = evaluation.point_inputs(clean, 10.0, 32, 0)
    point = functools.partial(evaluation.link_point, cfg, spec, tab, payload, clean)
    if jit is not None:
        point = jit(point, name="link_point")
        nv = torch.full((), nv, dtype=torch.float32, device=dev)

    def run():
        r = point(nv, z)
        return int(r.bit_errors.sum()), int(r.crc_ok.sum())

    return run, z.numel(), 1


def radar_sim_dwell(cfg, dev):
    """One dwell of apps/radar_sim with two targets (12 m / 25°, 5 m / −20°)
    and --max-targets 3 --cfar --window-range hann: radar_frame, the 3-target
    CLEAN estimate and the range-only CFAR."""
    from jrc_tpu_torch.apps import radar_sim

    sc = radar_sim.scene(cfg, dev, [(12.0, 0.0, 25.0, 10.0), (5.0, 0.0, -20.0, 10.0)],
                         window_range="hann")

    def run():
        return radar_sim.dwell(cfg, sc, max_targets=3, cfar_pfa=1e-4)

    n = (cfg.n_sync_words + 1 + cfg.n_ltf + sc.spec.n_ofdm_sym) * cfg.sym_len
    return run, n, 1


def jrc_dwell(cfg, dev, jrc_trx, radar_chain, loop: bool, jit=None):
    """A radar dwell (``radar_frame``) or one step of the JRC loop (``jrc_step``,
    the state carried from step to step) at the reference's operating point
    (bench.py: bench_radar_jrc): a QPSK-3/4 DATA frame of 80 B, a target at
    12 m, 5 m/s, 25°, RCS 10 m², comm noise variance 1e-4. With ``jit``
    (``graph.jit``), ``radar_frame`` (its tables in the partial) or the
    module (its generator registered) is captured, the scene given as
    ``Targets.on``."""
    import torch

    from jrc_tpu_torch.config import MCS, PacketType
    from jrc_tpu_torch.ops import channel
    from jrc_tpu_torch.ops.encoder import FrameSpec, make_payload

    trx = jrc_trx.JRCTrx(cfg, device=dev)
    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=80, packet_type=PacketType.DATA)
    payload = torch.from_numpy(make_payload(spec, bytes([2]) + b"bench jrc")).to(dev)
    targets = channel.Targets((12.0,), (5.0,), (25.0,), (10.0,))
    tab, rtab = trx.tables(spec), trx.radar_tables()
    n = (cfg.n_sync_words + 1 + cfg.n_ltf + spec.n_ofdm_sym) * cfg.sym_len  # a frame's samples
    frame, step = functools.partial(radar_chain.radar_frame, cfg, spec, tab, rtab), trx
    if jit is not None:
        targets = targets.on(dev)
        frame, step = jit(frame, name="radar_frame"), jit(trx, generators=(trx.generator,))
    if not loop:
        return (lambda: frame(payload, targets)), n, 1, None
    held = {"state": trx.init_state()}

    def run():
        held["state"] = step(held["state"], spec, payload, targets, comm_noise_var=1e-4).state

    return run, n, 1


def device_totals(run, runs: int):
    """(device ms, launches, decoder ms) per run from a profiler trace."""
    from jrc_tpu_torch.profiling import device_events

    dev = device_events(run, runs)
    total = sum(e["dur"] for e in dev) / 1e3
    decoder = sum(e["dur"] for e in dev if "viterbi_decode_kernel" in e["name"]) / 1e3
    return total / runs, len(dev) / runs, decoder / runs


# PyTorch's generic launchers: the operation is the functor they are instantiated with
GENERIC = {"vectorized_elementwise_kernel", "elementwise_kernel", "unrolled_elementwise_kernel",
           "gpu_kernel_impl_nocast", "gpu_kernel_impl", "index_elementwise_kernel"}


def short_name(kernel: str) -> str:
    """A kernel's operation from its C++ name: the first two identifiers that
    name a kernel, functor, copy or sort and are not a generic launcher."""
    marks = ("kernel", "Functor", "Fun", "Memcpy", "Memset", "Sort", "copy")
    ids = [t for t in re.findall(r"[A-Za-z_]\w*", kernel)
           if t not in GENERIC and any(m in t for m in marks)]
    return "/".join(dict.fromkeys(ids[:2])) or kernel[:60]


def extraction_kernels(model, x) -> dict:
    """{kernel name: launches} of one extract_frames_batch call on 3072 random
    triggers of ``x`` at the static path's symbol count."""
    import numpy as np
    import torch

    from jrc_tpu_torch.ops import sync
    from jrc_tpu_torch.profiling import device_events

    cfg = model.cfg
    rng = np.random.default_rng(0)
    trig = torch.from_numpy(rng.integers(0, x.shape[0] - 4096, N_BLOCKS * MAX_FRAMES)).to(x.device)
    cfo = torch.from_numpy(rng.uniform(-3e-4, 3e-4, len(trig)).astype(np.float32)).to(x.device)
    n_sym = 3 + cfg.n_ltf + model.spec.n_ofdm_sym
    call = lambda: sync.extract_frames_batch(cfg, x, trig, cfo, n_sym)  # noqa: E731
    call()
    names = {}
    for e in device_events(call, 1):
        short = short_name(e["name"])
        names[short] = names.get(short, 0) + 1
    return names


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--parent", help="checkout of an earlier commit to profile in the same call")
    ap.add_argument("--tree", nargs=2, metavar=("TREE", "LABEL"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.parent:
        parent = (str(Path(args.parent).resolve()), "parent")
        this = (str(ROOT), "this")
        for tree, label in (parent, this, this, parent):
            out = subprocess.run([sys.executable, __file__, "--runs", str(args.runs),
                                  "--tree", tree, label], cwd=tree, timeout=900)
            if out.returncode:
                raise RuntimeError(f"the run of {tree} failed with code {out.returncode}")
        return 0
    tree, label = args.tree or (str(ROOT), "this")
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_paths.py needs a CUDA device")
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__, "tree": label}), flush=True)
    stack = contextlib.ExitStack()  # the sharded configuration's process group
    configurations, static_model, x = paths(dev, stack)
    for name, build in configurations.items():
        run, samples, superblocks = build()
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.runs):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0) / superblocks)
        wall = statistics.median(times)
        device_ms, launches, viterbi_ms = (t / superblocks for t in device_totals(run, 3))
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run()
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        syncs = sum("synchroniz" in str(w.message).lower() for w in caught) / superblocks
        row = {
            "tree": label, "path": name, "samples": samples // superblocks, "wall_ms": wall,
            "wall_ms_min": min(times), "wall_ms_max": max(times),
            "samples_per_s": samples / superblocks / (wall / 1e3), "device_ms": device_ms,
            "idle_share": 1 - device_ms / wall, "launches": launches, "viterbi_ms": viterbi_ms,
            "host_syncs": syncs, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        if name in ("radar_dwell", "jrc_step", "radar_sim_dwell", "radar_dwell_jit",
                    "jrc_step_jit"):
            row["dwells_per_s"] = 1e3 / wall
        if name.startswith("ber_point"):
            row["frames_per_s"] = 32e3 / wall
        print(json.dumps(row), flush=True)
        del run
    kernels = extraction_kernels(static_model, x)
    print(json.dumps({"extract_frames_batch_kernels": kernels}), flush=True)
    stack.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
