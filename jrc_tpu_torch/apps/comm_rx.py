"""Receive-only app of the PyTorch/CUDA port (counterpart of apps/comm_rx.py,
which mirrors examples/usrp/mimo_ofdm_comm_RX.grc).

Streams an IQ capture (complex64 or interleaved-int16 file, or a demo
capture) through the native ring + block RX pipeline and reports decoded
frames. It runs on the CUDA device unless ``--cpu`` is given.

    python -m jrc_tpu_torch.apps.comm_rx --iq capture.c64 --mcs QPSK_3_4 --payload-bytes 100
    python -m jrc_tpu_torch.apps.comm_rx --demo          # decode a demo capture
    python -m jrc_tpu_torch.apps.comm_rx --cpu --demo --mesh 1   # one sharded step
    torchrun --nproc-per-node 2 -m jrc_tpu_torch.apps.comm_rx --cpu --demo --mesh 2

The port has no TX chain yet, so ``--demo`` builds its capture from the
frames pinned in ``jrc_tpu_torch/data/``: the static demo from the bench
frame (QPSK-3/4, 64 bytes: the defaults of ``--mcs`` / ``--payload-bytes``),
``--demo --dynamic`` from the pinned mixed-traffic frames (one DATA frame
per MCS and their NDP sounding frame) that fit ``--max-payload``.

At exit one line of the program's counters goes to standard error
(``utils.profiling.summary``): the calls, the slots that held a frame
against the slots decoded, the captured call's replays and captures (a
capture beyond the first is a recompile), the host ms a call in the
streamer (busy: push,
dispatch and readback; blocked: waiting on a staging buffer and on the
readback), the device's idle share over the run from the event-timed
graph replays, and the median device ms of each stage of the call. ``--trace-out
DIR`` records the spans' timeline and a device-only ``torch.profiler``
trace of the 24 calls after the first, writes them merged as
DIR/trace.json (chrome://tracing or Perfetto) and prints the five longest
idle gaps of the device by the host span open when each began.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from jrc_tpu_torch import capture
from jrc_tpu_torch.apps import add_trace_argument, report_trace
from jrc_tpu_torch.config import MCS, OFDMConfig, PacketType
from jrc_tpu_torch.io.stream import BlockStreamer
from jrc_tpu_torch.ops.encoder import FrameSpec
from jrc_tpu_torch.utils import profiling

DEMO_MCS, DEMO_PAYLOAD_BYTES = "QPSK_3_4", 64  # the pinned bench frame


def demo_capture(args, parser) -> np.ndarray:
    """Noise at 1e-4 with pinned frames 3000 samples apart from sample 700
    over ``4 · block_len`` samples."""
    if args.dynamic:
        frames = [f.samples for f in capture.load_mixed_frames()
                  if len(f.payload) <= args.max_payload]
        if not frames:
            parser.error(f"--demo --dynamic: no pinned frame fits --max-payload {args.max_payload}")
    else:
        if (args.mcs, args.payload_bytes) != (DEMO_MCS, DEMO_PAYLOAD_BYTES):
            parser.error(f"--demo decodes the pinned {DEMO_MCS} {DEMO_PAYLOAD_BYTES}-byte frame; "
                         "leave --mcs and --payload-bytes at their defaults (or add --dynamic)")
        frames = [capture.load_bench_frame()[0]]
    rng = np.random.default_rng(0)
    cap = (rng.normal(0, 1e-4, (4 * args.block_len, 2))
           .view(np.complex128)[:, 0]).astype(np.complex64)
    pos, k = 700, 0
    while True:
        w = frames[k % len(frames)]
        if pos + len(w) >= len(cap) - 100:
            break
        cap[pos : pos + len(w)] += w
        pos += len(w) + 3000
        k += 1
    return cap


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--iq", help="IQ capture file (complex64, or interleaved "
                               "int16 with --iq-format sc16)")
    p.add_argument("--iq-format", choices=["fc32", "sc16"], default="fc32",
                   help="file sample format: fc32 = complex64 (the "
                        "reference's host format), sc16 = interleaved int16 "
                        "re,im (what radios record natively)")
    p.add_argument("--wire", choices=["fc32", "sc16"], default=None,
                   help="ring + host->device transfer format; sc16 halves "
                        "bytes/sample with on-device dequantization. "
                        "Default: fc32 for complex64 input, sc16 for sc16 "
                        "files (which stay quantized end-to-end; an "
                        "explicit --wire fc32 with an sc16 file is "
                        "rejected rather than silently overridden)")
    p.add_argument("--demo", action="store_true",
                   help="decode a capture built from the pinned frames of "
                        "jrc_tpu_torch/data (static: the QPSK_3_4 64-byte bench "
                        "frame; with --dynamic: the mixed-traffic frames and "
                        "their NDP frame)")
    p.add_argument("--mcs", default=DEMO_MCS)
    p.add_argument("--payload-bytes", type=int, default=DEMO_PAYLOAD_BYTES)
    p.add_argument("--dynamic", action="store_true",
                   help="SIG-driven RX: discover each frame's MCS/length/"
                        "type from its SIG field (mixed traffic)")
    p.add_argument("--max-payload", type=int, default=256,
                   help="length envelope of the dynamic path")
    p.add_argument("--block-len", type=int, default=1 << 16)
    p.add_argument("--udp-out", type=int, default=0,
                   help="forward decoded payloads to this UDP port")
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="decode the capture in one time-block sharded step over the N ranks "
                        "of the process group (torchrun's environment; N = 1 needs none)")
    p.add_argument("--chan-est-csv", default=None,
                   help="write each received NDP frame's MIMO channel "
                        "estimate here in the reference chan_est.csv format "
                        "(lib/mimo_ofdm_equalizer_impl.cc:378-416), the "
                        "sounding feedback the TX precoder consumes; "
                        "requires --dynamic (NDP is SIG-classified)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU through the kernels' plain versions")
    add_trace_argument(p)
    args = p.parse_args(argv)

    if args.dynamic and args.payload_bytes > args.max_payload:
        p.error(f"--payload-bytes {args.payload_bytes} exceeds the dynamic "
                f"path's --max-payload {args.max_payload} envelope: such "
                "frames can never decode")
    if args.chan_est_csv and not args.dynamic:
        p.error("--chan-est-csv requires --dynamic (NDP frames are "
                "classified from their SIG field)")
    cfg = OFDMConfig()
    spec = FrameSpec(MCS[args.mcs], payload_bytes=args.payload_bytes,
                     packet_type=PacketType.DATA)
    if args.demo:
        cap = demo_capture(args, p)
    elif args.iq:
        if args.iq_format == "sc16":
            cap = np.fromfile(args.iq, np.int16).reshape(-1, 2)
        else:
            cap = np.fromfile(args.iq, np.complex64)
    else:
        p.error("--iq or --demo required")

    sink = None
    if args.udp_out:
        from jrc_tpu_torch.io.udp import UdpPduSink

        sink = UdpPduSink(args.udp_out)

    if args.mesh:
        try:
            return _run_sharded(args, p, cfg, spec, cap, sink)
        finally:
            if sink is not None:
                sink.close()

    sc16_input = cap.dtype == np.int16
    if sc16_input and args.wire == "fc32":
        p.error("--wire fc32 with an sc16 capture: the sc16 path stays "
                "quantized end-to-end; convert the file first if you need "
                "the float wire")
    wire = "sc16" if sc16_input else (args.wire or "fc32")
    streamer = BlockStreamer(
        cfg, None if args.dynamic else spec, block_len=args.block_len,
        max_frames=32, max_payload=args.max_payload, wire=wire,
        device="cpu" if args.cpu else None)
    n_ndp = 0
    chunk = 1 << 15
    t0 = time.perf_counter()
    try:
        with profiling.CallTrace(args.trace_out) as tracer:
            for i in range(0, len(cap), chunk):
                part = cap[i : i + chunk]
                if sc16_input:
                    streamer.push_sc16(part)  # native int16 straight onto the wire
                else:
                    streamer.push(part)
                for res in streamer.process_available():
                    n_ndp += _report(res, sink, args.chan_est_csv)
                    tracer.called()
            for res in streamer.flush():
                n_ndp += _report(res, sink, args.chan_est_csv)
                tracer.called()
    finally:
        if sink is not None:
            sink.close()
    s = streamer.stats
    print(f"blocks={s.blocks} frames={s.frames} crc_ok={s.crc_ok} "
          f"dropped_samples={s.dropped_samples}")
    fill = f" ring_fill_max={max(s.ring_fill)}" if s.ring_fill else ""
    print(profiling.summary("rx", s.calls, time.perf_counter() - t0,
                            busy=("stream.push", "stream.dispatch", "stream.readback"),
                            blocked=("stream.slot_wait", "stream.readback"),
                            stats=s, captured=streamer.captured) + fill,
          file=sys.stderr)
    report_trace(tracer)
    if args.chan_est_csv:
        print(f"chan_est: {n_ndp} NDP sounding update(s) -> "
              f"{args.chan_est_csv}" if n_ndp else
              "chan_est: no NDP frame received; nothing written")
    return 0


def _run_sharded(args, parser, cfg, spec, cap, sink) -> int:
    """One sharded step over the whole capture, every rank of the process
    group its block; rank 0 prints the frames and the ``mesh=`` line. Every
    rank leaves the group through ``parallel.mesh.teardown``.

    Each block gets 32 frame slots a ``--block-len`` it spans, the
    streamer's 32 a block, so every N decodes the same frames. The reference
    app gives a block 32 slots whatever its length, so at ``--mesh 1`` it
    keeps 32 frames of a longer capture. The cost grows with the slots: the
    step's suppression walks 4 candidates a slot one by one, and each is a
    few kernels (a node each of the captured graph on NCCL). At 2560 slots
    the captured world-1 step held 52 361 nodes and replayed in 99.9 ms on
    an H100 (``PERF.md`` §5); a 2^23-sample file at ``--mesh 1`` and the
    default ``--block-len`` takes about 4100 slots."""
    import contextlib

    import torch.distributed as dist

    from jrc_tpu_torch.models import streaming
    from jrc_tpu_torch.parallel import mesh as pmesh
    from jrc_tpu_torch.parallel import streaming as pstream
    from jrc_tpu_torch.runtime import SC16_SCALE

    if cap.dtype == np.int16:  # sc16 file: dequantize for the sharded step
        cap = ((cap.astype(np.float32) / SC16_SCALE) @ [1, 1j]).astype(np.complex64)
    backend = "gloo" if args.cpu else "nccl"
    device = "cpu" if args.cpu else None
    pmesh.init_distributed(backend=backend)  # torchrun's environment; nothing without one
    with contextlib.ExitStack() as stack:
        if dist.is_initialized():
            stack.callback(pmesh.teardown)  # every rank, rank 0 after its report
        elif args.mesh != 1:
            parser.error(f"--mesh {args.mesh}: run under torchrun with {args.mesh} processes")
        else:
            stack.enter_context(pmesh.local_group(backend))
        n_ranks = dist.get_world_size()
        if n_ranks != args.mesh:
            parser.error(f"--mesh {args.mesh}: the process group has {n_ranks} ranks")
        mesh = pmesh.time_mesh(n_ranks, device=device)
        # pad to an equal split whose block exceeds halo + history
        if args.dynamic:
            halo = streaming.frame_window_samples_dynamic(cfg, args.max_payload) + cfg.fft_len
        else:
            halo = streaming.frame_window_samples(cfg, spec) + cfg.fft_len
        need = max(len(cap), n_ranks * 2 * (halo + cfg.fft_len))
        n = -(-need // n_ranks) * n_ranks
        cap = np.concatenate([cap, np.zeros(n - len(cap), np.complex64)])
        block = pstream.local_block(mesh, cap, device=device)
        # the streamer's 32 slots a --block-len in every rank's block: as many over the
        # capture at any N, so that no N drops a frame that another decodes
        slots = 32 * -(-block.shape[0] // args.block_len)
        if args.dynamic:
            res = pstream.sharded_rx_dynamic(cfg, mesh, block, max_frames_per_block=slots,
                                             max_payload=args.max_payload)
        else:
            res = pstream.sharded_rx(cfg, spec, mesh, block, max_frames_per_block=slots)
        if dist.get_rank():
            return 0
        n_ndp = 0
        for blk in range(n_ranks):
            # one rank's block out of every per-slot field (the last two are the totals)
            per_block = [f[blk] for f in tuple(res)[:-2]]
            n_ndp += _report(type(res)(*per_block, res.n_frames, res.n_crc_ok), sink,
                             args.chan_est_csv)
        print(f"mesh={n_ranks} frames={int(res.n_frames)} crc_ok={int(res.n_crc_ok)}")
        if args.chan_est_csv and n_ndp:
            print(f"chan_est: {n_ndp} NDP sounding update(s) -> {args.chan_est_csv}")
    return 0


def _report(res, sink, chan_est_csv=None) -> int:
    """Print per-frame lines; export the latest NDP sounding estimate when
    requested (the equalizer→precoder feedback loop the reference closes
    through chan_est.csv). Returns the number of NDP estimates written."""
    r = {f: getattr(res, f).cpu().numpy() for f in res._fields}
    valid, crc, snr, payload = r["valid"], r["crc_ok"], r["snr_db"], r["payload"]
    # dynamic results carry SIG-discovered lengths; static payloads are
    # already exact: egress must honor the pdu_len contract either way
    plen = r.get("payload_len", np.full(len(valid), payload.shape[-1]))
    n_ndp = 0
    for k in np.nonzero(valid)[0]:
        extra = f" mcs={int(r['mcs'][k])}" if "mcs" in r else ""
        is_ndp = "chan_est_ok" in r and bool(r["chan_est_ok"][k])
        if is_ndp:
            extra += " type=NDP"
        print(f"  frame @ {int(r['start'][k])}: crc={bool(crc[k])} "
              f"snr={float(snr[k]):.1f} dB{extra}")
        if sink is not None and crc[k]:
            sink.send(payload[k][: int(plen[k])])
        if chan_est_csv and is_ndp:
            from jrc_tpu_torch.utils.logging import write_chan_est_csv

            write_chan_est_csv(chan_est_csv, r["chan_est"][k])
            n_ndp += 1
    return n_ndp


if __name__ == "__main__":
    sys.exit(main())
