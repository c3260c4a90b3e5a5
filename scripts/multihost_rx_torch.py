#!/usr/bin/env python3
"""Multi-process streaming RX of the PyTorch port: one process a rank, the
time-block sharded executor of jrc_tpu_torch.parallel over torch.distributed
(the port's twin of scripts/multihost_rx.py).

Each process joins the process group at ``--coordinator`` (``host:port`` or
a ``file://`` store) as rank ``--process-id`` of ``--num-processes``, takes
its block of a capture that every rank builds alike from a seed, and runs
``sharded_rx`` (and with ``--dynamic`` ``sharded_rx_dynamic``): halos cross
between neighbouring ranks by point-to-point sends, the counts are
all-reduced. One device a process: ``--device cuda`` decodes on the rank's
card (LOCAL_RANK, else the rank, modulo the host's cards), ``--device cpu`` on
the CPU; ``--backend`` names the collectives' backend (NCCL moves CUDA
tensors and takes one rank a card; gloo moves CPU tensors, so two gloo
ranks may share one card).

    python scripts/multihost_rx_torch.py --coordinator 127.0.0.1:9876 \\
        --num-processes 2 --process-id 0 --device cpu --backend gloo

``--capture straddle`` (the default) is the reference script's capture, a
QPSK-1/2 16-byte frame in every rank's block, laid out for one device a
process: every frame but the last rank's crosses the boundary into the next
block, so that it decodes only through a halo sent by another process.
``--capture bench`` is the bench capture of chip_smoke.py (2^23 samples,
QPSK-3/4 64-byte frames, CFO, 25 dB AWGN; 2417 frames) zero-padded to
``num_processes · block_len`` samples. Under NCCL each step is one captured
CUDA graph (``parallel.streaming.captures``); every rank also runs it op by op
(``graph.eager``) and requires every field equal. Every rank prints
``MULTIHOST_OK rank=... n_frames=... crc_ok=... dynamic=... captured=...``;
``--out FILE`` has rank 0 write the global starts of the valid slots there
(npz). ``--bench N`` then times N batches of 16 steps and prints
``MULTIHOST_BENCH`` with the median, least and most ms a step. Every rank
leaves the group through ``parallel.mesh.teardown`` and prints
``MULTIHOST_EXIT rank=...`` after it.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def straddle_capture(cfg, n_ranks: int, block_len: int):
    """(capture complex64, spec, payload, frames) of the reference script:
    noise at 1e-4, one frame a block, straddling into the next block on every
    rank but the last."""
    import numpy as np
    import torch

    from jrc_tpu_torch import tables
    from jrc_tpu_torch.config import MCS, PacketType
    from jrc_tpu_torch.models import comm_link
    from jrc_tpu_torch.ops import channel
    from jrc_tpu_torch.ops.encoder import FrameSpec, make_payload

    spec = FrameSpec(MCS.QPSK_1_2, payload_bytes=16, packet_type=PacketType.DATA)
    payload = make_payload(spec, bytes([2]) + b"multihost")
    tx = comm_link.tx_frame(cfg, spec, tables.from_numpy(cfg, spec, "cpu"),
                            torch.from_numpy(payload), 1)
    frame = channel.comm_channel(tx.samples, angle_deg=0.0, path_loss=5.0).numpy()
    rng = np.random.default_rng(0)
    cap = (rng.normal(0, 1e-4, (n_ranks * block_len, 2)) @ [1, 1j]).astype(np.complex64)
    if block_len <= 2 * len(frame):
        raise SystemExit(f"--block-len {block_len} must exceed twice the frame ({len(frame)})")
    for d in range(n_ranks):
        if d < n_ranks - 1:
            pos = (d + 1) * block_len - len(frame) // 3  # straddles d → d+1
        else:
            pos = d * block_len + (d * 977) % (block_len - len(frame) - 8)
        cap[pos : pos + len(frame)] += frame
    return cap, spec, payload, n_ranks


def bench_capture(cfg, n_ranks: int, block_len: int):
    """(capture, spec, payload, frames): the bench capture zero-padded to
    n_ranks · block_len samples."""
    import numpy as np

    from jrc_tpu_torch import capture
    from jrc_tpu_torch.config import MCS, PacketType
    from jrc_tpu_torch.ops.encoder import FrameSpec

    n = n_ranks * block_len
    if n < 2**23:
        raise SystemExit(f"--capture bench: {n_ranks} blocks of {block_len} samples hold less "
                         "than the 2^23-sample capture")
    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=64, packet_type=PacketType.DATA)
    frame, payload, _ = capture.load_bench_frame()
    cap, n_frames = capture.build_capture(frame, 2**23)
    cap = np.concatenate([cap, np.zeros(n - len(cap), np.complex64)])
    return cap, spec, payload, n_frames


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--coordinator", required=True, help="host:port, or a file:// store")
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--block-len", type=int, default=16384)
    p.add_argument("--dynamic", action="store_true",
                   help="also run the SIG-driven dynamic executor")
    p.add_argument("--bench", type=int, default=0, metavar="BATCHES",
                   help="after the correctness pass, time the step (16 calls a batch, "
                        "medians printed per rank)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--backend", choices=["nccl", "gloo"], default="nccl")
    p.add_argument("--capture", choices=["straddle", "bench"], default="straddle")
    p.add_argument("--out", help="rank 0 writes the global starts of the valid slots here (npz)")
    args = p.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)  # one core a rank; ranks share the host
    from jrc_tpu_torch.config import OFDMConfig
    from jrc_tpu_torch.parallel import mesh as pmesh
    from jrc_tpu_torch.parallel import streaming as pstream
    from jrc_tpu_torch.utils import graph

    def same_as_eager(res, step) -> None:
        """``res`` (captured under NCCL) equal in every field to ``step``'s op by op run."""
        with graph.eager():
            ref = step()
        for f, a, b in zip(res._fields, res, ref):
            if not torch.equal(a, b):
                raise SystemExit(f"[rank {args.process_id}] {f} differs from the op-by-op step")

    pmesh.init_distributed(args.coordinator, args.num_processes, args.process_id,
                           backend=args.backend)
    try:
        world = dist.get_world_size()
        if world != args.num_processes:
            raise SystemExit(f"the process group has {world} ranks, not {args.num_processes}")
        device = None if args.device == "cuda" else "cpu"
        mesh = pmesh.time_mesh(device=device)
        cfg = OFDMConfig()
        make = bench_capture if args.capture == "bench" else straddle_capture
        cap, spec, payload, n_want = make(cfg, world, args.block_len)
        # slots a block: 4 for one frame a block; a quarter over the bench's mean otherwise
        max_frames = 4 if args.capture == "straddle" else -(-5 * n_want // (4 * world) // 8) * 8
        block = pstream.local_block(mesh, cap, device=device)
        print(f"[rank {args.process_id}] block of {block.shape[0]} samples on {block.device}, "
              f"{dist.get_backend()} over {world} ranks", flush=True)

        step = lambda: pstream.sharded_rx(cfg, spec, mesh, block,  # noqa: E731
                                          max_frames_per_block=max_frames)
        res = step()
        same_as_eager(res, step)
        n_frames, n_ok = int(res.n_frames), int(res.n_crc_ok)
        if not n_frames == n_ok == n_want:
            raise SystemExit(f"[rank {args.process_id}] frames {n_frames}, crc_ok {n_ok}, "
                             f"want {n_want}")
        good = res.payload[res.valid].cpu().numpy()
        if not (good[:, : len(payload)] == payload).all():
            raise SystemExit(f"[rank {args.process_id}] a payload differs from the sent one")
        if args.dynamic:
            step_d = lambda: pstream.sharded_rx_dynamic(  # noqa: E731
                cfg, mesh, block, max_frames_per_block=max_frames,
                max_payload=32 if args.capture == "straddle" else 96)
            res_d = step_d()
            same_as_eager(res_d, step_d)
            nf_d, ok_d = int(res_d.n_frames), int(res_d.n_crc_ok)
            if not nf_d == ok_d == n_want:
                raise SystemExit(f"[rank {args.process_id}] dynamic: frames {nf_d}, crc_ok "
                                 f"{ok_d}, want {n_want}")
        if args.out and dist.get_rank() == 0:
            np.savez(args.out, start=res.start[res.valid].cpu().numpy())
        print(f"MULTIHOST_OK rank={args.process_id} n_frames={n_frames} crc_ok={n_ok} "
              f"dynamic={bool(args.dynamic)} captured={pstream.captures(mesh, block)}", flush=True)

        if args.bench:
            import statistics
            import time

            def step():
                out = pstream.sharded_rx(cfg, spec, mesh, block, max_frames_per_block=max_frames)
                return int(out.n_frames)  # the host read ends the step

            step()
            t_b, c_b = [], []
            for _ in range(args.bench):
                t0, c0 = time.perf_counter(), time.process_time()
                for _ in range(16):
                    step()
                t_b.append((time.perf_counter() - t0) / 16)
                c_b.append((time.process_time() - c0) / 16)
            t_med, c_med = statistics.median(t_b), statistics.median(c_b)
            print(f"MULTIHOST_BENCH rank={args.process_id} t_ms={t_med * 1e3:.4f} "
                  f"t_min_ms={min(t_b) * 1e3:.4f} t_max_ms={max(t_b) * 1e3:.4f} "
                  f"cpu_ms={c_med * 1e3:.4f} samples_per_s={world * args.block_len / t_med:.0f}",
                  flush=True)
    finally:
        pmesh.teardown()
    print(f"MULTIHOST_EXIT rank={args.process_id}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
