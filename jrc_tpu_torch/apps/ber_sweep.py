"""BER/PER-vs-SNR sweep over every MCS of the PyTorch/CUDA port (counterpart
of apps/ber_sweep.py): ``evaluation.link_curve`` per MCS, one batch of
``--frames`` noise realizations a point. It runs on the CUDA device unless
``--cpu`` is given.

    python -m jrc_tpu_torch.apps.ber_sweep --snrs 2 6 10 14 18 --frames 32 --plot ber.png
"""
from __future__ import annotations

import argparse
import sys

import torch

from jrc_tpu_torch import tables
from jrc_tpu_torch.config import MCS, OFDMConfig, PacketType
from jrc_tpu_torch.models import comm_link, evaluation
from jrc_tpu_torch.models.streaming import _entry_device
from jrc_tpu_torch.ops.encoder import FrameSpec, make_payload


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--snrs", nargs="+", type=float, default=[2, 6, 10, 14, 18, 22])
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--payload-bytes", type=int, default=64)
    p.add_argument("--mcs", nargs="+", default=None, help="subset of MCS names")
    p.add_argument("--soft", action="store_true")
    p.add_argument("--plot", default=None)
    p.add_argument("--csv", default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU through the kernels' plain versions")
    return p


def sweep(cfg: OFDMConfig, mcs_list, snrs, *, frames: int, payload_bytes: int, soft: bool,
          device, noise=None, jit: bool = True) -> dict:
    """``link_curve`` for each MCS, each point's line printed → {MCS name:
    [LinkPoint]}. Point i of a curve draws its noise from a generator seeded
    1000·i; ``noise(mcs, n_frames, n)``, where given, supplies an MCS's noise
    blocks (``link_curve``'s ``noise``) instead. ``jit``: as ``link_curve``
    takes it (on a card, each curve one captured graph)."""
    results = {}
    for mcs in mcs_list:
        spec = FrameSpec(mcs, payload_bytes=payload_bytes, packet_type=PacketType.DATA)
        filler = (bytes([2]) + b"ber sweep " * 6)[: spec.payload_bytes]
        payload = torch.from_numpy(make_payload(spec, filler)).to(device)
        tab = tables.from_numpy(cfg, spec, device)
        blocks = (None if noise is None
                  else noise(mcs, frames, comm_link.loopback_samples(cfg, spec)))
        pts = evaluation.link_curve(cfg, spec, tab, payload, snrs, n_frames=frames, soft=soft,
                                    noise=blocks, jit=jit)
        results[mcs.name] = pts
        for pt in pts:
            print(f"{mcs.name:11s} snr={pt.snr_db:5.1f} dB  ber={pt.ber:.2e}  per={pt.per:.3f}")
    return results


def main(argv=None, *, noise=None):
    """Run the sweep (``noise``: as ``sweep`` takes it)."""
    args = parser().parse_args(argv)
    dev = _entry_device("cpu" if args.cpu else None)
    mcs_list = [MCS[m] for m in args.mcs] if args.mcs else list(MCS)
    results = sweep(OFDMConfig(), mcs_list, args.snrs, frames=args.frames,
                    payload_bytes=args.payload_bytes, soft=args.soft, device=dev, noise=noise)

    if args.csv:
        with open(args.csv, "w") as fh:
            fh.write("mcs,snr_db,ber,per,n_frames\n")
            for name, pts in results.items():
                for pt in pts:
                    fh.write(f"{name},{pt.snr_db},{pt.ber},{pt.per},{pt.n_frames}\n")
        print(f"csv -> {args.csv}")
    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 5))
        for name, pts in results.items():
            ax.semilogy([p.snr_db for p in pts], [max(p.ber, 1e-7) for p in pts], "o-",
                        label=name)
        ax.set_xlabel("SNR (dB)")
        ax.set_ylabel("BER")
        ax.grid(True, which="both", alpha=0.3)
        ax.legend()
        fig.savefig(args.plot, dpi=120, bbox_inches="tight")
        plt.close(fig)
        print(f"plot -> {args.plot}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
