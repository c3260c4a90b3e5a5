"""Array alignment calibration of the PyTorch/CUDA port (counterpart of
apps/alignment.py, which mirrors examples/usrp/mimo_usrp_alignment_4tx2rx.grc):
a tone goes out of one TX antenna at a time through a reflector of the
synthetic scene; ``fft_peak_detect`` reads the received tone's frequency,
phase and magnitude on every RX channel, and the per-(tx, rx) phases give
the phase steps across the virtual array. It runs on the CUDA device unless
``--cpu`` is given.

    python -m jrc_tpu_torch.apps.alignment --tone-freq 1e6
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from jrc_tpu_torch.config import OFDMConfig
from jrc_tpu_torch.models.streaming import _entry_device
from jrc_tpu_torch.ops import channel, radar


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--tone-freq", type=float, default=1e6)
    p.add_argument("--n-samples", type=int, default=4096)
    p.add_argument("--target", default="5:0:10:10", help="reflector used as the calibration path")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    dev = _entry_device("cpu" if args.cpu else None)
    cfg = OFDMConfig()
    r, v, az, rcs = (float(x) for x in args.target.split(":"))
    targets = channel.Targets((r,), (v,), (az,), (rcs,))
    pos = torch.from_numpy(channel.virtual_positions(cfg.n_tx, cfg.n_rx,
                                                     channel.C_LIGHT / cfg.center_freq)).to(dev)
    n = args.n_samples
    t = np.arange(n) / cfg.sample_rate
    tone = torch.from_numpy(np.exp(2j * np.pi * args.tone_freq * t).astype(np.complex64)).to(dev)

    print(f"tone {args.tone_freq/1e6:.3f} MHz, reflector at {r} m / {az} deg")
    phases = np.zeros((cfg.n_tx, cfg.n_rx))
    for tx_i in range(cfg.n_tx):
        tx = torch.zeros((cfg.n_tx, n), dtype=torch.complex64, device=dev)
        tx[tx_i] = tone
        rx = channel.apply_targets(tx, targets, sample_rate=cfg.sample_rate,
                                   center_freq=cfg.center_freq, pos_virtual=pos)
        pk = radar.fft_peak_detect(torch.fft.fft(rx, dim=-1), cfg.sample_rate, samp_protect=2)
        freq, phase, mag = (x.cpu().numpy() for x in (pk.freq, pk.phase, pk.magnitude))
        for rx_i in range(cfg.n_rx):
            phases[tx_i, rx_i] = float(phase[rx_i])
            print(f"  tx{tx_i} -> rx{rx_i}: f={float(freq[rx_i])/1e6:.3f} MHz "
                  f"phase={np.degrees(float(phase[rx_i])):7.2f} deg "
                  f"mag={float(mag[rx_i]):.4g}")
    # per-element phase steps across the virtual array
    virt = phases.T.reshape(-1)  # rx-major ULA order
    steps = np.degrees(np.angle(np.exp(1j * np.diff(virt))))
    print("virtual-array phase steps (deg):", np.round(steps, 2))
    print("expected step for az: %.2f deg" % np.degrees(np.pi * np.sin(np.radians(az))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
