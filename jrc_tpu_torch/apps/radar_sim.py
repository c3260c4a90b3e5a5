"""Radar simulation app of the PyTorch/CUDA port (counterpart of
apps/radar_sim.py, which mirrors
examples/simulation/radar/mimo_ofdm_jrc_radar_sim.grc): N radar dwells
against a synthetic target scene, detections logged in the reference's
radar_log.csv format, the last range-angle map rendered as a heatmap;
optionally the CLEAN multi-target estimate, range-direction CA-CFAR, a
range taper, background removal and the channel-capture CSV. It runs on
the CUDA device unless ``--cpu`` is given.

    python -m jrc_tpu_torch.apps.radar_sim --targets 12:0:25:10 3.5:5:-20:10 --dwells 10
"""
from __future__ import annotations

import argparse
import sys
from typing import NamedTuple

import numpy as np
import torch

from jrc_tpu_torch import tables
from jrc_tpu_torch.config import MCS, OFDMConfig, PacketType
from jrc_tpu_torch.models import radar_chain
from jrc_tpu_torch.models.streaming import _entry_device
from jrc_tpu_torch.ops import channel, radar
from jrc_tpu_torch.ops.encoder import FrameSpec, make_payload
from jrc_tpu_torch.utils.logging import RadarLog, append_radar_capture_csv


def parse_target(s: str):
    r, v, az, rcs = (float(x) for x in s.split(":"))
    return r, v, az, rcs


#: the range-only CA-CFAR's (range, angle) guard and training half-widths
CFAR_GUARD, CFAR_TRAIN = (8, 0), (24, 0)


class Scene(NamedTuple):
    spec: FrameSpec
    payload: torch.Tensor
    tab: tables.Tables
    rtab: tables.RadarTables
    targets: channel.Targets


def scene(cfg: OFDMConfig, device, targets: list, *, mcs: str = "QPSK_1_2",
          payload_bytes: int = 50, window_range: str | None = None) -> Scene:
    """The app's NDP frame, its tables on ``device`` and the targets, each
    (range, velocity, azimuth, rcs)."""
    spec = FrameSpec(MCS[mcs], payload_bytes=payload_bytes, packet_type=PacketType.NDP)
    payload = torch.from_numpy(make_payload(spec, bytes([1]))).to(device)
    return Scene(spec, payload, tables.from_numpy(cfg, spec, device),
                 tables.radar_from_numpy(cfg, device, window_range=window_range),
                 channel.Targets(*[tuple(t[i] for t in targets) for i in range(4)]))


class Dwell(NamedTuple):
    frame: radar_chain.RadarFrameResult
    multi: radar.RangeAngleEstimate | None  # max_targets > 1
    cfar: radar.CfarResult | None  # cfar_pfa given


def dwell(cfg: OFDMConfig, sc: Scene, *, max_targets: int = 1, cfar_pfa: float | None = None,
          snr_threshold_db: float = 15.0, **frame_kwargs) -> Dwell:
    """One dwell: ``radar_frame``, then the CLEAN estimate of ``max_targets``
    (where > 1), then the range-only CA-CFAR on the map's power (where
    ``cfar_pfa`` is given)."""
    res = radar_chain.radar_frame(cfg, sc.spec, sc.tab, sc.rtab, sc.payload, sc.targets,
                                  snr_threshold_db=snr_threshold_db, **frame_kwargs)
    multi = cf = None
    if max_targets > 1:
        multi = radar.range_angle_estimate_multi(res.ra_map, sc.rtab.range_axis,
                                                 sc.rtab.angle_axis, max_targets=max_targets,
                                                 snr_threshold_db=snr_threshold_db)
    if cfar_pfa is not None:
        cf = radar.cfar_detect(res.ra_map.real ** 2 + res.ra_map.imag ** 2, guard=CFAR_GUARD,
                               train=CFAR_TRAIN, pfa=cfar_pfa)
    return Dwell(res, multi, cf)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--targets", nargs="+", default=["12:0:25:10"],
                   help="range:velocity:azimuth:rcs per target")
    p.add_argument("--dwells", type=int, default=5)
    p.add_argument("--mcs", default="QPSK_1_2")
    p.add_argument("--payload-bytes", type=int, default=50)
    p.add_argument("--noise-var", type=float, default=0.0)
    p.add_argument("--background-removal", action="store_true")
    p.add_argument("--snr-threshold", type=float, default=15.0)
    p.add_argument("--max-targets", type=int, default=1,
                   help=">1: CLEAN-style multi-target detection (subtract each peak's rank-1 "
                        "row/column outer product from the complex map, repeat)")
    p.add_argument("--window-range", choices=["hann", "hamming", "blackman"], default=None,
                   help="taper the range aperture: a lower sidelobe floor for weak targets; "
                        "default None = the reference's untapered imaging")
    p.add_argument("--cfar", action="store_true",
                   help="adaptive CA-CFAR along range per angle column: reports the detection "
                        "mask summary per dwell")
    p.add_argument("--cfar-pfa", type=float, default=1e-4)
    p.add_argument("--radar-log", default="radar_log.csv")
    p.add_argument("--capture-csv", default=None,
                   help="append each dwell's radar channel tensor in the reference CSV format")
    p.add_argument("--heatmap", default="range_angle.png")
    p.add_argument("--live", action="store_true",
                   help="timer-refreshed live heatmap (atomic PNG rewrite each refresh)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    dev = _entry_device("cpu" if args.cpu else None)
    cfg = OFDMConfig()
    sc = scene(cfg, dev, [parse_target(t) for t in args.targets], mcs=args.mcs,
               payload_bytes=args.payload_bytes, window_range=args.window_range)
    generator = torch.Generator(device=dev).manual_seed(0)  # the radar noise's (--noise-var)
    log = RadarLog(args.radar_log)
    range_axis, angle_axis = sc.rtab.range_axis.cpu().numpy(), sc.rtab.angle_axis.cpu().numpy()

    bg = radar.init_background(8, cfg.n_virtual, cfg.fft_len, device=dev) \
        if args.background_removal else None
    live = None
    if args.live and args.heatmap:
        from jrc_tpu_torch.viz.live import LiveHeatmap

        live = LiveHeatmap(range_axis, angle_axis, path=args.heatmap)
    last = None
    for d in range(args.dwells):
        res, multi, cf = dwell(cfg, sc, max_targets=args.max_targets,
                               cfar_pfa=args.cfar_pfa if args.cfar else None,
                               snr_threshold_db=args.snr_threshold, generator=generator,
                               noise_var=args.noise_var, background=bg)
        if args.background_removal:
            bg = res.background
        est = res.estimate
        det = bool(est.detected)
        print(f"dwell {d}: detected={det} range={float(est.range_m):.2f} m "
              f"angle={float(est.angle_deg):.1f} deg snr={float(est.snr_db):.1f} dB")
        if multi is not None:
            m = {f: getattr(multi, f).cpu().numpy() for f in multi._fields}
            for k in range(args.max_targets):
                if m["detected"][k]:
                    print(f"  target {k}: range={float(m['range_m'][k]):.2f} m "
                          f"angle={float(m['angle_deg'][k]):.1f} deg "
                          f"snr={float(m['snr_db'][k]):.1f} dB")
        if cf is not None:
            hit = bool(cf.detections[int(est.range_idx), int(est.angle_idx)])
            print(f"  cfar: {int(cf.n_detections)} cells above the adaptive threshold "
                  f"(pfa={args.cfar_pfa:g}); peak bin detected={hit}")
        if det:
            log.log_detection(float(est.power), float(est.snr_db), float(est.range_m),
                              float(est.angle_deg))
        if args.capture_csv:
            append_radar_capture_csv(args.capture_csv, res.chan.cpu().numpy(), cfg.n_tx, cfg.n_rx)
        if live is not None:
            live.push(lambda m=res.ra_map: (m.real ** 2 + m.imag ** 2).cpu().numpy())
            live.tick()
        last = res

    if last is not None and args.heatmap:
        from jrc_tpu_torch.viz.heatmap import render_heatmap

        rb = np.linspace(0, channel.C_LIGHT * cfg.fft_len / (2 * cfg.sample_rate), 512)
        power = (last.ra_map.real ** 2 + last.ra_map.imag ** 2).cpu().numpy()
        render_heatmap(power, rb, angle_axis, path=args.heatmap)
        print(f"heatmap -> {args.heatmap}; log -> {args.radar_log}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
