"""Communication simulation app of the PyTorch/CUDA port (counterpart of
apps/comm_sim.py, which mirrors
examples/simulation/communication/mimo_ofdm_jrc_comm_sim.grc): a closed
TX → channel → RX loop over a frame schedule with PER/SNR tracking
(``decoder.LinkStats``), the deliberate CFO, NDP channel sounding and
selectable steering, optionally fed from and delivering to UDP. It runs on
the CUDA device unless ``--cpu`` is given.

    python -m jrc_tpu_torch.apps.comm_sim --frames 20 --snr-db 22 --mcs QPSK_3_4 --steering svd
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from jrc_tpu_torch import tables
from jrc_tpu_torch.config import MCS, OFDMConfig, PacketType
from jrc_tpu_torch.models import comm_link
from jrc_tpu_torch.models.streaming import _entry_device
from jrc_tpu_torch.ops import decoder as dec_ops
from jrc_tpu_torch.ops import precoder
from jrc_tpu_torch.ops.encoder import FrameSpec, make_payload
from jrc_tpu_torch.utils.logging import CommLog


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--frames", type=int, default=10)
    p.add_argument("--mcs", default="QPSK_3_4")
    p.add_argument("--payload-bytes", type=int, default=100)
    p.add_argument("--snr-db", type=float, default=25.0)
    p.add_argument("--angle", type=float, default=15.0)
    p.add_argument("--path-loss", type=float, default=10.0)
    p.add_argument("--cfo", type=float, default=0.02,
                   help="CFO in cycles/fft_len (the grc's freq_offset)")
    p.add_argument("--steering", choices=["none", "phased", "svd"], default="none")
    p.add_argument("--ndp-every", type=int, default=5,
                   help="insert an NDP sounding frame every N frames")
    p.add_argument("--estimator", choices=["ls", "sta"], default="ls")
    p.add_argument("--soft", action="store_true", help="soft-decision Viterbi")
    p.add_argument("--udp-in", type=int, default=0, metavar="PORT",
                   help="take TX payloads from UDP datagrams on this port: first byte = packet "
                        "type (1=NDP, 2=DATA). Overrides the canned payloads and --ndp-every")
    p.add_argument("--udp-out", type=int, default=0, metavar="PORT",
                   help="forward CRC-clean decoded payloads to this UDP port")
    p.add_argument("--udp-timeout", type=float, default=10.0,
                   help="seconds to wait for the next --udp-in datagram before ending")
    p.add_argument("--comm-log", default="comm_log.csv")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU through the kernels' plain versions")
    return p


def main(argv=None, *, comm_noise=None):
    """Run a session. ``comm_noise(i, n)``, where given, supplies frame i's
    channel noise draws (standard normal pairs, (n,) complex64) instead of
    the app's generator (seeded 0)."""
    args = parser().parse_args(argv)
    dev = _entry_device("cpu" if args.cpu else None)
    cfg = OFDMConfig()
    data_spec = FrameSpec(MCS[args.mcs], payload_bytes=args.payload_bytes,
                          packet_type=PacketType.DATA)
    ndp_spec = FrameSpec(MCS.QPSK_1_2, payload_bytes=24, packet_type=PacketType.NDP)
    payload = torch.from_numpy(make_payload(data_spec, bytes([2]) + b"comm sim payload")).to(dev)
    ndp_payload = torch.from_numpy(make_payload(ndp_spec, bytes([1]))).to(dev)
    cfo = args.cfo * 2 * np.pi / cfg.fft_len
    generator = torch.Generator(device=dev).manual_seed(0)
    tabs: dict = {}
    log = CommLog(args.comm_log)
    stats = dec_ops.init_stats(device=dev)
    mean_steering = None
    seed = 1

    udp_src = udp_sink = None
    if args.udp_in:
        from jrc_tpu_torch.io.udp import UdpPduSource

        udp_src = UdpPduSource(args.udp_in)
        print(f"udp-in: listening on {udp_src.addr[0]}:{udp_src.addr[1]}")
    if args.udp_out:
        from jrc_tpu_torch.io.udp import UdpPduSink

        udp_sink = UdpPduSink(args.udp_out)
    try:
        for i in range(args.frames):
            if udp_src is not None:
                # until a valid datagram, so that drops do not use up --frames
                while True:
                    pdu = udp_src.get(timeout=args.udp_timeout)
                    if pdu is None or 1 <= len(pdu) <= cfg.max_payload:
                        break
                    print(f"udp-in: dropping {len(pdu)}-byte datagram")
                if pdu is None:
                    print("udp-in: idle timeout, ending session")
                    break
                is_ndp = int(pdu[0]) == 1 and args.steering != "none"
                spec = FrameSpec(MCS.QPSK_1_2 if int(pdu[0]) == 1 else MCS[args.mcs],
                                 payload_bytes=len(pdu),
                                 packet_type=PacketType.NDP if int(pdu[0]) == 1
                                 else PacketType.DATA)
                pl = torch.from_numpy(make_payload(spec, bytes(pdu))).to(dev)
            else:
                is_ndp = (args.ndp_every > 0 and i % args.ndp_every == args.ndp_every - 1
                          and args.steering != "none")
                spec = ndp_spec if is_ndp else data_spec
                pl = ndp_payload if is_ndp else payload
            if spec not in tabs:
                tabs[spec] = tables.from_numpy(cfg, spec, dev)
            tab = tabs[spec]
            noise = None
            if comm_noise is not None:
                noise = comm_noise(i, comm_link.loopback_samples(cfg, spec)).to(dev)
            res = comm_link.loopback(
                cfg, spec, tab, pl, noise=noise, generator=generator, angle_deg=args.angle,
                path_loss=args.path_loss, snr_db=args.snr_db, cfo=cfo, scrambler_seed=seed,
                estimator=args.estimator, soft=args.soft,
                mean_steering=None if is_ndp else mean_steering)
            seed = seed % 127 + 1
            crc = bool(res.decoded.crc_ok)
            snr, snr_d = float(res.eq.snr_legacy), float(res.eq.snr_data)
            if is_ndp and bool(res.eq.sig_ok) and args.steering != "none":
                _, mean_steering = precoder.steering_from_chan_est(
                    cfg, tab, res.eq.chan_est_full, phased=args.steering == "phased")
                print(f"frame {i}: NDP sounding -> steering refreshed ({args.steering})")
                continue
            stats = dec_ops.update_stats(stats, res.decoded.crc_ok)
            per = float(dec_ops.per_percent(stats))
            log.log_frame(crc, int(spec.packet_type), snr, snr_d, per)
            if udp_sink is not None and crc:
                udp_sink.send(res.decoded.payload.cpu().numpy())
            print(f"frame {i}: crc={crc} snr={snr:.1f} dB snr_data={snr_d:.1f} dB per={per:.1f}%")
        print(f"log -> {args.comm_log}")
    finally:
        if udp_src is not None:
            udp_src.close()
        if udp_sink is not None:
            udp_sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
