"""Full JRC transceiver session of the PyTorch/CUDA port (counterpart of
apps/jrc_trx.py, which mirrors examples/usrp/mimo_ofdm_jrc_TRX.grc), with
the simulated radio, driven through the TRX boundary at the reference
cadence: frames go out continuously, a TX+RX radar burst opens at most once
per ``--update-period`` (25 Hz at 0.04 s) and frames in between go out
TX-only. The burst's capture is re-aligned by ``--num-delay-samps``. The
comm leg models the remote receiver hearing every frame. With
``--doppler-frames N`` a burst becomes a train of N back-to-back frames
(phase-coherent through the simulated radio's stream clock) whose radar
channel estimates give a range-Doppler velocity estimate; ``--live``
rewrites a heatmap and a link-metric plot on a timer. It runs on the CUDA
device unless ``--cpu`` is given.

    python -m jrc_tpu_torch.apps.jrc_trx --frames 32 --target 12:0:25:10

At exit one line of the program's counters goes to standard error
(``utils.profiling.summary``): the frames, the host ms a frame (busy:
launching the frame's work; blocked: reading its results back), the
device's idle share over the session from each frame's event-timed device
span (on a card), and the median device ms of the frame's stages (``tx``,
``channel``: the radar burst and the comm channel, ``radar``, ``comm_rx``).
``--trace-out DIR`` writes the spans merged into a device-only profiler
trace of the 24 frames after the first and prints the longest
idle gaps of the device by host span.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from jrc_tpu_torch.apps import add_trace_argument, report_trace
from jrc_tpu_torch.config import MCS, OFDMConfig, PacketType
from jrc_tpu_torch.io.backend import SimTrx, TrxSession
from jrc_tpu_torch.models import comm_link, jrc_trx
from jrc_tpu_torch.ops import channel, ofdm, radar
from jrc_tpu_torch.ops.encoder import FrameSpec, make_payload
from jrc_tpu_torch.utils import graph, profiling
from jrc_tpu_torch.utils.logging import CommLog, RadarLog


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--frames", type=int, default=32,
                   help="total frames transmitted (bursts open at 1/update-period)")
    p.add_argument("--target", default="12:0:25:10", help="range:velocity:azimuth:rcs")
    p.add_argument("--mcs", default="QPSK_3_4")
    p.add_argument("--payload-bytes", type=int, default=80)
    p.add_argument("--radar-aided", action="store_true", default=True)
    p.add_argument("--no-radar-aided", dest="radar_aided", action="store_false")
    p.add_argument("--phased", action="store_true", default=True)
    p.add_argument("--svd", dest="phased", action="store_false")
    p.add_argument("--radar-streams", action="store_true")
    p.add_argument("--ndp-every", type=int, default=8,
                   help="every Nth frame is an NDP sounding frame (0 = never)")
    p.add_argument("--comm-noise-var", type=float, default=1e-4)
    p.add_argument("--update-period", type=float, default=0.04,
                   help="dwell burst period in seconds (reference: 0.04)")
    p.add_argument("--frame-interval", type=float, default=0.01,
                   help="seconds between produced frames")
    p.add_argument("--num-delay-samps", type=int, default=24,
                   help="TX->RX latency compensation (usrp_mimo_trx contract)")
    p.add_argument("--doppler-frames", type=int, default=0,
                   help="send this many back-to-back frames per dwell burst and estimate the "
                        "target velocity from the slow-time Doppler across them (0 = off)")
    p.add_argument("--udp-in", type=int, default=0, metavar="PORT",
                   help="take TX payloads from UDP datagrams on this port: first byte = "
                        "packet type (1=NDP, 2=DATA). Overrides the canned payloads and "
                        "--ndp-every")
    p.add_argument("--udp-out", type=int, default=0, metavar="PORT",
                   help="forward each CRC-clean decoded payload to this UDP port")
    p.add_argument("--udp-timeout", type=float, default=10.0,
                   help="seconds to wait for the next --udp-in datagram before ending")
    p.add_argument("--radar-log", default="radar_log.csv")
    p.add_argument("--comm-log", default="comm_log.csv")
    p.add_argument("--heatmap", default="jrc_range_angle.png",
                   help="PNG of the last range-angle map ('' = none; needs matplotlib)")
    p.add_argument("--live", action="store_true",
                   help="timer-refreshed live heatmap + link-metric scatter (atomic PNG rewrites)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the generator the comm noise and radar streams come from")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU through the kernels' plain versions")
    add_trace_argument(p)
    return p


def ltf_estimate(cfg: OFDMConfig, n_sym: int, x_sl: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The radar channel estimate of one burst ``r`` (n_rx, n_samples) against
    its frame's precoded MIMO-LTF rows ``x_sl`` (n_tx, n_ltf, fft_len)."""
    sl = slice(cfg.n_sync_words + 1, cfg.n_sync_words + 1 + cfg.n_ltf)
    return radar.radar_channel_estimate(x_sl, ofdm.ofdm_demodulate(cfg, r, n_sym)[:, sl])


def doppler_train(cfg: OFDMConfig, session: TrxSession, tx, rx: torch.Tensor, rtab,
                  pad_front: int, d0: int, n_frames: int, estimate=ltf_estimate) -> None:
    """The frame train of one burst: ``n_frames`` − 1 more back-to-back bursts
    of the same frame (phase-coherent through the backend's stream clock),
    the radar channel estimate of each (``estimate``, ``ltf_estimate`` or its
    captured form, given this frame's LTF grid), then the range-Doppler
    velocity estimate across the train, printed with the MTI blind-zone
    note. A missed burst ends the train (a gap breaks slow-time coherence)."""
    sl = slice(cfg.n_sync_words + 1, cfg.n_sync_words + 1 + cfg.n_ltf)
    x_sl = tx.grid.transpose(0, 1)[:, sl]
    n_sym = tx.grid.shape[0]
    hist = [estimate(cfg, n_sym, x_sl, rx)]
    n_want = tx.samples.shape[-1]
    for _ in range(n_frames - 1):
        b2 = session.backend.burst(tx.samples, n_want + d0)
        if b2 is None:
            print("  doppler train aborted: RX deadline miss")
            break
        hist.append(estimate(cfg, n_sym, x_sl, b2.rx[..., d0 : d0 + n_want][..., pad_front:]))
    v_axis = radar.velocity_axis(len(hist), n_want / cfg.sample_rate, cfg.center_freq)
    vest = radar.range_doppler_estimate(radar.range_doppler_map(torch.stack(hist)),
                                        rtab.range_axis, torch.from_numpy(v_axis).to(rx.device))
    if bool(vest.detected):
        v, blind = float(vest.velocity_mps), float(vest.blind_zone_mps)
        note = ""
        if abs(v) <= blind + 0.5 * float(v_axis[1] - v_axis[0]):
            note = (f"  [at MTI blind-zone edge (|v| < {blind:.1f} m/s unresolved) — lengthen "
                    f"--doppler-frames]")
        print(f"  doppler train ({len(hist)} frames): v={v:+.1f} m/s @ "
              f"{float(vest.range_m):.2f} m" + note)


def main(argv=None, *, comm_noise=None):
    """Run a session. ``comm_noise(d, n)``, where given, supplies frame d's
    comm-leg noise draws (standard normal pairs, (n,) complex64) instead of
    the session's generator."""
    args = parser().parse_args(argv)

    cfg = OFDMConfig()
    trx = jrc_trx.JRCTrx(cfg, seed=args.seed, device="cpu" if args.cpu else None)
    dev = trx.device
    r, v, az, rcs = (float(x) for x in args.target.split(":"))
    targets = channel.Targets((r,), (v,), (az,), (rcs,))
    data_spec = FrameSpec(MCS[args.mcs], payload_bytes=args.payload_bytes,
                          packet_type=PacketType.DATA)
    ndp_spec = FrameSpec(MCS.QPSK_1_2, payload_bytes=24, packet_type=PacketType.NDP)
    data_payload = torch.from_numpy(make_payload(data_spec, bytes([2]) + b"jrc data")).to(dev)
    ndp_payload = torch.from_numpy(make_payload(ndp_spec, bytes([1]))).to(dev)

    udp_src = udp_sink = None
    if args.udp_in:
        from jrc_tpu_torch.io.udp import UdpPduSource

        udp_src = UdpPduSource(args.udp_in)
        print(f"udp-in: listening on {udp_src.addr[0]}:{udp_src.addr[1]}")
    if args.udp_out:
        from jrc_tpu_torch.io.udp import UdpPduSink

        udp_sink = UdpPduSink(args.udp_out)

    def next_frame(d):
        """(spec, payload, is_ndp) of frame d: from the UDP ingress (one frame
        a datagram, its type byte honored, its exact length), else the
        canned schedule."""
        if udp_src is None:
            is_ndp = args.ndp_every > 0 and d % args.ndp_every == args.ndp_every - 1
            return (ndp_spec, ndp_payload, True) if is_ndp else (data_spec, data_payload, False)
        while True:
            pdu = udp_src.get(timeout=args.udp_timeout)
            if pdu is None:
                return None  # idle timeout: the packet generator stopped
            if 1 <= len(pdu) <= cfg.max_payload:
                break
            print(f"udp-in: dropping {len(pdu)}-byte datagram (valid: 1..{cfg.max_payload})")
        is_ndp = int(pdu[0]) == 1
        spec = FrameSpec(MCS.QPSK_1_2 if is_ndp else MCS[args.mcs], payload_bytes=len(pdu),
                         packet_type=PacketType.NDP if is_ndp else PacketType.DATA)
        return spec, torch.from_numpy(make_payload(spec, bytes(pdu))).to(dev), is_ndp

    session = TrxSession(SimTrx(cfg, targets, hw_delay_samps=args.num_delay_samps, device=dev),
                         update_period=args.update_period, num_delay_samps=args.num_delay_samps)
    pad_front = 5 * cfg.sym_len
    # the train's estimate, captured once per geometry (cfg, n_sym; the bursts' shape) like the
    # reference's h_of_cache; the frame's LTF grid is an input, so each train reads its own
    h_of = graph.jit(ltf_estimate, name="doppler_train estimate")
    rtab = trx.radar_tables()
    state = trx.init_state()
    rlog, clog = RadarLog(args.radar_log), CommLog(args.comm_log)
    range_axis, angle_axis = rtab.range_axis.cpu().numpy(), rtab.angle_axis.cpu().numpy()
    live_hm = live_tp = None
    if args.live:
        from jrc_tpu_torch.viz.live import LiveHeatmap, LiveTimePlot

        if args.heatmap:
            live_hm = LiveHeatmap(range_axis, angle_axis, path=args.heatmap)
        live_tp = LiveTimePlot(path="jrc_metrics.png")
    last_map = None
    n_ok = n_data = 0
    now = 0.0
    clock = profiling.DeviceClock("dwell") if dev.type == "cuda" else None
    frames_done, t0 = 0, time.perf_counter()
    try:
        with profiling.CallTrace(args.trace_out) as tracer:
            for d in range(args.frames):
                nxt = next_frame(d)
                if nxt is None:
                    print("udp-in: idle timeout, ending session")
                    break
                spec, pl, is_ndp = nxt
                tab = trx.tables(spec)
                with profiling.span("jrc.frame", d):
                    timed = clock.start() if clock is not None else None
                    profiling.stamp("dwell", "start", pl)
                    tx = jrc_trx.jrc_tx(cfg, tab, state, spec, pl, generator=trx.generator,
                                        radar_aided=args.radar_aided,
                                        phased_steering=args.phased,
                                        use_radar_streams=args.radar_streams,
                                        pad_front=pad_front)
                    profiling.stamp("dwell", "tx", pl)

                    # radar leg through the TRX boundary: a burst at most every
                    # update_period, TX-only otherwise
                    t_frame = now
                    burst = session.frame(tx.samples, now)
                    now += args.frame_interval
                    # comm leg: the remote comm RX hears every frame over the air
                    rx_wave = channel.comm_channel(tx.samples, angle_deg=az, path_loss=20.0)
                    n = rx_wave.shape[-1]
                    noise = (comm_noise(d, n).to(dev) if comm_noise is not None else
                             channel.normal_pair((n,), generator=trx.generator, device=dev))
                    rx_wave = channel.awgn(rx_wave, args.comm_noise_var, noise=noise)
                    profiling.stamp("dwell", "channel", pl)
                    est = None
                    if burst is not None:
                        rx = burst.rx[..., pad_front:]
                        est, ra_map, background = jrc_trx.jrc_radar_rx(cfg, rtab, state,
                                                                       tx.grid, rx)
                        if args.doppler_frames > 1:
                            doppler_train(cfg, session, tx, rx, rtab, pad_front,
                                          args.num_delay_samps, args.doppler_frames, h_of)
                        state = jrc_trx.radar_state_update(state, est, background)
                        last_map = ra_map
                    profiling.stamp("dwell", "radar", pl)
                    comm = comm_link.rx_chain(cfg, spec, tab, comm_link.guard(cfg, rx_wave))
                    profiling.stamp("dwell", "comm_rx", pl)
                    if clock is not None:
                        clock.stop(timed, d)
                with profiling.span("jrc.readback", d):
                    if est is not None:
                        if live_hm is not None:  # drawn frames only pay the copy to the host
                            live_hm.push(
                                lambda m=ra_map: (m.real ** 2 + m.imag ** 2).cpu().numpy())
                            live_hm.tick()
                        if bool(est.detected):
                            rlog.log_detection(float(est.power), float(est.snr_db),
                                               float(est.range_m), float(est.angle_deg))
                    crc = bool(comm.decoded.crc_ok)
                    if udp_sink is not None and crc:
                        udp_sink.send(comm.decoded.payload.cpu().numpy())
                    if is_ndp and bool(comm.eq.sig_ok):
                        # NDP sounding feedback (chan_est.csv -> precoder in the reference)
                        state = state._replace(chan_est=comm.eq.chan_est_full,
                                               chan_valid=torch.ones((), dtype=torch.bool,
                                                                     device=dev))
                    if not is_ndp:
                        n_data += 1
                        n_ok += crc
                    per = 100.0 * (1 - n_ok / max(n_data, 1))
                    clog.log_frame(crc, int(spec.packet_type), float(comm.eq.snr_legacy),
                                   float(comm.eq.snr_data), per)
                    if live_tp is not None:
                        live_tp.push("snr_db", t_frame, float(comm.eq.snr_legacy))
                        live_tp.push("per_%", t_frame, per)
                        live_tp.tick()
                    kind = "NDP " if is_ndp else "DATA"
                    msg = (f"frame {d} [{kind}] {'BURST' if burst is not None else 'tx-only'}: "
                           f"crc={crc}")
                    if est is not None:
                        msg += (f" radar det={bool(est.detected)} range={float(est.range_m):.2f} "
                                f"angle={float(est.angle_deg):.1f}")
                    print(msg + f" steer_angle={float(state.radar_angle):.1f}")
                tracer.called()
                frames_done += 1
        if last_map is not None and args.heatmap:
            from jrc_tpu_torch.viz.heatmap import render_heatmap

            power = (last_map.real ** 2 + last_map.imag ** 2).cpu().numpy()
            render_heatmap(power, range_axis, angle_axis, path=args.heatmap)
        print(f"bursts={session.n_bursts} tx_only={session.n_tx_only} "
              f"missed={session.n_missed}; "
              f"PER: {100.0 * (1 - n_ok / max(n_data, 1)):.1f}% over {n_data} DATA frames")
        if clock is not None:
            torch.cuda.synchronize()
            clock.harvest()
        print(profiling.summary("dwell", frames_done, time.perf_counter() - t0,
                                busy=("jrc.frame",), blocked=("jrc.readback",)),
              file=sys.stderr)
        report_trace(tracer)
    finally:
        if udp_src is not None:
            udp_src.close()
        if udp_sink is not None:
            udp_sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
