"""Pin a short sequence of JRC dwells of ``jrc_tpu`` for the PyTorch port.

The machine with the card has no jax, so ``chip_smoke.py`` holds the port's
``JRCTrx`` against dwells pinned here: ``jrc_tpu_torch/data/jrc_dwells.npz``
keeps, for each dwell of ``capture.JRC_DWELLS`` (run in order from the
initial state), the
random draws (comm noise, radar-stream values), the radar estimate, the peak
row and column of the range-angle map, the decoded payload, CRC and SIG
fields, SNRs, trigger, ``chan_mean`` and ``chan_est_full``, and the state
after the dwell (the reference ``JRCState``'s leaves).

    python scripts/pin_torch_jrc.py   # rewrites jrc_tpu_torch/data/jrc_dwells.npz
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from jrc_tpu_torch import capture  # noqa: E402

OUT = capture.JRC_FIXTURE

EST_FIELDS = ("range_m", "angle_deg", "power", "snr_db", "detected", "range_idx", "angle_idx")


def reference_dwells() -> dict:
    """Run ``capture.JRC_DWELLS`` through ``jrc_tpu.models.jrc_trx.jrc_step`` on the CPU
    (one jitted program per frame type and option set) → {name: array}."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from jrc_tpu.config import MCS, OFDMConfig, PacketType
    from jrc_tpu.models import jrc_trx
    from jrc_tpu.ops import channel, cplx as cx
    from jrc_tpu.ops.encoder import FrameSpec
    cfg = OFDMConfig()
    targets = channel.Targets(*((v,) for v in capture.JRC_TARGET))
    out = {}
    state = jrc_trx.init_state(cfg)
    steps = {}
    for i, (frame, seed, kw) in enumerate(capture.JRC_DWELLS):
        mcs, n_bytes, ptype, _ = frame
        payload = capture.jrc_payload(frame)
        spec = FrameSpec(MCS[mcs], payload_bytes=n_bytes, packet_type=PacketType[ptype])
        key = jax.random.PRNGKey(seed)
        tag = (spec, tuple(sorted(kw.items())))
        if tag not in steps:
            steps[tag] = jax.jit(lambda s, p, k, spec=spec, kw=kw: jrc_trx.jrc_step(
                cfg, s, spec, p, targets, key=k, comm_noise_var=capture.JRC_COMM_NOISE_VAR, **kw))
        r = steps[tag](state, jnp.asarray(payload), key)
        state = r.state
        # the draws, rebuilt from the keys in the reference's split order
        k_tx, _k_radar, k_comm = jax.random.split(key, 3)
        # the frame with jrc_step's padding of 5 and 3 symbols
        n = (cfg.n_sync_words + 1 + cfg.n_ltf + spec.n_ofdm_sym + 5 + 3) * cfg.sym_len
        noise = jax.jit(lambda k, n=n: channel.awgn(k, cx.zeros((n,)), 2.0))(k_comm)
        p = f"d{i}_"
        out[p + "payload_in"] = payload
        out[p + "comm_noise"] = (np.asarray(noise.re) + 1j * np.asarray(noise.im)).astype(
            np.complex64)
        if kw.get("use_radar_streams"):
            n_active = cfg.n_data_carriers + cfg.n_pilot_carriers
            out[p + "radar_values"] = np.asarray(jax.random.randint(
                k_tx, (cfg.n_tx - 1, spec.n_ofdm_sym, n_active), 0, 4)).astype(np.int8)
        for f in EST_FIELDS:
            out[p + f] = np.asarray(getattr(r.radar_est, f))
        ri, ai = int(r.radar_est.range_idx), int(r.radar_est.angle_idx)
        ra = np.asarray(r.ra_map.re) + 1j * np.asarray(r.ra_map.im)
        out[p + "map_row"], out[p + "map_col"] = ra[ri].astype(np.complex64), ra[:, ai].astype(
            np.complex64)
        out[p + "map_max"] = np.float32(np.abs(ra).max())
        dec, eq = r.comm.decoded, r.comm.eq
        out[p + "payload"], out[p + "crc_ok"] = np.asarray(dec.payload), np.asarray(dec.crc_ok)
        out[p + "start"] = np.asarray(r.comm.detection.start)
        for f in ("snr_legacy", "snr_data", "sig_rate_bitmap", "sig_length", "sig_ptype",
                  "sig_ok"):
            out[p + f] = np.asarray(getattr(eq, f))
        for f in ("chan_mean", "chan_est_full"):
            c = getattr(eq, f)
            out[p + f] = (np.asarray(c.re) + 1j * np.asarray(c.im)).astype(np.complex64)
        for name, leaf in zip(capture.JRC_STATE_LEAVES, jax.tree_util.tree_leaves(state)):
            out[p + "state_" + name] = np.asarray(leaf)
    return out


def main() -> int:
    import numpy as np

    arrays = reference_dwells()
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT.relative_to(ROOT)}: {len(capture.JRC_DWELLS)} dwells, {OUT.stat().st_size} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
