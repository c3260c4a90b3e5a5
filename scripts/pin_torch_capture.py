"""Pin the TX frames of the PyTorch port's capture functions.

The port has no TX chain yet, and the machine with the card has no jax, so
``jrc_tpu_torch.capture`` builds its captures from frames pinned here with
``jrc_tpu``:

* ``bench_frame_qpsk34_64B.npz``: the QPSK-3/4, 64-byte frame of
  ``bench.build_capture`` after ``channel.comm_channel`` with the bench
  CFO, computed by the same jitted CPU programs, plus its payload and the
  halo length ``bench.build_capture`` appends;
* ``mixed_frames.npz``: one DATA frame per MCS and one NDP frame
  (``MIXED_TRAFFIC``), each through the same channel with the bench CFO,
  with their payloads, MCS indices and SIG packet-type bits.

    python scripts/pin_torch_capture.py   # rewrites jrc_tpu_torch/data/*.npz
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "jrc_tpu_torch" / "data" / "bench_frame_qpsk34_64B.npz"
MIXED_OUT = ROOT / "jrc_tpu_torch" / "data" / "mixed_frames.npz"

#: (MCS name, payload bytes, packet type name), in capture order: the
#: payload lengths spread over the 256-byte envelope of comm_rx --dynamic
MIXED_TRAFFIC = (
    ("BPSK_1_2", 24, "DATA"),
    ("BPSK_3_4", 96, "DATA"),
    ("QPSK_1_2", 64, "DATA"),
    ("QPSK_3_4", 128, "DATA"),
    ("QAM16_1_2", 200, "DATA"),
    ("QAM16_3_4", 252, "DATA"),
    ("QPSK_1_2", 24, "NDP"),
)


def _jax_cpu():
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(ROOT))
    return jax


def tx_frame(mcs, payload_bytes: int, ptype, text: bytes, seed: int = 1,
             cfo: float | None = None):
    """(frame complex64, payload uint8): ``text`` behind the packet-type
    byte (2 = DATA, 1 = NDP), zero-padded to ``payload_bytes``, through the
    TX chain with scrambler ``seed`` and the bench channel with ``cfo``
    rad/sample (default: the bench CFO, 0.02 cycles per fft_len)."""
    jax = _jax_cpu()
    import jax.numpy as jnp
    import numpy as np

    from jrc_tpu.config import OFDMConfig, PacketType
    from jrc_tpu.models import comm_link
    from jrc_tpu.ops import channel
    from jrc_tpu.ops.encoder import FrameSpec, make_payload

    cfg = OFDMConfig()
    spec = FrameSpec(mcs, payload_bytes=payload_bytes, packet_type=ptype)
    if cfo is None:
        cfo = 0.02 * 2 * np.pi / cfg.fft_len
    type_byte = bytes([2 if ptype is PacketType.DATA else 1])
    with jax.default_device(jax.devices("cpu")[0]):
        payload = jnp.asarray(make_payload(spec, type_byte + text))
        tx_samples = jax.jit(lambda p: comm_link.tx_frame(cfg, spec, p, seed).samples)(payload)
        frame = np.asarray(
            jax.jit(
                lambda s: channel.comm_channel(
                    s, angle_deg=0.0, path_loss=5.0, noise_var=0.0, cfo=cfo
                )
            )(tx_samples)
        )
    return frame.astype(np.complex64), np.asarray(payload, np.uint8)


def pinned_frame():
    """(frame complex64, payload uint8, halo int) exactly as bench.build_capture
    makes them."""
    _jax_cpu()
    import bench
    from jrc_tpu.config import MCS, OFDMConfig, PacketType
    from jrc_tpu.models import streaming
    from jrc_tpu.ops.encoder import FrameSpec

    cfg = OFDMConfig()
    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=64, packet_type=PacketType.DATA)
    frame, payload = tx_frame(MCS.QPSK_3_4, 64, PacketType.DATA, b"bench frame")
    halo = max(
        streaming.frame_window_samples(cfg, spec),
        streaming.frame_window_samples_dynamic(cfg, bench.DYN_MAX_PAYLOAD),
    ) + cfg.fft_len
    return frame, payload, halo


def mixed_frames():
    """{name: array} of the mixed-traffic fixture: frame_i, payload_i,
    mcs (7,), packet_type_bit (7,). Each payload is a short label and
    seeded random bytes up to its length."""
    import numpy as np

    from jrc_tpu.config import MCS, PacketType

    arrays, mcs_idx, type_bits = {}, [], []
    for i, (mcs_name, n_bytes, type_name) in enumerate(MIXED_TRAFFIC):
        mcs, ptype = MCS[mcs_name], PacketType[type_name]
        text = f" {type_name} {mcs_name} {n_bytes}B ".encode()
        filler = np.random.default_rng(i).integers(0, 256, n_bytes - 1 - len(text), np.uint8)
        text += filler.tobytes()
        arrays[f"frame_{i}"], arrays[f"payload_{i}"] = tx_frame(mcs, n_bytes, ptype, text, seed=1 + i)
        mcs_idx.append(int(mcs))
        type_bits.append(ptype.sig_bit)
    arrays["mcs"] = np.asarray(mcs_idx, np.int64)
    arrays["packet_type_bit"] = np.asarray(type_bits, np.int64)
    return arrays


def main() -> int:
    import numpy as np

    frame, payload, halo = pinned_frame()
    os.makedirs(OUT.parent, exist_ok=True)
    np.savez_compressed(OUT, frame=frame, payload=payload, halo=np.int64(halo))
    print(f"wrote {OUT.relative_to(ROOT)}: frame {frame.shape} {frame.dtype}, "
          f"payload {payload.shape}, halo {halo}")
    mixed = mixed_frames()
    np.savez_compressed(MIXED_OUT, **mixed)
    print(f"wrote {MIXED_OUT.relative_to(ROOT)}: frames of "
          f"{[len(mixed[f'frame_{i}']) for i in range(len(MIXED_TRAFFIC))]} samples")
    return 0


if __name__ == "__main__":
    sys.exit(main())
