"""Pin the bench TX frame for the PyTorch port's capture function.

The port has no TX chain yet, and the machine with the card has no jax, so
``jrc_tpu_torch.capture`` builds the bench capture from one frame pinned
here with ``jrc_tpu``: the QPSK-3/4, 64-byte frame of ``bench.build_capture``
after ``channel.comm_channel`` with the bench CFO, computed by the same
jitted CPU programs, plus its payload and the halo length
``bench.build_capture`` appends.

    python scripts/pin_torch_capture.py   # rewrites jrc_tpu_torch/data/*.npz
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "jrc_tpu_torch" / "data" / "bench_frame_qpsk34_64B.npz"


def pinned_frame():
    """(frame complex64, payload uint8, halo int) exactly as bench.build_capture
    makes them."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(ROOT))
    import bench
    from jrc_tpu.config import MCS, OFDMConfig, PacketType
    from jrc_tpu.models import comm_link, streaming
    from jrc_tpu.ops import channel
    from jrc_tpu.ops.encoder import FrameSpec, make_payload

    cfg = OFDMConfig()
    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=64, packet_type=PacketType.DATA)
    cfo = 0.02 * 2 * np.pi / cfg.fft_len
    with jax.default_device(jax.devices("cpu")[0]):
        payload = jnp.asarray(make_payload(spec, bytes([2]) + b"bench frame"))
        tx_samples = jax.jit(lambda p: comm_link.tx_frame(cfg, spec, p, 1).samples)(payload)
        frame = np.asarray(
            jax.jit(
                lambda s: channel.comm_channel(
                    s, angle_deg=0.0, path_loss=5.0, noise_var=0.0, cfo=cfo
                )
            )(tx_samples)
        )
    halo = max(
        streaming.frame_window_samples(cfg, spec),
        streaming.frame_window_samples_dynamic(cfg, bench.DYN_MAX_PAYLOAD),
    ) + cfg.fft_len
    return frame.astype(np.complex64), np.asarray(payload, np.uint8), halo


def main() -> int:
    import numpy as np

    frame, payload, halo = pinned_frame()
    os.makedirs(OUT.parent, exist_ok=True)
    np.savez_compressed(OUT, frame=frame, payload=payload, halo=np.int64(halo))
    print(f"wrote {OUT.relative_to(ROOT)}: frame {frame.shape} {frame.dtype}, "
          f"payload {payload.shape}, halo {halo}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
