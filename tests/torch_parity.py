"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
conversions between numpy, torch and the reference's pair form, the
reference TX frame, and the comparison of two scan_rx results."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from jrc_tpu import config as jconfig
from jrc_tpu.models import streaming as jst
from jrc_tpu.ops.encoder import FrameSpec as JSpec
from jrc_tpu_torch import config, tables
from jrc_tpu_torch.ops.encoder import FrameSpec
from scripts import pin_torch_capture

# Each package gets its own configuration objects: the enums of the two
# compare and hash equal by value, but ``isinstance`` and ``is`` do not
# cross, so the port is handed CFG and the reference JCFG.
CFG = config.OFDMConfig()
JCFG = jconfig.OFDMConfig()


def specs(mcs, payload_bytes, packet_type=jconfig.PacketType.DATA):
    """(port FrameSpec, reference FrameSpec) of a frame, each built from its
    own package's MCS and PacketType."""
    return (FrameSpec(config.MCS(int(mcs)), payload_bytes, config.PacketType(int(packet_type))),
            JSpec(jconfig.MCS(int(mcs)), payload_bytes, jconfig.PacketType(int(packet_type))))


def tab(spec):
    return tables.from_numpy(CFG, spec, "cpu")


def t(a):
    return torch.from_numpy(np.array(a))


def cplx(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def np_of(carray):
    """Reference (re, im) pair → complex numpy."""
    return np.asarray(carray.re) + 1j * np.asarray(carray.im)


def tx_frame(jspec, text, cfo=0.0):
    """(frame samples complex64, payload) from the reference TX chain and
    comm channel, as bench.build_capture makes them."""
    return pin_torch_capture.tx_frame(jspec.mcs, jspec.payload_bytes, jspec.packet_type, text,
                                      cfo=cfo)


def jax_scan_rx(jspec, cap, block_len, n_blocks, mf):
    f = jax.jit(lambda x: jst.scan_rx(JCFG, jspec, x, block_len, n_blocks,
                                      max_frames_per_block=mf))
    return f(jnp.asarray(cap))


def assert_same_rx(ours, ref, *, payload_slots="all", snr=True):
    """valid/start/crc_ok/sig_ok exactly equal, payloads exactly equal on
    ``payload_slots`` ("all" or "valid"), snr_db within 1e-3 dB on valid
    slots (``snr=False`` for noise-free captures, whose SNR is set by
    rounding alone)."""
    valid = np.asarray(ref.valid)
    for f in ("valid", "start", "crc_ok", "sig_ok"):
        np.testing.assert_array_equal(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    sel = slice(None) if payload_slots == "all" else valid
    np.testing.assert_array_equal(ours.payload.numpy()[sel], np.asarray(ref.payload)[sel])
    if snr:
        np.testing.assert_allclose(ours.snr_db.numpy()[valid], np.asarray(ref.snr_db)[valid],
                                   atol=1e-3)
