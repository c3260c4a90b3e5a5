"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
the thread count of every port test process and of the processes it
starts, conversions between numpy, torch and the reference's pair form, the
reference TX frame, the comparison of two scan_rx results, and the
reference's slow pieces under jax.jit for the app twins.

Every port test file imports from here, so each pytest process that
collects one runs the port on ``THREADS`` intra-op threads for its whole
session, whatever file it runs (tests/test_torch_package.py holds the files
to it)."""
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

#: intra-op threads of each test process and of each child it starts: the
#: suite's xdist workers share the host's cores, and there torch's pool,
#: spinning on the plain versions' many small operations, runs them many
#: times slower than one thread does (set once, at import; the inter-op
#: pool is left alone, as setting it raises once work has started)
THREADS = 1
torch.set_num_threads(THREADS)
#: what a test adds to the environment of a process it starts
CHILD_ENV = {"OMP_NUM_THREADS": str(THREADS)}
#: the names that set a thread count, which no other port test file spells
SETTERS = ("set_num_threads", *CHILD_ENV)

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


#: compile options under which a jitted function's floats equal eager
#: op-by-op dispatch: with fusion and the algebraic simplifier off, XLA
#: computes each primitive on its own and rounds it to float32, in the eager
#: order (checked bit for bit against eager dispatch on alignment's tone
#: echo and on radar_frame with radar_sim's two targets and with one target
#: at 150 m/s; fused instead, the echo's phase moves the map by 4e-5 · max)
EAGER_EQUAL = {"xla_disable_hlo_passes": "fusion,algsimp"}


def jit_reference(monkeypatch) -> None:
    """The reference's TX frame, comm channel, AWGN, RX chain, steering from
    a channel estimate, the JRC legs, the radar imaging and the radar
    extras under jax.jit (bits, triggers and indices unchanged; floats
    within each test's tolerances), and its echo ``apply_targets`` under
    jax.jit with ``EAGER_EQUAL`` (bit for bit its eager result): the same
    functions, compiled once each instead of primitive by primitive."""
    from jrc_tpu.models import comm_link, jrc_trx
    from jrc_tpu.ops import channel, ofdm, precoder, radar

    for mod, name, kw in (
            (comm_link, "tx_frame", dict(static_argnums=(0, 1), static_argnames=(
                "use_radar_streams", "pad_front", "pad_tail"))),
            (comm_link, "rx_chain", dict(static_argnums=(0, 1),
                                         static_argnames=("estimator", "soft"))),
            (channel, "comm_channel", dict(static_argnames=(
                "angle_deg", "path_loss", "noise_var", "cfo"))),
            (channel, "awgn", {}),
            (channel, "apply_targets", dict(
                static_argnums=(1,), static_argnames=("sample_rate", "center_freq",
                                                      "self_coupling_db"),
                compiler_options=EAGER_EQUAL)),
            (precoder, "steering_from_chan_est", dict(static_argnums=(0,),
                                                      static_argnames=("phased",))),
            (jrc_trx, "jrc_tx", dict(static_argnums=(0, 2), static_argnames=(
                "radar_aided", "phased_steering", "use_radar_streams", "pad_front"))),
            (jrc_trx, "jrc_radar_rx", dict(static_argnums=(0,))),
            (jrc_trx, "radar_state_update", {}),
            (radar, "fft_peak_detect", dict(static_argnums=(1,),
                                            static_argnames=("samp_protect",))),
            (radar, "radar_channel_estimate", dict(static_argnames=("tx_interleave",))),
            (radar, "range_angle_map", dict(static_argnames=(
                "interp_factor_range", "interp_factor_angle", "window_range", "window_angle"))),
            (radar, "range_angle_estimate", {}),
            (ofdm, "ofdm_demodulate", dict(static_argnums=(0, 2))),
            (radar, "range_doppler_map", {}),
            (radar, "range_doppler_estimate", {})):
        monkeypatch.setattr(mod, name, jax.jit(getattr(mod, name), **kw))


def awgn_draws(keys, n: int) -> np.ndarray:
    """(len(keys), n) complex64 standard normal pairs, drawn as the
    reference's jitted, vmapped link loop draws its noise (``channel.awgn``
    of zeros at total variance 2)."""
    from jrc_tpu.ops import channel, cplx as cx

    draw = jax.jit(jax.vmap(lambda k: channel.awgn(k, cx.zeros((n,)), 2.0)))(keys)
    return np_of(draw).astype(np.complex64)
