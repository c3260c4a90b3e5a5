"""The PyTorch port's package boundary: no jax, same frame geometry, same
constant tables as jrc_tpu, and no silent fallback off the card."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jrc_tpu.config import MCS, OFDMConfig, PacketType  # noqa: E402
from jrc_tpu.ops import (  # noqa: E402
    coding as jcoding, modulation as jmod, precoder as jprecoder, viterbi as jvit,
)
from jrc_tpu.ops.encoder import FrameSpec as JSpec, make_payload as j_make_payload  # noqa: E402
from jrc_tpu_torch import kernels, tables  # noqa: E402
from jrc_tpu_torch.kernels import registry  # noqa: E402
from jrc_tpu_torch.ops import (  # noqa: E402
    detect_cuda, gather_cuda, gather_pieces, precoder, shuffle_pieces, viterbi, viterbi_cuda,
    viterbi_pieces,
)
from jrc_tpu_torch.ops.encoder import FrameSpec, make_payload  # noqa: E402

CFG = OFDMConfig()
ROOT = Path(__file__).resolve().parents[1]

IMPORT_ALL = """
import importlib, pkgutil, sys
import jrc_tpu_torch
for m in pkgutil.walk_packages(jrc_tpu_torch.__path__, "jrc_tpu_torch."):
    importlib.import_module(m.name)
print(len(sys.modules), "jax" in sys.modules, any(k.startswith("jax.") for k in sys.modules))
"""


def test_import_never_loads_jax():
    # a subprocess: the test workers themselves import jax via conftest
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], capture_output=True,
                         text=True, check=True, timeout=120).stdout.split()
    assert out[1:] == ["False", "False"], out


@pytest.mark.parametrize("mcs", list(MCS))
def test_frame_spec_matches(mcs):
    ours = FrameSpec(mcs, payload_bytes=77, packet_type=PacketType.DATA)
    ref = JSpec(mcs, payload_bytes=77, packet_type=PacketType.DATA)
    assert ours.packet_params == ref.packet_params
    assert ours.mcs_params == ref.mcs_params
    assert ours.n_ofdm_sym == ref.n_ofdm_sym
    assert ours.data_size_byte == ref.data_size_byte
    np.testing.assert_array_equal(make_payload(ours, b"\x02abc"), j_make_payload(ref, b"\x02abc"))
    assert precoder.SIG_RATE_TO_MCS == jprecoder.SIG_RATE_TO_MCS


def _reference_tables(spec):
    prev, sa, sb = jvit._trellis()
    _, phase, state_at = jcoding._scrambler_tables()
    crc_T, crc_E = jcoding._crc32_linear_tables(spec.data_size_byte)
    return dict(
        data_idx=CFG.data_carrier_idx, pilot_idx=CFG.pilot_carrier_idx,
        active_idx=CFG.active_carrier_idx, lltf_freq=CFG.lltf_freq,
        pilot_symbols=CFG.pilot_symbols,
        ltf0_conj=np.conj(CFG.ltf_mapped_sc_ss_sym[:, 0, :]),
        trellis_prev=prev, trellis_sign_a=sa, trellis_sign_b=sb,
        points=jmod.constellation(spec.mcs_params.n_bpsc),
        descramble_basis=jcoding._descramble_basis(spec.packet_params.n_data_bits - 7),
        scrambler_phase=phase, scrambler_state_at=state_at, crc_T=crc_T, crc_E=crc_E,
    )


@pytest.mark.parametrize("mcs", [MCS.BPSK_1_2, MCS.QPSK_3_4, MCS.QAM16_1_2])
def test_tables_equal_reference(mcs):
    spec = FrameSpec(mcs, payload_bytes=64, packet_type=PacketType.DATA)
    tab = tables.from_numpy(CFG, spec, "cpu")
    ref = _reference_tables(spec)
    assert set(ref) == set(tab._fields)
    for name, want in ref.items():
        got = getattr(tab, name).numpy()
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build()


def test_non_cpu_tensor_never_takes_the_plain_version():
    # a tensor off the CPU goes to the kernel path, which refuses what is
    # not a CUDA tensor: there is no fallback to the plain version
    x = torch.zeros(4096, dtype=torch.complex64, device="meta")
    with pytest.raises((RuntimeError, ValueError)):
        gather_cuda.gather_rows(x, torch.zeros(3, dtype=torch.int64, device="meta"), 100)
    with pytest.raises((RuntimeError, ValueError)):
        detect_cuda.detect_front_end(
            x, threshold=0.6, min_n_peaks=10, max_peak_distance=160, lag=16, win=32, pwin=48)
    with pytest.raises((RuntimeError, ValueError)):
        viterbi_cuda.viterbi_acs(torch.zeros(3, 20, device="meta"), None)


@pytest.mark.parametrize("k", registry.KERNELS, ids=lambda k: k.name)
def test_registry_entry(k):
    """Each entry names a counted wrapper, its plain version, its CUDA source
    with a C entry point, and the TPU kernel (or its pallas_call) it replaces."""
    assert isinstance(registry.wrapper(k).launches, int)
    assert callable(registry.plain(k))
    assert (ROOT / k.source).is_file()
    assert f"jrc_{k.name}" in kernels.SIGNATURES
    assert f"jrc_{k.name}(" in (ROOT / k.source).read_text()
    path, line = k.replaces.split(":")
    text = (ROOT / path).read_text().splitlines()[int(line) - 1]
    assert text.lstrip().startswith("def _") or "pl.pallas_call(" in text, text


def test_registry_covers_every_entry_point():
    assert sorted(f"jrc_{k.name}" for k in registry.KERNELS) == sorted(kernels.SIGNATURES)
    assert registry.rx_path_kernels() == (
        "viterbi_acs", "viterbi_traceback", "detect_front_end", "gather_rows")


def test_registry_plain_kernels_and_counts():
    """plain_kernels routes each wrapper to its plain version and puts it
    back; reset_counts sets every count to 0."""
    original = viterbi_cuda.viterbi_acs
    with registry.plain_kernels():
        assert viterbi_cuda.viterbi_acs is viterbi.viterbi_acs_plain
        assert shuffle_pieces.shuffle_pieces is shuffle_pieces.shuffle_pieces_plain
    assert viterbi_cuda.viterbi_acs is original
    saved = registry.launch_counts()
    try:
        gather_pieces.gather_pieces.launches = 3
        assert registry.launch_counts()["gather_pieces"] == 3
        registry.reset_counts()
        assert set(registry.launch_counts().values()) == {0}
    finally:
        for k in registry.KERNELS:
            registry.wrapper(k).launches = saved[k.name]


def test_pieces_off_the_cpu_never_take_the_plain_version():
    with pytest.raises((RuntimeError, ValueError)):
        shuffle_pieces.shuffle_pieces(torch.zeros(64, 8, device="meta"), "baseline", 3)
    with pytest.raises((RuntimeError, ValueError)):
        gather_pieces.gather_pieces(torch.zeros(4096, dtype=torch.complex64, device="meta"),
                                    torch.zeros(3, dtype=torch.int64, device="meta"), 100, "full")
    with pytest.raises((RuntimeError, ValueError)):
        viterbi_pieces.viterbi_pieces(torch.zeros(64, 8, device="meta"),
                                      torch.zeros(64, 8, device="meta"), "full", 32)
