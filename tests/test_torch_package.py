"""The PyTorch port's package boundary: no jax and nothing of the JAX
package, its own copy of the configuration equal to jrc_tpu's, same frame
geometry and constant tables, entry points on the card by default, and no
silent fallback off the card."""
import ast
import inspect
import dataclasses
import enum
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jrc_tpu import config as jconfig  # noqa: E402
from jrc_tpu.ops import (  # noqa: E402
    coding as jcoding, modulation as jmod, precoder as jprecoder, viterbi as jvit,
)
from jrc_tpu.ops.encoder import FrameSpec as JSpec, make_payload as j_make_payload  # noqa: E402
from jrc_tpu_torch import config, kernels, tables  # noqa: E402
from jrc_tpu_torch.config import MCS, OFDMConfig, PacketType  # noqa: E402
from jrc_tpu_torch.kernels import registry  # noqa: E402
from jrc_tpu_torch.ops import (  # noqa: E402
    detect_cuda, gather_cuda, gather_pieces, precoder, shuffle_pieces, viterbi, viterbi_cuda,
    viterbi_pieces,
)
from jrc_tpu_torch.models import streaming  # noqa: E402
from jrc_tpu_torch.ops.encoder import FrameSpec, make_payload  # noqa: E402
from tests.torch_parity import CFG, JCFG, SETTERS, THREADS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: every TPU kernel of the repo: each function that reaches pl.pallas_call
TPU_KERNELS = (
    "jrc_tpu/ops/viterbi_pallas.py:95", "jrc_tpu/ops/viterbi_pallas.py:151",
    "jrc_tpu/ops/detect_pallas.py:89", "jrc_tpu/ops/gather_pallas.py:32",
    "scripts/profile_shuffle.py:70", "scripts/profile_gather_variants.py:72",
    "scripts/profile_viterbi_variants.py:103",
)

IMPORT_ALL = """
import importlib, pkgutil, sys
import jrc_tpu_torch
for m in pkgutil.walk_packages(jrc_tpu_torch.__path__, "jrc_tpu_torch."):
    importlib.import_module(m.name)
importlib.import_module("scripts.multihost_rx_torch")
importlib.import_module("scripts.measure_multihost_torch")
importlib.import_module("scripts.probe_trace_loss_torch")
print(sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "jrc_tpu")))
"""


def test_import_never_loads_jax():
    # a subprocess: the test workers themselves import jax via conftest
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], capture_output=True,
                         text=True, check=True, timeout=120, cwd=ROOT).stdout.strip()
    assert out == "[]", out


PORT_FILES = sorted((ROOT / "jrc_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py",
    ROOT / "scripts" / "multihost_rx_torch.py", ROOT / "scripts" / "measure_multihost_torch.py",
    ROOT / "scripts" / "probe_trace_loss_torch.py",
    ROOT / "tests" / "torch_mesh_ranks.py"]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_nothing_of_the_jax_package(path):
    """No import statement of the port, of chip_smoke.py or of the card's
    tests names jax or jrc_tpu (comments may cite jrc_tpu files)."""
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "jrc_tpu"), (path, name)


def test_port_tests_take_their_thread_count_from_the_helper():
    """Every port test file but the card's imports from tests/torch_parity.py,
    whose import sets the thread count of the test process (in effect here)
    and which holds the environment of the processes a test starts; no port
    test file and no rank script names a thread setting of its own."""
    files = sorted((ROOT / "tests").glob("test_torch_*.py"))
    assert torch.get_num_threads() == THREADS
    for path in files:
        text = path.read_text()
        if path.name != "test_torch_cuda.py":
            froms = {n.module for n in ast.walk(ast.parse(text)) if isinstance(n, ast.ImportFrom)}
            assert "tests.torch_parity" in froms, path.name
    for path in [*files, ROOT / "tests" / "torch_mesh_ranks.py"]:
        for name in SETTERS:
            assert name not in path.read_text(), (path.name, name)


def _public(mod):
    return {n for n in vars(mod) if not n.startswith("_")
            and getattr(vars(mod)[n], "__module__", mod.__name__) == mod.__name__
            and not isinstance(vars(mod)[n], type(sys))}


def _same(a, b, what):
    """Equal by value across the two packages (enums by value, arrays
    exactly, dataclasses field by field)."""
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(a, enum.Enum):
        assert (a.name, a.value) == (b.name, b.value), what
    elif isinstance(a, dict):
        assert list(map(int, a)) == list(map(int, b)), what
        for (ka, va), (kb, vb) in zip(a.items(), b.items()):
            _same(ka, kb, what)
            _same(va, vb, what)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for x, y in zip(a, b):
            _same(x, y, what)
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    else:
        assert a == b and type(a) is type(b), what


def test_config_has_the_reference_names():
    # the port keeps the speed of light beside the config (the reference in ops/channel.py)
    assert _public(config) - {"C_LIGHT"} == _public(jconfig)


@pytest.mark.parametrize("name", sorted(
    n for n in _public(jconfig) if n.isupper() and not isinstance(getattr(jconfig, n), type)))
def test_config_constant_matches(name):
    _same(getattr(config, name), getattr(jconfig, name), name)


@pytest.mark.parametrize("cls", ["MCS", "PacketType"])
def test_config_enum_matches(cls):
    ours, ref = getattr(config, cls), getattr(jconfig, cls)
    assert [(m.name, int(m)) for m in ours] == [(m.name, int(m)) for m in ref]
    assert issubclass(ours, enum.IntEnum)


def _attrs(obj):
    """Names of the dataclass fields, properties and cached properties of
    ``obj``'s class."""
    cls = type(obj)
    derived = [n for n, v in vars(cls).items() if not n.startswith("_")
               and (isinstance(v, property) or hasattr(v, "func"))]
    return sorted([f.name for f in dataclasses.fields(cls)] + derived)


def _same_object(ours, ref, what):
    attrs = _attrs(ref)
    assert attrs == _attrs(ours), what
    for name in attrs:
        _same(getattr(ours, name), getattr(ref, name), f"{what}.{name}")
    return attrs


@pytest.mark.parametrize("mcs", list(jconfig.MCS))
def test_config_mcs_and_packet_params_match(mcs):
    ours, ref = config.MCSParams(config.MCS(int(mcs))), jconfig.MCSParams(mcs)
    assert len(_same_object(ours, ref, "MCSParams")) >= 7
    for n_bytes in (4, 5, 68, 81, config.MAX_PAYLOAD_SIZE + 4):
        for ptype in jconfig.PacketType:
            a = config.PacketParams(ours, n_bytes, config.PacketType(int(ptype)))
            b = jconfig.PacketParams(ref, n_bytes, ptype)
            assert len(_same_object(a, b, f"PacketParams({n_bytes})")) >= 8
    for n_carriers in (48, 52):
        _same(config.mcs_tables(n_carriers), jconfig.mcs_tables(n_carriers), "mcs_tables")


@pytest.mark.parametrize("kwargs", [{}, {"n_tx": 2, "n_rx": 2}], ids=["default", "2x2"])
def test_config_ofdm_config_matches(kwargs):
    ours, ref = OFDMConfig(**kwargs), jconfig.OFDMConfig(**kwargs)
    attrs = _same_object(ours, ref, "OFDMConfig")
    assert len(attrs) > 20
    assert sum(isinstance(getattr(ref, n), np.ndarray) for n in attrs) >= 8
    _same(ours.range_axis(), ref.range_axis(), "range_axis")
    _same(ours.angle_axis(), ref.angle_axis(), "angle_axis")
    assert hash(ours) == hash(OFDMConfig(**kwargs)) and ours == OFDMConfig(**kwargs)
    _same(config.DEFAULT_CONFIG, jconfig.DEFAULT_CONFIG, "DEFAULT_CONFIG")


@pytest.mark.parametrize("mcs", list(MCS))
def test_frame_spec_matches(mcs):
    ours = FrameSpec(mcs, payload_bytes=77, packet_type=PacketType.DATA)
    ref = JSpec(jconfig.MCS(int(mcs)), payload_bytes=77, packet_type=jconfig.PacketType.DATA)
    _same_object(ours.packet_params, ref.packet_params, "packet_params")
    _same_object(ours.mcs_params, ref.mcs_params, "mcs_params")
    assert ours.n_ofdm_sym == ref.n_ofdm_sym
    assert ours.data_size_byte == ref.data_size_byte
    np.testing.assert_array_equal(make_payload(ours, b"\x02abc"), j_make_payload(ref, b"\x02abc"))
    assert precoder.SIG_RATE_TO_MCS == jprecoder.SIG_RATE_TO_MCS


def _reference_tables(spec):
    prev, sa, sb = jvit._trellis()
    _, phase, state_at = jcoding._scrambler_tables()
    crc_T, crc_E = jcoding._crc32_linear_tables(spec.data_size_byte)
    return dict(
        data_idx=JCFG.data_carrier_idx, pilot_idx=JCFG.pilot_carrier_idx,
        active_idx=JCFG.active_carrier_idx, lltf_freq=JCFG.lltf_freq,
        pilot_symbols=JCFG.pilot_symbols,
        ltf0_conj=np.conj(JCFG.ltf_mapped_sc_ss_sym[:, 0, :]),
        trellis_prev=prev, trellis_sign_a=sa, trellis_sign_b=sb,
        points=jmod.constellation(spec.mcs_params.n_bpsc),
        descramble_basis=jcoding._descramble_basis(spec.packet_params.n_data_bits - 7),
        scrambler_phase=phase, scrambler_state_at=state_at, crc_T=crc_T, crc_E=crc_E,
        ltf_conj=np.conj(JCFG.ltf_mapped_sc_ss_sym), sync_freq=JCFG.sync_words_freq,
        ltf_mapped=JCFG.ltf_mapped_sc_ss_sym,
        sig_symbols=jprecoder.signal_field_symbols(JSpec(
            jconfig.MCS(int(spec.mcs)), spec.payload_bytes,
            jconfig.PacketType(int(spec.packet_type)))),
        scramble_cycle=jcoding._scrambler_tables()[0],
        fourier=jprecoder.fourier_matrix(JCFG.n_tx), qpsk_tx=jmod.constellation(2, tx_scale=True),
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
        viterbi_cuda.viterbi_decode(torch.zeros(3, 20, device="meta"), None)


@pytest.mark.parametrize("dynamic", [False, True], ids=["StreamingRx", "StreamingRxDynamic"])
def test_entry_points_default_to_the_card(dynamic):
    """Without ``device`` the modules build on the CUDA device and raise where
    there is none; ``device="cpu"`` builds them on the CPU, and ``forward``
    refuses a capture that lies elsewhere."""
    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=64, packet_type=PacketType.DATA)

    def make(**kw):
        if dynamic:
            return streaming.StreamingRxDynamic(CFG, 2**13, 2, max_payload=96, **kw)
        return streaming.StreamingRx(CFG, spec, 2**13, 2, **kw)

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    model = make(device="cpu")
    assert {b.device.type for b in model.buffers()} == {"cpu"}
    with pytest.raises(RuntimeError, match="device"):
        model(torch.zeros(2 * 2**13 + 4096, dtype=torch.complex64, device="meta"))


@pytest.mark.parametrize("k", registry.KERNELS, ids=lambda k: k.name)
def test_registry_entry(k):
    """Each entry names a counted wrapper, its plain version, its CUDA source
    with a C entry point, and the TPU kernels (or their pallas_call) it replaces;
    the wrapper counts its launches in the registry, in one place."""
    assert inspect.getsource(registry.wrapper(k)).count(f'registry.count("{k.name}")') == 1
    assert isinstance(registry.launch_counts()[k.name], int)
    assert callable(registry.plain(k))
    assert (ROOT / k.source).is_file()
    assert f"jrc_{k.name}" in kernels.SIGNATURES
    assert f"jrc_{k.name}(" in (ROOT / k.source).read_text()
    assert isinstance(k.replaces, tuple) and k.replaces
    for replaced in k.replaces:
        path, line = replaced.split(":")
        text = (ROOT / path).read_text().splitlines()[int(line) - 1]
        assert text.lstrip().startswith("def _") or "pl.pallas_call(" in text, text


@pytest.mark.parametrize("tpu_kernel", TPU_KERNELS)
def test_registry_replaces_every_tpu_kernel(tpu_kernel):
    owners = [k.name for k in registry.KERNELS if tpu_kernel in k.replaces]
    assert len(owners) == 1, owners


def test_registry_covers_every_entry_point():
    assert sorted(f"jrc_{k.name}" for k in registry.KERNELS) == sorted(kernels.SIGNATURES)
    assert registry.rx_path_kernels() == ("viterbi_decode", "detect_front_end", "gather_rows")
    with pytest.raises(ValueError, match="path"):
        registry.rx_path_kernels("radar")
    # the fused decoder stands for both TPU kernels of the decoder
    assert registry.KERNELS[0].replaces == TPU_KERNELS[:2]
    assert sorted(r for k in registry.KERNELS for r in k.replaces) == sorted(TPU_KERNELS)


def _run_path(path: str) -> None:
    """One small run of ``path`` on the CPU."""
    from jrc_tpu_torch import capture
    from jrc_tpu_torch.io.stream import BlockStreamer
    from jrc_tpu_torch.models import jrc_trx

    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=64, packet_type=PacketType.DATA)
    frame, _, halo = capture.load_bench_frame()
    cap, _ = capture.build_capture(frame, 2 * 2**13, halo=halo)
    if path == "static":
        streaming.StreamingRx(CFG, spec, 2**13, 2, device="cpu")(torch.from_numpy(cap))
    elif path == "dynamic":
        streaming.StreamingRxDynamic(CFG, 2**13, 2, max_payload=96, device="cpu")(
            torch.from_numpy(cap))
    elif path == "stream":
        streamer = BlockStreamer(CFG, spec, block_len=2**13, max_frames=8, device="cpu")
        streamer.push(cap)
        assert sum(int(r.crc_ok.sum()) for r in streamer.flush()) > 0
    elif path == "sim":
        from jrc_tpu_torch.models import evaluation

        spec = FrameSpec(MCS.BPSK_1_2, payload_bytes=16, packet_type=PacketType.DATA)
        payload = torch.from_numpy(make_payload(spec, b"\x02sim"))
        pts = evaluation.link_curve(CFG, spec, tables.from_numpy(CFG, spec, "cpu"), payload, [20.0],
                                    n_frames=2)
        assert pts[0].per == 0.0
    elif path == "block":
        for batched in (True, False):
            streaming.StreamingRx(CFG, spec, 2**13 - 64, 2, batched=batched, device="cpu")(
                torch.from_numpy(cap))
            streaming.StreamingRxDynamic(CFG, 2**13 - 64, 2, max_payload=96, batched=batched,
                                         device="cpu")(torch.from_numpy(cap))
    elif path == "mesh":
        from jrc_tpu_torch.parallel import batch, mesh, streaming as pstream

        with mesh.local_group("gloo"):
            tm, bm = mesh.time_mesh(device="cpu"), mesh.batch_mesh(device="cpu")
            for n in (2 * 2**13, 2 * 2**13 - 64):  # flat_rx, then rx_block
                block = pstream.local_block(tm, cap[:n], device="cpu")
                assert int(pstream.sharded_rx(CFG, spec, tm, block).n_crc_ok) > 0
                assert int(pstream.sharded_rx_dynamic(CFG, tm, block, max_payload=96)
                           .n_crc_ok) > 0
            halo = streaming.frame_window_samples(CFG, spec) + CFG.fft_len
            assert batch.batched_rx(bm, CFG, spec, cap[None, : 2**13 + halo],
                                    device="cpu")[0, 1] > 0
    elif path == "configs":
        cfg = capture.antenna_config(2, 1, 2)
        dwells = capture.ENTRY_DWELLS[:1]
        draws = capture.config_draws(cfg, dwells, np.random.default_rng(0))
        assert capture.config_dwells(jrc_trx.JRCTrx(cfg, device="cpu"), dwells, *draws)[0][
            "crc_ok"]
        frame, _ = capture.config_frame(cfg, spec, b"n_ltf 2")
        halo = streaming.frame_window_samples(cfg, spec) + cfg.fft_len
        cap2, n_frames = capture.build_capture(frame, 2 * 2**13, halo=halo)
        res = streaming.StreamingRx(cfg, spec, 2**13, 2, device="cpu")(torch.from_numpy(cap2))
        assert int(res.crc_ok.sum()) == n_frames
    else:
        trx = jrc_trx.JRCTrx(CFG, device="cpu")
        dwell = capture.pinned_jrc_dwells()[0]
        spec, payload, targets, draws, opts = capture.pinned_step_args(dwell, "cpu")
        trx(trx.init_state(), spec, payload, targets, draws=draws, **opts)


@pytest.mark.parametrize("path", registry.PATHS)
def test_registry_paths_are_what_each_path_launches(path):
    """The kernels each path calls on the CPU, counted where their wrappers
    are called (through the plain versions here), are the registry's for
    that path; the wrappers' launch counts stay 0 on the CPU (they count
    kernel launches only)."""
    calls = []
    before = registry.launch_counts()
    wrappers = [registry.wrapper(k) for k in registry.KERNELS]
    with registry.recorded_calls(calls):
        _run_path(path)
    assert {name for name, _, _ in calls} == set(registry.rx_path_kernels(path))
    assert registry.launch_counts() == before
    assert [registry.wrapper(k) for k in registry.KERNELS] == wrappers  # put back


def test_recorded_calls_keep_the_launch_counts():
    """The counts are the registry's, not the wrappers': a launch counted
    while recorded_calls or plain_kernels holds stays counted, and the swap
    itself moves no count."""
    name = registry.KERNELS[0].name
    before = registry.launch_counts()
    with registry.recorded_calls([]):
        registry.count(name)  # what the wrapper does where it launches
    with registry.plain_kernels():
        registry.count(name)
    assert registry.launch_counts() == {**before, name: before[name] + 2}


def test_registry_plain_kernels_and_counts():
    """plain_kernels routes each wrapper to its plain version and puts it
    back; reset_counts sets every count to 0."""
    original = viterbi_cuda.viterbi_decode
    with registry.plain_kernels():
        assert viterbi_cuda.viterbi_decode is viterbi.viterbi_decode_plain
        assert shuffle_pieces.shuffle_pieces is shuffle_pieces.shuffle_pieces_plain
    assert viterbi_cuda.viterbi_decode is original
    before = registry.launch_counts()["gather_pieces"]
    for _ in range(3):
        registry.count("gather_pieces")
    assert registry.launch_counts()["gather_pieces"] == before + 3
    registry.reset_counts()
    assert set(registry.launch_counts().values()) == {0}


def test_pieces_off_the_cpu_never_take_the_plain_version():
    with pytest.raises((RuntimeError, ValueError)):
        shuffle_pieces.shuffle_pieces(torch.zeros(64, 8, device="meta"), "baseline", 3)
    with pytest.raises((RuntimeError, ValueError)):
        gather_pieces.gather_pieces(torch.zeros(4096, dtype=torch.complex64, device="meta"),
                                    torch.zeros(3, dtype=torch.int64, device="meta"), 100, "full")
    with pytest.raises((RuntimeError, ValueError)):
        viterbi_pieces.viterbi_pieces(torch.zeros(64, 8, device="meta"),
                                      torch.zeros(64, 8, device="meta"), "full", 32)
