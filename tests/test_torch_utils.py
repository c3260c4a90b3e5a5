"""The port's last host-side helpers against jrc_tpu on the CPU: the
802.11 interleaver (``ops.coding.interleave``, all six MCS, both
directions: exactly equal), ``runtime.mean_power`` (the C++ library's
double accumulator: exactly the reference's float, within 1 ulp of float32
of numpy's float64 mean, 0 for no sample), the npz radar capture
(``utils.logging.save_radar_capture``: a file written by either package
loads in the other with the same arrays) and the build fingerprint
(``utils.cache``: stable within a process, different for another compiler
or host)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrc_tpu import runtime as jrt
from jrc_tpu.config import MCS, MCSParams
from jrc_tpu.ops import coding as jcoding
from jrc_tpu.utils import logging as jlogging
from jrc_tpu_torch import runtime as rt
from jrc_tpu_torch.ops import coding
from jrc_tpu_torch.utils import cache, logging as tlogging
from tests.torch_parity import THREADS  # noqa: F401 (the one-thread pool)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("mcs", list(MCS), ids=[m.name for m in MCS])
def test_interleave_matches_reference(mcs, reverse):
    p = MCSParams(mcs)
    rng = np.random.default_rng(int(mcs))
    bits = rng.integers(0, 2, (2, 3 * p.n_cbps)).astype(np.uint8)
    np.testing.assert_array_equal(coding._interleave_perm(p.n_cbps, p.n_bpsc),
                                  jcoding._interleave_perm(p.n_cbps, p.n_bpsc))
    got = coding.interleave(torch.from_numpy(bits), p.n_cbps, p.n_bpsc, reverse=reverse)
    want = jcoding.interleave(jnp.asarray(bits), p.n_cbps, p.n_bpsc, reverse=reverse)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = coding.interleave(got, p.n_cbps, p.n_bpsc, reverse=not reverse)
    np.testing.assert_array_equal(back.numpy(), bits)


@pytest.mark.parametrize("n", [0, 1, 1000, 65537])
def test_mean_power_matches_reference(n):
    rng = np.random.default_rng(n)
    x = (rng.normal(0, 0.3, (n, 2)).astype(np.float32).view(np.complex64)[:, 0]
         if n else np.zeros(0, np.complex64))
    got = rt.mean_power(x)
    assert got == jrt.mean_power(x)
    assert rt.load_library() is not None and jrt.load_library() is not None  # both native
    want = np.float32(np.mean(np.abs(x.astype(np.complex128)) ** 2)) if n else np.float32(0)
    assert abs(np.float32(got) - want) <= np.spacing(want)
    assert rt.mean_power(torch.from_numpy(x)) == got  # a tensor on the CPU


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_radar_capture_npz_round_trip(writer, tmp_path):
    rng = np.random.default_rng(3)
    chan = (rng.normal(size=(8, 64)) + 1j * rng.normal(size=(8, 64))).astype(np.complex64)
    meta = {"range_m": np.float32(12.0), "frame": np.int32(7)}
    path = tmp_path / "cap.npz"
    if writer == "port":
        tlogging.save_radar_capture(str(path), torch.from_numpy(chan), meta)
    else:
        jlogging.save_radar_capture(str(path), chan, meta)
    with np.load(path) as f:
        assert sorted(f.files) == ["chan", "frame", "range_m"]
        assert f["chan"].dtype == np.complex64
        np.testing.assert_array_equal(f["chan"], chan)
        assert f["range_m"] == meta["range_m"] and f["frame"] == meta["frame"]
    other = tmp_path / "other.npz"
    (jlogging if writer == "port" else tlogging).save_radar_capture(str(other), chan, meta)
    with np.load(path) as a, np.load(other) as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_fingerprint_is_stable_within_a_process():
    assert cache.machine_fingerprint() == cache.machine_fingerprint()
    assert cache.machine_fingerprint("g++") == cache.machine_fingerprint("g++")
    assert len(cache.machine_fingerprint()) == 12
    assert cache.compiler_version("no-such-compiler-here") == ""  # none needed
    assert cache.default_cache_root() == rt.BUILD_ROOT.parent
    assert rt.library_path().parent.parent.name == cache.machine_fingerprint("g++")


def test_fingerprint_differs_with_the_compiler_or_host(monkeypatch):
    """Another compiler version or another CPU gives another fingerprint, so
    a library built there is never loaded here."""
    base = cache.machine_fingerprint("g++")
    monkeypatch.setattr(cache, "compiler_version", lambda compiler: "g++ (other) 99.1.0")
    assert cache.machine_fingerprint("g++") != base
    path = rt.library_path()
    monkeypatch.undo()
    assert rt.library_path() != path and rt.library_path().parent.name == path.parent.name
    monkeypatch.setattr(cache, "_cpu_bits", lambda: ("x86_64", "", "model name : another CPU"))
    assert cache.machine_fingerprint("g++") != base
