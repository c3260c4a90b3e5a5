"""The plain versions of the port's profiling kernels P1-P3 against the
Pallas kernels of scripts/profile_{shuffle,gather_variants,viterbi_variants}.py
run in interpret mode on the CPU, at small shapes (the scripts' module
constants B, STEPS, CHUNK and N made small).

Each script is loaded fresh from its file with ``pl.pallas_call`` replaced
by an interpret-mode stand-in that also keeps each call's output. Loading a
script inserts the script's own checkout path into ``sys.path`` and calls
``enable_compile_cache()``, which moves the process-wide compile cache (to a
tmp dir here, through ``JRC_JAX_CACHE``); ``interpret_scripts`` puts
``sys.path`` and the three cache settings back afterwards.

P1 compares the final (64, B) state exactly and the scalar the script's
``make`` returns within rtol 1e-6 (the kernel sums in float32, the port in
float64); P2 compares the gathered (B, 2, w_out) rows exactly and the
scalar within rtol 1e-6; P3 compares w0, w1 and pm exactly. The states and
rows come from a run under ``jax.disable_jit()``, where the pallas_call
output is a concrete array. P2's ``noroll_nodma`` returns uninitialized
memory on the TPU, so only ``full`` and ``noroll`` are compared there.
"""
import contextlib
import importlib.util
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.experimental import pallas as real_pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from jrc_tpu.ops import cplx as cx  # noqa: E402
from jrc_tpu_torch.ops import gather_pieces, shuffle_pieces, viterbi_pieces  # noqa: E402
from tests.torch_parity import THREADS  # noqa: E402,F401 (the one-thread pool)

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
              "jax_persistent_cache_min_entry_size_bytes")


@contextlib.contextmanager
def interpret_scripts(cache_dir):
    """Yield load(name) → (a fresh module of scripts/<name>.py whose
    pallas_call runs in interpret mode, the list of that call's outputs);
    sys.path and the jax cache settings are restored on exit."""
    saved_path = list(sys.path)
    saved_cfg = {k: getattr(jax.config, k) for k in CACHE_KEYS}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JRC_JAX_CACHE", str(cache_dir))

        def load(name):
            outputs = []

            def pallas_call(*args, **kwargs):
                call = real_pl.pallas_call(*args, interpret=True, **kwargs)

                def run(*operands):
                    out = call(*operands)
                    outputs.append(out)
                    return out

                return run

            stand_in = types.SimpleNamespace(**{k: getattr(real_pl, k) for k in dir(real_pl)
                                                if not k.startswith("__")})
            stand_in.pallas_call = pallas_call
            spec = importlib.util.spec_from_file_location(f"_{name}_interpret",
                                                          SCRIPTS / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            try:
                spec.loader.exec_module(mod)
            finally:
                sys.path[:] = saved_path
            mod.pl = stand_in
            return mod, outputs

        try:
            yield load
        finally:
            sys.path[:] = saved_path
            for k, v in saved_cfg.items():
                jax.config.update(k, v)


@pytest.fixture
def load_script(tmp_path):
    with interpret_scripts(tmp_path / "jax_cache") as load:
        yield load


def test_loading_a_script_leaves_the_process_as_it_was(tmp_path):
    """The scripts insert a path into sys.path and move the compile cache
    at import; neither outlives the loader."""
    path, cfg = list(sys.path), {k: getattr(jax.config, k) for k in CACHE_KEYS}
    with interpret_scripts(tmp_path / "jax_cache") as load:
        load("profile_shuffle")
        assert sys.path == path
    assert sys.path == path
    assert {k: getattr(jax.config, k) for k in CACHE_KEYS} == cfg


@pytest.mark.parametrize("variant", shuffle_pieces.VARIANTS)
def test_shuffle_plain_matches_pallas(load_script, variant):
    mod, outputs = load_script("profile_shuffle")
    # an odd step count, not a multiple of roll8's period of 8: a wrong
    # permutation cannot come back to the right state by the end
    mod.B, mod.STEPS, mod.CHUNK = 256, 63, 7
    x = np.random.default_rng(0).uniform(0.5, 1.5, (64, mod.B)).astype(np.float32)
    want = float(np.asarray(mod.make(variant)(x))[0, 0])
    with jax.disable_jit():
        mod.make(variant)(x)
    state, total = shuffle_pieces.shuffle_pieces(torch.from_numpy(x), variant, mod.STEPS)
    assert state.shape == (64, mod.B) and state.dtype == torch.float32
    np.testing.assert_array_equal(state.numpy(), np.asarray(outputs[-1]))
    np.testing.assert_allclose(float(total), want, rtol=1e-6)


@pytest.mark.parametrize("variant", ["full", "noroll"])
def test_gather_pieces_plain_matches_pallas(load_script, variant):
    mod, outputs = load_script("profile_gather_variants")
    mod.B, mod.N = 64, 8192
    width = 300
    rng = np.random.default_rng(1)
    xs = rng.normal(0, 1, (2, mod.N)).astype(np.float32)
    starts = rng.integers(0, mod.N - 400, mod.B)
    starts[:4] = [-7, mod.N - width + 5, mod.N, 129]  # clamped at both ends
    starts = starts.astype(np.int32)
    args = (cx.CArray(jnp.asarray(xs[0]), jnp.asarray(xs[1])), jnp.asarray(starts))
    want = float(np.asarray(mod.make(variant, width)(*args))[0, 0])
    with jax.disable_jit():
        mod.make(variant, width)(*args)
    x = torch.complex(torch.from_numpy(xs[0]), torch.from_numpy(xs[1]))
    rows = gather_pieces.gather_pieces(x, torch.from_numpy(starts), width, variant)
    assert rows.shape == (mod.B, 384) and rows.dtype == torch.complex64
    want_rows = np.asarray(outputs[-1])[: mod.B]  # (B, 2, w_out): re, im
    np.testing.assert_array_equal(rows.real.numpy(), want_rows[:, 0])
    np.testing.assert_array_equal(rows.imag.numpy(), want_rows[:, 1])
    np.testing.assert_allclose(float(rows.real[:, :8].sum(dtype=torch.float64)), want, rtol=1e-6)


def test_gather_pieces_rows():
    """Row contents the scripts' scalar does not see: full rows start at the
    clamped start, noroll rows at that start rounded down to 128, zeros past
    the stream; noroll_nodma is all zeros."""
    n, width = 1000, 300
    x = torch.arange(1, n + 1, dtype=torch.float32).to(torch.complex64)
    starts = torch.tensor([-5, 130, 699, 900])
    full = gather_pieces.gather_pieces(x, starts, width, "full")
    noroll = gather_pieces.gather_pieces(x, starts, width, "noroll")
    assert full.real[:, 0].tolist() == [1, 131, 700, 701]
    assert noroll.real[:, 0].tolist() == [1, 129, 641, 641]
    assert full.real[3, n - 700 :].abs().sum() == 0 and full.real[3, n - 701] == n
    assert not gather_pieces.gather_pieces(x, starts, width, "noroll_nodma").abs().any()
    with pytest.raises(ValueError):
        gather_pieces.gather_pieces(x, starts, n + 1, "full")


def _p3_reference(mod, variant, va, vb, chunk_t):
    """The script's make_kernel in its own interpret-mode pallas_call,
    returning w0, w1 and pm (run_variant returns only pm's sum)."""
    t_steps, b = va.shape
    n_chunks = t_steps // chunk_t
    sa, sb = mod._sign_tables()

    def spec(shape, index_map):
        return real_pl.BlockSpec(shape, index_map, memory_space=pltpu.VMEM)

    return real_pl.pallas_call(
        mod.make_kernel(variant, chunk_t, n_chunks),
        grid=(n_chunks,),
        in_specs=[spec((chunk_t, b), lambda i: (i, 0)), spec((chunk_t, b), lambda i: (i, 0)),
                  spec((64, 2), lambda i: (0, 0)), spec((64, 2), lambda i: (0, 0))],
        out_specs=[spec((chunk_t, b), lambda i: (i, 0)), spec((chunk_t, b), lambda i: (i, 0)),
                   spec((64, b), lambda i: (0, 0))],
        out_shape=[jax.ShapeDtypeStruct((t_steps, b), jnp.uint32),
                   jax.ShapeDtypeStruct((t_steps, b), jnp.uint32),
                   jax.ShapeDtypeStruct((64, b), jnp.float32)],
        scratch_shapes=[pltpu.VMEM((64, b), jnp.float32)],
        interpret=True,
    )(jnp.asarray(va), jnp.asarray(vb), jnp.asarray(sa), jnp.asarray(sb))


@pytest.mark.parametrize("variant,chunk_t", [(v, 32) for v in viterbi_pieces.VARIANTS]
                         + [("full", 16), ("full", 64)])
def test_viterbi_pieces_plain_matches_pallas(load_script, variant, chunk_t):
    mod, _ = load_script("profile_viterbi_variants")
    rng = np.random.default_rng(chunk_t)
    t_steps, b = 128, 256
    va = rng.normal(0, 1, (t_steps, b)).astype(np.float32)
    vb = rng.normal(0, 1, (t_steps, b)).astype(np.float32)
    va[rng.random(va.shape) < 0.2] = 0.0  # erasures: equal candidates
    w0, w1, pm = (np.asarray(a) for a in _p3_reference(mod, variant, va, vb, chunk_t))
    g0, g1, gpm = viterbi_pieces.viterbi_pieces(torch.from_numpy(va), torch.from_numpy(vb),
                                                variant, chunk_t)
    np.testing.assert_array_equal(g0.numpy(), w0.view(np.int32))
    np.testing.assert_array_equal(g1.numpy(), w1.view(np.int32))
    np.testing.assert_array_equal(gpm.numpy(), pm)


def test_viterbi_pieces_full_decodes():
    """The full body's words trace back to the encoded bits: w0/w1 hold
    state s's decision at bit s % 32."""
    from jrc_tpu.ops import coding as jcoding

    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, (3, 64)).astype(np.uint8)
    bits[:, -6:] = 0  # tail: end in state 0
    coded = np.asarray(jcoding.conv_encode(jnp.asarray(bits))).astype(np.float32) * 2 - 1
    va, vb = torch.from_numpy(coded[:, 0::2].T.copy()), torch.from_numpy(coded[:, 1::2].T.copy())
    w0, w1, _ = viterbi_pieces.viterbi_pieces(va, vb, "full", 32)
    state = np.zeros(3, np.int64)
    out = np.zeros_like(bits)
    for t in range(63, -1, -1):
        word = np.where(state < 32, w0[t].numpy(), w1[t].numpy()).astype(np.int64) & 0xFFFFFFFF
        j = (word >> (state % 32)) & 1
        out[:, t] = state & 1
        state = (state >> 1) + 32 * j
    np.testing.assert_array_equal(out, bits)


def test_pieces_reject_bad_arguments():
    with pytest.raises(ValueError):
        shuffle_pieces.shuffle_pieces(torch.zeros(64, 4), "nope", 3)
    with pytest.raises(ValueError):
        shuffle_pieces.shuffle_pieces(torch.zeros(32, 4), "baseline", 3)
    with pytest.raises(ValueError):
        viterbi_pieces.viterbi_pieces(torch.zeros(40, 4), torch.zeros(40, 4), "full", 32)
    with pytest.raises(ValueError):
        gather_pieces.gather_pieces(torch.zeros(500, dtype=torch.complex64),
                                    torch.zeros(2), 100, "roll")
