"""The port's chunk-parallel Viterbi (``ops.viterbi.viterbi_decode_chunked``)
against jrc_tpu's on the CPU, bit for bit: at the three (T, B, L) of
tests/test_viterbi.py on noisy ±1 values (where it also equals the
sequential ``viterbi_decode_plain``), on an all-erasure input, and on a
tied input of {−1, 0, +1} values and on soft values with 20% erasures,
where the reference's chunked decoder parts from its sequential one and the
port follows the chunked one (the first minimum of ``torch.argmin`` as of
``jnp.argmin``). Where the two part, both paths cost the same: the chunked
metrics, summed in another order, break an exact tie the other way."""
import jax
import numpy as np
import pytest
import torch

from jrc_tpu.ops import coding as jcoding, viterbi as jviterbi
from jrc_tpu_torch import tables
from jrc_tpu_torch.ops import coding, viterbi
from tests.torch_parity import CFG, specs

SHAPES = [(200, 1, 64), (576, 4, 128), (1531, 2, 100)]  # (T, B, L)


def trellis():
    spec, _ = specs(1, 16)
    return tables.from_numpy(CFG, spec, "cpu").trellis


def reference(vals, chunk_len):
    return np.asarray(jax.jit(lambda v: jviterbi.viterbi_decode_chunked(
        v, chunk_len=chunk_len))(vals))


@pytest.mark.parametrize("t_steps,b,chunk_len", SHAPES, ids=[f"T{t}-B{b}-L{c}" for t, b, c in SHAPES])
def test_chunked_matches_reference_and_plain(t_steps, b, chunk_len):
    rng = np.random.default_rng(t_steps)
    bits = rng.integers(0, 2, (b, t_steps)).astype(np.uint8)
    coded = np.asarray(jcoding.conv_encode(bits)).astype(np.float32)
    vals = 2 * coded - 1 + rng.normal(0, 0.5, coded.shape).astype(np.float32)
    got = viterbi.viterbi_decode_chunked(torch.from_numpy(vals), n_out=t_steps,
                                         chunk_len=chunk_len)
    assert got.dtype == torch.uint8 and got.shape == (b, t_steps)
    np.testing.assert_array_equal(got.numpy(), reference(vals, chunk_len))
    np.testing.assert_array_equal(
        got.numpy(), viterbi.viterbi_decode_plain(torch.from_numpy(vals), trellis()).numpy())


@pytest.mark.parametrize("kind", ["erasures", "ties"])
def test_chunked_ties_follow_the_reference(kind):
    """Every path tied (all erasures), or many ties ({−1, 0, +1} values):
    equal to jrc_tpu's chunked decoder bit for bit, batch shape and n_out
    kept. On the tied values the reference's chunked and sequential
    decoders part, and so do the port's."""
    rng = np.random.default_rng(5)
    if kind == "erasures":
        vals = np.zeros((3, 2 * 150), np.float32)
    else:
        vals = rng.choice([-1.0, 0.0, 1.0], size=(2, 2, 2 * 300)).astype(np.float32)
    want = reference(vals, 64)
    got = viterbi.viterbi_decode_chunked(torch.from_numpy(vals), chunk_len=64)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        viterbi.viterbi_decode_chunked(torch.from_numpy(vals), n_out=100, chunk_len=64).numpy(),
        want[..., :100])
    plain = viterbi.viterbi_decode_plain(torch.from_numpy(vals), trellis()).numpy()
    seq = np.asarray(jax.jit(jviterbi.viterbi_decode)(vals))
    np.testing.assert_array_equal(plain, seq)
    assert np.array_equal(got.numpy(), plain) == np.array_equal(want, seq)


def path_cost(values: np.ndarray, bits: np.ndarray) -> np.ndarray:
    """The trellis cost of each row's decoded path from state 0: −Σ v · (2c − 1)
    over its re-encoded bits c, in float64."""
    c = coding.conv_encode(torch.from_numpy(bits)).numpy().astype(np.float64)
    return -(values.astype(np.float64) * (2 * c - 1)).sum(-1)


def test_chunked_parts_from_plain_only_on_tied_paths():
    """Soft values with 20% erasures at (64, 576): the port's chunked decoder
    equals the reference's and its plain decoder the reference's sequential
    one, bit for bit; the rows where chunked and sequential part are the same
    rows in both packages, and there both paths cost exactly the same."""
    rng = np.random.default_rng(10)
    vals = rng.normal(0, 1, (64, 2 * 576)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.2] = 0.0
    got = viterbi.viterbi_decode_chunked(torch.from_numpy(vals)).numpy()
    plain = viterbi.viterbi_decode_plain(torch.from_numpy(vals), trellis()).numpy()
    want = reference(vals, 128)
    seq = np.asarray(jax.jit(jviterbi.viterbi_decode)(vals))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plain, seq)
    parted = (got != plain).any(-1)
    np.testing.assert_array_equal(parted, (want != seq).any(-1))
    assert parted.any()  # the input holds ties
    np.testing.assert_array_equal(path_cost(vals, got), path_cost(vals, plain))
