"""The port's host utilities against jrc_tpu's: JRC state snapshots that
load across the two packages both ways (``utils/state_io``) and a JRC loop
resumed from a snapshot (tests/test_parallel_aux.py:89).

A snapshot holds the leaves in the reference's pytree order, so leaves
cross exactly. A port loop resumed from a jrc_tpu state equals the
uninterrupted port loop within ``capture.jrc_mismatches``' tolerances
(exact fields exact, floats within 1e-5 · max|want|, SNRs within 1e-3 dB:
the reference's state after dwell 1 and the port's differ by rounding); a
port loop resumed from its own snapshot equals it exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jrc_tpu.models import jrc_trx as jjrc  # noqa: E402
from jrc_tpu.utils import state_io as jstate_io  # noqa: E402
from jrc_tpu_torch import capture  # noqa: E402
from jrc_tpu_torch.models import jrc_trx  # noqa: E402
from jrc_tpu_torch.utils import state_io  # noqa: E402
from tests.torch_parity import CFG, JCFG  # noqa: E402

DWELLS = capture.pinned_jrc_dwells()


def _reference_leaves(dwell: int) -> list[np.ndarray]:
    """The state jrc_tpu left after ``dwell``, as pinned."""
    return [DWELLS[dwell].want[f"state_{n}"] for n in capture.JRC_STATE_LEAVES]


def _run(trx, state, dwells):
    records = []
    for dw in dwells:
        spec, payload, targets, draws, opts = capture.pinned_step_args(dw, "cpu")
        r = trx(state, spec, payload, targets, draws=draws, **opts)
        state = r.state
        records.append(capture.step_record(r))
    return state, records


@pytest.fixture(scope="module")
def uninterrupted():
    """The port's loop over the four pinned dwells from the initial state →
    (trx, state after dwell 1, records of dwells 2 and 3)."""
    trx = jrc_trx.JRCTrx(CFG, device="cpu")
    half, _ = _run(trx, trx.init_state(), DWELLS[:2])
    _, records = _run(trx, half, DWELLS[2:])
    return trx, half, records


def test_snapshot_roundtrip(tmp_path):
    st = jrc_trx.init_state(CFG, device="cpu")._replace(radar_angle=torch.tensor(17.5),
                                         radar_valid=torch.tensor(True),
                                         frame_count=torch.tensor(42, dtype=torch.int32))
    p = tmp_path / "state.npz"
    state_io.save_state(str(p), st)
    back = state_io.load_state(str(p), jrc_trx.init_state(CFG, device="cpu"))
    assert isinstance(back, jrc_trx.JRCState)
    assert float(back.radar_angle) == 17.5 and bool(back.radar_valid)
    assert int(back.frame_count) == 42
    assert back.background.buffer.shape == st.background.buffer.shape
    with np.load(p) as f:  # the reference's layout
        assert int(f["n_leaves"]) == 9 and {f"leaf_{i}" for i in range(9)} < set(f)
    with pytest.raises(ValueError, match="shape"):
        state_io.load_state(str(p), jrc_trx.init_state(CFG, record_len=4, device="cpu"))


def test_port_snapshot_loads_into_jrc_tpu(tmp_path):
    st = jrc_trx.state_from_numpy(_reference_leaves(1), "cpu")
    p = str(tmp_path / "port.npz")
    state_io.save_state(p, st)
    back = jstate_io.load_state(p, jjrc.init_state(JCFG))
    assert isinstance(back, jjrc.JRCState)
    got = jax.tree_util.tree_leaves(back)
    want = jrc_trx.state_to_numpy(st)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g), w)


def test_loop_resumes_from_a_jrc_tpu_snapshot(tmp_path, uninterrupted):
    """jrc_tpu writes its state after dwell 1; the port loads it and runs
    dwells 2 and 3, equal to the port's uninterrupted loop."""
    trx, _, want = uninterrupted
    like = jjrc.init_state(JCFG)
    jstate = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(like),
                                          [jnp.asarray(x) for x in _reference_leaves(1)])
    p = str(tmp_path / "jrc_tpu.npz")
    jstate_io.save_state(p, jstate)
    resumed = state_io.load_state(p, trx.init_state())
    for g, w in zip(jrc_trx.state_to_numpy(resumed), _reference_leaves(1)):
        np.testing.assert_array_equal(g, w)
    _, got = _run(trx, resumed, DWELLS[2:])
    for g, w in zip(got, want):
        assert capture.jrc_mismatches(g, w) == []


def test_loop_resumes_from_its_own_snapshot_exactly(tmp_path, uninterrupted):
    trx, half, want = uninterrupted
    p = str(tmp_path / "port.npz")
    state_io.save_state(p, half)
    _, got = _run(trx, state_io.load_state(p, trx.init_state()), DWELLS[2:])
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
