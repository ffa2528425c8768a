"""The port's implicit Schur solver against apex_tpu's block path
(APEX_TPU_UNIFORM=0) on synthetic_ba(8, 150, seed=0), f64, both started
from the same mid-solve state through convert.values_from_jax.

Tolerances: assembly rtol 1e-10 and solve rtol 1e-8. The sums run in
another order (index_add_ against sorted segment sums) and the PCG
preconditioner comes from another eigh, so the results agree to rounding
and to the PCG tolerance (1e-10), not bitwise. The solve runs at damping
0.1: self-calibration leaves the global scale free, held only by the
damping, so the step's conditioning grows as 1/damping and at 1e-3 turns
1e-16 assembly rounding into ~5e-8 relative differences of dx."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ba import build_ba_problem as jax_build
from apex_tpu.linalg.schur import SchurContext as JaxSchur
from apex_tpu_torch.ba import build_ba_problem
from apex_tpu_torch.convert import values_from_jax, values_to_numpy
from apex_tpu_torch.io import synthetic
from apex_tpu_torch.linalg.schur import SchurContext

EXACT = dict(variant="iterative", pcg_forcing=False, pcg_tolerance=1e-10,
             pcg_max_iterations=500)
DAMPING = 0.1


@pytest.fixture(scope="module")
def setup():
    ds = synthetic.synthetic_ba(n_cameras=8, n_points=150, seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_TPU_UNIFORM", "0")
        jcp = jax_build(ds, mode="self_calibration").compile(dtype=np.float64)
        jctx = JaxSchur(jcp, **EXACT)
    assert jctx.uniform is None, "the JAX side must run its block path"
    tcp = build_ba_problem(ds, mode="self_calibration").compile(
        dtype=torch.float64, device="cpu")
    tctx = SchurContext(tcp, **EXACT)
    # a mid-solve state: the initial values moved by a seeded step
    dx = np.random.default_rng(3).normal(scale=1e-2, size=jcp.total_dof)
    jvals = jcp.apply_step(jcp.initial_values(), jnp.asarray(dx))
    tvals = values_from_jax(tcp, [np.asarray(v) for v in jvals], jcp.pools)
    return jcp, jctx, jvals, tcp, tctx, tvals


def _close(t, j, rtol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=0)


def test_structure(setup):
    _, jctx, _, _, tctx, _ = setup
    assert (tctx.num_landmarks, tctx.num_entities, tctx.entity_dof) == (
        jctx.num_landmarks, jctx.num_entities, jctx.entity_dof)
    np.testing.assert_array_equal(tctx.red_of_global, jctx.red_of_global)
    assert len(tctx.couplings) == len(jctx.mcouplings)


def test_assemble(setup):
    _, jctx, jvals, _, tctx, tvals = setup
    jout = jctx.assemble(jvals, DAMPING)
    tout = tctx.assemble(tvals, DAMPING)
    for name, t, j in zip(("Hcc", "gc", "Hpp", "gp"), tout[:4], jout[:4]):
        assert t.shape == j.shape, name
        _close(t, j, 1e-10)
    assert len(tout[4]) == len(jout[4])
    for tw, jw in zip(tout[4], jout[4]):
        _close(tw, jw, 1e-10)
    _close(tout[5], jout[5], 1e-10)


@pytest.mark.parametrize("start", ["cold", "warm", "bad_warm"])
def test_solve(setup, start):
    jcp, jctx, jvals, _, tctx, tvals = setup
    jx0 = None
    if start != "cold":
        ref, *_ = jctx.solve(jvals, DAMPING)
        rng = np.random.default_rng(5)
        # a good warm start is near the answer; a bad one is rejected by the
        # guard and PCG starts from zero
        x0 = (0.9 * np.asarray(ref) if start == "warm"
              else rng.normal(scale=1e3, size=jcp.total_dof))
        jx0 = jnp.asarray(x0)
    jdx, jg, jcost, jpred = jctx.solve(jvals, DAMPING, dx_prev=jx0)
    tdx, tg, tcost, tpred = tctx.solve(
        tvals, DAMPING, dx_prev=None if jx0 is None else torch.from_numpy(np.array(jx0)))
    scale = np.abs(np.asarray(jdx)).max()
    # fixed-DOF entries are rounding noise around 0 in both: atol at the
    # step's scale
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), rtol=1e-8, atol=1e-12 * scale)
    _close(tg, jg, 1e-8)
    _close(tcost, jcost, 1e-12)
    _close(tpred, jpred, 1e-8)


def test_forcing_and_f32_knobs(setup):
    _, _, _, tcp, tctx, _ = setup
    assert tctx.pcg_rtol(None) == tctx.pcg_rtol_floor == 1e-10
    forced = SchurContext(tcp, variant="iterative", pcg_tolerance=1e-6)
    assert [forced.pcg_rtol(k) for k in (0, 1, 3, 30)] == [0.1, 0.05, 0.0125, 1e-6]
    f32 = SchurContext(build_ba_problem(synthetic.synthetic_ba(4, 40, seed=1)).compile(
        dtype=torch.float32, device="cpu"))
    assert f32.pp_shift_floor == 1e-4 and f32.pcg_rtol_floor == 3e-5
    assert tctx.pp_shift_floor == 0.0


def test_convert_checks(setup):
    jcp, _, jvals, tcp, _, tvals = setup
    arrays = values_to_numpy(tvals)
    for a, j in zip(arrays, jvals):
        np.testing.assert_array_equal(a, np.asarray(j))
    with pytest.raises(ValueError, match="shape"):
        values_from_jax(tcp, [a[:-1] for a in arrays], jcp.pools)
    with pytest.raises(ValueError, match="pools"):
        values_from_jax(tcp, arrays[:-1], jcp.pools)
    with pytest.raises(ValueError, match="manifold"):
        values_from_jax(tcp, arrays, jcp.pools[::-1])


def test_not_ported_variant(setup):
    with pytest.raises(NotImplementedError, match="ROADMAP A.3"):
        SchurContext(setup[3], variant="sparse")
