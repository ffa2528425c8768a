"""Lens self-calibration through the port's camera models against the JAX
package's (``tests/test_camera_selfcal.py``), on the CPU in f64: the same
scene, noise and perturbations, one intrinsics variable shared by all six
views, ``HuberLoss(2.0)``, the gauge fixes; LM through ``schur_implicit``
with that file's config, in python and in jit mode, for all 7 models, and
DogLeg with covariances for the pinhole. Each holds the JAX solve's
iterations and status, its final cost to rtol 1e-8 and its intrinsics.
Then the masked form of a jit step (what the card warms up before a CUDA
graph is captured) runs the extended camera's group kernel with no host
read.

The JAX reference solves run once per module (3-10 s each)."""

import numpy as np
import pytest
import torch

import apex_tpu as jax_apx
import apex_tpu_torch as apx
from chip_smoke import selfcal_problem, selfcal_scene
from test_camera_selfcal import MODELS, build_problem, make_scene
from test_torch_jit import _masked_solve
from test_torch_jit import one_thread  # noqa: F401 (autouse: one BLAS thread per module)

OPTIMIZE = ("pose", "landmark", "intrinsics")
# tests/test_camera_selfcal.py's LM config
LM = dict(linear_solver_type="schur_implicit", max_iterations=60, pcg_tolerance=1e-8,
          pcg_max_iterations=400)
DOGLEG = dict(max_iterations=40, compute_covariances=True)


def port_problem(model_name, intr_true):
    """The port's twin of ``build_problem`` for the self-calibration case:
    ``chip_smoke.py``'s ``selfcal_problem`` (which the card's ``camera_parity`` phase
    runs), the same scene and draws from the same seeds in the same order
    (``test_port_scene_is_the_reference_scene``)."""
    return selfcal_problem(model_name, intr_true, *selfcal_scene())


@pytest.fixture(scope="module")
def jax_solves():
    """The JAX package's solve of each model (and ``"dogleg"``), once per
    module: (result, observations)."""
    done = {}

    def get(key):
        if key not in done:
            model = "pinhole" if key == "dogleg" else key
            problem, n_obs, _ = build_problem(model, MODELS[model], OPTIMIZE)
            if key == "dogleg":
                from apex_tpu.optim.dogleg import DogLeg, DogLegConfig

                res = DogLeg(DogLegConfig(**DOGLEG)).optimize(problem)
            else:
                res = jax_apx.LevenbergMarquardt(
                    jax_apx.LevenbergMarquardtConfig(**LM)).optimize(problem)
            done[key] = res, n_obs
        return done[key]

    return get


@pytest.fixture(scope="module")
def port_problems():
    done = {}

    def get(model):
        if model not in done:
            done[model] = port_problem(model, MODELS[model])
        return done[model]

    return get


def _assert_same_intrinsics(rt, rj):
    """Focal lengths and principal point to rtol 1e-6, the distortion
    parameters to 1e-6 absolute: PCG's 1e-8 tolerance leaves the weakly
    observed distortion directions free at that level (rad_tan's k3 ends
    7e-8 apart, 1.3e-5 relative, with the costs 8e-11 apart)."""
    it, ij = np.asarray(rt.variables["intr_shared"]), np.asarray(rj.variables["intr_shared"])
    np.testing.assert_allclose(it[:4], ij[:4], rtol=1e-6)
    np.testing.assert_allclose(it[4:], ij[4:], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["python", "jit"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_selfcal_matches_apex_tpu(model, mode, jax_solves, port_problems):
    rj, n_obs = jax_solves(model)
    problem, n_port = port_problems(model)
    assert n_port == n_obs
    rt = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(mode=mode, **LM)).optimize(
        problem.compile(dtype=torch.float64, device="cpu"))
    assert rt.iterations == rj.iterations
    assert rt.status == apx.Status(int(rj.status))
    np.testing.assert_allclose(rt.initial_cost, rj.initial_cost, rtol=1e-12)
    np.testing.assert_allclose(rt.final_cost, rj.final_cost, rtol=1e-8)
    _assert_same_intrinsics(rt, rj)
    # the JAX test's own gates
    assert np.sqrt(rt.final_cost / n_port) < 1.0
    assert rt.final_cost < 0.5 * rt.initial_cost
    np.testing.assert_allclose(rt.variables["intr_shared"][0], MODELS[model][0], rtol=0.01)


def test_selfcal_dogleg_covariance_matches_apex_tpu(jax_solves, port_problems):
    """DogLeg with covariances on the pinhole scene: the JAX solve's
    iterations, cost (rtol 1e-8) and the shared intrinsics' covariance
    block (rtol 1e-6)."""
    rj, _ = jax_solves("dogleg")
    problem, _ = port_problems("pinhole")
    rt = apx.DogLeg(apx.DogLegConfig(**DOGLEG)).optimize(
        problem.compile(dtype=torch.float64, device="cpu"))
    assert rt.iterations == rj.iterations
    assert rt.status == apx.Status(int(rj.status))
    np.testing.assert_allclose(rt.final_cost, rj.final_cost, rtol=1e-8)
    cov, cov_j = rt.covariances["intr_shared"], np.asarray(rj.covariances["intr_shared"])
    assert cov.shape == cov_j.shape == (4, 4)
    np.testing.assert_allclose(cov, cov_j, rtol=1e-6, atol=1e-6 * np.abs(cov_j).max())
    np.testing.assert_allclose(cov, cov.T, atol=1e-8 * np.abs(cov).max())
    assert (np.diag(cov) > 0).all()


def test_port_scene_is_the_reference_scene():
    """The port's scene is ``make_scene``'s, and its problem holds the JAX
    ``build_problem``'s variables and initial values (the same draws in the same
    order)."""
    for got, want in zip(selfcal_scene(), make_scene()):
        np.testing.assert_array_equal(got, want)
    for model in ("pinhole", "kannala_brandt", "double_sphere"):
        jp, n_obs, _ = build_problem(model, MODELS[model], OPTIMIZE)
        tp, n_port = port_problem(model, MODELS[model])
        assert n_port == n_obs
        cj, ct = jp.compile(dtype=np.float64), tp.compile(dtype=torch.float64, device="cpu")
        for pj, pt in zip(cj.pools, ct.pools):
            assert list(pj.names) == list(pt.names)
            np.testing.assert_allclose(pt.values0.numpy(), np.asarray(pj.values0), rtol=1e-13,
                                       atol=1e-13)


@pytest.mark.parametrize("model", ["kannala_brandt", "double_sphere"])
def test_masked_selfcal_step_reads_nothing(model):
    """Three LM steps of a self-calibration problem through
    ``schur_implicit`` in the warm-up form, under a dispatch mode that fails
    on any host read: the autodiff camera Jacobians (``torch.func`` under
    ``vmap``) can be captured. Equal to the jit solve's first three
    iterations (rtol 1e-12)."""
    problem, _ = port_problem(model, MODELS[model])
    cp = problem.compile(dtype=torch.float64, device="cpu")
    cfg = dict(LM, max_iterations=3)
    st = _masked_solve(apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(mode="jit", **cfg)),
                       cp, 3)
    rj = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(mode="jit", **cfg)).optimize(cp)
    assert int(st["iteration"]) == rj.iterations == 3
    np.testing.assert_allclose(float(st["cost"]), rj.final_cost, rtol=1e-12)

