"""Gauss-Newton and DogLeg of the port against apex_tpu, on the CPU in f64:
the dog-leg step function case by case (rtol 1e-12), then whole solves
(same iterations and status, final cost to rtol 1e-8) on Rosenbrock and on
the SE2 and SE3 graphs of tests/test_optimizers.py, with the dense and the
banded Hessian, the Schur fallback and the QR tier."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu as jax_apx
import apex_tpu_torch as apx
from apex_tpu.ba import build_ba_problem as jax_build
from apex_tpu.factors.base import AutoDiffFactor
from apex_tpu.io import synthetic as jax_synthetic
from apex_tpu.optim.dogleg import _dogleg_step as jax_dogleg_step
from apex_tpu_torch.ba import build_ba_problem
from apex_tpu_torch.factors.base import AutoDiffFactor as PortAutoDiffFactor
from apex_tpu_torch.factors.base import Factor
from apex_tpu_torch.io import synthetic
from apex_tpu_torch.optim.dogleg import _dogleg_step
from chip_smoke import autodiff_rosenbrock
from test_torch_jit import one_thread  # noqa: F401 (autouse: one BLAS thread per module)

# -- the step function ----------------------------------------------------------

_G = np.array([3.0, -1.0, 2.0, 0.5])
_GN = np.array([-1.0, 0.4, -0.9, -0.1])
_CAUCHY = -0.05 * _G
STEP_CASES = {
    # (g, dx_gn, cauchy, delta)
    "gauss_newton_inside": (_G, _GN, _CAUCHY, 10.0),
    "steepest_descent_to_boundary": (_G, _GN, _CAUCHY, 0.1),
    "interpolated": (_G, _GN, _CAUCHY, 0.8),
    "interpolated_b_positive": (_G, 3.0 * _CAUCHY + np.array([0.0, 0.0, 0.0, 1.0]), _CAUCHY, 0.4),
    "zero_gradient": (np.zeros(4), np.zeros(4), np.zeros(4), 1.0),
    "zero_gradient_far_gn": (np.zeros(4), _GN, np.zeros(4), 0.5),
    "a_zero": (_G, _CAUCHY, _CAUCHY, 0.15),  # gn == cauchy: v = 0
    "d2_negative": (_G, np.array([5.0, 5.0, 5.0, 5.0]), np.array([0.3, 0.0, 0.0, 0.0]), 0.2999),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_dogleg_step_matches_apex_tpu(case):
    g, gn, cauchy, delta = STEP_CASES[case]
    want = np.asarray(jax_dogleg_step(jnp.asarray(g), jnp.asarray(gn), jnp.asarray(cauchy),
                                      jnp.asarray(delta)))
    got = _dogleg_step(torch.from_numpy(g), torch.from_numpy(gn), torch.from_numpy(cauchy),
                       delta)
    assert got.dtype == torch.float64 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-300)
    if case != "zero_gradient_far_gn":  # there g = 0 gives no direction to scale
        assert float(got.norm()) <= delta * (1 + 1e-12) or case == "gauss_newton_inside"


def test_dogleg_step_f32_stays_f32():
    g, gn, cauchy, delta = STEP_CASES["interpolated"]
    got = _dogleg_step(*(torch.from_numpy(a).float() for a in (g, gn, cauchy)), delta)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.norm()), delta, rtol=1e-6)


# -- Rosenbrock: a custom factor -------------------------------------------------


class JaxRosenbrock(AutoDiffFactor):
    """r = [10 (y - x^2), 1 - x] over one R2 variable, as
    tests/test_optimizers.py has it."""

    kind = "rosenbrock"

    def signature(self):
        return ("rosenbrock",)

    def var_manifolds(self):
        return ["R2"]

    def residual_dim(self):
        return 2

    def data(self):
        return {}

    @classmethod
    def residual(cls, manifolds, data, params):
        x, y = params[0][..., 0], params[0][..., 1]
        return jnp.stack([10.0 * (y - x * x), 1.0 - x], axis=-1)


class Rosenbrock(Factor):
    """The same factor in the port, with its analytic Jacobian."""

    kind = "rosenbrock"

    def signature(self):
        return ("rosenbrock",)

    def var_manifolds(self):
        return ["R2"]

    def residual_dim(self):
        return 2

    @classmethod
    def linearize(cls, manifolds, data, params, compute_jacobian):
        x, y = params[0][..., 0], params[0][..., 1]
        r = torch.stack([10.0 * (y - x * x), 1.0 - x], dim=-1)
        if not compute_jacobian:
            return r, None
        zero, one = torch.zeros_like(x), torch.ones_like(x)
        J = torch.stack([torch.stack([-20.0 * x, 10.0 * one], dim=-1),
                         torch.stack([-one, zero], dim=-1)], dim=-2)
        return r, [J]


# the same factor in the port through ``AutoDiffFactor``: its residual only,
# the Jacobian by ``torch.func`` (the card's ``lie_small`` phase solves it)
AutoDiffRosenbrock = autodiff_rosenbrock()


def _rosenbrock(pkg, factor):
    p = pkg.Problem()
    p.add_variable("xy", "R2", np.array([-1.2, 1.0]))
    p.add_residual_block(["xy"], factor())
    return p


def _compile(pkg, problem):
    if pkg is apx:
        return problem.compile(dtype=torch.float64, device="cpu")
    return problem.compile(dtype=np.float64)


def _make(pkg, kind, **kw):
    if kind == "gn":
        return pkg.GaussNewton(pkg.GaussNewtonConfig(**kw))
    if kind == "dl":
        return pkg.DogLeg(pkg.DogLegConfig(**kw))
    return pkg.LevenbergMarquardt(pkg.LevenbergMarquardtConfig(**kw))


def _assert_same_solve(rt, rj, rtol=1e-8):
    assert rt.iterations == rj.iterations
    assert rt.status == apx.Status(int(rj.status))
    assert (rt.successful_steps, rt.unsuccessful_steps) == (
        rj.successful_steps, rj.unsuccessful_steps)
    np.testing.assert_allclose(rt.initial_cost, rj.initial_cost, rtol=1e-12)
    np.testing.assert_allclose(rt.final_cost, rj.final_cost, rtol=rtol, atol=1e-25)


@pytest.mark.parametrize("kind,iterations", [("gn", 100), ("dl", 200), ("lm", 100)])
def test_rosenbrock_matches_apex_tpu(kind, iterations):
    rj = _make(jax_apx, kind, max_iterations=iterations).optimize(
        _compile(jax_apx, _rosenbrock(jax_apx, JaxRosenbrock)))
    solver = _make(apx, kind, max_iterations=iterations)
    rt = solver.optimize(_compile(apx, _rosenbrock(apx, Rosenbrock)))
    assert rt.converged
    _assert_same_solve(rt, rj)
    np.testing.assert_allclose(rt.variables["xy"], [1.0, 1.0], atol=1e-6)
    np.testing.assert_allclose(rt.variables["xy"], rj.variables["xy"], rtol=1e-8)
    if kind == "dl":
        # the initial radius of 1e4 is far too wide: the first steps are
        # rejected, each retried from the cache with a halved radius
        assert rt.unsuccessful_steps > 10 and solver.reused_steps > 10


@pytest.mark.parametrize("kind,iterations", [("gn", 100), ("dl", 200), ("lm", 100)])
def test_autodiff_rosenbrock_matches_apex_tpu(kind, iterations):
    """The port's ``AutoDiffFactor`` Rosenbrock against the JAX package's:
    the same solve, iteration for iteration."""
    rj = _make(jax_apx, kind, max_iterations=iterations).optimize(
        _compile(jax_apx, _rosenbrock(jax_apx, JaxRosenbrock)))
    rt = _make(apx, kind, max_iterations=iterations).optimize(
        _compile(apx, _rosenbrock(apx, AutoDiffRosenbrock)))
    assert rt.converged
    _assert_same_solve(rt, rj)
    np.testing.assert_allclose(rt.variables["xy"], rj.variables["xy"], rtol=1e-8)


class _AutoDiffBetween(PortAutoDiffFactor):
    """An SE3 between residual written as an ``AutoDiffFactor``: two slots,
    a right perturbation on a Lie group, and per-block data."""

    kind = "autodiff_between"

    def __init__(self, meas):
        self.meas = np.asarray(meas, dtype=np.float64)

    def signature(self):
        return ("autodiff_between",)

    def var_manifolds(self):
        return ["SE3", "SE3"]

    def residual_dim(self):
        return 6

    def data(self):
        return {"meas": self.meas}

    @classmethod
    def residual(cls, manifolds, data, params):
        G = manifolds[0]
        return G.log(G.compose(G.between(params[1], params[0]), data["meas"]))


def test_autodiff_factor_jacobians_match_the_closed_form():
    """Slot Jacobians of the autodiff between factor equal the closed-form
    ``BetweenFactor``'s (rtol 1e-10) on a batch of blocks."""
    from apex_tpu_torch.factors import BetweenFactor
    from apex_tpu_torch.manifolds import SE3

    rng = np.random.default_rng(4)
    xi, xj, meas = (SE3.exp(torch.from_numpy(rng.normal(size=(9, 6)) * 0.5)) for _ in range(3))
    r, jacs = _AutoDiffBetween.linearize([SE3, SE3], {"meas": meas}, [xi, xj], True)
    r_ref, jacs_ref = BetweenFactor.linearize([SE3, SE3], {"meas": meas}, [xi, xj], True)
    np.testing.assert_allclose(r.numpy(), r_ref.numpy(), rtol=1e-12, atol=1e-14)
    for got, want in zip(jacs, jacs_ref):
        assert got.shape == (9, 6, 6)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10, atol=1e-12)
    # f32 blocks give f32 Jacobians
    r32, jacs32 = _AutoDiffBetween.linearize([SE3, SE3], {"meas": meas.float()},
                                             [xi.float(), xj.float()], True)
    assert r32.dtype == torch.float32 and all(j.dtype == torch.float32 for j in jacs32)
    np.testing.assert_allclose(jacs32[0].double().numpy(), jacs[0].numpy(), rtol=1e-3,
                               atol=1e-4)


def test_masked_autodiff_step_reads_nothing():
    """LM steps of the autodiff Rosenbrock in the warm-up form of jit mode,
    under a dispatch mode that fails on any host read: ``AutoDiffFactor``'s
    ``jacfwd`` under ``vmap`` can be captured. Equal to the jit solve."""
    from test_torch_jit import _masked_solve

    cp = _compile(apx, _rosenbrock(apx, AutoDiffRosenbrock))
    rj = _make(apx, "lm", max_iterations=5, mode="jit").optimize(cp)
    st = _masked_solve(_make(apx, "lm", max_iterations=5, mode="jit"), cp, 5)
    assert int(st["iteration"]) == rj.iterations == 5
    np.testing.assert_allclose(float(st["cost"]), rj.final_cost, rtol=1e-12)


# -- pose graphs ----------------------------------------------------------------

GRAPHS = {
    "ring60": ("synthetic_pose_graph_2d", dict(n_poses=60, trajectory="ring", seed=8)),
    "sphere48": ("synthetic_pose_graph_3d", dict(n_poses=48, rings=4, seed=10)),
    "ring50": ("synthetic_pose_graph_2d", dict(n_poses=50, loop_stride=5, seed=9)),
}


def _graph_problems(name, **kw):
    fn, args = GRAPHS[name]
    return (getattr(jax_synthetic, fn)(**args).to_problem(**kw),
            getattr(synthetic, fn)(**args).to_problem(**kw))


@pytest.fixture(scope="module")
def lm_costs():
    """LM's final cost per graph, from the port (held to apex_tpu by the
    e2e files)."""
    return {name: apx.LevenbergMarquardt().optimize(
        _compile(apx, _graph_problems(name)[1])).final_cost for name in ("ring60", "sphere48")}


@pytest.mark.parametrize("solver", ["dense_cholesky", "sparse_cholesky"])
@pytest.mark.parametrize("kind", ["gn", "dl"])
@pytest.mark.parametrize("graph", ["ring60", "sphere48"])
def test_pose_graph_matches_apex_tpu(graph, kind, solver, lm_costs):
    """Gauge-free graphs: Gauss-Newton's undamped H is singular, and the
    retry ladders of both packages carry the step. Held to apex_tpu with the
    dense Hessian on the SE2 graph and the banded one on the SE3 graph (each
    JAX solve compiles for seconds); every combination to LM's optimum."""
    pj, pt = _graph_problems(graph)
    rt = _make(apx, kind, linear_solver_type=solver).optimize(_compile(apx, pt))
    assert rt.converged and rt.unsuccessful_steps == 0
    if (graph, solver) in (("ring60", "dense_cholesky"), ("sphere48", "sparse_cholesky")):
        rj = _make(jax_apx, kind, linear_solver_type=solver).optimize(_compile(jax_apx, pj))
        _assert_same_solve(rt, rj)
    # tests/test_optimizers.py: every optimizer reaches LM's optimum
    np.testing.assert_allclose(rt.final_cost, lm_costs[graph], rtol=1e-6)


@pytest.mark.parametrize("kind,iterations", [("dl", 40), ("gn", 25)])
def test_sparse_qr_matches_apex_tpu(kind, iterations):
    pj, pt = _graph_problems("ring50", fix_first=True)
    kw = dict(linear_solver_type="sparse_qr", max_iterations=iterations)
    rj = _make(jax_apx, kind, **kw).optimize(_compile(jax_apx, pj))
    rt = _make(apx, kind, **kw).optimize(_compile(apx, pt))
    assert rt.converged and rt.final_cost < 0.1 * rt.initial_cost
    _assert_same_solve(rt, rj)


def test_gauss_newton_jacobi_scaling_and_pcg():
    """The options Gauss-Newton hands to LM's solve functions."""
    pt = _graph_problems("ring50", fix_first=True)[1]
    ref = _make(apx, "gn").optimize(_compile(apx, pt))
    for kw in (dict(use_jacobi_scaling=True),
               dict(linear_solver_type="sparse_cholesky", use_jacobi_scaling=True),
               dict(linear_solver_type="pcg", pcg_tolerance=1e-12)):
        r = _make(apx, "gn", **kw).optimize(_compile(apx, pt))
        assert r.converged and r.unsuccessful_steps == 0
        np.testing.assert_allclose(r.final_cost, ref.final_cost, rtol=1e-6)


@pytest.fixture(scope="module")
def ba_dogleg():
    """DogLeg on a small BA problem: apex_tpu's first 8 iterations, and the
    port's whole dense_cholesky and sparse_cholesky solves."""
    ds = synthetic.synthetic_ba(n_cameras=6, n_points=80, seed=3)
    rj = _make(jax_apx, "dl", max_iterations=8).optimize(_compile(jax_apx, jax_build(ds)))
    tcp = _compile(apx, build_ba_problem(ds))
    refs = {solver: _make(apx, "dl", linear_solver_type=solver, max_iterations=100).optimize(tcp)
            for solver in ("dense_cholesky", "sparse_cholesky")}
    return tcp, rj, refs


def test_dogleg_ba_matches_apex_tpu(ba_dogleg):
    """Self-calibration leaves the scale free, and DogLeg's mu falls by 5x
    per good step, so the step's conditioning grows until rounding decides
    the path (from iteration 8 on here): the first 8 iterations are held to
    apex_tpu."""
    tcp, rj, refs = ba_dogleg
    rt = _make(apx, "dl", max_iterations=8).optimize(tcp)
    _assert_same_solve(rt, rj)
    assert refs["dense_cholesky"].final_cost < 0.1 * refs["dense_cholesky"].initial_cost


@pytest.mark.parametrize("solver", ["schur_implicit", "sparse_schur_complement", "schur",
                                    "schur_explicit", "schur_auto", "iterative_schur"])
def test_dogleg_schur_name_falls_back_to_cholesky(ba_dogleg, solver):
    """Every Schur name runs a Cholesky tier instead of raising: the banded
    one here (294 DOF fit one panel), so sparse_cholesky's very trajectory,
    and dense_cholesky's cost to rtol 1e-5 (tests/test_optimizers.py)."""
    tcp, _, refs = ba_dogleg
    res = _make(apx, "dl", linear_solver_type=solver, max_iterations=100).optimize(tcp)
    ref = refs["sparse_cholesky"]
    assert (res.status, res.iterations) == (ref.status, ref.iterations)
    np.testing.assert_allclose(res.final_cost, ref.final_cost, rtol=1e-12)
    np.testing.assert_allclose(res.final_cost, refs["dense_cholesky"].final_cost, rtol=1e-5)


def test_dogleg_schur_name_on_a_wide_band_takes_dense():
    """Above a block bandwidth of 1536 the fallback is dense_cholesky."""
    ds = synthetic.synthetic_ba_large(n_cameras=12, n_points=800, obs_per_camera=140, seed=2)
    tcp = _compile(apx, build_ba_problem(ds))
    from apex_tpu_torch.linalg import banded

    assert banded.block_bandwidth(tcp) > banded.MAX_BANDWIDTH
    assemble, *_ = _make(apx, "dl", linear_solver_type="schur")._hessian_functions(tcp)
    (H,), g, _ = assemble(tcp.initial_values())
    assert H.shape == (tcp.total_dof, tcp.total_dof) and g.shape == (tcp.total_dof,)
    runs = [_make(apx, "dl", linear_solver_type=s, max_iterations=1).optimize(tcp)
            for s in ("schur", "dense_cholesky")]
    assert runs[0].final_cost == runs[1].final_cost < runs[0].initial_cost


@pytest.mark.parametrize("solver", ["pcg", "sparse_general", "sparse_schur"])
def test_dogleg_other_solvers_raise(solver):
    pt = _graph_problems("ring50")[1]
    with pytest.raises(NotImplementedError, match="DogLeg supports"):
        _make(apx, "dl", linear_solver_type=solver).optimize(_compile(apx, pt))


def test_dogleg_without_step_reuse_takes_the_same_path():
    """A reused step equals a fresh linearization at the unmoved point, so
    switching the cache off changes no iterate."""
    runs = []
    for reuse in (True, False):
        solver = _make(apx, "dl", max_iterations=200, enable_step_reuse=reuse)
        runs.append((solver, solver.optimize(_compile(apx, _rosenbrock(apx, Rosenbrock)))))
    (s1, r1), (s2, r2) = runs
    assert s1.reused_steps > 10 and s2.reused_steps == 0
    assert (r1.iterations, r1.unsuccessful_steps) == (r2.iterations, r2.unsuccessful_steps)
    np.testing.assert_allclose(r1.variables["xy"], r2.variables["xy"], rtol=1e-14)


def test_dogleg_jit_reuses_steps_as_python_mode():
    """Rosenbrock, whose first DogLeg steps are rejected and retried from
    the cache: jit mode takes its fresh/reuse branch on the device and
    counts the reused steps there, python mode's count and trajectory;
    the JAX package's jit solve takes the same iterations and steps."""
    runs = {}
    for mode in ("python", "jit"):
        solver = _make(apx, "dl", max_iterations=200, mode=mode)
        runs[mode] = solver, solver.optimize(_compile(apx, _rosenbrock(apx, Rosenbrock)))
    (sp, rp), (sj, rj) = runs["python"], runs["jit"]
    assert sp.reused_steps > 10 and sj.reused_steps == sp.reused_steps
    assert (rj.iterations, rj.status, rj.unsuccessful_steps) == (
        rp.iterations, rp.status, rp.unsuccessful_steps)
    np.testing.assert_allclose(rj.variables["xy"], rp.variables["xy"], rtol=1e-12)
    rx = _make(jax_apx, "dl", max_iterations=200, mode="jit").optimize(
        _compile(jax_apx, _rosenbrock(jax_apx, JaxRosenbrock)))
    _assert_same_solve(rj, rx)


def test_dogleg_stats_and_covariances():
    pt = _graph_problems("ring50", fix_first=True)[1]
    res = _make(apx, "dl", collect_stats=True, compute_covariances=True).optimize(
        _compile(apx, pt))
    assert len(res.iteration_stats) == res.iterations
    assert res.iteration_stats[0].tr_radius >= 1e4  # the trust region, not a damping
    assert set(res.covariances) == set(res.variables)
    assert np.abs(res.covariances["x0"]).max() == 0.0
    assert "tr_radius" in apx.optim.IterationStats.HEADER


def test_modes_and_exports():
    assert apx.GaussNewton is apx.optim.GaussNewton and apx.DogLeg is apx.optim.DogLeg
    assert {"GaussNewton", "GaussNewtonConfig", "DogLeg", "DogLegConfig"} <= set(apx.__all__)
    pt = _graph_problems("ring50")[1]
    # GN and DogLeg run in jit mode, as python mode does
    for kind in ("gn", "dl"):
        rp, rj = (_make(apx, kind, mode=mode).optimize(_compile(apx, pt))
                  for mode in ("python", "jit"))
        assert (rj.iterations, rj.status) == (rp.iterations, rp.status)
        np.testing.assert_allclose(rj.final_cost, rp.final_cost, rtol=1e-12)
    # the configs carry the JAX package's fields and defaults
    for name in ("GaussNewtonConfig", "DogLegConfig"):
        jcfg, tcfg = getattr(jax_apx, name)(), getattr(apx, name)()
        assert vars(jcfg) == vars(tcfg)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lm_damping_update_matches_jax_bitwise(dtype):
    """LM's damping and nu updates in the problem's dtype: over a grid of
    (damping, nu, rho) the port's update, numpy form (python mode) and
    tensor form (jit mode), equals the JAX package's step
    (apex_tpu/optim/lm.py, the lines from ``coff`` to ``new_nu``, jitted)
    bit for bit, in f32 and in f64."""
    import jax

    from apex_tpu_torch.optim.lm import damping_update, damping_update_t

    cfg = apx.LevenbergMarquardtConfig()

    @jax.jit
    def jax_update(damping, nu, rho):
        accepted = rho > 0.0
        coff = 2.0 * rho - 1.0
        damping_acc = jnp.clip(damping * jnp.maximum(1.0 / 3.0, 1.0 - coff**3),
                               cfg.damping_min, cfg.damping_max)
        damping_rej = jnp.minimum(damping * nu, cfg.damping_max)
        return (jnp.where(accepted, damping_acc, damping_rej),
                jnp.where(accepted, 2.0, nu * 2.0))

    grid = np.stack(np.meshgrid(
        [1e-13, 2.4e-10, 3.7e-3, 0.77, 5e11, 1e12],
        [2.0, 16.0, 2.0 ** 40],
        [-1.3, -1e-9, 0.0, 1e-7, 0.1234567, 0.5, 0.7314, 0.999999, 1.0, 1.5, 37.0],
        indexing="ij"), axis=-1).reshape(-1, 3).astype(dtype)
    jd, jn = (np.asarray(a) for a in jax_update(*(jnp.asarray(c) for c in grid.T)))
    assert jd.dtype == jn.dtype == dtype
    for (damping, nu, rho), ref_d, ref_n in zip(grid, jd, jn):
        d, n = damping_update(damping, nu, rho, bool(rho > 0.0), cfg)
        assert type(d) is type(n) is dtype
        assert d.tobytes() == ref_d.tobytes() and n.tobytes() == ref_n.tobytes(), (
            damping, nu, rho, d, ref_d)
    # jit mode's tensor form, over the whole grid at once
    td, tn, trho = (torch.from_numpy(np.ascontiguousarray(c)) for c in grid.T)
    d, n = damping_update_t(td, tn, trho, trho > 0.0, cfg)
    assert d.numpy().tobytes() == jd.tobytes() and n.numpy().tobytes() == jn.tobytes()
