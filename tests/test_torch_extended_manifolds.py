"""The extended Lie groups of the port (SE23 with closed-form Jacobians,
Sim3 and SGal3 with exact ``torch.func`` autodiff ones) against the JAX
package's, on the CPU in f64: the group operations and the four tangent
Jacobians at random and small-angle tangents (rtol 1e-10), the chain of
``tests/test_extended_manifolds_e2e.py`` solved by LM through both packages
(same iterations, variables within 1e-8), the masked jit step of a Sim3
between factor with no host read; then the operations this slice adds to
every group (``hat``, ``interpolate``, ``act_j``, ``to_matrix`` /
``from_matrix``, ``plus_j``, ``is_valid``, ``random``), the registry and
``values_from_jax`` on the new pools."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu as jax_apx
import apex_tpu_torch as apx
from apex_tpu import manifolds as jax_manifolds
from apex_tpu.manifolds import se3 as jse3
from apex_tpu.manifolds import so3 as jso3
from apex_tpu_torch import manifolds
from apex_tpu_torch.convert import values_from_jax
from apex_tpu_torch.factors import BetweenFactor
from apex_tpu_torch.manifolds import se3 as tse3
from apex_tpu_torch.manifolds import so3 as tso3
from test_torch_jit import _masked_solve
from test_torch_jit import one_thread  # noqa: F401 (autouse: one BLAS thread per module)

EXTENDED = ["SE23", "Sim3", "SGal3"]
BASIC = ["SO2", "SE2", "SO3", "SE3", "R4"]
ALL = BASIC + EXTENDED
TOL = dict(rtol=1e-10, atol=1e-12)
# the rotation part of each tangent: SGal3's tangent is [rho, nu, theta, s]
ROT = {"SE23": slice(3, 6), "Sim3": slice(3, 6), "SGal3": slice(6, 9)}


N = 16  # rows of every batch: one shape per group keeps JAX's op caches warm


def _tangents(gname, seed=0):
    """Random tangents, a quarter (Sim3) or half (SE23, SGal3) of them in
    each regime: "random"; "small_angle", the rotation part in the
    small-angle branches (|theta| ~ 1e-7); for Sim3 also "small_scale"
    (sigma ~ 1e-12) and both. Sim3's sigma between 1e-10 and 1e-5, where
    the scale terms cancel, has a test of its own
    (``test_sim3_scale_band_matches_apex_tpu``)."""
    G = manifolds.get(gname)
    t = np.random.default_rng(seed).normal(size=(N, G.dof)) * 0.7
    parts = 4 if gname == "Sim3" else 2
    rows = np.arange(N) % parts
    t[np.ix_(rows % 2 == 1, np.arange(G.dof)[ROT[gname]])] *= 1e-7
    if gname == "Sim3":
        t[rows >= 2, 6] *= 1e-12
    return t


def _elements(gname, seed=1, n=N):
    """Group elements as Exp of random tangents, through the JAX package."""
    t = np.random.default_rng(seed).normal(size=(n, manifolds.get(gname).dof)) * 0.7
    return np.array(jax_manifolds.get(gname).exp(jnp.asarray(t)))


def _both(gname):
    return jax_manifolds.get(gname), manifolds.get(gname)


def _close(got, want, **tol):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _close(g, w, **tol)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


# op: (arguments, tolerance); t: tangents, x / y: elements, p: points
OPS = {
    "exp": ("t", TOL), "log": ("x", TOL), "compose": ("xy", TOL), "inverse": ("x", TOL),
    "adjoint": ("x", TOL), "minus": ("xy", TOL),
    "normalize": ("x", TOL), "act": ("xp", TOL), "hat": ("t", TOL),
    "interpolate": ("xya", TOL), "between_j": ("xy", TOL),
    "rjac": ("t", dict(rtol=1e-10, atol=1e-11)), "ljac": ("t", dict(rtol=1e-10, atol=1e-11)),
    "rjac_inv": ("t", dict(rtol=1e-10, atol=1e-11)),
    "ljac_inv": ("t", dict(rtol=1e-10, atol=1e-11)),
    "plus_j": ("xt", dict(rtol=1e-10, atol=1e-11)),
}


def _args(gname, kinds, pkg):
    arrays = {"t": _tangents(gname), "x": _elements(gname, 1), "y": _elements(gname, 2),
              "p": np.random.default_rng(3).normal(size=(N, 3))}
    conv = jnp.asarray if pkg == "jax" else torch.from_numpy
    return [0.3 if k == "a" else conv(arrays[k]) for k in kinds]


def _call(G, op, args):
    return getattr(G, op)(*args)


@pytest.fixture(scope="module")
def jax_ops():
    """The JAX package's value of each (group, op), once per module."""
    done = {}

    def get(gname, op):
        if (gname, op) not in done:
            done[gname, op] = _call(jax_manifolds.get(gname), op,
                                    _args(gname, OPS[op][0], "jax"))
        return done[gname, op]

    return get


@pytest.mark.parametrize("op", list(OPS))
@pytest.mark.parametrize("gname", EXTENDED)
def test_operation_matches_apex_tpu(gname, op, jax_ops):
    """Each group operation, tangent Jacobian and derived Jacobian of SE23,
    Sim3 and SGal3 at the same inputs as the JAX package's."""
    kinds, tol = OPS[op]
    got = _call(manifolds.get(gname), op, _args(gname, kinds, "torch"))
    _close(got, jax_ops(gname, op), **tol)


# Sim3 tangents whose sigma lies where the V matrix's scale terms cancel:
# (e^sigma - 1) / sigma loses log10(1 / |sigma|) digits, and its derivative
# in the autodiff Jacobians 2 log10(1 / |sigma|). Both packages evaluate
# the same expressions, so one last-place difference between XLA's and
# torch's exp shows up magnified by eps / |sigma| (exp) or eps / sigma^2
# (Jacobians). Over this test's 1,000 tangents the port's rows stayed
# within 0.53 eps / |sigma| (exp) and 0.90 eps / sigma^2 (the four
# Jacobians) of the JAX package's, relative to each row's largest entry,
# and log within 2 eps; below |sigma| ~ 1e-8 that bound exceeds the
# Jacobian itself, in both packages alike (ROADMAP C).
BAND_GROWTH = {"exp": 1, "log": 0, "rjac": 2, "ljac": 2, "rjac_inv": 2, "ljac_inv": 2}
N_BAND = 1000


def _band_tangents(seed=4):
    """Sim3 tangents with |sigma| log-uniform in (1e-10, 1e-5) and either
    sign, every second one with its rotation part in the small-angle
    branches."""
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(N_BAND, 7)) * 0.7
    t[1::2, 3:6] *= 1e-7
    t[:, 6] = 10.0 ** rng.uniform(-10, -5, N_BAND) * rng.choice([-1.0, 1.0], N_BAND)
    return t


@pytest.mark.parametrize("op", list(BAND_GROWTH))
def test_sim3_scale_band_matches_apex_tpu(op):
    """Sim3's exp, log and tangent Jacobians with sigma in (1e-10, 1e-5)
    against the JAX package's: each row within 4 eps / |sigma|^k of its
    largest entry (k from ``BAND_GROWTH``; 1e-10 where that is smaller)."""
    Gj, Gt = _both("Sim3")
    t = _band_tangents()
    if op == "log":
        x = np.asarray(Gj.exp(jnp.asarray(t)))
        got, want = Gt.log(torch.from_numpy(x)).numpy(), np.asarray(Gj.log(jnp.asarray(x)))
    else:
        got = getattr(Gt, op)(torch.from_numpy(t)).numpy()
        want = np.asarray(getattr(Gj, op)(jnp.asarray(t)))
    eps = np.finfo(np.float64).eps
    rtol = np.maximum(1e-10, 4.0 * eps / np.abs(t[:, 6]) ** BAND_GROWTH[op])
    diff = np.abs(got - want).reshape(N_BAND, -1).max(axis=1)
    scale = np.abs(want).reshape(N_BAND, -1).max(axis=1)
    bad = diff > rtol * scale
    assert not bad.any(), (op, t[bad, 6], diff[bad] / scale[bad], rtol[bad])


@pytest.mark.parametrize("gname", EXTENDED)
def test_interpolate_ends(gname):
    T = manifolds.get(gname)
    x, y = (torch.from_numpy(_elements(gname, s)) for s in (1, 2))
    _close(T.interpolate(x, y, 0.0), x.numpy(), atol=1e-12)
    # the end is y up to the quaternion's sign
    _close(T.normalize(T.interpolate(x, y, 1.0)), T.normalize(y).numpy(), atol=1e-12)


def _chain(pkg, gname):
    """``tests/test_extended_manifolds_e2e.py``'s chain: 8 poses from the
    JAX package's random steps (the truth is the same array for both
    packages), noisy initial values from numpy, the first pose fixed, a
    between factor per step and a loop closure."""
    G = jax_manifolds.get(gname)
    rng = np.random.default_rng(1)
    n = 8
    truth = [np.asarray(G.identity())]
    for k in jax.random.split(jax.random.PRNGKey(0), n - 1):
        truth.append(np.asarray(G.plus(jnp.asarray(truth[-1]), 0.3 * jax.random.normal(
            k, (G.dof,)))))
    problem = pkg.Problem()
    for i, t in enumerate(truth):
        init = t if i == 0 else np.asarray(G.plus(jnp.asarray(t),
                                                  jnp.asarray(rng.normal(0, 0.05, G.dof))))
        problem.add_variable(f"x{i}", gname, init)
    problem.fix_variable("x0")
    for a, b in [(i, i + 1) for i in range(n - 1)] + [(0, n - 1)]:
        meas = np.asarray(G.between(jnp.asarray(truth[a]), jnp.asarray(truth[b])))
        problem.add_residual_block([f"x{a}", f"x{b}"], pkg.BetweenFactor(gname, meas))
    return problem, truth


@pytest.fixture(scope="module")
def chains():
    done = {}

    def get(gname):
        if gname not in done:
            jp, truth = _chain(jax_apx, gname)
            rj = jax_apx.LevenbergMarquardt(
                jax_apx.LevenbergMarquardtConfig(max_iterations=60)).optimize(jp)
            done[gname] = rj, _chain(apx, gname)[0], truth
        return done[gname]

    return get


@pytest.mark.parametrize("mode", ["python", "jit"])
@pytest.mark.parametrize("gname", EXTENDED)
def test_between_chain_matches_apex_tpu(gname, mode, chains):
    rj, problem, truth = chains(gname)
    rt = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
        max_iterations=60, mode=mode)).optimize(problem.compile(device="cpu"))
    assert rt.converged and rt.final_cost < 1e-12
    assert rt.iterations == rj.iterations
    assert rt.status == apx.Status(int(rj.status))
    T = manifolds.get(gname)
    for i, t in enumerate(truth):
        np.testing.assert_allclose(rt.variables[f"x{i}"], np.asarray(rj.variables[f"x{i}"]),
                                   rtol=1e-8, atol=1e-8)
        err = T.minus(torch.tensor(rt.variables[f"x{i}"]), torch.tensor(t))
        assert float(err.norm()) < 1e-5


@pytest.mark.parametrize("gname", ["Sim3", "SGal3"])
def test_autodiff_jacobians_keep_f32(gname):
    """The autodiff Jacobians and adjoint of an f32 tangent stay f32 (and
    near f64's): an f32 solve takes them."""
    T = manifolds.get(gname)
    t = torch.from_numpy(_tangents(gname))
    x = T.exp(t)
    for fn, arg in (("rjac", t), ("ljac", t), ("rjac_inv", t), ("ljac_inv", t),
                    ("adjoint", x)):
        got = getattr(T, fn)(arg.float())
        assert got.dtype == torch.float32, fn
        np.testing.assert_allclose(got.double().numpy(), getattr(T, fn)(arg).numpy(),
                                   rtol=1e-3, atol=1e-3)


def test_masked_sim3_step_reads_nothing(chains):
    """Three LM steps of the Sim3 chain in the warm-up form of jit mode,
    under a dispatch mode that fails on any host read: the autodiff
    Jacobians (``jacfwd`` under ``vmap``) and ``inv_ex`` can be captured.
    Equal to the python-mode solve's first three iterations."""
    _, problem, _ = chains("Sim3")
    cp = problem.compile(device="cpu")
    st = _masked_solve(apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
        max_iterations=3, mode="jit")), cp, 3)
    rp = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(max_iterations=3)).optimize(cp)
    assert int(st["iteration"]) == rp.iterations == 3
    np.testing.assert_allclose(float(st["cost"]), rp.final_cost, rtol=1e-12)


def test_sim3_between_linearize_matches_apex_tpu():
    """The Sim3 between factor's residual and slot Jacobians (autodiff
    rjac_inv through ``log_j``) against the JAX package's."""
    from apex_tpu.factors import BetweenFactor as JaxBetween

    xi, xj, meas = _elements("Sim3", 4), _elements("Sim3", 5), _elements("Sim3", 6)
    Gj, Gt = _both("Sim3")
    rj, jj = JaxBetween.linearize([Gj, Gj], {"meas": jnp.asarray(meas)},
                                  [jnp.asarray(xi), jnp.asarray(xj)], True)
    rt, jt = BetweenFactor.linearize([Gt, Gt], {"meas": torch.from_numpy(meas)},
                                     [torch.from_numpy(xi), torch.from_numpy(xj)], True)
    _close(rt, rj)
    for got, want in zip(jt, jj):
        _close(got, want, rtol=1e-10, atol=1e-11)


# -- the operations added to every group ---------------------------------------


@pytest.mark.parametrize("gname", BASIC)
def test_new_operations_match_apex_tpu(gname):
    J, T = _both(gname)
    t = np.random.default_rng(7).normal(size=(6, T.dof)) * 0.6
    x = np.asarray(J.exp(jnp.asarray(t)))
    y = np.asarray(J.exp(jnp.asarray(np.random.default_rng(8).normal(size=(6, T.dof)) * 0.6)))
    _close(T.hat(torch.from_numpy(t)), J.hat(jnp.asarray(t)))
    _close(T.interpolate(torch.from_numpy(x), torch.from_numpy(y), 0.25),
           J.interpolate(jnp.asarray(x), jnp.asarray(y), 0.25))
    for got, want in zip(T.plus_j(torch.from_numpy(x), torch.from_numpy(t)),
                         J.plus_j(jnp.asarray(x), jnp.asarray(t))):
        _close(got, want, rtol=1e-10, atol=1e-11)
    np.testing.assert_array_equal(T.is_valid(torch.from_numpy(x)).numpy(),
                                  np.asarray(J.is_valid(jnp.asarray(x))))
    _close(T.identity_like((2, 3)), J.identity_like((2, 3)))
    v = np.random.default_rng(9).normal(size=(6, T.storage_dim if gname == "R4" else 3))
    if gname in ("SO2", "SE2"):
        v = v[:, :2]
    _close(T.act(torch.from_numpy(x), torch.from_numpy(v)), J.act(jnp.asarray(x),
                                                                   jnp.asarray(v)))


@pytest.mark.parametrize("pair", [(jso3, tso3), (jse3, tse3)], ids=["SO3", "SE3"])
def test_act_j_and_matrices_match_apex_tpu(pair):
    jm, tm = pair
    n = 7 if jm is jse3 else 4
    dof = 6 if jm is jse3 else 3
    x = np.asarray(jm.exp(jnp.asarray(np.random.default_rng(2).normal(size=(5, dof)))))
    v = np.random.default_rng(3).normal(size=(5, 3))
    for got, want in zip(tm.act_j(torch.from_numpy(x), torch.from_numpy(v)),
                         jm.act_j(jnp.asarray(x), jnp.asarray(v))):
        _close(got, want)
    M = tm.to_matrix(torch.from_numpy(x))
    _close(M, jm.to_matrix(jnp.asarray(x)))
    if jm is jse3:
        _close(tse3.from_matrix(M), jse3.from_matrix(jnp.asarray(M.numpy())))
        np.testing.assert_allclose(tse3.from_matrix(M).numpy(),
                                   tse3.normalize(torch.from_numpy(x)).numpy(), atol=1e-12)
    assert x.shape[-1] == n


@pytest.mark.parametrize("gname", ALL)
def test_random_is_valid_and_has_the_laws(gname):
    """``random`` cannot match JAX's draws value for value: the port's are
    valid elements, reproducible from the generator's seed, and follow the
    same laws (Gaussian translations, uniform rotations, log-normal
    scale)."""
    T = manifolds.get(gname)
    x = T.random_batch(torch.Generator().manual_seed(0), 4000)
    assert x.shape == (4000, T.storage_dim) and x.dtype == torch.float64
    assert bool(T.is_valid(x).all())
    again = T.random_batch(torch.Generator().manual_seed(0), 4000)
    assert torch.equal(x, again)
    one = T.random(torch.Generator().manual_seed(1), dtype=torch.float32)
    assert one.shape == (T.storage_dim,) and one.dtype == torch.float32
    if gname in ("SO3", "SE3", "SE23", "Sim3", "SGal3"):
        q = x[:, 3:7] if gname != "SO3" else x
        assert bool((q[:, 0] >= 0).all())
        # a uniform rotation: each quaternion component's square has mean 1/4
        np.testing.assert_allclose((q * q).mean(0).numpy(), 0.25, atol=0.02)
    if gname != "SO3" and gname not in ("SO2",):
        t = x[:, :2]
        np.testing.assert_allclose(t.mean(0).numpy(), 0.0, atol=0.1)
        np.testing.assert_allclose(t.std(0).numpy(), 1.0, atol=0.1)
    if gname == "Sim3":
        np.testing.assert_allclose(float(torch.log(x[:, 7]).std()), 0.5, atol=0.05)
    if gname == "SO2":
        assert float(x.abs().max()) <= np.pi
        np.testing.assert_allclose(float(x.std()), np.pi / np.sqrt(3), atol=0.1)


def test_registry():
    for name in ("SO2", "SE2", "SO3", "SE3", "SE23", "Sim3", "SGal3"):
        G = manifolds.get(name)
        J = jax_manifolds.get(name)
        assert (G.name, G.dof, G.storage_dim) == (J.name, J.dof, J.storage_dim)
    assert manifolds.get("R7").dof == 7
    with pytest.raises(KeyError):
        manifolds.get("SE4")


def test_values_from_jax_carries_extended_pools():
    """The JAX package's values of SE23, Sim3, SGal3 and R^K pools become the
    port's values tuple, pool by pool."""
    problems = []
    for pkg in (jax_apx, apx):
        p = pkg.Problem()
        for gname in ("SE23", "Sim3", "SGal3", "R5"):
            xs = _elements(gname, 3, n=2) if gname != "R5" else np.ones((2, 5))
            p.add_variables_batch([f"{gname}_{i}" for i in range(2)], gname, xs)
            p.add_residual_block([f"{gname}_0", f"{gname}_1"],
                                 pkg.BetweenFactor(gname, xs[0]))
        problems.append(p)
    cj = problems[0].compile(dtype=np.float64)
    ct = problems[1].compile(dtype=torch.float64, device="cpu")
    arrays = [np.asarray(pool.values0) for pool in cj.pools]
    values = values_from_jax(ct, arrays, cj.pools)
    assert [pool.manifold.name for pool in ct.pools] == [pool.manifold.name for pool in cj.pools]
    for got, want in zip(values, arrays):
        np.testing.assert_array_equal(got.numpy(), want)
