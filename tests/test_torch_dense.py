"""The prior factors, the dense solvers (``linalg/dense.py``) and the dense
assemblies of the PyTorch port against apex_tpu, f64 on the CPU: each
tensor within 1e-12 of its largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu as jax_apx
import apex_tpu_torch as apx
from apex_tpu.ba import build_ba_problem as jax_build
from apex_tpu.factors.prior import ManifoldPriorFactor as JManifoldPrior
from apex_tpu.factors.prior import PriorFactor as JPrior
from apex_tpu.io import synthetic as jax_synthetic
from apex_tpu.linalg import dense as jdense
from apex_tpu.manifolds import get as jget
from apex_tpu_torch.ba import build_ba_problem
from apex_tpu_torch.factors import ManifoldPriorFactor, PriorFactor
from apex_tpu_torch.io import synthetic
from apex_tpu_torch.linalg import banded, dense
from apex_tpu_torch.manifolds import get
from test_torch_jit import one_thread  # noqa: F401 (autouse: one BLAS thread per module)

TOL = 1e-12


def _close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=TOL,
                               atol=TOL * max(np.abs(j).max(), 1e-300))


def _points(name, n, seed):
    """n random points of manifold ``name`` (storage vectors)."""
    G = jget(name)
    t = np.random.default_rng(seed).normal(size=(n, G.dof))
    return np.array(G.exp(jnp.asarray(t)))


@pytest.mark.parametrize("name", ["SE2", "SE3", "R3"])
def test_prior_factors_match_apex_tpu(name):
    x, prior = _points(name, 16, 1), _points(name, 16, 2)
    G, JG = get(name), jget(name)
    kinds = [(ManifoldPriorFactor, JManifoldPrior)]
    if G.storage_dim == G.dof:
        kinds.append((PriorFactor, JPrior))
    else:
        with pytest.raises(ValueError, match="storage_dim == dof"):
            PriorFactor(prior[0], name)
    for tf, jf in kinds:
        for jac in (True, False):
            r, J = tf.linearize((G,), {"prior": torch.from_numpy(prior)},
                                [torch.from_numpy(x)], jac)
            rj, Jj = jf.linearize((JG,), {"prior": jnp.asarray(prior)}, [jnp.asarray(x)], jac)
            _close(r, rj)
            if jac:
                _close(J[0], Jj[0])
            else:
                assert J is None and Jj is None
    f = ManifoldPriorFactor(name, prior[0])
    assert f.signature() == ("manifold_prior", name) and f.residual_dim() == G.dof
    with pytest.raises(ValueError, match="shape"):
        ManifoldPriorFactor(name, prior[0][:-1])


def _spd(D, seed):
    A = np.random.default_rng(seed).normal(size=(D, D))
    return A @ A.T + D * np.eye(D)


def _indefinite(D, seed):
    """SPD, shifted so that its smallest eigenvalue is -1e-3 of the spread
    above it: the retry ladder's fifth shift (1e-2 of the mean diagonal)
    rescues it, the fourth does not."""
    A = _spd(D, seed)
    lam = np.linalg.eigvalsh(A)[0]
    return A - (lam + 1e-3 * (np.trace(A) / D - lam)) * np.eye(D)


@pytest.mark.parametrize("kind", ["spd", "indefinite"])
def test_cholesky_with_retry_matches_apex_tpu(kind):
    D = 40
    H = _spd(D, 3) if kind == "spd" else _indefinite(D, 3)
    g = np.random.default_rng(4).normal(size=D)
    for damping in (None, 0.5):
        dx = dense.solve_cholesky_with_retry(torch.from_numpy(H), torch.from_numpy(g), damping)
        jdx = jdense.solve_cholesky_with_retry(jnp.asarray(H), jnp.asarray(g), damping)
        assert torch.isfinite(dx).all()
        _close(dx, jdx)
    if kind == "indefinite":
        # without the ladder the factorization fails: NaN, not an exception
        assert torch.isnan(dense.solve_cholesky(torch.from_numpy(H), torch.from_numpy(g))).all()
    else:
        _close(dense.solve_cholesky(torch.from_numpy(H), torch.from_numpy(g), 0.5),
               jdense.solve_cholesky(jnp.asarray(H), jnp.asarray(g), 0.5))


@pytest.mark.parametrize("damping", [None, 1e-3, 10.0])
def test_solve_qr_matches_apex_tpu(damping):
    rng = np.random.default_rng(6)
    J, r = rng.normal(size=(90, 30)), rng.normal(size=90)
    _close(dense.solve_qr(torch.from_numpy(r), torch.from_numpy(J), damping),
           jdense.solve_qr(jnp.asarray(r), jnp.asarray(J), damping))


def _se2_problem(pkg, graph):
    """A ring with a Huber loss on every edge, a manifold prior on x0 and a
    Euclidean prior on x5 (unary factor groups)."""
    p = graph.to_problem(loss=pkg.HuberLoss(0.05))
    p.add_residual_block(["x0"], pkg.ManifoldPriorFactor("SE2", graph.vertices_se2[0]))
    p.add_residual_block(["x5"], pkg.PriorFactor(graph.vertices_se2[5] + 0.01, "SE2"))
    return p


@pytest.fixture(scope="module")
def se2_with_priors():
    kw = dict(n_poses=60, trajectory="manhattan", loop_stride=7, seed=2)
    cp = _se2_problem(apx, synthetic.synthetic_pose_graph_2d(**kw)).compile(device="cpu")
    jcp = _se2_problem(jax_apx, jax_synthetic.synthetic_pose_graph_2d(**kw)).compile(
        dtype=np.float64)
    return cp, jcp


@pytest.fixture(scope="module")
def ba_small():
    ds = synthetic.synthetic_ba(n_cameras=8, n_points=150, seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_TPU_UNIFORM", "0")
        jcp = jax_build(ds).compile(dtype=np.float64)
    return build_ba_problem(ds).compile(dtype=torch.float64, device="cpu"), jcp


@pytest.mark.parametrize("which", ["se2_with_priors", "ba_small"])
def test_dense_assemblies_match_apex_tpu(which, request):
    """H, g, cost of ``assemble_normal`` and r, J of
    ``assemble_dense_jacobian``; and H = J^T J within the port."""
    cp, jcp = request.getfixturevalue(which)
    assert cp.total_dof == jcp.total_dof
    H, g, cost = cp.assemble_normal(cp.initial_values())
    jH, jg, jcost = jax.jit(jcp.assemble_normal)(jcp.initial_values())
    for t, j in ((H, jH), (g, jg), (cost, jcost)):
        _close(t, j)
    r, J = cp.assemble_dense_jacobian(cp.initial_values())
    jr, jJ = jax.jit(jcp.assemble_dense_jacobian)(jcp.initial_values())
    _close(r, jr)
    _close(J, jJ)
    _close(J.mT @ J, H.numpy())
    _close(J.mT @ r, g.numpy())


def test_band_assembly_takes_unary_groups():
    """The prior groups go through the band plan: the band of the dense H,
    and the gradient, come out of the banded assembler (RCM layout: 19
    blocks of 16 columns)."""
    graph = synthetic.synthetic_pose_graph_2d(n_poses=100, trajectory="ring", seed=2)
    cp = _se2_problem(apx, graph).compile(device="cpu", ordering="rcm")
    H, g, cost = cp.assemble_normal(cp.initial_values())
    asm = banded.BandedNormalAssembler(cp)
    Dg, Cg, gb, costb = asm.assemble(cp.initial_values())
    m, n, D = asm.m, asm.n, asm.D
    assert (m, n) == (16, 19)
    Hp = torch.nn.functional.pad(H, (0, n * m - D, 0, n * m - D)).reshape(n, m, n, m)
    idx = torch.arange(n)
    _close(Dg, Hp[idx, :, idx, :].numpy())
    _close(Cg[1:], Hp[idx[1:], :, idx[:-1], :].numpy())
    _close(gb, g.numpy())
    _close(costb, cost.numpy())
