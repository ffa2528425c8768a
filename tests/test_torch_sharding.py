"""The port's multi-device solves (``apex_tpu_torch.parallel``) against the
JAX package's (``apex_tpu.parallel``), f64 on the CPU.

The JAX side runs in this process on conftest's 8 virtual devices. The
port's side runs on spawned gloo worlds of 1, 2 and 3 ranks (3 is odd, so
the factor rows and the landmark ranges are padded), once per module: each
rank computes every case of ``torch_sharding_ranks.cases`` and returns its
arrays here. The cases are those of ``tests/test_sharding.py`` and
``tests/test_sharding_planes.py``; the slow banded case runs on a 48-pose
graph instead of 96.

- normal equations: H and g at atol 1e-12, cost at rtol 1e-12, against the
  JAX package's ``make_sharded_normal_fn`` and the port's
  ``assemble_normal``;
- the dense sharded LM step: each of 8 costs at rtol 1e-10 against JAX's;
- the banded sharded step against the dense sharded step at rtol 1e-8;
- the landmark-partitioned Schur solve against the port's
  ``SchurContext.solve`` and JAX's ``step.solve`` at rtol 1e-8 (atol
  1e-10), its partition (``n_loc = ceil(n / size)``), convergence, and a
  pose prior (a camera-only group);
- the flat layout routes to the observation-sharded block path, whose costs
  match JAX's block path at rtol 1e-8 (PCG to 1e-12 on both sides, from
  damping 1e2: see ``torch_sharding_ranks.FLAT_PCG``);
- every rank of a world returns the same bits, and 1, 2 and 3 ranks agree.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import apex_tpu as jax_apx
import apex_tpu.parallel as jax_par
import torch_sharding_ranks as ranks
from apex_tpu.ba import build_ba_problem as jax_build_ba
from apex_tpu.factors import ManifoldPriorFactor as JaxManifoldPrior
from apex_tpu.io import synthetic as jax_synthetic
from apex_tpu_torch.linalg.schur import SchurContext
from apex_tpu_torch.parallel import ProcessMesh, launch
from apex_tpu_torch.parallel import mesh as mesh_mod
from test_torch_jit import one_thread  # noqa: F401 (autouse: one BLAS thread per module)

SIZES = (1, 2, 3)


@pytest.fixture(scope="module")
def worlds():
    """{size: [rank 0's cases, rank 1's, ...]} of one gloo world per size."""
    return {n: launch(ranks.cases, n, "gloo", "cpu") for n in SIZES}


@pytest.fixture(scope="module")
def jmesh():
    return Mesh(np.array(jax.devices()[:8]), ("data",))


def _jax_normal(cp, jmesh):
    fn, shard_args = jax_par.make_sharded_normal_fn(cp, jmesh)
    H, g, c = jax.jit(fn)(cp.initial_values(), *shard_args)
    return np.asarray(H), np.asarray(g), float(c)


def _jax_state(cp, damping=1e-3):
    values = cp.initial_values()
    return (values, jnp.asarray(damping, cp.dtype), jnp.asarray(2.0, cp.dtype), cp.cost(values))


def _jax_costs(step, cp, n, damping=1e-3):
    state = _jax_state(cp, damping)
    costs = [float(state[3])]
    for _ in range(n):
        state = step(*state)
        costs.append(float(state[3]))
    return costs


def _each_rank(worlds, case):
    for n, results in worlds.items():
        for rank, res in enumerate(results):
            yield n, rank, res[case]


@pytest.mark.parametrize("case,make", [
    ("ring", lambda: jax_synthetic.synthetic_pose_graph_2d(
        n_poses=50, trajectory="ring", seed=2).to_problem()),
    ("huber", lambda: jax_synthetic.synthetic_pose_graph_2d(n_poses=33, seed=4).to_problem(
        loss=jax_apx.HuberLoss(1.0), fix_first=True)),
])
def test_normal_equations(worlds, jmesh, case, make):
    H0, g0, c0 = _jax_normal(make().compile(), jmesh)
    cp = getattr(ranks, f"{case}_problem")()
    Hp, gp, cpc = (x.numpy() if torch.is_tensor(x) else x
                   for x in cp.assemble_normal(cp.initial_values()))
    for n, rank, res in _each_rank(worlds, case):
        # each group padded to the next multiple of the world size
        assert res["rows"] == [-(-g.count // n) for g in cp.groups]
        for H, g, c in ((H0, g0, c0), (Hp, gp, float(cpc))):
            np.testing.assert_allclose(res["H"], H, rtol=0, atol=1e-12, err_msg=f"{n} ranks")
            np.testing.assert_allclose(res["g"], g, rtol=0, atol=1e-12, err_msg=f"{n} ranks")
            assert math.isclose(res["cost"], c, rel_tol=1e-12), (n, rank, res["cost"], c)


def test_dense_step_matches_jax(worlds, jmesh):
    cp = jax_synthetic.synthetic_pose_graph_3d(n_poses=48, rings=4, seed=9).to_problem().compile()
    want = _jax_costs(jax.jit(jax_par.make_sharded_lm_step(cp, jmesh)), cp, 8)
    for n, rank, res in _each_rank(worlds, "dense"):
        np.testing.assert_allclose(res["costs"], want, rtol=1e-10, err_msg=f"{n} ranks")
        assert res["costs"][-1] < 0.15 * res["costs"][0]


def test_banded_step_matches_dense(worlds):
    for n, rank, res in _each_rank(worlds, "banded"):
        b, d = res["banded"], res["dense"]
        # the same normal equations: one step lands at the dense step's cost
        assert math.isclose(b[1], d[1], rel_tol=1e-8), (n, b[1], d[1])
        assert b[3] < b[1] < b[0]


@pytest.fixture(scope="module")
def jax_ba_solves(jmesh):
    """JAX's partitioned solves of the two partitioned cases at damping 1e-3."""
    ds = jax_synthetic.synthetic_ba(n_cameras=7, n_points=110, seed=4)
    cp = jax_build_ba(ds, mode="self_calibration").compile(dtype=np.float64)
    ds_p = jax_synthetic.synthetic_ba(n_cameras=5, n_points=60, seed=2)
    problem = jax_build_ba(ds_p, mode="self_calibration")
    problem.add_residual_block(["pose_0001"], JaxManifoldPrior("SE3", ds_p.camera_se3()[1]))
    cp_p = problem.compile(dtype=np.float64)
    out = {}
    for case, c in (("partitioned", cp), ("prior", cp_p)):
        step, _ = jax_par.make_sharded_schur_step(c, jmesh)
        assert hasattr(step, "solve")
        dx, g, cost, pred = step.solve(c.initial_values(), jnp.asarray(1e-3, c.dtype))
        out[case] = dict(dx=np.asarray(dx), g=np.asarray(g), cost=float(cost),
                         predicted=float(pred))
    return out


def _port_solve(cp):
    dx, g, cost, pred = SchurContext(cp, variant="iterative").solve(cp.initial_values(), 1e-3)
    return dict(dx=dx.numpy(), g=g.numpy(), cost=float(cost), predicted=float(pred))


@pytest.mark.parametrize("case", ["partitioned", "prior"])
def test_partitioned_solve(worlds, jax_ba_solves, case):
    """The partitioned solve is the port's one-device ``SchurContext.solve``
    and the JAX package's partitioned solve."""
    cp = ranks.ba_problem() if case == "partitioned" else ranks.prior_problem()
    for want in (_port_solve(cp), jax_ba_solves[case]):
        for n, rank, res in _each_rank(worlds, case):
            assert math.isclose(res["cost"], want["cost"], rel_tol=1e-12)
            for key in ("dx", "g"):
                np.testing.assert_allclose(res[key], want[key], rtol=1e-8, atol=1e-10,
                                           err_msg=f"{key}, {n} ranks, rank {rank}")
            assert math.isclose(res["predicted"], want["predicted"], rel_tol=1e-8)


def test_partition_layout(worlds):
    """Every landmark group splits into ceil(n / size) landmarks per rank
    with their cap observations each."""
    for n, rank, res in _each_rank(worlds, "partitioned"):
        lm = [(cap, nn, n_loc, k_loc) for cap, nn, n_loc, k_loc in res["metas"] if cap]
        assert lm
        for cap, nn, n_loc, k_loc in lm:
            assert n_loc == -(-nn // n) and k_loc == n_loc * cap
        assert res["local_landmarks"] == sum(n_loc for _, _, n_loc, _ in lm)
        assert res["local_rows"] == [k for *_, k in res["metas"]]


def test_partitioned_converges(worlds):
    for n, rank, res in _each_rank(worlds, "partitioned"):
        assert res["costs"][-1] < 0.3 * res["costs"][0]
        assert res["warm_costs"][-1] < 0.3 * res["costs"][0]


def test_flat_layout_takes_the_block_path(worlds, jmesh):
    ds = jax_synthetic.synthetic_ba_large(n_cameras=6, n_points=300, obs_per_camera=100, seed=3)
    cp = jax_build_ba(ds, layout="flat").compile(dtype=np.float64)
    step, _ = jax_par.make_sharded_schur_step(cp, jmesh, **ranks.FLAT_PCG)
    assert not hasattr(step, "solve")
    want = _jax_costs(jax.jit(step), cp, 3, damping=ranks.FLAT_DAMPING)
    for n, rank, res in _each_rank(worlds, "flat"):
        assert not res["partitioned"]
        np.testing.assert_allclose(res["damped"], want, rtol=1e-8, err_msg=f"{n} ranks")
        assert res["costs"][-1] < res["costs"][1] < res["costs"][0]


def _same_bits(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_bits(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_bits(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


REPLICATED = ("ring", "huber", "dense", "banded", "flat")


def test_ranks_of_a_world_agree_bitwise(worlds):
    for n, results in worlds.items():
        for case in REPLICATED + ("partitioned",):
            want = {k: v for k, v in results[0][case].items() if k != "local_rows"}
            for res in results[1:]:
                got = {k: v for k, v in res[case].items() if k != "local_rows"}
                assert _same_bits(got, want), (n, case)


@pytest.mark.parametrize("case,key,rtol", [
    ("ring", "H", 1e-12), ("huber", "H", 1e-12), ("dense", "costs", 1e-10),
    ("banded", "banded", 1e-10), ("partitioned", "dx", 1e-8),
    ("partitioned", "warm_costs", 1e-10), ("prior", "dx", 1e-8), ("flat", "damped", 1e-8)])
def test_mesh_size_invariance(worlds, case, key, rtol):
    """1, 2 and 3 ranks: the same results up to the order of the sums (H
    at atol 1e-12, as against the JAX package, dx at atol 1e-10)."""
    atol = {"H": 1e-12, "dx": 1e-10}.get(key, 0.0)
    one = np.asarray(worlds[1][0][case][key])
    for n in SIZES[1:]:
        np.testing.assert_allclose(np.asarray(worlds[n][0][case][key]), one, rtol=rtol,
                                   atol=atol, err_msg=f"{n} ranks")


def test_cuda_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        ProcessMesh(device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        launch(ranks.cases, 1, "nccl", "cuda")


def test_nccl_needs_a_card_per_rank(monkeypatch):
    """Two NCCL ranks on one card: refused before anything is spawned."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one card per rank"):
        launch(ranks.cases, 2, "nccl", "cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        launch(ranks.cases, 2, "mpi", "cpu")
    assert mesh_mod.rank_device("gloo", "cuda", 1) == torch.device("cuda", 0)
    assert mesh_mod.rank_device("gloo", "cpu", 1) == torch.device("cpu")
    assert mesh_mod.rank_device("nccl", "cuda", 1) == torch.device("cuda", 1)


def test_entry_matches_jax():
    """``graft_entry.entry``'s LM step on the 32-pose sphere, on the CPU,
    against ``__graft_entry__.entry``'s: cost, damping and nu after one step."""
    import __graft_entry__ as jax_entry
    from apex_tpu_torch.graft_entry import entry

    fn, args = entry(device="cpu")
    values, damping, nu, cost = fn(*args)[:4]
    jfn, jargs = jax_entry.entry()
    jout = jax.jit(jfn)(*jargs)
    assert math.isclose(float(cost), float(jout[3]), rel_tol=1e-10)
    assert math.isclose(damping, float(jout[1]), rel_tol=1e-10)
    assert nu == float(jout[2])


def test_dryrun_multichip_on_cpu(capsys):
    """The four checks of ``dryrun_multichip`` on 3 gloo ranks: each step
    lowers its cost (the checks raise otherwise) and rank 0's four lines
    are printed."""
    from apex_tpu_torch.graft_entry import dryrun_multichip

    costs = dryrun_multichip(3, device="cpu")
    assert sorted(costs) == ["banded", "block", "dense", "partitioned"]
    assert all(after < before for before, after in costs.values())
    assert capsys.readouterr().out.count(" OK\n") == 4
