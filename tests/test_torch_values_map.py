"""The variables a solve hands out (``CompiledProblem.values_dict``, a
``VariableMap`` over one read-only host copy per pool and the compiled
problem's name index) against the JAX package's dict, f64 on the CPU: the
same names in the same order, shapes, dtypes and bits, every value
read-only, after a solve in both loop modes and on the pools as they are
given; then the mapping's behaviour operation by operation against
``dict(m)``, and what it keeps alive."""

import gc
import pickle
import weakref

import numpy as np
import pytest
import torch

import apex_tpu_torch as apx
from apex_tpu.ba import build_ba_problem as jax_build
from apex_tpu.io import synthetic as jax_synthetic
from apex_tpu_torch.ba import build_ba_problem
from apex_tpu_torch.core.problem import CompiledProblem
from apex_tpu_torch.io import synthetic
from test_torch_jit import one_thread  # noqa: F401 (autouse: one BLAS thread per module)

# name -> (the problem from a package's synthetic module and BA builder, solver options)
PROBLEMS = {
    "se2": (lambda syn, build: syn.synthetic_pose_graph_2d(25, seed=6).to_problem(fix_first=True),
            dict(linear_solver_type="sparse_cholesky")),
    "se3": (lambda syn, build: syn.synthetic_pose_graph_3d(n_poses=12, rings=2, seed=0).to_problem(),
            dict(linear_solver_type="sparse_cholesky")),
    "ba_selfcal": (lambda syn, build: build(syn.synthetic_ba(n_cameras=4, n_points=30, seed=0)),
                   dict(linear_solver_type="schur_implicit")),
}


def _port(name):
    make, _ = PROBLEMS[name]
    return make(synthetic, build_ba_problem).compile(dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def jax_problems():
    """The JAX package's compiled twin of each problem, built once."""
    cache = {}

    def get(name):
        if name not in cache:
            make, _ = PROBLEMS[name]
            cache[name] = make(jax_synthetic, jax_build).compile(dtype=np.float64)
        return cache[name]

    return get


def _same(handed, want):
    """``handed`` (the port's) holds ``want``'s (the JAX package's dict)
    names in its order, each value of its shape and dtype, bit for bit,
    and read-only."""
    assert list(handed) == list(want)
    for name, v in want.items():
        got = handed[name]
        assert (got.shape, got.dtype) == (v.shape, v.dtype), name
        assert np.array_equal(got, v), name
        assert not got.flags.writeable, name


@pytest.mark.parametrize("mode", ["python", "jit"])
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_handed_out_variables_match_the_jax_dict(name, mode, jax_problems, monkeypatch):
    """A solve's ``variables`` and ``values_dict`` of a point that is not
    the start, each against the JAX package's ``values_dict`` of the same
    pools."""
    cp, jcp = _port(name), jax_problems(name)
    seen = []
    values_dict = cp.values_dict

    def record(values):
        seen.append([v.detach().numpy().copy() for v in values])
        return values_dict(values)

    monkeypatch.setattr(cp, "values_dict", record)
    result = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
        mode=mode, max_iterations=4, **PROBLEMS[name][1])).optimize(cp)
    assert result.final_cost < result.initial_cost
    _same(result.variables, jcp.values_dict(seen[-1]))

    dx = torch.linspace(-0.01, 0.02, cp.total_dof, dtype=torch.float64)
    moved = cp.apply_step(cp.initial_values(), dx)
    _same(values_dict(moved), jcp.values_dict([v.numpy() for v in moved]))


# ---------------------------------------------------------------------------
# the mapping, operation by operation
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ring():
    return _port("se2")


def _equal(a, b):
    assert list(a) == list(b)
    assert all(np.array_equal(a[k], b[k]) for k in b)


def _assign(m, d):
    for target in (m, d):
        target["x3"] = np.zeros(3)  # an index name keeps its place
        target["extra"] = np.ones(2)  # a new name comes last
    _equal(m, d)


def _delete(m, d):
    for target in (m, d):
        del target["x2"]
        target["x2"] = np.full(3, 2.0)  # back, at the end
        target["extra"] = np.ones(2)
        del target["extra"]
    with pytest.raises(KeyError):
        del m["x2_missing"]
    _equal(m, d)
    del m["x0"], d["x0"]
    assert "x0" not in m and m.get("x0") is None and len(m) == len(d)
    with pytest.raises(KeyError):
        m["x0"]
    _equal(m, d)


def _pickled(m, d):
    for target in (m, d):
        target["x1"] = np.zeros(3)
        del target["x2"]
        target["extra"] = np.ones(2)
    back = pickle.loads(pickle.dumps(m))
    _equal(back, d)
    assert all(not back[n].flags.writeable for n in back if n not in ("x1", "extra"))
    back["x3"] = np.zeros(3)
    assert not np.array_equal(m["x3"], back["x3"])


OPERATIONS = {
    "len": lambda m, d: len(m) == len(d) == 25,
    "in": lambda m, d: ("x7" in m) and ("x99" not in m) and (7 not in m),
    "get": lambda m, d: (np.array_equal(m.get("x4"), d["x4"])
                         and m.get("x99", "default") == "default" and m.get("x99") is None),
    "getitem_missing": lambda m, d: pytest.raises(KeyError, m.__getitem__, "x99") is not None,
    "iteration_order": lambda m, d: list(m) == list(d) == [f"x{i}" for i in range(25)],
    "keys": lambda m, d: m.keys() == d.keys() and d.keys() == m.keys() and list(m.keys()) == list(d),
    "values": lambda m, d: all(np.array_equal(a, b) for a, b in zip(m.values(), d.values(),
                                                                      strict=True)),
    "items": lambda m, d: all(a[0] == b[0] and np.array_equal(a[1], b[1])
                              for a, b in zip(m.items(), d.items(), strict=True)),
    "unpack": lambda m, d: _equal({**m}, d) is None,
    "dict": lambda m, d: _equal(dict(m), d) is None,
    "assign": lambda m, d: _assign(m, d) is None,
    "delete": lambda m, d: _delete(m, d) is None,
    "pickle": lambda m, d: _pickled(m, d) is None,
}


@pytest.mark.parametrize("op", list(OPERATIONS))
def test_the_mapping_behaves_as_its_dict(ring, op):
    """Each operation on the mapping agrees with ``dict(m)``; what one
    mapping's assignment or deletion changes leaves the pools, the name
    index and another mapping of the same pools as they were."""
    m = ring.values_dict(ring.initial_values())
    other = ring.values_dict(ring.initial_values())
    index = dict(ring.var_loc)
    pools = [v.clone() for v in ring.initial_values()]
    d = dict(m)
    assert OPERATIONS[op](m, d)
    assert ring.var_loc == index
    assert all(torch.equal(a, b) for a, b in zip(ring.initial_values(), pools))
    _equal(other, {n: pools[p][r].numpy() for n, (p, r) in index.items()})
    assert all(not v.flags.writeable for v in other.values())


@pytest.mark.parametrize("mode", ["python", "jit"])
def test_handed_out_values_share_no_memory(ring, mode):
    """No value of a result aliases a pool tensor, the start's, or another
    result's value."""
    solver = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(mode=mode))
    first, second = solver.optimize(ring), solver.optimize(ring)
    start = ring.values_dict(ring.initial_values())
    pools = [t.numpy() for t in ring.initial_values()]
    for name in first.variables:
        a, b = first.variables[name], start[name]
        assert not any(np.shares_memory(v, t) for v in (a, b) for t in pools), name
        assert not np.shares_memory(a, second.variables[name]), name
        assert not np.shares_memory(a, b), name


@pytest.mark.parametrize("mode", ["python", "jit"])
def test_a_result_keeps_no_compiled_problem_alive(mode):
    """A result outlives its compiled problem: a weak reference to the
    problem dies once the problem and its solver are dropped, and the
    result still reads every name."""
    cp = _port("se2")
    ref = weakref.ref(cp)
    solver = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(mode=mode))
    result = solver.optimize(cp)
    want = {n: np.array(v) for n, v in result.variables.items()}
    del cp, solver
    gc.collect()
    assert ref() is None
    assert not any(isinstance(x, CompiledProblem) for x in gc.get_referents(result.variables))
    _equal(result.variables, want)
