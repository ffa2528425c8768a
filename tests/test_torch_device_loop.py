"""jit mode's device loop on the CPU: the plain SPD-clamped inverse against
the JAX package's, the implicit Schur solve's PCG (one ``while_update``)
against the JAX package's PCG, and the program tree that a capture records
for the LM loop, recorded here under a recorder whose graphs capture
nothing: the tree the card builds its parent graph from.

Tolerances: the two packages' eigh calls both go to LAPACK, but JAX
symmetrizes its input and the port reads the lower triangle, so the
inverses agree to rounding times the clamped spectrum's conditioning:
rtol 1e-10 in f64 against the largest entry of each block, and 2e-4 in f32
(float32's 6e-8 roundoff times condition numbers up to 1e3 of the clamped
blocks). The Schur solves hold the tolerances of
``tests/test_torch_schur.py``: dx to rtol 1e-8, the PCG tolerance 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ba import build_ba_problem as jax_build
from apex_tpu.linalg.schur import SchurContext as JaxSchur
from apex_tpu.linalg.utils import spd_clamped_inv as jax_spd_clamped_inv
import apex_tpu_torch as apx
import chip_smoke
from apex_tpu_torch.ba import build_ba_problem
from apex_tpu_torch.convert import values_from_jax
from apex_tpu_torch.io import synthetic
from apex_tpu_torch.kernels import spd_inverse
from apex_tpu_torch.linalg.schur import SchurContext
from apex_tpu_torch.optim import graphs, lm
from test_torch_jit import one_thread  # noqa: F401 (autouse: one BLAS thread per module)

FIXTURES = __import__("pathlib").Path(__file__).parent / "fixtures"


def _blocks(n, kind, batch=40, seed=0):
    """Seeded symmetric [batch, n, n] blocks: SPD, indefinite, or with one
    eigenvalue near zero (1e-15 against O(1))."""
    rng = np.random.default_rng(seed + 100 * n)
    A = rng.normal(size=(batch, n, n))
    if kind == "spd":
        return A @ A.transpose(0, 2, 1) + 0.1 * np.eye(n)
    if kind == "indefinite":
        return A + A.transpose(0, 2, 1)
    Q, _ = np.linalg.qr(A)
    w = np.abs(rng.normal(size=(batch, n))) + 0.5
    w[:, 0] = 1e-15
    return (Q * w[:, None, :]) @ Q.transpose(0, 2, 1)


@pytest.mark.parametrize("kind", ["spd", "indefinite", "near_singular"])
@pytest.mark.parametrize("n", [1, 3, 6, 9, 15])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_spd_clamped_inv_matches_jax(n, kind, dtype):
    H = _blocks(n, kind).astype(dtype)
    want = np.asarray(jax_spd_clamped_inv(jnp.asarray(H)))
    got = spd_inverse.spd_clamped_inv(torch.from_numpy(H)).numpy()
    assert got.dtype == want.dtype == np.dtype(dtype)
    scale = np.abs(want).max(axis=(1, 2), keepdims=True)
    rtol = 1e-10 if dtype == "float64" else 2e-4
    assert np.all(np.abs(got - want) <= rtol * scale)
    # each kind at its own scale: the kept spectrum of a clamped block too
    full, kept, clamped = chip_smoke.spd_errors(torch.from_numpy(H), torch.from_numpy(got),
                                                torch.tensor(want))
    assert full <= rtol and clamped <= rtol and kept <= chip_smoke.SPD_KEPT_RTOL[dtype]
    # SPD whatever the input: every eigenvalue at or above the floor
    floor = spd_inverse.default_floor(torch.float64 if dtype == "float64" else torch.float32)
    w = np.linalg.eigvalsh(got.astype(np.float64))
    assert np.all(w > 0) or floor == 0


@pytest.mark.parametrize("B,n", [(1, 44), (300, 3), (257, 9), (257, 15)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_spd_check_sees_the_kept_spectrum(B, n, dtype):
    """chip_smoke's check of the SPD kernel on its blocks: every batch,
    B = 1 too, starts with an SPD block; an independent inverse (numpy's
    eigh, clamped) passes its gates, and one whose kept eigenvalues are 1%
    off fails them, also where the batch's other blocks are clamped."""
    H = torch.as_tensor(chip_smoke.spd_blocks(B, n), dtype=dtype)
    name = str(dtype).replace("torch.", "")
    w = np.linalg.eigvalsh(H[0].double().numpy())
    assert w.min() > 0
    want = spd_inverse.spd_clamped_inv_plain(H)
    w, V = np.linalg.eigh(H.double().numpy())
    floor = spd_inverse.default_floor(dtype) * np.maximum(np.abs(w).max(-1, keepdims=True), 1)
    clamped = np.maximum(w, floor)

    def inverse(spectrum):
        return torch.as_tensor((V / spectrum[:, None, :]) @ V.transpose(0, 2, 1), dtype=dtype)

    full, kept, rest = chip_smoke.spd_errors(H, inverse(clamped), want)
    assert full <= chip_smoke.SPD_RTOL[name] and rest <= chip_smoke.SPD_RTOL[name]
    assert kept <= chip_smoke.SPD_KEPT_RTOL[name]
    wrong = inverse(np.where(w > floor, 1.01 * clamped, clamped))
    full, kept, _ = chip_smoke.spd_errors(H, wrong, want)
    assert full > chip_smoke.SPD_RTOL[name]
    if B > 1 and dtype == torch.float64:
        # the clamped blocks' kept spectrum alone: f32 stores it to ~10%
        assert kept > chip_smoke.SPD_KEPT_RTOL[name]


def test_spd_clamped_inv_wrapper_on_the_cpu():
    """A CPU tensor takes the plain version and launches nothing; an empty
    batch passes through; ``linalg.utils`` re-exports the wrapper."""
    from apex_tpu_torch.linalg import utils

    before = spd_inverse.launches, spd_inverse.captured
    H = torch.from_numpy(_blocks(9, "spd"))
    np.testing.assert_array_equal(utils.spd_clamped_inv(H).numpy(),
                                  spd_inverse.spd_clamped_inv_plain(H).numpy())
    assert (spd_inverse.launches, spd_inverse.captured) == before
    assert utils.spd_clamped_inv(torch.zeros((0, 3, 3))).shape == (0, 3, 3)


EXACT = dict(variant="iterative", pcg_forcing=False, pcg_tolerance=1e-10,
             pcg_max_iterations=500)
DAMPING = 0.1


@pytest.fixture(scope="module")
def schur_setup():
    ds = synthetic.synthetic_ba(n_cameras=8, n_points=150, seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_TPU_UNIFORM", "0")
        jcp = jax_build(ds, mode="self_calibration").compile(dtype=np.float64)
    tcp = build_ba_problem(ds, mode="self_calibration").compile(
        dtype=torch.float64, device="cpu")
    dx = np.random.default_rng(3).normal(scale=1e-2, size=jcp.total_dof)
    jvals = jcp.apply_step(jcp.initial_values(), jnp.asarray(dx))
    tvals = values_from_jax(tcp, [np.asarray(v) for v in jvals], jcp.pools)
    return jcp, jvals, tcp, tvals


@pytest.mark.parametrize("options", [
    dict(start="cold"), dict(start="warm"), dict(start="cold", pcg_q_tolerance=0.1),
    dict(start="warm", pcg_forcing=True, iteration=2)],
    ids=["cold", "warm", "q_tolerance", "forcing"])
def test_device_loop_pcg_matches_jax(schur_setup, options):
    """``SchurContext._pcg`` (one ``graphs.while_update`` over masked
    chunks, the iteration a device counter, run eagerly here) against the
    JAX package's ``while_loop``
    PCG, from a cold start, a warm start, with Nash-Sofer's stop and with
    the forcing sequence at a device iteration."""
    options = dict(options)
    start, iteration = options.pop("start"), options.pop("iteration", None)
    kw = {**EXACT, **options}
    jcp, jvals, tcp, tvals = schur_setup
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_TPU_UNIFORM", "0")
        jctx = JaxSchur(jcp, **kw)
    assert jctx.uniform is None, "the JAX side must run its block path"
    tctx = SchurContext(tcp, **kw)
    jx0 = tx0 = None
    if start == "warm":
        ref, *_ = jctx.solve(jvals, DAMPING)
        jx0 = jnp.asarray(0.9 * np.asarray(ref))
        tx0 = torch.from_numpy(np.array(jx0))
    jit_iteration = None if iteration is None else torch.tensor(iteration)
    before = graphs.host_reads
    jdx, jg, jcost, jpred = jctx.solve(jvals, DAMPING, iteration=iteration, dx_prev=jx0)
    tdx, tg, tcost, tpred = tctx.solve(tvals, DAMPING, iteration=jit_iteration, dx_prev=tx0)
    # eagerly one read per trip, and the read that ends the loop
    assert 1 <= graphs.host_reads - before <= -(-kw["pcg_max_iterations"] // graphs.PCG_CHUNK) + 1
    scale = np.abs(np.asarray(jdx)).max()
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), rtol=1e-8, atol=1e-12 * scale)
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred), rtol=1e-8)


class _CpuRecorder(graphs._Recorder):
    """Records the program tree and captures nothing: each graph an empty
    stand-in."""

    def __init__(self):
        super().__init__(pool=None)

    def begin_graph(self):
        pass

    def end_graph(self):
        self.append(graphs._Graph(None, 1, {}))


def _tree(program):
    """The tree as nested tuples: "G" for a graph, ("IF", body) and
    ("WHILE", body)."""
    out = []
    for item in program:
        if isinstance(item, graphs._Graph):
            out.append("G")
        elif isinstance(item, graphs._Branch):
            out.append(("IF", _tree(item.body)))
        elif isinstance(item, graphs._Loop):
            out.append(("WHILE", _tree(item.body)))
        else:
            raise AssertionError(f"an item that is no graph, branch or loop: {item!r}")
    return out


def _count(tree, kind):
    return sum((1 if isinstance(t, tuple) and t[0] == kind else 0)
               + (_count(t[1], kind) if isinstance(t, tuple) else 0) for t in tree)


def _recorded(solver, cp):
    """The LM device program of ``solver`` on ``cp``, recorded on the CPU:
    (top-level tree, the LM loop's body)."""
    init, step = solver._make_device_init(cp), solver._make_device_step(cp)
    state = init()
    k, names = len(cp.pools), solver.JIT_STATE
    program = lm.device_program(init, step, torch.ones((), dtype=torch.bool),
                                torch.tensor(solver.config.max_iterations), k + names.index("status"),
                                k + names.index("iteration"), solver.config.max_iterations,
                                step.host_loop)
    recorded = graphs.record(program, state, _CpuRecorder())
    # only the QR solvers keep their LM loop on the host, named at the call site
    loop, = [item for item in recorded if isinstance(item, graphs._Loop)]
    qr = solver.config.linear_solver_type in ("dense_qr", "sparse_qr")
    assert loop.host == (lm.QR_HOST_LOOP if qr else None)
    tree = _tree(recorded)
    ifs = [t for t in tree if isinstance(t, tuple) and t[0] == "IF"]
    loops = [t for t in tree if isinstance(t, tuple) and t[0] == "WHILE"]
    assert len(ifs) == 1 and len(loops) == 1, tree
    assert tree.index(ifs[0]) < tree.index(loops[0])
    # the initial state's IF holds graphs only
    assert _count(ifs[0][1], "IF") == _count(ifs[0][1], "WHILE") == 0
    return tree, loops[0][1]


def _lm(**kw):
    return apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(mode="jit", **kw))


def test_recorded_tree_implicit_ba():
    """The implicit BA step: PCG one WHILE in the LM loop's WHILE (not one
    IF per PCG chunk), and no branch."""
    cp = build_ba_problem(synthetic.synthetic_ba(n_cameras=4, n_points=40, seed=1)).compile(
        dtype=torch.float64, device="cpu")
    _, body = _recorded(_lm(linear_solver_type="schur_implicit", max_iterations=5), cp)
    assert _count(body, "WHILE") == 1 and _count(body, "IF") == 0
    (pcg,) = [t for t in body if isinstance(t, tuple)]
    assert pcg[0] == "WHILE" and _count(pcg[1], "WHILE") == _count(pcg[1], "IF") == 0


def test_recorded_tree_pcg():
    """The plain ``pcg`` step: its CG loop one WHILE, no branch."""
    cp = apx.load_g2o(FIXTURES / "medium_se2_300.g2o").to_problem().compile(
        dtype=torch.float64, device="cpu")
    _, body = _recorded(_lm(linear_solver_type="pcg", max_iterations=5), cp)
    assert _count(body, "WHILE") == 1 and _count(body, "IF") == 0


def test_recorded_tree_banded():
    """The banded step (``sparse_cholesky``): the refinement gate an IF,
    then the retry ladder as IFs nested one in the other, a stage each;
    each stage holds its own refinement gate, an IF with no branch in it."""
    from apex_tpu_torch.linalg import banded

    cp = apx.load_g2o(FIXTURES / "medium_se3_250.g2o").to_problem().compile(
        dtype=torch.float64, device="cpu")
    _, body = _recorded(_lm(linear_solver_type="sparse_cholesky", max_iterations=5), cp)
    top = [t for t in body if isinstance(t, tuple)]
    assert [t[0] for t in top] == ["IF", "IF"] and _count(body, "WHILE") == 0
    depth, node = 0, top[1]
    while node is not None:
        depth += 1
        inner = [t for t in node[1] if isinstance(t, tuple)]
        assert [t[0] for t in inner] in (["IF"], ["IF", "IF"]), inner
        assert _count(inner[0][1], "IF") == _count(inner[0][1], "WHILE") == 0
        node = inner[1] if len(inner) == 2 else None
    assert depth == banded.RETRY_STAGES


@pytest.mark.parametrize("solver", ["dense_qr", "sparse_qr"])
def test_recorded_tree_qr_solvers_keep_the_loop_on_the_host(solver):
    """The QR solvers' LM loop is recorded as a WHILE kept on the host
    (cuSOLVER's QR allocates inside a capture): the step in it as for any
    other solver, the QR sweep's retry ladder a WHILE within."""
    cp = apx.load_g2o(FIXTURES / "medium_se2_300.g2o").to_problem().compile(
        dtype=torch.float64, device="cpu")
    _, body = _recorded(_lm(linear_solver_type=solver, max_iterations=5), cp)
    assert _count(body, "IF") == 0
    assert _count(body, "WHILE") == (1 if solver == "sparse_qr" else 0)


@pytest.mark.parametrize("n,panel", [(40, 16), (48, 16), (300, 64)])
def test_cholesky_panels(n, panel):
    """The panel Cholesky that the card takes above ``CHOLESKY_PANEL``
    columns (one cuSOLVER potrf that wide allocates inside a capture)
    against LAPACK's (rtol 1e-12 of the largest entry), and all NaN for a
    matrix that is not positive definite."""
    from apex_tpu_torch.linalg import banded

    A = np.random.default_rng(n).normal(size=(n, n))
    H = torch.from_numpy(A @ A.T + n * np.eye(n))
    want = torch.linalg.cholesky(H)
    got = banded.cholesky_panels(H.clone(), panel)
    assert np.abs((got - want).numpy()).max() <= 1e-12 * np.abs(want.numpy()).max()
    H[n - 3, n - 3] = -1e6
    assert torch.isnan(banded.cholesky_panels(H.clone(), panel)).all()
