"""The plain reference: Levenberg-Marquardt written in plain PyTorch from
the solver's documented semantics, with none of its code. It reads only
the inputs the benchmark generated, and the program's results only to
judge them (``compare.py``).

LM (Nielsen damping): on an accepted step (rho > 0) lambda *= max(1/3,
1 - (2 rho - 1)^3), clamped to [1e-12, 1e12], nu = 2; on a rejected one
lambda = min(lambda nu, 1e12), nu *= 2. The damped system is
(J^T J + lambda I) dx = -J^T r. After each iteration the status is checked
in this order: a non-finite cost or norm, the iteration cap, a rejected
step (go on), the gradient norm, the step norm against the parameter norm,
the relative cost change, ``min_cost_threshold``. The variables move by
the right plus, x * exp(dx) for poses and x + dx for vectors.

- ``BundleAdjustment``: BAL pinhole cameras (pose, [f, k1, k2]) and points,
  the first camera's pose fixed, Huber(1) by iteratively reweighted least
  squares (the residual and its Jacobian scaled by sqrt(rho'(s))); the
  landmarks are eliminated and the reduced camera system solved by
  conjugate gradients, preconditioned by the inverted camera blocks of the
  reduced matrix, warm-started from the previous step when that lowers
  the residual, to a tolerance 0.1 * 2^-iteration (at least 1e-6) relative
  to the right-hand side and at most ``pcg_max_iterations`` iterations.
- ``PoseGraph``: SE(3) between factors r = log(x_j^-1 x_i m), unweighted,
  the damped system solved exactly by a dense Cholesky factorization; the
  initial damping 1e-11 max diag(J^T J) when ``damping == "auto"``.

Everything runs in the dtype it is given, on the device it is given.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from . import lie

RUNNING = "RUNNING"


@dataclasses.dataclass
class Settings:
    max_iterations: int = 50
    cost_tolerance: float = 1e-6
    parameter_tolerance: float = 1e-8
    gradient_tolerance: float = 1e-10
    damping: object = 1e-3
    min_cost_threshold: Optional[float] = None
    pcg_max_iterations: int = 200
    pcg_tolerance: float = 1e-6


@dataclasses.dataclass
class Result:
    status: str
    iterations: int
    initial_cost: float
    final_cost: float
    values: tuple  # the variables as host numpy arrays, one per kind


def _status(it, cur, new, pnorm, snorm, gnorm, accepted, s: Settings):
    if not (math.isfinite(new) and math.isfinite(snorm) and math.isfinite(gnorm)):
        return "INVALID_NUMERICAL_VALUES"
    if it + 1 >= s.max_iterations:
        return "MAX_ITERATIONS_REACHED"
    if not accepted:
        return RUNNING
    if gnorm < s.gradient_tolerance:
        return "GRADIENT_TOLERANCE_REACHED"
    if it > 0 and snorm <= s.parameter_tolerance * (pnorm + s.parameter_tolerance):
        return "PARAMETER_TOLERANCE_REACHED"
    if it > 0 and abs(cur - new) / max(cur, 1e-10) < s.cost_tolerance:
        return "COST_TOLERANCE_REACHED"
    if s.min_cost_threshold is not None and new < s.min_cost_threshold:
        return "MIN_COST_THRESHOLD_REACHED"
    return RUNNING


def levenberg_marquardt(problem, s: Settings) -> Result:
    x = problem.initial()
    cost = cost0 = float(problem.cost(x))
    if s.damping == "auto":
        lam = min(max(1e-11 * float(problem.diag_max(x)), 1e-12), 1e12)
    else:
        lam = float(s.damping)
    nu, prev, it = 2.0, None, 0
    while True:
        dx, g, cur, predicted = problem.step(x, lam, it, prev, s)
        prev = dx
        xn = problem.apply(x, dx)
        new = float(problem.cost(xn))
        cur = float(cur)
        actual = cur - new
        if abs(predicted) < 1e-15:
            rho = 1.0 if actual > 0 else 0.0
        else:
            rho = actual / predicted
        accepted = rho > 0.0
        if accepted:
            lam = min(max(lam * max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3), 1e-12), 1e12)
            nu = 2.0
            x, cost = xn, new
        else:
            lam, nu = min(lam * nu, 1e12), nu * 2.0
            cost = cur
        snorm = math.sqrt(sum(float(torch.sum(d * d)) for d in dx))
        gnorm = math.sqrt(sum(float(torch.sum(v * v)) for v in g))
        pnorm = math.sqrt(sum(float(torch.sum(v * v)) for v in x))
        status = _status(it, cur, cost, pnorm, snorm, gnorm, accepted, s)
        it += 1
        if status != RUNNING:
            break
    return Result(status, it, cost0, cost, tuple(v.detach().cpu().numpy() for v in x))


def _sum_by(index, values, n):
    out = torch.zeros((n,) + values.shape[1:], dtype=values.dtype, device=values.device)
    return out.index_add_(0, index, values)


def _sym3_eig_range(A):
    """(smallest, largest) eigenvalue of symmetric 3x3 blocks, closed form."""
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    off = A[..., 0, 1] ** 2 + A[..., 0, 2] ** 2 + A[..., 1, 2] ** 2
    p2 = ((A[..., 0, 0] - q) ** 2 + (A[..., 1, 1] - q) ** 2 + (A[..., 2, 2] - q) ** 2
          + 2.0 * off)
    p = torch.sqrt(torch.clamp_min(p2 / 6.0, 1e-300))
    B = (A - q[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)) / p[..., None, None]
    phi = torch.acos(torch.clamp(torch.linalg.det(B) / 2.0, -1.0, 1.0)) / 3.0
    hi = q + 2.0 * p * torch.cos(phi)
    lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    flat = p2 < 1e-30
    d = torch.diagonal(A, dim1=-2, dim2=-1)
    return (torch.where(flat, d.amin(-1), lo), torch.where(flat, d.amax(-1), hi))


def landmark_inverse(Hpp):
    """The regularized inverse of the damped point blocks: a block whose
    smallest eigenvalue is below ``floor``, or whose condition number
    exceeds ``cond``, is shifted by |e_min| + rel max(e_max, 1) + floor
    first; (floor, cond, rel) = (1e-12, 1e10, 1e-8) in f64 and about their
    square roots, (1e-5, 1e6, 1e-5), in f32."""
    floor, cond, rel = (1e-5, 1e6, 1e-5) if Hpp.dtype == torch.float32 else (1e-12, 1e10, 1e-8)
    lo, hi = _sym3_eig_range(Hpp)
    bad = (lo < floor) | (hi > cond * torch.clamp_min(lo, floor * 1e-3))
    shift = torch.where(bad, lo.abs() + rel * torch.clamp_min(hi, 1.0) + floor,
                        torch.zeros_like(lo))
    A = Hpp + shift[:, None, None] * torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    # the adjugate over the determinant; rows of A are a, b, c
    a, b, c = A[:, 0], A[:, 1], A[:, 2]
    adj = torch.stack([torch.linalg.cross(b, c), torch.linalg.cross(c, a),
                       torch.linalg.cross(a, b)], -1)
    return adj / torch.sum(a * adj[..., 0], -1)[:, None, None]


def clamped_inverse(blocks):
    """The inverse with eigenvalues clamped from below at 1e-12 max(max|w|, 1)
    (an SPD preconditioner even where a block is not); eigh on the host in
    f64 (LAPACK's f32 eigh fails on some ill-conditioned blocks)."""
    w, V = torch.linalg.eigh(blocks.cpu().double())
    floor = torch.clamp_min(w.abs().amax(-1, keepdim=True), 1.0)
    w = torch.maximum(w, 1e-12 * floor)
    return ((V / w[..., None, :]) @ V.mT).to(dtype=blocks.dtype, device=blocks.device)


def pcg_tolerance(iteration, s: Settings, dtype=torch.float64):
    """0.1 * 2^-iteration, clamped to [floor, 0.1]; the floor is the
    configured tolerance, and at least 3e-5 in f32, where conjugate
    gradients stagnate near 1e-5."""
    floor = max(s.pcg_tolerance, 3e-5) if dtype == torch.float32 else s.pcg_tolerance
    return min(max(0.1 * 2.0 ** (-iteration), floor), 0.1)


class BundleAdjustment:
    """Self-calibrating BA over BAL data (the generator's dict)."""

    def __init__(self, data, dtype, device):
        def t(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

        q = lie.quat_normalize(lie.so3_exp(t(data["rotations"])))
        self.x0 = (torch.cat([t(data["translations"]), q], -1),
                   torch.stack([t(data["focals"]), t(data["k1"]), t(data["k2"])], -1),
                   t(data["points"]))
        self.cam = t(data["cam_indices"], torch.int64)
        self.pt = t(data["point_indices"], torch.int64)
        self.obs = t(data["observations"])
        self.C, self.P = self.x0[0].shape[0], self.x0[2].shape[0]
        self.n_obs = self.obs.shape[0]
        self.pose_free = torch.ones((self.C, 1, 1), dtype=dtype, device=device)
        self.pose_free[0] = 0.0  # the first camera's pose is fixed

    def initial(self):
        return self.x0

    def predict(self, x):
        """The observations the variables predict, in pixels ([K, 2]; 0 where
        a point lies behind its camera)."""
        return self._project(x, False, weighted=False) + self.obs

    def _project(self, x, jac, weighted=True):
        pose, intr, pts = x
        R = lie.quat_to_mat(pose[:, 3:])[self.cam]
        pw = pts[self.pt]
        pc = (R @ pw[..., None])[..., 0] + pose[self.cam, :3]
        f, k1, k2 = intr[self.cam].unbind(-1)
        X, Y, Z = pc.unbind(-1)
        Zs = torch.clamp_max(Z, -1e-6)
        xn, yn = -X / Zs, -Y / Zs
        r2 = xn * xn + yn * yn
        dist = 1.0 + r2 * (k1 + k2 * r2)
        uv = (f * dist)[:, None] * torch.stack([xn, yn], -1)
        ok = (Z < -1e-6) & torch.isfinite(uv).all(-1) & (uv.abs() < 1e8).all(-1)
        r = torch.where(ok[:, None], uv - self.obs, torch.zeros_like(uv))
        if not weighted:
            return torch.where(ok[:, None], r, -self.obs)
        # Huber(1) by reweighting: s = |r|^2, weight sqrt(rho'(s))
        s = torch.sum(r * r, -1)
        w = torch.where(s > 1.0, torch.clamp_min(s, 1.0) ** -0.25, torch.ones_like(s))
        if not jac:
            return w[:, None] * r
        # d(uv)/d(pc)
        dd = k1 + 2.0 * k2 * r2
        iz = -1.0 / Zs
        dxn = torch.stack([iz, torch.zeros_like(iz), X / (Zs * Zs)], -1)
        dyn = torch.stack([torch.zeros_like(iz), iz, Y / (Zs * Zs)], -1)
        du = f[:, None] * ((dist + 2 * dd * xn * xn)[:, None] * dxn + (2 * dd * xn * yn)[:, None] * dyn)
        dv = f[:, None] * ((2 * dd * xn * yn)[:, None] * dxn + (dist + 2 * dd * yn * yn)[:, None] * dyn)
        Jpc = torch.stack([du, dv], -2)  # [K, 2, 3]
        Jpose = Jpc @ torch.cat([R, -(R @ lie.skew(pw))], -1) * self.pose_free[self.cam]
        Jint = torch.stack([torch.stack([dist * xn, f * xn * r2, f * xn * r2 * r2], -1),
                            torch.stack([dist * yn, f * yn * r2, f * yn * r2 * r2], -1)], -2)
        Jpt = Jpc @ R
        scale = (w * ok)[:, None, None]
        return w[:, None] * r, torch.cat([Jpose, Jint], -1) * scale, Jpt * scale

    def cost(self, x):
        r = self._project(x, False)
        return 0.5 * torch.sum(r * r)

    def step(self, x, lam, it, prev, s: Settings):
        C, P = self.C, self.P
        r, Jc, Jl = self._project(x, True)
        cost = 0.5 * torch.sum(r * r)
        JcT, JlT = Jc.mT, Jl.mT
        eye9 = torch.eye(9, dtype=r.dtype, device=r.device)
        Hcc = _sum_by(self.cam, JcT @ Jc, C) + lam * eye9
        gc = _sum_by(self.cam, (JcT @ r[..., None])[..., 0], C)
        # in f32 the point blocks' shift is at least 1e-4, which bounds the
        # steps of weakly observed points
        shift = max(lam, 1e-4) if r.dtype == torch.float32 else lam
        Hpp = _sum_by(self.pt, JlT @ Jl, P) + shift * torch.eye(3, dtype=r.dtype, device=r.device)
        gp = _sum_by(self.pt, (JlT @ r[..., None])[..., 0], P)
        W = JcT @ Jl  # [K, 9, 3]
        Vinv = landmark_inverse(Hpp)

        def W_of(u):  # sum_k W_k u[pt_k] into camera rows
            return _sum_by(self.cam, (W @ u[self.pt][..., None])[..., 0], C)

        def Wt_of(v):  # sum_k W_k^T v[cam_k] into point rows
            return _sum_by(self.pt, (W.mT @ v[self.cam][..., None])[..., 0], P)

        def S_of(v):
            return (Hcc @ v[..., None])[..., 0] - W_of((Vinv @ Wt_of(v)[..., None])[..., 0])

        b = -gc + W_of((Vinv @ gp[..., None])[..., 0])
        blocks = Hcc - _sum_by(self.cam, W @ Vinv[self.pt] @ W.mT, C)
        Minv = clamped_inverse(blocks)
        dxc = self._pcg(S_of, Minv, b, pcg_tolerance(it, s, r.dtype), min(s.pcg_max_iterations, 9 * C),
                        None if prev is None else torch.cat([prev[0], prev[1]], -1))
        dxp = (Vinv @ (-gp - Wt_of(dxc))[..., None])[..., 0]
        dx = (dxc[:, :6], dxc[:, 6:], dxp)
        g = (gc[:, :6], gc[:, 6:], gp)
        # the Gauss-Newton model's reduction of the step taken
        Jdx = (Jc @ dxc[self.cam][..., None])[..., 0] + (Jl @ dxp[self.pt][..., None])[..., 0]
        predicted = -(torch.sum(gc * dxc) + torch.sum(gp * dxp)) - 0.5 * torch.sum(Jdx * Jdx)
        return dx, g, cost, float(predicted)

    @staticmethod
    def _pcg(S_of, Minv, b, rtol, cap, x0):
        bb = torch.sum(b * b)
        tol2 = rtol * rtol * bb
        x, r = torch.zeros_like(b), b.clone()
        if x0 is not None:
            rw = b - S_of(x0)
            if torch.sum(rw * rw) < bb:
                x, r = x0.clone(), rw
        z = (Minv @ r[..., None])[..., 0]
        p, rz = z.clone(), torch.sum(r * z)
        for _ in range(cap):
            if not bool(torch.sum(r * r) > tol2):
                break
            Sp = S_of(p)
            den = torch.sum(p * Sp)
            alpha = rz / torch.where(den == 0, torch.ones_like(den), den)
            x = x + alpha * p
            r = r - alpha * Sp
            z = (Minv @ r[..., None])[..., 0]
            rz_new = torch.sum(r * z)
            beta = rz_new / torch.where(rz == 0, torch.ones_like(rz), rz)
            p, rz = z + beta * p, rz_new
        return x

    @staticmethod
    def apply(x, dx):
        pose, intr, pts = x
        return (lie.se3_plus(pose, dx[0]), intr + dx[1], pts + dx[2])

    def diag_max(self, x):
        _, Jc, Jl = self._project(x, True)
        return max(float(_sum_by(self.cam, torch.sum(Jc * Jc, 1), self.C).max()),
                   float(_sum_by(self.pt, torch.sum(Jl * Jl, 1), self.P).max()))


class PoseGraph:
    """An SE(3) pose graph (the generator's dict), no vertex fixed."""

    def __init__(self, data, dtype, device):
        def t(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

        self.x0 = (t(data["vertices"]),)
        self.src, self.dst = t(data["src"], torch.int64), t(data["dst"], torch.int64)
        self.meas = t(data["measurements"])
        self.N = self.x0[0].shape[0]

    def initial(self):
        return self.x0

    @staticmethod
    def _residual(xi, xj, m):
        return lie.se3_log(lie.se3_compose(lie.se3_compose(lie.se3_inverse(xj), xi), m))

    def _linearize(self, x):
        v = x[0]
        xi, xj = v[self.src], v[self.dst]
        r = self._residual(xi, xj, self.meas)

        def res(d, a, b, m):
            # each row keeps a batch dimension of 1: under forward-mode
            # autodiff a Python number times a 0-d tensor gets an f64 tangent
            d, a, b, m = d[None], a[None], b[None], m[None]
            return self._residual(lie.se3_compose(a, lie.se3_exp(d[:, :6])),
                                  lie.se3_compose(b, lie.se3_exp(d[:, 6:])), m)[0]

        zero = torch.zeros((xi.shape[0], 12), dtype=v.dtype, device=v.device)
        J = torch.func.vmap(torch.func.jacfwd(res))(zero, xi, xj, self.meas)  # [E, 6, 12]
        return r, J

    def cost(self, x):
        v = x[0]
        r = self._residual(v[self.src], v[self.dst], self.meas)
        return 0.5 * torch.sum(r * r)

    def _normal(self, x):
        r, J = self._linearize(x)
        D = 6 * self.N
        ar = torch.arange(6, device=r.device)
        cols = [self.src[:, None] * 6 + ar, self.dst[:, None] * 6 + ar]
        Js = [J[..., :6], J[..., 6:]]
        H = torch.zeros(D * D, dtype=r.dtype, device=r.device)
        g = torch.zeros(D, dtype=r.dtype, device=r.device)
        for a in range(2):
            g.index_add_(0, cols[a].reshape(-1), (Js[a].mT @ r[..., None]).reshape(-1))
            for b in range(2):
                idx = cols[a][:, :, None] * D + cols[b][:, None, :]
                H.index_add_(0, idx.reshape(-1), (Js[a].mT @ Js[b]).reshape(-1))
        return H.view(D, D), g, 0.5 * torch.sum(r * r)

    def step(self, x, lam, it, prev, s: Settings):
        H, g, cost = self._normal(x)
        A = H + lam * torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
        del H
        L, info = torch.linalg.cholesky_ex(A)
        if int(info) == 0:
            dx = torch.cholesky_solve(-g[:, None], L)
            dx = dx + torch.cholesky_solve(-g[:, None] - A @ dx, L)  # one refinement
        else:  # not positive definite in this precision: LU
            dx = torch.linalg.solve(A, -g[:, None])
        dx = dx[:, 0]
        predicted = 0.5 * torch.sum(dx * (lam * dx - g))
        return (dx.view(-1, 6),), (g,), cost, float(predicted)

    @staticmethod
    def apply(x, dx):
        return (lie.se3_plus(x[0], dx[0]),)

    def diag_max(self, x):
        _, J = self._linearize(x)
        d = torch.zeros(6 * self.N, dtype=J.dtype, device=J.device)
        ar = torch.arange(6, device=J.device)
        for a, idx in ((0, self.src), (1, self.dst)):
            d.index_add_(0, (idx[:, None] * 6 + ar).reshape(-1),
                         torch.sum(J[..., 6 * a:6 * a + 6] ** 2, 1).reshape(-1))
        return d.max()


PROBLEMS = {"bundle_adjustment": BundleAdjustment, "pose_graph": PoseGraph}
# the solver's linear solvers whose steps each reference computes, as the
# configurations name them: the implicit Schur PCG, and an exact solve
LINEAR_SOLVERS = {
    "bundle_adjustment": {"schur_implicit"},
    "pose_graph": {"sparse_cholesky"},
}
