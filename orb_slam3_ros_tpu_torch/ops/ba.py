"""Bundle adjustment: Levenberg-Marquardt with an explicit Schur
complement over fixed-capacity edge tables — port of
``orb_slam3_ros_tpu.ops.ba`` (the scatter formulation of
``bundle_adjust``; its ``row_n`` gather formulation was a TPU workaround).

Every observation is a row (cam_idx, pt_idx, uv, inv_sigma2, valid). Per
LM step the per-edge residuals and Jacobians are batched over the edge
axis, the camera / point / camera-point blocks accumulate with
``index_add_``, the landmarks are eliminated by a dense Schur complement
onto the cameras, and the reduced system is solved by Cholesky. A step is
accepted when it lowers the robust cost.

``rel_tol`` early stopping comes in two forms with the same numbers as
the JAX package's ``while_loop``. The host form reads the step's ``done``
flag after each LM iteration (one device sync each) and skips the
iterations after convergence: the per-frame path. The device form
(``on_device=True``) always runs ``n_iters`` steps and freezes the state
from the step that set ``done``, with no host read: the form a captured
CUDA graph can hold (the chunk loop).

``comm`` (``parallel.dist_ba``) makes one solve of a problem sharded over
several processes: each holds a share of the edge rows and the points
those edges see, the cameras in full. The solver sums its partial
accumulations where they must be combined and nothing else changes; with
``comm=None`` (every single-process caller) the solve is as it was.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import cameras, lie, linalg, robust


class BAProblem(NamedTuple):
    """Fixed-capacity BA problem (the local-BA subgraph of the reference's
    Optimizer.cc:1120-1210 as arrays)."""

    R: torch.Tensor  # [K,3,3] Tcw rotations
    t: torch.Tensor  # [K,3]
    cam_fixed: torch.Tensor  # [K] bool: gauge / fixed observers
    cam_valid: torch.Tensor  # [K] bool: slot in use
    X: torch.Tensor  # [P,3] world points
    pt_valid: torch.Tensor  # [P] bool
    cam_idx: torch.Tensor  # [E] int32
    pt_idx: torch.Tensor  # [E] int32
    uv: torch.Tensor  # [E,2]
    inv_sigma2: torch.Tensor  # [E]
    edge_valid: torch.Tensor  # [E] bool
    cam_params: torch.Tensor  # [9] shared pinhole
    ur: torch.Tensor  # [E] right-image x of a stereo edge, -1 = mono
    bf: torch.Tensor  # [] fx * baseline


class BAResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    X: torch.Tensor
    chi2: torch.Tensor  # [E] final sigma-normalized chi2
    inlier: torch.Tensor  # [E]
    cost: torch.Tensor  # [] final robust cost
    n_inliers: torch.Tensor  # [] int32
    # LM iterations run before rel_tol stopped the solve (the port's
    # addition): an int in the host form, a 0-d int32 tensor in the device form.
    iters: int | torch.Tensor


def ba_problem_from_numpy(arrays, device) -> BAProblem:
    """BAProblem on ``device`` from a mapping of numpy arrays keyed by
    field name and laid out like the JAX package's."""
    return BAProblem(**{
        k: torch.from_numpy(np.array(arrays[k], copy=True)).to(device)
        for k in BAProblem._fields
    })


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form (cofactor) batched 3x3 inverse; determinants below
    1e-20 in magnitude are clamped to 1e-20."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)
    cof = torch.stack(
        [
            torch.stack([A11, A12, A13], dim=-1),
            torch.stack([A21, A22, A23], dim=-1),
            torch.stack([A31, A32, A33], dim=-1),
        ],
        dim=-2,
    )
    return cof * inv_det[..., None, None]


def _edge_res_jac(R, t, X, uv, ur, bf, cam_params, cam_model: str = "pinhole"):
    """Per-edge 3-dim (u, v, u_r) residuals [E,3] and Jacobians w.r.t. the
    camera's left se3 perturbation [E,3,6] and the point [E,3,3]; the u_r
    row is zero on monocular edges (ur < 0), which reduces exactly to the
    2-dim case. ``cam_model`` selects the projection (pinhole | kb8); under
    KB8 every u_r row is zero, as in the JAX package (its stereo rows are
    the rectified pinhole's)."""
    Xc = torch.einsum("eij,ej->ei", R, X) + t
    pred = cameras.project_model(cam_params, Xc, cam_model)
    Jproj = cameras.project_jac_model(cam_params, Xc, cam_model)  # [E,2,3]
    has_st = (ur >= 0).to(X.dtype)
    if cam_model == "kb8":
        has_st = torch.zeros_like(has_st)
    z = Xc[:, 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    ur_pred = pred[:, 0] - bf / z_safe
    r = torch.cat([pred - uv, (has_st * (ur_pred - ur))[:, None]], dim=-1)
    # d(u_r)/dXc = d(u)/dXc + (bf / z^2) e_z
    e_z = torch.eye(3, dtype=X.dtype, device=X.device)[2]
    Jur = Jproj[:, 0] + e_z * (bf / z_safe**2)[:, None]
    Jproj3 = torch.cat([Jproj, (has_st[:, None] * Jur)[:, None]], dim=1)  # [E,3,3]
    eye = torch.eye(3, dtype=X.dtype, device=X.device).expand(X.shape[0], 3, 3)
    Jc = Jproj3 @ torch.cat([eye, -lie.hat(Xc)], dim=-1)
    Jp = Jproj3 @ R
    return r, Jc, Jp


def _gather_edges(prob: BAProblem, cam, pt, R, t, X, cam_model: str = "pinhole"):
    return _edge_res_jac(R[cam], t[cam], X[pt], prob.uv, prob.ur, prob.bf, prob.cam_params,
                         cam_model)


def _robust_cost(chi2, w_valid, delta2):
    """Huber cost summed over valid edges."""
    rho = torch.where(
        chi2 <= delta2, chi2, 2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=1e-12)) - delta2
    )
    return torch.sum(torch.where(w_valid, rho, torch.zeros_like(rho)))


def reduce(comm, over: str, *xs):
    """Sum each tensor of ``xs`` over the ranks of ``over`` in place and
    return them: "world" (all ranks: sums over edges), "obs" (the ranks that
    hold the same points: sums over points) or "pt" (the ranks with the same
    edge split). Without a communicator the tensors are returned as they
    are."""
    if comm is not None:
        comm.sum(over, *xs)
    return xs[0] if len(xs) == 1 else xs


def schur_rows(comm):
    """The points whose Schur products this rank adds (``comm.pt_rows``, a
    slice of its points; all of them without a communicator)."""
    return slice(None) if comm is None else comm.pt_rows


def bundle_adjust(
    prob: BAProblem,
    n_iters: int = 10,
    chi2_th: float = robust.CHI2_MONO,
    use_robust: bool = True,
    lam0: float = 1e-3,
    rel_tol: float = 0.0,
    on_device: bool = False,
    cam_model: str = "pinhole",
    comm=None,
) -> BAResult:
    """Run up to ``n_iters`` LM iterations of full BA on the problem
    (``cam_model``: the projection of its rows, pinhole | kb8).

    ``rel_tol``: stop once an accepted step improves the robust cost by
    less than ``rel_tol`` of its value (g2o's terminate action); 0 runs all
    ``n_iters``. ``on_device``: stop by freezing the state on the device
    instead of leaving the loop on the host (see the module docstring);
    the results are the same to the bit. A Cholesky that fails (an
    indefinite Schur matrix) gives NaN, as ``cho_factor`` does in the JAX
    package: the step's cost is NaN and the step is rejected.

    ``comm``: this rank's share of a sharded problem (see the module
    docstring): the camera blocks, the Schur products, the cost and the
    inlier count are summed over all ranks, the point blocks over the ranks
    that hold the same points; each rank adds the Schur products of its
    ``comm.pt_rows`` and back-substitutes all of its points."""
    K = prob.R.shape[0]
    P = prob.X.shape[0]
    dtype, dev = prob.R.dtype, prob.R.device
    cam = prob.cam_idx.long()
    pt = prob.pt_idx.long()
    # Per-edge chi2 threshold: 3-DoF stereo edges use the wider gate.
    delta2 = torch.where(
        prob.ur >= 0,
        torch.full_like(prob.ur, robust.CHI2_STEREO),
        torch.full_like(prob.ur, chi2_th),
    )
    zero = torch.zeros((), dtype=dtype, device=dev)

    def chi2_of(R, t, X):
        r, _, _ = _gather_edges(prob, cam, pt, R, t, X, cam_model)
        return torch.sum(r * r, dim=-1) * prob.inv_sigma2

    def cost_of(R, t, X):
        chi2 = chi2_of(R, t, X)
        if use_robust:
            return reduce(comm, "world", _robust_cost(chi2, prob.edge_valid, delta2))
        return reduce(comm, "world", torch.sum(torch.where(prob.edge_valid, chi2, zero)))

    eye6 = torch.eye(6, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    free = (prob.cam_valid & ~prob.cam_fixed).to(dtype)  # [K]
    diag = torch.arange(K, device=dev)
    wcp_row = cam * P + pt

    def step(R, t, X, lam, cost):
        r, Jc, Jp = _gather_edges(prob, cam, pt, R, t, X, cam_model)  # [E,3],[E,3,6],[E,3,3]
        chi2 = torch.sum(r * r, dim=-1) * prob.inv_sigma2
        w_rob = robust.huber_weight(chi2, delta2) if use_robust else torch.ones_like(chi2)
        w = prob.inv_sigma2 * w_rob * prob.edge_valid.to(dtype)  # [E]

        # Block accumulations (scatter-adds over the edge rows).
        JcW = Jc * w[:, None, None]
        JpW = Jp * w[:, None, None]
        Hcc = torch.zeros((K, 6, 6), dtype=dtype, device=dev).index_add_(
            0, cam, JcW.transpose(1, 2) @ Jc
        )
        Hpp = torch.zeros((P, 3, 3), dtype=dtype, device=dev).index_add_(
            0, pt, JpW.transpose(1, 2) @ Jp
        )
        gc = torch.zeros((K, 6), dtype=dtype, device=dev).index_add_(
            0, cam, -torch.einsum("eia,ei->ea", JcW, r)
        )
        gp = torch.zeros((P, 3), dtype=dtype, device=dev).index_add_(
            0, pt, -torch.einsum("eia,ei->ea", JpW, r)
        )
        Wcp = torch.zeros((K * P, 6, 3), dtype=dtype, device=dev).index_add_(
            0, wcp_row, JcW.transpose(1, 2) @ Jp
        ).reshape(K, P, 6, 3)
        reduce(comm, "world", Hcc, gc)
        reduce(comm, "obs", Hpp, gp, Wcp)

        # Damping (Marquardt: scale the diagonals).
        Hcc_d = Hcc + (lam * torch.diagonal(Hcc, dim1=-2, dim2=-1) + 1e-6)[..., :, None] * eye6
        Hpp_d = Hpp + (lam * torch.diagonal(Hpp, dim1=-2, dim2=-1) + 1e-6)[..., :, None] * eye3
        Hpp_inv = inv3x3(Hpp_d)  # [P,3,3]

        # Schur reduction onto the cameras.
        rows = schur_rows(comm)
        Y = torch.einsum("kpab,pbc->kpac", Wcp[:, rows], Hpp_inv[rows])  # [K,P,6,3]
        S = -torch.einsum("kpac,lpbc->klab", Y, Wcp[:, rows])  # [K,K,6,6]
        Yg = torch.einsum("kpab,pb->ka", Y, gp[rows])
        reduce(comm, "world", S, Yg)
        S[diag, diag] += Hcc_d
        rhs = gc - Yg  # [K,6]

        # Fixed / invalid cameras: identity rows and columns, zero rhs.
        S = S * free[:, None, None, None] * free[None, :, None, None]
        S[diag, diag] += (1.0 - free)[:, None, None] * eye6
        rhs = rhs * free[:, None]

        Smat = S.transpose(1, 2).reshape(K * 6, K * 6)
        delta_c = linalg.cho_solve(Smat, rhs.reshape(K * 6)).reshape(K, 6)
        delta_c = delta_c * free[:, None]

        # Back-substitute the points.
        rhs_p = gp - torch.einsum("kpab,ka->pb", Wcp, delta_c)
        delta_p = torch.einsum("pab,pb->pa", Hpp_inv, rhs_p)
        delta_p = delta_p * prob.pt_valid[:, None].to(dtype)

        # Candidate update (fixed cameras skip even the renormalization, so
        # they stay bit-identical).
        dR, dt = lie.se3_exp(delta_c)
        freeb = free > 0
        R_new = torch.where(freeb[:, None, None], lie.normalize_rotation(dR @ R), R)
        t_new = torch.where(freeb[:, None], torch.einsum("kij,kj->ki", dR, t) + dt, t)
        X_new = X + delta_p

        cost_new = cost_of(R_new, t_new, X_new)
        better = cost_new < cost
        # converged: the accepted step no longer moves the cost
        done = better & (cost - cost_new <= rel_tol * cost)
        R = torch.where(better, R_new, R)
        t = torch.where(better, t_new, t)
        X = torch.where(better, X_new, X)
        lam = torch.where(better, torch.clamp(lam * 0.4, min=1e-8), torch.clamp(lam * 5.0, max=1e6))
        cost = torch.where(better, cost_new, cost)
        return R, t, X, lam, cost, done

    R, t, X = prob.R, prob.t, prob.X
    lam = torch.full((), lam0, dtype=dtype, device=dev)
    cost = cost_of(R, t, X)
    if on_device:
        stopped = torch.zeros((), dtype=torch.bool, device=dev)
        iters = torch.zeros((), dtype=torch.int32, device=dev)
        for _ in range(n_iters):
            out = step(R, t, X, lam, cost)
            iters = iters + (~stopped).to(torch.int32)
            R, t, X, lam, cost = (torch.where(stopped, old, new)
                                  for old, new in zip((R, t, X, lam, cost), out[:5]))
            if rel_tol > 0.0:
                stopped = stopped | out[5]
    else:
        iters = 0
        while iters < n_iters:
            R, t, X, lam, cost, done = step(R, t, X, lam, cost)
            iters += 1
            if rel_tol > 0.0 and bool(done):
                break
    chi2 = chi2_of(R, t, X)
    inlier = prob.edge_valid & (chi2 <= delta2)
    return BAResult(
        R=R, t=t, X=X, chi2=chi2, inlier=inlier, cost=cost,
        n_inliers=reduce(comm, "world", torch.sum(inlier, dtype=torch.int32)), iters=iters,
    )
