"""Map-scale bundle adjustment: matrix-free preconditioned conjugate
gradients on the Schur complement — port of
``orb_slam3_ros_tpu.ops.ba_pcg`` (the role of the reference's
``Optimizer::GlobalBundleAdjustemnt``, Optimizer.cc:52), with pinhole and
KB8 rows (``cam_model``; under KB8 the u_r rows are zero, as in
``ba.bundle_adjust``).

The reduced camera system S = Hcc - W Hpp^-1 W^T is never formed. A
product S x is gathers over the edge table and two ``index_add_`` scatters
(edges to points, edges to cameras) with a batched 3x3 point solve between
them; the preconditioner is block Jacobi on the exact 6x6 diagonal blocks of
S. Each LM iteration runs ``n_cg`` CG steps, the iterations run a fixed
number of times, and accept / reject / damping stay on the device (the LM
loop of ``ba.bundle_adjust``): a solve reads nothing back to the host,
and on the card it is one replay of a CUDA graph (``graphs.replay``).
Scatter-adds sum in an order of their own, so results agree with the JAX
package's to float32 round-off, not to the bit.
"""

from __future__ import annotations

import torch

from . import ba, cameras, graphs, lie, linalg, robust
from .ba import BAProblem, BAResult


def bundle_adjust_pcg(
    prob: BAProblem,
    n_iters: int = 10,
    n_cg: int = 50,
    chi2_th: float = robust.CHI2_MONO,
    use_robust: bool = True,
    lam0: float = 1e-3,
    cam_model: str = "pinhole",
) -> BAResult:
    """LM bundle adjustment with matrix-free Schur-PCG camera solves, the
    contract of ``ba.bundle_adjust`` with all ``n_iters`` iterations run.
    ``cam_model``: the projection of the rows (pinhole | kb8)."""
    cameras.check_model(cam_model)
    return graphs.replay(_solve, prob, n_iters, n_cg, chi2_th, use_robust, lam0, cam_model)


def _solve(prob: BAProblem, n_iters: int, n_cg: int, chi2_th: float, use_robust: bool,
           lam0: float, cam_model: str = "pinhole") -> BAResult:
    K, P = prob.R.shape[0], prob.X.shape[0]
    dtype, dev = prob.R.dtype, prob.R.device
    cam, pt = prob.cam_idx.long(), prob.pt_idx.long()
    delta2 = torch.where(prob.ur >= 0, torch.full_like(prob.ur, robust.CHI2_STEREO),
                         torch.full_like(prob.ur, chi2_th))
    zero = torch.zeros((), dtype=dtype, device=dev)

    def chi2_of(R, t, X):
        r, _, _ = ba._gather_edges(prob, cam, pt, R, t, X, cam_model)
        return torch.sum(r * r, dim=-1) * prob.inv_sigma2

    def cost_of(R, t, X):
        chi2 = chi2_of(R, t, X)
        if use_robust:
            return ba._robust_cost(chi2, prob.edge_valid, delta2)
        return torch.sum(torch.where(prob.edge_valid, chi2, zero))

    def to_cams(v):
        return torch.zeros((K,) + v.shape[1:], dtype=dtype, device=dev).index_add_(0, cam, v)

    def to_pts(v):
        return torch.zeros((P,) + v.shape[1:], dtype=dtype, device=dev).index_add_(0, pt, v)

    free = (prob.cam_valid & ~prob.cam_fixed).to(dtype)  # [K]
    ptm = prob.pt_valid.to(dtype)  # [P]
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    def step(R, t, X, lam, cost):
        r, Jc, Jp = ba._gather_edges(prob, cam, pt, R, t, X, cam_model)  # [E,3],[E,3,6],[E,3,3]
        chi2 = torch.sum(r * r, dim=-1) * prob.inv_sigma2
        w_rob = robust.huber_weight(chi2, delta2) if use_robust else torch.ones_like(chi2)
        w = prob.inv_sigma2 * w_rob * prob.edge_valid.to(dtype)
        JcW = Jc * w[:, None, None]
        JpW = Jp * w[:, None, None]
        Hcc = to_cams(JcW.transpose(1, 2) @ Jc)
        Hpp = to_pts(JpW.transpose(1, 2) @ Jp)
        gc = to_cams(-torch.einsum("eia,ei->ea", JcW, r))
        gp = to_pts(-torch.einsum("eia,ei->ea", JpW, r))
        Hcc_d = Hcc + (lam * torch.diagonal(Hcc, dim1=-2, dim2=-1) + 1e-6)[..., :, None] * eye6
        Hpp_d = Hpp + (lam * torch.diagonal(Hpp, dim1=-2, dim2=-1) + 1e-6)[..., :, None] * eye3
        Hpp_inv = ba.inv3x3(Hpp_d) * ptm[:, None, None]

        # rhs = gc - W Hpp^-1 gp, matrix-free
        zg = torch.einsum("pab,pb->pa", Hpp_inv, gp)
        v = torch.einsum("eia,eib,eb->ea", JcW, Jp, zg[pt])
        rhs = (gc - to_cams(v)) * free[:, None]

        # the exact 6x6 diagonal blocks of S for block Jacobi
        We = JcW.transpose(1, 2) @ Jp  # [E,6,3]
        De = We @ Hpp_inv[pt] @ We.transpose(1, 2)  # [E,6,6]
        S_diag = Hcc_d - to_cams(De)
        S_diag = S_diag * free[:, None, None] + (1.0 - free)[:, None, None] * eye6
        Minv = linalg.inv(S_diag)

        def S_mv(x):  # [K,6] -> [K,6]
            xm = x * free[:, None]
            te = torch.einsum("eia,ea->ei", Jc, xm[cam])
            y = to_pts(torch.einsum("eib,ei->eb", JpW, te))
            z = torch.einsum("pab,pb->pa", Hpp_inv, y)
            ve = torch.einsum("eia,ei->ea", JcW, torch.einsum("eib,eb->ei", Jp, z[pt]))
            return (torch.einsum("kab,kb->ka", Hcc_d, xm) - to_cams(ve)) * free[:, None]

        def safe(d):
            return torch.where(torch.abs(d) < 1e-20, torch.full_like(d, 1e-20), d)

        x = torch.zeros((K, 6), dtype=dtype, device=dev)
        rr = rhs
        p = torch.einsum("kab,kb->ka", Minv, rr)
        rz = torch.sum(rr * p)
        for _ in range(n_cg):
            Sp = S_mv(p)
            alpha = rz / safe(torch.sum(p * Sp))
            x = x + alpha * p
            rr = rr - alpha * Sp
            z = torch.einsum("kab,kb->ka", Minv, rr)
            rz_new = torch.sum(rr * z)
            p = z + (rz_new / safe(rz)) * p
            rz = rz_new
        delta_c = x * free[:, None]

        # back-substitute the points: delta_p = Hpp^-1 (gp - W^T delta_c)
        te = torch.einsum("eia,ea->ei", Jc, delta_c[cam])
        Wt_dc = to_pts(torch.einsum("eib,ei->eb", JpW, te))
        delta_p = torch.einsum("pab,pb->pa", Hpp_inv, gp - Wt_dc) * ptm[:, None]

        dR, dt = lie.se3_exp(delta_c)
        freeb = free > 0
        R_new = torch.where(freeb[:, None, None], lie.normalize_rotation(dR @ R), R)
        t_new = torch.where(freeb[:, None], torch.einsum("kij,kj->ki", dR, t) + dt, t)
        X_new = X + delta_p
        cost_new = cost_of(R_new, t_new, X_new)
        better = cost_new < cost
        R = torch.where(better, R_new, R)
        t = torch.where(better, t_new, t)
        X = torch.where(better, X_new, X)
        lam = torch.where(better, torch.clamp(lam * 0.4, min=1e-8), torch.clamp(lam * 5.0, max=1e6))
        return R, t, X, lam, torch.where(better, cost_new, cost)

    R, t, X = prob.R, prob.t, prob.X
    lam = torch.full((), lam0, dtype=dtype, device=dev)
    cost = cost_of(R, t, X)
    for _ in range(n_iters):
        R, t, X, lam, cost = step(R, t, X, lam, cost)
    chi2 = chi2_of(R, t, X)
    inlier = prob.edge_valid & (chi2 <= delta2)
    return BAResult(
        R=R, t=t, X=X, chi2=chi2, inlier=inlier, cost=cost,
        n_inliers=torch.sum(inlier, dtype=torch.int32), iters=n_iters,
    )
