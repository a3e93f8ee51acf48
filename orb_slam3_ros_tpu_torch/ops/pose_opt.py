"""Motion-only pose optimization: 6-DoF Levenberg-Marquardt over masked
reprojection edges — port of ``orb_slam3_ros_tpu.ops.pose_opt``.

The JAX solve is one ``lax.scan`` of rounds over a ``fori_loop`` of LM
steps; here both are Python loops over batched tensor ops, the accept /
reject of each step is a ``torch.where`` on a 0-d tensor, and nothing in
the loop reads a value back to the host (each read would be a device sync).
The damped normal equations go through ``torch.linalg.cholesky_ex`` (no
error check, hence no sync) + ``torch.cholesky_solve``.

Pose convention: Tcw (world -> camera), X_c = R X_w + t; the update is
left-multiplicative, T <- exp(delta) * T, with delta = [rho, phi].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import cameras, lie, robust


class PoseOptResult(NamedTuple):
    R: torch.Tensor  # [3, 3] optimized Rcw
    t: torch.Tensor  # [3]
    inlier: torch.Tensor  # [N] bool final chi2 classification
    n_inliers: torch.Tensor  # [] int32
    chi2: torch.Tensor  # [N] final per-edge chi2 (sigma-normalized)


def _residual_jac(R, t, Xw, uv, cam_params, cam_model: str = "pinhole"):
    """Per-edge reprojection residuals [N, 2] and Jacobians [N, 2, 6] with
    respect to the left-multiplicative se3 perturbation of Tcw (the JAX
    package's per-edge function with the edge axis written out);
    ``cam_model`` selects the projection (pinhole | kb8)."""
    Xc = Xw @ R.T + t
    r = cameras.project_model(cam_params, Xc, cam_model) - uv
    Jproj = cameras.project_jac_model(cam_params, Xc, cam_model)  # [N, 2, 3]
    # dXc/d[rho, phi] = [I, -hat(Xc)]
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(Xc.shape[0], 3, 3)
    JX = torch.cat([eye, -lie.hat(Xc)], dim=-1)  # [N, 3, 6]
    return r, Jproj @ JX


def pose_optimization(
    R0: torch.Tensor,
    t0: torch.Tensor,
    Xw: torch.Tensor,
    uv: torch.Tensor,
    inv_sigma2: torch.Tensor,
    valid: torch.Tensor,
    cam_params: torch.Tensor,
    rounds: int = 4,
    iters_per_round: int = 10,
    cam_model: str = "pinhole",
) -> PoseOptResult:
    """Optimize Tcw given fixed 3-D points and their observations.

    Args:
      R0, t0: initial Tcw.
      Xw: [N, 3] world points.
      uv: [N, 2] observed pixels (undistorted pinhole, or raw KB8).
      inv_sigma2: [N] per-edge information scale (1/sigma^2 by octave).
      valid: [N] bool — edge exists.
      cam_params: pinhole [9] or KB8 [8], as ``cam_model`` says.

    After each round, edges with sigma-normalized chi2 > CHI2_MONO leave
    the next round and may re-enter later (the reference's outlier schedule,
    Optimizer.cc:990-1022)."""
    chi2_th = robust.CHI2_MONO

    def residuals(R, t):
        return _residual_jac(R, t, Xw, uv, cam_params, cam_model)

    return _lm(residuals, R0, t0, inv_sigma2, valid, chi2_th, rounds, iters_per_round)


def _lm(residuals, R0, t0, inv_sigma2, valid, chi2_th, rounds: int, iters_per_round: int):
    """The LM ladder of the solves (this module's and ``twocam``'s): ``rounds`` x ``iters_per_round``
    damped Gauss-Newton steps on the Huber-weighted edges, each kept only if
    it lowers the cost, the edges above ``chi2_th`` (a float, or a per-edge
    tensor) reclassified after each round. ``residuals(R, t)`` gives the
    stacked residuals [N, D] and Jacobians [N, D, 6]."""
    dtype, dev = R0.dtype, R0.device
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    def compute_quad(R, t, active):
        r, J = residuals(R, t)
        chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
        w = inv_sigma2 * robust.huber_weight(chi2, chi2_th) * active.to(dtype)
        # H = sum_n J_n^T w_n J_n, g = -sum_n J_n^T w_n r_n as two matrix
        # products over the stacked residual rows (a three-operand einsum
        # would search a contraction path on the host at every call).
        Jw = (J * w[:, None, None]).reshape(-1, 6)
        H = Jw.T @ J.reshape(-1, 6)
        g = -(Jw.T @ r.reshape(-1))
        cost = torch.sum(torch.where(active, torch.clamp(chi2, max=chi2_th), 0.0))
        return H, g, cost, chi2

    R, t, active = R0, t0, valid
    lam = torch.full((), 1e-2, dtype=dtype, device=dev)
    for _ in range(rounds):
        for _ in range(iters_per_round):
            H, g, cost, _ = compute_quad(R, t, active)
            Hd = H + lam * torch.diag(torch.diag(H)) + 1e-8 * eye6
            L, _ = torch.linalg.cholesky_ex(Hd)
            delta = torch.cholesky_solve(g[:, None], L)[:, 0]
            dR, dt = lie.se3_exp(delta)
            R_new = lie.normalize_rotation(dR @ R)
            t_new = dR @ t + dt
            _, _, cost_new, _ = compute_quad(R_new, t_new, active)
            better = cost_new < cost
            R = torch.where(better, R_new, R)
            t = torch.where(better, t_new, t)
            lam = torch.where(
                better, torch.clamp(lam * 0.5, min=1e-6), torch.clamp(lam * 4.0, max=1e4)
            )
        # Reclassify outliers for the next round.
        _, _, _, chi2 = compute_quad(R, t, valid)
        active = valid & (chi2 <= chi2_th)
    _, _, _, chi2 = compute_quad(R, t, valid)
    inlier = valid & (chi2 <= chi2_th)
    return PoseOptResult(
        R=R, t=t, inlier=inlier, n_inliers=torch.sum(inlier, dtype=torch.int32), chi2=chi2
    )


def _residual_jac_stereo(R, t, Xw, uv, ur, bf, cam_params):
    """(u, v, u_r) residuals [N, 3] and Jacobians [N, 3, 6] — the
    reference's EdgeStereoSE3ProjectXYZOnlyPose (G2oTypes.h:466); the u_r
    row is zero on monocular edges (ur < 0)."""
    Xc = Xw @ R.T + t
    pred = cameras.pinhole_project_nodist(cam_params, Xc)
    Jproj = cameras.pinhole_project_jac(cam_params, Xc)  # [N, 2, 3]
    has_st = (ur >= 0).to(Xc.dtype)
    z = Xc[:, 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    r = torch.cat([pred - uv, (has_st * (pred[:, 0] - bf / z_safe - ur))[:, None]], dim=-1)
    # d(u - bf / z)/dXc: the u row with bf / z^2 added to its z entry
    Jur = torch.cat([Jproj[:, 0, :2], (Jproj[:, 0, 2] + bf / z_safe**2)[:, None]], dim=-1)
    Jproj3 = torch.cat([Jproj, (has_st[:, None] * Jur)[:, None]], dim=1)  # [N, 3, 3]
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(Xc.shape[0], 3, 3)
    JX = torch.cat([eye, -lie.hat(Xc)], dim=-1)
    return r, Jproj3 @ JX


def pose_optimization_stereo(
    R0: torch.Tensor,
    t0: torch.Tensor,
    Xw: torch.Tensor,
    uv: torch.Tensor,
    ur: torch.Tensor,
    bf,
    inv_sigma2: torch.Tensor,
    valid: torch.Tensor,
    cam_params: torch.Tensor,
    rounds: int = 2,
    iters_per_round: int = 6,
) -> PoseOptResult:
    """Motion-only pose optimization over mixed mono / stereo edges
    (PoseOptimization's stereo branch, Optimizer.cc:816/:900): ``ur`` [N]
    holds the right-image x of each edge, -1 on a monocular one; ``bf`` =
    fx * baseline (a float or a 0-d tensor). A stereo edge adds the
    disparity residual; the chi2 gates are per DoF (5.991 mono, 7.815
    stereo)."""
    delta2 = torch.where(ur >= 0, robust.CHI2_STEREO, robust.CHI2_MONO).to(R0.dtype)

    def residuals(R, t):
        return _residual_jac_stereo(R, t, Xw, uv, ur, bf, cam_params)

    return _lm(residuals, R0, t0, inv_sigma2, valid, delta2, rounds, iters_per_round)
