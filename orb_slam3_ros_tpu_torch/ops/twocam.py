"""Two-camera (non-rectified) frames: cross-camera triangulation and the
body-frame observation factor — port of ``orb_slam3_ros_tpu.ops.twocam``.

Role of the reference's fisheye-stereo machinery: ``Frame``'s two-camera
constructor with the left-to-right extrinsic ``Tlr`` (Frame.h:346),
``ComputeStereoFishEyeMatches`` (Frame.cc:1126: a brute-force descriptor
match between the two views, triangulation and reprojection gates; no
rectified row search, which a fisheye's epipolar curves rule out), and
``EdgeSE3ProjectXYZToBody`` (OptimizableTypes.h:118-196: a landmark seen by
the second camera projects through T_rl * T_lw).

The cross match is ``matching.search_frame_frame`` (the dense Hamming
product in torch); the triangulation is the batched DLT over the two
views' rays; the refinement is ``pose_opt``'s LM ladder over one edge table
of mixed left / right rows, a per-row mask picking the camera.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import cameras, hamming, lie, matching, robust, triangulate
from .orb import Features
from .pose_opt import PoseOptResult, _lm


class CrossCamTriangulation(NamedTuple):
    X_l: torch.Tensor  # [N, 3] points in the left camera's frame
    right_feat: torch.Tensor  # [N] int32 matched feature index in the right view
    ok: torch.Tensor  # [N] bool
    n_new: torch.Tensor  # [] int32


def triangulate_cross_camera(
    f_left: Features,
    f_right: Features,
    R_rl: torch.Tensor,
    t_rl: torch.Tensor,
    cam_params_l: torch.Tensor,
    cam_params_r: torch.Tensor,
    cam_model: str = "kb8",
    scale: float = 1.2,
    max_dist: int = hamming.TH_LOW,
    max_level: int = 2,
) -> CrossCamTriangulation:
    """ComputeStereoFishEyeMatches (Frame.cc:1126-1227): descriptor match
    left <-> right, DLT triangulation of each matched pair of rays
    (X_r = R_rl X_l + t_rl), then the gates: both features at most
    ``max_level`` (a coarse level's position noise against a few pixels of
    disparity biases the surviving depths shallow), a finite point in
    front of both cameras (z > 0.02) and the reprojection chi2 in both
    views."""
    idx, _ = matching.search_frame_frame(f_left, f_right, max_dist=max_dist, ratio=0.8)
    matched = idx >= 0
    ridx = torch.clamp(idx, 0, f_right.xy.shape[0] - 1).long()
    xy_r = f_right.xy[ridx]
    lvl_r = f_right.level[ridx]
    rays_l = cameras.unproject_model(cam_params_l, f_left.xy, cam_model)
    rays_r = cameras.unproject_model(cam_params_r, xy_r, cam_model)
    X_l = triangulate.triangulate_dlt(rays_l, rays_r, R_rl, t_rl)
    X_r = X_l @ R_rl.T + t_rl
    e_l = torch.sum((cameras.project_model(cam_params_l, X_l, cam_model) - f_left.xy) ** 2, -1)
    e_r = torch.sum((cameras.project_model(cam_params_r, X_r, cam_model) - xy_r) ** 2, -1)
    sig2_l = scale ** (2.0 * f_left.level.to(torch.float32))
    sig2_r = scale ** (2.0 * lvl_r.to(torch.float32))
    ok = (
        matched
        & (f_left.level <= max_level)
        & (lvl_r <= max_level)
        & torch.all(torch.isfinite(X_l), dim=-1)
        & (X_l[:, 2] > 0.02)
        & (X_r[:, 2] > 0.02)
        & (e_l < robust.CHI2_MONO * sig2_l)
        & (e_r < robust.CHI2_MONO * sig2_r)
    )
    return CrossCamTriangulation(X_l=X_l, right_feat=ridx.to(torch.int32), ok=ok,
                                 n_new=torch.sum(ok, dtype=torch.int32))


def _residual_jac_body(R, t, Xw, uv, is_right, R_rl, t_rl, cam_params, cam_model: str):
    """Reprojection residuals [N, 2] and Jacobians [N, 2, 6] of mixed
    left / right rows: a left row projects X_c = R X_w + t, a right row
    R_rl X_c + t_rl (EdgeSE3ProjectXYZToBody); the perturbation is the
    left camera's."""
    Xc = Xw @ R.T + t
    Xr = Xc @ R_rl.T + t_rl
    Xuse = torch.where(is_right[:, None], Xr, Xc)
    r = cameras.project_model(cam_params, Xuse, cam_model) - uv
    Jproj = cameras.project_jac_model(cam_params, Xuse, cam_model)  # [N, 2, 3]
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(Xc.shape[0], 3, 3)
    JX = torch.cat([eye, -lie.hat(Xc)], dim=-1)  # dXc/d[rho, phi], [N, 3, 6]
    JX = torch.where(is_right[:, None, None], R_rl @ JX, JX)
    return r, Jproj @ JX


def pose_optimization_two_cam(
    R0: torch.Tensor,
    t0: torch.Tensor,
    Xw: torch.Tensor,
    uv: torch.Tensor,
    is_right: torch.Tensor,
    R_rl: torch.Tensor,
    t_rl: torch.Tensor,
    inv_sigma2: torch.Tensor,
    valid: torch.Tensor,
    cam_params: torch.Tensor,
    rounds: int = 3,
    iters_per_round: int = 8,
    chi2_th: float = robust.CHI2_MONO,
    cam_model: str = "kb8",
) -> PoseOptResult:
    """Motion-only pose optimization of T_lw over mixed left / right edges
    (``is_right`` [N] bool: the row is the second camera's) — the
    two-camera branch of PoseOptimization (Optimizer.cc:816): right rows
    constrain the left pose through the fixed T_rl."""

    def residuals(R, t):
        return _residual_jac_body(R, t, Xw, uv, is_right, R_rl, t_rl, cam_params, cam_model)

    return _lm(residuals, R0, t0, inv_sigma2, valid, chi2_th, rounds, iters_per_round)
