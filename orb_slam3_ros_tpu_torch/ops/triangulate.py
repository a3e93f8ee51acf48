"""DLT triangulation and fundamental-matrix composition, batched — port of
``orb_slam3_ros_tpu.ops.triangulate``.

The 4x4 DLT systems go through ``torch.linalg.eigh`` (cuSOLVER on the
card, by way of ``linalg.eigh``), as the JAX package leaves them to
``jnp.linalg.eigh``.
"""

from __future__ import annotations

import torch

from . import lie, linalg


def triangulate_dlt(ray1: torch.Tensor, ray2: torch.Tensor, R21: torch.Tensor, t21: torch.Tensor):
    """Two-view DLT in normalized coordinates.

    ray1, ray2: [..., 3] normalized coords (z = 1) in cameras 1 and 2;
    (R21, t21): pose of camera 1 in camera 2 (x2 = R21 x1 + t21).
    Returns X1 [..., 3], the points in the camera-1 frame, from the
    eigenvector of A^T A with the smallest eigenvalue (its sign cancels in
    the division by w)."""
    x1, y1 = ray1[..., 0], ray1[..., 1]
    x2, y2 = ray2[..., 0], ray2[..., 1]
    P2 = torch.cat([R21, t21[..., None]], dim=-1)  # [3, 4]
    zero, one = torch.zeros_like(x1), torch.ones_like(x1)
    row0 = torch.stack([one, zero, -x1, zero], dim=-1)
    row1 = torch.stack([zero, one, -y1, zero], dim=-1)
    row2 = x2[..., None] * P2[2] - P2[0]
    row3 = y2[..., None] * P2[2] - P2[1]
    A = torch.stack([row0, row1, row2, row3], dim=-2)  # [..., 4, 4]
    AtA = A.transpose(-1, -2) @ A
    _, vecs = linalg.eigh(AtA)
    h = vecs[..., :, 0]  # eigenvector of the smallest eigenvalue
    w = h[..., 3]
    w_safe = torch.where(torch.abs(w) < 1e-9, torch.full_like(w, 1e-9), w)
    return h[..., :3] / w_safe[..., None]


def fundamental_from_poses(K1: torch.Tensor, K2: torch.Tensor, R12: torch.Tensor, t12: torch.Tensor):
    """F = K2^-T [t21]_x R21 K1^-1, mapping homogeneous pixels of image 1
    to epipolar lines of image 2, where (R12, t12) maps camera-2 coords
    into camera 1 (the reference's ``GeometricTools::ComputeF12``)."""
    R21 = R12.T
    t21 = -R12.T @ t12
    E = lie.hat(t21) @ R21
    K1inv = torch.linalg.inv_ex(K1)[0]
    K2inv = torch.linalg.inv_ex(K2)[0]
    return K2inv.T @ E @ K1inv


def K_matrix(params: torch.Tensor) -> torch.Tensor:
    """3x3 intrinsics from ``[fx, fy, cx, cy, ...]``."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    return torch.stack([
        torch.stack([fx, zero, cx]),
        torch.stack([zero, fy, cy]),
        torch.stack([zero, zero, one]),
    ])


def parallax_cos(X1: torch.Tensor, C2_in_1: torch.Tensor):
    """Cosine of the parallax angle at each point between the two camera
    centres (the reference's cosParallaxRays checks)."""
    d2 = X1 - C2_in_1
    n1 = torch.linalg.norm(X1, dim=-1)
    n2 = torch.linalg.norm(d2, dim=-1)
    return torch.sum(X1 * d2, dim=-1) / torch.clamp(n1 * n2, min=1e-12)
