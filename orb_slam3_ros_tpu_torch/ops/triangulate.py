"""DLT triangulation and fundamental-matrix composition, batched — port of
``orb_slam3_ros_tpu.ops.triangulate``.

The JAX package takes the DLT's null vector from ``jnp.linalg.eigh`` of
the 4x4 normal matrix. Here it comes from inverse iteration on a batched
inverse: cuSOLVER's ``eigh`` checks its convergence flags on the host,
which synchronizes and cannot be captured into a CUDA graph.
"""

from __future__ import annotations

import torch

from . import lie

DLT_ITERS = 3  # inverse-iteration steps: each multiplies the error by ~lambda0 / lambda1


def triangulate_dlt(ray1: torch.Tensor, ray2: torch.Tensor, R21: torch.Tensor, t21: torch.Tensor):
    """Two-view DLT in normalized coordinates.

    ray1, ray2: [..., 3] normalized coords (z = 1) in cameras 1 and 2;
    (R21, t21): pose of camera 1 in camera 2 (x2 = R21 x1 + t21).
    Returns X1 [..., 3], the points in the camera-1 frame, from the
    eigenvector of A^T A with the smallest eigenvalue (its sign cancels in
    the division by w): inverse iteration with B = (A^T A + d I)^-1, the
    shift d = 1e-7 trace keeping B finite without moving the eigenvectors,
    started from B's column with the largest diagonal entry (the direction
    the null vector dominates). No solver check and no host read. Closer to
    the float64 solution than float32 ``eigh`` at every parallax measured.
    """
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
    shift = 1e-7 * torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(4, dtype=AtA.dtype, device=AtA.device)
    B = torch.linalg.inv_ex(AtA + shift[..., None, None] * eye)[0]
    j = torch.argmax(torch.diagonal(B, dim1=-2, dim2=-1), dim=-1)
    h = torch.gather(B, -1, j[..., None, None].expand(B.shape[:-1] + (1,)))[..., 0]
    for _ in range(DLT_ITERS):
        h = h / torch.linalg.vector_norm(h, dim=-1, keepdim=True)
        h = (B @ h[..., None])[..., 0]
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
