"""SO(3) / SE(3) operations in torch — the subset of ``orb_slam3_ros_tpu.ops.lie``
that motion-only pose optimization needs.

Conventions are the JAX package's: rotations are 3x3 matrices, se(3)
tangent vectors are ``xi = [rho, phi]`` (translation first) with
``exp(xi) = (exp(phi^), J_l(phi) rho)``, and small-angle branches use
Taylor series selected with ``torch.where`` on sanitized inputs. Every
function is batched over leading dimensions.
"""

from __future__ import annotations

import torch

from . import linalg

_EPS = 1e-8  # theta^2 threshold below which Taylor branches take over


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: [..., 3] -> [..., 3, 3] skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def _sincos_coeffs(theta2: torch.Tensor):
    """(A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3), NaN-safe."""
    small = theta2 < _EPS
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    t = torch.sqrt(safe_t2)
    a_exact = torch.sin(t) / t
    b_exact = (1.0 - torch.cos(t)) / safe_t2
    c_exact = (t - torch.sin(t)) / (safe_t2 * t)
    a_taylor = 1.0 - theta2 / 6.0 + theta2 * theta2 / 120.0
    b_taylor = 0.5 - theta2 / 24.0 + theta2 * theta2 / 720.0
    c_taylor = 1.0 / 6.0 - theta2 / 120.0 + theta2 * theta2 / 5040.0
    return (
        torch.where(small, a_taylor, a_exact),
        torch.where(small, b_taylor, b_exact),
        torch.where(small, c_taylor, c_exact),
    )


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: [..., 3] -> [..., 3, 3]."""
    theta2 = torch.sum(phi * phi, dim=-1)
    A, B, _ = _sincos_coeffs(theta2)
    W = hat(phi)
    return _eye_like(W) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J_l of SO(3)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    _, B, C = _sincos_coeffs(theta2)
    W = hat(phi)
    return _eye_like(W) + B[..., None, None] * W + C[..., None, None] * (W @ W)


def se3_exp(xi: torch.Tensor):
    """exp: [..., 6] (rho, phi) -> (R [..., 3, 3], t [..., 3])."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = torch.einsum("...ij,...j->...i", so3_left_jacobian(phi), rho)
    return R, t


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] by the triple product (no LU launch)."""
    return torch.sum(M[..., 0, :] * torch.linalg.cross(M[..., 1, :], M[..., 2, :]), dim=-1)


def normalize_rotation(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation onto SO(3) via SVD (the reference's
    ``IMU::NormalizeRotation``); NaN for a matrix with a non-finite entry
    (an LM step from a failed Cholesky), as in the JAX package."""
    u, _, vt = linalg.svd(R)
    det = _det3(u @ vt)
    one = torch.ones_like(det)
    fix = torch.stack([one, one, det], dim=-1)
    return (u * fix[..., None, :]) @ vt
