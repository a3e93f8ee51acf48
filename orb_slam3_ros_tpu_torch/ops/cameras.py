"""Pinhole camera model in torch — port of the pinhole half of
``orb_slam3_ros_tpu.ops.cameras`` (projection, its Jacobian and the
iterative unprojection).

Parameter layout: ``[fx, fy, cx, cy, k1, k2, p1, p2, k3]`` (distortion
zeros = none). Kannala-Brandt-8 waits for the fisheye slice: the
``*_model`` dispatchers raise ``NotImplementedError`` for ``"kb8"``.
"""

from __future__ import annotations

import torch


def _safe_inv_z(z: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def pinhole_project(params: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Project camera-frame points [..., 3] to pixels [..., 2], applying
    radial-tangential distortion where the k-params are nonzero."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k1, k2, p1, p2, k3 = params[4], params[5], params[6], params[7], params[8]
    inv_z = _safe_inv_z(X[..., 2])
    x = X[..., 0] * inv_z
    y = X[..., 1] * inv_z
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([fx * xd + cx, fy * yd + cy], dim=-1)


def pinhole_unproject(params: torch.Tensor, uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Pixels [..., 2] -> normalized camera rays [..., 3] with z = 1, by
    ``iters`` fixpoint iterations of the radial-tangential undistortion
    (the cv::undistortPoints scheme)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k1, k2, p1, p2, k3 = params[4], params[5], params[6], params[7], params[8]
    xd = (uv[..., 0] - cx) / fx
    yd = (uv[..., 1] - cy) / fy
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = (xd - dx) / radial, (yd - dy) / radial
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def pinhole_project_jac(params: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """d(uv)/dX for the undistorted pinhole: [..., 2, 3]."""
    fx, fy = params[0], params[1]
    x, y = X[..., 0], X[..., 1]
    inv_z = _safe_inv_z(X[..., 2])
    inv_z2 = inv_z * inv_z
    zero = torch.zeros_like(x)
    row0 = torch.stack([fx * inv_z, zero, -fx * x * inv_z2], dim=-1)
    row1 = torch.stack([zero, fy * inv_z, -fy * y * inv_z2], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def pinhole_project_nodist(params: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Distortion-free projection (the optimizer's model)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    inv_z = _safe_inv_z(X[..., 2])
    return torch.stack(
        [fx * X[..., 0] * inv_z + cx, fy * X[..., 1] * inv_z + cy], dim=-1
    )


def _pinhole_only(model: str) -> None:
    if model != "pinhole":
        raise NotImplementedError(
            f"camera model {model!r} is not ported yet (ROADMAP Queue 1 item 6)"
        )


def project_model(params, X, model: str = "pinhole"):
    """Distortion-free projection under ``model``."""
    _pinhole_only(model)
    return pinhole_project_nodist(params, X)


def project_jac_model(params, X, model: str = "pinhole"):
    _pinhole_only(model)
    return pinhole_project_jac(params, X)


def unproject_model(params, uv, model: str = "pinhole"):
    """Pixels -> normalized rays (z = 1) under ``model``."""
    _pinhole_only(model)
    return pinhole_unproject(params, uv)


def in_image(uv: torch.Tensor, width: int, height: int, margin: float = 0.0):
    """Frustum bounds check (image-bounds part of ``Frame::isInFrustum``)."""
    return (
        (uv[..., 0] >= margin)
        & (uv[..., 0] < width - margin)
        & (uv[..., 1] >= margin)
        & (uv[..., 1] < height - margin)
    )
