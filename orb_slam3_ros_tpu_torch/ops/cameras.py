"""Camera models in torch — port of ``orb_slam3_ros_tpu.ops.cameras``:
the pinhole (projection, its Jacobian, the iterative unprojection) and the
Kannala-Brandt-8 fisheye (KannalaBrandt8.cpp), selected by name through the
``*_model`` dispatchers.

Parameter layouts: pinhole ``[fx, fy, cx, cy, k1, k2, p1, p2, k3]``
(distortion zeros = none); KB8 ``[fx, fy, cx, cy, k0, k1, k2, k3]`` with
r(theta) = theta + k0 theta^3 + k1 theta^5 + k2 theta^7 + k3 theta^9.

The JAX package takes the KB8 Jacobian by forward-mode AD of the
projection; here it is written in closed form (the same derivative,
including the floor of the radial distance near the optical axis), with no
host read, so that it runs inside a captured CUDA graph.
"""

from __future__ import annotations

import math

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


def kb8_project(params: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """KB8 fisheye projection of camera-frame points [..., 3] to pixels
    [..., 2] (KannalaBrandt8.cpp:34-60)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k0, k1, k2, k3 = params[4], params[5], params[6], params[7]
    x, y, z = X[..., 0], X[..., 1], X[..., 2]
    R2d = torch.sqrt(x * x + y * y)
    R2d_safe = torch.where(R2d < 1e-9, torch.full_like(R2d, 1e-9), R2d)
    theta = torch.atan2(R2d, z)
    th2 = theta * theta
    r = theta * (1.0 + th2 * (k0 + th2 * (k1 + th2 * (k2 + th2 * k3))))
    return torch.stack([fx * r * x / R2d_safe + cx, fy * r * y / R2d_safe + cy], dim=-1)


def kb8_unproject(params: torch.Tensor, uv: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Pixels [..., 2] -> rays [..., 3] with z = 1: ``iters`` Newton steps
    on the theta polynomial from theta = r, the distorted radius clamped to
    pi (the reference's theta_d bound, KannalaBrandt8.cpp:110-145). Beyond
    theta = pi/2 the ray's tan(theta) < 0 and it points backwards, as in the
    JAX package."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k0, k1, k2, k3 = params[4], params[5], params[6], params[7]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    r = torch.clamp(torch.sqrt(mx * mx + my * my), max=math.pi)
    theta = r
    for _ in range(iters):
        th2 = theta * theta
        f = theta * (1.0 + th2 * (k0 + th2 * (k1 + th2 * (k2 + th2 * k3)))) - r
        fp = 1.0 + th2 * (3 * k0 + th2 * (5 * k1 + th2 * (7 * k2 + th2 * 9 * k3)))
        theta = theta - f / torch.where(torch.abs(fp) < 1e-9, torch.full_like(fp, 1e-9), fp)
    small = r < 1e-9
    scale = torch.where(small, torch.ones_like(r),
                        torch.tan(theta) / torch.where(small, torch.ones_like(r), r))
    return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], dim=-1)


def kb8_project_jac(params: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """d(uv)/dX of ``kb8_project``: [..., 2, 3], in closed form. It is the
    derivative forward-mode AD takes of the projection as written: the
    floored radial distance (below 1e-9) is a constant there, and on the
    optical axis itself (x = y = 0, where AD gives NaN) the radial terms are
    taken as 0."""
    fx, fy = params[0], params[1]
    k0, k1, k2, k3 = params[4], params[5], params[6], params[7]
    x, y, z = X[..., 0], X[..., 1], X[..., 2]
    s2 = x * x + y * y
    s = torch.sqrt(s2)
    floored = s < 1e-9
    s_safe = torch.where(floored, torch.full_like(s, 1e-9), s)
    theta = torch.atan2(s, z)
    th2 = theta * theta
    r = theta * (1.0 + th2 * (k0 + th2 * (k1 + th2 * (k2 + th2 * k3))))
    dr = 1.0 + th2 * (3 * k0 + th2 * (5 * k1 + th2 * (7 * k2 + th2 * 9 * k3)))
    den = s2 + z * z
    den = torch.where(den > 0, den, torch.ones_like(den))
    # d(theta)/ds and d(theta)/dz of atan2(s, z)
    dth_ds = z / den
    dth_dz = -s / den
    # ds/dx, ds/dy (0 on the axis itself)
    on_axis = s <= 0
    s_div = torch.where(on_axis, torch.ones_like(s), s)
    dsx = torch.where(on_axis, torch.zeros_like(x), x / s_div)
    dsy = torch.where(on_axis, torch.zeros_like(y), y / s_div)
    # the floor's derivative: 0 where it holds
    dfx = torch.where(floored, torch.zeros_like(dsx), dsx)
    dfy = torch.where(floored, torch.zeros_like(dsy), dsy)
    inv = 1.0 / s_safe
    a = dr * dth_ds  # dr/ds
    rs2 = r * inv * inv
    # u = fx r x / s_safe, v = fy r y / s_safe
    du_dx = fx * (a * dsx * x * inv + r * inv - rs2 * x * dfx)
    du_dy = fx * (a * dsy * x * inv - rs2 * x * dfy)
    du_dz = fx * dr * dth_dz * x * inv
    dv_dx = fy * (a * dsx * y * inv - rs2 * y * dfx)
    dv_dy = fy * (a * dsy * y * inv + r * inv - rs2 * y * dfy)
    dv_dz = fy * dr * dth_dz * y * inv
    row0 = torch.stack([du_dx, du_dy, du_dz], dim=-1)
    row1 = torch.stack([dv_dx, dv_dy, dv_dz], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def fx_bearings(params: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """KB8 pixels [..., 2] -> their bearings' (x/z, y/z) scaled by fx: the
    pixels of ``bearing_camera``, a centred virtual pinhole, in which
    tolerances keep their pixel meaning near the image centre."""
    return kb8_unproject(params, uv)[..., :2] * params[0]


def bearing_camera(params: torch.Tensor) -> torch.Tensor:
    """The centred virtual pinhole [fx, fx, 0, 0, 0...] [9] of a KB8
    camera's ``fx_bearings`` (built on the device, no host read)."""
    fx = params[0:1]
    return torch.cat([fx, fx, torch.zeros(7, dtype=fx.dtype, device=fx.device)])


MODELS = ("pinhole", "kb8")


def check_model(model: str) -> None:
    if model not in MODELS:
        raise ValueError(f"unknown camera model {model!r} (one of {MODELS})")


def project_model(params, X, model: str = "pinhole"):
    """Distortion-free projection under ``model`` (the optimizer's forward
    model: pinhole on undistorted observations, KB8 on raw fisheye
    pixels)."""
    if model == "kb8":
        return kb8_project(params, X)
    return pinhole_project_nodist(params, X)


def project_jac_model(params, X, model: str = "pinhole"):
    if model == "kb8":
        return kb8_project_jac(params, X)
    return pinhole_project_jac(params, X)


def unproject_model(params, uv, model: str = "pinhole"):
    """Pixels -> rays (z = 1) under ``model``."""
    if model == "kb8":
        return kb8_unproject(params, uv)
    return pinhole_unproject(params, uv)


def in_image(uv: torch.Tensor, width: int, height: int, margin: float = 0.0):
    """Frustum bounds check (image-bounds part of ``Frame::isInFrustum``)."""
    return (
        (uv[..., 0] >= margin)
        & (uv[..., 0] < width - margin)
        & (uv[..., 1] >= margin)
        & (uv[..., 1] < height - margin)
    )
