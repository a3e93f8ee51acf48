"""Fisheye (KB8) input through rectification to a virtual pinhole — port of
``orb_slam3_ros_tpu.ops.rectify``.

Role of the reference's rectification maps
(``Settings::precomputeRectificationMaps``, cv::initUndistortRectifyMap +
cv::remap): the sampling map is computed once, then every frame is one
bilinear gather, and the rectified stream feeds the pinhole ``MonoSlam``.
The native alternative, tracking on raw fisheye pixels, is
``MonoSlam(cam_model="kb8")``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cameras


def kb8_rect_map(kb8_params, pin_params, height: int, width: int) -> torch.Tensor:
    """The sampling map: for each rectified (pinhole) pixel, the fisheye
    pixel it takes its value from. Returns [H, W, 2] float32 (x, y) on the
    device of ``kb8_params`` (a tensor; numpy arrays go to the CPU)."""
    kb8 = torch.as_tensor(kb8_params, dtype=torch.float32)
    pin = torch.as_tensor(pin_params, dtype=torch.float32, device=kb8.device)
    ys = torch.arange(height, dtype=torch.float32, device=kb8.device)
    xs = torch.arange(width, dtype=torch.float32, device=kb8.device)
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    uv = torch.stack([xg, yg], dim=-1).reshape(-1, 2)
    rays = cameras.pinhole_unproject(pin, uv)  # z = 1
    return cameras.kb8_project(kb8, rays).reshape(height, width, 2)


def remap_bilinear(img: torch.Tensor, smap: torch.Tensor) -> torch.Tensor:
    """Bilinear remap (the cv::remap role): ``img`` [h, w] sampled at
    ``smap`` [H, W, 2]; samples whose 2x2 neighbourhood leaves the image
    are 0. Returns [H, W] float32."""
    img = img.to(torch.float32)
    h, w = img.shape
    x, y = smap[..., 0], smap[..., 1]
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = x - x0f, y - y0f
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    valid = (x0 >= 0) & (x0 < w - 1) & (y0 >= 0) & (y0 < h - 1)
    x0c = torch.clamp(x0, 0, w - 2)
    y0c = torch.clamp(y0, 0, h - 2)
    flat = img.reshape(-1)
    i00 = y0c * w + x0c
    v00, v01 = flat[i00], flat[i00 + 1]
    v10, v11 = flat[i00 + w], flat[i00 + w + 1]
    out = (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
           + v10 * (1 - fx) * fy + v11 * fx * fy)
    return torch.where(valid, out, torch.zeros_like(out))


def virtual_pinhole_params(kb8_params, height: int, width: int,
                           fov_scale: float = 0.72) -> np.ndarray:
    """A virtual pinhole for a KB8 camera: the principal point at the image
    centre, f = the fisheye's f / ``fov_scale`` (smaller: a wider rectified
    field of view, more stretch at the edges). Returns [9] float32."""
    kb8 = np.asarray(kb8_params.cpu() if isinstance(kb8_params, torch.Tensor) else kb8_params,
                     np.float32)
    fx = float(kb8[0]) / fov_scale
    fy = float(kb8[1]) / fov_scale
    return np.asarray([fx, fy, (width - 1) / 2.0, (height - 1) / 2.0, 0, 0, 0, 0, 0], np.float32)
