"""Image pyramid and Gaussian blur — port of ``orb_slam3_ros_tpu.ops.pyramid``.

``jax.image.resize(..., "bilinear")`` antialiases when it shrinks (its
triangle kernel widens by the scale factor); ``F.interpolate`` only does so
with ``antialias=True``. Without it the 752x480 -> 627x400 level differs
by up to 71 grey levels from the reference; with it, by a few thousandths.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def level_shapes(height: int, width: int, n_levels: int, scale: float):
    """Static per-level (H, W) list, mirroring 1/scale^l sizing."""
    shapes = []
    for l in range(n_levels):
        inv = 1.0 / (scale**l)
        shapes.append((max(16, int(round(height * inv))), max(16, int(round(width * inv)))))
    return shapes


def build_pyramid(img: torch.Tensor, n_levels: int = 8, scale: float = 1.2):
    """[H, W] float32 -> list of ``n_levels`` tensors, each resized from
    the previous level (the reference's chained cv::resize)."""
    h, w = img.shape
    shapes = level_shapes(h, w, n_levels, scale)
    levels = [img]
    cur = img
    for l in range(1, n_levels):
        cur = F.interpolate(
            cur[None, None], size=shapes[l], mode="bilinear",
            align_corners=False, antialias=True,
        )[0, 0]
        levels.append(cur)
    return levels


def _gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    r = (ksize - 1) / 2.0
    x = np.arange(ksize) - r
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur_batched(imgs: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur of a stack [L, H, W], each image padded by
    reflection (without repeating the edge, the reference's
    BORDER_REFLECT_101 in cv::GaussianBlur(7, 7, 2, 2)): two 1-D
    convolutions, the stack on the batch axis."""
    k = torch.as_tensor(_gaussian_kernel1d(ksize, sigma), device=imgs.device)
    pad = ksize // 2
    x = F.pad(imgs[:, None], (0, 0, pad, pad), mode="reflect")
    x = F.conv2d(x, k.reshape(1, 1, ksize, 1))
    x = F.pad(x, (pad, pad, 0, 0), mode="reflect")
    return F.conv2d(x, k.reshape(1, 1, 1, ksize))[:, 0]


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """``gaussian_blur_batched`` of one [H, W] image."""
    return gaussian_blur_batched(img[None], ksize, sigma)[0]


def conv2d_same(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Single-channel 2-D correlation of [H, W] with ``kernel`` [kh, kw]
    (odd sizes), zero-padded to the same size."""
    kh, kw = kernel.shape
    return F.conv2d(img[None, None], kernel[None, None].to(img.dtype),
                    padding=(kh // 2, kw // 2))[0, 0]
