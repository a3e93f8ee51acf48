"""Stereo matching and depth back-projection — port of
``orb_slam3_ros_tpu.ops.stereo``.

Role of the reference's ``Frame::ComputeStereoMatches``
(orb_slam3/src/Frame.cc:811-984): for each left keypoint, the right
keypoints within a row band (its tolerance grows with the octave) and the
disparity range, the best Hamming match among them, then a sub-pixel
correction by sliding an 11x11 intensity window over +-5 px and fitting a
parabola to the SAD minimum.

The candidate search is one dense [NL, NR] masked Hamming matrix; the SAD
refinement gathers one 11x11 patch and one 11x21 strip per left keypoint
and evaluates the 11 shifts at once. Every shape is fixed by the feature
capacity and nothing reads a value back to the host, so a CUDA graph can
hold the whole function.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import hamming
from .orb import Features

SAD_W = 5  # half window (11 px), reference w = 5
SAD_L = 5  # slide range +-5


class StereoMatch(NamedTuple):
    u_right: torch.Tensor  # [N] subpixel right x-coordinate (level 0), -1 invalid
    depth: torch.Tensor  # [N] metric depth, -1 invalid
    valid: torch.Tensor  # [N] bool


def _windows(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, h: int, w: int):
    """[N, h, w] windows of ``img`` whose top-left corners are (y0, x0)
    (every window lies inside the image: the callers clip)."""
    dev = img.device
    rows = (y0[:, None] + torch.arange(h, device=dev)).long()
    cols = (x0[:, None] + torch.arange(w, device=dev)).long()
    return img[rows[:, :, None], cols[:, None, :]]


def match_stereo(
    left: Features,
    right: Features,
    img_left: torch.Tensor,
    img_right: torch.Tensor,
    fx: float,
    baseline: float,
    scale: float = 1.2,
    min_z: float = 0.1,
) -> StereoMatch:
    """Rectified stereo correspondence for every left feature.

    Args:
      left/right: the views' feature sets (level-0 coordinates).
      img_left/img_right: the level-0 images [H, W] float32 (the reference
        refines on the keypoint's pyramid level; level 0 changes the
        sub-pixel result marginally and keeps one gather shape).
      fx, baseline: rectified intrinsics; depth = fx * b / disparity.
    """
    NL = left.xy.shape[0]
    dev = left.xy.device
    dist = hamming.hamming_matrix(left.desc_sign, right.desc_sign)  # [NL, NR]
    dy = torch.abs(left.xy[:, None, 1] - right.xy[None, :, 1])
    lvl = torch.maximum(left.level[:, None], right.level[None, :]).to(torch.float32)
    row_tol = 2.0 * torch.pow(torch.full((), scale, device=dev), lvl)
    disp = left.xy[:, None, 0] - right.xy[None, :, 0]
    max_disp = fx * baseline / min_z
    lvl_ok = torch.abs(left.level[:, None] - right.level[None, :]) <= 1
    mask = (
        (dy <= row_tol) & (disp >= -1.0) & (disp <= max_disp) & lvl_ok
        & left.valid[:, None] & right.valid[None, :]
    )
    masked = torch.where(mask, dist, hamming.INVALID_DIST)
    best_idx = torch.argmin(masked, dim=1)  # first minimum
    best = torch.gather(masked, 1, best_idx[:, None])[:, 0]
    # (TH_HIGH + TH_LOW) / 2 acceptance like the reference's thOrbDist
    # (Frame.cc:850), plus mutual consistency between the images.
    matched = best <= (hamming.TH_HIGH + hamming.TH_LOW) // 2
    col_best = torch.argmin(masked, dim=0)  # [NR] first minimum over left rows
    matched = matched & (col_best[best_idx] == torch.arange(NL, device=dev))

    # Sub-pixel SAD refinement: an 11x11 block around the matched right x
    # at the left row, slid over +-SAD_L (the reference's IL window,
    # Frame.cc:900-960). The clips keep every window inside the image.
    h, w = img_left.shape
    W11 = 2 * SAD_W + 1
    xl = left.xy[:, 0]
    yl = torch.clamp(left.xy[:, 1].to(torch.int32), SAD_W, h - SAD_W - 1)
    xr0 = right.xy[best_idx, 0]
    xli = torch.clamp(xl.to(torch.int32), SAD_W, w - SAD_W - 1)
    xri = torch.clamp(xr0.to(torch.int32), SAD_W + SAD_L, w - SAD_W - SAD_L - 1)
    patch_l = _windows(img_left, yl - SAD_W, xli - SAD_W, W11, W11)  # [N, 11, 11]
    strip_r = _windows(img_right, yl - SAD_W, xri - SAD_W - SAD_L, W11, W11 + 2 * SAD_L)
    # centre-intensity normalization like the reference (Frame.cc:905)
    patch_l = patch_l - patch_l[:, SAD_W : SAD_W + 1, SAD_W : SAD_W + 1]
    shifted = strip_r.unfold(2, W11, 1).permute(0, 2, 1, 3)  # [N, 11 shifts, 11, 11]
    centre = strip_r[:, SAD_W, SAD_W : SAD_W + 2 * SAD_L + 1]  # [N, 11]
    sad = torch.sum(
        torch.abs(shifted - centre[:, :, None, None] - patch_l[:, None]), dim=(-2, -1)
    )  # [N, 11]
    k = torch.argmin(sad, dim=-1)
    # Reject minima at the slide window's edge (reference: bestincR == -L
    # or +L discards the match, Frame.cc:940).
    matched = matched & (k > 0) & (k < 2 * SAD_L)
    k_c = torch.clamp(k, 1, 2 * SAD_L - 1)
    s_m = torch.gather(sad, 1, (k_c - 1)[:, None])[:, 0]
    s_0 = torch.gather(sad, 1, k_c[:, None])[:, 0]
    s_p = torch.gather(sad, 1, (k_c + 1)[:, None])[:, 0]
    denom = torch.clamp(s_m + s_p - 2.0 * s_0, min=1e-6)
    delta = torch.clamp(0.5 * (s_m - s_p) / denom, -1.0, 1.0)  # parabola vertex
    # The SAD grid samples the left patch at the integer xli: shift the
    # refined right position by the keypoint's fractional part to express
    # it at xl (higher-octave keypoints have fractional level-0 coords).
    u_r = xri.to(xl.dtype) + (k_c - SAD_L).to(xl.dtype) + delta + (xl - xli.to(xl.dtype))
    disp_final = xl - u_r
    ok = matched & (disp_final > 0.01) & (disp_final < max_disp)
    depth = torch.where(ok, fx * baseline / torch.clamp(disp_final, min=1e-6), -1.0)
    return StereoMatch(u_right=torch.where(ok, u_r, -1.0), depth=depth, valid=ok)


def backproject(cam_params: torch.Tensor, xy: torch.Tensor, depth: torch.Tensor):
    """Pixels [N, 2] + depth [N] -> camera-frame 3D points [N, 3]."""
    fx, fy, cx, cy = cam_params[0], cam_params[1], cam_params[2], cam_params[3]
    x = (xy[:, 0] - cx) / fx * depth
    y = (xy[:, 1] - cy) / fy * depth
    return torch.stack([x, y, depth], dim=-1)
