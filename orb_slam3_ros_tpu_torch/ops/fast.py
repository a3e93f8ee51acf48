"""FAST-16 corner scores + grid-bucketed selection — port of
``orb_slam3_ros_tpu.ops.fast``.

The segment test runs on the whole image as 16 ``torch.roll`` comparisons
(which wrap around at the edges exactly like ``jnp.roll``); the 16-bit ring
masks are held in int64 because torch's uint32 supports few operations.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .topk import top_k

# Bresenham circle of radius 3, OpenCV ordering, as (dy, dx).
CIRCLE_OFFSETS = np.array(
    [
        (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    ],
    dtype=np.int32,
)

_ARC_LEN = 9  # segment test: >= 9 contiguous pixels (FAST-9/16)
SCORE_BUMP = 1e6  # high-threshold preference offset (scores < 16*255)


def _circle_stack(img: torch.Tensor) -> torch.Tensor:
    """[16, ..., H, W] stack of the circle-neighbour images via rolls."""
    return torch.stack(
        [torch.roll(img, (-int(dy), -int(dx)), dims=(-2, -1)) for dy, dx in CIRCLE_OFFSETS],
        dim=0,
    )


def _has_arc(mask16: torch.Tensor) -> torch.Tensor:
    """True where the 16-bit ring mask (int64) holds >= _ARC_LEN
    contiguous set bits, circularly."""
    m = mask16 | (mask16 << 16)  # unroll the ring into 32 bits
    r = m
    for _ in range(_ARC_LEN - 1):
        m = m >> 1
        r = r & m
    return (r & 0xFFFF) != 0


def _score_from_diff(diff: torch.Tensor, threshold: float):
    """(corner_mask, score) from a circle-difference stack [16, ..., H, W]."""
    mb = torch.zeros(diff.shape[1:], dtype=torch.int64, device=diff.device)
    md = torch.zeros_like(mb)
    for i in range(16):
        mb |= (diff[i] > threshold).to(torch.int64) << i
        md |= (diff[i] < -threshold).to(torch.int64) << i
    corner = _has_arc(mb) | _has_arc(md)
    # |p - c| - t is positive exactly where the pixel passes (brighter or
    # darker), so clamping at 0 is the reference's masked sum.
    excess = torch.clamp(torch.abs(diff) - threshold, min=0.0)
    return corner, torch.sum(excess, dim=0)


def score_map_combined(img: torch.Tensor, ini_threshold: float, min_threshold: float):
    """Two-threshold FAST score map: high-threshold corners get +SCORE_BUMP
    so they outrank low-threshold-only corners; -inf at non-corners. The
    circle stack is computed once and shared by both thresholds."""
    diff = _circle_stack(img) - img[None]
    corner_hi, score_hi = _score_from_diff(diff, ini_threshold)
    corner_lo, score_lo = _score_from_diff(diff, min_threshold)
    neg_inf = torch.full_like(score_lo, -float("inf"))
    return torch.where(
        corner_hi, score_hi + SCORE_BUMP, torch.where(corner_lo, score_lo, neg_inf)
    )


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep only local maxima of a 3x3 neighbourhood (-inf padding)."""
    mx = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return score >= mx


def select_grid(score: torch.Tensor, post_mask: torch.Tensor, max_kp: int, cell: int):
    """NMS + one best corner per cell + the top ``max_kp`` cells.

    ``score`` is -inf outside the image's true extent; ``post_mask`` (the
    descriptor border) applies after NMS. Tied scores keep the lower cell
    index first, as ``lax.top_k`` does (``topk.top_k``).

    Returns (xy [max_kp, 2] f32, response [max_kp], valid [max_kp])."""
    h, w = score.shape
    neg_inf = -float("inf")
    finite = torch.where(torch.isfinite(score), score, torch.full_like(score, neg_inf))
    keep = nms3x3(finite)
    score = torch.where(keep & post_mask, score, torch.full_like(score, neg_inf))

    ph = (-h) % cell
    pw = (-w) % cell
    sp = F.pad(score, (0, pw, 0, ph), value=neg_inf)
    hc, wc = (h + ph) // cell, (w + pw) // cell
    cells = sp.reshape(hc, cell, wc, cell).permute(0, 2, 1, 3).reshape(hc, wc, cell * cell)
    best_in_cell = torch.argmax(cells, dim=-1).reshape(-1)  # first maximum
    flat_scores = torch.gather(
        cells.reshape(hc * wc, cell * cell), 1, best_in_cell[:, None]
    )[:, 0]

    k = min(max_kp, flat_scores.shape[0])
    top_scores, top_cells = top_k(flat_scores, k)
    cy = top_cells // wc
    cx = top_cells % wc
    iy = best_in_cell[top_cells] // cell
    ix = best_in_cell[top_cells] % cell
    y = cy * cell + iy
    x = cx * cell + ix
    valid = torch.isfinite(top_scores)
    resp = torch.where(top_scores >= SCORE_BUMP, top_scores - SCORE_BUMP, top_scores)
    xy = torch.stack([x, y], dim=-1).to(torch.float32)
    xy = torch.where(valid[:, None], xy, torch.zeros_like(xy))
    resp = torch.where(valid, resp, torch.full_like(resp, neg_inf))
    if k < max_kp:
        pad = max_kp - k
        dev = score.device
        xy = torch.cat([xy, torch.zeros((pad, 2), dtype=torch.float32, device=dev)])
        resp = torch.cat([resp, torch.full((pad,), neg_inf, dtype=torch.float32, device=dev)])
        valid = torch.cat([valid, torch.zeros((pad,), dtype=torch.bool, device=dev)])
    return xy, resp, valid


def fast_score_map(img: torch.Tensor, threshold: float):
    """(corner_mask [H, W] bool, score [H, W] f32) for one threshold: the
    score sums |p_i - c| - t over the circle pixels past the threshold
    (the FAST "V" response that orders corners for NMS)."""
    return _score_from_diff(_circle_stack(img) - img[None], threshold)


def detect_grid(img: torch.Tensor, max_kp: int, cell: int, ini_threshold: float = 20.0,
                min_threshold: float = 7.0, border: int = 19):
    """Up to ``max_kp`` well-spread FAST corners of one pyramid level: the
    two-threshold score map, NMS, one corner a cell, the top cells.
    ``border`` masks the margin descriptor patches need (EDGE_THRESHOLD,
    ORBextractor.cc:793), after NMS. Returns (xy [max_kp, 2] f32 in level
    pixels, response [max_kp], valid [max_kp]); invalid slots have response
    -inf and xy (0, 0)."""
    h, w = img.shape
    score = score_map_combined(img, ini_threshold, min_threshold)
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    inb = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    return select_grid(score, inb, max_kp, cell)
