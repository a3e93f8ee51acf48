"""Guided feature matching — port of ``orb_slam3_ros_tpu.ops.matching``:
the projection search of tracking and landmark fusion, the windowed
search of initialization, the epipolar search of triangulation and the
unconstrained frame-to-frame search of relocalization, with the
rotation-histogram check.

There is no switch between routes for the projection search: on CUDA
tensors it always runs the hand-written matcher kernel, on CPU tensors its
plain torch version (``project_match.project_match``). The initialization,
triangulation and frame-to-frame searches are the dense
``hamming.mutual_nn`` path on both devices, as in the JAX package.
"""

from __future__ import annotations

import math

import torch

from . import hamming, project_match
from .orb import Features
from .topk import top_k

HISTO_BINS = 30  # rotation-consistency bins (ORBmatcher.cc HISTO_LENGTH=30)


def rotation_consistency(angle_q: torch.Tensor, angle_t: torch.Tensor, match_idx: torch.Tensor):
    """Keep only matches whose orientation difference falls in the three
    most popular histogram bins (the reference's ``ComputeThreeMaxima`` +
    CheckOrientation); bins 2 and 3 drop when under 10% of bin 1. Tied bin
    counts rank the lower bin first, as ``lax.top_k`` does.

    angle_q [N], angle_t [M] radians; match_idx [N] int32 (-1 = none).
    Returns the filtered match_idx [N]."""
    matched = match_idx >= 0
    rot = angle_q - angle_t[torch.clamp(match_idx, min=0).long()]
    two_pi = 2.0 * math.pi
    # Floor modulo into [0, 2 pi), written as jnp.mod computes it.
    rot = torch.fmod(rot, two_pi)
    rot = torch.where((rot != 0) & (rot < 0), rot + two_pi, rot)
    bins = torch.clamp((rot * (HISTO_BINS / two_pi)).to(torch.int32), 0, HISTO_BINS - 1)
    hist = torch.zeros((HISTO_BINS,), dtype=torch.int32, device=match_idx.device)
    hist.index_add_(0, bins.long(), matched.to(torch.int32))
    counts, top3 = top_k(hist, 3)
    keep2 = counts[1] > 0.1 * counts[0]
    keep3 = counts[2] > 0.1 * counts[0]
    in_top = (bins == top3[0]) | ((bins == top3[1]) & keep2) | ((bins == top3[2]) & keep3)
    return torch.where(matched & in_top, match_idx, -1)


def search_by_projection(
    proj_uv: torch.Tensor,
    proj_valid: torch.Tensor,
    proj_level: torch.Tensor,
    proj_sign: torch.Tensor,
    feats: Features,
    radius: float,
    scale: float = 1.2,
    level_slack: int = 1,
    max_dist: int = hamming.TH_HIGH,
    ratio: float = 0.9,
    site: str = "track",
):
    """Project-and-match (reference SearchByProjection for tracking, and
    ORBmatcher::Fuse's search).

    Args:
      proj_uv: [P, 2] predicted pixel positions of the projected points.
      proj_valid: [P] bool.
      proj_level: [P] int32 predicted octave; the search window scales with
        it and candidates must lie in [level-slack, level+slack].
      proj_sign: [P, 256] int8 descriptors of the projected points.
      feats: target frame features.
      radius: base search radius in level-0 pixels.
      site: which launch count of ``project_match.LAUNCHES`` a kernel
        launch adds to ("track", "fuse", "sim3" or "merge").

    Returns (match_idx [P] int32 into feats, -1 if none; match_dist [P])."""
    r = radius * scale ** proj_level.to(torch.float32)  # [P]
    return project_match.project_match(
        proj_uv, proj_valid, proj_level, proj_sign, r,
        feats.xy, feats.level, feats.valid, feats.desc_sign,
        level_slack=level_slack, max_dist=max_dist, ratio=ratio, site=site,
    )


def search_for_initialization(
    f1: Features,
    f2: Features,
    window: float = 100.0,
    max_dist: int = hamming.TH_LOW,
    ratio: float = 0.9,
):
    """Windowed search between the two initialization frames (reference
    ORBmatcher::SearchForInitialization: window 100 px, TH_LOW, ratio 0.9,
    rotation check), over all pyramid levels with |d level| <= 1 as in the
    JAX package. Returns (match_idx [N1] into f2, match_dist [N1])."""
    dist = hamming.hamming_matrix(f1.desc_sign, f2.desc_sign)
    d2 = torch.sum((f1.xy[:, None, :] - f2.xy[None, :, :]) ** 2, dim=-1)
    mask = (
        (d2 <= window * window)
        & (torch.abs(f1.level[:, None] - f2.level[None, :]) <= 1)
        & f1.valid[:, None]
        & f2.valid[None, :]
    )
    idx, d = hamming.mutual_nn(dist, mask, max_dist=max_dist, ratio=ratio)
    idx = rotation_consistency(f1.angle, f2.angle, idx)
    return idx, torch.where(idx >= 0, d, hamming.INVALID_DIST)


def search_frame_frame(
    f1: Features,
    f2: Features,
    max_dist: int = hamming.TH_LOW,
    ratio: float = 0.75,
    use_rotation: bool = True,
):
    """Unconstrained descriptor matching between two frames (the role of
    the reference's SearchByBoW, ORBmatcher.cc:765-905, whose BoW node
    constraint only prunes candidates): every valid pair, mutual nearest
    neighbours with the ratio test, then the rotation check. Returns
    (match_idx [N1] into f2, match_dist [N1])."""
    dist = hamming.hamming_matrix(f1.desc_sign, f2.desc_sign)
    mask = f1.valid[:, None] & f2.valid[None, :]
    idx, d = hamming.mutual_nn(dist, mask, max_dist=max_dist, ratio=ratio)
    if use_rotation:
        idx = rotation_consistency(f1.angle, f2.angle, idx)
    return idx, torch.where(idx >= 0, d, hamming.INVALID_DIST)


def epipolar_mask(
    F12: torch.Tensor,
    xy1: torch.Tensor,
    xy2: torch.Tensor,
    level2: torch.Tensor,
    scale: float = 1.2,
    base_tol: float = 3.84,
):
    """[N1, N2] point-to-epipolar-line compatibility (the reference's
    ``CheckDistEpipolarLine``): F12 maps homogeneous points of image 1 to
    lines in image 2; the tolerance grows with the candidate's octave."""
    p1 = torch.cat([xy1, torch.ones_like(xy1[:, :1])], dim=-1)  # [N1, 3]
    lines = p1 @ F12.T  # [N1, 3]
    a, b, c = lines[:, 0:1], lines[:, 1:2], lines[:, 2:3]
    d = a * xy2[None, :, 0] + b * xy2[None, :, 1] + c  # [N1, N2]
    dsq = (d * d) / torch.clamp(a * a + b * b, min=1e-12)
    sigma2 = scale ** (2.0 * level2.to(torch.float32))  # [N2]
    return dsq < base_tol * sigma2[None, :]


def search_for_triangulation(
    f1: Features,
    f2: Features,
    F12: torch.Tensor,
    already_matched1: torch.Tensor,
    already_matched2: torch.Tensor,
    max_dist: int = hamming.TH_LOW,
    scale: float = 1.2,
    base_tol: float = 3.84,
):
    """Epipolar-constrained match of the features without a landmark
    between two keyframes (ORBmatcher::SearchForTriangulation);
    ``already_matched*`` mark the features that have one."""
    dist = hamming.hamming_matrix(f1.desc_sign, f2.desc_sign)
    epi = epipolar_mask(F12, f1.xy, f2.xy, f2.level, scale=scale, base_tol=base_tol)
    mask = (
        epi
        & f1.valid[:, None]
        & f2.valid[None, :]
        & (~already_matched1)[:, None]
        & (~already_matched2)[None, :]
    )
    idx, d = hamming.mutual_nn(dist, mask, max_dist=max_dist, ratio=1.0)
    idx = rotation_consistency(f1.angle, f2.angle, idx)
    return idx, torch.where(idx >= 0, d, hamming.INVALID_DIST)
