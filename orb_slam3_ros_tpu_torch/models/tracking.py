"""Per-frame tracking against the map (coarse-to-fine project / match /
pose-optimize passes) and new-landmark triangulation between keyframes —
port of ``track_against_map``, ``triangulate_with_ref`` and what they call
in ``orb_slam3_ros_tpu.models.tracking``, under the pinhole or the KB8
fisheye camera (``cam_model``; KB8 projects raw fisheye pixels, and its
epipolar gate runs on bearings).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import cameras, hamming, matching, pose_opt, triangulate
from ..ops.orb import Features
from ..ops.topk import top_k
from .map_state import MapState, kf_index

# Coarse-to-fine pass schedules: (radius_px, LM rounds, LM iters) per pass.
SCHEDULE_DENSE = ((60.0, 2, 8), (12.0, 2, 8), (4.0, 3, 8))
SCHEDULE_LEAN = ((60.0, 3, 5), (4.0, 3, 5))


class TrackResult(NamedTuple):
    R: torch.Tensor  # [3,3] optimized Tcw
    t: torch.Tensor  # [3]
    feat_pt: torch.Tensor  # [N] int32: map-point id tracked by each feature (-1)
    n_inliers: torch.Tensor  # [] int32
    visible_mask: torch.Tensor  # [P] point was in frustum this frame
    found_mask: torch.Tensor  # [P] point was tracked as inlier


def _project_points(
    m: MapState, R, t, cam_params, width, height, margin=2.0,
    band_lo=0.8, band_hi=1.2, view_min=0.5, cam_model="pinhole",
):
    """Frustum + viewing-statistics gate (the reference's
    ``Frame::isInFrustum``). Points whose band was never set
    (pt_max_dist == 0) skip the gate. Returns (uv [P,2], ok [P]); every
    point searches at its creation octave ``pt_level`` (the JAX package's
    default; its ``predict_scale`` option is not ported)."""
    Xc = m.pt_X @ R.T + t
    uv = cameras.project_model(cam_params, Xc, cam_model)
    O_w = -R.T @ t
    po = m.pt_X - O_w
    dist = torch.linalg.norm(po, dim=-1)
    view_cos = torch.sum(po * m.pt_normal, dim=-1) / torch.clamp(dist, min=1e-12)
    banded = m.pt_max_dist > 0
    band_ok = (~banded) | (
        (dist >= band_lo * m.pt_min_dist)
        & (dist <= band_hi * m.pt_max_dist)
        & (view_cos > view_min)
    )
    ok = (
        m.pt_valid
        & (Xc[:, 2] > 0.05)
        & cameras.in_image(uv, width, height, margin)
        & band_ok
    )
    return uv, ok


def _match_and_pose(
    m: MapState, feats: Features, R, t, cam_params, width, height, radius,
    scale, rounds, iters, band_lo=0.8, band_hi=1.2, view_min=0.5, cam_model="pinhole",
):
    uv_proj, proj_ok = _project_points(
        m, R, t, cam_params, width, height,
        band_lo=band_lo, band_hi=band_hi, view_min=view_min, cam_model=cam_model,
    )
    idx, _ = matching.search_by_projection(
        uv_proj, proj_ok, m.pt_level, m.pt_desc_sign, feats,
        radius=radius, scale=scale, max_dist=hamming.TH_HIGH, ratio=0.9,
    )  # per-point best feature
    matched = idx >= 0
    fidx = torch.clamp(idx, 0, feats.xy.shape[0] - 1).long()
    obs_uv = feats.xy[fidx]
    inv_sigma2 = 1.0 / scale ** (2.0 * feats.level[fidx].to(torch.float32))
    res = pose_opt.pose_optimization(
        R, t, m.pt_X, obs_uv, inv_sigma2, matched, cam_params,
        rounds=rounds, iters_per_round=iters, cam_model=cam_model,
    )
    return res, idx, proj_ok


def track_against_map(
    m: MapState,
    feats: Features,
    R_pred: torch.Tensor,
    t_pred: torch.Tensor,
    cam_params: torch.Tensor,
    width: int,
    height: int,
    scale: float = 1.2,
    pt_mask: torch.Tensor | None = None,
    schedule: tuple | None = None,
    track_cap: int | None = None,
    cam_model: str = "pinhole",
) -> TrackResult:
    """Coarse-to-fine project/match/optimize against the point table.

    ``pt_mask``: [P] bool, points that may be tracked (the system's
    ``track_window``). ``schedule``: per-pass (radius_px, LM rounds, LM
    iters/round); the first pass uses relaxed frustum gates.
    ``track_cap``: first cut the candidates to the top ``track_cap`` points
    by visibility under the predicted pose, ties toward recent points (the
    reference's local-map tracking). Tied scores keep the lower point index
    first, as ``lax.top_k`` does; the order of the cut fixes the matcher's
    row order and with it which row wins a tie. ``cam_model``: the
    projection of the points and of the pose optimization's edges
    (pinhole | kb8).
    """
    if schedule is None:
        schedule = SCHEDULE_DENSE
    if pt_mask is not None:
        m = m._replace(pt_valid=m.pt_valid & pt_mask)
    P_full = m.P
    sel = None
    if track_cap is not None and track_cap < P_full:
        _, vis = _project_points(
            m, R_pred, t_pred, cam_params, width, height,
            margin=20.0, band_lo=0.4, band_hi=2.5, view_min=0.0, cam_model=cam_model,
        )
        P32 = float(P_full)
        score = (
            vis.to(torch.float32) * 2.0
            + m.pt_valid.to(torch.float32)
            + m.pt_first_kf.to(torch.float32) / (P32 * 4.0)
        )
        sel = top_k(score, track_cap)[1]
        m = m._replace(
            pt_valid=m.pt_valid[sel],
            pt_X=m.pt_X[sel],
            pt_desc_sign=m.pt_desc_sign[sel],
            pt_level=m.pt_level[sel],
            pt_found=m.pt_found[sel],
            pt_visible=m.pt_visible[sel],
            pt_first_kf=m.pt_first_kf[sel],
            pt_normal=m.pt_normal[sel],
            pt_min_dist=m.pt_min_dist[sel],
            pt_max_dist=m.pt_max_dist[sel],
        )
    radius0, rounds0, iters0 = schedule[0]
    res, idx, proj_ok = _match_and_pose(
        m, feats, R_pred, t_pred, cam_params, width, height,
        radius=radius0, scale=scale, rounds=rounds0, iters=iters0,
        band_lo=0.4, band_hi=2.5, view_min=0.0, cam_model=cam_model,
    )
    for radius_i, rounds_i, iters_i in schedule[1:]:
        res, idx, proj_ok = _match_and_pose(
            m, feats, res.R, res.t, cam_params, width, height,
            radius=radius_i, scale=scale, rounds=rounds_i, iters=iters_i, cam_model=cam_model,
        )
    # Invert the point->feature map into per-feature point ids (inliers).
    P = m.P
    N = feats.xy.shape[0]
    dev = idx.device
    keep = (idx >= 0) & res.inlier
    fidx = torch.clamp(idx, 0, N - 1).long()
    pt_ids = torch.arange(P, dtype=torch.int32, device=dev) if sel is None else sel.to(torch.int32)
    feat_pt = torch.full((N,), -1, dtype=torch.int32, device=dev).scatter_reduce(
        0, fidx, torch.where(keep, pt_ids, -1), "amax"
    )
    if sel is None:
        visible_mask, found_mask = proj_ok, keep
    else:
        visible_mask = torch.zeros((P_full,), dtype=torch.bool, device=dev)
        found_mask = torch.zeros((P_full,), dtype=torch.bool, device=dev)
        visible_mask[sel] = proj_ok  # sel holds distinct indices
        found_mask[sel] = keep
    return TrackResult(
        R=res.R,
        t=res.t,
        feat_pt=feat_pt,
        n_inliers=res.n_inliers,
        visible_mask=visible_mask,
        found_mask=found_mask,
    )


class TriangulationResult(NamedTuple):
    X_w: torch.Tensor  # [N,3] candidate world points (per new-keyframe feature)
    ref_feat: torch.Tensor  # [N] int32 matched feature index in the ref keyframe
    ok: torch.Tensor  # [N] passed all checks
    n_new: torch.Tensor  # [] int32


def kf_features(m: MapState, kf) -> Features:
    """Keyframe ``kf``'s (int or 0-d tensor) stored features as a
    ``Features`` (no response or packed descriptors: the searches do not
    read them)."""
    dev = m.kf_xy.device
    k = kf_index(kf, dev)

    def row(t):
        return t.index_select(0, k)[0]

    return Features(
        xy=row(m.kf_xy), level=row(m.kf_level), angle=row(m.kf_angle),
        response=torch.zeros((m.N,), dtype=m.kf_angle.dtype, device=dev),
        desc_packed=torch.zeros((m.N, 8), dtype=torch.int32, device=dev),
        desc_sign=row(m.kf_desc_sign), valid=row(m.kf_feat_valid),
    )


def triangulate_with_ref(
    m: MapState,
    new_kf,
    ref_kf,
    cam_params: torch.Tensor,
    scale: float = 1.2,
    cam_model: str = "pinhole",
) -> TriangulationResult:
    """Epipolar search + DLT new-landmark creation between the newest
    keyframe and a reference keyframe (LocalMapping::CreateNewMapPoints,
    reduced to one neighbour): cheirality, parallax and reprojection checks
    in both views. Keyframe ids: ints or 0-d tensors.

    Under KB8 the epipolar gate runs on the features' bearings scaled by fx
    (a centred virtual pinhole, so the tolerance keeps its pixel meaning)
    with the essential matrix: a fisheye's epipolar line is a curve in
    pixels (the reference's KannalaBrandt8::epipolarConstrain)."""
    dev = m.kf_R.device
    k_new, k_ref = kf_index(new_kf, dev), kf_index(ref_kf, dev)

    def row(t, k):
        return t.index_select(0, k)[0]

    f_new = kf_features(m, k_new)
    f_ref = kf_features(m, k_ref)
    R1, t1 = row(m.kf_R, k_new), row(m.kf_t, k_new)  # Tcw of new
    R2, t2 = row(m.kf_R, k_ref), row(m.kf_t, k_ref)
    # relative: x_ref = R21 x_new + t21 with 1 = new, 2 = ref
    R21 = R2 @ R1.T
    t21 = t2 - R21 @ t1
    R12 = R21.T
    t12 = -R21.T @ t21
    if cam_model == "kb8":
        K = triangulate.K_matrix(cameras.bearing_camera(cam_params))
        g_new = f_new._replace(xy=cameras.fx_bearings(cam_params, f_new.xy))
        g_ref = f_ref._replace(xy=cameras.fx_bearings(cam_params, f_ref.xy))
    else:
        K = triangulate.K_matrix(cam_params)
        g_new, g_ref = f_new, f_ref
    F12 = triangulate.fundamental_from_poses(K, K, R12, t12)
    idx, _ = matching.search_for_triangulation(
        g_new, g_ref, F12,
        already_matched1=row(m.kf_obs, k_new) >= 0,
        already_matched2=row(m.kf_obs, k_ref) >= 0,
        scale=scale,
    )
    matched = idx >= 0
    ridx = torch.clamp(idx, 0, m.N - 1)
    xy_ref = f_ref.xy[ridx.long()]
    rays1 = cameras.unproject_model(cam_params, f_new.xy, cam_model)
    rays2 = cameras.unproject_model(cam_params, xy_ref, cam_model)
    X1 = triangulate.triangulate_dlt(rays1, rays2, R21, t21)
    X2 = X1 @ R21.T + t21
    cospar = triangulate.parallax_cos(X1, -R21.T @ t21)
    e1 = torch.sum((cameras.project_model(cam_params, X1, cam_model) - f_new.xy) ** 2, -1)
    e2 = torch.sum((cameras.project_model(cam_params, X2, cam_model) - xy_ref) ** 2, -1)
    sig2_1 = scale ** (2.0 * f_new.level.to(torch.float32))
    sig2_2 = scale ** (2.0 * f_ref.level[ridx.long()].to(torch.float32))
    ok = (
        matched
        & torch.all(torch.isfinite(X1), dim=-1)
        & (X1[:, 2] > 0.02)
        & (X2[:, 2] > 0.02)
        & (cospar < 0.9998)
        & (e1 < 5.991 * sig2_1)
        & (e2 < 5.991 * sig2_2)
    )
    # world coords: X_w = R1^T (X1 - t1)
    X_w = (X1 - t1) @ R1
    return TriangulationResult(
        X_w=X_w, ref_feat=ridx, ok=ok, n_new=torch.sum(ok, dtype=torch.int32)
    )
