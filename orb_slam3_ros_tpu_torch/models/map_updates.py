"""Map mutations — port of ``orb_slam3_ros_tpu.models.map_updates``
(scatter formulations): keyframe insertion, landmark admission, fusion
and culling, keyframe culling, eviction and slot compaction, and the
gravity alignment and rescaling of the map after IMU initialization.

The JAX functions are pure (old state -> new state). Here
``update_track_counters``, ``insert_keyframe``, ``admit_depth_points`` and
``admit_new_points`` write into the given map's tensors in place and
return it, which saves copying the [K, N, 256] descriptor table per
keyframe; callers that need the old state keep a clone. The other
functions return new tensors for the fields they change.

Where XLA drops out-of-range scatter writes (``mode="drop"``) or leaves
the order of duplicate writes open, the port writes into a buffer one row
longer than the table and routes the rows that must not land to that
spare row, which is then cut off: no host sync, and no index is written
twice with different values.
"""

from __future__ import annotations

import torch

from ..ops import cameras, matching
from ..ops.orb import Features
from ..ops.topk import top_k
from .map_state import MapState, covisibility, kf_index, obs_matrix, point_obs_count
from .tracking import TriangulationResult, kf_features


def dedup_obs_rows(kf_obs: torch.Tensor, changed: torch.Tensor, P: int) -> torch.Tensor:
    """One observation per (keyframe, landmark): among the entries of a
    keyframe row that hold the same landmark, keep the one not rewritten
    by a remap, then the lowest feature slot, and erase the rest
    (MapPoint::Replace). Scatter-min over a [K, P + 1] table whose spare
    column takes the unbound entries."""
    K, N = kf_obs.shape
    dev = kf_obs.device
    cols = torch.arange(N, dtype=torch.int32, device=dev).expand(K, N)
    prio = cols + N * changed.to(torch.int32)
    rows = torch.arange(K, device=dev)[:, None].expand(K, N)
    val = torch.where(kf_obs >= 0, kf_obs, P).long()  # unbound -> spare column
    flat = (rows * (P + 1) + val).reshape(-1)
    best = torch.full((K * (P + 1),), 2 * N, dtype=torch.int32, device=dev)
    best.scatter_reduce_(0, flat, prio.reshape(-1), "amin")
    keep = (kf_obs < 0) | (prio == best[flat].reshape(K, N))
    return torch.where(keep, kf_obs, -1)


def update_track_counters(m: MapState, visible_mask, found_mask) -> MapState:
    """Found/visible ratios (MapPoint::IncreaseVisible/Found), in place."""
    m.pt_visible.add_(visible_mask.to(torch.int32))
    m.pt_found.add_(found_mask.to(torch.int32))
    return m


def insert_keyframe(
    m: MapState,
    kf_id,
    R: torch.Tensor,
    t: torch.Tensor,
    ts,
    feats: Features,
    feat_pt: torch.Tensor,
    ur: torch.Tensor | None = None,
) -> MapState:
    """Write keyframe slot ``kf_id`` (an int or a 0-d tensor) in place
    (KeyFrame ctor + observation binding). ``ur`` [N]: the stereo
    right-image x-coordinate of each feature, -1 on a monocular one; None
    writes a monocular keyframe (all -1). ``ts``: a float or a 0-d
    tensor."""
    k = kf_index(kf_id, m.kf_R.device)

    def put(table, row):
        table.index_copy_(0, k, row.to(table.dtype)[None])

    m.kf_valid.index_fill_(0, k, True)
    put(m.kf_R, R)
    put(m.kf_t, t)
    put(m.kf_xy, feats.xy)
    put(m.kf_level, feats.level)
    put(m.kf_angle, feats.angle)
    put(m.kf_desc_sign, feats.desc_sign)
    put(m.kf_feat_valid, feats.valid)
    put(m.kf_obs, feat_pt)
    put(m.kf_ts, ts if isinstance(ts, torch.Tensor) else torch.full((), ts, device=m.kf_ts.device))
    if ur is None:
        m.kf_ur.index_fill_(0, k, -1.0)
    else:
        put(m.kf_ur, ur)
    return m


def admit_depth_points(
    m: MapState,
    kf_id,
    X_w: torch.Tensor,  # [N,3] backprojected candidates (world)
    cand: torch.Tensor,  # [N] candidate mask (valid depth)
    base_id,
    room,
) -> tuple[MapState, torch.Tensor]:
    """Create landmarks from per-feature depth into point slots
    [base_id, base_id + n) in feature order, at most ``room`` of them, and
    bind them in keyframe ``kf_id`` (the stereo/RGB-D point creation of
    ``Tracking::StereoInitialization`` / ``CreateNewKeyFrame``). In place;
    the three scalars are ints or 0-d int32 tensors. Returns (map,
    n_admitted as a 0-d int32 tensor). The writes are ``admit_new_points``'
    scatter-adds of masked deltas: no data-dependent shape, so a CUDA graph
    can hold them."""
    P = m.P
    dev = m.pt_X.device
    k = kf_index(kf_id, dev)
    obs = m.kf_obs.index_select(0, k)[0]
    ok = cand & m.kf_feat_valid.index_select(0, k)[0] & (obs < 0)
    rank = torch.cumsum(ok.to(torch.int32), dim=0, dtype=torch.int32) - 1
    take = ok & (rank < room)
    slot = torch.clamp(base_id + rank, 0, P - 1)
    sl = slot.long()
    ti = take.to(torch.int32)
    desc = m.kf_desc_sign.index_select(0, k)[0]
    lvl = m.kf_level.index_select(0, k)[0]
    d_valid = torch.zeros((P,), dtype=torch.int32, device=dev).index_add_(0, sl, ti)
    d_X = take.to(m.pt_X.dtype)[:, None] * (X_w.to(m.pt_X.dtype) - m.pt_X[sl])
    d_desc = (take[:, None] * (desc.to(torch.int32) - m.pt_desc_sign[sl].to(torch.int32))).to(torch.int8)
    d_level = ti * (lvl - m.pt_level[sl])
    d_first = ti * (kf_id - m.pt_first_kf[sl])
    new_obs = torch.where(take, slot, obs)
    m.pt_valid.logical_or_(d_valid > 0)
    m.pt_X.index_add_(0, sl, d_X)
    m.pt_desc_sign.index_add_(0, sl, d_desc)
    m.pt_level.index_add_(0, sl, d_level)
    m.pt_first_kf.index_add_(0, sl, d_first)
    m.kf_obs.index_copy_(0, k, new_obs.to(m.kf_obs.dtype)[None])
    return m, torch.sum(take, dtype=torch.int32)


def refresh_point_stats(
    m: MapState, max_obs: int = 8, scale: float = 1.2, n_levels: int = 8
) -> MapState:
    """Recompute per-landmark bookkeeping in one pass (scatter formulation):
    the representative descriptor (minimum median Hamming distance to the
    other observations, ``MapPoint::ComputeDistinctiveDescriptors``) and
    the mean viewing direction + scale-invariance band from the first
    observing keyframe (``MapPoint::UpdateNormalAndDepth``). Observations
    are capped at ``max_obs`` per point in keyframe-id order."""
    K, N, P = m.K, m.N, m.P
    S = K * N
    dev = m.pt_X.device
    dtype = m.pt_X.dtype
    flat_pt = m.kf_obs.reshape(-1).long()
    flat_kf = torch.arange(S, device=dev) // N
    has = (flat_pt >= 0) & m.kf_feat_valid.reshape(-1) & m.kf_valid[flat_kf]
    q = torch.where(has, flat_pt, P)  # invalid slots sort to the end
    order = torch.argsort(q, stable=True)
    qs = q[order]
    # rank of each observation within its point's group
    start = torch.searchsorted(qs, qs, side="left")
    rank = torch.arange(S, device=dev) - start
    keep = (qs < P) & (rank < max_obs)
    obs_slot = torch.full((P * max_obs,), -1, dtype=torch.int64, device=dev)
    obs_slot.scatter_reduce_(
        0,
        torch.clamp(qs, 0, P - 1) * max_obs + torch.clamp(rank, 0, max_obs - 1),
        torch.where(keep, order, -1),
        "amax",
    )
    obs_slot = obs_slot.reshape(P, max_obs)
    valid_obs = obs_slot >= 0  # [P,O]
    oi = torch.clamp(obs_slot, 0, S - 1)
    kf_of = oi // N  # [P,O]

    # --- distinctive descriptor: min median pairwise Hamming ---
    desc_obs = m.kf_desc_sign.reshape(S, 256)[oi]  # [P,O,256] int8
    D = desc_obs.to(torch.float32)
    dist = 0.5 * (256.0 - torch.einsum("poc,pqc->poq", D, D))
    pair_ok = valid_obs[:, :, None] & valid_obs[:, None, :]
    BIG = 512.0
    dist = torch.where(pair_ok, dist, BIG)
    dist_sorted = torch.sort(dist, dim=-1).values  # valid entries first per row
    n_valid = torch.sum(valid_obs.to(torch.int64), dim=-1)  # [P]
    med_idx = torch.clamp(torch.div(n_valid - 1, 2, rounding_mode="floor"), 0, max_obs - 1)
    median = torch.gather(
        dist_sorted, 2, med_idx[:, None, None].expand(P, max_obs, 1)
    )[..., 0]  # [P,O]
    median = torch.where(valid_obs, median, BIG)
    best_row = torch.argmin(median, dim=-1)  # [P], first minimum
    winner = desc_obs[torch.arange(P, device=dev), best_row]  # [P,256] int8
    touched = n_valid > 0
    pt_desc = torch.where(touched[:, None], winner, m.pt_desc_sign)

    # --- normal + scale-invariance band ---
    C_w = -torch.einsum("kij,ki->kj", m.kf_R, m.kf_t)  # [K,3] camera centres
    vec = m.pt_X[:, None, :] - C_w[kf_of]  # [P,O,3]
    vlen = torch.linalg.norm(vec, dim=-1)
    unit = vec / torch.clamp(vlen, min=1e-12)[..., None]
    nsum = torch.sum(torch.where(valid_obs[..., None], unit, 0.0), dim=1)
    normal = nsum / torch.clamp(torch.linalg.norm(nsum, dim=-1), min=1e-12)[..., None]
    pt_normal = torch.where(touched[:, None], normal, m.pt_normal)
    # first observation (lowest kf id) = reference keyframe for the band
    ref_level = m.kf_level.reshape(S)[oi[:, 0]].to(dtype)
    dist_ref = vlen[:, 0]
    max_d = dist_ref * scale**ref_level
    min_d = max_d / scale ** (n_levels - 1.0)
    return m._replace(
        pt_desc_sign=pt_desc,
        pt_normal=pt_normal,
        pt_min_dist=torch.where(touched, min_d, m.pt_min_dist),
        pt_max_dist=torch.where(touched, max_d, m.pt_max_dist),
    )


def admit_new_points(
    m: MapState,
    kf_id,
    ref_kf,
    tri: TriangulationResult,
    base_id,
    room,
) -> tuple[MapState, torch.Tensor]:
    """Admit the accepted triangulations into point slots [base_id,
    base_id + n) in feature order, at most ``room`` of them, and bind them
    in both keyframes; in place. The four scalars are ints or 0-d int32
    tensors. Returns (map, n_admitted as a 0-d int32 tensor).

    Rows not taken share clipped slot indices with taken ones, so every
    write is a scatter-ADD of a masked delta (duplicates add zero), as in
    the JAX package: exact, and independent of the order of the adds. The
    keyframe rows are written through their tables (``index_copy_`` /
    ``index_add_``): a row taken with a tensor index is a copy."""
    P, N = m.P, m.N
    dev = m.pt_X.device
    k_new, k_ref = kf_index(kf_id, dev), kf_index(ref_kf, dev)
    ok = tri.ok
    rank = torch.cumsum(ok.to(torch.int32), dim=0, dtype=torch.int32) - 1
    take = ok & (rank < room)
    slot = torch.clamp(base_id + rank, 0, P - 1)
    sl = slot.long()
    ti = take.to(torch.int32)
    desc = m.kf_desc_sign.index_select(0, k_new)[0]
    lvl = m.kf_level.index_select(0, k_new)[0]
    obs_ref = m.kf_obs.index_select(0, k_ref)[0]
    ref_feat = tri.ref_feat.long()
    d_valid = torch.zeros((P,), dtype=torch.int32, device=slot.device).index_add_(0, sl, ti)
    d_X = take.to(m.pt_X.dtype)[:, None] * (tri.X_w - m.pt_X[sl])
    d_desc = (take[:, None] * (desc.to(torch.int32) - m.pt_desc_sign[sl].to(torch.int32))).to(torch.int8)
    d_level = ti * (lvl - m.pt_level[sl])
    d_first = ti * (kf_id - m.pt_first_kf[sl])
    d_ref = ti * (slot - obs_ref[ref_feat])
    new_obs_kf = torch.where(take, slot, m.kf_obs.index_select(0, k_new)[0])
    m.pt_valid.logical_or_(d_valid > 0)
    m.pt_X.index_add_(0, sl, d_X)
    m.pt_desc_sign.index_add_(0, sl, d_desc)
    m.pt_level.index_add_(0, sl, d_level)
    m.pt_first_kf.index_add_(0, sl, d_first)
    m.kf_obs.index_copy_(0, k_new, new_obs_kf[None])
    m.kf_obs.view(-1).index_add_(0, k_ref * N + ref_feat, d_ref)
    return m, torch.sum(take, dtype=torch.int32)


def apply_scaled_rotation(m: MapState, R_gw: torch.Tensor, s) -> MapState:
    """Gravity-align and metrically rescale the whole map after IMU
    initialization (``Map::ApplyScaledRotation``): X' = s R_gw X, camera
    poses R_cw' = R_cw R_gw^T, t_cw' = s t_cw (reprojection-invariant),
    world velocities v' = R_gw v (already metric after the init solve).
    Viewing normals rotate and the scale-invariance band rescales with the
    map. Returns new tensors for the fields it changes."""
    R_wg = R_gw.T
    return m._replace(
        pt_X=s * m.pt_X @ R_wg,
        kf_R=m.kf_R @ R_wg,
        kf_t=s * m.kf_t,
        kf_v=m.kf_v @ R_wg,
        pt_normal=m.pt_normal @ R_wg,
        pt_min_dist=s * m.pt_min_dist,
        pt_max_dist=s * m.pt_max_dist,
    )


def cull_points(m: MapState, n_kf) -> MapState:
    """MapPointCulling (LocalMapping.cc:346): a found/visible ratio under
    0.25 after 8 sightings, or fewer than 2 observing keyframes once 3
    keyframes have passed since the point's creation."""
    obs_count = point_obs_count(m)
    ratio_bad = (m.pt_visible >= 8) & (
        m.pt_found.to(torch.float32) < 0.25 * m.pt_visible.to(torch.float32)
    )
    lonely = (obs_count < 2) & ((n_kf - m.pt_first_kf) >= 3)
    kill = m.pt_valid & (ratio_bad | lonely)
    return m._replace(pt_valid=m.pt_valid & ~kill)


def _fuse_into_kf(
    m: MapState, src_pts: torch.Tensor, dst_kf, active: torch.Tensor,
    cam_params: torch.Tensor, width: int, height: int, radius: float,
    cam_model: str = "pinhole",
) -> tuple[MapState, torch.Tensor]:
    """Project the landmark set ``src_pts`` [P] into keyframe ``dst_kf``
    (int or 0-d tensor) and fuse with its features: a free feature gains
    the observation; a feature bound to another landmark that coincides
    in space merges the two, keeping the better-observed one and
    redirecting every observation of the other (ORBmatcher::Fuse +
    MapPoint::Replace). The projection search runs on the matcher kernel
    on CUDA, counted as a "fuse" launch."""
    P, N = m.P, m.N
    dev = m.pt_X.device
    k1 = kf_index(dst_kf, dev)
    R = m.kf_R.index_select(0, k1)[0]
    t = m.kf_t.index_select(0, k1)[0]
    dst_row = m.kf_obs.index_select(0, k1)[0]
    feats = kf_features(m, k1)
    Xc = m.pt_X @ R.T + t
    uv = cameras.project_model(cam_params, Xc, cam_model)
    in_dst = torch.zeros((P,), dtype=torch.int32, device=dev).index_add_(
        0, torch.clamp(dst_row, 0, P - 1).long(), ((dst_row >= 0) & feats.valid).to(torch.int32)
    ) > 0  # pMP->IsInKeyFrame(pKFi) skip
    # Geometric gates of ORBmatcher::Fuse: depth within the landmark's
    # scale-invariance band, viewing direction within 60 deg of its normal.
    O_w = -R.T @ t
    po = m.pt_X - O_w
    dist = torch.linalg.norm(po, dim=-1)
    view_cos = torch.sum(po * m.pt_normal, dim=-1) / torch.clamp(dist, min=1e-12)
    banded = m.pt_max_dist > 0
    geom_ok = (~banded) | (
        (dist >= 0.8 * m.pt_min_dist) & (dist <= 1.2 * m.pt_max_dist) & (view_cos > 0.5)
    )
    ok = (
        active & src_pts & m.pt_valid & ~in_dst & geom_ok
        & (Xc[:, 2] > 0.05) & cameras.in_image(uv, width, height, 2.0)
    )
    idx, _ = matching.search_by_projection(
        uv, ok, m.pt_level, m.pt_desc_sign, feats,
        radius=radius, max_dist=35, ratio=1.0, site="fuse",
    )
    matched = idx >= 0
    j = torch.clamp(idx, 0, N - 1).long()
    ar = torch.arange(P, dtype=torch.int32, device=dev)
    # One winner per destination feature (scatter-max on the point id).
    col = torch.full((N,), -1, dtype=torch.int32, device=dev).scatter_reduce_(
        0, j, torch.where(matched, ar, -1), "amax"
    )
    is_winner = matched & (col[j] == ar)
    bound_pt = dst_row[j]  # [P] landmark currently bound at the feature
    obs_cnt = point_obs_count(m)

    # Case 1: free feature -> bind the observation.
    bind = is_winner & (bound_pt < 0)
    new_row = dst_row.scatter_reduce(0, j, torch.where(bind, ar, -1), "amax")
    kf_obs = m.kf_obs.index_copy(0, k1, new_row[None])

    # Case 2: feature bound to another landmark that coincides in space
    # (within 2% of the depth) -> merge, keeping the one with more
    # observations.
    other = torch.clamp(bound_pt, 0, P - 1).long()
    sep = torch.linalg.norm(m.pt_X - m.pt_X[other], dim=-1)
    depth = torch.clamp(Xc[:, 2], min=1e-6)
    merge = (
        is_winner & (bound_pt >= 0) & (other != ar) & m.pt_valid[other] & (sep < 0.02 * depth)
    )
    keep_other = obs_cnt[other] >= obs_cnt
    winner = torch.where(keep_other, other.to(torch.int32), ar)
    loser = torch.where(keep_other, ar, other.to(torch.int32)).long()
    # Losers are distinct across merge rows (each was bound to a distinct
    # destination feature of a row that binds each landmark once). Only the
    # merge rows write; the others go to the spare entry P, so no entry is
    # written twice with different values.
    remap = torch.arange(P + 1, dtype=torch.int32, device=dev)
    remap.index_copy_(0, torch.where(merge, loser, P), winner)
    remap = remap[:P]
    vr = torch.clamp(kf_obs, 0, P - 1).long()
    tgt = remap[vr]
    kf_obs = dedup_obs_rows(
        torch.where(kf_obs >= 0, tgt, kf_obs), (kf_obs >= 0) & (tgt != vr.to(torch.int32)), P
    )
    dead = torch.zeros((P,), dtype=torch.int32, device=dev).index_add_(
        0, loser, merge.to(torch.int32)
    ) > 0
    w = winner.long()
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    add_found = torch.zeros((P,), dtype=torch.int32, device=dev).index_add_(
        0, w, torch.where(merge, m.pt_found[loser], zero)
    )
    add_vis = torch.zeros((P,), dtype=torch.int32, device=dev).index_add_(
        0, w, torch.where(merge, m.pt_visible[loser], zero)
    )
    n_fused = torch.sum(merge, dtype=torch.int32) + torch.sum(bind, dtype=torch.int32)
    return (
        m._replace(
            kf_obs=kf_obs,
            pt_valid=m.pt_valid & ~dead,
            pt_found=m.pt_found + add_found,
            pt_visible=m.pt_visible + add_vis,
        ),
        n_fused,
    )


def fuse_in_neighbors(
    m: MapState,
    kf_id,
    cam_params: torch.Tensor,
    width: int,
    height: int,
    n_neighbors: int = 1,
    radius: float = 3.0,
    cam_model: str = "pinhole",
) -> tuple[MapState, torch.Tensor]:
    """``LocalMapping::SearchInNeighbors``: fuse duplicated landmarks
    between keyframe ``kf_id`` and its ``n_neighbors`` most covisible
    keyframes (ties to the lower slot), both directions, projecting under
    ``cam_model``. ``kf_id``: an int or a 0-d tensor. Returns (map,
    n_fused)."""
    k1 = kf_index(kf_id, m.kf_obs.device)
    obs = obs_matrix(m)
    w = obs.to(torch.float32) @ obs.index_select(0, k1)[0].to(torch.float32)  # [K]
    w.index_fill_(0, k1, -1.0)
    w = torch.where(m.kf_valid, w, torch.full_like(w, -1.0))
    top_w, top_ids = top_k(w, n_neighbors)
    n_fused = torch.zeros((), dtype=torch.int32, device=w.device)
    for i in range(n_neighbors):
        nk = top_ids[i]
        active = top_w[i] > 0
        # forward: the new keyframe's landmarks into the neighbour
        m, f1 = _fuse_into_kf(
            m, obs_matrix(m).index_select(0, k1)[0], nk, active, cam_params, width, height,
            radius, cam_model,
        )
        # reverse: the neighbour's landmarks into the new keyframe
        src = obs_matrix(m).index_select(0, nk.reshape(1))[0]
        m, f2 = _fuse_into_kf(m, src, kf_id, active, cam_params, width, height, radius,
                              cam_model)
        n_fused = n_fused + f1 + f2
    return m, n_fused


def cull_keyframes(
    m: MapState,
    n_kf,
    protect_last: int = 2,
    redundancy: float = 0.9,
    n_levels: int = 8,
) -> tuple[MapState, torch.Tensor]:
    """``LocalMapping::KeyFrameCulling``: discard the most redundant
    keyframe, at most one a call, when >= ``redundancy`` of its landmarks
    are observed by at least 3 other keyframes at the same or a finer
    octave (+1 of slack); never slot 0 or the last ``protect_last``.
    Culled keyframes drop their observations. Returns (map, n_culled)."""
    K, N, P = m.K, m.N, m.P
    dev = m.kf_obs.device
    bound = obs_matrix(m)  # [K,P]
    flat_kf = torch.arange(K, device=dev).repeat_interleave(N)
    flat_pt = torch.clamp(m.kf_obs.reshape(-1), 0, P - 1).long()
    has = (m.kf_obs.reshape(-1) >= 0) & m.kf_feat_valid.reshape(-1) & m.kf_valid[flat_kf]
    lvl = torch.full((K * P,), n_levels, dtype=torch.int32, device=dev)
    lvl.scatter_reduce_(
        0, flat_kf * P + flat_pt,
        torch.where(has, m.kf_level.reshape(-1), n_levels), "amin",
    )
    lvl = lvl.reshape(K, P)  # observation octave, n_levels if unobserved
    ls = torch.arange(n_levels, dtype=torch.int32, device=dev)
    cum = bound[:, :, None] & (lvl[:, :, None] <= ls)  # [K,P,L]
    S = torch.sum(cum, dim=0, dtype=torch.int32)  # [P,L]
    thr = torch.clamp(lvl + 1, 0, n_levels - 1).long()
    S_g = S[torch.arange(P, device=dev)[None, :], thr]  # [K,P]
    red = bound & ((S_g - bound.to(torch.int32)) >= 3)  # others, self excluded
    nb = torch.sum(bound, dim=1, dtype=torch.int32)
    nr = torch.sum(red, dim=1, dtype=torch.int32)
    ids = torch.arange(K, dtype=torch.int32, device=dev)
    frac = nr.to(torch.float32) / torch.clamp(nb.to(torch.float32), min=1.0)
    qualifies = (
        m.kf_valid & (ids > 0) & (ids < n_kf - protect_last) & (nb > 0) & (frac >= redundancy)
    )
    best = torch.argmax(torch.where(qualifies, frac, torch.full_like(frac, -1.0)))
    cull = qualifies & (ids == best)
    return _drop_keyframes(m, cull)


def _drop_keyframes(m: MapState, cull: torch.Tensor) -> tuple[MapState, torch.Tensor]:
    return (
        m._replace(
            kf_valid=m.kf_valid & ~cull,
            kf_obs=torch.where(cull[:, None], -1, m.kf_obs),
        ),
        torch.sum(cull, dtype=torch.int32),
    )


def evict_one_keyframe(
    m: MapState, n_kf, protect_last: int = 4
) -> tuple[MapState, torch.Tensor]:
    """Last-resort slot recycling at capacity (no reference counterpart):
    evict the keyframe least covisible with the last ``protect_last``
    keyframes, ties to the oldest, never slot 0 or those last ones.
    Returns (map, n_evicted)."""
    cov = covisibility(m).to(torch.float32)  # [K,K]
    ids = torch.arange(m.K, dtype=torch.int32, device=cov.device)
    recent = (m.kf_valid & (ids >= n_kf - protect_last)).to(torch.float32)
    link = torch.sum(cov * recent[None, :], dim=1)
    cand = m.kf_valid & (ids > 0) & (ids < n_kf - protect_last)
    score = torch.where(cand, link + 1e-3 * ids.to(torch.float32), torch.full_like(link, float("inf")))
    cull = cand & (ids == torch.argmin(score))
    return _drop_keyframes(m, cull)


def compact_keyframes(m: MapState):
    """Move the valid keyframe slots to the front, in temporal order, so
    that a fixed-capacity map runs unbounded sequences.

    Returns (new_map, n_valid, old_of [K] int32), where ``old_of[r]`` is
    the old slot now at slot r. ``pt_first_kf`` is remapped; a point whose
    creating keyframe was culled inherits the nearest earlier survivor."""
    K = m.K
    valid = m.kf_valid
    order = torch.argsort((~valid).to(torch.uint8), stable=True)  # valid first
    n_valid = torch.sum(valid, dtype=torch.int32)
    rank = torch.cumsum(valid.to(torch.int32), dim=0, dtype=torch.int32) - 1
    new_of_old = torch.clamp(rank, 0, K - 1)
    kf_fields = (
        "kf_valid", "kf_R", "kf_t", "kf_xy", "kf_level", "kf_angle", "kf_desc_sign",
        "kf_feat_valid", "kf_obs", "kf_ts", "kf_ur", "kf_v", "kf_bg", "kf_ba",
    )
    m2 = m._replace(
        **{k: getattr(m, k)[order] for k in kf_fields},
        pt_first_kf=new_of_old[torch.clamp(m.pt_first_kf, 0, K - 1).long()],
    )
    return m2, n_valid, order.to(torch.int32)
