"""Loop closing: place recognition -> Sim(3) verification -> essential-graph
correction — port of ``orb_slam3_ros_tpu.models.loop_closing`` (the single-map
loop path of the reference's ``LoopClosing``: NewDetectCommonRegions
:1342, DetectCommonRegionsFromBoW :1596, CorrectLoop :1987).

Per new keyframe (``LoopCloser.try_close``) or per chunk's new keyframes at
the chunk boundary (``try_close_batch``): a pending hypothesis is verified
first, then retrieval candidates are detected (signatures, covisibility,
the grouped and the plain ranking, an adaptive score floor), matched to the
keyframe by descriptors, and a Sim(3) is solved by RANSAC on the matched
landmarks; an under-supported one is grown by SearchBySim3 (K1, the
projection matcher, at launch site "sim3") and refined. A hypothesis must
be confirmed on ``required_consistency`` consecutive keyframes by guided
projection before the correction fires: the essential-graph PGO (7-dof, or
4-dof with the scale fixed on inertial maps) with every past loop edge,
duplicate landmarks welded, and the asynchronous global BA started.

All of it is torch on the map's device with a ``torch.Generator`` for the
RANSAC draws. The host reads: the candidate ids once per check, a few
scalars per candidate, one packed read per pending verification (the
batched verification runs its rounds as a Python loop with the state on the
device and reads once at the end), one per closure.

With ``dump_dir`` (or $ORB_TPU_LOOP_DUMP_DIR) every closure writes its
pose-graph problem before and after the correction
(``closure_<kf>_pre`` / ``_post``, ``utils/optdump.py``'s format), which
``reoptimize`` re-solves offline.

Every projection goes through the system's camera (``slam.cam_model``:
the Sim(3) solver's inlier test, SearchBySim3 before K1's "sim3" launch,
and the global BA), as the reference projects through the keyframe's
camera object; the JAX package projects them through the pinhole model
whatever the camera (loop_closing.py:105, ROADMAP "Known faults").

A known fault of the JAX package is not copied: its batched verification
(``_verify_pending_scan``, loop_closing.py:600) never resets the miss count
on a hit; here, as in its sequential path and LoopClosing.cc:1415, a hit
resets it.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from ..ops import cameras, hamming, lie, matching, pgo, retrieval, sim3solver
from ..ops.topk import top_k
from ..utils import optdump
from . import map_updates
from .chunk_runner import read_host
from .map_state import MapState, covisibility
from .tracking import kf_features

SIM3_RADIUS = 8.0  # SearchBySim3's search radius in level-0 pixels (x 1.2^level)


class LoopCandidate(NamedTuple):
    """A verified loop hypothesis on the host: the candidate keyframe and
    the Sim(3) (s, R, t) with its inlier count (the JAX package's record
    type; the closer keeps its hypotheses on the device)."""

    cand_kf: int
    s: float
    R: np.ndarray
    t: np.ndarray
    n_inliers: int


class Sim3Pairs(NamedTuple):
    """Matched landmark pairs between keyframes 1 and 2, by kf1's feature slot."""

    X1: torch.Tensor  # [N,3] kf1's landmark in kf1's camera frame
    X2: torch.Tensor  # [N,3] the paired landmark in kf2's camera frame
    ok: torch.Tensor  # [N] bool
    pt1: torch.Tensor  # [N] kf1's landmark ids
    pt2: torch.Tensor  # [N] the paired landmark ids
    sig1: torch.Tensor  # [N] octave variance of kf1's keypoint
    sig2: torch.Tensor  # [N] octave variance of kf2's keypoint


def _in_cam(m: MapState, kf: int, X: torch.Tensor) -> torch.Tensor:
    return X @ m.kf_R[kf].T + m.kf_t[kf]


def _pairs(m1: MapState, kf1: int, m2: MapState, kf2: int, idx, src_ok, X1) -> Sim3Pairs:
    """Map 1 keyframe kf1's feature slots paired with map 2 keyframe kf2's
    features ``idx`` (-1: none)."""
    fidx2 = torch.clamp(idx, 0, m2.N - 1).long()
    pt1 = m1.kf_obs[kf1]
    pt2 = m2.kf_obs[kf2][fidx2]
    p2c = torch.clamp(pt2, 0, m2.P - 1).long()
    ok = src_ok & (idx >= 0) & (pt2 >= 0) & m2.pt_valid[p2c]
    sig1 = 1.2 ** (2.0 * m1.kf_level[kf1].to(X1.dtype))
    sig2 = 1.2 ** (2.0 * m2.kf_level[kf2][fidx2].to(X1.dtype))
    return Sim3Pairs(X1, _in_cam(m2, kf2, m2.pt_X[p2c]), ok, pt1, pt2, sig1, sig2)


def match_points_across(m1: MapState, kf1: int, m2: MapState, kf2: int) -> Sim3Pairs:
    """Keyframe kf1 of map 1 matched to keyframe kf2 of map 2 by descriptor
    (the reference's SearchByBoW before Sim3Solver, LoopClosing.cc:1650-1720),
    their bound landmarks paired in each camera frame."""
    idx, _ = matching.search_frame_frame(kf_features(m1, kf1), kf_features(m2, kf2),
                                         max_dist=64, ratio=0.85)
    pt1 = m1.kf_obs[kf1]
    p1c = torch.clamp(pt1, 0, m1.P - 1).long()
    src_ok = (pt1 >= 0) & m1.pt_valid[p1c]
    return _pairs(m1, kf1, m2, kf2, idx, src_ok, _in_cam(m1, kf1, m1.pt_X[p1c]))


def search_by_sim3(m1: MapState, kf1: int, m2: MapState, kf2: int, s21, R21, t21, cam_params,
                   width: int, height: int, radius: float, site: str,
                   cam_model: str = "pinhole") -> Sim3Pairs:
    """Widen the pairs under a Sim(3) hypothesis (``ORBmatcher::SearchBySim3``,
    ORBmatcher.cc:1457): map 1 keyframe kf1's landmarks projected through
    S21 into map 2 keyframe kf2's image, through its camera ``cam_model``,
    and matched against its landmark-bound features within ``radius`` *
    1.2^level, TH_HIGH, no ratio test. One K1 search at launch site
    ``site``, P = N."""
    pt1 = m1.kf_obs[kf1]
    p1c = torch.clamp(pt1, 0, m1.P - 1).long()
    X1 = _in_cam(m1, kf1, m1.pt_X[p1c])
    X1in2 = s21 * (X1 @ R21.T) + t21
    uv2 = cameras.project_model(cam_params, X1in2, cam_model)
    src_ok = ((pt1 >= 0) & m1.kf_feat_valid[kf1] & m1.pt_valid[p1c] & (X1in2[:, 2] > 0.05)
              & cameras.in_image(uv2, width, height, 2.0))
    f2 = kf_features(m2, kf2)
    f2 = f2._replace(valid=f2.valid & (m2.kf_obs[kf2] >= 0))
    idx, _ = matching.search_by_projection(
        uv2, src_ok, m1.pt_level[p1c], m1.pt_desc_sign[p1c], f2, radius=radius,
        max_dist=hamming.TH_HIGH, ratio=1.0, site=site,
    )
    return _pairs(m1, kf1, m2, kf2, idx, src_ok, X1)


def _write_back(m: MapState, valid, R, t, s, kf_R0, kf_t0) -> MapState:
    """The map after a pose-graph solve (R, t, s) of the states S_iw =
    (kf_R0, kf_t0, 1): keyframe poses (R, t / s), points moved with their
    first keyframe, and world velocities rotated by each keyframe's
    rotation correction (CorrectLoop's SetVelocity)."""
    K = m.K
    ones = torch.ones((K,), dtype=m.kf_t.dtype, device=m.kf_t.device)
    new_t = t / torch.clamp(s, min=1e-6)[:, None]
    X_new = pgo.correct_points(m.pt_X, torch.clamp(m.pt_first_kf, 0, K - 1),
                               kf_R0, kf_t0, ones, R, t, s)
    v_new = torch.einsum("kij,kj->ki", R.transpose(1, 2) @ kf_R0, m.kf_v)
    return m._replace(
        kf_R=torch.where(valid[:, None, None], R, m.kf_R),
        kf_t=torch.where(valid[:, None], new_t, m.kf_t),
        pt_X=torch.where(m.pt_valid[:, None], X_new, m.pt_X),
        kf_v=torch.where(valid[:, None], v_new, m.kf_v),
    )


def _essential_graph_pgo(
    m: MapState, new_kf: int, cand_kf: int, loop_R, loop_t, loop_s, n_kf: int,
    past_i, past_j, past_R, past_t, past_s, past_valid,
    n_iters: int = 24, four_dof: bool = False, cov_min: int = 100,
):
    """Essential-graph optimization (Optimizer::OptimizeEssentialGraph,
    Optimizer.cc:1504-1929): spanning-tree edges (each keyframe's parent is
    its most covisible older keyframe, else its predecessor), the 12
    strongest covisibility edges of each keyframe at weight >= ``cov_min``,
    every past loop edge and the new one, with only the candidate fixed;
    measurements from the current poses, the start pre-corrected through
    the new keyframe's covisible neighbourhood (CorrectedSim3). Returns
    (map, cost)."""
    K = m.K
    dtype, dev = m.kf_t.dtype, m.kf_t.device
    ids = torch.arange(K, device=dev)
    valid = m.kf_valid & (ids < n_kf)
    ones = torch.ones((K,), dtype=dtype, device=dev)
    cov = covisibility(m)

    def rel_of(i, j):
        """S_ji = S_jw S_iw^-1 from the current poses (scale 1)."""
        o = torch.ones(i.shape, dtype=dtype, device=dev)
        return lie.sim3_mul(m.kf_R[j], m.kf_t[j], o, *lie.sim3_inv(m.kf_R[i], m.kf_t[i], o))

    older = (ids[None, :] < ids[:, None]) & valid[None, :]
    w_par = torch.where(older, cov, torch.full_like(cov, -1))
    parent = torch.where(torch.amax(w_par, dim=1) > 0, torch.argmax(w_par, dim=1),
                         torch.clamp(ids - 1, min=0))
    st_i, st_j = ids, parent
    st_R, st_t, st_s = rel_of(st_i, st_j)
    st_valid = valid & valid[parent] & (ids >= 1)

    topk = min(12, K - 1)
    covm = torch.where((ids[None, :] > ids[:, None]) & valid[None, :] & valid[:, None],
                       cov, torch.full_like(cov, -1))
    wv, jv = top_k(covm, topk)
    iu = ids.repeat_interleave(topk)
    ju = jv.reshape(-1)
    cv_R, cv_t, cv_s = rel_of(iu, ju)
    not_tree = (parent[ju] != iu) & (parent[iu] != ju)
    not_loop = ~(((iu == cand_kf) & (ju == new_kf)) | ((iu == new_kf) & (ju == cand_kf)))
    cv_valid = (wv.reshape(-1) >= cov_min) & valid[iu] & valid[ju] & not_tree & not_loop

    one = torch.ones((), dtype=dtype, device=dev)
    if four_dof:  # metric map: the loop scale folded into the translation, s = 1
        loop_t_e, loop_s_e = loop_t / torch.clamp(loop_s, min=1e-6), one
        past_t = past_t / torch.clamp(past_s, min=1e-6)[:, None]
    else:
        loop_t_e, loop_s_e = loop_t, loop_s
    pc_i = torch.clamp(past_i.long(), 0, K - 1)
    pc_j = torch.clamp(past_j.long(), 0, K - 1)
    e_s = torch.cat([st_s, cv_s, past_s, loop_s_e.reshape(1)])
    prob_edges = dict(
        e_i=torch.cat([st_i, iu, past_i.long(), ids.new_full((1,), new_kf)]),
        e_j=torch.cat([st_j, ju, past_j.long(), ids.new_full((1,), cand_kf)]),
        e_R=torch.cat([st_R, cv_R, past_R, loop_R[None]]),
        e_t=torch.cat([st_t, cv_t, past_t, loop_t_e[None]]),
        e_s=torch.ones_like(e_s) if four_dof else e_s,
        e_valid=torch.cat([st_valid, cv_valid,
                           past_valid & (past_i >= 0) & valid[pc_i] & valid[pc_j],
                           torch.ones((1,), dtype=torch.bool, device=dev)]),
    )
    prob_edges["e_i"] = torch.where(prob_edges["e_i"] < 0, 0, prob_edges["e_i"])
    prob_edges["e_j"] = torch.where(prob_edges["e_j"] < 0, 0, prob_edges["e_j"])

    # CorrectedSim3 start: S_neww' = S21^-1 S_candw, and each covisible
    # neighbour i gets S_iw' = (S_iw S_neww^-1) S_neww'
    Rn_c, tn_c, sn_c = lie.sim3_mul(*lie.sim3_inv(loop_R, loop_t_e, loop_s_e),
                                    m.kf_R[cand_kf], m.kf_t[cand_kf], one)
    Rni, tni, sni = lie.sim3_inv(m.kf_R[new_kf], m.kf_t[new_kf], one)
    Ri_n, ti_n, si_n = lie.sim3_mul(m.kf_R, m.kf_t, ones, Rni[None], tni[None], sni[None])
    Ri_c, ti_c, si_c = lie.sim3_mul(Ri_n, ti_n, si_n, Rn_c, tn_c, sn_c)
    window = ((cov[new_kf] >= 15) | (ids == new_kf)) & valid & (ids != cand_kf)
    prob = pgo.PGOProblem(
        R=torch.where(window[:, None, None], Ri_c, m.kf_R),
        t=torch.where(window[:, None], ti_c, m.kf_t),
        s=torch.where(window, si_c, ones),
        kf_fixed=(ids == cand_kf) | ~valid, kf_valid=valid,
        e_weight=torch.ones(prob_edges["e_i"].shape, dtype=dtype, device=dev), **prob_edges,
    )
    solve = pgo.optimize_pose_graph_4dof if four_dof else pgo.optimize_pose_graph
    res = solve(prob, n_iters=n_iters)
    return _write_back(m, valid, res.R, res.t, res.s, m.kf_R, m.kf_t), res.cost


def _pgo_over_chain(m: MapState, new_kf: int, cand_kf: int, loop_R, loop_t, loop_s, n_kf: int,
                    n_iters: int = 20, four_dof: bool = False):
    """The reduced graph: sequential odometry edges k -> k+1 and the loop
    edge (weight 5), keyframe 0 and the candidate fixed. Returns (map, cost)."""
    K = m.K
    dtype, dev = m.kf_t.dtype, m.kf_t.device
    ids = torch.arange(K, device=dev)
    valid = m.kf_valid & (ids < n_kf)
    ones = torch.ones((K,), dtype=dtype, device=dev)
    i_seq, j_seq = ids[:-1], ids[1:]
    Rm, tm, sm = lie.sim3_mul(m.kf_R[j_seq], m.kf_t[j_seq], ones[:-1],
                              *lie.sim3_inv(m.kf_R[i_seq], m.kf_t[i_seq], ones[:-1]))
    e_t = torch.cat([tm, loop_t[None]])
    e_s = torch.cat([sm, loop_s.reshape(1)])
    if four_dof:
        e_t[-1] = loop_t / torch.clamp(loop_s, min=1e-6)
        e_s = torch.ones_like(e_s)
    prob = pgo.PGOProblem(
        R=m.kf_R, t=m.kf_t, s=ones,
        kf_fixed=(ids == cand_kf) | (ids == 0) | ~valid, kf_valid=valid,
        e_i=torch.cat([i_seq, ids.new_full((1,), new_kf)]),
        e_j=torch.cat([j_seq, ids.new_full((1,), cand_kf)]),
        e_R=torch.cat([Rm, loop_R[None]]), e_t=e_t, e_s=e_s,
        e_valid=torch.cat([valid[i_seq] & valid[j_seq],
                           torch.ones((1,), dtype=torch.bool, device=dev)]),
        e_weight=torch.cat([torch.ones_like(sm), torch.full((1,), 5.0, dtype=dtype, device=dev)]),
    )
    solve = pgo.optimize_pose_graph_4dof if four_dof else pgo.optimize_pose_graph
    res = solve(prob, n_iters=n_iters)
    return _write_back(m, valid, res.R, res.t, res.s, m.kf_R, m.kf_t), res.cost


def _fuse_duplicates(m: MapState, pt1, pt2, pair_ok) -> MapState:
    """Weld duplicate landmarks after a closure (``LoopClosing::SearchAndFuse``
    / ``MapPoint::Replace``, LoopClosing.cc:3446, on the Sim(3) inlier
    pairs): every observation of pt1 goes to pt2, one binding per
    (keyframe, landmark) survives, pt1 dies."""
    P = m.P
    dev = m.kf_obs.device
    src = torch.clamp(pt1, 0, P - 1).long()
    dst = torch.clamp(pt2, 0, P - 1)
    ok = pair_ok & (src != dst)
    # Only the welded pairs write, each at its own source (a landmark binds
    # once per keyframe row); the rest go to a spare slot past the end (the
    # JAX package writes them back onto themselves, which can race with a
    # welded pair at slot 0, the clamp of an unbound -1).
    at = torch.where(ok, src, P)
    remap = torch.arange(P + 1, dtype=torch.int32, device=dev)
    remap[at] = dst.to(torch.int32)
    killed = torch.zeros((P + 1,), dtype=torch.bool, device=dev)
    killed[at] = True
    vr = torch.clamp(m.kf_obs, 0, P - 1).long()
    tgt = remap[:P][vr]
    new_obs = map_updates.dedup_obs_rows(
        torch.where(m.kf_obs >= 0, tgt, m.kf_obs), (m.kf_obs >= 0) & (tgt != vr), P
    )
    return m._replace(kf_obs=new_obs, pt_valid=m.pt_valid & ~killed[:P])


def _adaptive_min_score(q, sigs, cov_row, kf_valid, ids, n_kf, new_kf, min_score):
    """The candidate score floor (minScore, LoopClosing.cc:1360-1380): the
    lowest similarity between the query and its covisible neighbours
    (weight >= 15), at least ``min_score``; ``min_score`` without
    neighbours."""
    neigh = (cov_row >= 15) & kf_valid & (ids < n_kf) & (ids != new_kf)
    s = retrieval.score_against(q, sigs)
    min_cov = torch.amin(torch.where(neigh, s, torch.full_like(s, float("inf"))))
    return torch.clamp(torch.where(torch.isfinite(min_cov), min_cov,
                                   torch.full_like(min_cov, min_score)), min=min_score)


def _detect_candidates_batch(m: MapState, new_kfs, n_kf: int, vocab, min_gap: int,
                             min_score: float, use_covisibility: bool = True) -> torch.Tensor:
    """Loop candidates of each keyframe of ``new_kfs`` (host ints), the
    keyframe signatures and the covisibility computed once for all: per
    keyframe, the grouped ranking (DetectNBestCandidates) and the plain
    ranking, 3 ids each, under the adaptive floor, keyframes closer than
    ``min_gap`` (and covisible ones, with ``use_covisibility``) excluded.
    Returns [B, 6] int32 ids, -1 for none."""
    sigs = retrieval.kf_signatures(m.kf_desc_sign, m.kf_feat_valid, vocab)
    cov = covisibility(m)
    ids = torch.arange(m.K, device=sigs.device)
    rows = []
    for nk in new_kfs:
        q = sigs[nk]
        exclude = (ids > nk - min_gap) | (ids >= n_kf)
        if use_covisibility:
            exclude = exclude | (cov[nk] > 10)
        thr = _adaptive_min_score(q, sigs, cov[nk], m.kf_valid, ids, n_kf, nk, min_score)
        cand_g, _ = retrieval.detect_candidates_grouped(q, sigs, cov, m.kf_valid, exclude,
                                                        min_common_score=thr)
        cand_f, _ = retrieval.detect_candidates(q, sigs, m.kf_valid, exclude, min_common_score=thr)
        rows.append(torch.cat([cand_g, cand_f]))
    return torch.stack(rows)


def _detect_candidates_fused(m: MapState, new_kf: int, n_kf: int, vocab, min_gap: int,
                             min_score: float, use_covisibility: bool = True) -> torch.Tensor:
    """``_detect_candidates_batch`` of one keyframe: [6] int32."""
    return _detect_candidates_batch(m, [new_kf], n_kf, vocab, min_gap, min_score,
                                    use_covisibility)[0]


def _verify_pending_fused(m: MapState, new_kf: int, cand: int, S_cw, cam_params, width: int,
                          height: int, min_inliers: int, fix_scale: bool = False,
                          cam_model: str = "pinhole"):
    """One guided verification of a pending hypothesis on ``new_kf``
    (DetectAndReffineSim3FromLastKF, LoopClosing.cc:1553): the stored
    world -> candidate Sim(3) propagated through the keyframe's pose, the
    pairs grown by SearchBySim3, the Sim(3) refined, both through
    ``cam_model``. Returns (result, the re-propagated S_cw, the pairs)."""
    one = torch.ones((), dtype=m.kf_t.dtype, device=m.kf_t.device)
    Rcj, tcj, scj = lie.sim3_mul(*S_cw, *lie.sim3_inv(m.kf_R[new_kf], m.kf_t[new_kf], one))
    pr = search_by_sim3(m, new_kf, m, cand, scj, Rcj, tcj, cam_params, width, height, SIM3_RADIUS,
                        "sim3", cam_model)
    res = sim3solver.refine_sim3(pr.X1, pr.X2, pr.ok, cam_params, scj, Rcj, tcj,
                                 min_inliers=min_inliers, sigma2_1=pr.sig1, sigma2_2=pr.sig2,
                                 fix_scale=fix_scale, cam_model=cam_model)
    S_cw_new = lie.sim3_mul(res.R, res.t, res.s, m.kf_R[new_kf], m.kf_t[new_kf], one)
    return res, S_cw_new, pr


class PendingScan(NamedTuple):
    """What ``_verify_pending_scan`` leaves, read on the host at once."""

    status: np.ndarray  # [B, 4] per round: (ran, ok, fired, died)
    state: int  # 0 pending, 1 fired, 2 died
    count: int
    miss: int
    S_cw: tuple  # the carried hypothesis (R, t, s) on the device
    fire: tuple  # at the firing round: (R, t, s, n_inliers, pt1, pt2, inlier pairs) on the device


def _verify_pending_scan(m: MapState, kfs, cand: int, S_cw, cam_params, width: int, height: int,
                         min_inliers: int, count0: int, miss0: int, required: int,
                         fix_scale: bool = False, cam_model: str = "pinhole") -> PendingScan:
    """Every pending-verification round for a chunk's new keyframes ``kfs``
    (host ints), each ``_verify_pending_fused``'s flow, with (S_cw, count,
    miss, state) carried on the device and one host read at the end. The
    carry freezes once the closure fires (count reaches ``required``) or
    the hypothesis dies (a second miss in a row). A hit resets the miss
    count, as the sequential path does (the JAX package's scan does not:
    loop_closing.py:600)."""
    dev = m.kf_t.device
    i32 = dict(dtype=torch.int32, device=dev)
    R_cw, t_cw, s_cw = S_cw
    count = torch.full((), count0, **i32)
    miss = torch.full((), miss0, **i32)
    state = torch.zeros((), **i32)
    N = m.N
    fire_pay = (torch.eye(3, dtype=R_cw.dtype, device=dev), torch.zeros_like(t_cw),
                torch.ones_like(s_cw), torch.zeros((), **i32), torch.full((N,), -1, **i32),
                torch.full((N,), -1, **i32), torch.zeros((N,), dtype=torch.bool, device=dev))
    status = []
    for kf in kfs:
        run = state == 0
        res, S_new, pr = _verify_pending_fused(m, kf, cand, (R_cw, t_cw, s_cw), cam_params,
                                               width, height, min_inliers, fix_scale, cam_model)
        hit = run & res.ok
        miss_round = run & ~res.ok
        count = torch.where(hit, count + 1, count)
        miss = torch.where(hit, 0, torch.where(miss_round, miss + 1, miss))
        R_cw, t_cw, s_cw = (torch.where(hit, new, old) for new, old in zip(S_new, (R_cw, t_cw, s_cw)))
        fire = hit & (count >= required)
        die = miss_round & (miss > 1)
        pay = (res.R, res.t, res.s, res.n_inliers, pr.pt1, pr.pt2, pr.ok & res.inlier)
        fire_pay = tuple(torch.where(fire, new, old) for new, old in zip(pay, fire_pay))
        state = torch.where(fire, 1, torch.where(die, 2, state))
        status.append(torch.stack([run, run & res.ok, fire, die]))
    st, sc = read_host(torch.stack(status), torch.stack([state, count, miss]))
    return PendingScan(status=st > 0.5, state=int(sc[0]), count=int(sc[1]), miss=int(sc[2]),
                       S_cw=(R_cw, t_cw, s_cw), fire=fire_pay)


class LoopCloser:
    """Loop detection and correction, driven by the system at its keyframe
    events (the JAX package's ``LoopCloser``, with its constructor
    arguments and defaults). ``closures`` lists (new_kf, cand_kf,
    n_inliers); ``sim3_searches`` counts the SearchBySim3 calls made."""

    def __init__(self, min_gap: int = 10, min_score: float = 0.30,
                 min_sim3_inliers: int = 20, use_covisibility: bool = True,
                 four_dof: bool = False, dump_dir: str | None = None,
                 run_gba: bool = True, gba_iters: int = 8,
                 required_consistency: int = 3, auto_train_vocab: bool = True):
        self.min_gap = min_gap
        self.min_score = min_score
        self.min_sim3_inliers = min_sim3_inliers
        # A candidate must be re-confirmed on this many consecutive
        # keyframes before the correction fires (mnLoopNumCoincidences >= 3).
        self.required_consistency = required_consistency
        self._pending = None  # {"cand", "count", "miss", "S_cw": (R, t, s) on the device}
        self.auto_train_vocab = auto_train_vocab
        self._vocab_trained_at = -1
        self._vocab_future = None
        self._vocab_exec = None
        self.run_gba = run_gba
        self.gba_iters = gba_iters
        self.four_dof = four_dof
        # The optimization problem of every closure, before and after its
        # correction (the fork's SetSaveLoopData, LoopClosing.cc:987), into
        # ``dump_dir`` or $ORB_TPU_LOOP_DUMP_DIR when set.
        self.dump_dir = dump_dir or os.environ.get("ORB_TPU_LOOP_DUMP_DIR")
        self.use_covisibility = use_covisibility
        self.last_closed_kf = -100
        self.closures = []
        self.sim3_searches = 0
        self.vocab = None  # [A, 256] int8 on the map's device; set by the system
        # Persistent loop edges (KeyFrame::mspLoopEdges): every accepted
        # closure's constraint stays in all later essential-graph solves;
        # the capacity doubles when full.
        self.max_loop_edges = 16
        self._edge_i = np.full((16,), -1, np.int32)
        self._edge_j = np.full((16,), -1, np.int32)
        self._edge_R = np.tile(np.eye(3, dtype=np.float32), (16, 1, 1))
        self._edge_t = np.zeros((16, 3), np.float32)
        self._edge_s = np.ones((16,), np.float32)
        self._n_edges = 0

    # ---- persistent loop edges ---------------------------------------
    def _grow_edges(self):
        pad = self.max_loop_edges
        self._edge_i = np.concatenate([self._edge_i, np.full((pad,), -1, np.int32)])
        self._edge_j = np.concatenate([self._edge_j, np.full((pad,), -1, np.int32)])
        self._edge_R = np.concatenate([self._edge_R, np.tile(np.eye(3, dtype=np.float32), (pad, 1, 1))])
        self._edge_t = np.concatenate([self._edge_t, np.zeros((pad, 3), np.float32)])
        self._edge_s = np.concatenate([self._edge_s, np.ones((pad,), np.float32)])
        self.max_loop_edges *= 2

    def _record_loop_edge(self, i, j, R, t, s):
        """Store an edge in the first slot compaction freed, growing if none."""
        free = np.nonzero(self._edge_i < 0)[0]
        if len(free) == 0:
            self._grow_edges()
            free = np.nonzero(self._edge_i < 0)[0]
        k = int(free[0])
        self._edge_i[k], self._edge_j[k] = i, j
        self._edge_R[k], self._edge_t[k], self._edge_s[k] = R, t, s
        self._n_edges += 1

    def remap_slots(self, new_of_old: np.ndarray) -> None:
        """Reindex the loop edges after keyframe compaction (edges with a
        culled end are dropped) and discard the slot-addressed pending
        hypothesis."""
        self._pending = None
        for k in range(self.max_loop_edges):
            if self._edge_i[k] < 0:
                continue
            a, b = new_of_old[self._edge_i[k]], new_of_old[self._edge_j[k]]
            if a < 0 or b < 0:
                self._edge_i[k] = self._edge_j[k] = -1
            else:
                self._edge_i[k], self._edge_j[k] = a, b
        if 0 <= self.last_closed_kf < len(new_of_old):
            nb = new_of_old[self.last_closed_kf]
            self.last_closed_kf = int(nb) if nb >= 0 else -100

    def _past_edges(self, device):
        return tuple(torch.from_numpy(a.copy()).to(device) for a in (
            self._edge_i, self._edge_j, self._edge_R, self._edge_t, self._edge_s,
            self._edge_i >= 0))

    # ---- vocabulary ----------------------------------------------------
    def _poll_vocab_training(self, slam) -> None:
        """Train the retrieval vocabulary off the critical path: once the
        map can support one (no vocabulary yet, 12 keyframes), then again
        whenever the keyframe count has doubled. The descriptors are read
        here, on the calling thread, in one host read; the k-medians runs
        in numpy on a background thread that launches no device work (the
        main thread may be capturing CUDA graphs); a finished result is
        installed at a later check."""
        fut = self._vocab_future
        if fut is not None:
            if fut.done():
                self._vocab_future = None
                vocab, n_at = fut.result()
                slam.set_vocabulary(vocab)
                self._vocab_trained_at = n_at
            return
        need = ((self.vocab is None and self._vocab_trained_at < 0 and slam.n_kf >= 12)
                or (self._vocab_trained_at > 0 and slam.n_kf >= 2 * self._vocab_trained_at))
        if not need:
            return
        if self._vocab_exec is None:
            self._vocab_exec = ThreadPoolExecutor(max_workers=1)
        n_at = slam.n_kf
        desc, valid = read_host(slam.map.kf_desc_sign[:n_at], slam.map.kf_feat_valid[:n_at])
        train = desc.reshape(-1, 256)[valid.reshape(-1) > 0.5].astype(np.int8)
        # power-of-two sizes, as the JAX package (it specializes on the shape)
        n_words = int(np.clip(len(train) // 16, 32, retrieval.MAX_WORDS))
        n_words = 1 << (n_words.bit_length() - 1)

        def _train():
            if n_words >= 1024:
                return retrieval.train_vocabulary_hier(train, n_words=n_words), n_at
            return retrieval.train_vocabulary(train, n_words=n_words), n_at

        self._vocab_future = self._vocab_exec.submit(_train)

    # ---- detection and verification -----------------------------------
    def _grow(self, m, kf1, kf2, s, R, t, slam) -> Sim3Pairs:
        self.sim3_searches += 1
        return search_by_sim3(m, kf1, m, kf2, s, R, t, slam.cam_params, slam.width, slam.height,
                              SIM3_RADIUS, "sim3", slam.cam_model)

    def try_close(self, slam, new_kf: int, generator: torch.Generator | None = None) -> bool:
        """Attempt a closure on keyframe ``new_kf`` (NewDetectCommonRegions'
        flow, LoopClosing.cc:1342-1595): advance a pending hypothesis, or
        detect and verify fresh candidates. Rewrites ``slam.map`` when a
        closure fires; returns whether one did."""
        if self.auto_train_vocab:
            self._poll_vocab_training(slam)
        if self._pending is not None:
            fired = self._advance_pending(slam, new_kf)
            if fired is not None:
                return fired
        if new_kf - self.last_closed_kf < self.min_gap:
            return False
        cand = _detect_candidates_fused(slam.map, new_kf, slam.n_kf, self.vocab, self.min_gap,
                                        self.min_score, self.use_covisibility)
        return self._try_candidates(slam, new_kf, cand.cpu().numpy(), generator)

    def _try_candidates(self, slam, new_kf: int, cand_ids, generator=None) -> bool:
        """Sim(3)-verify retrieval candidates for ``new_kf`` (RANSAC ->
        SearchBySim3 -> OptimizeSim3, LoopClosing.cc:1596-1720): the first
        that holds is corrected at once (``required_consistency`` 1) or
        stashed as the pending hypothesis. Inertial maps solve with the
        scale fixed (Sim3Solver's bFixScale)."""
        m = slam.map
        gen = slam.generator if generator is None else generator
        fs = bool(getattr(slam, "imu_initialized", False))
        kw = dict(min_inliers=self.min_sim3_inliers, fix_scale=fs, cam_model=slam.cam_model)
        tried = set()
        for c in cand_ids:
            c = int(c)
            if c < 0 or c in tried:
                continue
            tried.add(c)
            pr = match_points_across(m, new_kf, m, c)
            if int(pr.ok.sum()) < 20:
                continue
            res = sim3solver.solve_sim3(pr.X1, pr.X2, pr.ok, slam.cam_params, gen,
                                        sigma2_1=pr.sig1, sigma2_2=pr.sig2, **kw)
            ok, n_inl = read_host(res.ok, res.n_inliers)
            pairs_ok = pr.ok
            if not ok:
                # plausible but under-supported: grow by SearchBySim3 and refine
                if int(n_inl) < max(5, self.min_sim3_inliers // 3):
                    continue
                pr = self._grow(m, new_kf, c, res.s, res.R, res.t, slam)
                res = sim3solver.refine_sim3(pr.X1, pr.X2, pr.ok, slam.cam_params, res.s, res.R,
                                             res.t, sigma2_1=pr.sig1, sigma2_2=pr.sig2, **kw)
                ok, n_inl = read_host(res.ok, res.n_inliers)
                if not ok:
                    continue
                pairs_ok = pr.ok
            if self.required_consistency <= 1:
                return self._apply_closure(slam, new_kf, c, res.R, res.t, res.s, int(n_inl),
                                           pr.pt1, pr.pt2, pairs_ok & res.inlier)
            one = torch.ones((), dtype=m.kf_t.dtype, device=m.kf_t.device)
            # the hypothesis as world -> candidate camera: S_cw = S21 S_neww
            S_cw = lie.sim3_mul(res.R, res.t, res.s, m.kf_R[new_kf], m.kf_t[new_kf], one)
            self._pending = {"cand": c, "count": 1, "miss": 0, "S_cw": S_cw}
            return False
        return False

    def try_close_batch(self, slam, new_kfs, generator: torch.Generator | None = None) -> bool:
        """Closure processing for every keyframe a chunk inserted, at the
        chunk boundary: all pending-verification rounds at once, then one
        batched candidate detection for the keyframes left (the reference's
        loop thread consuming its keyframe queue, LoopClosing.cc:1108).
        The same as ``try_close`` per keyframe in order, except that
        detection for keyframes after a closure fired mid-batch sees the
        pre-correction map (their candidates are still verified against
        the corrected one). Returns whether a closure fired."""
        new_kfs = [int(k) for k in new_kfs]
        if not new_kfs:
            return False
        if self.auto_train_vocab:
            self._poll_vocab_training(slam)
        fired_any = False
        start = 0
        if self._pending is not None:
            fired_any, start = self._advance_pending_batch(slam, new_kfs)
        rem = [k for k in new_kfs[start:] if k - self.last_closed_kf >= self.min_gap]
        if not rem:
            return fired_any
        cand_rows = _detect_candidates_batch(slam.map, rem, slam.n_kf, self.vocab, self.min_gap,
                                             self.min_score, self.use_covisibility).cpu().numpy()
        for r, k in enumerate(rem):
            if self._pending is not None:
                # a hypothesis stashed earlier in this batch: verify it here
                out = self._advance_pending(slam, k)
                if out is not None:
                    fired_any |= bool(out)
                    continue
            if k - self.last_closed_kf < self.min_gap or (cand_rows[r] < 0).all():
                continue
            fired_any |= self._try_candidates(slam, k, cand_rows[r], generator)
        return fired_any

    def _advance_pending_batch(self, slam, new_kfs):
        """All of a batch's verification rounds in one pass
        (``_verify_pending_scan``). Returns (fired, consumed): the leading
        keyframes the pending hypothesis used up; the rest still need
        detection."""
        p = self._pending
        scan = _verify_pending_scan(
            slam.map, new_kfs, p["cand"], p["S_cw"], slam.cam_params, slam.width, slam.height,
            self.min_sim3_inliers, p["count"], p["miss"], self.required_consistency,
            fix_scale=bool(getattr(slam, "imu_initialized", False)), cam_model=slam.cam_model,
        )
        self.sim3_searches += len(new_kfs)
        if scan.state == 1:
            j = int(np.nonzero(scan.status[:, 2])[0][0])
            self._pending = None
            fR, ft, fs, fn, fpt1, fpt2, fok = scan.fire
            self._apply_closure(slam, new_kfs[j], p["cand"], fR, ft, fs, int(fn), fpt1, fpt2, fok)
            return True, j + 1
        if scan.state == 2:
            j = int(np.nonzero(scan.status[:, 3])[0][0])
            self._pending = None
            return False, j  # keyframe j goes on to detection
        p["count"], p["miss"], p["S_cw"] = scan.count, scan.miss, scan.S_cw
        return False, len(new_kfs)

    def _advance_pending(self, slam, new_kf: int):
        """Verify the pending hypothesis on ``new_kf`` by guided projection
        (one packed read). Returns True / False when this keyframe is done
        with, None to fall through to fresh detection (hypothesis dropped)."""
        p = self._pending
        res, S_cw_new, pr = _verify_pending_fused(
            slam.map, new_kf, p["cand"], p["S_cw"], slam.cam_params, slam.width, slam.height,
            self.min_sim3_inliers, fix_scale=bool(getattr(slam, "imu_initialized", False)),
            cam_model=slam.cam_model,
        )
        self.sim3_searches += 1
        ok, n_inl = read_host(res.ok, res.n_inliers)
        if ok:
            p["count"] += 1
            p["miss"] = 0
            p["S_cw"] = S_cw_new
            if p["count"] >= self.required_consistency:
                self._pending = None
                return self._apply_closure(slam, new_kf, p["cand"], res.R, res.t, res.s,
                                           int(n_inl), pr.pt1, pr.pt2, pr.ok & res.inlier)
            return False
        p["miss"] += 1
        if p["miss"] > 1:  # mnLoopNumNotFound < 2
            self._pending = None
            return None
        return False

    # ---- correction ----------------------------------------------------
    def _apply_closure(self, slam, new_kf: int, cand: int, loop_R, loop_t, loop_s,
                       n_inliers: int, pt1, pt2, fuse_ok) -> bool:
        """CorrectLoop (LoopClosing.cc:1987-2537): fold in and stop an
        in-flight global BA, correct the map through the essential graph
        (4-dof on inertial maps), record the loop edge, weld the duplicate
        landmarks, start the asynchronous global BA, refresh the point
        statistics and move the tracker to the corrected keyframe pose."""
        if slam._gba is not None:
            slam.abort_gba()  # mbStopGBA: a new closure stops the running solve
            while slam._gba is not None:
                slam._poll_gba(force=True)
        four_dof = self.four_dof or bool(getattr(slam, "imu_initialized", False))
        dev = slam.map.kf_t.device
        if self.dump_dir:
            self._dump_problem(slam, new_kf, cand, loop_R, loop_t, loop_s, "pre")
        slam.map, _ = _essential_graph_pgo(
            slam.map, new_kf, cand, loop_R, loop_t, loop_s, slam.n_kf, *self._past_edges(dev),
            four_dof=four_dof,
        )
        R, t, s, R_kf, t_kf = read_host(loop_R, loop_t, loop_s, slam.map.kf_R[new_kf],
                                        slam.map.kf_t[new_kf])
        self._record_loop_edge(new_kf, cand, R, t, float(s))
        if self.dump_dir:
            self._dump_problem(slam, new_kf, cand, R, t, s, "post")
        slam.map = _fuse_duplicates(slam.map, pt1, pt2, fuse_ok)
        if self.run_gba:
            slam._start_async_gba(self.gba_iters)
        slam.map = map_updates.refresh_point_stats(slam.map, n_levels=slam.config.n_levels)
        self.last_closed_kf = new_kf
        self.closures.append((new_kf, cand, n_inliers))
        slam.R_cur, slam.t_cur = R_kf.copy(), t_kf.copy()
        slam.vel_R = np.eye(3, dtype=np.float32)
        slam.vel_t = np.zeros(3, np.float32)
        slam._ref_cache = None
        return True

    def _dump_problem(self, slam, new_kf: int, cand: int, R, t, s, tag: str) -> None:
        """Write the closure's whole optimization problem with its loop
        constraint to ``dump_dir/closure_<new_kf>_<tag>`` (the fork's
        SaveOptimizationData pre / post directories,
        LoopClosing.cc:2006-2365)."""
        R, t, s = (x.cpu().numpy() if isinstance(x, torch.Tensor) else x for x in (R, t, s))
        d = optdump.dump_from_map(slam.map, slam.n_kf,
                                  loop_edges=[(new_kf, cand, R, t, float(s))])
        optdump.save_optimization_data(os.path.join(self.dump_dir, f"closure_{new_kf}_{tag}"), **d)
