"""Atlas: multi-map management — port of ``orb_slam3_ros_tpu.models.atlas``
(the reference's ``Atlas``, Atlas.cc: a set of maps with one active; the
tracking-loss policy of ``Tracking::CreateMapInAtlas``, Tracking.cc:2050-2068:
a map with fewer than ``min_kf_keep`` keyframes is reset, a larger one
archived; and the map-merge entry of ``LoopClosing``, MergeLocal,
LoopClosing.cc:1140-1211/2546).

An archived map is its ``MapState`` (a clone on the system's device: the
chunk loop's buffers may alias the active map), its counters, its keyframes'
retrieval signatures and, for an inertial map, its IMU side-state. A lost
frame may switch into an archived map (retrieval, then tracking against
it); a young map is welded into an archived one by a verified Sim(3): the
cross-map SearchBySim3 is K1 at launch site "merge", the younger map is
transformed and copied into the older one's free slots. A system split over two
devices keeps every active map on its map device and refreshes tracking's
replica after an archive, a switch or a weld.

Three faults of the JAX package are not copied (each pinned by a test in
``tests/test_torch_atlas.py``):

- a switch there overwrites the active map even when it has
  ``min_kf_keep`` keyframes or more (atlas.py:116-172); here such a map is
  archived first, as Tracking.cc:2050-2068 keeps it;
- a weld there carries no viewing normal or scale-invariance band
  (``pt_normal``, ``pt_min_dist``, ``pt_max_dist``; atlas.py:398-455), so the
  welded points keep what the archived map's slots held (zero: the viewing
  gate off); here they are carried across, transformed as
  ``map_updates.apply_scaled_rotation`` transforms them (MergeLocal updates
  normal and depth);
- the loop closer there keeps loop edges and a pending hypothesis that
  name keyframe slots of another map; here they are dropped at an archive
  or a switch, and shifted with the welded keyframes at a weld.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..ops import lie, retrieval, sim3solver
from . import map_state, tracking
from .loop_closing import match_points_across, search_by_sim3
from .map_state import MapState

MERGE_RADIUS = 10.0  # the cross-map SearchBySim3's radius in level-0 pixels (x 1.2^level)


@dataclass
class ArchivedMap:
    m: MapState
    n_kf: int
    n_pts: int
    sigs: torch.Tensor  # [K, A] retrieval signatures
    # Inertial side-state (None for visual maps): per-keyframe IMU blocks,
    # initialization flags, chain-break set (see InertialSlam).
    imu: Optional[dict] = None


@dataclass
class Atlas:
    """Host-side registry of archived maps, attached to a SLAM system.
    ``grow_searches`` counts the cross-map SearchBySim3 calls (K1 launches
    at site "merge")."""

    min_kf_keep: int = 8  # maps smaller than this are discarded on loss
    maps: list = field(default_factory=list)
    # The retrieval vocabulary ([A, 256] int8 on the map's device), set by
    # the system; archived signatures are not recomputed when it changes.
    vocab: Optional[torch.Tensor] = None
    grow_searches: int = 0

    def archive_current(self, slam) -> bool:
        """Archive the active map if it is worth keeping (>= min_kf_keep
        keyframes), then reset the system to a fresh empty map. Returns
        True if archived, False if discarded."""
        from .system import NOT_INITIALIZED

        keep = slam.n_kf >= self.min_kf_keep
        inertial = hasattr(slam, "kf_imu_acc")
        slam.flush()  # fold in a global BA in flight before the map is frozen
        if keep:
            sigs = retrieval.kf_signatures(slam.map.kf_desc_sign, slam.map.kf_feat_valid, self.vocab)
            imu = None
            if inertial:
                imu = dict(
                    acc=slam.kf_imu_acc.copy(), gyro=slam.kf_imu_gyro.copy(),
                    dts=slam.kf_imu_dts.copy(), initialized=slam.imu_initialized,
                    stage=slam.imu_stage, chain_breaks=set(slam.chain_breaks),
                )
            self.maps.append(ArchivedMap(
                m=MapState(*(x.clone() for x in slam.map)), n_kf=slam.n_kf, n_pts=slam.n_pts,
                sigs=sigs, imu=imu,
            ))
        if inertial:
            # A fresh map starts un-initialized on a fresh IMU chain; the
            # sensor history (_imu_history) carries over, as the reference's
            # CreateMapInAtlas keeps grabbing IMU (Tracking.cc:2701).
            slam.kf_imu_acc[:] = 0
            slam.kf_imu_gyro[:] = 0
            slam.kf_imu_dts[:] = 0
            slam.imu_initialized = False
            slam.imu_stage = 0
            slam.chain_breaks = set()
            slam.v_cur = np.zeros(3, np.float32)
            slam.bg_cur = np.zeros(3, np.float32)
            slam.ba_cur = np.zeros(3, np.float32)
            _drop_inertial_device_state(slam)
        slam.map = map_state.empty_map(slam.K_cap, slam.N, slam.P_cap, device=slam.device)
        slam._sync_replica()
        slam.n_kf = 0
        slam.n_pts = 0
        slam.init_feats = None
        slam.R_cur = np.eye(3, dtype=np.float32)
        slam.t_cur = np.zeros(3, np.float32)
        slam.vel_R = np.eye(3, dtype=np.float32)
        slam.vel_t = np.zeros(3, np.float32)
        slam.state = NOT_INITIALIZED
        slam._ref_cache = None
        _drop_loop_slots(slam)
        return keep

    # ------------------------------------------------------------------
    def try_relocalize_in_archived(self, slam, feats) -> bool:
        """Try to continue in an archived map (a re-encounter): per archived
        map, up to 3 retrieval candidates (one host read), each tried by
        tracking against that map from the candidate's pose (one read an
        attempt); 30 inliers switch the active map. An active map worth
        keeping is archived first."""
        from .system import OK

        q = retrieval.signature(feats.desc_sign, feats.valid, self.vocab)
        for k, am in enumerate(self.maps):
            cand_ids, _ = retrieval.detect_candidates(
                q, am.sigs, am.m.kf_valid,
                torch.zeros((am.m.K,), dtype=torch.bool, device=am.m.kf_valid.device),
                min_common_score=0.3,
            )
            for c in cand_ids.cpu().numpy():
                if c < 0:
                    continue
                res = tracking.track_against_map(
                    am.m, feats, am.m.kf_R[int(c)], am.m.kf_t[int(c)], slam.cam_params,
                    slam.width, slam.height,
                )
                buf = torch.cat([res.n_inliers.reshape(1).to(res.t.dtype), res.R.reshape(9),
                                 res.t]).cpu().numpy()
                if int(buf[0]) < 30:
                    continue
                del self.maps[k]
                if slam.n_kf >= self.min_kf_keep:
                    self.archive_current(slam)
                self._switch_to(slam, am, buf[1:10].reshape(3, 3).copy(), buf[10:13].copy())
                slam.state = OK
                return True
        return False

    @staticmethod
    def _switch_to(slam, am: ArchivedMap, R_cw: np.ndarray, t_cw: np.ndarray) -> None:
        slam.map = am.m
        slam._sync_replica()
        slam.n_kf = am.n_kf
        slam.n_pts = am.n_pts
        if am.imu is not None:
            slam.kf_imu_acc = am.imu["acc"].copy()
            slam.kf_imu_gyro = am.imu["gyro"].copy()
            slam.kf_imu_dts = am.imu["dts"].copy()
            slam.imu_initialized = am.imu["initialized"]
            slam.imu_stage = am.imu["stage"]
            # The next keyframe starts a fresh IMU chain: the archived map
            # was recorded earlier, no preintegration spans the time gap.
            slam.chain_breaks = set(am.imu["chain_breaks"]) | {am.n_kf}
            if am.imu["initialized"]:
                b = torch.cat([am.m.kf_bg[am.n_kf - 1], am.m.kf_ba[am.n_kf - 1]]).cpu().numpy()
                slam.bg_cur, slam.ba_cur = b[0:3].copy(), b[3:6].copy()
                slam.v_cur = np.zeros(3, np.float32)
        if hasattr(slam, "kf_imu_acc"):
            _drop_inertial_device_state(slam)
        slam.R_cur, slam.t_cur = R_cw, t_cw
        slam.vel_R = np.eye(3, dtype=np.float32)
        slam.vel_t = np.zeros(3, np.float32)
        slam._ref_cache = None
        _drop_loop_slots(slam)

    # ------------------------------------------------------------------
    def merge_current_into(self, slam, archived_idx: int) -> bool:
        """Weld the active map into archived map ``archived_idx`` (MergeLocal,
        LoopClosing.cc:2546): the 5 best cross-map keyframe pairs by
        signature score (score >= 0.2), each tried as descriptor pairs ->
        Sim(3) RANSAC -> SearchBySim3 across the maps (K1, site "merge") ->
        IRLS refit with 15 inliers; the first that holds gives the
        world-to-world Sim(3), the active map is transformed by it and
        copied into the archived one's free slots. With both maps
        IMU-initialized the weld is rigid (the scale fixed), the per-keyframe
        IMU blocks are re-indexed, the seam becomes a chain break and a
        welding VI-BA runs over the newest window (MergeLocal2 /
        MergeInertialBA, LoopClosing.cc:3114, Optimizer.cc:4093). The
        current pose and velocity move with the transform. The RANSAC
        hypotheses are drawn from ``slam.generator``."""
        slam.flush()
        gen = slam.generator
        am = self.maps[archived_idx]
        cur = slam.map
        inertial = hasattr(slam, "kf_imu_acc")
        both_metric = bool(inertial and am.imu is not None and am.imu["initialized"]
                           and slam.imu_initialized)
        cur_sigs = retrieval.kf_signatures(cur.kf_desc_sign, cur.kf_feat_valid, self.vocab)
        S = (cur_sigs @ am.sigs.T).cpu().numpy().copy()  # [Kc, Ka]
        S[slam.n_kf:, :] = -1
        S[:, am.n_kf:] = -1
        order = np.argsort(S.reshape(-1))[::-1][:5]
        res = None
        for flat_idx in order:
            kc, ka = (int(v) for v in np.unravel_index(int(flat_idx), S.shape))
            if S[kc, ka] < 0.2:
                break
            pr = match_points_across(cur, kc, am.m, ka)
            if int(pr.ok.sum()) < 8:
                continue
            cand = sim3solver.solve_sim3(pr.X1, pr.X2, pr.ok, slam.cam_params, gen, min_inliers=8,
                                         fix_scale=both_metric)
            if not bool(cand.ok):
                continue
            self.grow_searches += 1
            gr = search_by_sim3(cur, kc, am.m, ka, cand.s, cand.R, cand.t, slam.cam_params,
                                slam.width, slam.height, MERGE_RADIUS, "merge")
            ref = sim3solver.refine_sim3(
                gr.X1, gr.X2, gr.ok, slam.cam_params, cand.s, cand.R, cand.t, fix_scale=both_metric,
                min_inliers=15, sigma2_1=gr.sig1, sigma2_2=gr.sig2,
            )
            if bool(ref.ok):
                res = ref
                break
        if res is None:
            return False
        # S21 maps kc's camera frame into ka's. World to world:
        # S_wa<-wc = T_ka_w^-1 S21 T_kc_w (poses camera <- world).
        one = torch.ones((), dtype=cur.kf_t.dtype, device=cur.kf_t.device)
        Rm, tm, sm = lie.sim3_mul(res.R, res.t, res.s, cur.kf_R[kc], cur.kf_t[kc], one)
        Rai, tai, sai = lie.sim3_inv(am.m.kf_R[ka], am.m.kf_t[ka], one)
        Rw, tw, sw = lie.sim3_mul(Rai, tai, sai, Rm, tm, sm)
        merged, n_kf, n_pts = _concat_maps(am.m, am.n_kf, am.n_pts, _transform_map(cur, Rw, tw, sw),
                                           slam.n_kf, slam.n_pts)
        if merged is None:
            return False
        base_kf = am.n_kf
        slam.map = merged
        if inertial:
            # Re-index the per-keyframe IMU blocks: the archived map's keep
            # ids [0, base_kf), the active map's shift to [base_kf, ...).
            acc = np.zeros_like(slam.kf_imu_acc)
            gyro = np.zeros_like(slam.kf_imu_gyro)
            dts = np.zeros_like(slam.kf_imu_dts)
            if am.imu is not None:
                acc[:base_kf] = am.imu["acc"][:base_kf]
                gyro[:base_kf] = am.imu["gyro"][:base_kf]
                dts[:base_kf] = am.imu["dts"][:base_kf]
            new = slice(base_kf, base_kf + slam.n_kf)
            acc[new] = slam.kf_imu_acc[: slam.n_kf]
            gyro[new] = slam.kf_imu_gyro[: slam.n_kf]
            dts[new] = slam.kf_imu_dts[: slam.n_kf]
            slam.kf_imu_acc, slam.kf_imu_gyro, slam.kf_imu_dts = acc, gyro, dts
            old_breaks = am.imu["chain_breaks"] if am.imu else set()
            # the weld seam itself is a break too
            slam.chain_breaks = set(old_breaks) | {base_kf + b for b in slam.chain_breaks} | {base_kf}
            slam.imu_initialized = both_metric
            if not both_metric:
                slam.imu_stage = 0
            _drop_inertial_device_state(slam)
        if slam.loop_closer is not None:
            shift = np.full((slam.K_cap,), -1, np.int64)
            shift[: slam.K_cap - base_kf] = np.arange(base_kf, slam.K_cap)
            slam.loop_closer.remap_slots(shift)
        slam.n_kf = n_kf
        slam.n_pts = n_pts
        # The current pose moves with the map (the transform of one Tcw):
        # R' = R Rw^T, t' = s t - R Rw^T tw; no snap to the last keyframe.
        wbuf = torch.cat([Rw.reshape(9), tw, sw.reshape(1)]).cpu().numpy().astype(np.float64)
        Rwn, twn, swn = wbuf[0:9].reshape(3, 3), wbuf[9:12], float(wbuf[12])
        R_old, t_old = np.asarray(slam.R_cur, np.float64), np.asarray(slam.t_cur, np.float64)
        slam.R_cur = (R_old @ Rwn.T).astype(np.float32)
        slam.t_cur = (swn * t_old - R_old @ Rwn.T @ twn).astype(np.float32)
        slam.vel_R = np.eye(3, dtype=np.float32)
        slam.vel_t = np.zeros(3, np.float32)
        if inertial:
            # the body velocity rotates and scales with the world frame
            slam.v_cur = (swn * Rwn @ np.asarray(slam.v_cur, np.float64)).astype(np.float32)
        slam._ref_cache = None
        del self.maps[archived_idx]
        if both_metric:
            # Welding VI-BA over the seam window: the chain-break mask drops
            # the cross-chain preintegration edge, reprojection edges tie
            # the two sides.
            slam._run_vi_ba(window=slam.W, n_iters=6)
        slam._sync_replica()
        return True


def _drop_inertial_device_state(slam) -> None:
    """The per-frame anchor, its covariance and the chunk loop's inertial
    state describe the map that was active: rebuilt from the host next."""
    slam._vi_anchor = None
    slam._vi_prior = None
    slam._vi_dev_valid = False


def _drop_loop_slots(slam) -> None:
    """Loop edges and a pending hypothesis name keyframe slots of the map
    that was active: dropped with it."""
    if slam.loop_closer is not None:
        slam.loop_closer.remap_slots(np.full((slam.K_cap,), -1, np.int64))


def _transform_map(m: MapState, Rw, tw, sw) -> MapState:
    """A world-to-world Sim(3) X' = sw Rw X + tw applied to every pose and
    point of ``m``: R_cw' = R_cw Rw^T, t_cw' = sw t_cw - R_cw Rw^T tw (the
    camera frame scaled by sw), body velocities v' = sw Rw v, viewing
    normals rotated by Rw and the scale-invariance band scaled by sw."""
    R_t = Rw.T
    return m._replace(
        pt_X=sw * m.pt_X @ R_t + tw,
        kf_R=m.kf_R @ R_t,
        kf_t=sw * m.kf_t - (m.kf_R @ R_t) @ tw,
        kf_v=sw * m.kf_v @ R_t,
        pt_normal=m.pt_normal @ R_t,
        pt_min_dist=sw * m.pt_min_dist,
        pt_max_dist=sw * m.pt_max_dist,
    )


_KF_FIELDS = ("kf_valid", "kf_R", "kf_t", "kf_xy", "kf_level", "kf_angle", "kf_desc_sign",
              "kf_feat_valid", "kf_ts", "kf_ur", "kf_v", "kf_bg", "kf_ba")
_PT_FIELDS = ("pt_valid", "pt_X", "pt_desc_sign", "pt_level", "pt_found", "pt_visible",
              "pt_normal", "pt_min_dist", "pt_max_dist")


def _concat_maps(base: MapState, base_kf: int, base_pts: int,
                 other: MapState, other_kf: int, other_pts: int):
    """Copy ``other``'s first ``other_kf`` keyframes and ``other_pts``
    points into ``base``'s free slots after ``base_kf`` / ``base_pts`` (the
    id remap is one offset). Returns (merged, n_kf, n_pts) in new tensors,
    or (None, 0, 0) when the capacities would overflow."""
    if base_kf + other_kf > base.K or base_pts + other_pts > base.P:
        return None, 0, 0
    m = MapState(*(x.clone() for x in base))
    ks, ps = slice(base_kf, base_kf + other_kf), slice(base_pts, base_pts + other_pts)
    for f in _KF_FIELDS:
        getattr(m, f)[ks] = getattr(other, f)[:other_kf]
    for f in _PT_FIELDS:
        getattr(m, f)[ps] = getattr(other, f)[:other_pts]
    obs = other.kf_obs[:other_kf]
    m.kf_obs[ks] = torch.where(obs >= 0, obs + base_pts, -1)
    m.pt_first_kf[ps] = other.pt_first_kf[:other_pts] + base_kf
    return m, base_kf + other_kf, base_pts + other_pts
