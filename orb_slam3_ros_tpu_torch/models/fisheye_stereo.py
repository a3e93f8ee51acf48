"""Two-camera (non-rectified, fisheye) stereo pipelines — port of
``orb_slam3_ros_tpu.models.fisheye_stereo``.

Role of the reference's two-camera machinery: the ``Frame`` two-camera
constructor with the left-to-right extrinsic ``Tlr`` (Frame.h:346),
``ComputeStereoFishEyeMatches`` (Frame.cc:1126-1227: a brute-force
descriptor match between the views, DLT triangulation and reprojection
gates, no rectified row search) and ``EdgeSE3ProjectXYZToBody``
(OptimizableTypes.h:118-196), by which right-camera observations constrain
the left camera's pose through the fixed Tlr: the TUM-VI stereo(-inertial)
configuration (Examples/Stereo-Inertial/TUM-VI.yaml).

A frame extracts both views and cross-matches them
(``twocam.triangulate_cross_camera``); tracking is ``MonoSlam``'s, then the
pose is refined over a table of mixed left / right rows
(``twocam.pose_optimization_two_cam``). Metric scale comes from the
cross-camera triangulation: the map starts metric at the first frame with
60 cross points, and every keyframe admits its cross points as landmarks.
The cross points' depths also become a ``StereoMatch`` with a virtual u_r
= u - bf / z (the RGB-D mechanism, Frame.cc:984), which the keyframes and
the inertial keyframe work read; under KB8 every BA and VI-BA zeroes the
u_r rows (the relation u_r = u - bf / z holds only for a rectified pair;
the JAX package's VI-BA keeps them, projected through the pinhole model:
ROADMAP "Known faults"), so the right view constrains the map through the
cross-camera landmarks and the two-camera pose refinement.

Frames run one at a time, as RGB-D's do (the chunk gate does not admit a
system with bf > 0 and no stereo chunk branch): a frame's front end (both
extractions, the cross match and the virtual ``StereoMatch``, the JAX
package's ``_frame_program``) is one CUDA graph replay on the card
(``front_end_program``, "rig"), then its tracking and the two-camera
refinement (the JAX package's ``track_against_map`` and ``_twocam_refine``
jits) one more (``track_program``, kind "rig"; "vi" once the inertial rig's
IMU is initialized), with one host read;
``process_frames`` of [N, 2, H, W] pairs splits each pair into
``process_frame``. The stage timer names "extract+cross" and "track", the
JAX package's; a keyframe emits a "keyframe" event, which the JAX
package's rig omits. ``devices`` raises ``ValueError``, as in
``stereo_system``. Left out, as in the other ported systems: the JAX
package's lag-1 VI chunk plumbing
(``_drain_vi_chunk``, ``_vi_dev_state``; ROADMAP "Do not port") and its
asynchronous keyframe apply (``_apply_kf_async``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import twocam
from . import map_updates
from .front_end_program import FrontEndConfig, FrontEndProgram
from .inertial_system import InertialSlam
from .system import NOT_INITIALIZED, OK, RECENTLY_LOST, SPLIT_REFUSED, MonoSlam


def _twocam_refine(m, feats, feat_pt, cross_ok, uv_right, R0, t0, R_rl, t_rl, cam_params,
                   cam_model):
    """Mixed left / right motion-only refinement: every tracked landmark
    gives its left reprojection row; one whose left feature also
    cross-matched gives the right view's row through Tlr
    (EdgeSE3ProjectXYZToBody), at the left feature's pyramid level. One
    table of 2N rows. Run inside the tracking program (``track_program``,
    kind "rig")."""
    N = feats.xy.shape[0]
    pt = torch.clamp(feat_pt, 0, m.P - 1).long()
    bound = (feat_pt >= 0) & m.pt_valid[pt] & feats.valid
    Xw = m.pt_X[pt]
    inv_s2 = 1.2 ** (-2.0 * feats.level.to(torch.float32))
    is_right = torch.arange(2 * N, device=Xw.device) >= N
    return twocam.pose_optimization_two_cam(
        R0, t0, torch.cat([Xw, Xw]), torch.cat([feats.xy, uv_right]), is_right, R_rl, t_rl,
        torch.cat([inv_s2, inv_s2]), torch.cat([bound, bound & cross_ok]), cam_params,
        cam_model=cam_model,
    )


class FisheyeStereoSlam(MonoSlam):
    """Non-rectified two-camera pipeline: ``MonoSlam``'s arguments (the
    camera defaults to "kb8"; both views share the intrinsics) plus the
    left-to-right extrinsic X_r = R_rl X_l + t_rl (``R_rl`` [3, 3], ``t_rl``
    [3]; identity and zero by default)."""

    TRACK_KIND = "rig"

    def __init__(self, *args, R_rl=None, t_rl=None, **kw):
        if kw.get("devices") is not None:
            raise ValueError(SPLIT_REFUSED.format(type(self).__name__))
        kw.setdefault("cam_model", "kb8")
        # Its own per-frame flow and keyframe insertion, both synchronous: an
        # explicit pipelined=True changes nothing, as in the JAX package.
        kw.setdefault("pipelined", False)
        super().__init__(*args, **kw)
        R_rl = np.eye(3, dtype=np.float32) if R_rl is None else np.asarray(R_rl, np.float32)
        t_rl = np.zeros(3, np.float32) if t_rl is None else np.asarray(t_rl, np.float32)
        self.R_rl = torch.as_tensor(R_rl, device=self.device)
        self.t_rl = torch.as_tensor(t_rl, device=self.device)
        self.baseline = float(np.linalg.norm(t_rl))
        # A gross-outlier depth gate only: a cap inside the scene's depth
        # range truncates the noisy cross-camera depths and the map comes
        # out too shallow (the JAX package measured 15-25% with 40x).
        self.max_depth = 80.0 * max(self.baseline, 1e-6)
        self.bf = float(self.cam_params[0]) * self.baseline  # one read at construction
        self._last_cross = None  # the frame's CrossCamTriangulation
        self._last_depth = None  # the cross match as a StereoMatch (virtual u_r)
        self._front_prog = None  # the front end (``front_end_program``), made at the first frame

    def process_frame(self, img_left, img_right, ts: float):
        """Process one pair of raw frames ([H, W] each, numpy or tensors,
        values in [0, 255]). Returns Twc [4, 4] (numpy), or None while
        initializing or when tracking is lost."""
        self._check_ts_jump(ts)
        t0 = time.perf_counter()
        if self._front_prog is None:
            self._front_prog = FrontEndProgram(FrontEndConfig(
                kind="rig", config=self.config, height=self.height, width=self.width,
                cam_params=self.cam_params, cam_model=self.cam_model, bf=self.bf,
                max_depth=self.max_depth, R_rl=self.R_rl, t_rl=self.t_rl,
            ), self.device)
        fe = self._front_prog.run(img_left, img_right)
        feats, cross = fe.feats, fe.cross
        self._last_cross = cross
        self._last_depth = fe.sm
        t0 = self._tic("extract+cross", t0)
        if self.state == NOT_INITIALIZED:
            out = self._fisheye_initialize(feats, cross, ts)
        elif self.state in (OK, RECENTLY_LOST):
            out = self._track(fe, ts, predict=True)
        else:
            out = self._try_relocalize(feats, ts)
        self._tic("track", t0)
        self.frame_id += 1
        return out

    def _fallback_frame(self, img, ts: float):
        """A frame of ``process_frames``: a [2, H, W] pair split into its
        views. The rig has no chunk program (``_chunkable`` fails on its
        ``bf`` > 0 without a stereo chunk branch), so every frame of
        ``process_frames`` comes here."""
        return self.process_frame(img[0], img[1], ts)

    def _virtual_ur(self, feats, cross, cand):
        z = torch.clamp(cross.X_l[:, 2], min=1e-3)
        return torch.where(cand, feats.xy[:, 0] - self.bf / z, -1.0)

    def _cross_candidates(self, cross):
        return cross.ok & (cross.X_l[:, 2] < self.max_depth)

    # ------------------------------------------------------------------
    def _fisheye_initialize(self, feats, cross, ts):
        """Instant metric initialization from the first frame with at least
        60 cross-camera points: keyframe 0 at the identity, its landmarks
        the triangulated points."""
        if int(cross.n_new) < 60:
            return None
        dev = self.device
        cand = self._cross_candidates(cross)
        self.map = map_updates.insert_keyframe(
            self.map, 0, torch.eye(3, device=dev), torch.zeros(3, device=dev), ts, feats,
            torch.full((self.N,), -1, dtype=torch.int32, device=dev),
            ur=self._virtual_ur(feats, cross, cand),
        )
        self.map, n_new = map_updates.admit_depth_points(self.map, 0, cross.X_l, cand, 0,
                                                         self.P_cap)
        self.map = map_updates.refresh_point_stats(self.map, n_levels=self.config.n_levels)
        self.n_kf = 1
        self.n_pts = int(n_new)
        self.last_kf_frame = self.frame_id
        self.R_cur = np.eye(3, dtype=np.float32)
        self.t_cur = np.zeros(3, np.float32)
        self.state = OK
        self._log_pose(ts)
        return self._pose_mat()

    def _track_config(self):
        return super()._track_config()._replace(R_rl=self.R_rl, t_rl=self.t_rl)

    def _insert_keyframe(self, feats, ts, track_res):
        """A keyframe with its virtual u_r; its cross-camera points into
        the map as metric landmarks (left-camera points taken to the world
        by the tracked pose), the local BA, point culling and statistics,
        then one host read of (admitted points, refined pose)."""
        self.abort_gba()
        kf_id = self.n_kf
        self._emit_keyframe(ts, kf_id)
        dev = self.device
        cross = self._last_cross
        cand = self._cross_candidates(cross)
        R = torch.as_tensor(self.R_cur, device=dev)
        t = torch.as_tensor(self.t_cur, device=dev)
        self.map = map_updates.insert_keyframe(
            self.map, kf_id, R, t, ts, feats, track_res.feat_pt,
            ur=self._virtual_ur(feats, cross, cand),
        )
        self.n_kf += 1
        self.last_kf_frame = self.frame_id
        self.map, n_new = map_updates.admit_depth_points(
            self.map, kf_id, (cross.X_l - t) @ R, cand, self.n_pts, self.P_cap - self.n_pts,
        )
        self._run_local_ba(n_iters=self.local_ba_iters)
        self.map = map_updates.cull_points(self.map, self.n_kf)
        self.map = map_updates.refresh_point_stats(self.map, n_levels=self.config.n_levels)
        buf = torch.cat([
            n_new.to(torch.float32).reshape(1), self.map.kf_R[kf_id].reshape(9),
            self.map.kf_t[kf_id],
        ]).cpu().numpy()
        self.n_pts += int(buf[0])
        self.R_cur = buf[1:10].reshape(3, 3).copy()
        self.t_cur = buf[10:13].copy()
        self._close_loop(kf_id)
        self._set_ref_cache(self.n_kf - 1, self.R_cur, self.t_cur)


class FisheyeStereoInertialSlam(InertialSlam, FisheyeStereoSlam):
    """Two-camera rig with an IMU, the TUM-VI stereo-inertial configuration,
    in the JAX package's MRO: ``InertialSlam`` supplies the IMU ingestion,
    prediction, staged initialization (with the scale fixed: the
    cross-camera triangulation observes it) and the VI keyframe BA;
    ``FisheyeStereoSlam`` the two-camera frames, the instant metric
    initialization and the cross-camera landmarks. It runs at
    ``FisheyeStereoSlam``'s default camera, KB8, whose model reaches the
    15-dof refinement and every VI-BA (``InertialSlam``); ``cam_model=
    "pinhole"`` gives the JAX package's tested configuration."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.imu_fix_scale = True

    def process_frame(self, img_left, img_right, ts, acc=None, gyro=None, dts=None):
        """Track one pair with its IMU block (the samples since the previous
        frame; arrays [M, 3] / [M]). Returns Twc or None."""
        self._record_frame_imu(ts, acc, gyro, dts)
        return FisheyeStereoSlam.process_frame(self, img_left, img_right, ts)

    def _fallback_frame_imu(self, img, ts, acc, gyro, dts):
        """A frame of ``process_frames`` with its IMU block: the pair split
        (no VI chunk either: ``_vi_chunkable`` fails on ``bf`` > 0)."""
        return self.process_frame(img[0], img[1], ts, acc=acc, gyro=gyro, dts=dts)
