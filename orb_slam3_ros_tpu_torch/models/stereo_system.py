"""Stereo and RGB-D pipelines on top of the monocular system — port of
``orb_slam3_ros_tpu.models.stereo_system``.

Role of the reference's ``System(..., STEREO / RGBD)`` paths:
``Tracking::GrabImageStereo`` / ``GrabImageRGBD`` (Tracking.cc:1480/1553),
``StereoInitialization`` (an instant metric map from depth,
Tracking.cc:2371) and the depth-based point creation of
``CreateNewKeyFrame`` (Tracking.cc:3255). Tracking, BA and loop closing are
``MonoSlam``'s: only the frame's construction and the landmarks' source
differ, and the map is metric from the first frame. Every BA builds the
(u, v, u_r) rows of the keyframes' stereo observations (``bf`` = fx *
baseline, the reference's mbf).

``StereoSlam.process_frames`` runs the steady state in chunks of
[2, H, W] pairs (``device_loop``'s stereo branch, CUDA graphs on the card);
RGB-D runs per frame, as in the JAX package. A frame taken one at a time
runs its front end (both extractions and ``match_stereo``, or the
extraction and the depth map sampled at the features: the JAX package's
jitted ``_extract`` / ``_match_stereo``) as one CUDA graph replay on the
card (``front_end_program``), the tracking after it eagerly. The inertial variants pair
these with ``InertialSlam`` (IMU initialization with the scale held fixed:
depth observes it); the stereo-inertial chunks run ``vi_device_loop``'s
stereo branch.

The stage timer names the JAX package's stages: "extract+stereo" or
"extract+depth", then "track". A keyframe emits a "keyframe" event through
``on_frame``, which the JAX package's stereo keyframe path omits.

Left out, as the JAX package's compile and host helpers: the schedule
warm-up (``_warm_schedules``) and the lag-1 VI chunk drain (ROADMAP "Do not
port"). The two-device split (``devices``) raises ``ValueError`` at
construction: the JAX package's classes raise it at their first tracked
frame, where the stereo refinement reads the canonical map with the
replica's tracking results (ROADMAP "Divergences"). The non-rectified
fisheye rig is ``fisheye_stereo``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import pose_opt, stereo
from . import map_updates
from .front_end_program import FrontEndConfig, FrontEndProgram
from .inertial_system import InertialSlam
from .system import NOT_INITIALIZED, OK, RECENTLY_LOST, SPLIT_REFUSED, MonoSlam


def _stereo_refine(m, feats, feat_pt, ur, R0, t0, cam_params, bf):
    """Re-optimize the tracked pose over mixed mono / stereo (u, v, u_r)
    edges gathered from the tracker's per-feature landmark bindings (the
    stereo branch of PoseOptimization, Optimizer.cc:816). ``ur``: each
    feature's right-image x, -1 where it has none."""
    pt = torch.clamp(feat_pt, 0, m.P - 1).long()
    valid = (feat_pt >= 0) & m.pt_valid[pt] & feats.valid
    inv_sigma2 = 1.2 ** (-2.0 * feats.level.to(torch.float32))
    return pose_opt.pose_optimization_stereo(
        R0, t0, m.pt_X[pt], feats.xy, ur, bf, inv_sigma2, valid, cam_params,
    )


class StereoSlam(MonoSlam):
    """Rectified stereo pipeline: ``MonoSlam``'s arguments plus the rig's
    ``baseline`` (metres) and ``depth_factor_far``: points farther than
    ``depth_factor_far`` * baseline are not created from one view's depth
    (the reference's mThDepth)."""

    def __init__(self, *args, baseline: float = 0.1, depth_factor_far: float = 40.0, **kw):
        if kw.get("devices") is not None:
            raise ValueError(SPLIT_REFUSED.format(type(self).__name__))
        # Its own per-frame flow and keyframe insertion, both synchronous: an
        # explicit pipelined=True changes nothing, as in the JAX package.
        kw.setdefault("pipelined", False)
        super().__init__(*args, **kw)
        self.baseline = baseline
        self.fx = float(self.cam_params[0])  # one read at construction
        self.bf = self.fx * baseline
        self.max_depth = depth_factor_far * baseline
        self._last_depth = None  # the current frame's StereoMatch
        self._front_prog = None  # the front end, made at the first frame

    def _track_post(self, feats, res, ts):
        """Stereo refinement of the visually tracked pose before the
        standard bookkeeping."""
        sm = self._last_depth
        if sm is not None:
            ur = torch.where(sm.valid, sm.u_right, -1.0)
            r2 = _stereo_refine(self.map, feats, res.feat_pt, ur, res.R, res.t,
                                self.cam_params, self.bf)
            res = res._replace(R=r2.R, t=r2.t, n_inliers=r2.n_inliers)
        return super()._track_post(feats, res, ts)

    # ------------------------------------------------------------------
    def _front_end_config(self) -> FrontEndConfig:
        return FrontEndConfig(kind="stereo", config=self.config, height=self.height,
                              width=self.width, cam_params=self.cam_params,
                              cam_model=self.cam_model, fx=self.fx, baseline=self.baseline)

    def _front_end(self) -> FrontEndProgram:
        """The frame's front end (``front_end_program``), made at the first
        frame: on the card one CUDA graph replay a frame."""
        if self._front_prog is None:
            self._front_prog = FrontEndProgram(self._front_end_config(), self.device)
        return self._front_prog

    def process_frame(self, img_left, img_right, ts: float):
        """Process one rectified pair ([H, W] each, numpy or tensors, values
        in [0, 255]). Returns Twc [4, 4] (numpy), or None when tracking is
        lost or the first pair has too little depth."""
        self._check_ts_jump(ts)
        t0 = time.perf_counter()
        fe = self._front_end().run(img_left, img_right)
        feats, sm = fe.feats, fe.sm
        self._last_depth = sm
        t0 = self._tic("extract+stereo", t0)
        if self.state == NOT_INITIALIZED:
            out = self._stereo_initialize(feats, sm, ts)
        elif self.state in (OK, RECENTLY_LOST):
            self._predict_motion(ts)
            out = self._track(feats, ts)
        else:
            out = self._try_relocalize(feats, ts)
        self._tic("track", t0)
        self.frame_id += 1
        return out

    # ------------------------------------------------------------------
    def _depth_candidates(self, sm):
        return sm.valid & (sm.depth > 0) & (sm.depth < self.max_depth)

    def _stereo_initialize(self, feats, sm, ts):
        """Instant metric initialization from the first frame with at least
        100 close depth candidates (StereoInitialization,
        Tracking.cc:2371-2480): keyframe 0 at the identity, its close
        points from depth."""
        cand = self._depth_candidates(sm)
        if int(cand.sum()) < 100:
            return None
        dev = self.device
        self.map = map_updates.insert_keyframe(
            self.map, 0, torch.eye(3, device=dev), torch.zeros(3, device=dev), ts, feats,
            torch.full((self.N,), -1, dtype=torch.int32, device=dev),
            ur=torch.where(sm.valid, sm.u_right, -1.0),
        )
        X_c = stereo.backproject(self.cam_params, feats.xy, sm.depth)
        self.map, n_new = map_updates.admit_depth_points(self.map, 0, X_c, cand, 0, self.P_cap)
        self.map = map_updates.refresh_point_stats(self.map, n_levels=self.config.n_levels)
        self.n_kf = 1
        self.n_pts = int(n_new)
        self.last_kf_frame = self.frame_id
        self.R_cur = np.eye(3, dtype=np.float32)
        self.t_cur = np.zeros(3, np.float32)
        self.state = OK
        self._log_pose(ts)
        return self._pose_mat()

    # ------------------------------------------------------------------
    def _insert_keyframe(self, feats, ts, track_res):
        """A keyframe with its features' u_r; its close points from depth
        in world coordinates, the local BA with (u, v, u_r) rows, point
        culling and statistics, then one host read of (admitted points,
        refined pose) and the loop-closure check."""
        kf_id = self.n_kf
        self._emit_keyframe(ts, kf_id)
        dev = self.device
        sm = self._last_depth
        R = torch.as_tensor(self.R_cur, device=dev)
        t = torch.as_tensor(self.t_cur, device=dev)
        self.map = map_updates.insert_keyframe(
            self.map, kf_id, R, t, ts, feats, track_res.feat_pt,
            ur=torch.where(sm.valid, sm.u_right, -1.0),
        )
        self.n_kf += 1
        self.last_kf_frame = self.frame_id
        X_c = stereo.backproject(self.cam_params, feats.xy, sm.depth)
        self.map, n_new = map_updates.admit_depth_points(
            self.map, kf_id, (X_c - t) @ R, self._depth_candidates(sm), self.n_pts,
            self.P_cap - self.n_pts,
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

    # No _run_local_ba override: stereo keeps the monocular window (the
    # metric gauge needs one fixed keyframe, which it always has), and the
    # chunk gate's check that the local BA is MonoSlam's must hold for the
    # stereo chunk loop to engage.

    # ------------------------------------------------------------------
    # The chunk loop takes [2, H, W] pairs: the step extracts both views
    # and stereo-matches, the keyframe body builds (u, v, u_r) BA rows
    # (device_loop's stereo branch). A frame that runs per frame splits its
    # pair back.
    def _chunk_stereo(self) -> bool:
        return True

    def _fallback_frame(self, img, ts: float):
        return self.process_frame(img[0], img[1], ts)  # a pair, or [2, H, W]

    def process_frames(self, imgs, tss, imgs_right=None):
        """Track a batch of rectified pairs. ``imgs``: ``(stack, off)`` with
        ``stack`` [N, 2, H, W] on the device (uint8 or float32, values in
        [0, 255]) holding the pairs at ``stack[off : off + C]``; a
        [C, 2, H, W] tensor; or a sequence of left frames with
        ``imgs_right`` the right ones. See ``MonoSlam.process_frames``."""
        if imgs_right is not None:
            imgs = [torch.stack([torch.as_tensor(lf), torch.as_tensor(rf)])
                    for lf, rf in zip(imgs, imgs_right)]
        return super().process_frames(imgs, tss)


class StereoInertialSlam(InertialSlam, StereoSlam):
    """Stereo-inertial pipeline (the reference's IMU_STEREO mode).

    Cooperative MRO, as in the JAX package: ``InertialSlam`` supplies the
    IMU ingestion, prediction, staged initialization (with the scale fixed:
    stereo observes it, the reference's stereo IMU init,
    LocalMapping.cc:1181) and the VI keyframe BA; ``StereoSlam`` the
    frame's construction, the instant metric initialization and the
    depth-based landmarks. ``InertialSlam._insert_keyframe``'s ``super()``
    resolves to the stereo keyframe path."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.imu_fix_scale = True

    def process_frame(self, img_left, img_right, ts, acc=None, gyro=None, dts=None):
        """Track one rectified pair with its IMU block (the samples since
        the previous frame; arrays [M, 3] / [M]). Returns Twc or None."""
        self._record_frame_imu(ts, acc, gyro, dts)
        return StereoSlam.process_frame(self, img_left, img_right, ts)

    def _fallback_frame_imu(self, img, ts, acc, gyro, dts):
        return self.process_frame(img[0], img[1], ts, acc=acc, gyro=gyro, dts=dts)


class RgbdSlam(StereoSlam):
    """RGB-D pipeline: depth sampled from the sensor's depth map at the
    features (GrabImageRGBD converts depth to a virtual right coordinate,
    Tracking.cc:1553 + Frame.cc:984; back-projection here skips the
    virtual-disparity detour). ``max_depth``: the far-point cut-off
    (metres); the virtual baseline is 0.05 m."""

    def __init__(self, *args, max_depth: float = 8.0, **kw):
        kw.pop("baseline", None)
        super().__init__(*args, baseline=0.05, **kw)
        self.max_depth = max_depth

    def _front_end_config(self) -> FrontEndConfig:
        return FrontEndConfig(kind="rgbd", config=self.config, height=self.height,
                              width=self.width, cam_params=self.cam_params,
                              cam_model=self.cam_model, bf=self.bf)

    def process_frame(self, img, depth_map, ts: float):
        """Process one frame ([H, W], values in [0, 255]) with its metric
        depth map ([H, W], metres; 0 where the sensor has none). Returns
        Twc [4, 4] or None."""
        self._check_ts_jump(ts)
        t0 = time.perf_counter()
        fe = self._front_end().run(img, depth_map)
        feats, sm = fe.feats, fe.sm
        self._last_depth = sm
        t0 = self._tic("extract+depth", t0)
        if self.state == NOT_INITIALIZED:
            out = self._stereo_initialize(feats, sm, ts)
        elif self.state in (OK, RECENTLY_LOST):
            out = self._track(feats, ts)
        else:
            out = self._try_relocalize(feats, ts)
        self._tic("track", t0)
        self.frame_id += 1
        return out

    # Per frame only: the float depth maps do not ride the frame stack.
    def _chunk_stereo(self) -> bool:
        return False

    def _fallback_frame(self, img, ts: float):
        raise ValueError("RgbdSlam takes frames with their depth maps through process_frame")


class RgbdInertialSlam(InertialSlam, RgbdSlam):
    """RGB-D-inertial pipeline, the reference's IMU_RGBD mode
    (src/ros_rgbd_inertial.cc): ``InertialSlam``'s IMU side (scale held
    fixed: depth observes it) with ``RgbdSlam``'s frames, initialization
    and landmarks, in the JAX package's MRO."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.imu_fix_scale = True

    def process_frame(self, img, depth_map, ts, acc=None, gyro=None, dts=None):
        """Track one frame and its depth map with its IMU block. Returns
        Twc or None."""
        self._record_frame_imu(ts, acc, gyro, dts)
        return RgbdSlam.process_frame(self, img, depth_map, ts)

    def _fallback_frame_imu(self, img, ts, acc, gyro, dts):
        return RgbdSlam._fallback_frame(self, img, ts)
