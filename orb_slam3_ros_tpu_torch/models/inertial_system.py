"""Monocular-inertial pipeline — port of
``orb_slam3_ros_tpu.models.inertial_system.InertialSlam`` (the reference's
``System(..., IMU_MONOCULAR)``: ``Tracking::PreintegrateIMU`` /
``PredictStateIMU``, the staged ``LocalMapping::InitializeIMU`` and
``LocalInertialBA`` per keyframe).

Flow: run visually until ``init_after_kf`` keyframes accumulate, then
solve gravity / scale / biases / velocities over the keyframe chain
(``viba.inertial_init``), gravity-align and rescale the map, and from then
on predict each frame's pose from the IMU, refine its 15-dof body state
against the map and the preintegration factor, and refine keyframes with
the temporal-window visual-inertial BA. Two more initialization stages
follow at +4 and +8 keyframes with weakening bias priors.

A VI frame runs one frame behind, as in the JAX package
(``_process_frame_vi``): ``process_frame`` first drains the frame before it
(``_drain_vi_pending``: the packed (inliers, pose, v, bg, ba) it copied to
the host, the state ladder, the keyframe decision and any keyframe's work,
at that frame's own id), then dispatches this frame with no host read
(``vi_frame_program``: preintegration at the anchor's bias, the IMU
prediction, extraction, tracking and the 15-dof refinement, on the card one
CUDA graph replay) and returns the previous frame's pose: None at the first
VI frame after a visual one. The anchor state and its covariance stay on
the device from frame to frame. A keyframe runs as the VI keyframe
program (``vi_kf_program``: insert + admit, fuse, BA + point cull, stats,
keyframe cull, end, on the card replays of its region graphs, captured at
the first VI keyframe; the eager ``_vi_kf_work`` is the plain function it
is held to) and costs one more host read, an initialization stage one for
its solve and one for the state after its BA.
The frame in flight is drained by ``flush`` (and so by ``get_trajectory``,
a timestamp jump, compaction (``_make_room``), an Atlas archive, checkpoint
saves, the control socket's ``save_map`` / ``save_traj``), by
``process_frames`` before its chunk gate and by a frame that does not take
the VI path; relocalization runs only once a drain has left tracking
LOST.

``pipelined`` (default False, the JAX package's): with True, the visual
frames before the IMU initializes go through ``MonoSlam``'s pipelined frame
(the frame graph and the deferred keyframe work; an initialization stage
absorbs the deferred keyframe first). The frame in flight when a drain
initializes the IMU was tracked against the map before its rescale: the
next VI frame re-runs it through the VI frame program from the IMU
prediction and posts it first (``_drain_pending``), so every dispatched
frame is posted once, in frame order (the JAX package leaves it until
``flush``: ROADMAP "Known faults in the reference"). The stereo, RGB-D and
two-camera inertial systems keep their own synchronous frame.

``process_frames`` runs the steady state in chunks (``vi_device_loop``): on
the card each frame is one replay of a captured CUDA graph of the frame
step, each keyframe a few replays of the keyframe body's graphs, with a
two-word host read a frame and one read a chunk; frames outside the steady
state go through ``process_frame`` one at a time, as in the JAX package.

Once ``time_recently_lost`` has passed, tracking is LOST and each frame
tries to relocalize through ``MonoSlam``'s path (``_try_relocalize``); the
first frame after a recovery rebuilds the inertial anchor from the host's
pose, velocity and biases.

With ``enable_loop_closing`` the closer checks each new keyframe (per
keyframe, or over a chunk's new keyframes at its boundary); on an
initialized map it solves the Sim(3) with the scale fixed and corrects
through the 4-dof essential graph, and the asynchronous global BA is the
full inertial BA over every keyframe (``viba.vi_bundle_adjust`` on a cloned
snapshot, two LM iterations a dispatch with the damping carried between
them, folded in by ``apply_vi_gba_partial``). A correction or a fold-in
moves keyframe poses and velocities, so the chunk's inertial state is
rebuilt from the host at the next chunk, and the end-of-chunk pose rides
the correction of the newest keyframe.

With ``enable_atlas`` (``MonoSlam``'s Atlas) an archived map keeps its IMU
blocks, flags and chain breaks; a switch into it breaks the chain at its
next keyframe, and a weld re-indexes the blocks, makes the seam a chain
break and, with both maps initialized, is rigid and followed by a welding
VI-BA. At a chunk boundary a weld rebuilds the chunk's inertial state and
takes the newest keyframe's state.

The stereo- and RGB-D-inertial systems (``stereo_system``) build on this
class: their keyframes carry u_r and create close landmarks from depth
(the keyframe program's depth variant), every VI-BA builds (u, v, u_r)
rows with ``bf``, their frames are tracked by the tracking program
(``track_program``) and refined by its "vi" kind once the IMU is
initialized (``_track``: the IMU prediction on the device from the host's
state, tracking, the preintegration at the anchor's bias and the 15-dof
refinement, monocular; the stereo or two-camera refinement before), and the
stereo-inertial chunks take [2, H, W] pairs.

The ``on_frame`` events are ``MonoSlam``'s: a VI frame emits "frame" (no
point-cloud events, as in the JAX package), a VI keyframe "keyframe", a
chunk both from its rows and the point-cloud events at its boundary. A
bad-IMU reset is logged at ``obslog.NORMAL``.

With ``devices`` (``MonoSlam``'s two-device split) a VI frame's
preintegration, prediction, extraction, tracking and 15-dof refinement run
on the track device against the map replica; keyframes, the IMU
initialization stages and the global BA run on the map device, and the
replica is refreshed after each keyframe and at once after an
initialization stage, a fold-in or a reset. No VI chunk runs while split.

``cam_model="kb8"`` runs the whole pipeline on raw fisheye frames: the
camera model reaches VI tracking, the 15-dof refinement
(``viba.pose_inertial_optimization``), the keyframe's triangulation and
fusion, every VI-BA (the temporal window, the initialization stages' full
inertial BAs, the global BA, the Atlas's welding BA: ``viba``'s
``cam_model``) and the VI chunk's graphs
(``VIChunkConfig.cam_model``). The JAX package threads the camera into VI
tracking but projects every VI-BA row and the 15-dof refinement's rows
through the pinhole model whatever the camera (ROADMAP "Known faults");
the port projects them through the system's camera.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import imu as imu_ops
from ..ops import viba
from ..utils import obslog
from . import local_mapping, map_state, map_updates, vi_device_loop
from .chunk_runner import admit_keyframe_points, read_host, read_rows
from .system import LOST, NOT_INITIALIZED, OK, RECENTLY_LOST, MonoSlam
from .track_program import pack_x
from .vi_frame_program import VIFrameConfig, VIFrameProgram
from .vi_kf_program import KFInputs, VIKeyframeProgram


def _vi_kf_work(
    m, kf_id, R, t, ts, feats, feat_pt, n_pts, free_cap, vb_new,
    window_ids, fixed, imu_blocks, edge_ok, calib, cam_params,
    *, width, height, fuse_neighbors, do_fuse, do_stats, do_cull, n_iters, n_levels,
    bf=0.0, ur=None, depth=None, max_depth=0.0, cam_model="pinhole",
):
    """One VI keyframe's mapping work (LocalMapping::Run with
    LocalInertialBA), the plain function the keyframe program
    (``vi_kf_program``) is held to: insert -> record body state ->
    triangulate -> admit -> fuse -> temporal-window VI-BA -> culls. ``vb_new`` [9]: the new
    keyframe's (v, bg, ba); ``imu_blocks`` [W-1, S, 7]: per-edge IMU blocks
    (acc | gyro | dt). A stereo or RGB-D keyframe passes its features'
    ``ur`` and ``depth`` (-1 where none): it creates the close landmarks
    (depth under ``max_depth``) from depth before triangulating far ones
    (Tracking.cc:3255), and its VI-BA builds (u, v, u_r) rows with ``bf``.
    Returns (map, n_new_points as a 0-d tensor)."""
    m = map_updates.insert_keyframe(m, kf_id, R, t, ts, feats, feat_pt, ur=ur)
    m.kf_v[kf_id] = vb_new[0:3]
    m.kf_bg[kf_id] = vb_new[3:6]
    m.kf_ba[kf_id] = vb_new[6:9]
    m, n_new = admit_keyframe_points(m, kf_id, R, t, feats.xy, feats.valid, depth, n_pts,
                                     free_cap, cam_params, max_depth, cam_model)
    if do_fuse:
        m, _ = map_updates.fuse_in_neighbors(
            m, kf_id, cam_params, width, height, n_neighbors=fuse_neighbors,
            cam_model=cam_model,
        )
    prob = local_mapping.build_vi_ba(
        m, window_ids, fixed, imu_blocks[..., 0:3], imu_blocks[..., 3:6], imu_blocks[..., 6],
        edge_ok, calib, cam_params, bf=bf,
    )
    res = viba.vi_bundle_adjust(prob, n_iters=n_iters, cam_model=cam_model)
    m = local_mapping.apply_vi_ba(m, window_ids, res, calib)
    m = map_updates.cull_points(m, kf_id + 1)
    if do_stats:
        m = map_updates.refresh_point_stats(m, n_levels=n_levels)
    if do_cull:
        m, _ = map_updates.cull_keyframes(m, kf_id + 1, n_levels=n_levels)
    return m, n_new


def _pack_kf_state(m, kf: int) -> torch.Tensor:
    """[21] f32: (v, bg, ba, R(9), t) of keyframe ``kf``, for one host read."""
    return torch.cat([m.kf_v[kf], m.kf_bg[kf], m.kf_ba[kf], m.kf_R[kf].reshape(9), m.kf_t[kf]])


def _vi_refine(
    m, feats, feat_pt, R_cw0, t_cw0, v0, bg0, ba0,
    R_anc, p_anc, v_anc, bg_anc, ba_anc, pre, anc_Sigma, cam_params, R_bc, t_bc,
    cam_model="pinhole",
):
    """Gather the tracker's per-feature landmark bindings into visual edges
    and run the 15-dof VI motion-only solve (the per-frame
    PoseInertialOptimizationLast* stage) under ``cam_model``.
    ``anc_Sigma``: the anchor state's posterior covariance (zeros = exact
    anchor)."""
    pt = torch.clamp(feat_pt, 0, m.P - 1).long()
    valid = (feat_pt >= 0) & m.pt_valid[pt] & feats.valid
    inv_sigma2 = 1.2 ** (-2.0 * feats.level.to(torch.float32))
    R_wb0, p_wb0 = viba.body_from_cam(R_cw0, t_cw0, R_bc, t_bc)
    res = viba.pose_inertial_optimization(
        R_wb0, p_wb0, v0, bg0, ba0, m.pt_X[pt], feats.xy, inv_sigma2, valid,
        R_anc, p_anc, v_anc, bg_anc, ba_anc, pre, anc_Sigma, cam_params, R_bc, t_bc,
        cam_model=cam_model,
    )
    R_cw, t_cw = viba.cam_from_body(res.R_wb, res.p_wb, R_bc, t_bc)
    return res, R_cw, t_cw


class InertialSlam(MonoSlam):
    """Monocular-inertial pipeline: the JAX package's constructor arguments
    and defaults plus ``device`` (see ``MonoSlam``). ``calib``: an
    ``ImuCalib`` of tensors or numpy arrays."""

    def __init__(
        self,
        *args,
        calib: imu_ops.ImuCalib,
        imu_cap_frame: int = 32,
        imu_cap_kf: int = 256,
        init_after_kf: int = 6,
        time_recently_lost: float = 5.0,
        vi_tracking: bool = True,
        **kw,
    ):
        # The JAX package's default (its IMU prediction is host-driven); True
        # pipelines the visual frames before the IMU's initialization.
        kw.setdefault("pipelined", False)
        super().__init__(*args, **kw)
        # The VI frame in flight (a dict: its VIFrameOut, ts, frame id) and
        # the VI frame program, made at the first VI frame; with counts of
        # the VI dispatches, the drains and the drains whose copy had landed.
        self._vi_pending = None
        self._vi_prog = None
        # The VI keyframe program (its buffers hold the map after a keyframe),
        # made at the first VI keyframe.
        self._vi_kf_prog = None
        self.pipe_counts.update(vi_dispatches=0, vi_drains=0, vi_ready=0)
        # Per-frame VI motion-only optimization once the IMU is initialized
        # and the RECENTLY_LOST dead-reckoning window it enables.
        self.vi_tracking = vi_tracking
        self.time_recently_lost = time_recently_lost
        self._lost_since_ts = None
        self._vi_anchor = None  # (R_wb, p_wb, v, bg, ba) on the device
        self._vi_prior = None  # [15,15] anchor posterior cov on the device
        self.calib = imu_ops.ImuCalib(*(
            torch.as_tensor(np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x, np.float32))
            .to(self.device) for x in calib
        ))
        # the calibration where a frame is tracked (the track device when split)
        self._tcalib = imu_ops.ImuCalib(*(x.to(self.track_device) for x in self.calib))
        self.imu_cap_frame = imu_cap_frame
        self.imu_cap_kf = imu_cap_kf
        self.init_after_kf = init_after_kf
        self.imu_initialized = False
        self.imu_fix_scale = False  # stereo / RGB-D: scale observable
        self.imu_stage = 0  # initialization stages done (0..3)
        self.init_stage_ms = {}  # stage -> wall ms of its solve, for profiling
        # per-keyframe IMU blocks on the host: block k integrates KF k-1 -> KF k
        self.kf_imu_acc = np.zeros((self.K_cap, imu_cap_kf, 3), np.float32)
        self.kf_imu_gyro = np.zeros((self.K_cap, imu_cap_kf, 3), np.float32)
        self.kf_imu_dts = np.zeros((self.K_cap, imu_cap_kf), np.float32)
        # per-frame IMU history: (frame_ts, acc, gyro, dts); a frame's block
        # covers (prev_frame_ts, frame_ts]. Keyframe blocks are assembled
        # from it, so keyframes created in retrospect (the two-view
        # initialization) get the right integration intervals.
        self._imu_history = []
        self._frame_imu = (None, None, None)
        self._last_kf_ts = None
        # host copies of the current body state (world frame)
        self.v_cur = np.zeros(3, np.float32)
        self.bg_cur = np.zeros(3, np.float32)
        self.ba_cur = np.zeros(3, np.float32)
        # Keyframe ids whose IMU chain to the previous keyframe is broken (a
        # merged block overflowed its capacity at compaction); VI-BA windows
        # mask the inertial edge into them.
        self.chain_breaks: set = set()
        # A divergent IMU solve resets the active map (mbBadImu).
        self.bad_imu_resets = 0
        # The chunk loop's runner (its buffers and graphs), made at the first
        # chunk; its inertial state stays valid from one chunk to the next
        # until per-frame processing or a map rewrite intervenes.
        self._vi_runner = None
        self._vi_dev_valid = False

    # ------------------------------------------------------------------
    def _check_bad_imu(self) -> bool:
        """Detect a divergent inertial solve from the host state just read
        (non-finite, or a physically impossible velocity / bias) and reset
        the active map. Returns True if a reset happened."""
        bad = (
            not np.all(np.isfinite(self.v_cur))
            or not np.all(np.isfinite(self.bg_cur))
            or not np.all(np.isfinite(self.ba_cur))
            or not np.all(np.isfinite(self.t_cur))
            or float(np.linalg.norm(self.v_cur)) > 50.0
            or float(np.linalg.norm(self.bg_cur)) > 2.0
            or float(np.linalg.norm(self.ba_cur)) > 20.0
        )
        if not bad:
            return False
        self.bad_imu_resets += 1
        obslog.log(
            f"bad IMU solve (v={self.v_cur}, bg={self.bg_cur}, "
            f"ba={self.ba_cur}) — resetting active map", obslog.NORMAL,
        )
        self._reset_active_map()
        return True

    def _reset_active_map(self):
        """ResetActiveMap: a fresh empty map and cleared IMU state."""
        self.kf_imu_acc[:] = 0
        self.kf_imu_gyro[:] = 0
        self.kf_imu_dts[:] = 0
        self.imu_initialized = False
        self.imu_stage = 0
        self.chain_breaks = set()
        self.v_cur = np.zeros(3, np.float32)
        self.bg_cur = np.zeros(3, np.float32)
        self.ba_cur = np.zeros(3, np.float32)
        self._vi_anchor = None
        self._vi_prior = None
        self._last_kf_ts = None
        self.map = map_state.empty_map(self.K_cap, self.N, self.P_cap, device=self.device)
        self._sync_replica()
        self.n_kf = 0
        self.n_pts = 0
        self.init_feats = None
        self.R_cur = np.eye(3, dtype=np.float32)
        self.t_cur = np.zeros(3, np.float32)
        self.vel_R = np.eye(3, dtype=np.float32)
        self.vel_t = np.zeros(3, np.float32)
        self.state = NOT_INITIALIZED
        self._ref_cache = None
        self._vi_dev_valid = False

    # ------------------------------------------------------------------
    # The chunked, abortable full inertial BA (the reference's
    # RunGlobalBundleAdjustment calls FullInertialBA on an inertial map,
    # LoopClosing.cc:3611-3620, with the same mbStopGBA flag).
    def _start_async_gba(self, n_iters: int, n_cg: int = 50, chunk: int = 2) -> None:
        """The visual global BA before the IMU is initialized; after it, the
        full inertial BA over every keyframe on a clone of the map (see
        ``MonoSlam._start_async_gba``), a previous solve stopped and folded
        in first."""
        if not self.imu_initialized:
            return super()._start_async_gba(n_iters, n_cg=n_cg, chunk=chunk)
        if self._gba is not None:
            self.abort_gba()
            while self._gba is not None:
                self._poll_gba(force=True)
        built = self._build_vi_window_problem(self.n_kf)
        if built is None:
            return
        prob, window_ids = built
        prob = prob._replace(states=viba.VIStates(*(x.clone() for x in prob.states)),
                             X=prob.X.clone(), uv=prob.uv.clone(), pt_valid=prob.pt_valid.clone())
        self._gba = dict(kind="vi", prob=prob, window_ids=window_ids, done=0, target=n_iters,
                         chunk=chunk, lam=torch.full((), 1e-3, device=self.device),
                         n_kf0=self.n_kf, res=None, abort=False, obs0=self.map.kf_obs.clone())
        self.gba_counts["started"] += 1
        self._dispatch_gba_chunk()

    def _dispatch_gba_chunk(self) -> None:
        g = self._gba
        if g.get("kind") != "vi":
            return super()._dispatch_gba_chunk()
        it = min(g["chunk"], g["target"] - g["done"])
        res = viba.vi_bundle_adjust(g["prob"], n_iters=it, lam0=g["lam"],
                                    cam_model=self.cam_model)
        g["prob"] = g["prob"]._replace(states=res.states, X=res.X)
        g["lam"] = res.lam
        g["res"] = res
        g["done"] += it
        self._gba_mark(g)

    def _finish_gba(self) -> None:
        """Fold in the solve; its correction of the last keyframe it saw
        also moves the tracker's pose and velocity (the keyframes made
        during the solve ride it too), and the chunk's inertial state and
        the per-frame anchor are rebuilt from the host."""
        g = self._gba
        if g.get("kind") != "vi":
            super()._finish_gba()
        else:
            self._gba = None
            r = g["n_kf0"] - 1
            pre = torch.cat([self.map.kf_R[r].reshape(9), self.map.kf_t[r]])
            self.map = local_mapping.apply_vi_gba_partial(
                self.map, g["window_ids"], g["res"], self.calib, g["n_kf0"], kf_obs0=g["obs0"]
            )
            self.map = map_updates.refresh_point_stats(self.map, n_levels=self.config.n_levels)
            pre, post = read_host(pre, torch.cat([self.map.kf_R[r].reshape(9), self.map.kf_t[r]]))
            Rr_o, tr_o, Rr_n, tr_n = pre[:9].reshape(3, 3), pre[9:], post[:9].reshape(3, 3), post[9:]
            # Tcw_cur' = (Tcw_cur Twc_r_old) Tcw_r_new
            R_cr = self.R_cur @ Rr_o.T
            t_cr = self.t_cur - R_cr @ tr_o
            self.R_cur = (R_cr @ Rr_n).astype(np.float32)
            self.t_cur = (R_cr @ tr_n + t_cr).astype(np.float32)
            self.v_cur = ((Rr_n.T @ Rr_o) @ self.v_cur).astype(np.float32)
            self._ref_cache = None
            self.gba_counts["finished"] += 1
            self._sync_replica()
        self._vi_dev_valid = False
        self._vi_anchor = None
        self._vi_prior = None
        if g.get("kind") == "vi":
            self._check_bad_imu()

    def process_frame(self, img, ts: float, acc=None, gyro=None, dts=None):
        """Track one frame with its IMU block (the samples since the
        previous frame; arrays [M, 3] / [M]). Returns Twc [4, 4] or None;
        on the VI path the previous frame's (module docstring)."""
        self._poll_replica()
        has_imu = self._record_frame_imu(ts, acc, gyro, dts)
        if self.imu_initialized and self.vi_tracking and has_imu and self.state in (OK, RECENTLY_LOST):
            if self._pending is not None:
                self._drain_pending()  # a visual frame in flight is posted first
            self._check_ts_jump(ts)
            if self.state in (OK, RECENTLY_LOST):
                return self._process_frame_vi(img, ts)
        self._drain_vi_pending()
        return super().process_frame(img, ts)

    def _fallback_frame_imu(self, img, ts, acc, gyro, dts):
        """One frame of a chunk that runs per frame, with its IMU block:
        ``process_frame``; the stereo-inertial system splits its [2, H, W]
        pair here."""
        return self.process_frame(img, ts, acc=acc, gyro=gyro, dts=dts)

    def _record_frame_imu(self, ts, acc, gyro, dts) -> bool:
        """Append a frame's IMU block to the history and make it the
        frame's; per-frame processing changes host state the chunk's
        inertial state does not see, so the next chunk rebuilds it.
        Returns whether the frame has samples."""
        self._vi_dev_valid = False
        has_imu = acc is not None and len(acc) > 0
        if has_imu:
            self._imu_history.append((
                ts, np.asarray(acc, np.float32), np.asarray(gyro, np.float32),
                np.asarray(dts, np.float32),
            ))
            if len(self._imu_history) > 200:
                self._imu_history.pop(0)
        self._frame_imu = (acc, gyro, dts) if has_imu else (None, None, None)
        return has_imu

    def _collect_block(self, t0: float, t1: float):
        """Concatenate the IMU samples of frames with ts in (t0, t1] into a
        fixed-capacity block; samples beyond ``imu_cap_kf`` are dropped."""
        a = np.zeros((self.imu_cap_kf, 3), np.float32)
        g = np.zeros((self.imu_cap_kf, 3), np.float32)
        d = np.zeros((self.imu_cap_kf,), np.float32)
        n = 0
        for fts, fa, fg, fd in self._imu_history:
            if t0 < fts <= t1 + 1e-9:
                m = min(len(fa), self.imu_cap_kf - n)
                if m <= 0:
                    break
                a[n : n + m] = fa[:m]
                g[n : n + m] = fg[:m]
                d[n : n + m] = fd[:m]
                n += m
        return a, g, d

    def _imu_block(self, imu) -> np.ndarray:
        """A frame's IMU samples ``imu`` = (acc, gyro, dts) as one
        [imu_cap_frame, 7] array (acc | gyro | dt, zero rows as padding)."""
        acc, gyro, dts = imu
        blk = np.zeros((self.imu_cap_frame, 7), np.float32)
        n = min(len(acc), self.imu_cap_frame)
        blk[:n, 0:3], blk[:n, 3:6], blk[:n, 6] = acc[:n], gyro[:n], dts[:n]
        return blk

    def _frame_block(self) -> torch.Tensor:
        """This frame's ``_imu_block`` on the map device."""
        return torch.from_numpy(self._imu_block(self._frame_imu)).to(self.device)

    def _preint_block(self, blk: torch.Tensor, b: torch.Tensor) -> imu_ops.Preintegrated:
        # The tree form: in eager torch it beats the per-sample recursion at
        # the frame and the window shape alike (PERF.md).
        return imu_ops.preintegrate(blk[..., 0:3], blk[..., 3:6], blk[..., 6], b, self.calib)

    # ------------------------------------------------------------------
    def _predict_motion(self, ts):
        """Seed the motion model with the IMU prediction (PredictStateIMU
        replaces constant velocity) on frames that go through the visual
        tracker (``vi_tracking=False``). The two-view systems' VI frames
        predict inside the tracking program (``_track``), from the host's
        state before the prediction, which is also their anchor where the
        device holds none: ``v_cur`` becomes the predicted velocity here, and
        an anchor rebuilt from the host after this call would pair the
        previous pose with the current velocity (the JAX package does,
        ROADMAP "Known faults in the reference")."""
        if not self.imu_initialized or self._frame_imu[0] is None:
            return
        R_wb, p_wb, v, bg, ba = self._body_state_from_host()
        b = torch.cat([bg, ba])
        pre = self._preint_block(self._frame_block(), b)
        R2, p2, v2 = imu_ops.predict_state(R_wb, p_wb, v, b, pre)
        R_cw, t_cw = viba.cam_from_body(R2, p2, self.calib.R_bc, self.calib.t_bc)
        buf = torch.cat([R_cw.reshape(9), t_cw, v2]).cpu().numpy()
        R_cw, t_cw = buf[0:9].reshape(3, 3), buf[9:12]
        self.vel_R = R_cw @ self.R_cur.T
        self.vel_t = t_cw - self.vel_R @ self.t_cur
        self.v_cur = buf[12:15].copy()

    def _body_state_from_host(self):
        """Anchor body state on the map device from the host's camera pose,
        velocity and biases (used when no per-frame anchor exists yet)."""
        buf = torch.from_numpy(np.concatenate([
            self.R_cur.reshape(-1), self.t_cur, self.v_cur, self.bg_cur, self.ba_cur,
        ]).astype(np.float32)).to(self.device)
        R_wb, p_wb = viba.body_from_cam(
            buf[0:9].reshape(3, 3), buf[9:12], self.calib.R_bc, self.calib.t_bc
        )
        return R_wb, p_wb, buf[12:15], buf[15:18], buf[18:21]

    # ------------------------------------------------------------------
    # The VI frame's one-frame lag (the JAX package's _process_frame_vi and
    # _drain_vi_pending, inertial_system.py:416-479).
    def _process_frame_vi(self, img, ts):
        """An OK / RECENTLY_LOST frame once the IMU is initialized: drain
        the frame before it (its keyframe work included), then dispatch this
        one (on the track device against the replica when split). Returns
        the drained frame's pose, or None."""
        out = self._drain_vi_pending()
        if self.state not in (OK, RECENTLY_LOST):
            # the drained frame lost tracking: this one recovers
            return super().process_frame(img, ts)
        self._vi_pending = self._dispatch_vi(img, ts, self._frame_imu, self.frame_id)
        self.frame_id += 1
        return out

    def _vi_frame_program(self) -> VIFrameProgram:
        if self._vi_prog is None:
            m = self.map
            self._vi_prog = VIFrameProgram(VIFrameConfig(
                config=self.config, cam_params=self._track_cam, calib=self._tcalib,
                width=self.width, height=self.height, track_cap=self.track_cap,
                cam_model=self.cam_model, uint8=self.transfer_uint8, K=m.K, N=m.N, P=m.P,
                imu_cap_frame=self.imu_cap_frame,
            ), self.track_device)
        return self._vi_prog

    def _dispatch_vi(self, img, ts: float, imu, idx: int) -> dict:
        """Frame ``img`` with its IMU samples ``imu`` = (acc, gyro, dts)
        through the VI frame program, with no host read, from the previous
        frame's refined state on the device, or from the host's pose,
        velocity and biases where there is none. Returns the dispatched frame
        (its ``VIFrameOut``, ts, frame id ``idx``)."""
        if self._replica is not None:
            # the drain before this dispatch may have started a refresh:
            # adopt it if it has landed (off the card it has)
            self._replica.poll()
            self._replica.note_frame()
        host = None
        if self._vi_anchor is None:
            host = np.concatenate([self.R_cur.reshape(-1), self.t_cur, self.v_cur, self.bg_cur,
                                   self.ba_cur])
        out = self._vi_frame_program().dispatch(
            img, self._imu_block(imu), self._tmap(), self._current_schedule(),
            anchor=self._vi_anchor, Sigma=self._vi_prior, host=host,
            warm=(self._sched_dense, self._sched_lean),
        )
        self.pipe_counts["vi_dispatches"] += 1
        return dict(out=out, ts=ts, idx=idx)

    def _drain_vi_pending(self):
        """The VI frame in flight through ``_vi_post`` at its own frame id
        (its host copy waited for). Returns its pose, or None."""
        p = self._vi_pending
        if p is None:
            return None
        self._vi_pending = None
        out = p["out"]
        self.pipe_counts["vi_drains"] += 1
        self.pipe_counts["vi_ready"] += out.host.ready()
        buf = out.host.get()
        saved, self.frame_id = self.frame_id, p["idx"]
        try:
            return self._vi_post(out.feats, out.res, out.vires, p["ts"], buf)
        finally:
            self.frame_id = max(saved, self.frame_id)

    def flush(self):
        """Drain the VI frame in flight, then ``MonoSlam.flush``. Returns
        the last pose drained."""
        out = self._drain_vi_pending()
        out2 = super().flush()
        return out2 if out2 is not None else out

    def _poll_between_chunks(self) -> None:
        """``MonoSlam``'s, with the VI frame in flight drained before the
        visual one (the JAX package's ``process_frames``)."""
        self._poll_gba()
        self._drain_vi_pending()
        self._drain_pending()

    def _dispatch(self, img, ts: float, schedule: tuple, prev) -> dict:
        """``MonoSlam``'s pipelined dispatch, the frame's image and IMU
        samples kept with it: its drain posts it with its own IMU block, and
        the handoff (``_drain_pending``) runs it again."""
        d = super()._dispatch(img, ts, schedule, prev)
        d.update(img=img, imu=self._frame_imu)
        return d

    def _drain_pending(self):
        """``MonoSlam``'s drain of the visual frame in flight, with the
        frame's own IMU samples. The handoff: a frame dispatched before the
        IMU initialized, drained after, was tracked against the map before
        its gravity alignment and rescale; it goes through the VI frame
        program now, from the IMU prediction, and is drained at once."""
        p = self._pending
        if p is None:
            return super()._drain_pending()
        if (self.imu_initialized and self.vi_tracking and p["imu"][0] is not None
                and self.state == OK):
            self._pending = None
            self._apply_kf_async()
            self._poll_gba()
            self._poll_replica()
            self._vi_pending = self._dispatch_vi(p["img"], p["ts"], p["imu"], p["idx"])
            return self._drain_vi_pending()
        saved, self._frame_imu = self._frame_imu, p["imu"]
        try:
            return super()._drain_pending()
        finally:
            self._frame_imu = saved

    def _track_config(self):
        return super()._track_config()._replace(calib=self.calib,
                                                imu_cap_frame=self.imu_cap_frame)

    def _track(self, fe, ts, predict: bool = False):
        """A two-view frame's tracking (stereo, RGB-D, the rig): once the
        IMU is initialized, on a frame with IMU samples, the tracking
        program's "vi" kind (the JAX package's ``track_against_map`` and
        ``InertialSlam._track_post``: with ``predict`` the IMU prediction
        from the host's state, on the device, in place of
        ``_predict_motion``; tracking; the frame's block preintegrated at the
        anchor's bias and the 15-dof refinement), anchored at the previous
        frame's refined state on the device or, where there is none, at the
        host's state the prediction started from; then one host read and
        ``_vi_post``. Otherwise ``MonoSlam``'s (the stereo or two-camera
        refinement)."""
        if not (self.imu_initialized and self.vi_tracking) or self._frame_imu[0] is None:
            return super()._track(fe, ts, predict)
        R_pred, t_pred = self._host_prediction()
        host = np.concatenate([self.R_cur.reshape(-1), self.t_cur, self.v_cur, self.bg_cur,
                               self.ba_cur])
        prog = self._track_program()
        x = pack_x(prog.cfg, R_pred, t_pred, self.n_kf, host=host,
                   imu=self._imu_block(self._frame_imu))
        out = prog.run("vi", self.map, fe, x, self._current_schedule(),
                       warm=(self._sched_dense, self._sched_lean), anchor=self._vi_anchor,
                       Sigma=self._vi_prior, predict=predict)
        buf = out.host.get()
        if predict:
            # the host's motion model and velocity as ``_predict_motion`` leaves them
            R_cw, t_cw = buf[22:31].reshape(3, 3), buf[31:34]
            self.vel_R = R_cw @ self.R_cur.T
            self.vel_t = t_cw - self.vel_R @ self.t_cur
            self.v_cur = buf[34:37].copy()
        return self._vi_post(fe.feats, out.res, out.vires, ts, buf[:22])

    def _vi_post(self, feats, res, vires, ts, buf):
        """The state ladder after a VI frame. ``buf`` [22]: the host copy of
        (inliers, R_cw, t_cw, v, bg, ba). With under 15 visual inliers the
        state dead-reckons on the IMU for up to ``time_recently_lost``
        seconds (keyframes keep being inserted so the preintegration chain
        stays whole), then tracking is LOST."""
        n_vis = int(buf[0])
        R_new, t_new = buf[1:10].reshape(3, 3).copy(), buf[10:13].copy()
        state_tuple = (vires.R_wb, vires.p_wb, vires.v_w, vires.bg, vires.ba)
        if n_vis < 15:
            if self.state == OK or self._lost_since_ts is None:
                self._lost_since_ts = ts
            if ts - self._lost_since_ts <= self.time_recently_lost:
                self.state = RECENTLY_LOST
                self.R_cur, self.t_cur = R_new, t_new
                self.v_cur = buf[13:16].copy()
                self._vi_anchor = state_tuple
                self._vi_prior = None  # no visual information to marginalize
                self._log_pose(ts)
                if self._need_keyframe(n_vis):
                    self._ref_kf_inl = n_vis
                    self._insert_keyframe(feats, ts, res)
                return self._pose_mat()
            self.state = LOST
            self._vi_prior = None
            self._vi_anchor = None
            return None
        if self.state == RECENTLY_LOST:
            self.state = OK
            self.lost_count = 0
        self._lost_since_ts = None
        self.R_cur, self.t_cur = R_new, t_new
        self.v_cur = buf[13:16].copy()
        self.bg_cur = buf[16:19].copy()
        self.ba_cur = buf[19:22].copy()
        self._vi_anchor = state_tuple
        # Next frame's anchor uncertainty = this solve's posterior cov.
        self._vi_prior = vires.Sigma
        vis, fnd = self._to_map_dev((res.visible_mask, res.found_mask))
        self.map = map_updates.update_track_counters(self.map, vis, fnd)
        self._log_pose(ts)
        if self.on_frame is not None:
            self.on_frame(dict(event="frame", ts=ts, Twc=self._pose_mat(), n_inliers=n_vis,
                               state=self.state, n_kf=self.n_kf))
        if self._need_keyframe(n_vis):
            self._ref_kf_inl = n_vis
            self._insert_keyframe(feats, ts, res)
        return self._pose_mat()

    # ------------------------------------------------------------------
    def _create_initial_map(self, feats, ts, idx, res):
        super()._create_initial_map(feats, ts, idx, res)
        # KF0 (at init_ts) and KF1 (at ts) were just created; keep the block
        # integrating KF0 -> KF1.
        self.kf_imu_acc[1], self.kf_imu_gyro[1], self.kf_imu_dts[1] = self._collect_block(
            self.init_ts, ts
        )
        self._last_kf_ts = ts

    def _insert_keyframe(self, feats, ts, track_res):
        kf_id = self.n_kf
        prev_ts = self._last_kf_ts
        if prev_ts is None:
            prev_ts = float(self.map.kf_ts[max(kf_id - 1, 0)])
        self.kf_imu_acc[kf_id], self.kf_imu_gyro[kf_id], self.kf_imu_dts[kf_id] = (
            self._collect_block(prev_ts, ts)
        )
        self._last_kf_ts = ts

        if self.imu_initialized and kf_id >= 2:
            self._insert_keyframe_vi(feats, ts, track_res, kf_id)
        else:
            super()._insert_keyframe(feats, ts, track_res)
            # Record the current velocity / bias on the new keyframe slot.
            vb = torch.from_numpy(
                np.concatenate([self.v_cur, self.bg_cur, self.ba_cur]).astype(np.float32)
            ).to(self.device)
            self.map.kf_v[kf_id] = vb[0:3]
            self.map.kf_bg[kf_id] = vb[3:6]
            self.map.kf_ba[kf_id] = vb[6:9]
        if not self.imu_initialized and self.n_kf >= self.init_after_kf:
            self._timed_stage(1, self._initialize_imu)
            self.imu_stage = 1
        elif self.imu_initialized and self.imu_stage == 1 and self.n_kf >= self.init_after_kf + 4:
            # Stage 2 (the reference's VIBA1 step, bias priors 1e2 -> 1):
            # re-solve gravity / scale on the now roughly metric map and
            # re-run the full inertial BA with weaker bias priors.
            self._timed_stage(2, self._initialize_imu, bias_prior_g=1.0, bias_prior_a=1e4)
            self.imu_stage = 2
        elif self.imu_initialized and self.imu_stage == 2 and self.n_kf >= self.init_after_kf + 8:
            # Stage 3: free-prior full inertial BA with gravity / scale
            # vertices (VIBA2) — closes the last few % of scale.
            self._timed_stage(3, self._run_vi_ba_gs, n_iters=40, bias_prior_g=0.0, bias_prior_a=0.0)
            self.imu_stage = 3

    def _timed_stage(self, stage: int, fn, **kw) -> None:
        """Run an initialization stage; it ends in a host read, so its wall
        time includes its device work. A stage rotates and rescales the whole
        map: a split system's replica is refreshed at once (the JAX package
        refreshes it only after the next keyframe)."""
        self._apply_kf_async(force=True)  # a deferred keyframe's pose predates the stage
        t0 = time.perf_counter()
        fn(**kw)
        self.init_stage_ms[stage] = (time.perf_counter() - t0) * 1e3
        self._sync_replica()

    def _window_host(self, lo: int, last: int, fixed, W_eff: int):
        """Pad a keyframe window [lo, last) to ``W_eff`` entries with the
        empty last slot (fixed, edge masked) and gather its IMU blocks.
        Returns (window_ids, fixed, imu_blocks [W_eff-1, S, 7], edge_ok) as
        numpy: edge (ids[i] -> ids[i+1]) uses block ids[i+1]."""
        ids = list(range(lo, last))
        fixed = list(fixed)
        edge_ok = [ids[i + 1] not in self.chain_breaks for i in range(len(ids) - 1)]
        pad = W_eff - len(ids)
        if pad > 0:
            ids = ids + [self.K_cap - 1] * pad
            fixed = fixed + [True] * pad
            edge_ok = edge_ok + [False] * pad
        ids, fixed, edge_ok = ids[:W_eff], fixed[:W_eff], edge_ok[: W_eff - 1]
        blk_ids = ids[1:]
        blocks = np.concatenate([
            self.kf_imu_acc[blk_ids], self.kf_imu_gyro[blk_ids], self.kf_imu_dts[blk_ids][..., None],
        ], axis=-1).astype(np.float32)
        return (np.asarray(ids, np.int32), np.asarray(fixed, bool), blocks,
                np.asarray(edge_ok, bool))

    def _window(self, lo: int, last: int, fixed, W_eff: int):
        """``_window_host`` on the device."""
        ids, fixed, blocks, edge_ok = self._window_host(lo, last, fixed, W_eff)
        dev = self.device
        return (torch.as_tensor(ids, device=dev), torch.as_tensor(fixed, device=dev),
                torch.from_numpy(blocks).to(dev), torch.as_tensor(edge_ok, device=dev))

    def _vi_kf_program(self) -> VIKeyframeProgram:
        if self._vi_kf_prog is None:
            m = self.map
            # the depth variant: the stereo, RGB-D and rig keyframes carry
            # u_r and create their close points from depth
            cfg = self._vi_chunk_config()._replace(stereo=self.bf > 0)
            self._vi_kf_prog = VIKeyframeProgram(cfg, self.device, m.K, m.N, m.P)
        return self._vi_kf_prog

    def _insert_keyframe_vi(self, feats, ts, track_res, kf_id):
        """A keyframe once the IMU is initialized: the VI keyframe program
        (``vi_kf_program``: on the card replays of its graphs) and its one
        host read of (admitted points, the keyframe's refined state), then
        the loop-closure check. It stops a global BA in flight after its
        current dispatch, as ``MonoSlam._insert_keyframe`` does."""
        self.abort_gba()
        self._emit_keyframe(ts, kf_id)
        # Temporal VI-BA window over the last W keyframes INCLUDING the new
        # one (LocalInertialBA's mPrevKF chain).
        last = kf_id + 1
        lo = max(0, last - self.W)
        if last <= self.W:
            # The window covers the whole map: only keyframe 0 fixed (fixing
            # more this early slows scale convergence).
            fixed = [i == 0 for i in range(lo, last)]
        else:
            fixed = [i == 0 or i < last - self.ba_window for i in range(lo, last)]
        window_ids, fixed, blocks, edge_ok = self._window_host(lo, last, fixed, self.W)
        feats, feat_pt = self._to_map_dev((feats, track_res.feat_pt))
        ur = depth = None
        if self.bf > 0:
            sm = self._last_depth
            ur, depth = torch.where(sm.valid, sm.u_right, -1.0), torch.where(sm.valid, sm.depth, -1.0)
        inp = KFInputs(
            kf_id=kf_id, R=self.R_cur, t=self.t_cur, ts=ts, n_pts=self.n_pts,
            vb=np.concatenate([self.v_cur, self.bg_cur, self.ba_cur]), window_ids=window_ids,
            fixed=fixed, edge_ok=edge_ok, blocks=blocks, feats=feats, feat_pt=feat_pt, ur=ur,
            depth=depth,
        )
        self.map, buf = self._vi_kf_program().run(self.map, inp)
        self._forget_frame_maps()
        self.n_kf += 1
        self.last_kf_frame = self.frame_id
        self.n_pts += int(buf[0])
        self._take_kf_state(kf_id, buf[1:])
        # BA moved keyframe poses: the per-frame anchor / prior are stale.
        self._vi_anchor = None
        self._vi_prior = None
        if self._check_bad_imu():
            return
        self._close_loop(kf_id)
        self._start_replica_copy()

    def _forget_frame_maps(self) -> None:
        """``MonoSlam._forget_frame_maps``, the VI frame program's too."""
        super()._forget_frame_maps()
        if self._vi_prog is not None:
            self._vi_prog.forget_map()

    def _take_kf_state(self, kf_id: int, buf: np.ndarray) -> None:
        """Host state from a keyframe's packed (v, bg, ba, R, t)."""
        self.v_cur = buf[0:3].copy()
        self.bg_cur = buf[3:6].copy()
        self.ba_cur = buf[6:9].copy()
        self.R_cur = buf[9:18].reshape(3, 3).copy()
        self.t_cur = buf[18:21].copy()
        self._set_ref_cache(kf_id, self.R_cur, self.t_cur)

    # ------------------------------------------------------------------
    def _compact_hook(self, order, new_of_old, n_valid):
        """Reorder the per-slot IMU blocks after keyframe compaction. Where
        keyframes between two survivors were culled, their blocks are
        concatenated into the successor's (the reference's
        ``Preintegrated::MergePrevious``); overflow past the block capacity
        breaks the chain at that seam (VI-BA masks the inertial edge
        there)."""
        old_acc, old_gyro, old_dts = self.kf_imu_acc, self.kf_imu_gyro, self.kf_imu_dts
        acc = np.zeros_like(old_acc)
        gyro = np.zeros_like(old_gyro)
        dts = np.zeros_like(old_dts)
        old_breaks = set(self.chain_breaks)
        breaks = set()
        for r in range(n_valid):
            co = int(order[r])
            if r == 0:
                acc[0], gyro[0], dts[0] = old_acc[co], old_gyro[co], old_dts[co]
                continue
            po = int(order[r - 1])
            n = 0
            ok = True
            for j in range(po + 1, co + 1):
                if j in old_breaks:
                    ok = False
                    break
                m_j = int((old_dts[j] > 0).sum())
                if n + m_j > self.imu_cap_kf:
                    ok = False
                    break
                acc[r, n : n + m_j] = old_acc[j, :m_j]
                gyro[r, n : n + m_j] = old_gyro[j, :m_j]
                dts[r, n : n + m_j] = old_dts[j, :m_j]
                n += m_j
            if not ok:
                breaks.add(r)
        self.kf_imu_acc, self.kf_imu_gyro, self.kf_imu_dts = acc, gyro, dts
        self.chain_breaks = breaks
        self._vi_anchor = None
        self._vi_prior = None
        self._vi_dev_valid = False  # slot layout changed

    # ------------------------------------------------------------------
    def _initialize_imu(self, rounds: int = 1, bias_prior_g: float = 1e2, bias_prior_a: float = 1e6):
        """Gravity / scale / bias initialization and map alignment
        (LocalMapping::InitializeIMU): the closed-form-seeded inertial-only
        solve, the map alignment, then the full inertial BA with gravity and
        scale vertices. The bias priors follow the reference's decreasing
        ladder across re-runs (1e2 -> 1 -> 0)."""
        for _ in range(rounds):
            self._imu_init_round(bias_prior_g, bias_prior_a)

    def _imu_init_round(self, bias_prior_g: float = 1e2, bias_prior_a: float = 1e6):
        n = self.n_kf
        dev = self.device
        m = self.map
        R_wb, p_wb = viba.body_from_cam(m.kf_R[:n], m.kf_t[:n], self.calib.R_bc, self.calib.t_bc)
        b_lin = torch.from_numpy(np.concatenate([self.bg_cur, self.ba_cur]).astype(np.float32)).to(dev)
        blocks = torch.from_numpy(np.concatenate([
            self.kf_imu_acc[1:n], self.kf_imu_gyro[1:n], self.kf_imu_dts[1:n][..., None],
        ], axis=-1).astype(np.float32)).to(dev)
        pre = self._preint_block(blocks, b_lin.expand(n - 1, 6))
        edge_ok = np.asarray([(i + 1) not in self.chain_breaks for i in range(n - 1)])
        res = viba.inertial_init(
            R_wb, p_wb, torch.ones(n, dtype=torch.bool, device=dev),
            torch.arange(n - 1, dtype=torch.int32, device=dev),
            torch.arange(1, n, dtype=torch.int32, device=dev),
            pre, torch.as_tensor(edge_ok, device=dev),
            n_iters=40, fix_scale=self.imu_fix_scale,
        )
        # One host read of the solve: scale, Rwg, the shared biases (absolute:
        # the linearization point is handled inside the residual) and v.
        buf = torch.cat([
            res.scale.reshape(1), res.Rwg.reshape(9), res.bg, res.ba, res.v_w.reshape(-1)
        ]).cpu().numpy()
        s, Rwg, bg, ba = float(buf[0]), buf[1:10].reshape(3, 3), buf[10:13], buf[13:16]
        v = buf[16:].reshape(n, 3)
        if not np.isfinite(s) or s < 1e-3:
            return
        # Align the world to gravity and rescale to metric.
        self.map = map_updates.apply_scaled_rotation(
            self.map, torch.as_tensor(np.ascontiguousarray(Rwg.T), device=dev), s
        )
        # The relative frame log carries old-scale translations.
        self.rel_traj = [(ts, ref, R_cr, t_cr * s) for ts, ref, R_cr, t_cr in self.rel_traj]
        # Velocities from the init solve (visual axes, metric) -> rotate.
        v_new = (v @ Rwg).astype(np.float32)  # R_gw @ v_i
        mm = self.map
        mm.kf_v[:n] = torch.from_numpy(v_new).to(dev)
        mm.kf_bg[:n] = torch.from_numpy(bg.copy()).to(dev)
        mm.kf_ba[:n] = torch.from_numpy(ba.copy()).to(dev)
        self.imu_initialized = True
        # Full inertial BA over the WHOLE map with bias priors and free
        # gravity-direction / scale vertices (FullInertialBA(bInit=true));
        # it ends by reading the newest keyframe's state back.
        self._run_vi_ba_gs(n_iters=25, bias_prior_g=bias_prior_g, bias_prior_a=bias_prior_a)

    # ------------------------------------------------------------------
    def _run_local_ba(self, n_iters):
        if self.imu_initialized:
            self._run_vi_ba(window=self.W, n_iters=n_iters)
        else:
            super()._run_local_ba(n_iters)

    def _build_full_vi_problem(self):
        """The all-keyframe VI problem (only keyframe 0's pose fixed), at
        its exact size once the map outgrows a window: the gravity / scale
        solve shifts its scale estimate by a few percent under heavy padded
        duplication, and eager torch needs no fixed shape."""
        n = self.n_kf
        window_ids, fixed, blocks, edge_ok = self._window(
            0, n, [i == 0 for i in range(n)], max(self.W, n)
        )
        prob = local_mapping.build_vi_ba(
            self.map, window_ids, fixed, blocks[..., 0:3], blocks[..., 3:6], blocks[..., 6],
            edge_ok, self.calib, self.cam_params, bf=self.bf,
        )
        return prob, window_ids

    def _run_vi_ba_gs(self, n_iters, bias_prior_g=0.0, bias_prior_a=0.0):
        """Full inertial BA with gravity / scale vertices, then apply the
        recovered (Rwg, s) to the whole map."""
        if self.n_kf < 3:
            self._sync_host_state()
            return
        prob, window_ids = self._build_full_vi_problem()
        res = viba.vi_bundle_adjust_gs(
            prob, torch.eye(3, dtype=torch.float32, device=self.device), n_iters=n_iters,
            bias_prior_g=bias_prior_g, bias_prior_a=bias_prior_a, fix_scale=self.imu_fix_scale,
            cam_model=self.cam_model,
        )
        self.map = local_mapping.apply_vi_ba(self.map, window_ids, res, self.calib)
        buf = torch.cat([res.scale.reshape(1), res.Rwg.reshape(9)]).cpu().numpy()
        s, Rwg = float(buf[0]), buf[1:10].reshape(3, 3)
        if np.isfinite(s) and s > 1e-3:
            # The GS residual measured the visual map as s times too small:
            # scale and rotate the map, and put the velocity vertices (visual
            # units inside the GS factor) into metric units too.
            self.map = map_updates.apply_scaled_rotation(
                self.map, torch.as_tensor(np.ascontiguousarray(Rwg.T), device=self.device), s
            )
            self.map = self.map._replace(kf_v=self.map.kf_v * s)
            self.rel_traj = [(ts, ref, R_cr, t_cr * s) for ts, ref, R_cr, t_cr in self.rel_traj]
        self._sync_host_state()

    def _sync_host_state(self):
        """Refresh the host's bias / velocity / pose from the newest
        keyframe (one host read) and drop the stale per-frame anchor."""
        kf_last = self.n_kf - 1
        self._take_kf_state(kf_last, _pack_kf_state(self.map, kf_last).cpu().numpy())
        self.vel_R = np.eye(3, dtype=np.float32)
        self.vel_t = np.zeros(3, np.float32)
        self._vi_anchor = None
        self._vi_prior = None
        self._check_bad_imu()

    def _build_vi_window_problem(self, window):
        """The (padded) VI-BA problem over the last ``window`` keyframes.
        Returns (prob, window_ids), or None when there is nothing to solve."""
        if self.n_kf < 2:
            return None
        last = self.n_kf
        lo = max(0, last - window)
        ids = range(lo, last)
        if window >= last:
            fixed = [i == 0 for i in ids]  # full BA: only the origin fixed
        else:
            fixed = [i == 0 or i < last - self.ba_window for i in ids]
        if all(fixed):
            return None
        window_ids, fixed_d, blocks, edge_ok = self._window(lo, last, fixed, max(self.W, len(ids)))
        prob = local_mapping.build_vi_ba(
            self.map, window_ids, fixed_d, blocks[..., 0:3], blocks[..., 3:6], blocks[..., 6],
            edge_ok, self.calib, self.cam_params, bf=self.bf,
        )
        return prob, window_ids

    def _run_vi_ba(self, window, n_iters):
        built = self._build_vi_window_problem(window)
        if built is None:
            return
        self._vi_dev_valid = False  # a host-side VI solve: the chunk state is stale
        prob, window_ids = built
        res = viba.vi_bundle_adjust(prob, n_iters=n_iters, cam_model=self.cam_model)
        self.map = local_mapping.apply_vi_ba(self.map, window_ids, res, self.calib)
        # Sync the host's bias / velocity and the ref-pose cache with the
        # newest keyframe (one host read). The tracker's current pose stays.
        kf_last = self.n_kf - 1
        buf = _pack_kf_state(self.map, kf_last).cpu().numpy()
        self.v_cur = buf[0:3].copy()
        self.bg_cur = buf[3:6].copy()
        self.ba_cur = buf[6:9].copy()
        self._set_ref_cache(kf_last, buf[9:18].reshape(3, 3), buf[18:21])
        if self._check_bad_imu():
            return
        self._vi_anchor = None
        self._vi_prior = None

    # ------------------------------------------------------------------
    # The chunk loop (vi_device_loop.py): the steady state on the device,
    # one graph replay a frame on the card.
    def _vi_chunkable(self) -> bool:
        return (
            self.imu_initialized
            and self.vi_tracking
            and self.imu_stage >= 3  # all three initialization stages done
            and self.state == OK
            and self._replica is None  # no chunk while split
            and self.track_window is None
            # a monocular keyframe body builds no u_r rows: a system with
            # bf > 0 chunks only through the stereo branch
            and (self.bf == 0.0 or self._chunk_stereo())
            # the chunk's temporal window assumes it is full
            and self.n_kf > self.W
        )

    def _vi_chunk_config(self) -> vi_device_loop.VIChunkConfig:
        return vi_device_loop.VIChunkConfig(
            config=self.config, cam_params=self.cam_params, calib=self.calib,
            width=self.width, height=self.height, kf_every=self.kf_every,
            kf_min_inliers=self.kf_min_inliers, kf_ref_ratio=self.kf_ref_ratio, W=self.W,
            ba_window=self.ba_window, local_ba_iters=self.local_ba_iters,
            fuse_neighbors=self.fuse_neighbors, fuse_every=self.fuse_every,
            stats_every=self.stats_every, cull_every=self.cull_every,
            kf_culling=self.kf_culling, K_cap=self.K_cap, imu_cap_frame=self.imu_cap_frame,
            imu_cap_kf=self.imu_cap_kf, track_cap=self.track_cap, bf=float(self.bf),
            baseline=float(getattr(self, "baseline", 0.0)),
            max_depth=float(getattr(self, "max_depth", 0.0)), stereo=self._chunk_stereo(),
            fx=float(getattr(self, "fx", 0.0)), cam_model=self.cam_model,
        )

    def _fresh_vi_dev_state(self) -> vi_device_loop.VIDevState:
        """The chunk's inertial state from host bookkeeping (at the first
        chunk, or after per-frame processing): the anchor (the per-frame
        path's, or the host pose and velocity), its covariance, the IMU
        samples since the last keyframe and the per-keyframe blocks, in one
        upload."""
        t0 = self._last_kf_ts
        a, g, d = self._collect_block(-1e18 if t0 is None else t0, 1e18)
        S, K = self.imu_cap_kf, self.K_cap
        edge_ok = np.ones(K, np.float32)
        edge_ok[sorted(self.chain_breaks)] = 0.0
        buf = torch.from_numpy(np.concatenate([
            np.concatenate([a, g, d[:, None]], axis=-1).reshape(-1),
            np.concatenate([self.kf_imu_acc, self.kf_imu_gyro, self.kf_imu_dts[..., None]],
                           axis=-1).reshape(-1),
            edge_ok, [float((d > 0).sum())],
        ]).astype(np.float32)).to(self.device)
        blk, kf_blk = buf[: S * 7].reshape(S, 7), buf[S * 7 : S * 7 * (K + 1)].reshape(K, S, 7)
        R_wb, p_wb, v, bg, ba = self._vi_anchor or self._body_state_from_host()
        Sigma = self._vi_prior
        if Sigma is None:
            Sigma = torch.zeros((15, 15), dtype=torch.float32, device=self.device)
        return vi_device_loop.VIDevState(
            R_wb=R_wb, p_wb=p_wb, v=v, bg=bg, ba=ba, Sigma=Sigma, blk=blk,
            blk_n=buf[-1].to(torch.int32), blk_ok=torch.ones((), dtype=torch.bool, device=self.device),
            kf_blk=kf_blk, kf_edge_ok=buf[S * 7 * (K + 1) : -1] > 0.5,
        )

    def process_frames(self, imgs, tss, acc=None, gyro=None, dts=None):
        """Track a batch of frames with their IMU blocks (``acc[i]``,
        ``gyro[i]``, ``dts[i]``: the samples since frame i - 1). ``imgs``:
        ``(stack, off)``, a [N, H, W] tensor on the device (uint8 or float32,
        values in [0, 255]) holding the frames at ``stack[off : off + C]``,
        for the chunk loop; or a sequence of images. The steady state (IMU
        stage 3, tracking OK, ``n_kf > W``, no timestamp jump, a stack) runs
        as a chunk; otherwise every frame goes through ``process_frame``.
        Without IMU samples, ``MonoSlam.process_frames``."""
        if acc is None:
            return super().process_frames(imgs, tss)
        self._poll_between_chunks()
        C = len(tss)
        tss_np = np.asarray(tss, np.float64)
        chunked = isinstance(imgs, tuple)
        frames = [imgs[0][int(imgs[1]) + i] for i in range(C)] if chunked else imgs
        ok_chunk = chunked and self._vi_chunkable()
        if ok_chunk:
            last = self._last_frame_ts
            gaps = np.diff(np.concatenate([[tss_np[0] if last is None else last], tss_np]))
            ok_chunk = not np.any(gaps > self.ts_jump_threshold)
        if ok_chunk and not self.localization_only and self.n_kf >= self.K_cap - 1 - (C + 1) // 2:
            self._make_room()
        if not ok_chunk:
            for i in range(C):
                self._fallback_frame_imu(frames[i], float(tss_np[i]), acc[i], gyro[i], dts[i])
            return
        self._run_vi_chunk(imgs[0], int(imgs[1]), frames, tss_np, acc, gyro, dts)

    def _run_vi_chunk(self, stack, off, frames, tss_np, acc, gyro, dts):
        C, M = len(tss_np), self.imu_cap_frame
        runner = self._vi_runner
        if runner is None:
            runner = self._vi_runner = vi_device_loop.VIChunkRunner(
                self._vi_chunk_config(), self.device
            )
        # Build the inertial state BEFORE recording the chunk's IMU in the
        # host history: _collect_block gathers everything after the last
        # keyframe, and the chunk appends its own frames' samples on the
        # device.
        st = self._fresh_vi_dev_state() if not (self._vi_dev_valid and runner.buf) else None
        xs = np.zeros((C, M * 7 + 2), np.float32)
        for i in range(C):
            n = min(len(dts[i]), M)
            blk = xs[i, : M * 7].reshape(M, 7)
            blk[:n, 0:3], blk[:n, 3:6], blk[:n, 6] = acc[i][:n], gyro[i][:n], dts[i][:n]
            xs[i, M * 7 :] = (tss_np[i], self.frame_id + i)
            if len(dts[i]):
                self._imu_history.append((
                    float(tss_np[i]), np.asarray(acc[i], np.float32),
                    np.asarray(gyro[i], np.float32), np.asarray(dts[i], np.float32),
                ))
        del self._imu_history[:-200]
        # Localization mode: a last-keyframe id far in the future keeps the
        # chunk from inserting keyframes (the JAX package's sentinel).
        lkf = self.frame_id + (1 << 22) if self.localization_only else self.last_kf_frame
        runner.load(
            self.map, runner.carry().st if st is None else st, self.n_kf, self.n_pts, lkf,
            self._ref_kf_inl if self._ref_kf_inl > 0 else -1,
        )
        n_kf0, fid0 = self.n_kf, self.frame_id
        rows, kf_ids = runner.run_chunk(
            stack, off, torch.from_numpy(xs).to(self.device), self._current_schedule(), n_kf0
        )
        self._forget_frame_maps()  # the step graphs wrote the map in place
        c = runner.carry()
        self.map = c.m
        # The chunk's one read: its rows, the carried body state, the
        # counters and the new keyframes' IMU blocks.
        R_sc, t_sc = viba.cam_from_body(c.st.R_wb, c.st.p_wb, self.calib.R_bc, self.calib.t_bc)
        new = slice(n_kf0, n_kf0 + len(kf_ids))
        rows, R_sc, t_sc, v, bg, ba, sc, new_blk, new_ok = read_host(
            rows, R_sc, t_sc, c.st.v, c.st.bg, c.st.ba,
            torch.stack([c.n_kf, c.n_pts, c.last_kf_fid, c.alive.to(torch.int32), c.ref_inl]),
            c.st.kf_blk[new], c.st.kf_edge_ok[new],
        )
        out = read_rows(rows)
        self.frame_id = fid0 + C
        self._absorb_vi_chunk(out, R_sc, t_sc, v, bg, ba, sc, kf_ids, new_blk, new_ok, tss_np)
        self._last_frame_ts = float(tss_np[-1])
        self._maybe_publish_points(float(tss_np[-1]))
        if self._check_bad_imu():
            return
        self._vi_dev_valid = True  # unless a closure or the dead tail below moves things
        if (self.loop_closer is not None or self.atlas is not None) and self._close_at_boundary(
                self._new_kf_slots(out)):
            return
        n_run = rows.shape[0]
        if sc[3] < 0.5:
            # Visual support collapsed at frame k: hand off to the per-frame
            # RECENTLY_LOST ladder and replay frames k.. there, their IMU
            # samples first taken out of the history the chunk recorded (so
            # the next keyframe's block does not hold them twice).
            k = n_run - 1
            self.state = RECENTLY_LOST
            self._lost_since_ts = float(tss_np[k])
            cut = float(tss_np[k]) - 1e-9
            self._imu_history = [e for e in self._imu_history if e[0] < cut]
            self.frame_id = fid0 + k
            for i in range(k, C):
                self._fallback_frame_imu(frames[i], float(tss_np[i]), acc[i], gyro[i], dts[i])

    def _close_at_boundary(self, new_kfs) -> bool:
        """The loop-closure check and the Atlas's weld of a chunk's new
        keyframes at its boundary. Either moves the map: the chunk's
        inertial state is rebuilt at the next chunk. After a closure the
        end-of-chunk pose (frames past the newest keyframe) is carried
        through that keyframe's correction, T_cur' = (T_cur T_kf_old^-1)
        T_kf_new, its velocity rotated alike (CorrectLoop's velocity
        update); after a weld, which remaps the slots, the tracker takes the
        newest keyframe's state. Returns True on a bad-IMU reset."""
        if not new_kfs:
            return False
        last = self.n_kf - 1
        R_cur, t_cur, v_cur = self.R_cur, self.t_cur, self.v_cur
        moved, R_old = False, None
        if self.loop_closer is not None:
            R_old, t_old = read_host(self.map.kf_R[last], self.map.kf_t[last])
            moved = self.loop_closer.try_close_batch(self, new_kfs)
        if self.atlas is not None and self.atlas.maps and any(k % 4 == 0 for k in new_kfs):
            self._freeze_rel_traj()
            if self.atlas.merge_current_into(self, 0):
                moved, R_old = True, None
        if not moved:
            return False
        self._vi_dev_valid = False
        self._vi_anchor = None
        self._vi_prior = None
        buf = _pack_kf_state(self.map, self.n_kf - 1).cpu().numpy()
        self.bg_cur, self.ba_cur = buf[3:6].copy(), buf[6:9].copy()
        R_new, t_new = buf[9:18].reshape(3, 3), buf[18:21]
        if R_old is not None and self.n_kf - 1 == last:
            # the pose the chunk ended at, read before the closure moved it
            R_rel = R_cur @ R_old.T
            t_rel = t_cur - R_rel @ t_old
            self.R_cur = (R_rel @ R_new).astype(np.float32)
            self.t_cur = (R_rel @ t_new + t_rel).astype(np.float32)
            self.v_cur = ((R_new.T @ R_old) @ v_cur).astype(np.float32)
        else:
            self.R_cur, self.t_cur, self.v_cur = R_new.copy(), t_new.copy(), buf[0:3].copy()
            self._set_ref_cache(self.n_kf - 1, R_new, t_new)
        self.vel_R = np.eye(3, dtype=np.float32)
        self.vel_t = np.zeros(3, np.float32)
        return self._check_bad_imu()

    def _absorb_vi_chunk(self, out, R_sc, t_sc, v, bg, ba, sc, kf_ids, new_blk, new_ok, tss_np):
        """Host state after a chunk: counters, the carried body state, the
        mirror of the new keyframes' IMU blocks, the motion model and the
        trajectory logs of the tracked frames."""
        self.n_kf, self.n_pts = int(sc[0]), int(sc[1])
        if not self.localization_only:  # else the sentinel, not a frame id
            self.last_kf_frame = int(sc[2])
        self._ref_kf_inl = max(0, int(sc[4]))
        self.R_cur, self.t_cur = R_sc.astype(np.float32), t_sc.astype(np.float32)
        self.v_cur, self.bg_cur, self.ba_cur = v.copy(), bg.copy(), ba.copy()
        self._ref_cache = None
        # The chunk's state carries the exact anchor; a per-frame call after
        # it starts from the host pose.
        self._vi_anchor = None
        self._vi_prior = None
        for j, k in enumerate(kf_ids):
            self.kf_imu_acc[k], self.kf_imu_gyro[k] = new_blk[j, :, 0:3], new_blk[j, :, 3:6]
            self.kf_imu_dts[k] = new_blk[j, :, 6]
            if not new_ok[j]:
                self.chain_breaks.add(k)
        alive = np.nonzero(out.alive)[0]
        if len(alive) >= 2:
            # constant velocity for a later non-VI frame
            R0, t0, R1, t1 = out.R[alive[-2]], out.t[alive[-2]], out.R[alive[-1]], out.t[alive[-1]]
            self.vel_R = (R1 @ R0.T).astype(np.float32)
            self.vel_t = (t1 - self.vel_R @ t0).astype(np.float32)
        self._log_chunk_rows(out, tss_np)
        kf_rows = [i for i in alive if out.is_kf[i]]
        if kf_rows:
            self._last_kf_ts = float(tss_np[kf_rows[-1]])
