"""Monocular SLAM system facade — port of ``orb_slam3_ros_tpu.models.system.MonoSlam``
(the reference's ``System`` + ``Tracking`` state machine and the
synchronous per-keyframe ``LocalMapping`` body).

State machine: NOT_INITIALIZED -> (two-view initialization) -> OK ->
(tracking loss) -> LOST -> (relocalization) -> OK. Per frame:
constant-velocity pose prediction, ORB extraction and coarse-to-fine
tracking on ``device``, one host read of (inliers, R, t); then the
keyframe decision, and on a keyframe the mapping work
(``kf_work.keyframe_work``) and one host read of (admitted points, refined
pose). At capacity, culled keyframe slots are recycled by compaction.

By default (``pipelined=True``, the JAX package's default) tracking runs
one frame behind: ``process_frame`` dispatches frame i, then drains frame
i-1's result and returns frame i-1's pose (None for the first OK frame
after initialization or relocalization); ``flush`` (and ``get_trajectory``,
which flushes) drains the last frame. Frame i's prediction is made on the
device from the poses of frames i-1 and i-2, which may still be in flight
(``frame_program``: on the card one CUDA graph replay a frame), and its
(inliers, R, t) come back through pinned memory behind a CUDA event, so the
host's keyframe decision, keyframe work and events for frame i-1 overlap
the device's frame i: the shape of the reference's tracking / mapping
thread overlap (System.cc:178). A keyframe's work is queued with no host
read (the local BA in its device form) and its (admitted points, refined
pose) are absorbed at a later frame once they have landed, or at once when
something needs them (``n_pts``, the next keyframe, relocalization,
compaction, ``flush``): the reference's rule that LocalMapping never stalls
Tracking (LocalMapping.cc:64). Until then the tracked pose stands for the
keyframe's in the reference-pose cache. The loop closer checks a deferred
keyframe when its result is absorbed (the reference's keyframe queue to the
loop thread). With an Atlas the keyframe work stays synchronous, as in the
JAX package. A frame that is not OK drains first and then recovers: a
frame that finds tracking OK again is tracked at once on the dense
schedule; otherwise it initializes or relocalizes. ``pipelined=False``
tracks every frame at once and returns its own pose.

A map can also be loaded and tracked in localization mode (``set_map`` /
``load_map`` + ``activate_localization_mode``).

``process_frames`` runs the steady state in chunks (``device_loop``): on
the card each frame is one replay of a captured CUDA graph of the frame
step, each keyframe a few replays of the keyframe body's graphs, with a
two-word host read a frame and one read a chunk; frames outside the steady
state go through ``process_frame`` one at a time, as in the JAX package.

A LOST frame relocalizes (``Tracking::Relocalization``): retrieval
candidates by covisibility-grouped word signatures, descriptor matches
against each candidate keyframe's landmarks, PnP RANSAC, then tracking
against the map from the PnP pose; one host read of the candidates and one
of each attempt's result.

With ``enable_loop_closing`` a ``loop_closing.LoopCloser`` checks every new
keyframe (per keyframe on the per-frame path, over a chunk's new keyframes
at the chunk boundary) and corrects the map on a verified revisit, then
starts the asynchronous global BA: a Schur-PCG solve of a cloned snapshot
of the map, two LM iterations a dispatch, interleaved with tracking on the
card's one stream. A CUDA event recorded after each dispatch paces the
next one (polled at chunk boundaries and frames, no sync, no thread); a
new keyframe of the per-frame path aborts the solve after its current
dispatch; the result folds in with the keyframes and points made during
the solve carried along (``apply_global_ba_partial``). ``flush`` folds in
a solve still in flight.

With ``enable_atlas`` an ``atlas.Atlas`` keeps the maps tracking lost: after
``lost_patience`` frames without a relocalization, or at a timestamp jump,
the map is archived (or discarded below 8 keyframes) and a fresh one
initialized; a lost frame also tries the archived maps and switches into
one it tracks against; every 4th keyframe slot (per keyframe, or among a
chunk's new keyframes at its boundary) tries to weld the active map into
the oldest archived one.

Stereo and RGB-D (``stereo_system``) subclass this class: they extract
their own frames and go through ``_track``; ``bf`` (fx * baseline, 0 here)
gives every BA the (u, v, u_r) rows of their keyframes, and
``_chunk_stereo`` lets the chunk loop take [2, H, W] stereo pairs.

``cam_model="kb8"`` tracks raw Kannala-Brandt-8 fisheye frames natively,
per frame and in chunks: KB8 projection in tracking, fusion and every BA,
triangulation gated on bearings, two-view initialization and
relocalization's PnP on fx-scaled bearings (a centred virtual pinhole),
and in loop closing and the Atlas: the Sim(3) solves, SearchBySim3 (K1's
"sim3" and "merge" sites), tracking against an archived map and the
global BA. The JAX package projects loop closing's and the Atlas's rows
through the pinhole model whatever the camera (ROADMAP "Known faults");
the port projects them through the system's camera. The two-camera
fisheye rig is ``fisheye_stereo``; the rectified route is
``ops.rectify`` into the pinhole system.

``on_frame`` (a callable, e.g. ``utils.obslog.FrameStreamer`` or a
``utils.control.ControlServer``'s hook) receives the JAX package's events
as dicts of numpy arrays and Python scalars: "frame" for every tracked
frame, "keyframe" for every keyframe, and with ``points_every`` > 0, every
``points_every`` frames, "map_points", "kf_markers" and (per frame)
"tracked_points" from one host read. A chunk's frame and keyframe events
come from the rows its loop reads anyway (no read or graph node added),
its point events from one read at its boundary.

``timing`` holds host wall-clock stage times per frame
(``timing_summary``, ``print_time_stats``); see ``_tic``.

``devices=(track_device, map_device)`` splits the system over two devices
(the JAX package's two-chip split, the shape of the reference's Tracking /
LocalMapping threads): the canonical map lives on the map device, where
initialization, relocalization, keyframe work, loop closing, the global BA
and the Atlas run; each frame's extraction and tracking run on the track
device against a replica of the map (``replica.MapReplica``), refreshed
asynchronously after every keyframe and at once after any other map
change. A refresh that has landed is adopted at the top of the next frame,
so tracking reads a map at most one keyframe old (the JAX package's
per-frame path adopts it only at the next keyframe; ROADMAP "Known
faults"). No chunk runs while split, as in the JAX package. Both devices
may be one card (or the CPU): the replica is still a copy of its own.

With ``devices``, the speculative frame runs on the track device against
the replica.
"""

from __future__ import annotations

import sys
import time
from typing import Optional

import numpy as np
import torch

from .. import resolve_device, to_device
from ..ops import ba_pcg, cameras, matching, orb, pnp, ransac, retrieval
from . import device_loop, kf_work, local_mapping, map_state, map_updates, tracking
from .atlas import Atlas
from .chunk_runner import read_host, read_rows
from .frame_program import FrameConfig, FrameProgram, HostCopy
from .kf_program import KFInputs, KeyframeProgram
from .loop_closing import LoopCloser
from .replica import MapReplica

# The stereo, RGB-D and two-camera systems refuse ``devices``: the JAX
# package's raise ValueError("Received incompatible devices ...") at their first
# tracked frame, where the stereo / two-camera refinement reads the canonical
# map with the replica's tracking results (ROADMAP "Divergences").
SPLIT_REFUSED = ("{0} does not run split over two devices: the JAX package's {0} raises "
                 "ValueError (incompatible devices) at its first tracked frame "
                 "(ROADMAP \"Divergences\")")

NOT_INITIALIZED = 0
OK = 1
LOST = 2
RECENTLY_LOST = 3  # inertial dead reckoning (InertialSlam)


class _ChunkReplayView:
    """Frame ``i`` of a chunk given as ``(stack, offset)``: ``stack[offset + i]``
    (the per-frame fallback and the dead-tail replay read frames so)."""

    def __init__(self, stack, offset: int):
        self._stack = stack
        self._off = offset

    def __getitem__(self, i):
        return self._stack[self._off + i]


def _reloc_pnp_inputs(m: map_state.MapState, kf: int, feats: orb.Features):
    """2D-3D correspondences for relocalization's PnP (the JAX package's
    ``_reloc_pnp_inputs``; the reference's SearchByBoW(pKF, frame)): the
    query frame's descriptors matched against keyframe ``kf``'s features,
    the keyframe's bound live landmarks paired with the query pixels.
    Returns (X [N, 3], uv [N, 2], ok [N])."""
    kf_feats = orb.Features(
        xy=m.kf_xy[kf], level=m.kf_level[kf], angle=m.kf_angle[kf], response=None,
        desc_packed=None, desc_sign=m.kf_desc_sign[kf], valid=m.kf_feat_valid[kf],
    )
    idx, _ = matching.search_frame_frame(kf_feats, feats, max_dist=64, ratio=0.8)
    pt = m.kf_obs[kf]
    ptc = torch.clamp(pt, 0, m.P - 1).long()
    ok = (idx >= 0) & (pt >= 0) & m.pt_valid[ptc]
    uv = feats.xy[torch.clamp(idx, 0, m.N - 1).long()]
    return m.pt_X[ptc], uv, ok


def _reloc_detect(m: map_state.MapState, desc_sign, valid, vocab) -> torch.Tensor:
    """Relocalization candidates (DetectRelocalizationCandidates,
    KeyFrameDatabase.cc:733-856; the JAX package's ``_reloc_detect_fused``):
    every keyframe's signature, the query's, the covisibility and the
    grouped ranking. Returns the candidate ids [3] int32, -1 for none."""
    sigs = retrieval.kf_signatures(m.kf_desc_sign, m.kf_feat_valid, vocab)
    q = retrieval.signature(desc_sign, valid, vocab)
    cand, _ = retrieval.detect_candidates_grouped(
        q, sigs, map_state.covisibility(m), m.kf_valid,
        torch.zeros((m.K,), dtype=torch.bool, device=m.kf_valid.device), min_common_score=0.0,
    )
    return cand


def _reloc_attempt(m: map_state.MapState, cand: int, feats: orb.Features, cam_params,
                   width: int, height: int, generator=None, samples=None,
                   cam_model: str = "pinhole") -> torch.Tensor:
    """One relocalization attempt against keyframe ``cand``
    (Tracking::Relocalization, Tracking.cc:3648-3760; the JAX package's
    ``_reloc_attempt_fused``): descriptor matches to its landmarks, a PnP
    RANSAC seed (the keyframe's own pose when PnP has too little support),
    then tracking against the map from the seed. Under KB8 the PnP runs on
    ``cameras.fx_bearings`` with ``cameras.bearing_camera``. ``samples``
    [256, 6]: the PnP hypotheses' samples (drawn by ``generator`` when
    None). Returns [13] f32 on the device: (R, t, tracking inliers)."""
    X, uv, ok = _reloc_pnp_inputs(m, cand, feats)
    pnp_cam = cam_params
    if cam_model == "kb8":
        uv, pnp_cam = cameras.fx_bearings(cam_params, uv), cameras.bearing_camera(cam_params)
    if samples is None:
        pres = pnp.solve_pnp(X, uv, ok, pnp_cam, generator)
    else:
        pres = pnp.solve_pnp_from_samples(X, uv, ok, pnp_cam, samples)
    use = pres.ok & (torch.sum(ok) >= 15)
    R0 = torch.where(use, pres.R, m.kf_R[cand])
    t0 = torch.where(use, pres.t, m.kf_t[cand])
    res = tracking.track_against_map(m, feats, R0, t0, cam_params, width, height,
                                     cam_model=cam_model)
    return torch.cat([res.R.reshape(-1), res.t, res.n_inliers.reshape(1).to(res.t.dtype)])


class MonoSlam:
    """Monocular pipeline (the reference's ``System(..., MONOCULAR)``).

    Takes the JAX package's constructor arguments with its defaults, plus
    ``device`` (None: the CUDA device, an error where there is none; the CPU
    only when asked for); the options whose paths are not ported raise when
    set.
    ``transfer_uint8`` sets the frame format of the chunk loop's stack;
    ``cam_model`` the camera ("pinhole", or "kb8": ``cam_params`` then
    holds the eight KB8 parameters and frames are raw fisheye images);
    ``devices`` = (track_device, map_device) the two-device split (module
    docstring), in place of ``device``; ``pipelined`` (default True) the
    one-frame lag (module docstring)."""

    def __init__(
        self,
        height: int,
        width: int,
        cam_params: np.ndarray,
        n_features: int = 600,
        max_keyframes: int = 64,
        max_points: int = 8192,
        ba_window: int = 8,
        ba_fixed: int = 4,
        kf_every: int = 5,
        kf_min_inliers: int = 60,
        kf_ref_ratio: float = 0.5,
        local_ba_iters: int = 6,
        enable_loop_closing: bool = False,
        enable_atlas: bool = False,
        lost_patience: int = 10,
        track_window: Optional[int] = None,
        pipelined: bool = True,
        fuse_neighbors: int = 1,
        kf_culling: bool = True,
        fuse_every: int = 1,
        stats_every: int = 1,
        cull_every: int = 1,
        track_schedule: Optional[tuple] = None,
        lean_after_kf: int = 12,
        ts_jump_threshold: float = 1.0,
        covis_ba: bool = True,
        devices: Optional[tuple] = None,
        track_cap: Optional[int] = None,
        transfer_uint8: bool = False,
        points_every: int = 0,
        cam_model: str = "pinhole",
        seed: int = 0,
        device: str | torch.device | None = None,
    ):
        cameras.check_model(cam_model)
        if devices is not None:
            track_device, map_device = (torch.device(d) for d in devices)
            if track_device.type != map_device.type or (
                    device is not None and torch.device(device).type != map_device.type):
                raise ValueError(f"devices {devices} (with device={device}): the track and map "
                                 "devices must be of one type, and device, if given, too")
            device = map_device
        self.device = resolve_device(device)
        # per-frame extraction and tracking run here (the map device unless split)
        self.track_device = self.device if devices is None else track_device
        self.height, self.width = height, width
        self.cam_params = torch.as_tensor(np.asarray(cam_params, np.float32), device=self.device)
        self._track_cam = self.cam_params.to(self.track_device)
        self.cam_model = cam_model
        self.config = orb.default_config(height, width, n_features=n_features)
        self.K_cap = max_keyframes
        self.P_cap = max_points
        self.N = self.config.total_cap
        self.ba_window = ba_window
        self.ba_fixed = ba_fixed
        self.W = ba_window + ba_fixed
        self.kf_every = kf_every
        self.kf_min_inliers = kf_min_inliers
        self.kf_ref_ratio = kf_ref_ratio
        self.local_ba_iters = local_ba_iters
        self.track_window = track_window
        self.fuse_neighbors = fuse_neighbors
        self.kf_culling = kf_culling
        self.fuse_every = max(1, fuse_every)
        self.stats_every = max(1, stats_every)
        self.cull_every = max(1, cull_every)
        self.ts_jump_threshold = ts_jump_threshold
        self.covis_ba = covis_ba
        self.transfer_uint8 = transfer_uint8
        self.track_cap = track_cap
        self._sched_dense = track_schedule or tracking.SCHEDULE_DENSE
        self._sched_lean = track_schedule or tracking.SCHEDULE_LEAN
        self.lean_after_kf = lean_after_kf
        self.localization_only = False
        # The one-frame lag: the frame in flight (a dict: its FrameOut, ts,
        # frame id) and the deferred keyframe results ((kf_id, HostCopy) of
        # (admitted points, kf R, kf t, BA iterations)); with the frame
        # program, made at the first dispatch, and counts of the dispatches,
        # the drains and the drains whose copy had landed already.
        self.pipelined = pipelined
        self._pending = None
        self._kf_async = None
        self._frame_prog = None
        self.pipe_counts = {"dispatches": 0, "drains": 0, "ready": 0, "kf_deferred": 0}
        # fx * baseline of the stereo / RGB-D residuals (0: monocular, no u_r rows)
        self.bf = 0.0
        # Hypothesis draws of two-view initialization, on ``device``.
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

        self.state = NOT_INITIALIZED
        self.map = map_state.empty_map(self.K_cap, self.N, self.P_cap, device=self.device)
        # tracking's copy of the map on the track device when split
        self._replica = None if devices is None else MapReplica(self.map, self.track_device)
        self.n_kf = 0
        self.n_pts = 0
        self.frame_id = 0
        self.last_kf_frame = 0
        self._ref_kf_inl = 0  # inliers at the last keyframe insertion
        self._last_frame_ts = None
        self._init_fail_count = 0
        self._cap_retry_frame = -999
        self.init_feats: Optional[orb.Features] = None
        self.init_ts = 0.0
        self.on_frame = None  # observation hook: a callable taking one event dict
        self.points_every = points_every
        self._last_points_pub = -1  # frame id of the last point-cloud events
        self.timing = {}  # stage name -> [host seconds], see _tic
        self.ba_iters = []  # local-BA iterations run, one entry per BA of the per-frame path
        self.loop_closer = LoopCloser() if enable_loop_closing else None
        # The global BA in flight (mbStopGBA semantics), or None; with counts
        # of the solves started and folded in and of the dispatches made.
        self._gba = None
        self.gba_counts = {"started": 0, "finished": 0, "dispatches": 0}
        # The archived maps, and the lost frames since tracking last held.
        self.atlas = Atlas() if enable_atlas else None
        self.lost_count = 0
        self.lost_patience = lost_patience
        # The retrieval vocabulary ([A, 256] +-1 int8 on ``device``); the
        # shipped one is installed here (the reference loads its ORBvoc at
        # startup, System.cc:114).
        self.set_vocabulary(retrieval.default_vocabulary())
        self._mono_runner = None  # the chunk loop's runner, made at the first chunk
        # The keyframe program (its buffers hold the map after a keyframe),
        # made at the first keyframe that runs it.
        self._kf_prog = None

        # Motion model (velocity = T_cur * T_last^-1), kept on the host.
        self.R_cur = np.eye(3, dtype=np.float32)
        self.t_cur = np.zeros(3, np.float32)
        self.vel_R = np.eye(3, dtype=np.float32)
        self.vel_t = np.zeros(3, np.float32)
        self._ref_cache = None  # (ref_kf_id, R_ref, t_ref) host copy
        self.trajectory = []  # (ts, Twc 4x4) frozen at track time
        # (ts, ref_kf, R_cr, t_cr): each frame's pose relative to its
        # reference keyframe, so the final trajectory carries all later
        # keyframe corrections (the reference's mlRelativeFramePoses).
        self.rel_traj = []
        self.frozen_traj = []  # absolute poses of frames whose ref keyframe or map went

    # ------------------------------------------------------------------
    @property
    def n_pts(self) -> int:
        """Live landmark count. Absorbs deferred keyframe results first, so
        a reader always sees the settled count."""
        if self._kf_async is not None:
            self._apply_kf_async(force=True)
        return self._n_pts

    @n_pts.setter
    def n_pts(self, v: int) -> None:
        self._n_pts = v

    # ------------------------------------------------------------------
    def set_map(self, m: map_state.MapState, n_kf: int, n_pts: int, R_cw, t_cw) -> None:
        """Install a map and the current pose Tcw; tracking starts (state
        OK) with a zero motion model. Tensors already on ``device`` are
        used in place, so tracking's visibility counters update them."""
        if m.K != self.K_cap or m.P != self.P_cap or m.N != self.N:
            raise ValueError(
                f"map capacities (K={m.K}, P={m.P}, N={m.N}) do not match this "
                f"system (K={self.K_cap}, P={self.P_cap}, N={self.N})"
            )
        self.map = map_state.MapState(*(x.to(self.device) for x in m))
        self._sync_replica()
        self.n_kf = int(n_kf)
        self.n_pts = int(n_pts)
        self.R_cur = np.asarray(R_cw, np.float32)
        self.t_cur = np.asarray(t_cw, np.float32)
        self.vel_R = np.eye(3, dtype=np.float32)
        self.vel_t = np.zeros(3, np.float32)
        self._ref_cache = None
        self.last_kf_frame = self.frame_id
        self.state = OK

    def load_map(self, path: str) -> None:
        """Load a map checkpoint written by either package's ``save_map``
        and resume tracking from the pose stored in its counters."""
        from ..utils import checkpoint

        m, counters = checkpoint.load_map(path, device=self.device)
        self.frame_id = int(counters.get("frame_id", 0))
        self.set_map(
            m, counters["n_kf"], counters["n_pts"], counters["R_cur"], counters["t_cur"]
        )

    def activate_localization_mode(self) -> None:
        """Freeze the map: no keyframe insertion (``mbOnlyTracking``)."""
        self.localization_only = True

    def deactivate_localization_mode(self) -> None:
        """Resume full SLAM: the keyframe cadence re-arms from this frame."""
        self.localization_only = False
        self.last_kf_frame = self.frame_id
        self._ref_kf_inl = 0

    def set_vocabulary(self, vocab) -> None:
        """Install a retrieval vocabulary ([A, 256] +-1, numpy or a tensor),
        used by relocalization from the next lost frame on and by loop
        closing from its next check on. Call it before mapping starts: the
        signatures of archived maps are not recomputed."""
        if isinstance(vocab, torch.Tensor):
            vocab = vocab.cpu().numpy()
        self.vocab = torch.from_numpy(np.asarray(vocab, np.int8)).to(self.device)
        if self.loop_closer is not None:
            self.loop_closer.vocab = self.vocab
        if self.atlas is not None:
            self.atlas.vocab = self.vocab

    def train_vocabulary_from_map(self, n_words: int | None = None, iters: int = 12) -> np.ndarray:
        """Train a vocabulary on the descriptors the map's keyframes hold
        (one host read) and install it. The default size grows with the
        samples, one word for 16 of them, between 32 and ``MAX_WORDS``;
        from 1024 words the training is hierarchical."""
        desc, valid = read_host(self.map.kf_desc_sign[: self.n_kf],
                                self.map.kf_feat_valid[: self.n_kf])
        train = desc.reshape(-1, 256)[valid.reshape(-1) > 0.5].astype(np.int8)
        if n_words is None:
            n_words = int(np.clip(len(train) // 16, 32, retrieval.MAX_WORDS))
        if n_words >= 1024:
            vocab = retrieval.train_vocabulary_hier(train, n_words=n_words, iters=iters)
        else:
            vocab = retrieval.train_vocabulary(train, n_words=n_words, iters=iters)
        self.set_vocabulary(vocab)
        return vocab

    # ------------------------------------------------------------------
    # The two-device split (no-ops on one device).
    def _tmap(self) -> map_state.MapState:
        """The map per-frame tracking reads: the replica when split, else
        the canonical map."""
        return self.map if self._replica is None else self._replica.current

    def _to_map_dev(self, x):
        """Tracking's outputs (tensors, NamedTuples of them, tuples) on the
        map device, before they update the canonical map."""
        return x if self._replica is None else to_device(x, self.device)

    def _sync_replica(self) -> None:
        """Refresh the replica now: a map change outside the keyframe cadence
        (initialization, a loop closure, a global-BA fold-in, compaction, an
        Atlas switch or weld, a reset, ``set_map``)."""
        if self._replica is not None:
            self._replica.sync(self.map)

    def _start_replica_copy(self) -> None:
        """Refresh the replica asynchronously after keyframe work; a refresh
        still in flight is adopted first, so tracking is never more than one
        keyframe behind."""
        if self._replica is not None:
            self._replica.start(self.map)

    def _close_loop(self, kf_id: int) -> None:
        """The loop-closure check of the new keyframe ``kf_id``. A closure
        rewrites the whole map and the tracker's pose, so the replica is
        refreshed at once: the next frame must not predict the corrected
        pose against the uncorrected map."""
        if self.loop_closer is not None and self.loop_closer.try_close(self, kf_id):
            self._sync_replica()

    def _poll_replica(self) -> None:
        """At the top of a frame: adopt a refresh that has landed."""
        if self._replica is not None:
            self._replica.poll()

    # ------------------------------------------------------------------
    def _set_ref_cache(self, ref_id, R_ref, t_ref):
        """Host copy of the reference keyframe's pose: it changes only at
        keyframe events, so the per-frame log never reads the device."""
        self._ref_cache = (int(ref_id), np.asarray(R_ref), np.asarray(t_ref))

    def _pose_mat(self) -> np.ndarray:
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = self.R_cur.T
        T[:3, 3] = -self.R_cur.T @ self.t_cur
        return T

    def _log_pose(self, ts: float) -> None:
        Rcw, tcw = self.R_cur, self.t_cur
        self.trajectory.append((ts, self._pose_mat()))
        if self.n_kf > 0:
            ref = self.n_kf - 1
            if self._ref_cache is None or self._ref_cache[0] != ref:
                R_ref = self.map.kf_R[ref].cpu().numpy()
                t_ref = self.map.kf_t[ref].cpu().numpy()
                self._set_ref_cache(ref, R_ref, t_ref)
            _, R_ref, t_ref = self._ref_cache
            R_cr = Rcw @ R_ref.T  # T_cr = Tcw_frame * Twc_ref
            self.rel_traj.append((ts, ref, R_cr, tcw - R_cr @ t_ref))

    @staticmethod
    def _compose(R_cr, t_cr, R_ref, t_ref) -> np.ndarray:
        Rcw = R_cr @ R_ref
        tcw = R_cr @ t_ref + t_cr
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = Rcw.T
        T[:3, 3] = -Rcw.T @ tcw
        return T

    def _compose_rel(self):
        kf_R = self.map.kf_R.cpu().numpy()
        kf_t = self.map.kf_t.cpu().numpy()
        return [
            (ts, self._compose(R_cr, t_cr, kf_R[ref], kf_t[ref]))
            for ts, ref, R_cr, t_cr in self.rel_traj
        ]

    def _freeze_rel_traj(self):
        """Flush the relative frame log into absolute poses."""
        self.frozen_traj.extend(self._compose_rel())
        self.rel_traj = []

    def get_trajectory(self):
        """[(ts, Twc 4x4)] of the tracked frames, recomposed against the
        current keyframe poses (the reference's SaveTrajectoryEuRoC): every
        later BA correction of a frame's reference keyframe applies. Flushes
        first: the frame in flight, deferred keyframe results and a global
        BA in flight are in it."""
        self.flush()
        if not self.rel_traj and not self.frozen_traj:
            return list(self.trajectory)
        return list(self.frozen_traj) + self._compose_rel()

    # ------------------------------------------------------------------
    def _current_schedule(self) -> tuple:
        """Dense passes while the map is young or the Atlas counts failed
        relocalizations, lean passes on a mature map."""
        if self.n_kf < self.lean_after_kf or self.lost_count > 0:
            return self._sched_dense
        return self._sched_lean

    def _check_ts_jump(self, ts: float) -> None:
        """An input gap longer than ``ts_jump_threshold`` breaks the motion
        model (Tracking.cc:1856-1891): with an Atlas the map is archived and
        a fresh one started, without one tracking drops to LOST and
        relocalizes."""
        last = self._last_frame_ts
        self._last_frame_ts = ts
        if (last is not None and self.state in (OK, RECENTLY_LOST)
                and ts - last > self.ts_jump_threshold):
            self.flush()
            if self.atlas is not None:
                self._freeze_rel_traj()
                self.atlas.archive_current(self)  # state -> NOT_INITIALIZED
            else:
                self.state = LOST

    def process_frame(self, img, ts: float):
        """Process one grayscale frame ([H, W], numpy or a tensor, values in
        [0, 255]). Returns Twc [4, 4] (numpy), or None while initializing
        or when tracking is lost. Pipelined (the default), the pose returned
        is the previous frame's: call ``flush`` (or ``get_trajectory``) to
        drain the last one."""
        self._poll_replica()
        self._check_ts_jump(ts)
        if self.pipelined:
            return self._process_frame_pipelined(img, ts)
        t0 = time.perf_counter()
        feats = orb.extract(torch.as_tensor(img, dtype=torch.float32, device=self.track_device),
                            self.config)
        if self.state in (NOT_INITIALIZED, LOST):
            feats = self._to_map_dev(feats)  # initialization and relocalization map side
            t0 = self._tic("extract", t0)
            if self.state == NOT_INITIALIZED:
                out = self._try_initialize(feats, ts)
            else:
                out = self._try_relocalize(feats, ts)
        else:
            self._predict_motion(ts)
            res = self._track_res(feats)
            t0 = self._tic("extract+track", t0)
            out = self._track_post(feats, res, ts)
        self._tic("frame", t0)
        self.frame_id += 1
        return out

    def _tic(self, name: str, t0: float) -> float:
        """Close stage ``name`` opened at ``t0`` (``time.perf_counter``) and
        open the next one: host wall clock, with no synchronization added to
        measure it. On the card a stage's time is the host's time to enqueue
        its work plus any host read inside it, so device time lands in the
        stage that reads: in ``process_frame`` the tracked frame's one read
        is in "frame", not in "extract+track".

        The stage names are the JAX package's, at its boundaries where the
        port has one. ``MonoSlam.process_frame``: "extract" (a frame that
        initializes or relocalizes), "extract+track" (extraction and
        tracking; the JAX package's one fused program), "frame" (the rest:
        the pose read, keyframe decision and keyframe work, or
        initialization / relocalization). The stereo, RGB-D and two-camera
        frames: "extract+stereo" / "extract+depth" / "extract+cross" (both
        views' extraction and their match), then "track". The port's eager
        path splits differently from the JAX package's programs in one
        place: its extraction runs before the state test, so "extract" and
        "extract+track" both start at the frame's upload. Pipelined (the
        default): "dispatch" (frame i's upload, map copy and program, with no
        wait), then "frame" (frame i-1's drain: the wait for its copy, the
        keyframe decision, queued keyframe work, events), or "extract" and
        "frame" for a frame that initializes or relocalizes. The inertial
        frame once the IMU is initialized and the chunk loop add no stage,
        as in the JAX package."""
        t1 = time.perf_counter()
        self.timing.setdefault(name, []).append(t1 - t0)
        return t1

    def timing_summary(self) -> dict:
        """Stage name -> (mean s, std s, calls)."""
        return {k: (float(np.mean(v)), float(np.std(v)), len(v)) for k, v in self.timing.items()}

    def print_time_stats(self, file=None) -> None:
        """Per-stage wall clock, mean +- std [calls], slowest first (the
        reference's ``Tracking::PrintTimeStats``, Tracking.cc:299)."""
        out = file or sys.stderr
        print("*** orb-tpu time stats (ms, mean +- std [n]) ***", file=out)
        for name, (mean, std, n) in sorted(self.timing_summary().items(), key=lambda kv: -kv[1][0]):
            print(f"  {name:24s} {mean * 1e3:9.2f} +- {std * 1e3:7.2f}  [{n}]", file=out)

    def _track(self, feats: orb.Features, ts: float):
        """Track ``feats`` against the map from the motion model's
        prediction, then ``_track_post`` (the stereo and RGB-D systems call
        it with the features they extracted themselves)."""
        return self._track_post(feats, self._track_res(feats), ts)

    def _track_res(self, feats: orb.Features) -> tracking.TrackResult:
        """``track_against_map`` from the motion model's prediction (on the
        track device against the replica when split)."""
        dev = self.track_device
        R_pred = self.vel_R @ self.R_cur
        t_pred = self.vel_R @ self.t_cur + self.vel_t
        tm = self._tmap()
        if self._replica is not None:
            self._replica.note_frame()
        pt_mask = None
        if self.track_window is not None:
            pt_mask = tm.pt_first_kf >= (self.n_kf - self.track_window)
        return tracking.track_against_map(
            tm, feats, torch.as_tensor(R_pred, device=dev),
            torch.as_tensor(t_pred, device=dev), self._track_cam,
            self.width, self.height, pt_mask=pt_mask,
            schedule=self._current_schedule(), track_cap=self.track_cap,
            cam_model=self.cam_model,
        )

    # ------------------------------------------------------------------
    # The pipelined one-frame lag (the JAX package's _process_frame_pipelined
    # and _drain_pending, system.py:661-723 and :988-1010).
    def _process_frame_pipelined(self, img, ts: float):
        t0 = time.perf_counter()
        dispatched = None
        if self.state == OK:
            dispatched = self._dispatch(img, ts, self._current_schedule(), self._pending)
            t0 = self._tic("dispatch", t0)
            out = self._drain_pending()
        else:
            self._drain_pending()  # may recover through relocalization
            if self.state == OK:
                # Just recovered: this frame at once, on the dense schedule.
                f = self._dispatch(img, ts, self._sched_dense, None)["out"]
                out = self._track_post(f.feats, f.res, ts, fetched=f.host.get())
            else:
                img = torch.as_tensor(img, dtype=torch.float32, device=self.track_device)
                feats = self._to_map_dev(orb.extract(img, self.config))
                t0 = self._tic("extract", t0)
                if self.state == NOT_INITIALIZED:
                    out = self._try_initialize(feats, ts)
                else:
                    out = self._try_relocalize(feats, ts)
        self._pending = dispatched
        self._tic("frame", t0)
        self.frame_id += 1
        return out

    def _frame_program(self) -> FrameProgram:
        if self._frame_prog is None:
            m = self.map
            self._frame_prog = FrameProgram(FrameConfig(
                config=self.config, cam_params=self._track_cam, width=self.width,
                height=self.height, track_window=self.track_window, track_cap=self.track_cap,
                cam_model=self.cam_model, uint8=self.transfer_uint8, K=m.K, N=m.N, P=m.P,
            ), self.track_device)
        return self._frame_prog

    def _dispatch(self, img, ts: float, schedule: tuple, prev) -> dict:
        """Frame ``img`` through the frame program on the track device, with
        no host read: predicted on the device from the pending frame ``prev``
        (a dispatched dict), or from the host's motion model when there is
        none. Returns the dispatched frame (its ``FrameOut``, ts, frame id)."""
        if self._replica is not None:
            self._replica.note_frame()
        prog = self._frame_program()
        if prev is not None:
            out = prog.dispatch(img, self._tmap(), self.n_kf, schedule, prev=prev["out"])
        else:
            self._predict_motion(ts)
            R_pred = self.vel_R @ self.R_cur
            t_pred = self.vel_R @ self.t_cur + self.vel_t
            out = prog.dispatch(img, self._tmap(), self.n_kf, schedule,
                                host=(R_pred, t_pred, self.R_cur, self.t_cur))
        self.pipe_counts["dispatches"] += 1
        return dict(out=out, ts=ts, idx=self.frame_id)

    def _drain_pending(self):
        """The previous call's frame through ``_track_post`` (its keyframe
        decision at its own frame id); first the deferred keyframe results
        that have landed are absorbed, a global BA in flight is advanced and
        a landed replica refresh adopted. Returns the frame's pose, or None.
        A frame drained after tracking was lost at the frame before it
        relocalizes instead."""
        self._apply_kf_async()
        self._poll_gba()
        self._poll_replica()
        p = self._pending
        if p is None:
            return None
        self._pending = None
        out = p["out"]
        if self.state != OK:
            if self.state == LOST:
                return self._try_relocalize(self._to_map_dev(out.feats), p["ts"])
            return None
        self.pipe_counts["drains"] += 1
        self.pipe_counts["ready"] += out.host.ready()
        fetched = out.host.get()
        saved, self.frame_id = self.frame_id, p["idx"]
        try:
            return self._track_post(out.feats, out.res, p["ts"], fetched=fetched)
        finally:
            self.frame_id = saved

    def _fallback_frame(self, img, ts: float):
        """One frame of a chunk that runs per frame (a gate that does not
        hold, a dead tail): ``process_frame``; the stereo system splits its
        [2, H, W] pair here."""
        return self.process_frame(img, ts)

    # ------------------------------------------------------------------
    # The chunk loop (device_loop.py): the steady state on the device, one
    # graph replay a frame on the card.
    def flush(self):
        """Drain the frame in flight (pipelined: its pose is returned),
        absorb deferred keyframe results and fold in a global BA still in
        flight (end of a sequence, before bulk map reads). A chunk is
        absorbed when ``process_frames`` returns (the JAX package drains its
        last chunk here)."""
        out = self._drain_pending()
        self._apply_kf_async(force=True)
        while self._gba is not None:
            self._poll_gba(force=True)
        return out

    # ------------------------------------------------------------------
    # The chunked, abortable global BA (the reference's background GBA
    # thread and its mbStopGBA flag, LoopClosing.cc:3609-3780).
    def _start_async_gba(self, n_iters: int, n_cg: int = 50, chunk: int = 2) -> None:
        """Start a global BA of ``n_iters`` LM iterations, ``chunk`` a
        dispatch, on a clone of the map as it stands: the chunk loop's
        buffers hold the map and the next chunk overwrites them in place,
        so neither the problem nor the snapshot of the observation table
        (against which the fold-in tells an outlier binding from one made
        during the solve) may alias them."""
        if self._gba is not None:
            self._poll_gba(force=True)  # fold in the previous solve first
        prob = local_mapping.build_global_ba(self.map, self.n_kf, self.cam_params, bf=self.bf)
        prob = prob._replace(**{f: getattr(prob, f).clone()
                                for f in ("R", "t", "X", "uv", "pt_valid", "ur")})
        self._gba = dict(prob=prob, done=0, target=n_iters, chunk=chunk, n_cg=n_cg,
                         n_kf0=self.n_kf, res=None, abort=False, obs0=self.map.kf_obs.clone())
        self.gba_counts["started"] += 1
        self._dispatch_gba_chunk()

    def abort_gba(self) -> None:
        """Issue no further dispatch (mbStopGBA); the one on the device
        completes and is folded in."""
        if self._gba is not None:
            self._gba["abort"] = True

    def _dispatch_gba_chunk(self) -> None:
        g = self._gba
        it = min(g["chunk"], g["target"] - g["done"])
        res = ba_pcg.bundle_adjust_pcg(g["prob"], n_iters=it, n_cg=g["n_cg"],
                                       cam_model=self.cam_model)
        g["prob"] = g["prob"]._replace(R=res.R, t=res.t, X=res.X)
        g["res"] = res
        g["done"] += it
        self._gba_mark(g)

    def _gba_mark(self, g: dict) -> None:
        """Record the pacing event of a dispatch (none off the card: done)."""
        self.gba_counts["dispatches"] += 1
        g["event"] = None
        if self.device.type == "cuda":
            g["event"] = torch.cuda.Event()
            g["event"].record()

    def _poll_gba(self, force: bool = False) -> None:
        """At a boundary: once the last dispatch has run on the card (or
        when forced), fold the solve in if it is done or aborted, else
        dispatch its next chunk."""
        g = self._gba
        if g is None:
            return
        if not force and g["event"] is not None and not g["event"].query():
            return
        if g["abort"] or g["done"] >= g["target"]:
            self._finish_gba()
        else:
            self._dispatch_gba_chunk()

    def _poll_between_chunks(self) -> None:
        """At a chunk boundary: advance a global BA in flight with two
        polls, as the JAX package makes there (``process_frames`` and its
        ``_drain_pending``; off the card each dispatches, on the card the
        second finds the first's dispatch still queued unless the card is
        idle), and settle the frame in flight before the chunk gate: its
        drain can change the state."""
        self._poll_gba()
        self._drain_pending()

    def _finish_gba(self) -> None:
        g, self._gba = self._gba, None
        self.map = local_mapping.apply_global_ba_partial(self.map, g["res"], g["n_kf0"],
                                                         kf_obs0=g["obs0"])
        self.map = map_updates.refresh_point_stats(self.map, n_levels=self.config.n_levels)
        self._ref_cache = None
        self.gba_counts["finished"] += 1
        self._sync_replica()

    def _chunk_stereo(self) -> bool:
        """Whether the chunk loop takes [2, H, W] stereo pairs (the stereo
        system's; RGB-D runs per frame: its float depth maps do not ride
        the frame stack)."""
        return False

    def _chunkable(self) -> bool:
        """The chunk loop's gate (the JAX package's): no chunk while split."""
        return (
            self.state == OK
            and self._replica is None
            and self.covis_ba
            # a monocular keyframe body builds no u_r rows: a system with
            # bf > 0 chunks only through the stereo branch
            and (self.bf == 0.0 or self._chunk_stereo())
            # a subclass with its own local BA (the inertial one) runs per frame
            and type(self)._run_local_ba is MonoSlam._run_local_ba
            # the per-frame path's dense warm-up on a young map first
            and self.n_kf >= max(2, self.lean_after_kf)
        )

    def _chunk_config(self) -> device_loop.ChunkConfig:
        return device_loop.ChunkConfig(
            config=self.config, cam_params=self.cam_params, width=self.width,
            height=self.height, kf_every=self.kf_every, kf_min_inliers=self.kf_min_inliers,
            kf_ref_ratio=self.kf_ref_ratio, ba_window=self.ba_window, ba_fixed=self.ba_fixed,
            local_ba_iters=self.local_ba_iters, fuse_neighbors=self.fuse_neighbors,
            fuse_every=self.fuse_every, stats_every=self.stats_every,
            cull_every=self.cull_every, kf_culling=self.kf_culling, K_cap=self.K_cap,
            track_cap=self.track_cap, track_window=self.track_window, bf=float(self.bf),
            baseline=float(getattr(self, "baseline", 0.0)),
            max_depth=float(getattr(self, "max_depth", 0.0)), stereo=self._chunk_stereo(),
            fx=float(getattr(self, "fx", 0.0)), cam_model=self.cam_model,
        )

    def _frame_stack(self, imgs) -> torch.Tensor:
        """A chunk's frames on the device as one [C, H, W] stack ([C, 2, H,
        W] of stereo pairs): uint8 with ``transfer_uint8``, float32
        otherwise."""
        if isinstance(imgs, torch.Tensor):
            return imgs.to(self.device)
        if all(isinstance(im, torch.Tensor) for im in imgs):
            stack = torch.stack([im.to(self.device) for im in imgs])
        else:
            stack = torch.from_numpy(np.stack([np.asarray(im) for im in imgs])).to(self.device)
        if self.transfer_uint8:
            return torch.clamp(stack, 0, 255).to(torch.uint8)
        return stack.to(torch.float32)

    def process_frames(self, imgs, tss):
        """Track a batch of frames. ``imgs``: ``(stack, off)``, a [N, H, W]
        tensor on the device (uint8 or float32, values in [0, 255]) holding
        the frames at ``stack[off : off + C]``; a [C, H, W] tensor; or a
        sequence of images. The steady state (tracking OK on a mature map,
        no timestamp jump) runs as a chunk; otherwise every frame goes
        through ``process_frame``. A chunk that loses track hands the frame
        that lost it and the frames after it to ``process_frame``, in state
        LOST: they relocalize."""
        self._poll_between_chunks()
        C = len(tss)
        tss_np = np.asarray(tss, np.float64)
        frames = _ChunkReplayView(imgs[0], int(imgs[1])) if isinstance(imgs, tuple) else imgs
        if not self._chunkable():
            for i in range(C):
                self._fallback_frame(frames[i], float(tss_np[i]))
            return
        self._apply_kf_async(force=True)
        # The weak-tracking rule can make a keyframe every 2 frames: reserve
        # for that, so that the chunk's capacity guard never drops one.
        if not self.localization_only and self.n_kf >= self.K_cap - 1 - (C + 1) // 2:
            self._make_room()
        last = self._last_frame_ts
        gaps = np.diff(np.concatenate([[tss_np[0] if last is None else last], tss_np]))
        if np.any(gaps > self.ts_jump_threshold):
            for i in range(C):
                self._fallback_frame(frames[i], float(tss_np[i]))
            return
        self._last_frame_ts = float(tss_np[-1])
        if isinstance(imgs, tuple):
            stack, off = imgs[0], int(imgs[1])
        else:
            stack, off = self._frame_stack(imgs), 0
        self._run_chunk(stack, off, frames, tss_np)

    def _run_chunk(self, stack, off: int, frames, tss_np) -> None:
        C = len(tss_np)
        runner = self._mono_runner
        if runner is None:
            runner = self._mono_runner = device_loop.MonoChunkRunner(
                self._chunk_config(), self.device
            )
        n_kf0, fid0 = self.n_kf, self.frame_id
        # Localization mode: a last-keyframe id far in the future keeps the
        # chunk from inserting keyframes (the JAX package's sentinel).
        lkf = fid0 + (1 << 22) if self.localization_only else self.last_kf_frame
        # One upload: the pose and motion model, then each frame's (ts, id).
        up = torch.from_numpy(np.concatenate([
            self.R_cur.reshape(-1), self.t_cur, self.vel_R.reshape(-1), self.vel_t,
            np.stack([tss_np, fid0 + np.arange(C)], axis=1).reshape(-1),
        ]).astype(np.float32)).to(self.device)
        # ref_inl -1: the thRefRatio bar reseeds from the chunk's first frame,
        # as the JAX package's host sends it (carrying it was measured there
        # to densify keyframes into weak-parallax windows).
        runner.load(self.map, up[:24], n_kf0, self.n_pts, lkf, -1)
        rows, kf_ids = runner.run_chunk(stack, off, up[24:].reshape(C, 2), self._sched_lean, n_kf0)
        self._forget_frame_maps()  # the step graphs wrote the map in place
        c = runner.carry()
        self.map = c.m
        # The chunk's one read: its rows, the end pose and motion model, the counters.
        rows, pose, sc = read_host(
            rows, torch.cat([c.R.reshape(9), c.t, c.vel_R.reshape(9), c.vel_t]),
            torch.stack([c.n_kf, c.n_pts, c.last_kf_fid, c.alive.to(torch.int32), c.ref_inl]),
        )
        out = read_rows(rows)
        self.frame_id = fid0 + C
        self._absorb_chunk(out, pose, sc, tss_np)
        self._maybe_publish_points(float(tss_np[-1]))
        new_kfs = self._new_kf_slots(out)
        if self.loop_closer is not None:
            # the chunk's new keyframes, at its boundary (the reference's loop
            # thread consuming its keyframe queue, LoopClosing.cc:1108)
            self.loop_closer.try_close_batch(self, new_kfs)
        if self.atlas is not None and self.atlas.maps and any(k % 4 == 0 for k in new_kfs):
            # a weld of the chunk's map into the oldest archived one; the next
            # chunk loads the welded map into the runner's buffers
            self._freeze_rel_traj()
            self.atlas.merge_current_into(self, 0)
        if sc[3] < 0.5:
            # Tracking failed at frame k: LOST, and frames k.. replayed one
            # at a time, through relocalization.
            k = rows.shape[0] - 1
            self.state = LOST
            self.frame_id = fid0 + k
            for i in range(k, C):
                self._fallback_frame(frames[i], float(tss_np[i]))
            self.frame_id = max(fid0 + C, self.frame_id)

    def _absorb_chunk(self, out, pose, sc, tss_np) -> None:
        """Host state after a chunk: counters, the pose and motion model, and
        the trajectory logs of the tracked frames."""
        self.n_kf, self.n_pts = int(sc[0]), int(sc[1])
        if not self.localization_only:  # else the sentinel, not a frame id
            self.last_kf_frame = int(sc[2])
        self._ref_kf_inl = max(0, int(sc[4]))
        self.R_cur, self.t_cur = pose[0:9].reshape(3, 3).copy(), pose[9:12].copy()
        self.vel_R, self.vel_t = pose[12:21].reshape(3, 3).copy(), pose[21:24].copy()
        self._ref_cache = None
        self._log_chunk_rows(out, tss_np)

    @staticmethod
    def _new_kf_slots(out) -> list:
        """The keyframe slots a chunk inserted, from its rows on the host."""
        return [int(out.ref[i]) for i in np.nonzero(out.is_kf & out.alive)[0]]

    def _log_chunk_rows(self, out, tss_np) -> None:
        """The trajectory logs of a chunk's tracked frames (``out``: its
        rows read on the host), and their "frame" / "keyframe" events: a
        row's ``ref`` is its reference keyframe slot after the frame's
        keyframe decision (n_kf - 1 at that frame)."""
        for i in np.nonzero(out.alive)[0]:
            ts = float(tss_np[i])
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = out.R[i].T
            T[:3, 3] = -out.R[i].T @ out.t[i]
            self.trajectory.append((ts, T))
            self.rel_traj.append((ts, int(out.ref[i]), out.R_cr[i].copy(), out.t_cr[i].copy()))
            if self.on_frame is not None:
                self.on_frame(dict(event="frame", ts=ts, Twc=T, n_inliers=int(out.n_inliers[i]),
                                   state=OK, n_kf=int(out.ref[i]) + 1))
                if out.is_kf[i]:
                    self.on_frame(dict(event="keyframe", ts=ts, kf_id=int(out.ref[i])))

    def _predict_motion(self, ts: float) -> None:
        """Hook: update vel_R / vel_t before tracking (constant velocity
        here; the inertial pipeline predicts from the IMU)."""

    def _compact_hook(self, order, new_of_old, n_valid) -> None:
        """Hook: reindex per-slot host state after keyframe compaction (the
        inertial pipeline reorders and merges its IMU blocks here)."""

    # ------------------------------------------------------------------
    def _try_relocalize(self, feats: orb.Features, ts: float):
        """Relocalization after tracking loss (``Tracking::Relocalization``,
        Tracking.cc:3648): up to 3 retrieval candidates (one host read), each
        tried as descriptor matches -> PnP RANSAC -> tracking against the map
        (one 13-float read an attempt); the first with >= 30 tracking
        inliers wins, with the motion model reset. With an Atlas a frame that
        fails tries the archived maps next (a switch), and after
        ``lost_patience`` such frames the map is archived and a fresh one
        started (Tracking.cc:2050-2068). Returns Twc, or None while lost."""
        self._apply_kf_async(force=True)
        if self.n_kf < 2:
            return None
        cand_ids = _reloc_detect(self.map, feats.desc_sign, feats.valid, self.vocab).cpu().numpy()
        for c in cand_ids:
            if c < 0:
                continue
            buf = _reloc_attempt(
                self.map, int(c), feats, self.cam_params, self.width, self.height, self.generator,
                cam_model=self.cam_model,
            ).cpu().numpy()
            if int(buf[12]) >= 30:
                self.R_cur = buf[:9].reshape(3, 3).copy()
                self.t_cur = buf[9:12].copy()
                self.vel_R = np.eye(3, dtype=np.float32)
                self.vel_t = np.zeros(3, np.float32)
                self.state = OK
                self.lost_count = 0
                self._log_pose(ts)
                return self._pose_mat()
        if self.atlas is not None:
            self._freeze_rel_traj()
            if self.atlas.try_relocalize_in_archived(self, feats):
                self.lost_count = 0
                self._log_pose(ts)
                return self._pose_mat()
            self.lost_count += 1
            if self.lost_count >= self.lost_patience:
                self.atlas.archive_current(self)
                self.lost_count = 0
        return None

    # ------------------------------------------------------------------
    def _try_initialize(self, feats: orb.Features, ts: float):
        """Two-view initialization (Tracking::MonocularInitialization): the
        first frame with > 100 features becomes the reference; each later
        frame is matched against it and, with >= 60 matches, reconstructed
        by H/F RANSAC. The reference frame moves on after too few matches
        or three failed reconstructions in a row. Under KB8 the H/F RANSAC
        runs on ``cameras.fx_bearings`` with ``cameras.bearing_camera`` (a
        fisheye's epipolar geometry is not linear in pixels)."""
        if self.init_feats is None:
            if int(feats.valid.sum()) > 100:
                self.init_feats = feats
                self.init_ts = ts
            return None
        idx, _ = matching.search_for_initialization(self.init_feats, feats, window=100.0)
        matched = idx >= 0
        if int(matched.sum()) < 60:
            self.init_feats = feats
            self.init_ts = ts
            return None
        xy1 = self.init_feats.xy
        xy2 = feats.xy[torch.clamp(idx, min=0).long()]
        init_cam = self.cam_params
        if self.cam_model == "kb8":
            xy1 = cameras.fx_bearings(self.cam_params, xy1)
            xy2 = cameras.fx_bearings(self.cam_params, xy2)
            init_cam = cameras.bearing_camera(self.cam_params)
        res = ransac.two_view_init(xy1, xy2, matched, init_cam, self.generator)
        if not bool(res.ok) or int(res.n_good) < 50:
            self._init_fail_count += 1
            if self._init_fail_count >= 3:
                self.init_feats = feats
                self.init_ts = ts
                self._init_fail_count = 0
            return None
        self._init_fail_count = 0
        self._create_initial_map(feats, ts, idx.cpu().numpy(), res)
        self.state = OK
        if self.pipelined:
            # the frame graph of each schedule now, not at a live frame
            self._frame_program().warm((self._sched_dense, self._sched_lean), self._tmap(),
                                       self.n_kf, self.R_cur, self.t_cur)
        self._log_pose(ts)
        return self._pose_mat()

    def _create_initial_map(self, feats, ts, idx: np.ndarray, res: ransac.TwoViewResult):
        """Two keyframes and the triangulated points, scaled to median depth
        1 (Tracking::CreateInitialMapMonocular), then a 20-iteration BA of
        the initial map with keyframe 0 fixed."""
        good = res.good.cpu().numpy()
        X1 = res.X1.cpu().numpy()  # points in the cam-1 (first keyframe) frame
        s = 1.0 / max(float(np.median(X1[good][:, 2])), 1e-6)
        R21 = res.R21.cpu().numpy()
        t21 = res.t21.cpu().numpy() * s
        n_new = int(good.sum())
        src_feat1 = np.where(good)[0]  # feature index in keyframe 0
        src_feat2 = idx[src_feat1]  # feature index in keyframe 1
        dev = self.device
        obs0 = np.full((self.N,), -1, np.int32)
        obs1 = np.full((self.N,), -1, np.int32)
        obs0[src_feat1] = np.arange(n_new, dtype=np.int32)
        obs1[src_feat2] = np.arange(n_new, dtype=np.int32)
        f1 = self.init_feats
        m = self.map
        # Keyframe 0 at the identity (world = first camera frame), keyframe
        # 1 at (R21, t21); in place on the empty map.
        map_updates.insert_keyframe(
            m, 0, torch.eye(3, device=dev), torch.zeros(3, device=dev), self.init_ts,
            f1, torch.as_tensor(obs0, device=dev),
        )
        map_updates.insert_keyframe(
            m, 1, torch.as_tensor(R21, device=dev), torch.as_tensor(t21, device=dev), ts,
            feats, torch.as_tensor(obs1, device=dev),
        )
        src = torch.as_tensor(src_feat1, device=dev).long()
        m.pt_valid[:n_new] = True
        m.pt_X[:n_new] = torch.as_tensor(X1[good] * s, device=dev)
        m.pt_desc_sign[:n_new] = f1.desc_sign[src]
        m.pt_level[:n_new] = f1.level[src]
        m.pt_first_kf[:n_new] = 0
        self.n_kf = 2
        self.n_pts = n_new
        self.last_kf_frame = self.frame_id
        self._run_local_ba(n_iters=20)
        self.map = map_updates.refresh_point_stats(self.map, n_levels=self.config.n_levels)
        self.R_cur = self.map.kf_R[1].cpu().numpy()
        self.t_cur = self.map.kf_t[1].cpu().numpy()
        self.vel_R = np.eye(3, dtype=np.float32)
        self.vel_t = np.zeros(3, np.float32)
        self._set_ref_cache(1, self.R_cur, self.t_cur)
        self._sync_replica()

    # ------------------------------------------------------------------
    def _track_post(self, feats, res, ts, fetched=None):
        """A tracked frame's host side: the motion model, the counters, the
        logs and events, the keyframe decision. ``fetched``: its (inliers,
        R, t) already on the host (the pipelined drain's), else read here:
        one host read a frame."""
        packed = fetched
        if packed is None:
            packed = torch.cat([res.n_inliers.reshape(1).to(res.t.dtype), res.R.reshape(-1),
                                res.t]).cpu().numpy()
        n_inl = int(packed[0])
        if n_inl < 15:
            self.state = LOST
            return None
        R_new = packed[1:10].reshape(3, 3)
        t_new = packed[10:13]
        self.vel_R = R_new @ self.R_cur.T
        self.vel_t = t_new - self.vel_R @ self.t_cur
        self.R_cur, self.t_cur = R_new, t_new
        vis, fnd = self._to_map_dev((res.visible_mask, res.found_mask))
        self.map = map_updates.update_track_counters(self.map, vis, fnd)
        self._log_pose(ts)
        if self.on_frame is not None:
            self.on_frame(dict(event="frame", ts=ts, Twc=self._pose_mat(), n_inliers=n_inl,
                               state=self.state, n_kf=self.n_kf))
            self._maybe_publish_points(ts, found_mask=fnd)
        if self._need_keyframe(n_inl):
            self._ref_kf_inl = n_inl
            self._insert_keyframe(feats, ts, res)
        return self._pose_mat()

    def _maybe_publish_points(self, ts: float, found_mask=None) -> None:
        """Every ``points_every`` frames, the point-cloud events through
        ``on_frame`` (the reference's tracked-points / all-points /
        keyframe-marker publishers, src/common.cc:273-369), from one host
        read: "map_points" (every live landmark), "kf_markers" (every live
        keyframe's camera centre) and, with this frame's ``found_mask``,
        "tracked_points"."""
        if self.on_frame is None or self.points_every <= 0:
            return
        if self.frame_id - self._last_points_pub < self.points_every:
            return
        self._last_points_pub = self.frame_id
        m = self.map
        got = read_host(m.pt_X, m.pt_valid, m.kf_R, m.kf_t, m.kf_valid,
                        *(() if found_mask is None else (found_mask,)))
        X, pv, kR, kt, kv = got[0], got[1] > 0.5, got[2], got[3], got[4] > 0.5
        self.on_frame(dict(event="map_points", ts=ts, n=int(pv.sum()), points=X[pv]))
        kv[self.n_kf:] = False
        centers = -np.einsum("kji,kj->ki", kR[kv], kt[kv])
        self.on_frame(dict(event="kf_markers", ts=ts, n=int(kv.sum()),
                           centers=centers.astype(np.float32)))
        if found_mask is not None:
            fm = (got[5] > 0.5) & pv
            self.on_frame(dict(event="tracked_points", ts=ts, n=int(fm.sum()), points=X[fm]))

    def _emit_keyframe(self, ts: float, kf_id: int) -> None:
        """The "keyframe" event of a keyframe about to be inserted."""
        if self.on_frame is not None:
            self.on_frame(dict(event="keyframe", ts=ts, kf_id=kf_id))

    def _need_keyframe(self, n_inl: int) -> bool:
        """Simplified NeedNewKeyFrame (Tracking.cc:3103): periodic, or early
        when tracking weakens (under ``kf_min_inliers``, or under
        ``kf_ref_ratio`` of the last keyframe's inliers); never from a
        nearly lost pose, never in localization mode. At capacity, slots
        are recycled first (``_make_room``)."""
        if self.localization_only:
            return False
        if self.n_kf >= self.K_cap and not self._make_room():
            return False
        since = self.frame_id - self.last_kf_frame
        if n_inl <= 15:
            return False
        weak = n_inl < self.kf_min_inliers or (
            self.kf_ref_ratio > 0.0
            and self._ref_kf_inl > 0
            and n_inl < self.kf_ref_ratio * self._ref_kf_inl
        )
        return since >= self.kf_every or (weak and since >= 2)

    def _make_room(self) -> bool:
        """Recycle culled keyframe slots by compaction; if the live map
        fills the capacity, first cull the most redundant keyframe at a
        relaxed bar, or else evict the one least covisible with the recent
        window. Returns True if a slot is free; a failed attempt backs off
        for 10 frames."""
        if self.frame_id - self._cap_retry_frame < 10:
            return False
        # compaction remaps slots: fold in a global BA in flight first (its
        # snapshot indexes the current layout)
        self.flush()
        if int(self.map.kf_valid.sum()) >= self.K_cap:
            self.map, n_c = map_updates.cull_keyframes(
                self.map, self.n_kf, redundancy=0.5, n_levels=self.config.n_levels
            )
            if int(n_c) == 0:
                self.map, n_c = map_updates.evict_one_keyframe(self.map, self.n_kf)
                if int(n_c) == 0:
                    self._cap_retry_frame = self.frame_id
                    return False
        self._compact_kf_slots()
        ok = self.n_kf < self.K_cap
        if not ok:
            self._cap_retry_frame = self.frame_id
        return ok

    def _compact_kf_slots(self):
        """Squeeze culled keyframe holes out of the map and remap the
        relative trajectory log; entries whose reference keyframe was
        culled freeze at its final pose."""
        valid = self.map.kf_valid.cpu().numpy()
        kf_R = self.map.kf_R.cpu().numpy()
        kf_t = self.map.kf_t.cpu().numpy()
        m2, n_valid, order = map_updates.compact_keyframes(self.map)
        order = order.cpu().numpy()
        n_valid = int(n_valid)
        new_of_old = np.full((self.K_cap,), -1, np.int32)
        new_of_old[order[:n_valid]] = np.arange(n_valid, dtype=np.int32)
        new_rel = []
        for ts, ref, R_cr, t_cr in self.rel_traj:
            if valid[ref]:
                new_rel.append((ts, int(new_of_old[ref]), R_cr, t_cr))
            else:
                self.frozen_traj.append((ts, self._compose(R_cr, t_cr, kf_R[ref], kf_t[ref])))
        self.rel_traj = new_rel
        self.map = m2
        self.n_kf = n_valid
        self._ref_cache = None
        self._sync_replica()
        if self.loop_closer is not None:
            self.loop_closer.remap_slots(new_of_old)
        self._compact_hook(order, new_of_old, n_valid)

    def _insert_keyframe(self, feats, ts, track_res):
        """Insert the current frame as keyframe ``n_kf`` and run its mapping
        work, then read back (admitted points, BA-refined pose, BA
        iterations) at once; then the loop-closure check of the new
        keyframe. Pipelined without an Atlas the work is queued instead
        (``_queue_keyframe``) and its results absorbed later
        (``_apply_kf_async``). Deferred results of the keyframe before are
        absorbed first. A new keyframe stops a global BA in flight after its
        current dispatch (the JAX package's bound on the staleness of the
        snapshot). When split, the replica's refresh starts after all of it.
        Where the JAX package runs its fused keyframe program
        (``_fused_keyframe``) the work is the keyframe program
        (``kf_program``: on the card replays of its graphs), else the eager
        ``kf_work.keyframe_work``."""
        self._apply_kf_async(force=True)
        self.abort_gba()
        kf_id = self.n_kf
        self._emit_keyframe(ts, kf_id)
        if self.pipelined and self.atlas is None:
            self._queue_keyframe(kf_id, ts, feats, track_res)
            self.n_kf += 1
            self.last_kf_frame = self.frame_id
            # the tracked pose stands for the keyframe's until its result lands
            self._set_ref_cache(kf_id, self.R_cur, self.t_cur)
            self._start_replica_copy()
            return
        feats, feat_pt = self._to_map_dev((feats, track_res.feat_pt))
        if self._fused_keyframe(kf_id):
            buf = self._run_kf_program(kf_id, ts, feats, feat_pt, self.R_cur, self.t_cur)
            iters = int(buf[13])
        else:
            dev = self.device
            self.map, n_new, iters = self._keyframe_work(
                kf_id, ts, feats, feat_pt, torch.as_tensor(self.R_cur, device=dev),
                torch.as_tensor(self.t_cur, device=dev), on_device=False,
            )
            buf = torch.cat([
                n_new.to(torch.float32).reshape(1), self.map.kf_R[kf_id].reshape(9),
                self.map.kf_t[kf_id],
            ]).cpu().numpy()
        self.ba_iters.append(iters)
        self.n_kf += 1
        self.last_kf_frame = self.frame_id
        self.n_pts += int(buf[0])
        self.R_cur = buf[1:10].reshape(3, 3).copy()
        self.t_cur = buf[10:13].copy()
        self._close_loop(kf_id)
        if self.atlas is not None and self.atlas.maps and kf_id % 4 == 0:
            # try to weld this map into the oldest archived one (MergeLocal)
            self._freeze_rel_traj()
            self.atlas.merge_current_into(self, 0)
        # the (possibly loop-corrected or welded) pose of the newest keyframe
        self._set_ref_cache(self.n_kf - 1, self.R_cur, self.t_cur)
        self._start_replica_copy()

    def _fused_keyframe(self, kf_id: int) -> bool:
        """Whether keyframe ``kf_id`` runs the keyframe program: the JAX
        package's gate of its fused program (the covisibility window, past
        the initial pair, and this class's own local BA; a subclass with
        another BA flavour runs the stages eagerly)."""
        return (self.covis_ba and kf_id >= 2
                and type(self)._run_local_ba is MonoSlam._run_local_ba)

    def _kf_program(self) -> KeyframeProgram:
        if self._kf_prog is None:
            m = self.map
            self._kf_prog = KeyframeProgram(self._chunk_config(), self.device, m.K, m.N, m.P)
        return self._kf_prog

    def _run_kf_program(self, kf_id: int, ts: float, feats, feat_pt, R, t, defer: bool = False):
        """Keyframe ``kf_id`` through the keyframe program at pose (R, t)
        (host arrays, or tensors on the map device), on the map device; the
        program's buffers become the system's map. Returns the packed (points
        admitted, R, t, BA iterations): numpy, or with ``defer`` a
        ``HostCopy`` of them."""
        inp = KFInputs(kf_id=kf_id, R=R, t=t, ts=ts, n_pts=self.n_pts, feats=feats,
                       feat_pt=feat_pt)
        self.map, packed = self._kf_program().run(self.map, inp, defer=defer)
        self._forget_frame_maps()
        return packed

    def _forget_frame_maps(self) -> None:
        """Graph replays wrote the map in place, behind torch's version
        counters: the frame program copies it in afresh at its next
        dispatch."""
        if self._frame_prog is not None:
            self._frame_prog.forget_map()

    def _keyframe_work(self, kf_id: int, ts: float, feats, feat_pt, R, t, on_device: bool):
        """``kf_work.keyframe_work`` of keyframe ``kf_id`` at pose (R, t) on
        the map device, at this system's settings."""
        return kf_work.keyframe_work(
            self.map, kf_id, R, t, ts, feats, feat_pt,
            self.n_pts, self.P_cap - self.n_pts, self.cam_params, self.bf,
            w_free=self.ba_window, w_fixed=self.ba_fixed,
            n_iters=self.local_ba_iters, n_levels=self.config.n_levels,
            fuse_neighbors=self.fuse_neighbors,
            do_fuse=self.fuse_neighbors > 0 and kf_id >= 2 and kf_id % self.fuse_every == 0,
            do_stats=kf_id % self.stats_every == 0,
            do_cull=self.kf_culling and kf_id >= 4 and kf_id % self.cull_every == 0,
            width=self.width, height=self.height,
            window=None if self.covis_ba else self._temporal_window(kf_id + 1),
            cam_model=self.cam_model, on_device=on_device,
        )

    def _queue_keyframe(self, kf_id: int, ts: float, feats, track_res) -> None:
        """The deferred keyframe (the JAX package's pipelined branch,
        system.py:1589-1606): its work queued with no host read (the keyframe
        program, or the eager work with the local BA in its device form; the
        pose is the frame's tracked pose on the device, the same values as
        the host's copy), then (admitted points, refined pose, BA
        iterations) copied to the host without a wait."""
        # No host read may hide in here (an ``int()`` of a tensor, a ``.cpu()``,
        # an upload from pageable memory): the pose is the device copy, not
        # the host's R_cur / t_cur, and the counts stay 0-d tensors.
        feats, feat_pt, R, t = self._to_map_dev((feats, track_res.feat_pt, track_res.R,
                                                 track_res.t))
        if self._fused_keyframe(kf_id):
            host = self._run_kf_program(kf_id, ts, feats, feat_pt, R, t, defer=True)
        else:
            self.map, n_new, iters = self._keyframe_work(kf_id, ts, feats, feat_pt, R, t,
                                                         on_device=True)
            f32 = torch.float32
            host = HostCopy(torch.cat([
                n_new.to(f32).reshape(1), self.map.kf_R[kf_id].reshape(9),
                self.map.kf_t[kf_id], iters.to(f32).reshape(1),
            ]))
        self._kf_async = (kf_id, host)
        self.pipe_counts["kf_deferred"] += 1

    def _apply_kf_async(self, force: bool = False) -> None:
        """Absorb a deferred keyframe's results (the JAX package's
        ``_apply_kf_async``): the admitted points, the refined pose into the
        reference-pose cache while that keyframe is still the newest, the
        BA's iterations, then the loop closer's check of the keyframe.
        Unforced, only once its copy has landed: the frame loop never waits
        for it."""
        d = self._kf_async
        if d is None:
            return
        kf_id, host = d
        if not force and not host.ready():
            return
        self._kf_async = None
        v = host.get()
        self._n_pts += int(v[0])
        self.ba_iters.append(int(v[13]))
        if self.n_kf - 1 == kf_id and (self._ref_cache is None or self._ref_cache[0] == kf_id):
            self._set_ref_cache(kf_id, v[1:10].reshape(3, 3).copy(), v[10:13].copy())
        self._close_loop(kf_id)

    def _temporal_window(self, n_kf: int):
        """The local-BA window of ``covis_ba=False`` over keyframe slots
        [0, n_kf): the last ``ba_window`` free, the ``ba_fixed`` before them
        fixed, slot 0 always fixed; with only slot 0 fixed, the oldest slot
        of the window is fixed too (mono gauge). Padded with the empty last
        slot to ``ba_window + ba_fixed`` entries. Returns (window_ids,
        fixed_mask, None)."""
        free_lo = max(0, n_kf - self.ba_window)
        fix_lo = max(0, free_lo - self.ba_fixed)
        ids = list(range(fix_lo, n_kf))
        fixed = [i < free_lo or i == 0 for i in ids]
        if sum(fixed) == (1 if 0 in ids else 0):
            fixed[0] = True
        pad = self.W - len(ids)
        if pad > 0:
            ids = ids + [self.K_cap - 1] * pad  # an empty slot (kf_valid False)
            fixed = fixed + [True] * pad
        dev = self.device
        return (
            torch.as_tensor(np.asarray(ids[: self.W], np.int32), device=dev),
            torch.as_tensor(np.asarray(fixed[: self.W], bool), device=dev),
            None,
        )

    def _run_local_ba(self, n_iters: int) -> None:
        """Local BA around the newest keyframe: the covisibility window
        (``covis_ba``) or the temporal one."""
        if self.covis_ba:
            window = local_mapping.select_covis_window(
                self.map, self.n_kf - 1, self.ba_window, self.ba_fixed
            )
        else:
            window = self._temporal_window(self.n_kf)
        self.map, iters = local_mapping.local_ba(self.map, window, self.cam_params, n_iters,
                                                 self.bf, self.cam_model)
        self.ba_iters.append(iters)
