"""Device-resident monocular chunk loop — port of
``orb_slam3_ros_tpu.models.device_loop``.

The steady monocular state (tracking OK on a map of at least
``lean_after_kf`` keyframes) runs frame after frame on the device: per
frame, the constant-velocity prediction -> extraction -> tracking (with
``track_window``'s point mask) -> the keyframe decision; per keyframe,
insertion -> triangulation against the previous keyframe -> admission ->
fusion -> covisibility local BA -> point culling -> point statistics ->
keyframe culling, then the frame adopts its keyframe's BA-refined pose.

``MonoChunkRunner`` runs it on ``chunk_runner.ChunkRunner``'s machinery: on
the card one CUDA graph of the frame step per tracking schedule and the
keyframe body in six segments (``kf_insert``, ``kf_fuse``, ``kf_ba``,
``kf_stats``, ``kf_cull``, ``kf_end``), the fuse, stats and cull segments
replayed only at the keyframe ids that call for them; after each step the
host reads two words, ``(need_kf, alive)``. The local BA stops at
``rel_tol`` 1e-3 by freezing its state on the device
(``ba.bundle_adjust(on_device=True)``), as the JAX package's ``while_loop``
does.

``ChunkConfig.cam_model`` "kb8" runs the same graphs on raw fisheye
frames: KB8 projection and Jacobians in tracking, fusion and the local BA,
and triangulation gated on bearings (``MonoSlam(cam_model="kb8")``).

A frame with fewer than 15 inliers ends the chunk: its step leaves the
state as it was, and the host replays it and the frames after it one at a
time (the JAX scan runs on past it with the state frozen; the frames the
host replays are the same).

The stereo branch (``ChunkConfig.stereo``, the stereo system's chunks):
a frame is a [2, H, W] rectified pair; the step extracts both views, runs
``stereo.match_stereo`` and, after tracking, refines the pose over mixed
(u, v, u_r) edges (``pose_optimization_stereo``); the keyframe body inserts
with each feature's u_r, creates the close landmarks from stereo depth
(Tracking::CreateNewKeyFrame, Tracking.cc:3255) before triangulating, and
its local BA builds (u, v, u_r) rows with ``bf``. The same seven graphs,
the same two-word read a frame.

Not ported (ROADMAP "Do not port"): the tunnel's packing
(``pack_chunk_result`` / ``unpack_chunk_result``), ``_prep_xs`` and the
``ORB_BATCH_EXTRACT`` knob.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import orb
from . import local_mapping, map_updates, tracking
from .chunk_runner import ChunkRunner, admit_keyframe_points, frame_row, prep_frame
from .map_state import MapState, kf_index
from .vi_device_loop import need_keyframe


class LoopCarry(NamedTuple):
    m: MapState
    R: torch.Tensor  # [3,3] current Tcw
    t: torch.Tensor  # [3]
    vel_R: torch.Tensor  # [3,3] constant-velocity motion (T_cur T_last^-1)
    vel_t: torch.Tensor  # [3]
    n_kf: torch.Tensor  # [] int32
    n_pts: torch.Tensor  # [] int32
    last_kf_fid: torch.Tensor  # [] int32
    alive: torch.Tensor  # [] bool, False after a tracking failure
    # Inliers at the reference keyframe for the thRefRatio rule (-1:
    # unseeded, the first frame's count is taken).
    ref_inl: torch.Tensor  # [] int32


class ChunkConfig(NamedTuple):
    """The static settings of one system's chunk (``MonoSlam``'s)."""

    config: orb.ExtractorConfig
    cam_params: torch.Tensor
    width: int
    height: int
    kf_every: int
    kf_min_inliers: int
    kf_ref_ratio: float
    ba_window: int
    ba_fixed: int
    local_ba_iters: int
    fuse_neighbors: int
    fuse_every: int
    stats_every: int
    cull_every: int
    kf_culling: bool
    K_cap: int
    track_cap: int | None
    track_window: int | None
    # The stereo branch: fx * baseline of the u_r rows (0: none), the rig's
    # baseline and fx, the depth below which a keyframe creates landmarks
    # from stereo depth, and whether a frame is a [2, H, W] pair.
    bf: float = 0.0
    baseline: float = 0.0
    max_depth: float = 0.0
    stereo: bool = False
    fx: float = 0.0
    # The camera of every projection, triangulation and BA row (pinhole |
    # kb8: raw fisheye pixels).
    cam_model: str = "pinhole"


def frame_step(c: LoopCarry, img, x_in, cfg: ChunkConfig, schedule: tuple):
    """One frame: the JAX chunk's scan body up to its keyframe branch
    (``device_loop.py:216-281``). ``img`` [H, W], or [2, H, W] with
    ``cfg.stereo`` (any real dtype, values in [0, 255]); ``x_in`` [2] f32:
    the frame's timestamp and id. Returns (carry, fr): ``fr`` holds what a
    keyframe at this frame needs (``f_*`` features, the tracked pose,
    ``kf_id``) and the frame's ``row`` and ``flags`` (need_kf, alive). The
    carry already counts the keyframe the flags call for."""
    ts = x_in[0]
    fid = x_in[1].to(torch.int32)
    R_pred = c.vel_R @ c.R
    t_pred = c.vel_R @ c.t + c.vel_t
    feats, ur, depth = prep_frame(img, cfg)
    pt_mask = None
    if cfg.track_window is not None:
        pt_mask = c.m.pt_first_kf >= (c.n_kf - cfg.track_window)
    res = tracking.track_against_map(
        c.m, feats, R_pred, t_pred, cfg.cam_params, cfg.width, cfg.height,
        pt_mask=pt_mask, schedule=schedule, track_cap=cfg.track_cap, cam_model=cfg.cam_model,
    )
    if cfg.stereo:
        from .stereo_system import _stereo_refine

        r2 = _stereo_refine(c.m, feats, res.feat_pt, ur, res.R, res.t, cfg.cam_params, cfg.bf)
        res = res._replace(R=r2.R, t=r2.t, n_inliers=r2.n_inliers)
    n_inl = res.n_inliers
    ok = c.alive & (n_inl >= 15)
    R_new = torch.where(ok, res.R, c.R)
    t_new = torch.where(ok, res.t, c.t)
    dR = res.R @ c.R.T
    vel_R = torch.where(ok, dR, c.vel_R)
    vel_t = torch.where(ok, res.t - dR @ c.t, c.vel_t)
    m = map_updates.update_track_counters(c.m, res.visible_mask & ok, res.found_mask & ok)
    since = fid - c.last_kf_fid
    ref_inl = torch.where(c.ref_inl < 0, n_inl, c.ref_inl)
    need_kf = need_keyframe(
        ok, n_inl, since, ref_inl, c.n_kf, K_cap=cfg.K_cap, kf_every=cfg.kf_every,
        kf_min_inliers=cfg.kf_min_inliers, kf_ref_ratio=cfg.kf_ref_ratio, min_kf=2,
    )
    fr = dict(
        f_xy=feats.xy, f_level=feats.level, f_angle=feats.angle, f_desc=feats.desc_sign,
        f_valid=feats.valid, f_pt=res.feat_pt, kf_R=R_new, kf_t=t_new, kf_ts=ts,
        kf_id=c.n_kf, n_vis=n_inl,
        # rewritten by kf_end on a keyframe
        row=frame_row(m, c.n_kf - 1, R_new, t_new,
                      torch.where(c.alive, n_inl, torch.zeros_like(n_inl)), need_kf, ok),
        flags=torch.stack([need_kf, ok]).to(torch.int32),
    )
    if cfg.stereo:
        fr.update(f_ur=ur, f_depth=depth)
    c2 = LoopCarry(
        m=m, R=R_new, t=t_new, vel_R=vel_R, vel_t=vel_t,
        n_kf=c.n_kf + need_kf.to(torch.int32), n_pts=c.n_pts,
        last_kf_fid=torch.where(need_kf, fid, c.last_kf_fid), alive=ok,
        ref_inl=torch.where(need_kf, n_inl, ref_inl),
    )
    return c2, fr


def _kf_feats(fr: dict) -> orb.Features:
    return orb.Features(
        xy=fr["f_xy"], level=fr["f_level"], angle=fr["f_angle"], response=None,
        desc_packed=None, desc_sign=fr["f_desc"], valid=fr["f_valid"],
    )


def insert_admit(m: MapState, fr: dict, n_pts, cfg):
    """Insert the keyframe ``fr`` describes (``fr["kf_id"]``, its pose,
    timestamp and features; with ``cfg.stereo`` its features' u_r), then
    admit its new points from slot ``n_pts`` on
    (``chunk_runner.admit_keyframe_points``; depth first with
    ``cfg.stereo``). What the chunk's ``kf_insert`` and the per-frame
    keyframe program (``kf_program``) share. Returns (map, points admitted
    as a 0-d tensor)."""
    kf_id = fr["kf_id"]
    m = map_updates.insert_keyframe(
        m, kf_id, fr["kf_R"], fr["kf_t"], fr["kf_ts"], _kf_feats(fr), fr["f_pt"],
        ur=fr["f_ur"] if cfg.stereo else None,
    )
    return admit_keyframe_points(
        m, kf_id, fr["kf_R"], fr["kf_t"], fr["f_xy"], fr["f_valid"],
        fr["f_depth"] if cfg.stereo else None, n_pts, m.P - n_pts, cfg.cam_params,
        cfg.max_depth, cfg.cam_model,
    )


def kf_insert(c: LoopCarry, fr: dict, cfg: ChunkConfig) -> LoopCarry:
    """Keyframe segment 1: insert the keyframe at its tracked pose (with
    its features' u_r in a stereo chunk) and admit its new points
    (``insert_admit``)."""
    m, n_new = insert_admit(c.m, fr, c.n_pts, cfg)
    return c._replace(m=m, n_pts=c.n_pts + n_new)


def kf_fuse(c: LoopCarry, fr: dict, cfg: ChunkConfig) -> LoopCarry:
    """Keyframe segment 2: landmark fusion with the most covisible keyframes."""
    m, _ = map_updates.fuse_in_neighbors(
        c.m, fr["kf_id"], cfg.cam_params, cfg.width, cfg.height, n_neighbors=cfg.fuse_neighbors,
        cam_model=cfg.cam_model,
    )
    return c._replace(m=m)


def covis_ba(m: MapState, kf_id, cfg: ChunkConfig):
    """The covisibility window around keyframe ``kf_id``, its local BA
    (stopping at rel_tol 1e-3 on the device), the write-back, the outlier
    observations unbound, then point culling with ``kf_id + 1`` keyframes.
    What the chunk's ``kf_ba`` and the per-frame keyframe program
    (``kf_program``) share. Returns (map, LM iterations run as a 0-d int32
    tensor)."""
    window = local_mapping.select_covis_window(m, kf_id, cfg.ba_window, cfg.ba_fixed)
    m, iters = local_mapping.local_ba(m, window, cfg.cam_params, cfg.local_ba_iters, cfg.bf,
                                      cfg.cam_model, on_device=True)
    return map_updates.cull_points(m, kf_id + 1), iters


def kf_ba(c: LoopCarry, fr: dict, cfg: ChunkConfig) -> LoopCarry:
    """Keyframe segment 3: the covisibility local BA and point culling
    (``covis_ba``)."""
    return c._replace(m=covis_ba(c.m, fr["kf_id"], cfg)[0])


def kf_stats(c: LoopCarry, fr: dict, cfg: ChunkConfig) -> LoopCarry:
    """Keyframe segment 4: representative descriptors, normals, bands."""
    return c._replace(m=map_updates.refresh_point_stats(c.m, n_levels=cfg.config.n_levels))


def kf_cull(c: LoopCarry, fr: dict, cfg: ChunkConfig) -> LoopCarry:
    """Keyframe segment 5: keyframe culling."""
    m, _ = map_updates.cull_keyframes(c.m, fr["kf_id"] + 1, n_levels=cfg.config.n_levels)
    return c._replace(m=m)


def kf_end(c: LoopCarry, fr: dict, cfg: ChunkConfig):
    """Keyframe segment 6: the frame adopts its keyframe's BA-refined pose
    (the velocity stays the tracked one, as in the JAX chunk). Returns
    (carry, fr) with the frame's row rewritten."""
    m, kf_id = c.m, fr["kf_id"]
    k = kf_index(kf_id, m.kf_R.device)
    R, t = m.kf_R.index_select(0, k)[0], m.kf_t.index_select(0, k)[0]
    one = torch.ones((), dtype=torch.int32, device=R.device)
    fr = dict(fr, row=frame_row(m, kf_id, R, t, fr["n_vis"], one, one))
    return c._replace(R=R, t=t), fr


KF_SEGMENTS = {
    "kf_insert": kf_insert, "kf_fuse": kf_fuse, "kf_ba": kf_ba, "kf_stats": kf_stats,
    "kf_cull": kf_cull, "kf_end": kf_end,
}


class MonoChunkRunner(ChunkRunner):
    """Runs chunks of the steady monocular state (``ChunkRunner``): the
    buffers hold the map, the pose and motion model and the carry scalars
    besides the frame's inputs, its timestamp and id."""

    CARRY = LoopCarry
    NESTED = {"m": MapState}
    SEGMENTS = KF_SEGMENTS

    @staticmethod
    def step(c, img, x_in, cfg, schedule):
        return frame_step(c, img, x_in, cfg, schedule)

    def x_len(self) -> int:
        return 2

    def load(self, m: MapState, pose: torch.Tensor, n_kf: int, n_pts: int, last_kf_fid: int,
             ref_inl: int) -> None:
        """Put a chunk's starting state into the buffers: ``pose`` [24] is
        (R, t, vel_R, vel_t) flattened, on the device."""
        self._load(LoopCarry(
            m=m, R=pose[0:9].reshape(3, 3), t=pose[9:12], vel_R=pose[12:21].reshape(3, 3),
            vel_t=pose[21:24], n_kf=n_kf, n_pts=n_pts, last_kf_fid=last_kf_fid, alive=1,
            ref_inl=ref_inl,
        ))
