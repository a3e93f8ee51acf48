"""Device-resident visual-inertial chunk loop — port of
``orb_slam3_ros_tpu.models.vi_device_loop``.

The steady mono-inertial state (all three IMU-initialization stages done,
tracking OK, a full temporal window) runs frame after frame on the device:
per frame, preintegration of the frame's IMU block -> state prediction ->
extraction -> tracking -> 15-dof VI refinement -> the keyframe decision; per
keyframe, insertion -> triangulation -> admission -> fusion ->
temporal-window VI-BA -> culls, with the JAX package's IMU bookkeeping: the
since-last-keyframe block ``blk`` (its fill ``blk_n``, ``blk_ok`` False
after an overflow), the per-keyframe edge blocks ``kf_blk`` with
``kf_edge_ok``, and the anchor body state with its covariance ``Sigma``.

``VIChunkRunner`` runs it on ``chunk_runner.ChunkRunner``'s machinery: on
the card one CUDA graph of the frame step per tracking schedule, and the
keyframe body in six segments, of which the fuse, stats and cull segments
are replayed only at the keyframe ids that call for them (ids the host
knows); after each step the host reads two words, ``(need_kf, alive)``.

The keyframe bodies (``insert_admit``, ``kf_fuse``, ``window_ba``,
``kf_stats``, ``kf_cull``) are also the per-frame path's VI keyframe
program's (``vi_kf_program``); the chunk gathers its window and its
keyframe's body state on the device, the program takes the host's.

A frame whose refinement keeps fewer than 15 inliers ends the chunk: its
step leaves the body state as it was, and the host replays it and the
frames after it one at a time, from the state of the last tracked frame.

The stereo branch (``VIChunkConfig.stereo``, the stereo-inertial
system's chunks): a frame is a [2, H, W] rectified pair whose step extracts
both views and runs ``stereo.match_stereo`` (``chunk_runner.prep_frame``);
the keyframe body inserts with each feature's u_r, creates the close
landmarks from stereo depth before triangulating, and its VI-BA builds
(u, v, u_r) rows with ``bf``. The 15-dof refinement stays monocular, as on
the per-frame path once the IMU gives metric scale.

``VIChunkConfig.cam_model`` "kb8" runs the same graphs on raw fisheye
frames: KB8 projection in tracking, the 15-dof refinement, admission,
fusion and the window's VI-BA. A runner belongs to one system, so its
graphs are captured per (tracking schedule, camera model), as the JAX
package caches its chunk program per (schedule, cam_model).

Not ported (ROADMAP "Do not port"): the tunnel's packing
(``unpack_vi_dev_state``, ``pack_vi_chunk_result``) and the
``ORB_BATCH_EXTRACT`` branch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import imu as imu_ops
from ..ops import orb, viba
from . import local_mapping, map_updates, tracking
from .chunk_runner import ChunkRunner, admit_keyframe_points, frame_row, prep_frame
from .map_state import MapState, kf_index


class VIDevState(NamedTuple):
    """Inertial side state carried from frame to frame and chunk to chunk."""

    R_wb: torch.Tensor  # [3,3] previous frame's body rotation (anchor)
    p_wb: torch.Tensor  # [3]
    v: torch.Tensor  # [3]
    bg: torch.Tensor  # [3]
    ba: torch.Tensor  # [3]
    Sigma: torch.Tensor  # [15,15] anchor posterior covariance (zeros = exact)
    blk: torch.Tensor  # [S,7] IMU samples (acc | gyro | dt) since the last keyframe
    blk_n: torch.Tensor  # [] int32 fill count
    blk_ok: torch.Tensor  # [] bool, False after an overflow (chain break)
    kf_blk: torch.Tensor  # [K,S,7] per-keyframe edge blocks (k integrates k-1 -> k)
    kf_edge_ok: torch.Tensor  # [K] bool


class VICarry(NamedTuple):
    m: MapState
    st: VIDevState
    n_kf: torch.Tensor  # [] int32
    n_pts: torch.Tensor  # [] int32
    last_kf_fid: torch.Tensor  # [] int32
    alive: torch.Tensor  # [] bool
    # Inliers at the reference keyframe for the thRefRatio rule (-1:
    # unseeded, the first frame's count is taken).
    ref_inl: torch.Tensor  # [] int32


class VIChunkConfig(NamedTuple):
    """The static settings of one system's chunk (``InertialSlam``'s)."""

    config: orb.ExtractorConfig
    cam_params: torch.Tensor
    calib: imu_ops.ImuCalib
    width: int
    height: int
    kf_every: int
    kf_min_inliers: int
    kf_ref_ratio: float
    W: int  # temporal VI-BA window (keyframes)
    ba_window: int  # its free keyframes
    local_ba_iters: int
    fuse_neighbors: int
    fuse_every: int
    stats_every: int
    cull_every: int
    kf_culling: bool
    K_cap: int
    imu_cap_frame: int
    imu_cap_kf: int
    track_cap: int | None
    # The stereo branch (``device_loop.ChunkConfig``'s fields of that name).
    bf: float = 0.0
    baseline: float = 0.0
    max_depth: float = 0.0
    stereo: bool = False
    fx: float = 0.0
    # the camera (``device_loop.ChunkConfig.cam_model``): a runner, and so
    # its graphs, belongs to one system and so to one camera model
    cam_model: str = "pinhole"


def need_keyframe(ok, n_vis, since, ref_inl, n_kf, *, K_cap, kf_every, kf_min_inliers,
                  kf_ref_ratio, min_kf: int = 0):
    """The chunk's keyframe rule (JAX ``vi_device_loop.py:357-372``; the
    monocular chunk's, ``device_loop.py:262-281``, adds ``min_kf`` = 2): a
    tracked frame under capacity with at least ``min_kf`` keyframes,
    ``kf_every`` frames after the last keyframe, or two frames after it when
    tracking weakens (under ``kf_min_inliers``, or under ``kf_ref_ratio`` of
    the reference keyframe's inliers: NeedNewKeyFrame's thRefRatio,
    Tracking.cc:3103). 0-d tensors in, a 0-d bool tensor out."""
    weak = (n_vis < kf_min_inliers) & (since >= 2)
    if kf_ref_ratio > 0.0:
        weak = weak | (
            (n_vis.to(torch.float32) < kf_ref_ratio * ref_inl.to(torch.float32)) & (since >= 2)
        )
    if min_kf > 0:
        ok = ok & (n_kf >= min_kf)
    return ok & (n_kf < K_cap) & ((since >= kf_every) | weak)


class VIFrame(NamedTuple):
    """What ``vi_frame`` computes for one frame."""

    feats: orb.Features
    ur: torch.Tensor | None  # stereo: each feature's right-image x (-1: none)
    depth: torch.Tensor | None
    res: tracking.TrackResult
    vires: viba.PoseInertialResult
    R_cw: torch.Tensor  # the refined pose
    t_cw: torch.Tensor
    R_pred: torch.Tensor  # the IMU prediction tracking started from
    t_pred: torch.Tensor


def vi_frame(m: MapState, img, imu, R_wb, p_wb, v, bg, ba, Sigma, cfg, schedule: tuple) -> VIFrame:
    """One VI frame against map ``m`` (the JAX package's
    ``_vi_fused_program`` and the first half of its chunk's scan body):
    preintegrate the frame's IMU block ``imu`` [M, 7] (acc | gyro | dt,
    zero rows as padding) at the anchor's bias, predict the state from the
    anchor (R_wb, p_wb, v, bg, ba) (PredictStateIMU, Tracking.cc:1774),
    extract (``chunk_runner.prep_frame``), track from the prediction, then
    the 15-dof refinement against the map and the preintegration factor,
    the anchor's covariance ``Sigma`` [15, 15] (zeros: exact) marginalized
    in. ``cfg``: a chunk or VI frame configuration."""
    from .inertial_system import _vi_refine

    calib = cfg.calib
    b = torch.cat([bg, ba])
    pre = imu_ops.preintegrate(imu[:, 0:3], imu[:, 3:6], imu[:, 6], b, calib)
    R2, p2, _ = imu_ops.predict_state(R_wb, p_wb, v, b, pre)
    R_pred, t_pred = viba.cam_from_body(R2, p2, calib.R_bc, calib.t_bc)
    feats, ur, depth = prep_frame(img, cfg)
    res = tracking.track_against_map(
        m, feats, R_pred, t_pred, cfg.cam_params, cfg.width, cfg.height,
        schedule=schedule, track_cap=cfg.track_cap, cam_model=cfg.cam_model,
    )
    vires, R_cw, t_cw = _vi_refine(
        m, feats, res.feat_pt, res.R, res.t, v, bg, ba,
        R_wb, p_wb, v, bg, ba, pre, Sigma, cfg.cam_params,
        calib.R_bc, calib.t_bc, cfg.cam_model,
    )
    return VIFrame(feats=feats, ur=ur, depth=depth, res=res, vires=vires, R_cw=R_cw, t_cw=t_cw,
                   R_pred=R_pred, t_pred=t_pred)


def frame_step(c: VICarry, img, x_in, cfg: VIChunkConfig, schedule: tuple):
    """One frame: the JAX chunk's scan body up to its keyframe branch.
    ``img`` [H, W], or [2, H, W] with ``cfg.stereo`` (any real dtype,
    values in [0, 255]); ``x_in``
    [M*7 + 2] f32: the frame's IMU block (acc | gyro | dt rows, zero rows
    as padding), its timestamp and its frame id. Returns (carry, fr):
    ``fr`` holds what a keyframe at this frame needs (``f_*`` features,
    pose, ``kf_id``) and the frame's ``row`` and ``flags`` (need_kf,
    alive). The carry already counts the keyframe the flags call for."""
    M, S = cfg.imu_cap_frame, cfg.imu_cap_kf
    dev = img.device
    imu = x_in[: M * 7].reshape(M, 7)
    ts = x_in[M * 7]
    fid = x_in[M * 7 + 1].to(torch.int32)
    d = imu[:, 6]
    st = c.st
    # Append the frame's samples to the since-last-keyframe block; samples
    # past its capacity go to a spare row that is cut off (the JAX
    # package's mode="drop").
    idx = st.blk_n + torch.arange(M, dtype=torch.int32, device=dev)
    dst = torch.where((d > 0) & (idx < S), idx, S).long()
    blk = torch.cat([st.blk, st.blk[:1]]).index_copy_(0, dst, imu)[:S]
    n_valid = torch.sum(d > 0, dtype=torch.int32)
    blk_ok = st.blk_ok & (st.blk_n + n_valid <= S)
    blk_n = torch.clamp(st.blk_n + n_valid, max=S)
    f = vi_frame(c.m, img, imu, st.R_wb, st.p_wb, st.v, st.bg, st.ba, st.Sigma, cfg, schedule)
    feats, ur, depth, res, vires, R_cw, t_cw, R_pred, t_pred = f
    n_vis = vires.n_inliers
    ok = c.alive & (n_vis >= 15)

    def keep(new, old):
        return torch.where(ok, new, old)

    # The anchor advances to the refined state with its posterior
    # covariance (the per-frame path's _vi_anchor / _vi_prior).
    st2 = VIDevState(
        R_wb=keep(vires.R_wb, st.R_wb), p_wb=keep(vires.p_wb, st.p_wb),
        v=keep(vires.v_w, st.v), bg=keep(vires.bg, st.bg), ba=keep(vires.ba, st.ba),
        Sigma=keep(vires.Sigma, st.Sigma), blk=keep(blk, st.blk),
        blk_n=keep(blk_n, st.blk_n), blk_ok=keep(blk_ok, st.blk_ok),
        kf_blk=st.kf_blk, kf_edge_ok=st.kf_edge_ok,
    )
    m = map_updates.update_track_counters(c.m, res.visible_mask & ok, res.found_mask & ok)
    since = fid - c.last_kf_fid
    ref_inl = torch.where(c.ref_inl < 0, n_vis, c.ref_inl)
    need_kf = need_keyframe(
        ok, n_vis, since, ref_inl, c.n_kf, K_cap=cfg.K_cap, kf_every=cfg.kf_every,
        kf_min_inliers=cfg.kf_min_inliers, kf_ref_ratio=cfg.kf_ref_ratio,
    )
    n_inl = torch.where(c.alive, n_vis, torch.zeros_like(n_vis))
    fr = dict(
        f_xy=feats.xy, f_level=feats.level, f_angle=feats.angle, f_desc=feats.desc_sign,
        f_valid=feats.valid, f_pt=res.feat_pt,
        kf_R=torch.where(ok, R_cw, R_pred), kf_t=torch.where(ok, t_cw, t_pred),
        kf_ts=ts, kf_id=c.n_kf, n_vis=n_vis,
        # rewritten by kf_end on a keyframe
        row=frame_row(m, c.n_kf - 1, R_cw, t_cw, n_inl, need_kf, ok),
        flags=torch.stack([need_kf, ok]).to(torch.int32),
    )
    if cfg.stereo:
        fr.update(f_ur=ur, f_depth=depth)
    c2 = VICarry(
        m=m, st=st2, n_kf=c.n_kf + need_kf.to(torch.int32), n_pts=c.n_pts,
        last_kf_fid=torch.where(need_kf, fid, c.last_kf_fid), alive=ok,
        ref_inl=torch.where(need_kf, n_vis, ref_inl),
    )
    return c2, fr


def _kf_feats(fr: dict) -> orb.Features:
    return orb.Features(
        xy=fr["f_xy"], level=fr["f_level"], angle=fr["f_angle"], response=None,
        desc_packed=None, desc_sign=fr["f_desc"], valid=fr["f_valid"],
    )


def insert_admit(m: MapState, fr: dict, v, bg, ba, n_pts, cfg):
    """Insert the keyframe ``fr`` describes (``fr["kf_id"]``, its pose,
    timestamp and features; with ``cfg.stereo`` its features' u_r) with its
    body state (v, bg, ba), then admit its new points from slot ``n_pts``
    on (``chunk_runner.admit_keyframe_points``; depth first with
    ``cfg.stereo``). What the chunk's ``kf_insert`` and the per-frame
    keyframe program (``vi_kf_program``) share. Returns (map, points
    admitted as a 0-d tensor)."""
    kf_id = fr["kf_id"]
    k = kf_index(kf_id, m.kf_R.device)
    m = map_updates.insert_keyframe(
        m, kf_id, fr["kf_R"], fr["kf_t"], fr["kf_ts"], _kf_feats(fr), fr["f_pt"],
        ur=fr["f_ur"] if cfg.stereo else None,
    )
    m.kf_v.index_copy_(0, k, v[None])
    m.kf_bg.index_copy_(0, k, bg[None])
    m.kf_ba.index_copy_(0, k, ba[None])
    return admit_keyframe_points(
        m, kf_id, fr["kf_R"], fr["kf_t"], fr["f_xy"], fr["f_valid"],
        fr["f_depth"] if cfg.stereo else None, n_pts, m.P - n_pts, cfg.cam_params,
        cfg.max_depth, cfg.cam_model,
    )


def kf_insert(c: VICarry, fr: dict, cfg: VIChunkConfig) -> VICarry:
    """Keyframe segment 1: snapshot the since-last-keyframe IMU block into
    ``kf_blk[kf_id]``, insert the keyframe with its body state (v, bg, ba)
    (and its features' u_r in a stereo chunk) and admit its new points
    (``insert_admit``)."""
    st = c.st
    S = cfg.imu_cap_kf
    k = kf_index(fr["kf_id"], st.blk.device)
    filled = torch.arange(S, device=st.blk.device) < st.blk_n
    st.kf_blk.index_copy_(0, k, torch.where(filled[:, None], st.blk, 0.0)[None])
    st.kf_edge_ok.index_copy_(0, k, st.blk_ok.reshape(1))
    m, n_new = insert_admit(c.m, fr, st.v, st.bg, st.ba, c.n_pts, cfg)
    return c._replace(m=m, n_pts=c.n_pts + n_new)


def kf_fuse(c: VICarry, fr: dict, cfg: VIChunkConfig) -> VICarry:
    """Keyframe segment 2: landmark fusion with the most covisible keyframes."""
    m, _ = map_updates.fuse_in_neighbors(
        c.m, fr["kf_id"], cfg.cam_params, cfg.width, cfg.height, n_neighbors=cfg.fuse_neighbors,
        cam_model=cfg.cam_model,
    )
    return c._replace(m=m)


def window_ba(m: MapState, ids, fixed, blocks, edge_ok, last, cfg) -> MapState:
    """The temporal-window VI-BA over keyframes ``ids`` [W] (``fixed`` [W]
    held), the inertial edge ids[i] -> ids[i+1] from ``blocks[i]``
    [S, 7] where ``edge_ok[i]``; its write-back, then point culling with
    ``last`` keyframes. What the chunk's ``kf_ba`` and the per-frame
    keyframe program (``vi_kf_program``) share."""
    prob = local_mapping.build_vi_ba(
        m, ids, fixed, blocks[..., 0:3], blocks[..., 3:6], blocks[..., 6], edge_ok, cfg.calib,
        cfg.cam_params, bf=cfg.bf,
    )
    res = viba.vi_bundle_adjust(prob, n_iters=cfg.local_ba_iters, cam_model=cfg.cam_model)
    m = local_mapping.apply_vi_ba(m, ids, res, cfg.calib)
    return map_updates.cull_points(m, last)


def kf_ba(c: VICarry, fr: dict, cfg: VIChunkConfig) -> VICarry:
    """Keyframe segment 3: the temporal window over the last W keyframes,
    the new one included (LocalInertialBA's mPrevKF chain,
    Optimizer.cc:2532), with its ids, fixed mask and IMU blocks gathered on
    the device (``window_ba``). The host gates chunking on n_kf > W, so the
    window is always full."""
    st = c.st
    last = fr["kf_id"] + 1
    ids = last - cfg.W + torch.arange(cfg.W, dtype=torch.int32, device=st.blk.device)
    fixed = (ids == 0) | (ids < last - cfg.ba_window)
    edge = ids[1:].long()
    m = window_ba(c.m, ids, fixed, st.kf_blk.index_select(0, edge),
                  st.kf_edge_ok.index_select(0, edge), last, cfg)
    return c._replace(m=m)


def kf_stats(c: VICarry, fr: dict, cfg: VIChunkConfig) -> VICarry:
    """Keyframe segment 4: representative descriptors, normals, bands."""
    return c._replace(m=map_updates.refresh_point_stats(c.m, n_levels=cfg.config.n_levels))


def kf_cull(c: VICarry, fr: dict, cfg: VIChunkConfig) -> VICarry:
    """Keyframe segment 5: keyframe culling."""
    m, _ = map_updates.cull_keyframes(c.m, fr["kf_id"] + 1, n_levels=cfg.config.n_levels)
    return c._replace(m=m)


def kf_end(c: VICarry, fr: dict, cfg: VIChunkConfig):
    """Keyframe segment 6: a fresh anchor from the BA-refined keyframe
    state, exact (Sigma = 0), an empty since-last-keyframe block, and the
    frame's row with the keyframe's refined pose. Returns (carry, fr)."""
    m, st, kf_id = c.m, c.st, fr["kf_id"]
    k = kf_index(kf_id, st.blk.device)

    def row(t):
        return t.index_select(0, k)[0]

    R, t = row(m.kf_R), row(m.kf_t)
    R_wb, p_wb = viba.body_from_cam(R, t, cfg.calib.R_bc, cfg.calib.t_bc)
    st2 = st._replace(
        R_wb=R_wb, p_wb=p_wb, v=row(m.kf_v), bg=row(m.kf_bg), ba=row(m.kf_ba),
        Sigma=torch.zeros_like(st.Sigma), blk=torch.zeros_like(st.blk),
        blk_n=torch.zeros_like(st.blk_n), blk_ok=torch.ones_like(st.blk_ok),
    )
    one = torch.ones((), dtype=torch.int32, device=R.device)
    fr = dict(fr, row=frame_row(m, kf_id, R, t, fr["n_vis"], one, one))
    return c._replace(st=st2), fr


KF_SEGMENTS = {
    "kf_insert": kf_insert, "kf_fuse": kf_fuse, "kf_ba": kf_ba, "kf_stats": kf_stats,
    "kf_cull": kf_cull, "kf_end": kf_end,
}


class VIChunkRunner(ChunkRunner):
    """Runs chunks of the steady mono-inertial state (``ChunkRunner``): the
    buffers hold the map, the inertial state and the carry scalars besides
    the frame's inputs, an IMU block, its timestamp and id a frame."""

    CARRY = VICarry
    NESTED = {"m": MapState, "st": VIDevState}
    SEGMENTS = KF_SEGMENTS

    @staticmethod
    def step(c, img, x_in, cfg, schedule):
        return frame_step(c, img, x_in, cfg, schedule)

    def x_len(self) -> int:
        return self.cfg.imu_cap_frame * 7 + 2

    def load(self, m: MapState, st: VIDevState, n_kf: int, n_pts: int, last_kf_fid: int,
             ref_inl: int) -> None:
        """Put a chunk's starting state into the buffers (``ChunkRunner._load``)."""
        self._load(VICarry(m=m, st=st, n_kf=n_kf, n_pts=n_pts, last_kf_fid=last_kf_fid,
                           alive=1, ref_inl=ref_inl))
