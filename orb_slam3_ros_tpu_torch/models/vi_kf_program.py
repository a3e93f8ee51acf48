"""The visual-inertial keyframe program of the per-frame path — port of the
JAX package's ``_vi_kf_work`` (``models/inertial_system.py:32-105``) as
``InertialSlam._insert_keyframe_vi_fused`` runs it: one dispatch and one
packed host read a keyframe once the IMU is initialized.

``VIKeyframeProgram`` runs the keyframe as regions of
``chunk_runner.GraphRegions``, in the order and under the names of the VI
chunk's keyframe segments (``chunk_runner.kf_segments``): insert + admit,
fuse, BA + point cull, stats, keyframe cull, end; the fuse, stats and cull
regions run only at the keyframe ids that call for them, as the JAX body's
static branches do. The region bodies are the chunk's
(``vi_device_loop.insert_admit``, ``kf_fuse``, ``window_ba``, ``kf_stats``,
``kf_cull``); what differs is where their inputs come from. On the card
each region is one replay of a CUDA graph, all of them captured at the
program's first keyframe (a failed capture raises; nothing falls back to
the eager path); off the card the same functions run eagerly on the same
buffers. ``eager_keyframe`` runs the plain function, ``_vi_kf_work``, on the
same inputs.

Its inputs are static buffers:

* ``x`` [24 + 3W - 1] f32, uploaded from pinned memory: the keyframe id,
  its timestamp, the point count, the keyframe's (v, bg, ba), its pose
  (R, t), then the temporal window the host built (``InertialSlam._window``:
  young maps, the fixed mask, chain breaks), as ids, fixed mask and edge
  mask;
* ``blocks`` [W-1, S, 7]: the window's IMU blocks (acc | gyro | dt),
  uploaded from pinned memory;
* the keyframe's features and landmark bindings (``f_*``), with a depth
  variant (``cfg.stereo``: the stereo-, RGB-D- and rig-inertial systems)
  their u_r and depth, copied on the device;
* the map: the program's buffers hold it. A dispatch copies in the fields
  of the system's map that are not its buffers already (none in the steady
  state: the system's map is the program's after each keyframe), and the
  system takes the buffers as its map; the frame programs, whose map copy
  follows tensor versions, are told to forget theirs after the replays.

Its output, the packed [22] (points admitted, the keyframe's v, bg, ba, R,
t), is the keyframe's one host read, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import orb
from .chunk_runner import kf_segments
from .frame_program import upload
from .kf_program import REGIONS, KeyframeRegions, KFCarry, store_map  # noqa: F401
from .map_state import MapState, kf_index
from .vi_device_loop import insert_admit, kf_cull, kf_fuse, kf_stats, window_ba

PACKED_LEN = 22  # (n_new, v, bg, ba, R, t): the keyframe's one host read


class KFInputs(NamedTuple):
    """One keyframe's inputs: host values and the features on the map
    device (``ur`` / ``depth`` None without depth)."""

    kf_id: int
    R: np.ndarray  # [3, 3] the keyframe's pose (Tcw)
    t: np.ndarray  # [3]
    ts: float
    n_pts: int  # point slots used
    vb: np.ndarray  # [9] its (v, bg, ba)
    window_ids: np.ndarray  # [W] int
    fixed: np.ndarray  # [W] bool
    edge_ok: np.ndarray  # [W-1] bool
    blocks: np.ndarray  # [W-1, S, 7] f32
    feats: orb.Features
    feat_pt: torch.Tensor  # [N] int32
    ur: torch.Tensor | None = None  # [N] right-image x, -1 where none
    depth: torch.Tensor | None = None  # [N] depth, -1 where none

    def host_vector(self) -> np.ndarray:
        """``x``: the host values as one f32 vector."""
        return np.concatenate([
            [self.kf_id, self.ts, self.n_pts], self.vb, np.asarray(self.R).reshape(9), self.t,
            self.window_ids, self.fixed, self.edge_ok,
        ]).astype(np.float32)


def _state(buf: dict):
    """(KFCarry of the program's map, the keyframe as the chunk segments'
    ``fr``) from the buffers."""
    x = buf["x"]
    fr = dict(f_xy=buf["f_xy"], f_level=buf["f_level"], f_angle=buf["f_angle"],
              f_desc=buf["f_desc"], f_valid=buf["f_valid"], f_pt=buf["f_pt"],
              kf_R=x[12:21].reshape(3, 3), kf_t=x[21:24], kf_ts=x[1],
              kf_id=x[0].to(torch.int32))
    if "f_ur" in buf:
        fr.update(f_ur=buf["f_ur"], f_depth=buf["f_depth"])
    return KFCarry(m=MapState(*(buf[f] for f in MapState._fields))), fr


def kf_insert(buf: dict, cfg) -> None:
    c, fr = _state(buf)
    x = buf["x"]
    m, n_new = insert_admit(c.m, fr, x[3:6], x[6:9], x[9:12], x[2].to(torch.int32), cfg)
    store_map(buf, m)
    buf["n_new"].copy_(n_new)


def kf_ba(buf: dict, cfg) -> None:
    c, fr = _state(buf)
    x, W = buf["x"], cfg.W
    ids = x[24 : 24 + W].to(torch.int32)
    fixed = x[24 + W : 24 + 2 * W] > 0.5
    edge_ok = x[24 + 2 * W :] > 0.5
    store_map(buf, window_ba(c.m, ids, fixed, buf["blocks"], edge_ok, fr["kf_id"] + 1, cfg))


def kf_end(buf: dict, cfg) -> None:
    """The packed host read: points admitted and the keyframe's refined
    (v, bg, ba, R, t)."""
    c, fr = _state(buf)
    m = c.m
    k = kf_index(fr["kf_id"], m.kf_R.device)

    def row(t):
        return t.index_select(0, k)[0].reshape(-1)

    buf["packed"].copy_(torch.cat([buf["n_new"].reshape(1).to(torch.float32), row(m.kf_v),
                                   row(m.kf_bg), row(m.kf_ba), row(m.kf_R), row(m.kf_t)]))


class VIKeyframeProgram(KeyframeRegions):
    """The VI keyframe of one system (see the module docstring). ``cfg``: a
    ``vi_device_loop.VIChunkConfig`` (its window, cadences, camera, IMU
    calibration and depth variant ``stereo``); ``K``, ``N``, ``P``: the
    map's capacities. ``run`` does one keyframe."""

    BODIES = dict(kf_insert=kf_insert, kf_ba=kf_ba, kf_end=kf_end)
    SEGMENTS = dict(kf_fuse=kf_fuse, kf_stats=kf_stats, kf_cull=kf_cull)
    state = staticmethod(_state)

    def __init__(self, cfg, device, K: int, N: int, P: int):
        super().__init__(cfg, device, K, N, P)
        dev = self.device
        f32 = dict(dtype=torch.float32, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        self.buf.update(
            x=torch.zeros((24 + 3 * cfg.W - 1,), **f32),
            blocks=torch.zeros((cfg.W - 1, cfg.imu_cap_kf, 7), **f32),
            f_xy=torch.zeros((N, 2), **f32), f_level=torch.zeros((N,), **i32),
            f_angle=torch.zeros((N,), **f32),
            f_desc=torch.zeros((N, 256), dtype=torch.int8, device=dev),
            f_valid=torch.zeros((N,), dtype=torch.bool, device=dev), f_pt=torch.zeros((N,), **i32),
            n_new=torch.zeros((), **i32), packed=torch.zeros((PACKED_LEN,), **f32),
        )
        if cfg.stereo:
            self.buf.update(f_ur=torch.zeros((N,), **f32), f_depth=torch.zeros((N,), **f32))

    def load(self, m: MapState, inp: KFInputs) -> None:
        """Put keyframe ``inp`` and map ``m`` into the buffers: the map's
        fields that are not the buffers already, the features on the
        device, the host values from pinned memory. No host read."""
        self.load_map(m)
        b = self.buf
        fe = inp.feats
        for k, v in (("f_xy", fe.xy), ("f_level", fe.level), ("f_angle", fe.angle),
                     ("f_desc", fe.desc_sign), ("f_valid", fe.valid), ("f_pt", inp.feat_pt)):
            b[k].copy_(v)
        if self.cfg.stereo:
            b["f_ur"].copy_(inp.ur)
            b["f_depth"].copy_(inp.depth)
        upload(b["x"], inp.host_vector())
        upload(b["blocks"], inp.blocks)

    def run(self, m: MapState, inp: KFInputs):
        """Keyframe ``inp`` on map ``m``: the regions ``kf_segments`` names
        for its id (on the card, at the first keyframe, every region is
        captured first), then the one host read. Returns (the program's
        map, the packed [22] as numpy)."""
        self.load(m, inp)
        self.replay(inp.kf_id)
        return self.map, self.buf["packed"].cpu().numpy()


def eager_keyframe(m: MapState, inp: KFInputs, cfg):
    """The plain function on the same inputs: ``inertial_system._vi_kf_work``
    (looked up at call time) with ``cfg``'s settings, camera and IMU
    calibration on map ``m`` (written in place where the function writes in
    place). Returns (map, the packed [22] on the device)."""
    from . import inertial_system

    dev = m.kf_R.device
    kf = inp.kf_id
    segs = kf_segments(cfg, kf)
    depth_kw = {}
    if cfg.stereo:
        depth_kw = dict(ur=inp.ur, depth=inp.depth, max_depth=cfg.max_depth)
    T = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)  # noqa: E731
    m, n_new = inertial_system._vi_kf_work(
        m, kf, T(inp.R), T(inp.t), inp.ts, inp.feats, inp.feat_pt, inp.n_pts, m.P - inp.n_pts,
        T(inp.vb), T(inp.window_ids, torch.int32), T(inp.fixed, torch.bool), T(inp.blocks),
        T(inp.edge_ok, torch.bool), cfg.calib, cfg.cam_params, width=cfg.width, height=cfg.height,
        fuse_neighbors=cfg.fuse_neighbors, do_fuse="kf_fuse" in segs,
        do_stats="kf_stats" in segs, do_cull="kf_cull" in segs, n_iters=cfg.local_ba_iters,
        n_levels=cfg.config.n_levels, bf=cfg.bf, cam_model=cfg.cam_model, **depth_kw,
    )
    return m, torch.cat([n_new.to(torch.float32).reshape(1),
                         inertial_system._pack_kf_state(m, kf)])
