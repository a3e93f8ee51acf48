"""The monocular keyframe program of the per-frame path — port of the JAX
package's fused keyframe jit (``kf_work.keyframe_work``) as
``MonoSlam._insert_keyframe`` runs it: one dispatch a keyframe, with one
packed host read (synchronous) or a copy of it that lands later (the
pipelined mode's deferred keyframe).

``KeyframeProgram`` runs the keyframe as regions of
``chunk_runner.GraphRegions``, in the order and under the names of the mono
chunk's keyframe segments (``chunk_runner.kf_segments``): insert + admit,
fuse, BA + point cull, stats, keyframe cull, end; the fuse, stats and cull
regions run only at the keyframe ids that call for them, as the JAX
function's static ``do_fuse`` / ``do_stats`` / ``do_cull`` do. The region
bodies are the chunk's (``device_loop.insert_admit``, ``kf_fuse``,
``covis_ba``, ``kf_stats``, ``kf_cull``); what differs is where their inputs
come from. On the card each region is one replay of a CUDA graph, all of
them captured at the program's first keyframe (a failed capture raises;
nothing falls back to the eager path); off the card the same functions run
eagerly on the same buffers. ``eager_keyframe`` runs the plain function,
``kf_work.keyframe_work``, on the same inputs. The camera model is the
configuration's (pinhole or KB8), as in the chunk.

Its inputs are static buffers:

* ``x`` [15] f32: the keyframe id, its timestamp, the point count, then its
  pose (R, t), uploaded from pinned memory; a pose already on the device
  (the deferred keyframe's tracked pose) is copied over the pose there;
* the keyframe's features and landmark bindings (``f_*``), copied on the
  device;
* the map: the program's buffers hold it. A run copies in the fields of
  the system's map that are not its buffers already (none in the steady
  state: the system's map is the program's after each keyframe), so a path
  that rebinds the system's map (compaction, an Atlas switch or weld, a
  reset, a loop correction, a global-BA fold-in, a chunk) is copied in at
  the next keyframe; the frame programs, whose map copy follows tensor
  versions, are told to forget theirs after the replays.

Its output, the packed [14] (points admitted, the keyframe's R and t, the
local BA's iterations), is the keyframe's one host read, as in the JAX
package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import orb
from .chunk_runner import GraphRegions, kf_segments
from .device_loop import covis_ba, insert_admit, kf_cull, kf_fuse, kf_stats
from .frame_program import HostCopy, map_shapes, upload
from .map_state import MapState, kf_index

PACKED_LEN = 14  # (n_new, R, t, BA iterations): the keyframe's one host read
REGIONS = ("kf_insert", "kf_fuse", "kf_ba", "kf_stats", "kf_cull", "kf_end")


class KFCarry(NamedTuple):
    """What the chunk's fuse, stats and cull segments read and rebind."""

    m: MapState


def store_map(buf: dict, m: MapState) -> None:
    """The map fields a region rebound, into their buffers."""
    for f, v in zip(MapState._fields, m):
        if v is not buf[f]:
            buf[f].copy_(v)


class KeyframeRegions(GraphRegions):
    """What the per-frame keyframe programs (``KeyframeProgram``,
    ``vi_kf_program.VIKeyframeProgram``) share: the map's fields as buffers
    (the system's map after a keyframe), one region a name of ``REGIONS``,
    and a keyframe's replays. A subclass gives ``state`` (the chunk
    segments' carry and ``fr`` from its buffers), its own region bodies
    ``BODIES[name](buf, cfg)`` (insert, BA, end) and its device loop's
    ``SEGMENTS`` (fuse, stats, cull: ``seg(carry, fr, cfg)``, whose map goes
    back into the buffers), adds its input and output buffers and loads a
    keyframe's inputs."""

    BODIES: dict = {}
    SEGMENTS: dict = {}
    state = None  # staticmethod: buf -> (KFCarry, fr)

    def __init__(self, cfg, device, K: int, N: int, P: int):
        super().__init__(cfg, device)
        self.buf = {f: torch.zeros(shape, dtype=dt, device=self.device)
                    for f, (shape, dt) in map_shapes(K, N, P).items()}

    def region(self, name):
        cfg, state = self.cfg, self.state
        if name in self.SEGMENTS:
            seg = self.SEGMENTS[name]

            def run(buf):
                c, fr = state(buf)
                store_map(buf, seg(c, fr, cfg).m)
        else:
            body = self.BODIES[name]

            def run(buf):
                body(buf, cfg)

        return run

    @property
    def map(self) -> MapState:
        """The map in the program's buffers."""
        return MapState(*(self.buf[f] for f in MapState._fields))

    def load_map(self, m: MapState) -> None:
        """Copy in the fields of map ``m`` that are not the buffers already."""
        store_map(self.buf, m)

    def replay(self, kf_id: int) -> None:
        """The regions ``kf_segments`` names for keyframe ``kf_id`` (on the
        card, at the first keyframe, every region is captured first)."""
        if self.graphs:
            for name in REGIONS:
                if name not in self._graph:
                    self._graph[name] = self._capture(self.region(name))
        for name in kf_segments(self.cfg, kf_id):
            self._run(name)


class KFInputs(NamedTuple):
    """One keyframe's inputs: host values, the pose on the host or on the
    map device, and the features on the map device."""

    kf_id: int
    R: np.ndarray | torch.Tensor  # [3, 3] the keyframe's pose (Tcw)
    t: np.ndarray | torch.Tensor  # [3]
    ts: float
    n_pts: int  # point slots used
    feats: orb.Features
    feat_pt: torch.Tensor  # [N] int32

    @property
    def pose_on_device(self) -> bool:
        return isinstance(self.R, torch.Tensor)

    def host_vector(self) -> np.ndarray:
        """``x``: the host values as one f32 vector (a pose on the device
        leaves its entries 0 here)."""
        pose = np.zeros(12) if self.pose_on_device else np.concatenate(
            [np.asarray(self.R).reshape(9), np.asarray(self.t)])
        return np.concatenate([[self.kf_id, self.ts, self.n_pts], pose]).astype(np.float32)


def _state(buf: dict):
    """(KFCarry of the program's map, the keyframe as the chunk segments'
    ``fr``) from the buffers."""
    x = buf["x"]
    fr = dict(f_xy=buf["f_xy"], f_level=buf["f_level"], f_angle=buf["f_angle"],
              f_desc=buf["f_desc"], f_valid=buf["f_valid"], f_pt=buf["f_pt"],
              kf_R=x[3:12].reshape(3, 3), kf_t=x[12:15], kf_ts=x[1],
              kf_id=x[0].to(torch.int32))
    return KFCarry(m=MapState(*(buf[f] for f in MapState._fields))), fr


def kf_insert(buf: dict, cfg) -> None:
    c, fr = _state(buf)
    m, n_new = insert_admit(c.m, fr, buf["x"][2].to(torch.int32), cfg)
    store_map(buf, m)
    buf["n_new"].copy_(n_new)


def kf_ba(buf: dict, cfg) -> None:
    c, fr = _state(buf)
    m, iters = covis_ba(c.m, fr["kf_id"], cfg)
    store_map(buf, m)
    buf["iters"].copy_(iters)


def kf_end(buf: dict, cfg) -> None:
    """The packed host read: points admitted, the keyframe's refined pose
    and the local BA's iterations."""
    c, fr = _state(buf)
    m = c.m
    k = kf_index(fr["kf_id"], m.kf_R.device)
    f32 = torch.float32
    buf["packed"].copy_(torch.cat([
        buf["n_new"].reshape(1).to(f32), m.kf_R.index_select(0, k).reshape(9),
        m.kf_t.index_select(0, k).reshape(3), buf["iters"].reshape(1).to(f32),
    ]))


class KeyframeProgram(KeyframeRegions):
    """The monocular keyframe of one system (see the module docstring).
    ``cfg``: a ``device_loop.ChunkConfig`` (its covisibility window,
    cadences, BA iterations and camera); ``K``, ``N``, ``P``: the map's
    capacities. ``run`` does one keyframe."""

    BODIES = dict(kf_insert=kf_insert, kf_ba=kf_ba, kf_end=kf_end)
    SEGMENTS = dict(kf_fuse=kf_fuse, kf_stats=kf_stats, kf_cull=kf_cull)
    state = staticmethod(_state)

    def __init__(self, cfg, device, K: int, N: int, P: int):
        super().__init__(cfg, device, K, N, P)
        dev = self.device
        f32 = dict(dtype=torch.float32, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        self.buf.update(
            x=torch.zeros((15,), **f32),
            f_xy=torch.zeros((N, 2), **f32), f_level=torch.zeros((N,), **i32),
            f_angle=torch.zeros((N,), **f32),
            f_desc=torch.zeros((N, 256), dtype=torch.int8, device=dev),
            f_valid=torch.zeros((N,), dtype=torch.bool, device=dev), f_pt=torch.zeros((N,), **i32),
            n_new=torch.zeros((), **i32), iters=torch.zeros((), **i32),
            packed=torch.zeros((PACKED_LEN,), **f32),
        )

    def load(self, m: MapState, inp: KFInputs) -> None:
        """Put keyframe ``inp`` and map ``m`` into the buffers: the map's
        fields that are not the buffers already, the features and a pose on
        the device copied there, the host values from pinned memory. No
        host read."""
        self.load_map(m)
        b = self.buf
        fe = inp.feats
        for k, v in (("f_xy", fe.xy), ("f_level", fe.level), ("f_angle", fe.angle),
                     ("f_desc", fe.desc_sign), ("f_valid", fe.valid), ("f_pt", inp.feat_pt)):
            b[k].copy_(v)
        upload(b["x"], inp.host_vector())
        if inp.pose_on_device:
            b["x"][3:12].copy_(inp.R.reshape(9))
            b["x"][12:15].copy_(inp.t)

    def run(self, m: MapState, inp: KFInputs, defer: bool = False):
        """Keyframe ``inp`` on map ``m``: its regions' replays
        (``replay``), then the packed [14]: read at once, or with ``defer``
        copied to the host without a wait. Returns (the program's map, the
        packed values as numpy, or with ``defer`` their ``HostCopy``)."""
        self.load(m, inp)
        self.replay(inp.kf_id)
        packed = self.buf["packed"]
        return self.map, HostCopy(packed) if defer else packed.cpu().numpy()


def eager_keyframe(m: MapState, inp: KFInputs, cfg):
    """The plain function on the same inputs: ``kf_work.keyframe_work``
    (looked up at call time; the local BA in its device form) with
    ``cfg``'s settings and camera on map ``m`` (written in place where the
    function writes in place). Returns (map, the packed [14] on the
    device)."""
    from . import kf_work

    dev = m.kf_R.device
    kf = inp.kf_id
    segs = kf_segments(cfg, kf)
    R, t = inp.R, inp.t
    if not inp.pose_on_device:
        R = torch.as_tensor(np.asarray(R, np.float32), device=dev)
        t = torch.as_tensor(np.asarray(t, np.float32), device=dev)
    m, n_new, iters = kf_work.keyframe_work(
        m, kf, R, t, inp.ts, inp.feats, inp.feat_pt, inp.n_pts, m.P - inp.n_pts,
        cfg.cam_params, cfg.bf, w_free=cfg.ba_window, w_fixed=cfg.ba_fixed,
        n_iters=cfg.local_ba_iters, n_levels=cfg.config.n_levels,
        fuse_neighbors=cfg.fuse_neighbors, do_fuse="kf_fuse" in segs,
        do_stats="kf_stats" in segs, do_cull="kf_cull" in segs, width=cfg.width,
        height=cfg.height, cam_model=cfg.cam_model, on_device=True,
    )
    f32 = torch.float32
    return m, torch.cat([n_new.to(f32).reshape(1), m.kf_R[kf].reshape(9), m.kf_t[kf],
                         iters.to(f32).reshape(1)])
