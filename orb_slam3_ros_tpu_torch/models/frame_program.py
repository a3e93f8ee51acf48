"""The pipelined mode's speculative frame program — port of the JAX
package's ``MonoSlam._fused_track_dev`` (``models/system.py:350-362``).

Frame i is dispatched before frame i-1's result has reached the host: the
constant-velocity prediction is made on the device from the poses of
frames i-1 and i-2, then ``orb.extract`` and ``tracking.track_against_map``
run from it. ``FrameProgram`` runs that as one region of
``chunk_runner.GraphRegions``: on the card one replay of a CUDA graph per
tracking schedule, captured right after initialization (``warm``) or at
its first use (a failed capture raises; nothing falls back to the eager
path); off the card the same function runs eagerly on the same buffers.
``vi_frame_program.VIFrameProgram`` runs the VI frame on the same buffers
and map copy (``TrackingRegions``).

Its inputs are static buffers:

* ``img`` [H, W]: float32, or uint8 under ``transfer_uint8`` (a float frame
  is clamped to [0, 255] and truncated, as the chunk loop's stack is);
* ``x`` [38] f32: a host-prediction flag, the host's prediction (R, t),
  frame i-1's pose (R, t) and frame i-2's, and ``n_kf`` (the ``track_window``
  mask is made from it inside the program). A speculative dispatch moves
  frame i-1's pose to i-2's place and copies the pending frame's result in,
  device to device, never through the host; the host's prediction is used
  only for the first frame after a break in the chain (initialization,
  relocalization, a chunk), as the JAX package's ``_fused_track`` is;
* the map: the point fields tracking reads (``FRAME_MAP_FIELDS``) are
  copied into the program's own buffers at dispatch, and only when one of
  them changed: another tensor, or the same one written since (torch's
  version counter of the tensor; a chunk's graph replays write the map
  without it, so the system calls ``forget_map`` after a chunk). The map is
  not bound to the graph's buffers: the system's map tensors are rebound
  and archived (the Atlas keeps an archived map's tensors), so a graph that
  read them in place could read a map that is gone. The copy is enqueued
  before the replay, so the frame reads the map as it stood at dispatch:
  the drain's counter update and keyframe work for frame i-1 are enqueued
  after frame i's replay (the JAX package's one keyframe of staleness).
  The keyframe fields and the found / visible counters tracking does not
  read are zero-stride views of a zero.

Its outputs are written into buffers by the program. The next replay
overwrites them before the drain reads them, so ``dispatch`` copies them
out on the device after each run (``FrameOut``), and copies (n_inliers, R,
t) into pinned host memory without a wait, with a CUDA event after it
(``HostCopy``): the drain waits on that event, no thread, no poll loop.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import orb
from . import tracking
from .chunk_runner import GraphRegions
from .map_state import MapState

# The map fields tracking reads (``track_against_map`` and the window mask).
FRAME_MAP_FIELDS = ("pt_valid", "pt_X", "pt_desc_sign", "pt_level", "pt_first_kf",
                    "pt_normal", "pt_min_dist", "pt_max_dist")
# ``x``: [0] 1.0 for the host's prediction, [1:13] its (R, t), [13:25]
# frame i-1's (R, t), [25:37] frame i-2's, [37] n_kf.
X_LEN = 38
PACKED_LEN = 13  # (n_inliers, R, t): the frame's one host read


class FrameConfig(NamedTuple):
    """The static settings of one system's frame program."""

    config: orb.ExtractorConfig
    cam_params: torch.Tensor  # on the program's device
    width: int
    height: int
    track_window: int | None
    track_cap: int | None
    cam_model: str
    uint8: bool  # the image buffer is uint8 (``transfer_uint8``)
    K: int  # the map's capacities
    N: int
    P: int


class HostCopy:
    """A device tensor's values on the host, copied without a wait: on the
    card a non-blocking copy into pinned memory and a CUDA event after it;
    off the card a copy."""

    def __init__(self, x: torch.Tensor):
        self.event = None
        if x.device.type == "cuda":
            self.values = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self.values.copy_(x, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(x.device))
        else:
            self.values = x.clone()

    def ready(self) -> bool:
        """Whether the copy has landed (a query, no wait)."""
        return self.event is None or self.event.query()

    def get(self) -> np.ndarray:
        """The values (waits for the copy's event)."""
        if self.event is not None:
            self.event.synchronize()
        return self.values.numpy().copy()

    def __deepcopy__(self, memo):
        """A copy of a system with a frame in flight: the values once
        landed, with no event (a CUDA event cannot be copied)."""
        out = HostCopy.__new__(HostCopy)
        out.values, out.event = torch.from_numpy(self.get()), None
        return out


class FrameOut(NamedTuple):
    """One dispatched frame: its features and tracking result on the device
    (copies of the program's outputs), its tracked pose [12] (R, t) there,
    and the host copy of (n_inliers, R, t) in flight."""

    feats: orb.Features
    res: tracking.TrackResult
    pose: torch.Tensor
    host: HostCopy


def predict(x: torch.Tensor):
    """The prediction of ``x`` (see ``X_LEN``): the host's where its flag is
    set, else the constant velocity of frames i-2 -> i-1 applied to frame
    i-1's pose (the JAX package's ``_fused_dev``)."""
    R1, t1 = x[13:22].reshape(3, 3), x[22:25]
    R2, t2 = x[25:34].reshape(3, 3), x[34:37]
    vel_R = R1 @ R2.T
    vel_t = t1 - vel_R @ t2
    R_dev = vel_R @ R1
    t_dev = vel_R @ t1 + vel_t
    host = x[0] > 0.5
    return torch.where(host, x[1:10].reshape(3, 3), R_dev), torch.where(host, x[10:13], t_dev)


def program_map(buf: dict, blank: dict) -> MapState:
    """The map a frame program reads: its buffers of the fields tracking
    reads, ``blank``'s zero views for the others."""
    return MapState(**{f: buf[f] if f in FRAME_MAP_FIELDS else blank[f] for f in MapState._fields})


def store_tracked(buf: dict, feats: orb.Features, res: tracking.TrackResult) -> None:
    """A frame's features and tracking result into the program's buffers."""
    for f in orb.Features._fields:
        buf[f"f_{f}"].copy_(getattr(feats, f))
    buf["feat_pt"].copy_(res.feat_pt)
    buf["n_inl"].copy_(res.n_inliers)
    buf["visible"].copy_(res.visible_mask)
    buf["found"].copy_(res.found_mask)


def frame_program(buf: dict, blank: dict, cfg: FrameConfig, schedule: tuple) -> None:
    """The speculative frame on the program's buffers: the prediction,
    extraction and tracking against the map in ``buf``, each output copied
    into its buffer. ``blank``: the zero views standing for the map fields
    tracking does not read."""
    x = buf["x"]
    R_pred, t_pred = predict(x)
    feats = orb.extract(buf["img"].to(torch.float32), cfg.config)
    m = program_map(buf, blank)
    pt_mask = None
    if cfg.track_window is not None:
        pt_mask = m.pt_first_kf >= (x[37].to(torch.int32) - cfg.track_window)
    res = tracking.track_against_map(
        m, feats, R_pred, t_pred, cfg.cam_params, cfg.width, cfg.height, pt_mask=pt_mask,
        schedule=schedule, track_cap=cfg.track_cap, cam_model=cfg.cam_model,
    )
    store_tracked(buf, feats, res)
    buf["packed"].copy_(torch.cat([res.n_inliers.reshape(1).to(torch.float32),
                                   res.R.reshape(9), res.t]))
    buf["pred"].copy_(torch.cat([R_pred.reshape(9), t_pred]))


def upload(dst: torch.Tensor, a: np.ndarray) -> None:
    """Host array ``a`` into ``dst``: on the card from pinned memory without
    a wait (a copy from pageable memory synchronizes the stream)."""
    src = torch.from_numpy(np.ascontiguousarray(a))
    if dst.device.type == "cuda":
        dst.copy_(src.pin_memory(), non_blocking=True)
    else:
        dst.copy_(src)


def load_image(dst: torch.Tensor, img) -> None:
    """Image ``img`` (numpy or a tensor, values in [0, 255]) into buffer
    ``dst``: a tensor on the buffer's device is copied there, anything else
    uploaded from pinned memory (``upload``); a uint8 buffer takes a float
    image clamped to [0, 255] and truncated, as the chunk loop's stack does."""
    if isinstance(img, torch.Tensor) and img.device.type == dst.device.type:
        if dst.dtype == torch.uint8 and img.dtype != torch.uint8:
            img = torch.clamp(img, 0, 255)
        dst.copy_(img)
        return
    a = img.cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)
    if dst.dtype == torch.uint8:
        a = a if a.dtype == np.uint8 else np.clip(a, 0, 255).astype(np.uint8)
    else:
        a = a.astype(np.float32, copy=False)
    upload(dst, a)


class TrackingRegions(GraphRegions):
    """What the frame program, the VI frame program
    (``vi_frame_program.VIFrameProgram``) and the tracking program
    (``track_program.TrackProgram``) share: the map's point fields tracking
    reads, the features and the tracking result as static buffers (and a
    subclass's ``_own_buffers``: the frame programs' image among them), the
    map copied in only when it changed, and the capture of one graph a
    tracking schedule (the frame programs' regions ``("frame",
    schedule)``)."""

    def __init__(self, cfg, device):
        super().__init__(cfg, device)
        dev = self.device
        f32 = dict(dtype=torch.float32, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        N, P = cfg.config.total_cap, cfg.P
        shapes = map_shapes(cfg.K, cfg.N, P)
        self.buf = dict(
            **{f: torch.zeros(shapes[f][0], dtype=shapes[f][1], device=dev)
               for f in FRAME_MAP_FIELDS},
            f_xy=torch.zeros((N, 2), **f32), f_level=torch.zeros((N,), **i32),
            f_angle=torch.zeros((N,), **f32), f_response=torch.zeros((N,), **f32),
            f_desc_packed=torch.zeros((N, 8), **i32),
            f_desc_sign=torch.zeros((N, 256), dtype=torch.int8, device=dev),
            f_valid=torch.zeros((N,), dtype=torch.bool, device=dev),
            feat_pt=torch.zeros((N,), **i32), n_inl=torch.zeros((), **i32),
            visible=torch.zeros((P,), dtype=torch.bool, device=dev),
            found=torch.zeros((P,), dtype=torch.bool, device=dev),
            **self._own_buffers(),
        )
        self._blank = {f: torch.zeros((), dtype=dt, device=dev).expand(shape)
                       for f, (shape, dt) in shapes.items() if f not in FRAME_MAP_FIELDS}
        self._map_src = {}  # map field -> (the tensor last copied in, its version then)
        self.map_copies = 0  # dispatches that copied the map in

    def _own_buffers(self) -> dict:
        """The program's inputs and outputs besides the map, the features
        and the tracking result."""
        raise NotImplementedError

    def _image_buffer(self) -> torch.Tensor:
        """[H, W]: float32, or uint8 under ``cfg.uint8``."""
        cfg = self.cfg
        return torch.zeros((cfg.height, cfg.width),
                           dtype=torch.uint8 if cfg.uint8 else torch.float32, device=self.device)

    def forget_map(self) -> None:
        """Copy the map in at the next dispatch whatever its tensors' versions
        (after writes that bypass them: a chunk's graph replays)."""
        self._map_src.clear()

    def _load_map(self, m: MapState) -> None:
        copied = False
        for f in FRAME_MAP_FIELDS:
            src = getattr(m, f)
            seen = self._map_src.get(f)
            if seen is not None and seen[0] is src and seen[1] == src._version:
                continue
            self.buf[f].copy_(src)
            self._map_src[f] = (src, src._version)
            copied = True
        self.map_copies += copied

    def _capture_schedules(self, schedules) -> None:
        """Capture the graph of each schedule not captured yet, from the
        inputs in the buffers (on the card; off it there is nothing to
        capture)."""
        if not self.graphs:
            return
        for schedule in dict.fromkeys(schedules):
            name = ("frame", schedule)
            if name not in self._graph:
                self._graph[name] = self._capture(self.region(name))


class FrameProgram(TrackingRegions):
    """The speculative frame of one system (see the module docstring);
    ``dispatch`` runs one frame."""

    def __init__(self, cfg: FrameConfig, device):
        super().__init__(cfg, device)
        self._n_kf = None  # n_kf in ``x``
        self._host_pred = False  # whether ``x`` holds the host-prediction flag

    def _own_buffers(self) -> dict:
        """The image, the prediction's inputs ``x``, the packed host read and
        the prediction."""
        f32 = dict(dtype=torch.float32, device=self.device)
        return dict(img=self._image_buffer(), x=torch.zeros((X_LEN,), **f32),
                    packed=torch.zeros((PACKED_LEN,), **f32), pred=torch.zeros((12,), **f32))

    def region(self, name):
        schedule = name[1]

        def run(buf):
            frame_program(buf, self._blank, self.cfg, schedule)

        return run

    def warm(self, schedules, m: MapState, n_kf: int, R, t) -> None:
        """Capture the graph of each schedule now, from the map ``m`` and
        the pose (R, t) (on the card; off it there is nothing to capture):
        the JAX package's ``_warm_schedules`` after initialization, so that
        the switch from the dense schedule to the lean one never stalls a
        live frame with a capture."""
        if not self.graphs:
            return
        self._load_map(m)
        R, t = np.asarray(R, np.float32).reshape(-1), np.asarray(t, np.float32).reshape(-1)
        upload(self.buf["x"], np.concatenate([[1.0], R, t, R, t, R, t, [n_kf]]).astype(np.float32))
        self._host_pred, self._n_kf = True, n_kf
        self._capture_schedules(schedules)

    def dispatch(self, img, m: MapState, n_kf: int, schedule: tuple,
                 prev: FrameOut | None = None, host=None) -> FrameOut:
        """Run frame ``img`` against map ``m`` under ``schedule``. ``prev``:
        the pending frame (i-1): predict on the device from its pose and the
        pose the previous dispatch read as frame i-1's. Else ``host`` =
        (R_pred, t_pred, R_cur, t_cur), numpy: the host's prediction, with
        the host's pose as frame i-1's for the next dispatch. No host read."""
        load_image(self.buf["img"], img)
        # The map as it stands now: the copy and the replay are enqueued
        # before the drain's counter update and keyframe work for frame i-1,
        # which stream order keeps after them (one keyframe of staleness).
        self._load_map(m)
        x = self.buf["x"]
        if prev is None:
            R_pred, t_pred, R_cur, t_cur = (np.asarray(a, np.float32).reshape(-1) for a in host)
            upload(x, np.concatenate([[1.0], R_pred, t_pred, R_cur, t_cur, R_cur, t_cur,
                                      [n_kf]]).astype(np.float32))
            self._host_pred, self._n_kf = True, n_kf
        else:
            # The previous dispatch was frame i-1's (a dispatch whose frame
            # is not left pending breaks the chain: the next one is the
            # host's), so x[13:25] holds frame i-2's pose.
            x[25:37].copy_(x[13:25])
            x[13:25].copy_(prev.pose)
            if self._host_pred:
                x[0:1].fill_(0.0)
                self._host_pred = False
            if n_kf != self._n_kf:
                x[37:38].fill_(float(n_kf))
                self._n_kf = n_kf
        self._run(("frame", schedule))
        return self._result()

    def _result(self) -> FrameOut:
        # The next replay overwrites the output buffers before this frame is
        # drained (after frame i+1's dispatch): copy them out on the card.
        b = self.buf
        feats = orb.Features(**{f: b[f"f_{f}"].clone() for f in orb.Features._fields})
        packed = b["packed"].clone()
        res = tracking.TrackResult(
            R=packed[1:10].reshape(3, 3), t=packed[10:13], feat_pt=b["feat_pt"].clone(),
            n_inliers=b["n_inl"].clone(), visible_mask=b["visible"].clone(),
            found_mask=b["found"].clone(),
        )
        return FrameOut(feats=feats, res=res, pose=packed[1:13], host=HostCopy(b["packed"]))


def map_shapes(K: int, N: int, P: int) -> dict:
    """Each map field's (shape, dtype) at capacities K, N, P (as
    ``map_state.empty_map`` makes them)."""
    f32, i32, b, i8 = torch.float32, torch.int32, torch.bool, torch.int8
    return dict(
        kf_valid=((K,), b), kf_R=((K, 3, 3), f32), kf_t=((K, 3), f32), kf_xy=((K, N, 2), f32),
        kf_level=((K, N), i32), kf_angle=((K, N), f32), kf_desc_sign=((K, N, 256), i8),
        kf_feat_valid=((K, N), b), kf_obs=((K, N), i32), kf_ts=((K,), f32),
        kf_ur=((K, N), f32), pt_valid=((P,), b), pt_X=((P, 3), f32),
        pt_desc_sign=((P, 256), i8), pt_level=((P,), i32), pt_found=((P,), i32),
        pt_visible=((P,), i32), pt_first_kf=((P,), i32), pt_normal=((P, 3), f32),
        pt_min_dist=((P,), f32), pt_max_dist=((P,), f32), kf_v=((K, 3), f32),
        kf_bg=((K, 3), f32), kf_ba=((K, 3), f32),
    )
