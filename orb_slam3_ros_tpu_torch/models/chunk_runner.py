"""What the monocular and the visual-inertial chunk loops share
(``device_loop.MonoChunkRunner``, ``vi_device_loop.VIChunkRunner``): the
static buffers, one CUDA graph per region, the replay loop with its two-word
host read a frame, the frame's output row, and the stereo branch's frame
preparation and keyframe point creation.

``GraphRegions``, the capture and replay of named regions on static
buffers, is also the pipelined per-frame mode's (``frame_program``).

Where the JAX package compiles a chunk into one XLA program (``lax.scan``
over the frames, the keyframe work under ``lax.cond``), a runner captures
CUDA graphs: one of the frame step per tracking schedule and one of each
keyframe segment. After each step the host reads ``(need_kf, alive)`` and
replays the keyframe segments the keyframe's id calls for, or goes on: the
branch the JAX program takes on the device. Every region reads and writes
one set of static buffers; off the card the same functions run eagerly on
the same buffers.
"""

from __future__ import annotations

import collections
import time
from typing import NamedTuple

import torch

from ..ops import orb, project_match, stereo
from . import map_updates, tracking
from .map_state import MapState, kf_index


class ChunkOut(NamedTuple):
    """One frame's output, as the columns of its row of ``ROW_LEN`` floats
    (the JAX package's packed per-frame columns)."""

    R: torch.Tensor  # [3,3] camera Tcw
    t: torch.Tensor  # [3]
    R_cr: torch.Tensor  # [3,3] pose relative to the reference keyframe
    t_cr: torch.Tensor  # [3]
    ref: torch.Tensor  # [] reference keyframe slot
    n_inliers: torch.Tensor  # []
    is_kf: torch.Tensor  # []
    alive: torch.Tensor  # []


ROW_LEN = 28
# The carry's scalars, the same in both loops, with their buffers' dtypes.
CARRY_SCALARS = {"n_kf": torch.int32, "n_pts": torch.int32, "last_kf_fid": torch.int32,
                 "alive": torch.bool, "ref_inl": torch.int32}
# What a keyframe's segments read of the frame that made it; a stereo
# chunk's also read each feature's right-image x and depth (-1 where none).
FRAME_KEYS = ("f_xy", "f_level", "f_angle", "f_desc", "f_valid", "f_pt",
              "kf_R", "kf_t", "kf_ts", "kf_id", "n_vis")
STEREO_KEYS = ("f_ur", "f_depth")


def frame_row(m: MapState, ref, R_cur, t_cur, n_inliers, is_kf, alive) -> torch.Tensor:
    """[ROW_LEN] f32: ``ChunkOut``'s columns in field order, with the pose
    relative to keyframe ``ref`` (a 0-d tensor)."""
    k = kf_index(ref, R_cur.device)
    R_ref = m.kf_R.index_select(0, k)[0]
    t_ref = m.kf_t.index_select(0, k)[0]
    R_cr = R_cur @ R_ref.T
    t_cr = t_cur - R_cr @ t_ref
    tail = torch.stack([x.to(torch.float32) for x in (ref, n_inliers, is_kf, alive)])
    return torch.cat([R_cur.reshape(9), t_cur, R_cr.reshape(9), t_cr, tail])


def read_rows(rows) -> ChunkOut:
    """``ChunkOut`` of numpy arrays with a leading frame axis from the host
    copy [C, ROW_LEN] of a chunk's rows."""
    C = rows.shape[0]
    return ChunkOut(
        R=rows[:, 0:9].reshape(C, 3, 3), t=rows[:, 9:12],
        R_cr=rows[:, 12:21].reshape(C, 3, 3), t_cr=rows[:, 21:24],
        ref=rows[:, 24].astype(int), n_inliers=rows[:, 25].astype(int),
        is_kf=rows[:, 26] > 0.5, alive=rows[:, 27] > 0.5,
    )


def read_host(*tensors) -> list:
    """One host read of several device tensors: numpy arrays of their
    shapes, as float32 (exact for the counts and ids read here)."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors]).cpu().numpy()
    out, o = [], 0
    for t in tensors:
        out.append(flat[o : o + t.numel()].reshape(t.shape))
        o += t.numel()
    return out


def prep_frame(img, cfg):
    """A frame's features, and with ``cfg.stereo`` each feature's
    right-image x and depth (-1 where unmatched) from the [2, H, W] pair:
    the JAX chunks' ``_prep_stereo`` / ``_prep_one``. Returns (feats, ur,
    depth), the last two None for a monocular frame."""
    if not cfg.stereo:
        return orb.extract(img.to(torch.float32), cfg.config), None, None
    il, ir = img[0].to(torch.float32), img[1].to(torch.float32)
    fl = orb.extract(il, cfg.config)
    fr = orb.extract(ir, cfg.config)
    sm = stereo.match_stereo(fl, fr, il, ir, fx=cfg.fx, baseline=cfg.baseline)
    return (fl, torch.where(sm.valid, sm.u_right, -1.0),
            torch.where(sm.valid, sm.depth, -1.0))


def admit_keyframe_points(m, kf_id, R, t, xy, valid, depth, n_pts, room, cam_params,
                          max_depth: float = 0.0, cam_model: str = "pinhole"):
    """A new keyframe's landmarks into the point slots from ``n_pts`` on,
    at most ``room`` of them: with a ``depth`` per feature (stereo, RGB-D;
    -1 where none) first the close points (under ``max_depth``) from
    depth, metric, at the keyframe's pose (R, t); then triangulation
    against the previous keyframe binds what is still unbound (far points,
    every monocular one; under ``cam_model``). Returns (map, points
    admitted as a 0-d tensor)."""
    base, n_new = n_pts, 0
    if depth is not None:
        cand = (depth > 0) & (depth < max_depth) & valid
        X_c = stereo.backproject(cam_params, xy, depth)
        m, n_new = map_updates.admit_depth_points(m, kf_id, (X_c - t) @ R, cand, base, room)
        base = base + n_new
    tri = tracking.triangulate_with_ref(m, kf_id, kf_id - 1, cam_params, cam_model=cam_model)
    m, n_tri = map_updates.admit_new_points(m, kf_id, kf_id - 1, tri, base, room - n_new)
    return m, n_new + n_tri


def kf_segments(cfg, kf_id: int) -> tuple:
    """The keyframe segments keyframe ``kf_id`` runs, in order: the
    conditions of the JAX keyframe body's ``lax.cond`` branches. ``cfg``:
    a chunk configuration (its fuse / stats / cull cadence)."""
    seg = ["kf_insert"]
    if cfg.fuse_neighbors > 0 and kf_id >= 2 and kf_id % cfg.fuse_every == 0:
        seg.append("kf_fuse")
    seg.append("kf_ba")
    if kf_id % cfg.stats_every == 0:
        seg.append("kf_stats")
    if cfg.kf_culling and kf_id >= 4 and kf_id % cfg.cull_every == 0:
        seg.append("kf_cull")
    seg.append("kf_end")
    return tuple(seg)


class GraphRegions:
    """Named regions of work on one set of static buffers (``buf``), each
    run as a CUDA graph on the card: what the chunk runners and the
    pipelined frame program (``frame_program.FrameProgram``) share. A
    subclass gives ``region(name)``: the region's function on a buffer set.

    On CUDA (``graphs``), each region is captured once as a CUDA graph on a
    side stream, after a warm-up run of it on a scratch copy of the buffers
    on that stream (library handles, matcher workspaces and device tables
    then exist before capture), each graph in its own memory pool, and then
    replayed; a failed capture or replay raises, nothing falls back to the
    eager path. Off the card the regions run eagerly on the same buffers;
    ``region`` gives any region's eager function on the card too.

    K1 launches: a capture queues none, so ``project_match.LAUNCHES`` gets
    the graph's launches on every replay; the warm-ups launch for real and
    are counted there too, and in ``warmup_launches``."""

    def __init__(self, cfg, device: torch.device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.graphs = self.device.type == "cuda"
        self.buf: dict = {}
        self._graph: dict = {}  # region -> (CUDAGraph, K1 launches a replay)
        self._stream = None
        self._workspaces = {}  # matcher workspaces the graphs hold, by address
        self.warmup_launches = {site: 0 for site in project_match.LAUNCHES}
        self.capture_s = 0.0
        self.runs = collections.Counter()  # region -> runs (replays on the card)
        # With ``timing``: CUDA events around every replay, and the host's
        # gap between a frame's flag read and the next frame's first launch.
        self.timing = False
        self.spans = []  # (region, start event, end event)
        self.gaps_s = []

    def region(self, name):
        """The function of region ``name`` on a buffer set: it reads its
        inputs there and writes its results back there."""
        raise NotImplementedError

    def _run(self, name) -> None:
        self.runs[name] += 1
        fn = self.region(name)
        if not self.graphs:
            fn(self.buf)
            return
        entry = self._graph.get(name)
        if entry is None:
            entry = self._graph[name] = self._capture(fn)
        g, launches = entry
        if self.timing:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            g.replay()
            b.record()
            self.spans.append((name, a, b))
        else:
            g.replay()
        project_match.count_replay(launches)

    def _capture(self, fn):
        t0 = time.perf_counter()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        s = self._stream
        s.wait_stream(torch.cuda.current_stream(self.device))
        before = dict(project_match.LAUNCHES)
        with torch.cuda.stream(s):
            fn({k: v.clone() for k, v in self.buf.items()})
        for site, n in project_match.LAUNCHES.items():
            self.warmup_launches[site] += n - before[site]
        s.synchronize()
        g = torch.cuda.CUDAGraph(keep_graph=True)  # its node list stays readable
        with project_match.captured_launches() as launches:
            with torch.cuda.graph(g, stream=s):
                fn(self.buf)
        # A graph holds the addresses of the matcher workspaces of its
        # stream: keep them alive whatever the cache evicts.
        for ws in project_match.stream_workspaces(s.cuda_stream):
            self._workspaces[ws.data_ptr()] = ws
        self.capture_s += time.perf_counter() - t0
        return g, launches

    @property
    def n_graphs(self) -> int:
        return len(self._graph)


class ChunkRunner(GraphRegions):
    """Runs chunks of a steady state on ``GraphRegions``' machinery: one
    region of the frame step per schedule (``("step", schedule)``) and one
    of each keyframe segment. The buffers hold the carry's leaves, the
    frame's inputs and what a keyframe needs of the frame. A subclass names
    its carry (``CARRY``, with ``NESTED``: the NamedTuple class of each
    field that holds a tuple of leaves), its frame step (``step``), its
    keyframe segments (``SEGMENTS``) and the length of a frame's input row
    (``x_len``). Each region ends by copying every leaf it rebinds back into
    its buffer, so the buffers are the state from one replay to the next."""

    CARRY: type
    NESTED: dict = {}
    SEGMENTS: dict = {}

    @staticmethod
    def step(c, img, x_in, cfg, schedule):
        """One frame: returns (carry, fr), ``fr`` holding ``frame_keys()``,
        the frame's ``row`` and its ``flags`` (need_kf, alive)."""
        raise NotImplementedError

    def x_len(self) -> int:
        raise NotImplementedError

    @property
    def stereo(self) -> bool:
        """Whether a frame is a [2, H, W] stereo pair (the config's flag)."""
        return bool(self.cfg.stereo)

    def frame_keys(self) -> tuple:
        return FRAME_KEYS + (STEREO_KEYS if self.stereo else ())

    # ---- state -------------------------------------------------------
    def carry(self, buf=None):
        """The carry whose leaves are the tensors of ``buf`` (the runner's
        buffers by default)."""
        b = self.buf if buf is None else buf
        kw = {}
        for f in self.CARRY._fields:
            sub = self.NESTED.get(f)
            kw[f] = b[f] if sub is None else sub(*(b[f"{f}.{g}"] for g in sub._fields))
        return self.CARRY(**kw)

    def _leaves(self, c) -> list:
        """(buffer key, leaf) pairs of a carry, in field order."""
        out = []
        for f, v in zip(c._fields, c):
            if f in self.NESTED:
                out += [(f"{f}.{g}", w) for g, w in zip(v._fields, v)]
            else:
                out.append((f, v))
        return out

    def _load(self, c) -> None:
        """Put a chunk's starting state into the buffers: leaves that are
        tensors and not the buffers already are copied in (the per-frame
        path rebinds some); numbers are filled."""
        if not self.buf:
            self._make_buffers(c)
        for k, v in self._leaves(c):
            dst = self.buf[k]
            if not isinstance(v, torch.Tensor):
                dst.fill_(v)
            elif v is not dst:
                dst.copy_(v)

    def _make_buffers(self, c) -> None:
        cfg, dev = self.cfg, self.device
        N = cfg.config.total_cap
        f32, i32 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int32, device=dev)
        b = {}
        for k, v in self._leaves(c):
            if k in CARRY_SCALARS:
                b[k] = torch.zeros((), dtype=CARRY_SCALARS[k], device=dev)
            else:
                b[k] = torch.empty_like(v, device=dev)
        img_shape = (2, cfg.height, cfg.width) if self.stereo else (cfg.height, cfg.width)
        b.update(
            img=torch.zeros(img_shape, **f32),
            x_in=torch.zeros((self.x_len(),), **f32),
            f_xy=torch.zeros((N, 2), **f32), f_level=torch.zeros((N,), **i32),
            f_angle=torch.zeros((N,), **f32),
            f_desc=torch.zeros((N, 256), dtype=torch.int8, device=dev),
            f_valid=torch.zeros((N,), dtype=torch.bool, device=dev),
            f_pt=torch.zeros((N,), **i32), kf_R=torch.zeros((3, 3), **f32),
            kf_t=torch.zeros((3,), **f32), kf_ts=torch.zeros((), **f32),
            kf_id=torch.zeros((), **i32), n_vis=torch.zeros((), **i32),
            row=torch.zeros((ROW_LEN,), **f32), flags=torch.zeros((2,), **i32),
        )
        if self.stereo:
            b.update(f_ur=torch.zeros((N,), **f32), f_depth=torch.zeros((N,), **f32))
        self.buf = b

    def _commit(self, buf: dict, c, fr: dict | None = None) -> None:
        """Copy the leaves of ``c`` (and ``fr``) that are not their buffers
        into them. A leaf that is another buffer (the step's ``kf_id`` is
        the carry's ``n_kf`` it increments) is copied out first."""
        pairs = self._leaves(c) + list((fr or {}).items())
        pairs = [(k, v) for k, v in pairs if v is not buf[k]]
        written = {buf[k].untyped_storage().data_ptr() for k, _ in pairs}
        pairs = [(k, v.clone() if v.untyped_storage().data_ptr() in written else v)
                 for k, v in pairs]
        for k, v in pairs:
            buf[k].copy_(v)

    # ---- regions -----------------------------------------------------
    def region(self, name):
        """The function of region ``name`` (``("step", schedule)`` or a
        keyframe segment) on a buffer set: it reads its inputs there and
        writes its results back there."""
        cfg = self.cfg
        if isinstance(name, tuple):
            schedule = name[1]

            def step(buf):
                c, fr = self.step(self.carry(buf), buf["img"], buf["x_in"], cfg, schedule)
                self._commit(buf, c, fr)

            return step
        seg = self.SEGMENTS[name]

        def kf(buf):
            out = seg(self.carry(buf), {k: buf[k] for k in self.frame_keys()}, cfg)
            c, fr2 = (out, None) if isinstance(out, self.CARRY) else out
            self._commit(buf, c, None if fr2 is None else {"row": fr2["row"]})

        return kf

    # ---- a chunk -----------------------------------------------------
    def run_chunk(self, stack, off: int, xs: torch.Tensor, schedule: tuple, n_kf: int):
        """Frames ``stack[off : off + C]`` with their input rows ``xs``
        [C, x_len] on the device (see the subclass's ``step``), from the
        state in the buffers; ``n_kf`` is the host's keyframe count, which
        names the keyframe segments to replay. Stops after the first frame
        that is not tracked. Returns (rows [n, ROW_LEN] on the device, the
        keyframe ids inserted)."""
        C = xs.shape[0]
        rows = torch.empty((C, ROW_LEN), dtype=torch.float32, device=self.device)
        kf_ids = []
        t_read = None
        for i in range(C):
            if self.timing and t_read is not None:
                self.gaps_s.append(time.perf_counter() - t_read)
            self.buf["img"].copy_(stack[off + i])
            self.buf["x_in"].copy_(xs[i])
            self._run(("step", schedule))
            need_kf, alive = self.buf["flags"].tolist()  # the frame's one host read
            t_read = time.perf_counter()
            if need_kf:
                for seg in kf_segments(self.cfg, n_kf):
                    self._run(seg)
                kf_ids.append(n_kf)
                n_kf += 1
            rows[i].copy_(self.buf["row"])
            if not alive:
                return rows[: i + 1], kf_ids
        return rows, kf_ids
