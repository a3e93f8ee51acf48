"""Observability: the leveled logger and the per-frame event stream — port of
``orb_slam3_ros_tpu.utils.obslog`` (numpy and the standard library only).

Headless counterpart of the reference's observability surface: the
``Verbose::PrintMess`` leveled logger (orb_slam3/include/System.h:47-72,
default QUIET) and the ROS publisher set (camera pose, tracked points,
keyframe markers, state; src/common.cc:65-118). Instead of ROS topics,
consumers set a system's ``on_frame`` callback, or install a
``FrameStreamer`` there, which writes one JSON line an event. Events carry
numpy arrays and Python scalars, never tensors: the systems read them on
the host before they emit.
"""

from __future__ import annotations

import json
import sys
import time
from typing import IO

import numpy as np

QUIET = 0
NORMAL = 1
VERBOSE = 2
DEBUG = 3

FLUSH_EVERY = 25  # events between flushes of a FrameStreamer's file
_LEVEL_NAMES = {QUIET: "quiet", NORMAL: "normal", VERBOSE: "verbose", DEBUG: "debug"}
_level = QUIET
_sink: IO = sys.stderr


def set_level(level: int) -> None:
    """Global verbosity (Verbose::SetTh role; default QUIET like
    System.cc:220)."""
    global _level
    _level = level


def get_level() -> int:
    return _level


def log(msg: str, level: int = NORMAL) -> None:
    """Print ``msg`` when the global verbosity admits ``level``
    (Verbose::PrintMess contract)."""
    if level <= _level:
        print(f"[orb-tpu {_LEVEL_NAMES.get(level, level)}] {msg}",
              file=_sink, flush=True)


class FrameStreamer:
    """Per-frame event stream to a JSONL file — the headless analogue of
    the pose/odometry/keyframe-marker publishers. Install with
    ``slam.on_frame = FrameStreamer(path)``; call ``close()`` (or use as
    a context manager) when done.

    Events:
      frame:          ts, Twc (4x4 row-major), n_inliers, state, n_kf
      keyframe:       ts, kf_id
      loop:           new_kf, cand_kf
      tracked_points: ts, n, points (flattened [n,3] world xyz) — the
                      tracked-point-cloud publisher role
      map_points:     ts, n, points — the all-map-points publisher role
      kf_markers:     ts, n, centers (flattened [n,3] camera centers)
    (point-cloud events fire at the pipeline's ``points_every`` cadence;
    src/common.cc:273-369 is the reference surface.)
    """

    def __init__(self, path: str):
        self._f = open(path, "w")
        self._n = 0
        self.t0 = time.time()

    def __call__(self, event: dict) -> None:
        rec = {}
        for k, v in event.items():
            if isinstance(v, np.ndarray):
                rec[k] = np.asarray(v).reshape(-1).tolist()
            elif isinstance(v, (np.floating, np.integer)):
                rec[k] = v.item()
            else:
                rec[k] = v
        rec["wall"] = round(time.time() - self.t0, 4)
        self._f.write(json.dumps(rec) + "\n")
        self._n += 1
        if self._n % FLUSH_EVERY == 0:
            self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
