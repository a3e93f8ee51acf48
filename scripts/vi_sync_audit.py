"""Synchronizing calls of the VI chunk loop's regions on one CUDA card, under
each of torch's choices of linear-algebra backend; optionally then the
chunk loop itself (``chip_smoke.py`` phase 9) from the same state.

    python3 scripts/vi_sync_audit.py [--chunk]

Runs ``InertialSlam`` frame by frame at ``bench.py``'s ``main_vi``
configuration (``utils/profile_keyframe.py``: ``VI_SEQ_KW``, ``VI_SLAM_KW``,
``vi_calib()``) until the chunk gate holds. From that state, for each of
``torch.backends.cuda.preferred_linalg_library`` "default", "magma" and
"cusolver" (the package sets "cusolver" at import), a fresh
``VIChunkRunner`` runs the next frame's step and then every keyframe
segment once, eagerly (``region(name)``), under
``torch.cuda.set_sync_debug_mode("warn")``. Prints, per backend, one JSON
line: each region's host ms (its run and a synchronize) and its
synchronizing calls by file:line. With
``--chunk``, ``chip_smoke.phase_vi_chunk`` then runs from the gate's state
(the CUDA graphs, their times and phase 9's checks) and its result is
printed as one more JSON line. Needs one card; about 80 s with ``--chunk``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from orb_slam3_ros_tpu_torch.models import inertial_system, vi_device_loop  # noqa: E402
from orb_slam3_ros_tpu_torch.ops import project_match  # noqa: E402
from orb_slam3_ros_tpu_torch.utils import synth  # noqa: E402
from orb_slam3_ros_tpu_torch.utils.profile_keyframe import VI_SEQ_KW, VI_SLAM_KW, vi_calib  # noqa: E402

BACKENDS = ("default", "magma", "cusolver")


def audit_regions(slam, stack, ts, im, i) -> dict:
    """Host ms and synchronizing calls (by file:line) of the step on frame
    ``i`` and of each keyframe segment after it, run eagerly once from
    ``slam``'s state."""
    r = vi_device_loop.VIChunkRunner(slam._vi_chunk_config(), slam.device)
    r.load(slam.map, slam._fresh_vi_dev_state(), slam.n_kf, slam.n_pts, slam.last_kf_frame, -1)
    M = slam.imu_cap_frame
    x = np.zeros((M * 7 + 2,), np.float32)
    n = len(im["dts"][i])
    blk = x[: M * 7].reshape(M, 7)
    blk[:n, 0:3], blk[:n, 3:6], blk[:n, 6] = im["acc"][i], im["gyro"][i], im["dts"][i]
    x[M * 7 :] = (ts[i], slam.frame_id)
    r.buf["img"].copy_(stack[i])
    r.buf["x_in"].copy_(torch.from_numpy(x))
    out = {}
    for name in [("step", slam._current_schedule()), *vi_device_loop.KF_SEGMENTS]:
        fn = r.region(name)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                fn(r.buf)
                torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        where = {}
        for w in caught:
            if "synchroniz" in str(w.message):
                k = f"{Path(w.filename).name}:{w.lineno}"
                where[k] = where.get(k, 0) + 1
        out["step" if isinstance(name, tuple) else name] = dict(
            host_ms=(time.perf_counter() - t0) * 1e3, syncs=where
        )
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunk", action="store_true", help="then run chip_smoke.py's phase 9")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("vi_sync_audit: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    project_match.build()
    seq, im = synth.make_vi_sequence(**VI_SEQ_KW)
    slam = inertial_system.InertialSlam(cam_params=seq.cam_params, calib=vi_calib(), **VI_SLAM_KW)
    gate = chip_smoke.CHUNK_WARM - 2 * chip_smoke.CHUNK  # bench.py main_vi's per-frame limit
    i, init_frame = 0, None
    while i < gate and not slam._vi_chunkable():
        out = slam.process_frame(seq.images[i], float(seq.timestamps[i]), acc=im["acc"][i],
                                 gyro=im["gyro"][i], dts=im["dts"][i])
        if init_frame is None and out is not None:
            init_frame = i
        i += 1
    chip_smoke.check(slam._vi_chunkable(), f"the chunk gate did not hold by frame {gate}")
    print(f"chunk gate holds at frame {i} ({slam.n_kf} keyframes, map initialized at frame "
          f"{init_frame})")
    stack = torch.clamp(seq.images, 0, 255).to(torch.uint8)
    chosen = torch.backends.cuda.preferred_linalg_library()
    try:
        for lib in BACKENDS:
            torch.backends.cuda.preferred_linalg_library(lib)
            regions = audit_regions(slam, stack, seq.timestamps, im, i)
            print(json.dumps({"backend": lib, "regions": regions}), flush=True)
    finally:
        torch.backends.cuda.preferred_linalg_library(chosen)
    if args.chunk:
        # The gate holds on the frame after IMU stage 3: no steady per-frame
        # VI frame to print beside the chunks' (nan).
        vi8 = dict(init_frame=init_frame, frames_per_s=float("nan"), frame_ms_p50=float("nan"))
        vc = chip_smoke.phase_vi_chunk(torch, project_match, vi8, (i, slam, seq, im))
        print(json.dumps({"vi_chunk": vc, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
