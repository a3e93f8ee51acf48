"""Card profile of the mapping paths: one keyframe's work split by stage.

    python -m orb_slam3_ros_tpu_torch.utils.profile_keyframe --out DIR
    python -m orb_slam3_ros_tpu_torch.utils.profile_keyframe --out DIR --vi

Maps ``chip_smoke.py``'s mapping sequence (752x480, 1000 features,
``bench.py``'s configuration, 120 frames) from frame 0 on the CUDA card.
The first keyframe from slot 6 on that fuses, refreshes point statistics
and culls runs under ``torch.profiler``, each stage of
``kf_work.keyframe_work`` in a ``record_function`` range, as the plain
function on a copy of its map (the per-frame path runs the keyframe
program, whose graph replays fall in no stage); every kernel is
attributed to the stage whose range launched it. The next such keyframe
is timed stage by stage with host clocks around synchronized calls. Last,
one tracking frame runs under the profiler. Writes ``result.json``, the
chrome traces and the profiler's tables to DIR and prints the result
without the per-frame times.

``--vi`` does the same for the mono-inertial path: ``InertialSlam`` over
``chip_smoke.py``'s 165-frame sequence with IMU samples; after the third
IMU initialization stage one VI keyframe (insert, triangulate, admit, fuse,
``build_vi_ba`` with its window preintegration, ``vi_bundle_adjust``,
apply, culls) is profiled and the next timed by stage, each as the plain
function ``_vi_kf_work`` on a copy of its map (the per-frame path runs the
keyframe program, whose graph replays fall in no stage), then one VI frame
(preintegration, prediction, extraction, tracking, the 15-dof refinement)
is profiled, with no keyframe: its call (the drain of the frame before it
and its dispatch) and the ``flush`` that drains it. The VI frame runs as
one CUDA graph replay, so its kernels fall in no stage's range.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

import numpy as np

from ..models import (inertial_system, kf_program, local_mapping, map_state, map_updates,
                      system, tracking, vi_kf_program)
from ..models.chunk_runner import kf_segments
from ..ops import ba, imu, orb, project_match, viba
from . import synth

# (stage, module, function): the stages keyframe_work calls, in order.
STAGES = (
    ("insert", map_updates, "insert_keyframe"),
    ("triangulate", tracking, "triangulate_with_ref"),
    ("admit", map_updates, "admit_new_points"),
    ("fuse", map_updates, "fuse_in_neighbors"),
    ("window", local_mapping, "select_covis_window"),
    ("build_ba", local_mapping, "build_local_ba"),
    ("ba", ba, "bundle_adjust"),
    ("apply_ba", local_mapping, "apply_local_ba"),
    ("drop_outliers", local_mapping, "drop_ba_outlier_obs"),
    ("cull_points", map_updates, "cull_points"),
    ("stats", map_updates, "refresh_point_stats"),
    ("cull_kf", map_updates, "cull_keyframes"),
)
# the stages of inertial_system._vi_kf_work, then those of a VI frame
VI_STAGES = (
    ("insert", map_updates, "insert_keyframe"),
    ("triangulate", tracking, "triangulate_with_ref"),
    ("admit", map_updates, "admit_new_points"),
    ("fuse", map_updates, "fuse_in_neighbors"),
    ("build_vi_ba", local_mapping, "build_vi_ba"),
    ("preintegrate", imu, "preintegrate"),  # inside build_vi_ba on a keyframe
    ("vi_ba", viba, "vi_bundle_adjust"),
    ("apply_vi_ba", local_mapping, "apply_vi_ba"),
    ("cull_points", map_updates, "cull_points"),
    ("stats", map_updates, "refresh_point_stats"),
    ("cull_kf", map_updates, "cull_keyframes"),
    ("predict", imu, "predict_state"),
    ("extract", orb, "extract"),
    ("track", tracking, "track_against_map"),
    ("vi_refine", inertial_system, "_vi_refine"),
)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
H, W, N_FRAMES = 480, 752, 120
# The mono-inertial configuration (``bench.py``'s ``main_vi``: EuRoC noise
# densities at 100 Hz): ``chip_smoke.py``'s mono-inertial phase and ``--vi``
# here drive the same run from these.
VI_IMU_HZ = 100.0
VI_SEQ_KW = dict(n_frames=165, height=H, width=W, frame_dt=0.1, imu_per_frame=10, seed=0,
                 bg=np.array([0.01, -0.015, 0.02]), noise_g=1e-4, noise_a=1e-3)
VI_SLAM_KW = dict(height=H, width=W, n_features=1000, max_keyframes=64, max_points=4096,
                  kf_every=5, init_after_kf=6, lean_after_kf=4, track_cap=768, fuse_every=3,
                  stats_every=3, cull_every=3, local_ba_iters=4, imu_cap_kf=64, imu_cap_frame=16)


def vi_calib() -> imu.ImuCalib:
    """The IMU noise calibration of the mono-inertial configuration."""
    return imu.ImuCalib(
        sigma_g=np.full(3, 1.7e-4 * np.sqrt(VI_IMU_HZ), np.float32),
        sigma_a=np.full(3, 2e-3 * np.sqrt(VI_IMU_HZ), np.float32),
        sigma_gw=np.full(3, 1.9e-5 / np.sqrt(VI_IMU_HZ), np.float32),
        sigma_aw=np.full(3, 3e-3 / np.sqrt(VI_IMU_HZ), np.float32),
        R_bc=np.eye(3, dtype=np.float32), t_bc=np.zeros(3, np.float32),
    )


class _StageHooks:
    """Replaces each stage function by a wrapper: a ``record_function``
    range named ``stage::<stage>``, or, while ``times`` is a dict, host
    clocks around the synchronized call."""

    def __init__(self, stages=STAGES):
        self.stages = stages
        self.times = None
        self._saved = []

    def install(self):
        for name, mod, attr in self.stages:
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(name, fn))

    def remove(self):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)
        self._saved = []

    def _wrap(self, name, fn):
        def staged(*args, **kw):
            if self.times is None:
                with torch.profiler.record_function(f"stage::{name}"):
                    return fn(*args, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.times[name] = self.times.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out

        return staged


def _profiled(fn, trace: Path, table: Path) -> float:
    """Run ``fn()`` under the profiler inside a ``stage::total`` range;
    export its chrome trace and op table. Returns the host wall ms."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function("stage::total"):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(str(trace))
    table.write_text(prof.key_averages().table(sort_by="cpu_time_total", row_limit=60))
    return wall


def device_profile(fn):
    """(kernels launched, their summed device ms) of one ``fn()`` under
    ``torch.profiler``, from its events in memory; (None, None) where the
    profiler traced nothing on the card."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None, None
    launches = sum("memcpy" not in e.name.lower() and "memset" not in e.name.lower() for e in kernels)
    # ``device_time_total`` was ``cuda_time_total`` in older torch
    us = sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0) for e in kernels)
    return launches, us / 1e3


def stage_split(trace: Path) -> dict:
    """Per ``stage::`` range of a chrome trace: host ms of the range, the
    kernels launched from inside it, their device ms, and the host ms of
    the CUDA API calls made inside it. A kernel counts in the innermost
    range around the API call that launched it (matched by correlation
    id); ``total`` counts everything."""
    events = [e for e in json.loads(trace.read_text())["traceEvents"] if e.get("ph") == "X"]
    ranges = sorted(
        ((e["ts"], e["ts"] + e["dur"], e["name"][len("stage::"):]) for e in events
         if e.get("cat") == "user_annotation" and e["name"].startswith("stage::")),
        key=lambda r: r[1] - r[0],
    )  # innermost first
    out = {name: dict(host_ms=0.0, launches=0, device_ms=0.0, api_ms=0.0) for *_, name in ranges}
    for a, b, name in ranges:
        out[name]["host_ms"] += (b - a) / 1e3

    def owners(ts):
        inner = next((r[2] for r in ranges if r[2] != "total" and r[0] <= ts <= r[1]), None)
        return [n for n in (inner, "total") if n is not None and n in out]

    api = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            for n in owners(e["ts"]):
                out[n]["api_ms"] += e["dur"] / 1e3
            if "correlation" in e.get("args", {}):
                api[e["args"]["correlation"]] = e["ts"]
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        ts = api.get(e.get("args", {}).get("correlation"))
        if ts is None:
            continue
        for n in owners(ts):
            out[n]["device_ms"] += e["dur"] / 1e3
            out[n]["launches"] += e["cat"] == "kernel"
    return out


def profile_vi(out: Path, card: str) -> dict:
    """The ``--vi`` mode: see the module docstring."""
    n_frames = VI_SEQ_KW["n_frames"]
    seq, im = synth.make_vi_sequence(**VI_SEQ_KW)
    slam = inertial_system.InertialSlam(cam_params=seq.cam_params, calib=vi_calib(), **VI_SLAM_KW)
    result = {"card": card}
    hooks = _StageHooks(VI_STAGES)
    run = vi_kf_program.VIKeyframeProgram.run

    def hooked(prog, m, inp):
        # The program's regions replay as CUDA graphs, whose kernels fall in
        # no stage's range: the stages are profiled and timed on the plain
        # function, ``_vi_kf_work``, on a copy of the keyframe's map.
        full = (len(kf_segments(prog.cfg, inp.kf_id)) == len(vi_kf_program.REGIONS)
                and slam.imu_stage == 3)
        if full and "timed_kf" not in result:
            mc = map_state.MapState(*(x.clone() for x in m))

            def eager():
                return vi_kf_program.eager_keyframe(mc, inp, prog.cfg)

            if "profiled_kf" not in result:
                wall = _profiled(eager, out / "vi_kf_trace.json", out / "vi_kf_table.txt")
                result["profiled_kf"] = dict(kf_id=inp.kf_id, wall_ms=wall,
                                             stages=stage_split(out / "vi_kf_trace.json"))
            else:
                hooks.times = {}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eager()
                torch.cuda.synchronize()
                result["timed_kf"] = dict(kf_id=inp.kf_id, wall_ms=(time.perf_counter() - t0) * 1e3,
                                          stages_ms=hooks.times)
                hooks.times = None
        return run(prog, m, inp)

    def frame(i):
        return slam.process_frame(seq.images[i], float(seq.timestamps[i]),
                                  acc=im["acc"][i], gyro=im["gyro"][i], dts=im["dts"][i])

    hooks.install()
    vi_kf_program.VIKeyframeProgram.run = hooked
    frame_ms = []
    try:
        for i in range(n_frames - 1):
            t0 = time.perf_counter()
            frame(i)
            frame_ms.append((time.perf_counter() - t0) * 1e3)
        # One more VI frame, kept from becoming a keyframe, under the profiler.
        slam.activate_localization_mode()
        wall = _profiled(lambda: (frame(n_frames - 1), slam.flush()), out / "vi_frame_trace.json",
                         out / "vi_frame_table.txt")
    finally:
        vi_kf_program.VIKeyframeProgram.run = run
        hooks.remove()
    result["vi_frame"] = dict(wall_ms=wall, stages=stage_split(out / "vi_frame_trace.json"))
    result.update(n_kf=slam.n_kf, imu_stage=slam.imu_stage, init_stage_ms=slam.init_stage_ms,
                  frame_ms=frame_ms)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--vi", action="store_true", help="profile the mono-inertial path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_keyframe: no CUDA device", file=sys.stderr)
        return 2
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    project_match.build()
    if args.vi:
        result = profile_vi(out, card)
        (out / "vi_result.json").write_text(json.dumps(result, indent=1))
        (out / "vi_frame_trace.json").unlink()  # tens of MB; its stage split is in the result
        print(json.dumps({k: v for k, v in result.items() if k != "frame_ms"}))
        return 0
    seq = synth.make_sequence(n_frames=N_FRAMES, height=H, width=W, dt=0.1, seed=3, device="cuda")
    # chip_smoke.py's mapping configuration (bench.py:60-66).
    slam = system.MonoSlam(
        height=H, width=W, cam_params=seq.cam_params, n_features=1000, max_keyframes=64,
        max_points=4096, kf_every=8, fuse_every=3, stats_every=3, cull_every=3,
        lean_after_kf=4, track_cap=768, pipelined=False, device="cuda",
    )
    result = {"card": card}
    hooks = _StageHooks()
    run = kf_program.KeyframeProgram.run

    def hooked(prog, m, inp, defer=False):
        # The program's regions replay as CUDA graphs, whose kernels fall in
        # no stage's range: the stages are profiled and timed on the plain
        # function, ``kf_work.keyframe_work``, on a copy of the keyframe's map.
        full = len(kf_segments(prog.cfg, inp.kf_id)) == len(kf_program.REGIONS) and inp.kf_id >= 6
        if full and "timed_kf" not in result:
            mc = map_state.MapState(*(x.clone() for x in m))

            def eager():
                return kf_program.eager_keyframe(mc, inp, prog.cfg)

            if "profiled_kf" not in result:
                wall = _profiled(eager, out / "kf_trace.json", out / "kf_table.txt")
                result["profiled_kf"] = dict(kf_id=inp.kf_id, wall_ms=wall,
                                             stages=stage_split(out / "kf_trace.json"))
            else:
                hooks.times = {}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eager()
                torch.cuda.synchronize()
                result["timed_kf"] = dict(kf_id=inp.kf_id, wall_ms=(time.perf_counter() - t0) * 1e3,
                                          stages_ms=hooks.times)
                hooks.times = None
        return run(prog, m, inp, defer)

    hooks.install()
    kf_program.KeyframeProgram.run = hooked
    frame_ms = []
    try:
        for i in range(N_FRAMES):
            t0 = time.perf_counter()
            slam.process_frame(seq.images[i], float(seq.timestamps[i]))
            frame_ms.append((time.perf_counter() - t0) * 1e3)
        # One more tracking frame, with no keyframe, under the profiler.
        slam.activate_localization_mode()
        wall = _profiled(
            lambda: slam.process_frame(seq.images[-1], float(seq.timestamps[-1]) + 0.1),
            out / "frame_trace.json", out / "frame_table.txt",
        )
    finally:
        kf_program.KeyframeProgram.run = run
        hooks.remove()
    result["track_frame"] = dict(wall_ms=wall, **stage_split(out / "frame_trace.json")["total"])
    result.update(n_kf=slam.n_kf, ba_iters=slam.ba_iters, frame_ms=frame_ms)
    (out / "result.json").write_text(json.dumps(result, indent=1))
    print(json.dumps({k: v for k, v in result.items() if k != "frame_ms"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
