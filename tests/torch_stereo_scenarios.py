"""The stereo and RGB-D scenarios of ``chip_smoke.py`` phase 15, run by the
JAX package or by the port: the numbers phase 15 holds the card to.

    python3 tests/torch_stereo_scenarios.py --package jax   [--part acd] [--frames N]
    python3 tests/torch_stereo_scenarios.py --package torch [--part acd] [--frames N]
        [--device cuda]

(a) ``scripts/bench_variants.py::run_stereo``: the KITTI shape (1242x376
pairs, 2000 features, 0.54 m baseline), ``make_sequence(seed=3, dt=0.1)``,
``StereoSlam`` with ``chip_smoke.ST_SLAM_KW`` and ``bench.py``'s lean
schedule; frame by frame until the chunk gate holds, chunks of 15 to frame
45 (frame by frame to there), then chunks to the end. (c) phase 8's configuration
(``profile_keyframe.VI_SEQ_KW`` / ``VI_SLAM_KW`` / ``vi_calib``) with a
0.11 m stereo rig and ``chip_smoke.SVI_MAX_POINTS`` point slots:
``StereoInertialSlam`` frame by frame until
``_vi_chunkable()``, then chunks of 15 of a uint8 stack. (d) ``RgbdSlam``
at 640x480 with 1000 features over ``make_sequence(seed=3)`` with depth,
and ``RgbdInertialSlam`` at 640x480 over phase 8's IMU sequence with
depth, both frame by frame. ``--frames`` shortens (a) and (c) (the same
protocol over fewer frames); ``--per-frame`` runs (c) without chunks.

Prints one JSON line a part: the frame of the first pose, the frames
without one after it, keyframes, the metric ATE (no scale alignment; (c)
and (d)'s inertial run skip their first 12 poses) and the scale of a
Sim(3) fit; (c) also the IMU stage, the gravity alignment's R[2,2], the
gyro bias error, the resets and the metric ATE over frames 12..64 and 65
on; and the run's seconds.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # the repo root

import chip_smoke as cs  # noqa: E402  (protocol constants; imports numpy only)

CHUNK = 15


class _Package:
    """The classes, sequences and stacks of one package."""

    def __init__(self, name: str, device: str):
        self.name, self.device = name, device
        if name == "jax":
            import jax

            jax.config.update("jax_platforms", "cpu")
            import jax.numpy as jnp

            from orb_slam3_ros_tpu.models import stereo_system
            from orb_slam3_ros_tpu.ops import imu
            from orb_slam3_ros_tpu.utils import synth

            self.jnp, self.imu = jnp, imu
        else:
            import torch

            from orb_slam3_ros_tpu_torch.models import stereo_system
            from orb_slam3_ros_tpu_torch.utils import synth

            self.torch = torch
            torch.set_num_threads(4)
        self.ss, self.synth = stereo_system, synth

    def kw(self) -> dict:
        return {} if self.name == "jax" else dict(device=self.device)

    def seq(self, **kw):
        return self.synth.make_sequence(**kw, **self.kw())

    def vi_seq(self, **kw):
        return self.synth.make_vi_sequence(**kw, **self.kw())

    def system(self, cls: str, **kw):
        slam = getattr(self.ss, cls)(**kw, **self.kw())
        if self.name == "jax":
            slam._warm_schedules = lambda: None  # compiles ahead only
        return slam

    def calib(self):
        from orb_slam3_ros_tpu_torch.utils.profile_keyframe import vi_calib

        c = vi_calib()
        if self.name == "jax":
            return self.imu.ImuCalib(*(self.jnp.asarray(x) for x in c))
        return c

    def pair_stack(self, seq):
        """[N, 2, H, W] uint8 pairs on the package's device."""
        if self.name == "jax":
            return self.jnp.asarray(np.clip(np.stack([seq.images, seq.images_right], 1), 0, 255)
                                    .astype(np.uint8))
        t = self.torch
        return t.clamp(t.stack([seq.images, seq.images_right], 1), 0, 255).to(t.uint8)


def _metrics(slam, seq, skip: int = 0) -> dict:
    from orb_slam3_ros_tpu_torch.utils.evaluate_ate import align_umeyama, ate_rmse

    traj = slam.get_trajectory()
    ts = np.asarray([t for t, _ in traj])[skip:]
    est = np.stack([np.asarray(T)[:3, 3] for _, T in traj])[skip:]
    gt_ts = np.asarray(seq.timestamps, np.float64)
    metric, n, _ = ate_rmse(ts, est, gt_ts, seq.t_wc, with_scale=False)
    _, _, scale = ate_rmse(ts, est, gt_ts, seq.t_wc, with_scale=True)
    gt = seq.t_wc[np.clip(np.searchsorted(gt_ts, ts - 1e-6), 0, len(gt_ts) - 1)]
    _, R, _ = align_umeyama(est, gt, with_scale=True)
    return dict(poses=len(traj), scored=int(n), ate_metric_m=float(metric), scale=float(scale),
                r22=float(R[2, 2]), keyframes=int(slam.n_kf))


def _per_frame(slam, step, i: int, first: list, lost: list) -> None:
    out = step(i)
    if out is not None and not first:
        first.append(i)
    elif out is None and first:
        lost.append(i)


def part_a(pk: _Package, n_frames: int) -> dict:
    seq = pk.seq(n_frames=n_frames, height=cs.ST_H, width=cs.ST_W, dt=0.1, seed=3,
                 stereo_baseline=cs.ST_BASE)
    slam = pk.system("StereoSlam", height=cs.ST_H, width=cs.ST_W, cam_params=seq.cam_params,
                     baseline=cs.ST_BASE, **cs.ST_SLAM_KW)
    slam._sched_lean = cs.BENCH_LEAN
    pairs = pk.pair_stack(seq)
    first, lost = [], []

    def step(i):
        return slam.process_frame(seq.images[i], seq.images_right[i], float(seq.timestamps[i]))

    t0 = time.perf_counter()
    i = 0
    while (slam.state != pk.ss.OK or not slam._chunkable()) and i < cs.ST_WARM - CHUNK:
        _per_frame(slam, step, i, first, lost)
        i += 1
    gate = i
    for end in (min(cs.ST_WARM, n_frames), n_frames):  # to the timed chunks' start, then on
        while i + CHUNK <= end:
            slam.process_frames((pairs, i), seq.timestamps[i : i + CHUNK])
            i += CHUNK
        while i < end:
            _per_frame(slam, step, i, first, lost)
            i += 1
    slam.flush()
    out = _metrics(slam, seq)
    out.update(part="a", first_pose=first[0] if first else None, lost_per_frame=lost,
               chunkable_at=gate, state=int(slam.state), seconds=time.perf_counter() - t0)
    return out


def _segments(slam, seq, bounds) -> dict:
    """The metric ATE over frames [lo, hi) for each (lo, hi) of ``bounds``."""
    from orb_slam3_ros_tpu_torch.utils.evaluate_ate import ate_rmse

    traj = slam.get_trajectory()
    ts = np.asarray([t for t, _ in traj])
    est = np.stack([np.asarray(T)[:3, 3] for _, T in traj])
    gt_ts = np.asarray(seq.timestamps, np.float64)
    out = {}
    for lo, hi in bounds:
        sel = (ts >= gt_ts[lo] - 1e-6) & (ts <= gt_ts[hi - 1] + 1e-6)
        out[f"ate_metric_m_{lo}_{hi}"] = float(ate_rmse(ts[sel], est[sel], gt_ts, seq.t_wc,
                                                        with_scale=False)[0])
    return out


def part_c(pk: _Package, n_frames: int, per_frame: bool = False) -> dict:
    from orb_slam3_ros_tpu_torch.utils import profile_keyframe as pkf

    seq, im = pk.vi_seq(**{**pkf.VI_SEQ_KW, "n_frames": n_frames}, stereo_baseline=cs.SVI_BASE)
    slam = pk.system("StereoInertialSlam", cam_params=seq.cam_params, calib=pk.calib(),
                     baseline=cs.SVI_BASE,
                     **{**pkf.VI_SLAM_KW, "max_points": cs.SVI_MAX_POINTS})
    pairs = pk.pair_stack(seq)
    first, lost = [], []

    def step(i):
        return slam.process_frame(seq.images[i], seq.images_right[i], float(seq.timestamps[i]),
                                  acc=im["acc"][i], gyro=im["gyro"][i], dts=im["dts"][i])

    t0 = time.perf_counter()
    i = 0
    while i < n_frames and not slam._vi_chunkable():
        _per_frame(slam, step, i, first, lost)
        i += 1
    gate = i
    while i + CHUNK <= n_frames and not per_frame:
        s = slice(i, i + CHUNK)
        slam.process_frames((pairs, i), seq.timestamps[s], acc=im["acc"][s], gyro=im["gyro"][s],
                            dts=im["dts"][s])
        i += CHUNK
    while i < n_frames:
        _per_frame(slam, step, i, first, lost)
        i += 1
    slam.flush()
    out = _metrics(slam, seq, skip=cs.VI_SKIP)
    out.update(part="c", first_pose=first[0] if first else None, lost_per_frame=lost,
               chunkable_at=gate, state=int(slam.state), imu_stage=int(slam.imu_stage),
               fix_scale=bool(slam.imu_fix_scale), resets=int(getattr(slam, "bad_imu_resets", 0)),
               bg_err=float(np.abs(np.asarray(slam.bg_cur) - im["bg"]).max()),
               seconds=time.perf_counter() - t0, per_frame=per_frame,
               **_segments(slam, seq, [(cs.VI_SKIP, 65), (65, n_frames)]))
    return out


def part_d(pk: _Package) -> list:
    from orb_slam3_ros_tpu_torch.utils import profile_keyframe as pkf

    outs = []
    t0 = time.perf_counter()
    seq = pk.seq(n_frames=cs.RGBD_FRAMES, height=cs.RGBD_H, width=cs.RGBD_W, dt=0.1, seed=3,
                 with_depth=True)
    slam = pk.system("RgbdSlam", height=cs.RGBD_H, width=cs.RGBD_W, cam_params=seq.cam_params,
                     **cs.RGBD_SLAM_KW)
    first, lost = [], []
    for i in range(cs.RGBD_FRAMES):
        _per_frame(slam, lambda i: slam.process_frame(seq.images[i], seq.depths[i],
                                                      float(seq.timestamps[i])), i, first, lost)
    out = _metrics(slam, seq)
    out.update(part="d_rgbd", first_pose=first[0] if first else None, lost_per_frame=lost,
               state=int(slam.state), seconds=time.perf_counter() - t0)
    outs.append(out)

    t0 = time.perf_counter()
    shape = dict(height=cs.RGBD_H, width=cs.RGBD_W)
    seq, im = pk.vi_seq(**{**pkf.VI_SEQ_KW, "n_frames": cs.RGBD_VI_FRAMES, **shape},
                        with_depth=True)
    slam = pk.system("RgbdInertialSlam", cam_params=seq.cam_params, calib=pk.calib(),
                     **{**pkf.VI_SLAM_KW, **shape})
    first, lost = [], []
    for i in range(cs.RGBD_VI_FRAMES):
        _per_frame(slam, lambda i: slam.process_frame(
            seq.images[i], seq.depths[i], float(seq.timestamps[i]), acc=im["acc"][i],
            gyro=im["gyro"][i], dts=im["dts"][i]), i, first, lost)
    out = _metrics(slam, seq, skip=cs.VI_SKIP)
    out.update(part="d_rgbd_vi", first_pose=first[0] if first else None, lost_per_frame=lost,
               state=int(slam.state), imu_initialized=bool(slam.imu_initialized),
               imu_stage=int(slam.imu_stage), seconds=time.perf_counter() - t0)
    outs.append(out)
    return outs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--part", default="acd", help="any of a, c, d")
    ap.add_argument("--frames", type=int, default=None, help="frames of (a) and (c)")
    ap.add_argument("--device", default="cpu", help="the port's device")
    ap.add_argument("--per-frame", action="store_true", help="(c) without chunks")
    args = ap.parse_args()
    pk = _Package(args.package, args.device)
    from orb_slam3_ros_tpu_torch.utils import profile_keyframe as pkf

    if "a" in args.part:
        print(json.dumps(part_a(pk, args.frames or cs.ST_FRAMES)), flush=True)
    if "c" in args.part:
        print(json.dumps(part_c(pk, args.frames or pkf.VI_SEQ_KW["n_frames"], args.per_frame)),
              flush=True)
    if "d" in args.part:
        for out in part_d(pk):
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
