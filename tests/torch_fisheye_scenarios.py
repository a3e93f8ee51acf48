"""The fisheye scenarios of ``chip_smoke.py`` phase 16, run by the JAX
package or by the port: the numbers phase 16 holds the card to.

    python3 tests/torch_fisheye_scenarios.py --package jax   [--part abcdefg] [--size test]
    python3 tests/torch_fisheye_scenarios.py --package torch [--part abcdefg] [--device cuda]

The TUM-VI shape (ORB-SLAM3's Examples/Stereo-Inertial/TUM-VI.yaml): 512x512
KB8 frames, cam0's intrinsics, 1000 features a view. (a) ``MonoSlam(cam_model
="kb8")`` over ``make_room(seed=2)`` and ``orbit_trajectory(120, dt=0.05)``
(20 Hz) at ``chip_smoke.FE_SLAM_KW`` with ``bench.py``'s lean schedule:
frame by frame until the chunk gate holds, chunks of 15 to frame 45, then
chunks to the end. (b) ``FisheyeStereoSlam``: the right camera 0.101 m
along x and yawed 2 degrees (``tests/test_fisheye_stereo.py``'s rig at
TUM-VI's baseline), the orbit at 10 Hz over 60 frames, frame by frame.
(c) ``FisheyeStereoInertialSlam(cam_model="pinhole")``, the JAX test's
camera: phase 8's 752x480 sequence and calibration (100 Hz IMU samples,
``profile_keyframe.VI_SEQ_KW`` / ``VI_SLAM_KW`` / ``vi_calib``) with a
0.11 m pure-translation rig, ``kf_every`` 3, 45 frames, frame by frame.
(d) the rectified route: KB8 frames rendered at 1.5x (768x768), remapped
to ``rectify.virtual_pinhole_params`` at 512x512 by ``remap_bilinear`` on
one precomputed ``kb8_rect_map``, into the pinhole ``MonoSlam``; 25 frames
of the orbit at 10 Hz (``tests/test_rectify.py``'s scenario).

The numbers of ``chip_smoke.py`` phase 19 (``chip_smoke.KB8_JAX``): (e)
``InertialSlam`` through phase 9's protocol (``bench.py``'s ``main_vi``:
per frame until ``_vi_chunkable()``, chunks of 15 to frame 105, chunks to
165) on phase 8's sequence, pinhole at 752x480; (f) the same trajectory,
IMU and room seen through the KB8 camera at the TUM-VI shape,
``InertialSlam(cam_model="kb8")``; (g) ``FisheyeStereoInertialSlam()`` at
its KB8 default on (b)'s rig, both views of phase 8's trajectory rendered
KB8, 45 frames, frame by frame. The JAX package projects the KB8 runs'
visual-inertial rows through the pinhole model (ROADMAP "Known faults"):
(f) and (g) record what that gives, the port is not held to them.
``--size test`` runs (c), (e), (f) and (g) at the CPU tests' size
(``tests/test_torch_kb8_vi.py``): 240x376, the repo's test KB8, (e) and (f)
``tests/test_torch_inertial_e2e.py``'s 45 frames and settings, (c) and (g)
``tests/test_torch_fisheye_e2e.py``'s 40-frame inertial rig (0.12 m along
x), frame by frame.

Prints one JSON line a part: the frame of the first pose, the frames without
one after it, keyframes, the ATE (Sim(3) for (a) and (d), metric without
scale alignment for (b), (c), (e), (f), (g); (e) and (f) skip the first 12
poses, as ``bench.py`` does) and the scale of a Sim(3) fit, the IMU state
of the inertial runs, and the run's seconds.
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
# The CPU tests' size (--size test): the repo's test KB8 at 240x376
# (tests/test_torch_kb8.py), the mono-inertial settings of
# tests/test_torch_inertial_e2e.py and the inertial rig of
# tests/test_torch_fisheye_e2e.py.
TEST_KB8 = np.asarray([150.0, 150.0, 187.5, 119.5, 0.02, 0.001, -0.002, 0.0002], np.float32)
TEST_H, TEST_W, TEST_VI_FRAMES, TEST_RIG_FRAMES, TEST_BASE = 240, 376, 45, 40, 0.12
TEST_SEQ_KW = dict(frame_dt=0.1, imu_per_frame=10, seed=0, bg=np.array([0.01, -0.015, 0.02]),
                   noise_g=1e-4, noise_a=1e-3)
TEST_VI_KW = dict(n_features=1200, max_keyframes=32, max_points=4096, kf_every=3,
                  init_after_kf=6)
TEST_RIG_KW = dict(n_features=1000, max_keyframes=32, max_points=4096, kf_every=3,
                   init_after_kf=6)
VI_SKIP = 12


class _Package:
    """The systems, renderer and rectification of one package."""

    def __init__(self, name: str, device: str):
        self.name, self.device = name, device
        if name == "jax":
            import jax

            jax.config.update("jax_platforms", "cpu")
            import jax.numpy as jnp

            from orb_slam3_ros_tpu.models import fisheye_stereo, system
            from orb_slam3_ros_tpu.models.inertial_system import InertialSlam
            from orb_slam3_ros_tpu.ops import imu, rectify
            from orb_slam3_ros_tpu.utils import synth

            self.jnp, self.imu = jnp, imu
        else:
            import torch

            from orb_slam3_ros_tpu_torch.models import fisheye_stereo, system
            from orb_slam3_ros_tpu_torch.models.inertial_system import InertialSlam
            from orb_slam3_ros_tpu_torch.ops import rectify
            from orb_slam3_ros_tpu_torch.utils import synth

            self.torch = torch
            torch.set_num_threads(4)
        self.fs, self.sys, self.rectify, self.synth = fisheye_stereo, system, rectify, synth
        self.InertialSlam = InertialSlam

    def kw(self) -> dict:
        return {} if self.name == "jax" else dict(device=self.device)

    def system(self, cls, **kw):
        slam = cls(pipelined=False, **kw, **self.kw()) if self.name != "jax" else cls(pipelined=False, **kw)
        if self.name == "jax":
            slam._warm_schedules = lambda: None  # compiles ahead only
        return slam

    def scene(self):
        return self.synth.make_room(seed=2, **self.kw())

    def render(self, scene, R_wc, t_wc, cam, h, w):
        if self.name == "jax":
            jnp = self.jnp
            img, depth = self.synth.render(scene, jnp.asarray(R_wc), jnp.asarray(t_wc),
                                           jnp.asarray(cam), height=h, width=w, cam_model="kb8")
            return np.asarray(img), np.asarray(depth)
        return self.synth.render(scene, R_wc, t_wc, cam, height=h, width=w, cam_model="kb8")

    def room(self, seed: int):
        return self.synth.make_room(seed=seed, **self.kw())

    def stack(self, imgs):
        """[N, H, W] uint8 frames on the package's device."""
        if self.name == "jax":
            return self.jnp.asarray(np.clip(np.stack(imgs), 0, 255).astype(np.uint8))
        t = self.torch
        return t.clamp(t.stack(imgs), 0, 255).to(t.uint8)

    def calib(self, test: bool = False):
        """Phase 8's IMU calibration, or with ``test`` the CPU tests'
        (``tests/vi_sim.py``'s ``make_calib(freq=100.0)``)."""
        from orb_slam3_ros_tpu_torch.utils.profile_keyframe import vi_calib

        if test:
            from vi_sim import make_calib

            c = [np.asarray(x, np.float32) for x in make_calib(freq=100.0)]
        else:
            c = vi_calib()
        if self.name == "jax":
            return self.imu.ImuCalib(*(self.jnp.asarray(x) for x in c))
        from orb_slam3_ros_tpu_torch.ops import imu

        return imu.ImuCalib(*c)


def _metrics(slam, t_wc, ts, with_scale: bool) -> dict:
    return dict(cs.traj_ate(slam, ts, t_wc, with_scale), keyframes=int(slam.n_kf))


def _per_frame(step, i: int, first: list, lost: list) -> None:
    out = step(i)
    if out is not None and not first:
        first.append(i)
    elif out is None and first:
        lost.append(i)


def part_a(pk: _Package) -> dict:
    scene = pk.scene()
    R_wc, t_wc, ts = pk.synth.orbit_trajectory(cs.FE_FRAMES, dt=cs.FE_DT)
    imgs = [pk.render(scene, R_wc[i], t_wc[i], cs.FE_KB8, cs.FE_H, cs.FE_W)[0]
            for i in range(cs.FE_FRAMES)]
    stack = pk.stack(imgs)
    slam = pk.system(pk.sys.MonoSlam, height=cs.FE_H, width=cs.FE_W, cam_params=cs.FE_KB8,
                     cam_model="kb8", **cs.FE_SLAM_KW)
    slam._sched_lean = cs.BENCH_LEAN
    first, lost = [], []

    def step(i):
        return slam.process_frame(imgs[i], float(ts[i]))

    t0 = time.perf_counter()
    i = 0
    while (slam.state != pk.sys.OK or not slam._chunkable()) and i < cs.MONO_WARM - CHUNK:
        _per_frame(step, i, first, lost)
        i += 1
    gate = i
    for end in (cs.MONO_WARM, cs.FE_FRAMES):
        while i + CHUNK <= end:
            slam.process_frames((stack, i), ts[i : i + CHUNK])
            i += CHUNK
        while i < end:
            _per_frame(step, i, first, lost)
            i += 1
    out = _metrics(slam, t_wc, ts, with_scale=True)
    out.update(part="a", first_pose=first[0] if first else None, lost_per_frame=lost,
               chunkable_at=gate, state=int(slam.state), seconds=time.perf_counter() - t0)
    return out


def part_b(pk: _Package) -> dict:
    scene = pk.scene()
    n = cs.FE_ST_FRAMES
    R_wc, t_wc, ts = pk.synth.orbit_trajectory(n, dt=cs.FE_ST_DT)
    R_rl, t_rl = cs.fe_rig()
    slam = pk.system(pk.fs.FisheyeStereoSlam, height=cs.FE_H, width=cs.FE_W,
                     cam_params=cs.FE_KB8, R_rl=R_rl, t_rl=t_rl, **cs.FE_ST_KW)
    first, lost = [], []
    t0 = time.perf_counter()
    for i in range(n):
        img_l, _ = pk.render(scene, R_wc[i], t_wc[i], cs.FE_KB8, cs.FE_H, cs.FE_W)
        c_r = t_wc[i] + R_wc[i] @ (-R_rl.T @ t_rl)  # the right camera's centre
        img_r, _ = pk.render(scene, R_wc[i] @ R_rl.T, c_r, cs.FE_KB8, cs.FE_H, cs.FE_W)
        _per_frame(lambda i: slam.process_frame(img_l, img_r, float(ts[i])), i, first, lost)
    out = _metrics(slam, t_wc, ts, with_scale=False)
    out.update(part="b", first_pose=first[0] if first else None, lost_per_frame=lost,
               state=int(slam.state), seconds=time.perf_counter() - t0)
    return out


def _vi_seq_kw(test: bool, n_frames: int) -> dict:
    """``make_vi_sequence``'s arguments: phase 8's sequence, or the CPU
    tests' (``--size test``)."""
    from orb_slam3_ros_tpu_torch.utils import profile_keyframe as pkf

    if test:
        return dict(TEST_SEQ_KW, n_frames=n_frames, height=TEST_H, width=TEST_W)
    return {**pkf.VI_SEQ_KW, "n_frames": n_frames}


def part_c(pk: _Package, test: bool = False) -> dict:
    n = TEST_RIG_FRAMES if test else cs.FE_VI_FRAMES
    base = TEST_BASE if test else cs.SVI_BASE
    kw = _vi_seq_kw(test, n)
    seq, im = pk.synth.make_vi_sequence(**kw, stereo_baseline=base, **pk.kw())
    slam = pk.system(pk.fs.FisheyeStereoInertialSlam, height=kw["height"], width=kw["width"],
                     cam_params=seq.cam_params,
                     calib=pk.calib(test), R_rl=np.eye(3, dtype=np.float32),
                     t_rl=np.asarray([-base, 0.0, 0.0], np.float32),
                     cam_model="pinhole", **(TEST_RIG_KW if test else cs.FE_VI_KW))
    first, lost = [], []
    t0 = time.perf_counter()
    for i in range(n):
        _per_frame(lambda i: slam.process_frame(
            seq.images[i], seq.images_right[i], float(seq.timestamps[i]), acc=im["acc"][i],
            gyro=im["gyro"][i], dts=im["dts"][i]), i, first, lost)
    out = _metrics(slam, seq.t_wc, seq.timestamps, with_scale=False)
    out.update(part="c", first_pose=first[0] if first else None, lost_per_frame=lost,
               state=int(slam.state), imu_initialized=bool(slam.imu_initialized),
               imu_fix_scale=bool(slam.imu_fix_scale), imu_stage=int(slam.imu_stage),
               seconds=time.perf_counter() - t0)
    return out


def _kb8_views(pk: _Package, seq, cam, h: int, w: int, rig=None):
    """The sequence's poses seen through the KB8 camera ``cam`` in its room
    (``make_vi_sequence``'s, seed 0): (left views, right views or None)."""
    scene = pk.room(0)
    left = [pk.render(scene, seq.R_wc[i], seq.t_wc[i], cam, h, w)[0]
            for i in range(len(seq.timestamps))]
    if rig is None:
        return left, None
    R_rl, t_rl = rig
    right = [pk.render(scene, seq.R_wc[i] @ R_rl.T, seq.t_wc[i] + seq.R_wc[i] @ (-R_rl.T @ t_rl),
                       cam, h, w)[0] for i in range(len(seq.timestamps))]
    return left, right


def _vi_part(pk: _Package, part: str, kb8: bool, test: bool) -> dict:
    """(e) / (f): ``InertialSlam`` on phase 8's trajectory and IMU through
    the pinhole or the KB8 camera; phase 9's protocol, or per frame at the
    test size."""
    from orb_slam3_ros_tpu_torch.utils import profile_keyframe as pkf

    n = TEST_VI_FRAMES if test else pkf.VI_SEQ_KW["n_frames"]
    kw = _vi_seq_kw(test, n)
    cam, h, w = ((TEST_KB8, TEST_H, TEST_W) if test else (cs.FE_KB8, cs.FE_H, cs.FE_W))
    if kb8:
        kw.update(height=h, width=w)
    seq, im = pk.synth.make_vi_sequence(**kw, **pk.kw())
    imgs, cam_params = (_kb8_views(pk, seq, cam, h, w)[0], cam) if kb8 else (
        list(seq.images), seq.cam_params)
    slam_kw = dict(TEST_VI_KW) if test else {k: v for k, v in pkf.VI_SLAM_KW.items()
                                             if k not in ("height", "width")}
    slam = pk.system(pk.InertialSlam, height=kw["height"], width=kw["width"],
                     cam_params=cam_params, cam_model="kb8" if kb8 else "pinhole",
                     calib=pk.calib(test), **slam_kw)

    def step(i):
        return slam.process_frame(imgs[i], float(seq.timestamps[i]), acc=im["acc"][i],
                                  gyro=im["gyro"][i], dts=im["dts"][i])

    first, lost = [], []
    t0 = time.perf_counter()
    i, gate = 0, None
    if test:
        for i in range(n):
            _per_frame(step, i, first, lost)
    else:
        while i < cs.CHUNK_WARM - 2 * CHUNK and not slam._vi_chunkable():
            _per_frame(step, i, first, lost)
            i += 1
        gate, stack = i, pk.stack(imgs)
        while i + CHUNK <= n:
            slam.process_frames((stack, i), seq.timestamps[i : i + CHUNK],
                                acc=im["acc"][i : i + CHUNK], gyro=im["gyro"][i : i + CHUNK],
                                dts=im["dts"][i : i + CHUNK])
            i += CHUNK
    getattr(slam, "flush", lambda: None)()
    out = _skip_metrics(slam, seq.t_wc, seq.timestamps)
    out.update(part=part, size="test" if test else "full", first_pose=first[0] if first else None,
               lost_per_frame=lost, chunkable_at=gate, state=int(slam.state),
               imu_initialized=bool(slam.imu_initialized), imu_stage=int(slam.imu_stage),
               bad_imu_resets=int(slam.bad_imu_resets), seconds=time.perf_counter() - t0)
    return out


def _skip_metrics(slam, t_wc, ts) -> dict:
    """The metric ATE, the scale and the gravity alignment over the poses
    after the first 12 (``bench.py``'s ``main_vi``)."""
    from orb_slam3_ros_tpu_torch.utils.evaluate_ate import ate_rmse

    traj = slam.get_trajectory()
    tss = np.asarray([t for t, _ in traj])[VI_SKIP:]
    est = np.stack([np.asarray(T)[:3, 3] for _, T in traj])[VI_SKIP:]
    gt_ts = np.asarray(ts, np.float64)
    metric, n, _ = ate_rmse(tss, est, gt_ts, np.asarray(t_wc), with_scale=False)
    _, _, scale = ate_rmse(tss, est, gt_ts, np.asarray(t_wc), with_scale=True)
    return dict(ate_m=float(metric), scored=int(n), scale=float(scale), keyframes=int(slam.n_kf))


def part_e(pk: _Package, test: bool = False) -> dict:
    return _vi_part(pk, "e", kb8=False, test=test)


def part_f(pk: _Package, test: bool = False) -> dict:
    return _vi_part(pk, "f", kb8=True, test=test)


def part_g(pk: _Package, test: bool = False) -> dict:
    """``FisheyeStereoInertialSlam()`` at its KB8 default: (b)'s rig (the
    test size: 0.12 m along x) over phase 8's trajectory and IMU, both views
    rendered KB8."""
    n = TEST_RIG_FRAMES if test else cs.FE_VI_FRAMES
    kw = _vi_seq_kw(test, n)
    cam, h, w = ((TEST_KB8, TEST_H, TEST_W) if test else (cs.FE_KB8, cs.FE_H, cs.FE_W))
    kw.update(height=h, width=w)
    if test:
        R_rl, t_rl = np.eye(3, dtype=np.float32), np.asarray([-TEST_BASE, 0.0, 0.0], np.float32)
    else:
        R_rl, t_rl = cs.fe_rig()
    seq, im = pk.synth.make_vi_sequence(**kw, **pk.kw())
    left, right = _kb8_views(pk, seq, cam, h, w, rig=(R_rl, t_rl))
    slam = pk.system(pk.fs.FisheyeStereoInertialSlam, height=h, width=w, cam_params=cam,
                     calib=pk.calib(test), R_rl=R_rl, t_rl=t_rl,
                     **(TEST_RIG_KW if test else cs.FE_VI_KW))
    first, lost = [], []
    t0 = time.perf_counter()
    for i in range(n):
        _per_frame(lambda i: slam.process_frame(
            left[i], right[i], float(seq.timestamps[i]), acc=im["acc"][i], gyro=im["gyro"][i],
            dts=im["dts"][i]), i, first, lost)
    out = _metrics(slam, seq.t_wc, seq.timestamps, with_scale=False)
    out.update(part="g", size="test" if test else "full", cam_model=slam.cam_model,
               first_pose=first[0] if first else None, lost_per_frame=lost,
               state=int(slam.state), imu_initialized=bool(slam.imu_initialized),
               imu_fix_scale=bool(slam.imu_fix_scale), imu_stage=int(slam.imu_stage),
               seconds=time.perf_counter() - t0)
    return out


def part_d(pk: _Package) -> dict:
    scene = pk.scene()
    n = cs.FE_RECT_FRAMES
    R_wc, t_wc, ts = pk.synth.orbit_trajectory(n, dt=cs.FE_ST_DT)
    hi = np.asarray(cs.FE_KB8, np.float32).copy()
    hi[:4] *= cs.FE_RECT_UP
    hs, ws = int(cs.FE_H * cs.FE_RECT_UP), int(cs.FE_W * cs.FE_RECT_UP)
    pin = pk.rectify.virtual_pinhole_params(cs.FE_KB8, cs.FE_H, cs.FE_W)
    if pk.name == "jax":
        jnp = pk.jnp
        smap = pk.rectify.kb8_rect_map(jnp.asarray(hi), jnp.asarray(pin), cs.FE_H, cs.FE_W)
    else:
        smap = pk.rectify.kb8_rect_map(pk.torch.as_tensor(hi, device=pk.device), pin, cs.FE_H,
                                       cs.FE_W)
    slam = pk.system(pk.sys.MonoSlam, height=cs.FE_H, width=cs.FE_W, cam_params=pin,
                     **cs.FE_RECT_KW)
    first, lost = [], []
    t0 = time.perf_counter()
    for i in range(n):
        fish, _ = pk.render(scene, R_wc[i], t_wc[i], hi, hs, ws)
        if pk.name == "jax":
            rect = np.asarray(pk.rectify.remap_bilinear(pk.jnp.asarray(fish), smap))
        else:
            rect = pk.rectify.remap_bilinear(fish, smap)
        _per_frame(lambda i: slam.process_frame(rect, float(ts[i])), i, first, lost)
    out = _metrics(slam, t_wc, ts, with_scale=True)
    out.update(part="d", first_pose=first[0] if first else None, lost_per_frame=lost,
               state=int(slam.state), seconds=time.perf_counter() - t0)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--part", default="abcd", help="any of a, b, c, d, e, f, g")
    ap.add_argument("--device", default="cpu", help="the port's device")
    ap.add_argument("--size", choices=("full", "test"), default="full",
                    help="test: (c), (e), (f), (g) at the CPU tests' size")
    args = ap.parse_args()
    pk = _Package(args.package, args.device)
    parts = {"a": part_a, "b": part_b, "c": part_c, "d": part_d, "e": part_e, "f": part_f,
             "g": part_g}
    for p in args.part:
        kw = {"test": True} if args.size == "test" and p in "cefg" else {}
        print(json.dumps(parts[p](pk, **kw)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
