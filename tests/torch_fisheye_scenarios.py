"""The fisheye scenarios of ``chip_smoke.py`` phase 16, run by the JAX
package or by the port: the numbers phase 16 holds the card to.

    python3 tests/torch_fisheye_scenarios.py --package jax   [--part abcd]
    python3 tests/torch_fisheye_scenarios.py --package torch [--part abcd] [--device cuda]

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

Prints one JSON line a part: the frame of the first pose, the frames without
one after it, keyframes, the ATE (Sim(3) for (a) and (d), metric without
scale alignment for (b) and (c)) and the scale of a Sim(3) fit, (c) the
IMU state, and the run's seconds.
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
    """The systems, renderer and rectification of one package."""

    def __init__(self, name: str, device: str):
        self.name, self.device = name, device
        if name == "jax":
            import jax

            jax.config.update("jax_platforms", "cpu")
            import jax.numpy as jnp

            from orb_slam3_ros_tpu.models import fisheye_stereo, system
            from orb_slam3_ros_tpu.ops import imu, rectify
            from orb_slam3_ros_tpu.utils import synth

            self.jnp, self.imu = jnp, imu
        else:
            import torch

            from orb_slam3_ros_tpu_torch.models import fisheye_stereo, system
            from orb_slam3_ros_tpu_torch.ops import rectify
            from orb_slam3_ros_tpu_torch.utils import synth

            self.torch = torch
            torch.set_num_threads(4)
        self.fs, self.sys, self.rectify, self.synth = fisheye_stereo, system, rectify, synth

    def kw(self) -> dict:
        return {} if self.name == "jax" else dict(device=self.device)

    def system(self, cls, **kw):
        slam = cls(**kw, **self.kw()) if self.name != "jax" else cls(pipelined=False, **kw)
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

    def stack(self, imgs):
        """[N, H, W] uint8 frames on the package's device."""
        if self.name == "jax":
            return self.jnp.asarray(np.clip(np.stack(imgs), 0, 255).astype(np.uint8))
        t = self.torch
        return t.clamp(t.stack(imgs), 0, 255).to(t.uint8)

    def calib(self):
        from orb_slam3_ros_tpu_torch.utils.profile_keyframe import vi_calib

        c = vi_calib()
        if self.name == "jax":
            return self.imu.ImuCalib(*(self.jnp.asarray(x) for x in c))
        return c


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


def part_c(pk: _Package) -> dict:
    from orb_slam3_ros_tpu_torch.utils import profile_keyframe as pkf

    kw = {**pkf.VI_SEQ_KW, "n_frames": cs.FE_VI_FRAMES}
    seq, im = pk.synth.make_vi_sequence(**kw, stereo_baseline=cs.SVI_BASE, **pk.kw())
    slam = pk.system(pk.fs.FisheyeStereoInertialSlam, height=kw["height"], width=kw["width"],
                     cam_params=seq.cam_params,
                     calib=pk.calib(), R_rl=np.eye(3, dtype=np.float32),
                     t_rl=np.asarray([-cs.SVI_BASE, 0.0, 0.0], np.float32),
                     cam_model="pinhole", **cs.FE_VI_KW)
    first, lost = [], []
    t0 = time.perf_counter()
    for i in range(cs.FE_VI_FRAMES):
        _per_frame(lambda i: slam.process_frame(
            seq.images[i], seq.images_right[i], float(seq.timestamps[i]), acc=im["acc"][i],
            gyro=im["gyro"][i], dts=im["dts"][i]), i, first, lost)
    out = _metrics(slam, seq.t_wc, seq.timestamps, with_scale=False)
    out.update(part="c", first_pose=first[0] if first else None, lost_per_frame=lost,
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
    ap.add_argument("--part", default="abcd", help="any of a, b, c, d")
    ap.add_argument("--device", default="cpu", help="the port's device")
    args = ap.parse_args()
    pk = _Package(args.package, args.device)
    for p in args.part:
        print(json.dumps({"a": part_a, "b": part_b, "c": part_c, "d": part_d}[p](pk)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
