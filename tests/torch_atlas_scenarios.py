"""The Atlas scenarios of ``chip_smoke.py`` phase 14, run by the JAX package
or by the port on the CPU: the numbers phase 14 holds the card to.

    python3 tests/torch_atlas_scenarios.py --package jax   [--height 480 --width 752] [--part abc]
    python3 tests/torch_atlas_scenarios.py --package torch [--height 480 --width 752] [--part abc]
        [--seed 0]   (the systems' RANSAC seed)
        [--device cuda] [--reps N] [--deterministic] [--save-attempts DIR]
    python3 tests/torch_atlas_scenarios.py --weld-trials DIR/attempt0 [--trials 20]

(a) ``tests/test_atlas.py``'s blackout on phase 7's sequence
(``make_sequence(seed=3)``, 120 frames, 1000 features, ``kf_every`` 3,
``lost_patience`` 3): frames 0..29 mapped, 8 blank frames inserted, then
back to the scene at frame 30 with the clock running on; frame by frame
until the chunk gate holds, then chunks of 15 to frame 105. (b) the end of
(a) saved with ``save_atlas`` and loaded into a fresh system in state LOST,
which runs frames 101..119 frame by frame. (c) ``tests/test_atlas.py``'s
inertial weld at phase 8's configuration (``profile_keyframe.VI_SEQ_KW`` /
``VI_SLAM_KW`` / ``vi_calib``): frames 0..44 map 1 (IMU-initialized), which
is archived; map 2 from frame 45 until its IMU is initialized (the archived
map held out of the Atlas meanwhile, so that no weld happens before), then
the weld and 10 more frames.

Prints one JSON line a part: (a) the keyframes before the blackout, the
maps archived at the blackout, the first frame tracked again, the frame at
which the archived map was taken back and the route (switch or weld), the
path that welded, the state at the end, the Sim(3) ATE over the frames
after the map's return and the Atlas's grow searches; (b) the frame that
relocalized, the keyframes before and after, the Sim(3) ATE; (c) the
weld's scale, the seam, the metric ATE of the welded map's keyframes
(SE(3)-aligned) and the states of the 10 frames after the weld.

(a) also lists every weld attempt (the frame and whether it held);
``--save-attempts`` saves the session (``save_atlas``) just before each
one. ``--reps N`` runs (a) N times in one process and prints the first
step at which a run's state (state, keyframes, points, the sum of the
landmarks' coordinates) differs from the first run's; ``--deterministic``
runs the port under ``torch.use_deterministic_algorithms``.
``--weld-trials`` loads a saved session into both packages on the CPU and
tries the weld with ``--trials`` RANSAC keys (JAX) and seeds (the port),
printing how many held in each.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # the repo root

# (a) and (b): frames mapped before the blackout, blank frames, the last
# frame of (a), the first of (b), the sequence's frames, the chunk length.
A_MAP, A_BLANK, A_END, B_START, N_FRAMES, CHUNK = 30, 8, 105, 101, 120, 15
# (c): map 1's frames, the frames after the weld, the last frame map 2 may
# take to initialize its IMU.
C_SPLIT, C_AFTER, C_INIT_BY = 45, 10, 140
MONO_KW = dict(n_features=1000, max_keyframes=64, max_points=4096, kf_every=3, fuse_every=3,
               stats_every=3, cull_every=3, lean_after_kf=4, track_cap=768, transfer_uint8=True,
               pipelined=False, enable_atlas=True, lost_patience=3)


def step_frame(s: int):
    """The sequence frame shown at step ``s`` of (a) (None: a blank frame)."""
    if s < A_MAP:
        return s
    if s < A_MAP + A_BLANK:
        return None
    return s - A_BLANK


def frame_step(i: int) -> int:
    return i if i < A_MAP else i + A_BLANK


def np_of(x) -> np.ndarray:
    return np.asarray(x.cpu().numpy() if hasattr(x, "cpu") else x, np.float64)


def ate_over(traj, ts0, steps_ts, t_wc_of_step, with_scale):
    from orb_slam3_ros_tpu_torch.utils.evaluate_ate import ate_rmse

    kept = [(t, T) for t, T in traj if t >= ts0 - 1e-6]
    est_ts = np.asarray([t for t, _ in kept])
    est = np.stack([T[:3, 3] for _, T in kept])
    rmse, n, _ = ate_rmse(est_ts, est, steps_ts, t_wc_of_step, with_scale=with_scale)
    return float(rmse), int(n)


class Pkg:
    """The package under test: its classes, its synth, its checkpoint, and
    how it makes a frame stack and a sub-seed."""

    def __init__(self, name: str, device: str):
        self.name = name
        if name == "jax":
            import jax

            jax.config.update("jax_platforms", "cpu")
            import jax.numpy as jnp

            from orb_slam3_ros_tpu.models import system
            from orb_slam3_ros_tpu.models.inertial_system import InertialSlam
            from orb_slam3_ros_tpu.ops import imu
            from orb_slam3_ros_tpu.utils import checkpoint, synth

            self.jnp, self.jax = jnp, jax
            self.kw = {}
        else:
            import torch

            from orb_slam3_ros_tpu_torch.models import system
            from orb_slam3_ros_tpu_torch.models.inertial_system import InertialSlam
            from orb_slam3_ros_tpu_torch.ops import imu
            from orb_slam3_ros_tpu_torch.utils import checkpoint, synth

            self.torch = torch
            self.kw = dict(device=device)
        self.system, self.InertialSlam, self.imu = system, InertialSlam, imu
        self.checkpoint, self.synth = checkpoint, synth

    def images(self, seq) -> np.ndarray:
        im = seq.images
        return np.asarray(im if self.name == "jax" else im.cpu().numpy(), np.float32)

    def stack(self, frames: np.ndarray):
        u8 = np.clip(frames, 0, 255).astype(np.uint8)
        if self.name == "jax":
            return self.jnp.asarray(u8)
        return self.torch.from_numpy(u8).to(self.kw["device"])

    def merge(self, slam) -> bool:
        if self.name == "jax":
            return slam.atlas.merge_current_into(slam, 0, self.jax.random.PRNGKey(7))
        return slam.atlas.merge_current_into(slam, 0)


def fingerprint(pk: Pkg, slam) -> list:
    m = slam.map
    pv = np.asarray(m.pt_valid if pk.name == "jax" else m.pt_valid.cpu()).astype(bool)
    return [int(slam.state), int(slam.n_kf), int(slam.n_pts), float(np.abs(np_of(m.pt_X)[pv]).sum())]


def part_a_b(pk: Pkg, H: int, W: int, parts: str, seed: int, save_dir: str | None = None) -> list:
    OK, LOST = pk.system.OK, pk.system.LOST
    seq = pk.synth.make_sequence(n_frames=N_FRAMES, height=H, width=W, dt=0.1, seed=3, **pk.kw)
    images = pk.images(seq)
    t_wc = np_of(seq.t_wc)
    n_steps = N_FRAMES + A_BLANK
    steps_ts = float(np_of(seq.timestamps)[0]) + 0.1 * np.arange(n_steps)
    frames = [step_frame(s) for s in range(n_steps)]
    blank = np.zeros((H, W), np.float32)
    stack_np = np.stack([blank if f is None else images[f] for f in frames])
    shown = np.asarray([f is not None for f in frames])
    gt_ts, gt_pos = steps_ts[shown], t_wc[[f for f in frames if f is not None]]
    slam = pk.system.MonoSlam(height=H, width=W, cam_params=seq.cam_params, seed=seed, **MONO_KW,
                              **pk.kw)
    # the JAX Atlas keeps no count of its cross-map searches: count them
    grows = [0]
    if pk.name == "jax":
        atlas_mod = sys.modules[type(slam.atlas).__module__]
        grow = atlas_mod._cross_map_grow

        def counted(*a, **k):
            grows[0] += 1
            return grow(*a, **k)

        atlas_mod._cross_map_grow = counted
    switched = []
    reloc = slam.atlas.try_relocalize_in_archived

    def noted(*a, **k):
        ok = reloc(*a, **k)
        switched.append(ok)
        return ok

    slam.atlas.try_relocalize_in_archived = noted
    attempts, cur = [], [0]
    merge = slam.atlas.merge_current_into

    def attempt(*a, **k):
        if save_dir:
            pk.checkpoint.save_atlas(os.path.join(save_dir, f"attempt{len(attempts)}"), slam)
        ok = merge(*a, **k)
        attempts.append([frames[cur[0]], bool(ok)])
        return ok

    slam.atlas.merge_current_into = attempt
    steps = []
    t0 = time.time()
    out = []
    for s in range(A_MAP):
        slam.process_frame(stack_np[s], float(steps_ts[s]))
    kf_before = slam.n_kf
    for s in range(A_MAP, A_MAP + A_BLANK):
        slam.process_frame(blank, float(steps_ts[s]))
    n_arch = len(slam.atlas.maps)
    state_mid = slam.state
    tracked_at, back_at, route, path = None, None, None, None
    s = A_MAP + A_BLANK
    stack = pk.stack(stack_np)
    end = frame_step(A_END)
    while s < end:
        chunked = slam.state == OK and slam._chunkable() and s + CHUNK <= end
        maps0 = len(slam.atlas.maps)
        cur[0] = s + CHUNK - 1 if chunked else s
        if chunked:
            slam.process_frames((stack, s), steps_ts[s : s + CHUNK])
            if pk.name == "jax":
                slam._drain_chunk()  # its chunk results land at the next call: take them now
            s += CHUNK
        else:
            T = slam.process_frame(stack_np[s], float(steps_ts[s]))
            if tracked_at is None and T is not None:
                tracked_at = frames[s]
            if os.environ.get("ATLAS_SCENARIO_LOG"):
                print(frames[s], T is not None, int(slam.state), int(slam.n_kf), slam.lost_count,
                      len(slam.atlas.maps), flush=True)
            s += 1
        steps.append([s - 1] + fingerprint(pk, slam))
        if maps0 and not slam.atlas.maps and back_at is None:
            back_at = frames[s - 1]
            route = "switch" if any(switched) else "weld"
            path = "chunk boundary" if chunked else "per frame"
            # frames from the next on: the ones before were logged in the
            # young map's frame (frozen at the weld)
            back_ts = float(steps_ts[s]) if s < n_steps else float("inf")
    slam.flush()
    traj = slam.get_trajectory()
    finite = all(np.isfinite(T).all() for _, T in traj)
    ate = ate_over(traj, back_ts, gt_ts, gt_pos, True) if back_at is not None else (None, 0)
    res_a = dict(
        part="a", package=pk.name, seed=seed, height=H, width=W,
        keyframes_before_blackout=int(kf_before),
        archived_at_blackout=n_arch, state_after_blackout=int(state_mid),
        first_tracked_frame=tracked_at, map_back_at_frame=back_at, route=route, weld_path=path,
        weld_attempts=attempts,
        maps_left=len(slam.atlas.maps), state_at_end=int(slam.state), n_kf=int(slam.n_kf),
        trajectory_finite=finite, poses=len(traj), ate_sim3_after_return_m=ate[0],
        ate_poses=ate[1], wall_s=round(time.time() - t0, 1),
        grow_searches=grows[0] if pk.name == "jax" else slam.atlas.grow_searches,
    )
    if pk.name == "jax":
        atlas_mod._cross_map_grow = grow
    print(json.dumps(res_a), flush=True)
    out.append(dict(res_a, steps=steps))
    if "b" not in parts:
        return out
    t0 = time.time()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "session")
        pk.checkpoint.save_atlas(path, slam)
        n_kf0 = slam.n_kf
        s2 = pk.system.MonoSlam(height=H, width=W, cam_params=seq.cam_params, seed=seed, **MONO_KW,
                                **pk.kw)
        pk.checkpoint.load_atlas(path, s2)
    s2.state = LOST
    reloc_at = None
    for i in range(B_START, N_FRAMES):
        st = frame_step(i)
        T = s2.process_frame(stack_np[st], float(steps_ts[st]))
        if reloc_at is None and T is not None:
            reloc_at = i
        if os.environ.get("ATLAS_SCENARIO_LOG"):
            print(i, T is not None, int(s2.state), int(s2.n_kf), s2.lost_count, len(s2.atlas.maps),
                  flush=True)
    s2.flush()
    ate_b = ate_over(s2.get_trajectory(), float(steps_ts[frame_step(B_START)]), gt_ts, gt_pos, True)
    res_b = dict(part="b", package=pk.name, relocalized_at=reloc_at, n_kf_loaded=int(n_kf0),
                 n_kf_end=int(s2.n_kf), state_at_end=int(s2.state), ate_sim3_m=ate_b[0],
                 ate_poses=ate_b[1], wall_s=round(time.time() - t0, 1))
    print(json.dumps(res_b), flush=True)
    out.append(res_b)
    return out


def vi_config(pk: Pkg, H: int, W: int):
    from orb_slam3_ros_tpu_torch.utils import profile_keyframe as pkf

    seq_kw = {**pkf.VI_SEQ_KW, "height": H, "width": W}
    slam_kw = {**pkf.VI_SLAM_KW, "height": H, "width": W, "enable_atlas": True}
    c = pkf.vi_calib()
    calib = pk.imu.ImuCalib(*(np.asarray(x, np.float32) for x in c))
    if pk.name == "jax":
        calib = pk.imu.ImuCalib(*(pk.jnp.asarray(x) for x in calib))
    return seq_kw, slam_kw, calib


def part_c(pk: Pkg, H: int, W: int, seed: int) -> dict:
    from orb_slam3_ros_tpu_torch.utils.evaluate_ate import ate_rmse

    OK = pk.system.OK
    seq_kw, slam_kw, calib = vi_config(pk, H, W)
    seq, im = pk.synth.make_vi_sequence(**seq_kw, **pk.kw)
    images = pk.images(seq)
    tss = np_of(seq.timestamps)
    slam = pk.InertialSlam(cam_params=seq.cam_params, calib=calib, seed=seed, **slam_kw, **pk.kw)
    t0 = time.time()

    def run(i):
        return slam.process_frame(images[i], float(tss[i]), acc=im["acc"][i], gyro=im["gyro"][i],
                                  dts=im["dts"][i])

    for i in range(C_SPLIT):
        run(i)
    init1, kf1 = bool(slam.imu_initialized), int(slam.n_kf)
    slam._freeze_rel_traj()
    archived = slam.atlas.archive_current(slam)
    held, slam.atlas.maps = slam.atlas.maps, []
    i = C_SPLIT
    while i < C_INIT_BY and not (slam.imu_initialized and slam.state == OK):
        run(i)
        i += 1
    init2_at, kf2 = i - 1, int(slam.n_kf)
    slam.atlas.maps = held
    slam._freeze_rel_traj()
    merged = pk.merge(slam)
    weld_at = i - 1
    breaks = sorted(int(b) for b in slam.chain_breaks)
    m = slam.map
    kv = np.asarray(m.kf_valid if pk.name == "jax" else m.kf_valid.cpu()).astype(bool)
    to_np = (lambda x: np.asarray(x)) if pk.name == "jax" else (lambda x: x.cpu().numpy())
    R, t, kts, v = to_np(m.kf_R)[kv], to_np(m.kf_t)[kv], to_np(m.kf_ts)[kv], to_np(m.kf_v)[kv]
    pos = -np.einsum("kji,kj->ki", R, t)  # camera centres
    t_wc = np_of(seq.t_wc)
    ate_kf, n_kf_ate, s_kf = ate_rmse(kts.astype(np.float64), pos, tss, t_wc, with_scale=False)
    states = []
    for j in range(i, i + C_AFTER):
        run(j)
        states.append(int(slam.state))
    res = dict(
        part="c", package=pk.name, seed=seed, height=H, width=W, map1_imu_initialized=init1,
        map1_kf=kf1,
        archived=bool(archived), map2_imu_initialized_at=init2_at, map2_kf=kf2, welded=bool(merged),
        weld_at_frame=weld_at, imu_initialized_after=bool(slam.imu_initialized),
        n_kf=int(slam.n_kf), chain_breaks=breaks, seam_is_break=kf1 in breaks or any(b >= kf1 for b in breaks),
        poses_finite=bool(np.isfinite(R).all() and np.isfinite(t).all()),
        velocities_finite=bool(np.isfinite(v).all()), ate_metric_keyframes_m=float(ate_kf),
        ate_keyframes=int(n_kf_ate), states_after=states, wall_s=round(time.time() - t0, 1),
    )
    print(json.dumps(res), flush=True)
    return res


def weld_trials(path: str, n: int, H: int, W: int) -> dict:
    """How many of ``n`` welds of the session at ``path`` hold in each
    package (JAX keys 0..n-1, the port's seeds 0..n-1; CPU)."""
    jx, tc = Pkg("jax", "cpu"), Pkg("torch", "cpu")
    cam = np_of(tc.synth.make_sequence(n_frames=2, height=H, width=W, dt=0.1, seed=3, device="cpu")
                .cam_params).astype(np.float32)
    held = {"jax": 0, "torch": 0}
    for k in range(n):
        for pk in (jx, tc):
            slam = pk.system.MonoSlam(height=H, width=W, cam_params=cam, seed=k, **MONO_KW, **pk.kw)
            pk.checkpoint.load_atlas(path, slam)
            if pk.name == "jax":
                ok = slam.atlas.merge_current_into(slam, 0, jx.jax.random.PRNGKey(k))
            else:
                ok = slam.atlas.merge_current_into(slam, 0)
            held[pk.name] += bool(ok)
    res = dict(session=path, trials=n, held=held)
    print(json.dumps(res), flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "torch"))
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=752)
    ap.add_argument("--part", default="abc", help="any of a, b (runs a first), c")
    ap.add_argument("--device", default="cpu", help="the port's device")
    ap.add_argument("--seed", type=int, default=0, help="the systems' RANSAC seed")
    ap.add_argument("--reps", type=int, default=1, help="runs of (a)")
    ap.add_argument("--deterministic", action="store_true",
                    help="the port under torch.use_deterministic_algorithms")
    ap.add_argument("--save-attempts", default=None, help="a directory for the sessions")
    ap.add_argument("--weld-trials", default=None, help="a session saved by --save-attempts")
    ap.add_argument("--trials", type=int, default=20)
    a = ap.parse_args()
    if a.weld_trials:
        weld_trials(a.weld_trials, a.trials, a.height, a.width)
        return 0
    if a.package is None:
        ap.error("--package is required")
    if a.deterministic:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"  # before cuBLAS starts
    pk = Pkg(a.package, a.device)
    if a.deterministic:
        pk.torch.use_deterministic_algorithms(True)
    if a.save_attempts:
        os.makedirs(a.save_attempts, exist_ok=True)
    if "a" in a.part or "b" in a.part:
        runs = [part_a_b(pk, a.height, a.width, a.part if r == 0 else "a", a.seed,
                         a.save_attempts if r == 0 else None)[0] for r in range(a.reps)]
        for r in range(1, a.reps):
            diff = [(x, y) for x, y in zip(runs[0]["steps"], runs[r]["steps"]) if x != y]
            print(json.dumps(dict(reps_compared=[0, r], first_differing_step=diff[0] if diff else None)),
                  flush=True)
    if "c" in a.part:
        part_c(pk, a.height, a.width, a.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
