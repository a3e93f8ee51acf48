"""The port's whole slice against the JAX package: localization-mode
monocular tracking of a stored map, plus the port's import guard."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.models.system import MonoSlam as JaxSlam
from orb_slam3_ros_tpu.utils import checkpoint as jckpt
from orb_slam3_ros_tpu.utils import synth as jsynth
from orb_slam3_ros_tpu.utils.evaluate_ate import ate_rmse
from orb_slam3_ros_tpu_torch.models import system as tsys
from torch_parity import jax_seed_map

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
H, W, NF, N_FRAMES, KF_EVERY = 240, 376, 500, 30, 6
SLAM_KW = dict(height=H, width=W, n_features=NF, max_keyframes=64, max_points=4096,
               track_cap=768, lean_after_kf=4, pipelined=False)


def _run(slam, seq):
    slam.activate_localization_mode()
    for i in range(1, N_FRAMES):
        assert slam.process_frame(seq.images[i], float(seq.timestamps[i])) is not None, f"lost at {i}"
    traj = slam.get_trajectory()
    ts = np.asarray([t for t, _ in traj])
    pos = np.stack([T[:3, 3] for _, T in traj])
    rmse, n, _ = ate_rmse(ts, pos, seq.timestamps, seq.t_wc, with_scale=False)
    assert n == N_FRAMES - 1
    return rmse, pos


def test_slice_localization_tracking(tmp_path):
    # Map built by the JAX package from rendered depth at ground-truth
    # keyframe poses, saved with its checkpoint, loaded by the port. Both
    # track frames 1..29 from the ground-truth pose of frame 0 without
    # loss. Metric ATE (no scale): the JAX package measures 0.0101 m here;
    # both must be <= 0.02 m and within 5 mm of each other (float summation
    # order forks the trajectories by micrometres, not millimetres).
    seq = jsynth.make_sequence(n_frames=N_FRAMES, height=H, width=W, dt=0.1, seed=3, with_depth=True)
    jslam = JaxSlam(cam_params=seq.cam_params, **SLAM_KW)
    m, n_kf, n_pts = jax_seed_map(seq, KF_EVERY, jslam)
    assert n_kf == 5 and n_pts > 2000
    R0 = seq.R_wc[0].T
    counters = {"n_kf": n_kf, "n_pts": n_pts, "frame_id": 0, "state": 1,
                "R_cur": R0.tolist(), "t_cur": (-R0 @ seq.t_wc[0]).tolist()}
    path = str(tmp_path / "map.npz")
    jckpt.save_map(path, m, counters)

    jckpt.load_system(path, jslam)
    ate_jax, pos_jax = _run(jslam, seq)

    tslam = tsys.MonoSlam(cam_params=seq.cam_params, device="cpu", **SLAM_KW)
    tslam.load_map(path)
    assert tslam.state == tsys.OK and tslam._current_schedule() == tslam._sched_lean
    ate_port, pos_port = _run(tslam, seq)

    assert ate_jax <= 0.02 and ate_port <= 0.02
    assert abs(ate_port - ate_jax) <= 0.005
    assert np.abs(pos_port - pos_jax).max() < 0.005


def test_unported_states_raise():
    cam = np.asarray([200, 200, 187.5, 119.5, 0, 0, 0, 0, 0], np.float32)
    slam = tsys.MonoSlam(cam_params=cam, device="cpu", **SLAM_KW)
    img = np.zeros((H, W), np.float32)
    # NOT_INITIALIZED runs two-view initialization: a blank frame has no
    # features, so it waits for a reference frame.
    assert slam.process_frame(img, 0.0) is None and slam.state == tsys.NOT_INITIALIZED
    assert slam.init_feats is None
    # LOST relocalizes; without two keyframes there is nothing to relocalize
    # against, and the frame stays LOST.
    slam.state = tsys.LOST
    assert slam.process_frame(img, 0.1) is None and slam.state == tsys.LOST
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsys.MonoSlam(cam_params=cam, device="cpu", **{**SLAM_KW, "pipelined": True})
    # The test keeps its name from when ``devices`` raised too: the two-device
    # split is ported now, and ``devices`` builds a split system (its tests:
    # tests/test_torch_two_device*.py).
    split = tsys.MonoSlam(cam_params=cam, devices=("cpu", "cpu"), **SLAM_KW)
    assert split._tmap() is not split.map and split.track_device == split.device
    # the observation hooks are ported (tests/test_torch_events.py)
    assert tsys.MonoSlam(cam_params=cam, device="cpu", points_every=1, **SLAM_KW).points_every == 1
    # the Atlas is ported (tests/test_torch_atlas.py)
    assert tsys.MonoSlam(cam_params=cam, device="cpu", enable_atlas=True, **SLAM_KW).atlas.maps == []
    other = tsys.MonoSlam(cam_params=cam, device="cpu", **{**SLAM_KW, "max_points": 128})
    with pytest.raises(ValueError):
        slam.set_map(other.map, 0, 0, np.eye(3), np.zeros(3))


def test_port_imports_without_jax():
    # The port must run where JAX is absent: import every module with
    # ``jax`` blocked, and no source line may import it.
    code = (
        "import sys, pkgutil, importlib; sys.modules['jax'] = None\n"
        "import orb_slam3_ros_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not any(k == 'orb_slam3_ros_tpu' or k.startswith('orb_slam3_ros_tpu.') for k in sys.modules)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True, timeout=120)
    banned = re.compile(r"^\s*(import|from)\s+(jax|orb_slam3_ros_tpu)(\.|\s|$)", re.M)
    for f in [*(ROOT / "orb_slam3_ros_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]:
        assert not banned.search(f.read_text()), f
