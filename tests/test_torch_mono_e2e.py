"""The port's monocular mapping slice end to end against the JAX package:
both initialize from two views, map and track the same rendered sequence
(the setup of ``test_e2e_mono.py``); the port is held to the JAX
package's Sim(3)-aligned ATE. The two packages draw other RANSAC
hypotheses, so their trajectories fork: they are compared by ATE, not
pose by pose."""

import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.models.system import MonoSlam as JaxSlam
from orb_slam3_ros_tpu.utils import synth as jsynth
from orb_slam3_ros_tpu.utils.evaluate_ate import ate_rmse
from orb_slam3_ros_tpu_torch.models import system as tsys

torch.set_num_threads(1)

H, W, NF, N_FRAMES = 240, 376, 1200, 40
SLAM_KW = dict(height=H, width=W, n_features=NF, max_keyframes=32, max_points=4096, pipelined=False)


@pytest.fixture(scope="module")
def seq():
    return jsynth.make_sequence(n_frames=N_FRAMES, height=H, width=W, dt=0.1, seed=3)


def run(slam, seq):
    """Feed every frame; returns (frame index of the first pose, number of
    frames with a pose, Sim(3)-aligned ATE over the trajectory)."""
    first = None
    n_posed = 0
    for i in range(N_FRAMES):
        out = slam.process_frame(seq.images[i], float(seq.timestamps[i]))
        if out is not None:
            n_posed += 1
            first = i if first is None else first
    traj = slam.get_trajectory()
    ts = np.asarray([t for t, _ in traj])
    pos = np.stack([Twc[:3, 3] for _, Twc in traj])
    rmse, n, _ = ate_rmse(ts, pos, seq.timestamps.astype(np.float64), seq.t_wc, with_scale=True)
    assert n == len(traj)
    return first, n_posed, rmse


def test_mono_slice_end_to_end(seq):
    # The JAX package measures ATE 0.0176 m here. The port must initialize
    # by frame 4, give poses for >= 36 of the 40 frames, and reach
    # ATE <= min(0.10 m, the JAX package's + 0.01 m).
    jslam = JaxSlam(cam_params=seq.cam_params, **SLAM_KW)
    jslam._warm_schedules = lambda: None  # ahead-of-time compiles only
    _, n_jax, ate_jax = run(jslam, seq)
    assert n_jax >= 30 and ate_jax < 0.10

    slam = tsys.MonoSlam(cam_params=seq.cam_params, device="cpu", **SLAM_KW)
    first, n_port, ate_port = run(slam, seq)
    assert slam.state == tsys.OK
    assert first is not None and first <= 4, first
    assert n_port >= 36, n_port
    assert ate_port <= min(0.10, ate_jax + 0.01), (ate_port, ate_jax)
    assert slam.n_kf >= 4 and slam.n_pts > 100
    # Every observation bound in a live keyframe points to an allocated
    # point slot (test_e2e_mono.py's check). A point culled by
    # MapPointCulling keeps its observations, in both packages, until a
    # local BA over a keyframe that sees it clears them; most bindings are
    # to live points (93% measured). The map keeps the JAX dtypes.
    m = slam.map
    obs = m.kf_obs[m.kf_valid]
    bound = obs[obs >= 0]
    assert bound.numel() > 0 and int(bound.max()) < slam.n_pts
    assert m.pt_valid[bound.long()].float().mean() >= 0.9
    assert m.kf_obs.dtype == torch.int32 and m.pt_first_kf.dtype == torch.int32
    assert m.pt_valid.dtype == torch.bool and m.kf_desc_sign.dtype == torch.int8
