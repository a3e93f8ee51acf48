"""The port's ``RgbdInertialSlam`` per frame against the JAX package's, at
``tests/test_rgbd_inertial.py``'s configuration (40 frames at 240x376, 1200
features, 100 Hz IMU with a gyro bias, rendered depth maps), the JAX
package's frames and depth maps fed to both. Both initialize at frame 0
from depth and initialize the IMU with the scale held fixed; results are
compared end to end, never pose by pose.

Both packages run in the module's fixture (about 90 s here). Tolerances
are stated where they are compared.
"""

import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.models.stereo_system import RgbdInertialSlam as JaxRgbdInertial
from orb_slam3_ros_tpu.utils import synth as jsynth
from orb_slam3_ros_tpu_torch.models import system as tsys
from orb_slam3_ros_tpu_torch.models.stereo_system import RgbdInertialSlam
from orb_slam3_ros_tpu_torch.utils.evaluate_ate import ate_rmse
from torch_parity import torch_calib
from vi_sim import make_calib

torch.set_num_threads(1)
N_FRAMES = 40
BG = np.array([0.01, -0.015, 0.02])
SEQ_KW = dict(n_frames=N_FRAMES, height=240, width=376, frame_dt=0.1, imu_per_frame=10, seed=0,
              bg=BG, noise_g=1e-4, noise_a=1e-3, with_depth=True)
SLAM_KW = dict(height=240, width=376, n_features=1200, max_keyframes=32, max_points=4096,
               kf_every=3, init_after_kf=6)


def _run(slam, seq, imu):
    posed = [i for i in range(N_FRAMES) if slam.process_frame(
        seq.images[i], seq.depths[i], float(seq.timestamps[i]), acc=imu["acc"][i],
        gyro=imu["gyro"][i], dts=imu["dts"][i]) is not None]
    traj = slam.get_trajectory()
    ts = np.asarray([t for t, _ in traj])
    est = np.stack([np.asarray(T_)[:3, 3] for _, T_ in traj])
    gt_ts = seq.timestamps.astype(np.float64)
    metric, n, _ = ate_rmse(ts, est, gt_ts, seq.t_wc, with_scale=False)
    _, _, scale = ate_rmse(ts, est, gt_ts, seq.t_wc, with_scale=True)
    return dict(posed=posed, n=n, metric=metric, scale=scale, state=int(slam.state),
                initialized=bool(slam.imu_initialized), stage=int(slam.imu_stage),
                fix_scale=bool(slam.imu_fix_scale), n_kf=int(slam.n_kf),
                bg=np.asarray(slam.bg_cur, np.float64), chunkable=slam._vi_chunkable())


@pytest.fixture(scope="module")
def runs():
    seq, imu = jsynth.make_vi_sequence(**SEQ_KW)
    jslam = JaxRgbdInertial(cam_params=seq.cam_params, calib=make_calib(freq=100.0), **SLAM_KW)
    jslam._warm_schedules = lambda: None  # compiles ahead only
    tslam = RgbdInertialSlam(cam_params=seq.cam_params, calib=torch_calib(make_calib(freq=100.0)),
                             device="cpu", **SLAM_KW)
    return dict(jax=_run(jslam, seq, imu), port=_run(tslam, seq, imu), system=tslam)


# Both initialize at frame 0 and track every frame, IMU initialized with the
# scale fixed at the same stage; keyframes within 1; the metric ATE within
# 25% + 5 mm of the JAX run's and under the JAX test's 0.1 m, the Sim(3)
# scale within 0.02 of the JAX run's and the JAX test's 0.08 of 1; the gyro
# bias within the JAX test's 0.01 (norm) of the truth and within 5e-3 of the
# JAX run's (measured on the CPU: 0.00837 / 0.00872 m, scale 0.99855 /
# 0.99863, 14 / 14 keyframes, stage 3 / 3, bg 1.6e-3 apart).
CHECKS = {
    "initialized_at_frame_0": lambda r: r["port"]["posed"][:1] == r["jax"]["posed"][:1] == [0],
    "every_frame_posed": lambda r: r["port"]["posed"] == list(range(N_FRAMES))
    and r["port"]["n"] == N_FRAMES,
    "state_ok": lambda r: r["port"]["state"] == r["jax"]["state"] == tsys.OK,
    "imu_initialized": lambda r: r["port"]["initialized"] and r["jax"]["initialized"],
    "scale_held_fixed": lambda r: r["port"]["fix_scale"] and r["jax"]["fix_scale"],
    "same_init_stage": lambda r: r["port"]["stage"] == r["jax"]["stage"] >= 2,
    "keyframes_within_1": lambda r: abs(r["port"]["n_kf"] - r["jax"]["n_kf"]) <= 1
    and r["port"]["n_kf"] >= 8,
    "metric_ate_close": lambda r: r["port"]["metric"] <= 1.25 * r["jax"]["metric"] + 0.005,
    "metric_ate_under_the_jax_test_bound": lambda r: r["port"]["metric"] < 0.1,
    "scale_close": lambda r: abs(r["port"]["scale"] - r["jax"]["scale"]) <= 0.02
    and abs(r["port"]["scale"] - 1.0) < 0.08,
    "gyro_bias_estimated": lambda r: np.linalg.norm(r["port"]["bg"] - BG) < 0.01,
    "gyro_bias_as_jax": lambda r: np.abs(r["port"]["bg"] - r["jax"]["bg"]).max() <= 5e-3,
    # RGB-D runs per frame: its float depth maps do not ride the frame stack
    "no_chunk_gate": lambda r: not r["port"]["chunkable"],
}


@pytest.mark.parametrize("name", list(CHECKS))
def test_rgbd_inertial_against_jax(runs, name):
    assert CHECKS[name](runs), (name, runs["port"], runs["jax"])


def test_keyframes_carry_virtual_right_coordinates(runs):
    # u_r = u - bf / d on every keyframe's features with depth; the VI-BA
    # builds (u, v, u_r) rows from them with the virtual 5 cm baseline.
    slam = runs["system"]
    m = slam.map
    assert slam.bf == pytest.approx(float(slam.cam_params[0]) * 0.05)
    for k in range(slam.n_kf):
        has = (m.kf_ur[k] >= 0) & m.kf_feat_valid[k]
        assert has.sum() >= 0.5 * m.kf_feat_valid[k].sum(), k
    prob, _ = slam._build_vi_window_problem(slam.W)
    assert float(prob.bf) == pytest.approx(slam.bf, rel=1e-6)
    assert int((prob.ur >= 0).sum()) > 100
