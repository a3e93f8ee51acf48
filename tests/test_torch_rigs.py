"""``process_frames`` on the two-camera rigs (``FisheyeStereoSlam`` and
``FisheyeStereoInertialSlam``): a [N, 2, H, W] stack of pairs goes through
the per-frame path, each pair split into its views, and gives the same
poses, bit for bit, as N calls of ``process_frame`` on the same pairs.
The JAX package's rigs inherit the mono frame fallback and raise a
``TypeError`` on the same call (its ``process_frame`` takes two views); the
port's pins the fixed contract."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.models import fisheye_stereo as jfs
from orb_slam3_ros_tpu_torch.models import fisheye_stereo as tfs
from orb_slam3_ros_tpu_torch.ops import imu as timu
from orb_slam3_ros_tpu_torch.utils import synth

torch.set_num_threads(1)
KB8 = np.asarray([150.0, 150.0, 187.5, 119.5, 0.02, 0.001, -0.002, 0.0002], np.float32)
H, W, BASELINE, N = 240, 376, 0.12, 6
KW = dict(height=H, width=W, n_features=1200, max_keyframes=16, max_points=4096, kf_every=2)


def _rz(a):
    c, s = np.cos(a), np.sin(a)
    return np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


@pytest.fixture(scope="module")
def kb8_pairs():
    """N raw KB8 pairs of the orbit at 10 Hz, the right camera 0.12 m along
    x and yawed 2 degrees (``tests/test_fisheye_stereo.py``'s rig)."""
    R_rl = _rz(-0.035)
    t_rl = (-R_rl @ np.asarray([BASELINE, 0.0, 0.0], np.float32)).astype(np.float32)
    scene = synth.make_room(seed=2, device="cpu")
    R_wc, t_wc, ts = synth.orbit_trajectory(N, dt=0.1)
    pairs = []
    for i in range(N):
        left, _ = synth.render(scene, R_wc[i], t_wc[i], KB8, height=H, width=W, cam_model="kb8")
        c_r = t_wc[i] + R_wc[i] @ (-R_rl.T @ t_rl)
        right, _ = synth.render(scene, R_wc[i] @ R_rl.T, c_r, KB8, height=H, width=W,
                                cam_model="kb8")
        pairs.append(torch.stack([left, right]))
    return torch.stack(pairs), ts, R_rl, t_rl


def _poses(slam):
    return np.stack([T for _, T in slam.trajectory])


def test_kb8_rig_process_frames_equals_per_frame(kb8_pairs):
    stack, ts, R_rl, t_rl = kb8_pairs
    kw = dict(cam_params=KB8, R_rl=R_rl, t_rl=t_rl, device="cpu", **KW)
    one = tfs.FisheyeStereoSlam(**kw)
    for i in range(N):
        one.process_frame(stack[i, 0], stack[i, 1], float(ts[i]))
    many = tfs.FisheyeStereoSlam(**kw)
    many.process_frames(stack, ts)
    # the rig initializes at the first pair with 60 cross points (frame 2)
    assert len(one.trajectory) >= N - 3 and many.n_kf == one.n_kf >= 2
    np.testing.assert_array_equal(_poses(many), _poses(one))
    # the (stack, offset) form: the last N - 1 pairs after the first
    part = tfs.FisheyeStereoSlam(**kw)
    part.process_frame(stack[0, 0], stack[0, 1], float(ts[0]))
    part.process_frames((stack, 1), ts[1:])
    np.testing.assert_array_equal(_poses(part), _poses(one))


def test_jax_rig_process_frames_raises_type_error(kb8_pairs):
    # The reference fault the port fixes: the JAX rig routes a pair through
    # MonoSlam's fallback, process_frame(img, ts), which lacks ``ts``.
    stack, ts, R_rl, t_rl = kb8_pairs
    jslam = jfs.FisheyeStereoSlam(cam_params=KB8, R_rl=R_rl, t_rl=t_rl, **KW)
    jslam._warm_schedules = lambda: None
    with pytest.raises(TypeError, match="ts"):
        jslam.process_frames([jnp.asarray(stack[0].numpy())], ts[:1])


def test_inertial_rig_process_frames_equals_per_frame():
    seq, imu = synth.make_vi_sequence(
        n_frames=N, height=H, width=W, frame_dt=0.1, imu_per_frame=10, seed=0,
        stereo_baseline=BASELINE, device="cpu",
    )
    f = 100.0
    calib = timu.ImuCalib(
        sigma_g=torch.full((3,), 1.7e-4 * np.sqrt(f)), sigma_a=torch.full((3,), 2e-3 * np.sqrt(f)),
        sigma_gw=torch.full((3,), 1.9e-5 / np.sqrt(f)), sigma_aw=torch.full((3,), 3e-3 / np.sqrt(f)),
        R_bc=torch.eye(3), t_bc=torch.zeros(3),
    )
    kw = dict(cam_params=seq.cam_params, calib=calib, R_rl=np.eye(3, dtype=np.float32),
              t_rl=np.asarray([-BASELINE, 0.0, 0.0], np.float32), cam_model="pinhole",
              init_after_kf=6, device="cpu", **KW)
    stack = torch.stack([seq.images, seq.images_right], dim=1)
    ts = seq.timestamps
    one = tfs.FisheyeStereoInertialSlam(**kw)
    for i in range(N):
        one.process_frame(stack[i, 0], stack[i, 1], float(ts[i]), acc=imu["acc"][i],
                          gyro=imu["gyro"][i], dts=imu["dts"][i])
    many = tfs.FisheyeStereoInertialSlam(**kw)
    many.process_frames((stack, 0), ts, acc=imu["acc"], gyro=imu["gyro"], dts=imu["dts"])
    assert len(one.trajectory) >= N - 3 and many.n_kf == one.n_kf >= 2
    np.testing.assert_array_equal(_poses(many), _poses(one))
    # without IMU blocks: MonoSlam's gate, the same split
    mono = tfs.FisheyeStereoInertialSlam(**kw)
    mono.process_frames(stack[:2], ts[:2])
    assert mono.frame_id == 2
