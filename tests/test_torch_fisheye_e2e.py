"""The port's two-camera systems against the JAX package's, end to end, and
the KB8 configurations the port once refused, constructed.

``tests/test_fisheye_stereo.py``'s two scenarios, cut in length:
(a) ``FisheyeStereoSlam`` on raw KB8 pairs at 240x376 (the repo's test
KB8, 1200 features), the right camera 0.12 m along x and yawed 2 degrees,
30 frames of the orbit at 10 Hz rendered by the JAX package for both;
(b) ``FisheyeStereoInertialSlam(cam_model="pinhole")`` over
``make_vi_sequence(seed=0)`` with a 0.12 m pure-translation rig and 100 Hz
IMU samples (``tests/vi_sim.py``'s calibration), 40 frames, the JAX
package's sequence fed to both. Both packages run each in the module's
fixture; results are compared end to end (first pose, frames posed,
keyframes, the metric ATE without scale alignment, the Sim(3) scale),
never pose by pose. Tolerances are stated where they are compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.models import fisheye_stereo as jfs
from orb_slam3_ros_tpu.utils import synth as jsynth
from orb_slam3_ros_tpu_torch.models import fisheye_stereo as tfs
from orb_slam3_ros_tpu_torch.models import system as tsys
from orb_slam3_ros_tpu_torch.models.inertial_system import InertialSlam
from orb_slam3_ros_tpu_torch.ops import imu as timu
from orb_slam3_ros_tpu_torch.utils.evaluate_ate import ate_rmse
from vi_sim import make_calib

torch.set_num_threads(1)
KB8 = np.asarray([150.0, 150.0, 187.5, 119.5, 0.02, 0.001, -0.002, 0.0002], np.float32)
H, W, BASELINE = 240, 376, 0.12
N_STEREO, N_VI = 30, 40


def _rz(a):
    c, s = np.cos(a), np.sin(a)
    return np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def _result(slam, ts, t_wc, posed):
    traj = slam.get_trajectory()
    tss = np.asarray([t for t, _ in traj])
    est = np.stack([np.asarray(T_)[:3, 3] for _, T_ in traj])
    gt_ts = np.asarray(ts, np.float64)
    metric, n, _ = ate_rmse(tss, est, gt_ts, np.asarray(t_wc), with_scale=False)
    _, _, scale = ate_rmse(tss, est, gt_ts, np.asarray(t_wc), with_scale=True)
    return dict(posed=posed, scored=int(n), metric=float(metric), scale=float(scale),
                n_kf=int(slam.n_kf), state=int(slam.state),
                imu=bool(getattr(slam, "imu_initialized", False)),
                fix_scale=bool(getattr(slam, "imu_fix_scale", False)))


def _stereo_pairs():
    R_rl = _rz(-0.035)
    t_rl = -R_rl @ np.asarray([BASELINE, 0.0, 0.0], np.float32)
    scene = jsynth.make_room(seed=2)
    R_wc, t_wc, ts = jsynth.orbit_trajectory(N_STEREO, dt=0.1, seed=2)
    left, right = [], []
    for i in range(N_STEREO):
        img_l, _ = jsynth.render(scene, jnp.asarray(R_wc[i]), jnp.asarray(t_wc[i]),
                                 jnp.asarray(KB8), height=H, width=W, cam_model="kb8")
        c_r = t_wc[i] + R_wc[i] @ (-R_rl.T @ t_rl)
        img_r, _ = jsynth.render(scene, jnp.asarray(R_wc[i] @ R_rl.T), jnp.asarray(c_r),
                                 jnp.asarray(KB8), height=H, width=W, cam_model="kb8")
        left.append(np.asarray(img_l))
        right.append(np.asarray(img_r))
    return left, right, R_rl, t_rl.astype(np.float32), t_wc, ts


def _run_stereo(slam, left, right, ts):
    return [i for i in range(N_STEREO)
            if slam.process_frame(left[i], right[i], float(ts[i])) is not None]


def _run_vi(slam, seq, imu):
    return [i for i in range(N_VI)
            if slam.process_frame(seq.images[i], seq.images_right[i], float(seq.timestamps[i]),
                                  acc=imu["acc"][i], gyro=imu["gyro"][i],
                                  dts=imu["dts"][i]) is not None]


@pytest.fixture(scope="module")
def runs():
    out = {}
    left, right, R_rl, t_rl, t_wc, ts = _stereo_pairs()
    kw = dict(height=H, width=W, cam_params=KB8, n_features=1200, max_keyframes=32,
              max_points=4096, kf_every=3, R_rl=R_rl, t_rl=t_rl)
    jslam = jfs.FisheyeStereoSlam(**kw)
    jslam._warm_schedules = lambda: None  # compiles ahead only
    tslam = tfs.FisheyeStereoSlam(device="cpu", **kw)
    out["stereo"] = dict(
        jax=_result(jslam, ts, t_wc, _run_stereo(jslam, left, right, ts)),
        port=_result(tslam, ts, t_wc, _run_stereo(tslam, left, right, ts)), n=N_STEREO,
        system=tslam)

    seq, imu = jsynth.make_vi_sequence(
        n_frames=N_VI, height=H, width=W, frame_dt=0.1, imu_per_frame=10, seed=0,
        bg=np.array([0.01, -0.015, 0.02]), noise_g=1e-4, noise_a=1e-3, stereo_baseline=BASELINE,
    )
    calib = make_calib(freq=100.0)
    kw = dict(height=H, width=W, cam_params=seq.cam_params, n_features=1000, max_keyframes=32,
              max_points=4096, kf_every=3, R_rl=np.eye(3, dtype=np.float32),
              t_rl=np.asarray([-BASELINE, 0.0, 0.0], np.float32), cam_model="pinhole",
              init_after_kf=6)
    jslam = jfs.FisheyeStereoInertialSlam(calib=calib, **kw)
    jslam._warm_schedules = lambda: None
    tslam = tfs.FisheyeStereoInertialSlam(
        calib=timu.ImuCalib(*(np.asarray(x) for x in calib)), device="cpu", **kw)
    out["inertial"] = dict(
        jax=_result(jslam, seq.timestamps, seq.t_wc, _run_vi(jslam, seq, imu)),
        port=_result(tslam, seq.timestamps, seq.t_wc, _run_vi(tslam, seq, imu)), n=N_VI,
        system=tslam)
    return out


# (a) the KB8 rig: both give their first pose within the first 3 frames and
# every frame a pose after it; keyframes within 2; the metric ATE within
# 1.5x + 5 mm of the JAX run's and under test_fisheye_stereo.py's 0.15 m;
# the Sim(3) scale no farther from 1 than the JAX run's + 0.05 (measured
# on the CPU: JAX 0.0508 m / 1.144, port 0.0407 m / 1.104, both first posed
# at frame 2, 11 keyframes each; the JAX run moves with the size of the
# point table, whose float sums XLA orders by it: 0.0932 m with 2048 slots,
# the port's run the same to the bit).
# (b) the inertial rig: the IMU initialized with the scale fixed in both;
# first pose at frame 0 and every frame posed; keyframes within 2; the
# metric ATE within 1.5x + 5 mm of the JAX run's and under the JAX test's
# 0.12 m; the scale no farther from 1 than the JAX run's + 0.005, and
# within the JAX test's 6% (measured: JAX 0.0222 m / 1.0197, port 0.0106 m
# / 1.0009, 14 keyframes each; the port anchors the refinement where the
# IMU prediction started, ROADMAP "Known faults").
CHECKS = {
    "first_pose_early": lambda r, n: r["port"]["posed"][:1] and r["jax"]["posed"][:1]
    and r["port"]["posed"][0] <= 3 and r["jax"]["posed"][0] <= 3,
    "every_frame_posed_after_it": lambda r, n: r["port"]["posed"]
    == list(range(r["port"]["posed"][0], n)),
    "state_ok": lambda r, n: r["port"]["state"] == r["jax"]["state"] == tsys.OK,
    "keyframes_within_2": lambda r, n: abs(r["port"]["n_kf"] - r["jax"]["n_kf"]) <= 2,
    "metric_ate_close": lambda r, n: r["port"]["metric"] <= 1.5 * r["jax"]["metric"] + 0.005,
    "metric_ate_under_the_jax_test_bound": lambda r, n: r["port"]["metric"]
    < (0.12 if r["port"]["imu"] else 0.15),
    "scale_close": lambda r, n: abs(r["port"]["scale"] - 1.0)
    <= abs(r["jax"]["scale"] - 1.0) + (0.005 if r["port"]["imu"] else 0.05),
}


@pytest.mark.parametrize("rig", ["stereo", "inertial"])
@pytest.mark.parametrize("name", list(CHECKS))
def test_two_camera_end_to_end_against_jax(runs, rig, name):
    r = runs[rig]
    assert CHECKS[name](r, r["n"]), (name, r["port"], r["jax"])


def test_inertial_rig_initializes_the_imu_with_fixed_scale(runs):
    r = runs["inertial"]
    for side in ("port", "jax"):
        assert r[side]["imu"] and r[side]["fix_scale"], (side, r[side])
    assert abs(r["port"]["scale"] - 1.0) < 0.06


def test_kb8_rig_keyframes_carry_cross_camera_points(runs):
    # Each keyframe of the KB8 rig holds virtual u_r (u - bf / z < u) on its
    # cross-matched features, and the map is metric from the first frame.
    slam = runs["stereo"]["system"]
    m = slam.map
    for k in range(slam.n_kf):
        ur, u = m.kf_ur[k], m.kf_xy[k, :, 0]
        has = ur >= 0
        assert int(has.sum()) >= 20, k
        assert torch.all(ur[has] < u[has])
    assert slam.bf == pytest.approx(150.0 * BASELINE, rel=1e-6)


# ---- the KB8 options the port once refused ----------------------------------
def _calib():
    return timu.ImuCalib(*(np.asarray(x) for x in make_calib(freq=100.0)))


KB8_OPTIONS = {
    "inertial_kb8": lambda: InertialSlam(height=H, width=W, cam_params=KB8, cam_model="kb8",
                                         calib=_calib(), device="cpu"),
    "fisheye_inertial_default": lambda: tfs.FisheyeStereoInertialSlam(
        height=H, width=W, cam_params=KB8, calib=_calib(), device="cpu"),
    "kb8_loop_closing": lambda: tsys.MonoSlam(height=H, width=W, cam_params=KB8,
                                              cam_model="kb8", enable_loop_closing=True,
                                              device="cpu"),
    "kb8_atlas": lambda: tsys.MonoSlam(height=H, width=W, cam_params=KB8, cam_model="kb8",
                                       enable_atlas=True, device="cpu"),
    "kb8_rig_loop_closing": lambda: tfs.FisheyeStereoSlam(
        height=H, width=W, cam_params=KB8, enable_loop_closing=True, device="cpu"),
}


@pytest.mark.parametrize("name", list(KB8_OPTIONS))
def test_kb8_options_construct(name):
    """Each KB8 configuration the JAX package offers builds with the camera
    it names, and with its loop closer, Atlas or IMU (the rigs fix the
    scale); ``tests/test_torch_kb8_vi.py`` and ``tests/test_torch_kb8_loop.py``
    run them."""
    slam = KB8_OPTIONS[name]()
    assert slam.cam_model == "kb8"
    assert (slam.loop_closer is not None) == name.endswith("loop_closing")
    assert (slam.atlas is not None) == (name == "kb8_atlas")
    inertial = name in ("inertial_kb8", "fisheye_inertial_default")
    assert hasattr(slam, "imu_fix_scale") == inertial
    if inertial:
        assert slam.imu_fix_scale == (name == "fisheye_inertial_default")


def test_pinhole_options_stay_open():
    # the same options with the pinhole camera construct
    cam = np.asarray([150.0, 150.0, 187.5, 119.5, 0, 0, 0, 0, 0], np.float32)
    assert tsys.MonoSlam(height=H, width=W, cam_params=cam, enable_loop_closing=True,
                         enable_atlas=True, device="cpu").loop_closer is not None
    slam = tfs.FisheyeStereoInertialSlam(height=H, width=W, cam_params=cam, calib=_calib(),
                                         cam_model="pinhole", device="cpu")
    assert slam.imu_fix_scale and slam.cam_model == "pinhole"
    with pytest.raises(ValueError):
        tsys.MonoSlam(height=H, width=W, cam_params=cam, cam_model="fov", device="cpu")
