"""The port's ``StereoInertialSlam`` per frame against the JAX package's, at
``tests/test_stereo_inertial.py``'s configuration (35 frames at 240x376,
800 features, a 0.12 m baseline, 100 Hz IMU with a gyro bias), the JAX
package's rendered pairs fed to both. Both initialize at frame 0 from
stereo depth and initialize the IMU with the scale held fixed; results are
compared end to end (metric ATE without scale alignment, scale, biases),
never pose by pose.

The port's run also records where the tracked pose is refined: by the
stereo (u, v, u_r) solve until the IMU is initialized, by the monocular
15-dof VI solve after it (the JAX package's order, through
``InertialSlam._track_post``), whose anchor is the state before the
frame's IMU prediction (where the JAX package rebuilds it from the host
after the prediction moved the velocity: a fault of the reference the port
does not copy, so the port's run sits below the JAX run's ATE after IMU
initialization). And the stereo VI keyframe body: the JAX
run's last ``_vi_kf_work`` call with u_r and depth is replayed through the
port's ``_vi_kf_work`` from the same inputs.

Both packages run in the module's fixture (about 170 s here, most of it
the JAX package's compiles). Tolerances are stated where they are compared.
"""

import copy

import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.models import inertial_system as jis
from orb_slam3_ros_tpu.models.stereo_system import StereoInertialSlam as JaxStereoInertial
from orb_slam3_ros_tpu.utils import synth as jsynth
from orb_slam3_ros_tpu_torch.models import inertial_system as tis
from orb_slam3_ros_tpu_torch.models import stereo_system as tss
from orb_slam3_ros_tpu_torch.models import system as tsys
from orb_slam3_ros_tpu_torch.utils.evaluate_ate import ate_rmse
from torch_cases import T
from torch_parity import np_tree, torch_calib, torch_features, torch_map
from vi_sim import make_calib

torch.set_num_threads(1)
N_FRAMES, BASELINE = 35, 0.12
BG = np.array([0.01, -0.015, 0.02])
SEQ_KW = dict(n_frames=N_FRAMES, height=240, width=376, frame_dt=0.1, imu_per_frame=10, seed=0,
              bg=BG, noise_g=1e-4, noise_a=1e-3, stereo_baseline=BASELINE)
SLAM_KW = dict(height=240, width=376, n_features=800, max_keyframes=32, max_points=4096,
               kf_every=3, baseline=BASELINE, init_after_kf=6)


def _run(slam, seq, imu):
    posed = [i for i in range(N_FRAMES) if slam.process_frame(
        seq.images[i], seq.images_right[i], float(seq.timestamps[i]), acc=imu["acc"][i],
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
                bg=np.asarray(slam.bg_cur, np.float64))


@pytest.fixture(scope="module")
def runs():
    seq, imu = jsynth.make_vi_sequence(**SEQ_KW)
    # The JAX run, recording its stereo VI keyframe bodies.
    calls, original = [], jis._vi_kf_work

    def record(*args, **kw):
        out = original(*args, **kw)
        if kw.get("depth") is not None:
            calls.append((args, kw, out))
        return out

    jis._vi_kf_work = record
    try:
        jslam = JaxStereoInertial(cam_params=seq.cam_params, calib=make_calib(freq=100.0),
                                  **SLAM_KW)
        jslam._warm_schedules = lambda: None  # compiles ahead only
        jres = _run(jslam, seq, imu)
    finally:
        jis._vi_kf_work = original
    # The port's run, recording which solve refined each tracked frame.
    refines, stereo_refine = [], tss._stereo_refine
    tslam = tss.StereoInertialSlam(cam_params=seq.cam_params, calib=torch_calib(make_calib(freq=100.0)),
                                   device="cpu", **SLAM_KW)

    def counted(*a, **k):
        refines.append((tslam.frame_id, tslam.imu_initialized))
        return stereo_refine(*a, **k)

    tss._stereo_refine = counted
    try:
        tres = _run(tslam, seq, imu)
    finally:
        tss._stereo_refine = stereo_refine
    return dict(jax=jres, port=tres, system=tslam, refines=refines, calls=calls, imu=imu, seq=seq)


# Both initialize at frame 0 and track every frame, IMU initialized with the
# scale fixed at the same stage; keyframes within 1. The port anchors the VI
# refinement where the JAX package does not (the module docstring), so it is
# held to the JAX run's result as a bar, not matched to it: the metric ATE
# within 25% + 5 mm of the JAX run's, the Sim(3) scale within the JAX test's
# 0.05 of 1 and no farther from 1 than the JAX run's + 0.01, the gyro bias
# within the JAX test's 1.5e-2 of the truth and no farther from it than the
# JAX run's + 2e-3 (measured on the CPU: 0.01823 / 0.02882 m, bias error
# 5.3e-4 / 8.6e-3, 12 / 12 keyframes, stage 2 / 2; with the JAX package's
# anchor the port measured 0.02882 m and the JAX run's bias to 4e-5).
CHECKS = {
    "initialized_at_frame_0": lambda r: r["port"]["posed"][:1] == r["jax"]["posed"][:1] == [0],
    "every_frame_posed": lambda r: r["port"]["posed"] == list(range(N_FRAMES))
    and r["port"]["n"] == N_FRAMES,
    "state_ok": lambda r: r["port"]["state"] == r["jax"]["state"] == tsys.OK,
    "imu_initialized": lambda r: r["port"]["initialized"] and r["jax"]["initialized"],
    "scale_held_fixed": lambda r: r["port"]["fix_scale"] and r["jax"]["fix_scale"],
    "same_init_stage": lambda r: r["port"]["stage"] == r["jax"]["stage"] >= 1,
    "keyframes_within_1": lambda r: abs(r["port"]["n_kf"] - r["jax"]["n_kf"]) <= 1,
    "metric_ate_close": lambda r: r["port"]["metric"] <= 1.25 * r["jax"]["metric"] + 0.005,
    "metric_ate_under_the_jax_test_bound": lambda r: r["port"]["metric"] < 0.12,
    "scale_close": lambda r: abs(r["port"]["scale"] - 1.0) < 0.05
    and abs(r["port"]["scale"] - 1.0) <= abs(r["jax"]["scale"] - 1.0) + 0.01,
    "gyro_bias_estimated": lambda r: np.abs(r["port"]["bg"] - BG).max() <= 1.5e-2,
    "gyro_bias_no_worse_than_jax": lambda r: np.abs(r["port"]["bg"] - BG).max()
    <= np.abs(r["jax"]["bg"] - BG).max() + 2e-3,
}


@pytest.mark.parametrize("name", list(CHECKS))
def test_stereo_inertial_against_jax(runs, name):
    assert CHECKS[name](runs), (name, runs["port"], runs["jax"])


def test_stereo_refinement_until_the_imu_is_initialized(runs):
    # The stereo (u, v, u_r) refinement runs on every tracked frame before
    # the IMU is initialized and on none after: then the 15-dof VI solve
    # refines, monocular, as in the JAX package.
    ref = runs["refines"]
    assert len(ref) >= 10 and not any(init for _, init in ref)
    first_vi = max(f for f, _ in ref) + 1
    assert first_vi < N_FRAMES - 5  # frames after it went through the VI solve
    assert runs["system"].imu_initialized


def test_refinement_anchored_before_the_prediction(runs):
    # A stereo-inertial frame's IMU prediction turns v_cur into the
    # predicted velocity; the 15-dof refinement after it must start from the
    # state the prediction started from (the previous pose with its own
    # velocity), not one rebuilt from the host with the new velocity (the
    # JAX package's fault, ROADMAP "Known faults in the reference").
    # The prediction and the refinement run in the tracking program's "vi"
    # kind: its anchor buffers hold the state the refinement started from.
    slam = copy.deepcopy(runs["system"])
    im, seq, i = runs["imu"], runs["seq"], N_FRAMES - 1
    slam._vi_anchor = None  # as after a keyframe
    slam.last_kf_frame = slam.frame_id  # no keyframe at this frame
    v_before = slam.v_cur.copy()
    slam._record_frame_imu(99.0, im["acc"][i], im["gyro"][i], im["dts"][i])
    fe = slam._front_end().run(seq.images[i], seq.images_right[i])
    slam._track(fe, 99.0, predict=True)
    prog = slam._track_prog
    v_pred = prog.buf["packed"][34:37].numpy()
    assert np.abs(v_pred - v_before).max() > 1e-3  # the prediction moved it
    np.testing.assert_allclose(prog.buf["anc_v"].numpy(), v_before, atol=1e-6)
    assert prog.anchors["host"] >= 1


def _port_kf_work(args, kw):
    """The port's ``_vi_kf_work`` on a recorded JAX call's inputs."""
    (m, kf_id, R, t, ts, feats, feat_pt, n_pts, free_cap, v_new, bg_new, ba_new, big, small,
     calib, cam_params, bf, width, height, fuse_neighbors, do_fuse, do_stats, do_cull, n_iters,
     n_levels, _cam_model) = args
    small = np.asarray(small)
    W = (small.shape[0] + 1) // 3
    tm = torch_map(m)
    vb = T(np.concatenate([np.asarray(v_new), np.asarray(bg_new), np.asarray(ba_new)]))
    return tis._vi_kf_work(
        tm, int(kf_id), T(R), T(t), float(ts), torch_features(feats), T(feat_pt), int(n_pts),
        int(free_cap), vb, T(small[:W].astype(np.int32)), T(small[W : 2 * W] > 0.5), T(big),
        T(small[2 * W :] > 0.5), torch_calib(calib), T(cam_params), width=width, height=height,
        fuse_neighbors=fuse_neighbors, do_fuse=do_fuse, do_stats=do_stats, do_cull=do_cull,
        n_iters=n_iters, n_levels=n_levels, bf=float(bf), ur=T(kw["ur"]), depth=T(kw["depth"]),
        max_depth=float(kw["max_depth"]),
    )


@pytest.fixture(scope="module")
def kf_body(runs):
    assert runs["calls"], "the JAX run made no stereo VI keyframe"
    args, kw, (jm, packed) = runs["calls"][-1]
    tm, n_new = _port_kf_work(args, kw)
    return dict(kf=int(args[1]), tm=tm, n_new=int(n_new), jm=np_tree(jm),
                packed=np.asarray(packed), ur=np.asarray(kw["ur"]))


# The replayed keyframe body: the same points admitted (depth first, then
# triangulated) and the inserted keyframe's row equal; observations 99%
# alike; the VI-BA's keyframe states within 1e-3 (its normal equations sum
# in another order: the JAX body's row_n reduce against index_add_).
def test_vi_keyframe_body_admits_as_jax(kf_body):
    assert kf_body["n_new"] == int(kf_body["packed"][0]) > 0


def test_vi_keyframe_body_inserts_right_coordinates(kf_body):
    k = kf_body["kf"]
    np.testing.assert_array_equal(kf_body["tm"].kf_ur[k].numpy(), kf_body["jm"]["kf_ur"][k])
    np.testing.assert_array_equal(kf_body["tm"].kf_ur[k].numpy(), kf_body["ur"])
    assert (kf_body["ur"] >= 0).sum() > 50


def test_vi_keyframe_body_map_as_jax(kf_body):
    tm, jm = kf_body["tm"], kf_body["jm"]
    assert (tm.kf_obs.numpy() == jm["kf_obs"]).mean() >= 0.99
    assert (tm.pt_valid.numpy() == jm["pt_valid"]).mean() >= 0.99
    for f in ("kf_R", "kf_t", "kf_v", "kf_bg", "kf_ba"):
        assert np.abs(getattr(tm, f).numpy() - jm[f]).max() <= 1e-3, f
