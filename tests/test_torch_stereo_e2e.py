"""The port's ``StereoSlam`` and ``RgbdSlam`` per frame against the JAX
package's, end to end, at ``tests/test_stereo.py``'s configuration (240x376,
800 features, a 0.12 m baseline, ``make_sequence(seed=3)``): 25 stereo
pairs and 20 RGB-D frames, the JAX package's rendered images fed to both
packages. Both initialize at frame 0 from depth; results are compared end
to end (keyframes, points, the metric ATE without scale alignment, the
Sim(3) scale), never pose by pose. Then the global BA of the stereo map:
``build_global_ba`` of both packages on the port's map carries ``bf`` and
the keyframes' u_r rows, field for field, and the port's asynchronous global
BA builds its problem with them.

Both packages run in the module's fixture (about 60 s here). Tolerances are
stated where they are compared.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.models import local_mapping as jlm
from orb_slam3_ros_tpu.models import map_state as jms
from orb_slam3_ros_tpu.models.stereo_system import RgbdSlam as JaxRgbd
from orb_slam3_ros_tpu.models.stereo_system import StereoSlam as JaxStereo
from orb_slam3_ros_tpu.utils import synth as jsynth
from orb_slam3_ros_tpu_torch.models import local_mapping as tlm
from orb_slam3_ros_tpu_torch.models import map_state as tms
from orb_slam3_ros_tpu_torch.models import system as tsys
from orb_slam3_ros_tpu_torch.models.stereo_system import RgbdSlam, StereoSlam
from orb_slam3_ros_tpu_torch.utils.evaluate_ate import ate_rmse
from torch_parity import np_tree

torch.set_num_threads(1)
H, W, BASELINE = 240, 376, 0.12
N_STEREO, N_RGBD = 25, 20
SLAM_KW = dict(height=H, width=W, n_features=800, max_keyframes=32, max_points=4096)


def _run(slam, seq, n, second):
    """``n`` frames through ``process_frame(img, second[i], ts)``; returns
    the frames that gave a pose and the end-to-end result."""
    posed = [i for i in range(n)
             if slam.process_frame(seq.images[i], second[i], float(seq.timestamps[i])) is not None]
    traj = slam.get_trajectory()
    ts = np.asarray([t for t, _ in traj])
    est = np.stack([np.asarray(T)[:3, 3] for _, T in traj])
    gt_ts = seq.timestamps.astype(np.float64)
    metric, scored, _ = ate_rmse(ts, est, gt_ts, seq.t_wc, with_scale=False)
    _, _, scale = ate_rmse(ts, est, gt_ts, seq.t_wc, with_scale=True)
    return dict(posed=posed, scored=scored, metric=metric, scale=scale, n_kf=int(slam.n_kf),
                n_pts=int(slam.n_pts), state=int(slam.state))


@pytest.fixture(scope="module")
def runs():
    seq = jsynth.make_sequence(n_frames=N_STEREO, height=H, width=W, dt=0.1, seed=3,
                               stereo_baseline=BASELINE, with_depth=True)
    out = {"seq": seq}
    for name, jcls, tcls, kw, n, second in (
        ("stereo", JaxStereo, StereoSlam, dict(baseline=BASELINE), N_STEREO, seq.images_right),
        ("rgbd", JaxRgbd, RgbdSlam, {}, N_RGBD, seq.depths),
    ):
        jslam = jcls(cam_params=seq.cam_params, **SLAM_KW, **kw)
        jslam._warm_schedules = lambda: None  # compiles ahead only
        tslam = tcls(cam_params=seq.cam_params, device="cpu", **SLAM_KW, **kw)
        out[name] = dict(jax=_run(jslam, seq, n, second), port=_run(tslam, seq, n, second),
                         n=n, system=tslam, jax_system=jslam)
    return out


# Both initialize at frame 0 and track every frame; the keyframe counts
# within 1; points within 5%; the metric ATE within 25% + 2 mm of the JAX
# run's and the Sim(3) scale within 0.01 of it (measured on the CPU:
# stereo 0.014536 / 0.014561 m, scale 1.00627 / 1.00622, 5 / 5 keyframes,
# 1230 / 1230 points; RGB-D at 25 frames 0.008888 / 0.008895 m).
CHECKS = {
    "initialized_at_frame_0": lambda r, n: r["port"]["posed"][:1] == r["jax"]["posed"][:1] == [0],
    "every_frame_posed": lambda r, n: r["port"]["posed"] == list(range(n))
    and r["port"]["scored"] == n,
    "state_ok": lambda r, n: r["port"]["state"] == r["jax"]["state"] == tsys.OK,
    "keyframes_within_1": lambda r, n: abs(r["port"]["n_kf"] - r["jax"]["n_kf"]) <= 1
    and r["port"]["n_kf"] >= 3,
    "points_within_5_percent": lambda r, n: abs(r["port"]["n_pts"] - r["jax"]["n_pts"])
    <= 0.05 * r["jax"]["n_pts"],
    "metric_ate_close": lambda r, n: r["port"]["metric"] <= 1.25 * r["jax"]["metric"] + 0.002,
    "metric_ate_under_the_jax_test_bound": lambda r, n: r["port"]["metric"] < 0.06,
    "scale_close": lambda r, n: abs(r["port"]["scale"] - r["jax"]["scale"]) <= 0.01,
}


@pytest.mark.parametrize("sensor", ["stereo", "rgbd"])
@pytest.mark.parametrize("name", list(CHECKS))
def test_end_to_end_against_jax(runs, sensor, name):
    r = runs[sensor]
    assert CHECKS[name](r, r["n"]), (name, r["port"], r["jax"])


@pytest.mark.parametrize("sensor", ["stereo", "rgbd"])
def test_keyframes_carry_right_coordinates(runs, sensor):
    # Every keyframe of the map holds its features' u_r (virtual for
    # RGB-D): most valid features have one, and u_r < u (positive
    # disparity) wherever there is one.
    slam = runs[sensor]["system"]
    m = slam.map
    for k in range(slam.n_kf):
        ur, valid, u = m.kf_ur[k], m.kf_feat_valid[k], m.kf_xy[k, :, 0]
        has = ur >= 0
        assert (has & valid).sum() >= 0.3 * valid.sum(), k
        assert torch.all(ur[has] < u[has] + 1e-3)


def _jax_map(tm):
    return jms.MapState(**{k: jnp.asarray(v) for k, v in tms.to_numpy(tm).items()})


@pytest.mark.parametrize("sensor", ["stereo", "rgbd"])
def test_global_ba_problem_against_jax(runs, sensor):
    # build_global_ba on the port's map in both packages: every field equal
    # (inv_sigma2 to float rounding), bf the system's, and stereo rows (u_r
    # >= 0) among the edges.
    slam = runs[sensor]["system"]
    tp = tlm.build_global_ba(slam.map, slam.n_kf, slam.cam_params, bf=slam.bf)
    jp = jlm.build_global_ba(_jax_map(slam.map), jnp.asarray(slam.n_kf),
                             jnp.asarray(slam.cam_params.numpy()),
                             bf=jnp.asarray(slam.bf, jnp.float32))
    for k, v in np_tree(jp).items():
        np.testing.assert_allclose(getattr(tp, k).numpy(), v, rtol=1e-6, err_msg=k)
    assert float(tp.bf) == pytest.approx(slam.bf, rel=1e-6)
    assert int(((tp.ur >= 0) & tp.edge_valid).sum()) > 100


def test_async_global_ba_builds_stereo_rows(runs):
    # The asynchronous global BA (a closure's) solves the stereo map with its
    # u_r rows and bf, and folds in with the map still tracking.
    slam = copy.deepcopy(runs["stereo"]["system"])
    slam._start_async_gba(4)
    prob = slam._gba["prob"]
    assert float(prob.bf) == pytest.approx(slam.bf, rel=1e-6)
    assert int(((prob.ur >= 0) & prob.edge_valid).sum()) > 100
    slam.flush()
    assert slam.gba_counts["finished"] == 1
    assert torch.isfinite(slam.map.kf_t[: slam.n_kf]).all()
