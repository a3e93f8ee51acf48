"""The mapping side of the mono-inertial path against the JAX package:
``build_vi_ba`` / ``apply_vi_ba`` / ``apply_scaled_rotation`` on a map
carried across as numpy, the IMU-block bookkeeping of keyframe compaction,
and the visual-inertial synthetic sequence."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vi_sim
from orb_slam3_ros_tpu.models import local_mapping as jlm
from orb_slam3_ros_tpu.models import map_state as jms
from orb_slam3_ros_tpu.models import map_updates as jmu
from orb_slam3_ros_tpu.ops import lie as jlie
from orb_slam3_ros_tpu.ops import viba as jviba
from orb_slam3_ros_tpu.utils import synth as jsynth
from orb_slam3_ros_tpu_torch.models import inertial_system as tis
from orb_slam3_ros_tpu_torch.models import local_mapping as tlm
from orb_slam3_ros_tpu_torch.models import map_updates as tmu
from orb_slam3_ros_tpu_torch.ops import imu as timu
from orb_slam3_ros_tpu_torch.ops import viba as tviba
from orb_slam3_ros_tpu_torch.utils import synth as tsynth
from torch_parity import np_tree, torch_calib, torch_map

torch.set_num_threads(1)
T = torch.from_numpy
K, N, P, S = 8, 40, 100, 20
CAM = np.array([300, 300, 188, 120, 0, 0, 0, 0, 0], np.float32)


@pytest.fixture(scope="module")
def vi_map():
    """A JAX map of 6 live keyframes on a simulated inertial trajectory
    (slots 6 and 7 empty), random observations, velocities and biases, with
    the IMU blocks between consecutive keyframes."""
    rng = np.random.default_rng(5)
    n = 6
    sim = vi_sim.simulate_vi(rng, n_kf=n - 1, samples_per_kf=S, bg=[0.01, -0.02, 0.005])
    jc = vi_sim.make_calib()._replace(
        R_bc=jlie.so3_exp(jnp.asarray([0.05, -0.1, 0.02])), t_bc=jnp.asarray([0.02, -0.01, 0.03]))
    R_cw, t_cw = jviba.cam_from_body(jnp.asarray(sim["R_wb"]), jnp.asarray(sim["p_wb"]), jc.R_bc, jc.t_bc)
    m = {k: np.array(v) for k, v in np_tree(jms.empty_map(K, N, P)).items()}
    m["kf_valid"][:n] = True
    m["kf_R"][:n], m["kf_t"][:n] = np.asarray(R_cw), np.asarray(t_cw)
    m["kf_xy"][:] = rng.uniform(0, 376, (K, N, 2))
    m["kf_level"][:] = rng.integers(0, 8, (K, N))
    m["kf_feat_valid"][:] = rng.random((K, N)) < 0.9
    m["kf_obs"][:] = np.where(rng.random((K, N)) < 0.7, rng.integers(0, P, (K, N)), -1)
    m["kf_ur"][:] = np.where(rng.random((K, N)) < 0.3, m["kf_xy"][..., 0] - 5.0, -1.0)
    m["pt_valid"][:] = rng.random(P) < 0.9
    m["pt_X"][:] = rng.uniform([-3, -3, 4], [3, 3, 8], (P, 3))
    m["pt_normal"][:] = rng.normal(size=(P, 3))
    m["pt_min_dist"][:], m["pt_max_dist"][:] = 1.0, 9.0
    m["kf_v"][:n] = sim["v_w"]
    m["kf_bg"][:n] = sim["bg"] + rng.normal(size=(n, 3)) * 1e-3
    m["kf_ba"][:n] = rng.normal(size=(n, 3)) * 1e-2
    jm = jms.MapState(**{k: jnp.asarray(v) for k, v in m.items()})
    return jm, jc, sim


def _window(sim, W=8):
    """Window over keyframes 0..5 padded with the empty last slot to W
    entries, as ``InertialSlam._window`` builds it."""
    n = 6
    ids = np.asarray(list(range(n)) + [K - 1] * (W - n), np.int32)
    fixed = np.asarray([i == 0 for i in range(n)] + [True] * (W - n))
    edge_ok = np.asarray([True] * (n - 1) + [False] * (W - n))
    pad = W - 1 - (n - 1)
    acc = np.concatenate([sim["acc"], np.zeros((pad, S, 3), np.float32)])
    gyro = np.concatenate([sim["gyro"], np.zeros((pad, S, 3), np.float32)])
    dts = np.concatenate([sim["dts"], np.zeros((pad, S), np.float32)])
    return ids, fixed, acc, gyro, dts, edge_ok


def _tree_close(want, got, path=""):
    # 1e-5 of each array's largest entry, C 1e-4 (the preintegration
    # tolerances of test_torch_imu.py); integer and bool arrays equal.
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _tree_close(w, g, path + k + ".")
        elif w is not None and w.dtype.kind in "fc":
            tol = 1e-4 if k == "C" else 1e-5
            assert np.abs(w - g).max() <= tol * max(np.abs(w).max(), 1e-30), path + k
        elif w is not None:
            np.testing.assert_array_equal(g, w, err_msg=path + k)


def _torch_tree(x):
    if x is None:
        return None
    if hasattr(x, "_fields"):
        return {k: _torch_tree(getattr(x, k)) for k in x._fields}
    return x.numpy()


@pytest.mark.parametrize("bf", [0.0, 40.0])
def test_build_vi_ba_matches_jax(vi_map, bf):
    jm, jc, sim = vi_map
    ids, fixed, acc, gyro, dts, edge_ok = _window(sim)
    want = jlm.build_vi_ba(jm, *(jnp.asarray(x) for x in (ids, fixed, acc, gyro, dts, edge_ok)),
                           jc, jnp.asarray(CAM), bf=bf)
    got = tlm.build_vi_ba(torch_map(jm), *(T(x) for x in (ids, fixed, acc, gyro, dts, edge_ok)),
                          torch_calib(jc), T(CAM), bf=bf)
    _tree_close(np_tree(want), _torch_tree(got))
    # padded edges are masked, the real chain is whole
    np.testing.assert_array_equal(got.ie_valid.numpy(), [True] * 5 + [False] * 2)
    assert got.cam_idx.shape[0] == 8 * N and got.X.shape[0] == P


def test_broken_chain_masks_the_edge(vi_map):
    jm, jc, sim = vi_map
    ids, fixed, acc, gyro, dts, edge_ok = _window(sim)
    edge_ok[2] = False  # chain break into keyframe 3
    dts[4] = 0.0  # an empty block: dT = 0
    got = tlm.build_vi_ba(torch_map(jm), *(T(x) for x in (ids, fixed, acc, gyro, dts, edge_ok)),
                          torch_calib(jc), T(CAM))
    np.testing.assert_array_equal(got.ie_valid.numpy(), [True, True, False, True, False, False, False])


def test_vi_ba_and_apply_match_jax(vi_map):
    # The window solve and its scatter back, both packages from the same
    # map: keyframe poses within 1e-4, velocities and biases 1e-4, points
    # as in test_torch_viba.py; the padded slot and the keyframes outside
    # the window keep their values.
    jm, jc, sim = vi_map
    ids, fixed, acc, gyro, dts, edge_ok = _window(sim)
    jp = jlm.build_vi_ba(jm, *(jnp.asarray(x) for x in (ids, fixed, acc, gyro, dts, edge_ok)),
                         jc, jnp.asarray(CAM))
    want = np_tree(jlm.apply_vi_ba(jm, jnp.asarray(ids), jviba.vi_bundle_adjust(jp, n_iters=3), jc))
    tm, tc = torch_map(jm), torch_calib(jc)
    tp = tlm.build_vi_ba(tm, *(T(x) for x in (ids, fixed, acc, gyro, dts, edge_ok)), tc, T(CAM))
    got = tlm.apply_vi_ba(tm, T(ids), tviba.vi_bundle_adjust(tp, n_iters=3), tc)
    for f in ("kf_R", "kf_t", "kf_v", "kf_bg", "kf_ba"):
        np.testing.assert_allclose(getattr(got, f).numpy(), want[f], atol=1e-4, err_msg=f)
        # untouched up to the round trip camera -> body -> camera of the
        # padded slot's identity pose (6e-8)
        np.testing.assert_allclose(getattr(got, f)[6:].numpy(), np_tree(jm)[f][6:], atol=1e-6)
    d = np.abs(got.pt_X.numpy() - want["pt_X"]).max(axis=1)
    assert np.quantile(d, 0.99) < 2e-3 and d.max() < 5e-2
    assert not np.array_equal(got.kf_t.numpy()[1:6], np_tree(jm)["kf_t"][1:6])  # it did move


def test_apply_scaled_rotation_matches_jax(vi_map):
    jm, _, _ = vi_map
    R_gw = np.asarray(jlie.so3_exp(jnp.asarray([0.3, -0.2, 0.1])))
    s = 1.7
    want = np_tree(jmu.apply_scaled_rotation(jm, jnp.asarray(R_gw), jnp.asarray(s)))
    tm = torch_map(jm)
    got = tmu.apply_scaled_rotation(tm, T(R_gw), s)
    for f, w in want.items():
        g = getattr(got, f).numpy()
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)
    # reprojection-invariant: a point in a camera frame only scales
    Xc0 = tm.kf_R[2] @ tm.pt_X[7] + tm.kf_t[2]
    Xc1 = got.kf_R[2] @ got.pt_X[7] + got.kf_t[2]
    np.testing.assert_allclose(Xc1.numpy(), s * Xc0.numpy(), rtol=1e-5, atol=1e-5)


def _slam(**kw):
    calib = timu.ImuCalib(*(np.full(3, 1e-3, np.float32),) * 4, np.eye(3, dtype=np.float32),
                          np.zeros(3, np.float32))
    return tis.InertialSlam(height=60, width=94, cam_params=CAM, n_features=100, max_keyframes=8,
                            max_points=64, calib=calib, imu_cap_kf=8, imu_cap_frame=4,
                            device="cpu", **kw)


def test_compact_hook_merges_blocks_and_breaks_chains():
    slam = _slam()
    # block k holds k + 1 samples whose dt encodes k
    for k in range(8):
        slam.kf_imu_dts[k, : min(k + 1, 8)] = 0.01 * (k + 1)
        slam.kf_imu_acc[k, : min(k + 1, 8), 0] = k
    slam._vi_anchor, slam._vi_prior = object(), object()
    # survivors 0, 1, 3, 6: slot 2 merges blocks 2+3 (3 + 4 = 7 samples),
    # slot 3 would merge 4+5+6 (5 + 6 + 7 = 18 > 8): the chain breaks there
    order = np.array([0, 1, 3, 6, 2, 4, 5, 7])
    slam._compact_hook(order, None, 4)
    np.testing.assert_allclose(slam.kf_imu_dts[1, :3], [0.02, 0.02, 0])
    np.testing.assert_allclose(slam.kf_imu_dts[2], [0.03] * 3 + [0.04] * 4 + [0])
    np.testing.assert_allclose(slam.kf_imu_acc[2, :7, 0], [2] * 3 + [3] * 4)
    assert slam.chain_breaks == {3}
    assert not slam.kf_imu_dts[4:].any()
    assert slam._vi_anchor is None and slam._vi_prior is None
    # an old break inside a merged span carries over to the merged slot
    slam.chain_breaks = {2}
    slam._compact_hook(np.array([0, 2, 1, 3, 4, 5, 6, 7]), None, 2)
    assert slam.chain_breaks == {1}
    # and the window masks the edge into a broken slot
    _, _, blocks, edge_ok = slam._window(0, 3, [True, False, False], 4)
    np.testing.assert_array_equal(edge_ok.numpy(), [False, True, False])
    assert blocks.shape == (3, 8, 7)


def test_collect_block_truncates_at_capacity():
    slam = _slam()
    for i in range(4):  # 4 frames x 3 samples = 12 > imu_cap_kf = 8
        slam._imu_history.append((0.1 * (i + 1), np.full((3, 3), i, np.float32),
                                  np.zeros((3, 3), np.float32), np.full(3, 0.01, np.float32)))
    a, g, d = slam._collect_block(0.0, 0.4)
    assert (d > 0).sum() == 8 and a[7, 0] == 2 and a.shape == (8, 3)
    a, g, d = slam._collect_block(0.1, 0.3)  # (t0, t1]: frames 2 and 3
    assert (d > 0).sum() == 6 and a[0, 0] == 1


def test_make_vi_sequence_matches_jax():
    # Poses in float64 here against float32 there: equal to float32
    # rounding (1e-6). IMU samples: 5e-6 (measured 1e-6 on values up to
    # ~10 m/s^2: the JAX package differentiates the pose in float32). Same
    # noise stream and draw order, so noise does not widen this. Images
    # within 0.05 grey levels (measured 0.006).
    # Both trajectories, "wander" and the loop-closure sequence's "loop".
    kw = dict(n_frames=5, height=60, width=94, frame_dt=0.1, imu_per_frame=10, seed=0,
              bg=np.array([0.01, -0.015, 0.02]), noise_g=1e-4, noise_a=1e-3)
    for trajectory in ("wander", "loop"):
        want, wi = jsynth._make_vi_sequence_impl(**kw, gravity=None, ba=None, stereo_baseline=0.0,
                                                 with_depth=False, trajectory=trajectory)
        got, gi = tsynth.make_vi_sequence(**kw, trajectory=trajectory, device="cpu")
        np.testing.assert_allclose(got.R_wc, want.R_wc, atol=1e-6)
        np.testing.assert_allclose(got.t_wc, want.t_wc, atol=1e-6)
        np.testing.assert_allclose(got.timestamps, want.timestamps)
        np.testing.assert_array_equal(got.cam_params, want.cam_params)
        np.testing.assert_allclose(got.images.numpy(), want.images, atol=0.05)
        assert sorted(gi) == sorted(wi)
        for k in ("acc", "gyro", "dts", "vel"):
            assert gi[k].dtype == wi[k].dtype and gi[k].shape == wi[k].shape
            np.testing.assert_allclose(gi[k], wi[k], atol=5e-6, err_msg=k)
        assert not gi["dts"][0].any() and np.allclose(gi["dts"][1:], 0.01)
