"""Parity of the port's pose optimization, map updates, checkpoints and
``track_against_map`` with the JAX package, stage by stage: each stage is
fed the JAX package's own intermediate (map, features)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.models import map_state as jms
from orb_slam3_ros_tpu.models import map_updates as jmu
from orb_slam3_ros_tpu.models import tracking as jtrk
from orb_slam3_ros_tpu.models.system import MonoSlam as JaxSlam
from orb_slam3_ros_tpu.ops import lie as jlie
from orb_slam3_ros_tpu.ops import pose_opt as jpo
from orb_slam3_ros_tpu.utils import checkpoint as jckpt
from orb_slam3_ros_tpu.utils import synth as jsynth
from orb_slam3_ros_tpu_torch.models import map_state as tms
from orb_slam3_ros_tpu_torch.models import map_updates as tmu
from orb_slam3_ros_tpu_torch.models import tracking as ttrk
from orb_slam3_ros_tpu_torch.models.system import MonoSlam as TorchSlam
from orb_slam3_ros_tpu_torch.ops import pose_opt as tpo
from orb_slam3_ros_tpu_torch.utils import checkpoint as tckpt
from orb_slam3_ros_tpu_torch.utils import synth as tsynth
from torch_cases import T
from torch_parity import jax_seed_map, np_tree, torch_features, torch_map

torch.set_num_threads(1)

H, W, NF = 120, 188, 300
SLAM_KW = dict(height=H, width=W, n_features=NF, max_keyframes=8, max_points=1024)


def pose_cw(seq, i):
    R = seq.R_wc[i].T
    return R, -R @ seq.t_wc[i]


@pytest.fixture(scope="module")
def seq():
    return jsynth.make_sequence(n_frames=8, height=H, width=W, dt=0.1, seed=3, with_depth=True)


@pytest.fixture(scope="module")
def jslam(seq):
    return JaxSlam(cam_params=seq.cam_params, pipelined=False, **SLAM_KW)


@pytest.fixture(scope="module")
def jmap(seq, jslam):
    return jax_seed_map(seq, 3, jslam)


def random_map(seed, K=6, N=40, P=50):
    """A small map in numpy whose points are seen by several keyframes
    with noisy descriptors (ties in the median Hamming distances)."""
    rng = np.random.default_rng(seed)
    m = {k: np.array(v) for k, v in np_tree(jms.empty_map(K, N, P)).items()}
    base = (1 - 2 * (rng.random((P, 256)) < 0.5)).astype(np.int8)
    m["kf_valid"][: K - 1] = True
    phi = rng.normal(0, 0.3, (K, 3)).astype(np.float32)
    m["kf_R"] = np.asarray(jlie.so3_exp(phi))
    m["kf_t"] = rng.normal(0, 1, (K, 3)).astype(np.float32)
    m["kf_level"] = rng.integers(0, 8, (K, N)).astype(np.int32)
    m["kf_feat_valid"] = rng.random((K, N)) < 0.9
    obs = rng.integers(-1, P, (K, N)).astype(np.int32)
    m["kf_obs"] = obs
    flip = rng.random((K, N, 256)) < 0.1
    desc = base[np.clip(obs, 0, P - 1)]
    m["kf_desc_sign"] = np.where(flip, -desc, desc).astype(np.int8)
    m["pt_valid"] = rng.random(P) < 0.8
    m["pt_X"] = rng.normal(0, 2, (P, 3)).astype(np.float32)
    return m


def test_pose_optimization(rng):
    # LM over the same edges; 6x6 normal equations summed in another order
    # and two SVDs in normalize_rotation: R, t to 1e-4.
    n = 200
    R_gt = np.asarray(jlie.so3_exp(np.asarray([0.1, -0.2, 0.05], np.float32)))
    t_gt = np.asarray([0.1, -0.3, 0.5], np.float32)
    Xw = np.concatenate(
        [rng.uniform(-2, 2, (n, 2)), rng.uniform(2, 6, (n, 1))], -1
    ).astype(np.float32)
    cam = np.asarray([200, 200, 188, 120, 0, 0, 0, 0, 0], np.float32)
    Xc = Xw @ R_gt.T + t_gt
    uv = (cam[:2] * Xc[:, :2] / Xc[:, 2:] + cam[2:4]).astype(np.float32)
    uv += rng.normal(0, 0.7, uv.shape).astype(np.float32)
    uv[: n // 10] += rng.uniform(20, 40, (n // 10, 2)).astype(np.float32)  # outliers
    level = rng.integers(0, 4, n)
    inv_s2 = (1.0 / 1.2 ** (2.0 * level)).astype(np.float32)
    valid = rng.random(n) < 0.95
    R0 = np.asarray(jlie.so3_exp(np.asarray([0.13, -0.17, 0.08], np.float32))) @ np.eye(3, dtype=np.float32)
    t0 = t_gt + np.asarray([0.05, -0.04, 0.03], np.float32)
    j = jpo.pose_optimization(R0, t0, Xw, uv, inv_s2, valid, cam, rounds=3, iters_per_round=5)
    t = tpo.pose_optimization(T(R0), T(t0), T(Xw), T(uv), T(inv_s2), T(valid), T(cam), rounds=3, iters_per_round=5)
    np.testing.assert_allclose(t.R.numpy(), np.asarray(j.R), atol=1e-4)
    np.testing.assert_allclose(t.t.numpy(), np.asarray(j.t), atol=1e-4)
    assert (t.inlier.numpy() == np.asarray(j.inlier)).mean() >= 0.99
    assert abs(int(t.n_inliers) - int(j.n_inliers)) <= 2
    assert t.n_inliers.dtype == torch.int32


def test_update_counters_and_insert_keyframe(jmap, seq, jslam, rng):
    jm = jmap[0]
    vis = rng.random(jm.P) < 0.5
    fnd = vis & (rng.random(jm.P) < 0.5)
    jm2 = jmu.update_track_counters(jm, vis, fnd)
    tm2 = tmu.update_track_counters(torch_map(jm), T(vis), T(fnd))
    np.testing.assert_array_equal(tm2.pt_visible.numpy(), np.asarray(jm2.pt_visible))
    np.testing.assert_array_equal(tm2.pt_found.numpy(), np.asarray(jm2.pt_found))

    feats = jslam._extract(jnp.asarray(seq.images[1]))
    feat_pt = rng.integers(-1, jm.P, jm.N).astype(np.int32)
    R, t = pose_cw(seq, 1)
    jm3 = jmu.insert_keyframe(jm, jnp.asarray(5), R, t, jnp.asarray(0.1, jnp.float32), feats, feat_pt)
    tm3 = tmu.insert_keyframe(torch_map(jm), 5, T(R), T(t), 0.1, torch_features(feats), T(feat_pt))
    for k, v in np_tree(jm3).items():
        np.testing.assert_array_equal(getattr(tm3, k).numpy(), v, err_msg=k)


def test_admit_depth_points(jmap, rng):
    jm, n_kf, n_pts = jmap
    kf = n_kf - 1
    X_w = rng.normal(0, 2, (jm.N, 3)).astype(np.float32)
    cand = rng.random(jm.N) < 0.7
    for base, room in ((n_pts, jm.P - n_pts), (n_pts, 17)):
        jm2, nj = jmu.admit_depth_points(jm, jnp.asarray(kf), X_w, cand, jnp.asarray(base), jnp.asarray(room))
        tm2, nt = tmu.admit_depth_points(torch_map(jm), kf, T(X_w), T(cand), base, room)
        assert int(nt) == int(nj)
        for k, v in np_tree(jm2).items():
            np.testing.assert_array_equal(getattr(tm2, k).numpy(), v, err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_refresh_point_stats(seed):
    # Descriptor choice is integer logic on exact float sums: equal.
    # Normals and distance bands: float32 rounding, 1e-5.
    m = random_map(seed)
    jm = jmu.refresh_point_stats(jms.MapState(**m), dense=False)
    tm = tmu.refresh_point_stats(tms.from_numpy(m, "cpu"))
    np.testing.assert_array_equal(tm.pt_desc_sign.numpy(), np.asarray(jm.pt_desc_sign))
    for k in ("pt_normal", "pt_min_dist", "pt_max_dist"):
        np.testing.assert_allclose(getattr(tm, k).numpy(), np.asarray(getattr(jm, k)), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        tms.obs_matrix(tms.from_numpy(m, "cpu")).numpy(),
        np.asarray(jms.obs_matrix(jms.MapState(**m), dense=False)),
    )


def test_seed_map_from_depth(seq, jslam, jmap):
    # The port's fixture on the same rendered frames builds the same map:
    # identical slots and bindings, descriptors up to rounding-boundary
    # bit flips, geometry to float32 rounding.
    jm, n_kf, n_pts = jmap
    tslam = TorchSlam(cam_params=seq.cam_params, device="cpu", **SLAM_KW)
    tseq = tsynth.SynthSequence(
        images=T(seq.images), R_wc=seq.R_wc, t_wc=seq.t_wc, timestamps=seq.timestamps,
        cam_params=seq.cam_params, depths=T(seq.depths),
    )
    tm, tk, tp = tsynth.seed_map_from_depth(tseq, 3, tslam)
    assert (tk, tp) == (n_kf, n_pts) and n_pts > 300
    for k in ("kf_valid", "kf_obs", "pt_valid", "pt_level", "pt_first_kf", "kf_xy", "kf_level"):
        np.testing.assert_array_equal(getattr(tm, k).numpy(), np.asarray(getattr(jm, k)), err_msg=k)
    for k in ("pt_X", "pt_normal", "pt_min_dist", "pt_max_dist", "kf_R", "kf_t"):
        np.testing.assert_allclose(getattr(tm, k).numpy(), np.asarray(getattr(jm, k)), rtol=1e-5, atol=1e-5, err_msg=k)
    same = np.all(tm.pt_desc_sign.numpy() == np.asarray(jm.pt_desc_sign), axis=1)
    assert same[: n_pts].mean() >= 0.98


def test_checkpoint_round_trips(jmap, tmp_path):
    jm, n_kf, n_pts = jmap
    counters = {"n_kf": n_kf, "n_pts": n_pts, "frame_id": 0, "state": 1,
                "R_cur": np.eye(3).tolist(), "t_cur": [0.0, 0.0, 0.0]}
    p1 = str(tmp_path / "jax_map.npz")
    jckpt.save_map(p1, jm, counters)
    tm, c1 = tckpt.load_map(p1, device="cpu")
    assert c1 == counters
    for k, v in np_tree(jm).items():
        got = getattr(tm, k).numpy()
        assert got.dtype == v.dtype, k
        np.testing.assert_array_equal(got, v, err_msg=k)
    p2 = str(tmp_path / "torch_map.npz")
    tckpt.save_map(p2, tm, counters)
    jm2, c2 = jckpt.load_map(p2)
    assert c2 == counters
    for k, v in np_tree(jm).items():
        np.testing.assert_array_equal(np.asarray(getattr(jm2, k)), v, err_msg=k)
    with open(p2, "r+b") as f:  # corrupt one byte: the md5 check refuses it
        f.seek(100)
        b = f.read(1)
        f.seek(100)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(ValueError):
        tckpt.load_map(p2, device="cpu")


@pytest.mark.parametrize("sched,cap", [("lean", 256), ("dense", None)])
def test_track_against_map(seq, jslam, jmap, sched, cap):
    # Both trackers get the JAX features of frame 4 and the same predicted
    # pose. The normal equations are summed in another order, which can
    # flip a discrete decision (an edge at the chi2 gate, an LM accept)
    # and move the optimum within the noise: poses agree to 1e-3 (1 mm,
    # 1 mrad), the discrete outputs nearly everywhere.
    jm = jmap[0]
    schedule = jtrk.SCHEDULE_LEAN if sched == "lean" else jtrk.SCHEDULE_DENSE
    feats = jslam._extract(jnp.asarray(seq.images[4]))
    R, t = pose_cw(seq, 4)
    dR = np.asarray(jlie.so3_exp(np.asarray([0.01, -0.008, 0.006], np.float32)))
    R_pred = (dR @ R).astype(np.float32)
    t_pred = (t + np.asarray([0.02, -0.01, 0.015])).astype(np.float32)
    kw = dict(width=W, height=H, schedule=schedule, track_cap=cap)
    j = jtrk.track_against_map(jm, feats, R_pred, t_pred, jnp.asarray(seq.cam_params), **kw)
    t_ = ttrk.track_against_map(torch_map(jm), torch_features(feats), T(R_pred), T(t_pred), T(seq.cam_params), **kw)
    np.testing.assert_allclose(t_.R.numpy(), np.asarray(j.R), atol=1e-3)
    np.testing.assert_allclose(t_.t.numpy(), np.asarray(j.t), atol=1e-3)
    assert int(j.n_inliers) > 50
    assert abs(int(t_.n_inliers) - int(j.n_inliers)) <= 2
    assert (t_.visible_mask.numpy() == np.asarray(j.visible_mask)).mean() >= 0.99
    assert (t_.found_mask.numpy() == np.asarray(j.found_mask)).mean() >= 0.99
    assert (t_.feat_pt.numpy() == np.asarray(j.feat_pt)).mean() >= 0.99
    assert t_.feat_pt.dtype == torch.int32
