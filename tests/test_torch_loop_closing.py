"""Loop closing in the port (``models/loop_closing.py``) against the JAX
package, on a map built with numpy from a seed: a candidate keyframe
observing a place, three revisiting keyframes that observe duplicate
landmarks of it displaced by a Sim(3) drift (the same descriptors), a
keyframe that sees nothing of the place, and unrelated keyframes. Checked:
the descriptor pairs, SearchBySim3 (K1's plain version on the CPU), the
batched candidate detection, the duplicate weld and the vocabulary
training (equal to the bit), the pending verification (rounds and the
``miss`` reset the port does and the JAX scan does not), ``try_close`` on
the map (and on an initialized inertial map: the scale fixed, the 4-dof
graph, the velocities), the chunk-boundary re-anchoring of the inertial
tracker pose, the asynchronous global BA (chunks, abort, a keyframe
arriving during the solve, mirroring ``tests/test_async_gba.py``) and the
snapshot a solve started between chunks must take of the chunk loop's
buffers.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.models import loop_closing as jlc
from orb_slam3_ros_tpu.models import map_state as jms
from orb_slam3_ros_tpu.ops import lie as jlie
from orb_slam3_ros_tpu.ops import retrieval as jret
from orb_slam3_ros_tpu_torch.models import local_mapping as tlm
from orb_slam3_ros_tpu_torch.models import loop_closing as tlc
from orb_slam3_ros_tpu_torch.models import map_state as tms
from orb_slam3_ros_tpu_torch.models.system import OK, MonoSlam
from orb_slam3_ros_tpu_torch.ops import ba_pcg, lie as tlie
from orb_slam3_ros_tpu_torch.ops import retrieval as tret
from orb_slam3_ros_tpu_torch.utils import synth as tsynth
from torch_parity import torch_map

torch.set_num_threads(1)
H, W = 480, 640
CAM = np.asarray([400.0, 400.0, 320.0, 240.0, 0, 0, 0, 0, 0], np.float32)
K, N, P = 16, 272, 2048  # N: the feature slots of 250 features at 640x480
CAND, REVISIT, BAD = 2, (11, 12, 13), 14  # slots of the synthetic map
N_PLACE, N_OTHER = 250, 80


def T(a):
    return torch.from_numpy(np.array(a))


def _pose(rng, yaw, pos):
    R_wc = np.asarray(jlie.so3_exp(jnp.asarray([0.0, yaw, 0.0], jnp.float32)))
    R_wc = R_wc @ np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=3) * 0.01, jnp.float32)))
    R = R_wc.T.astype(np.float32)
    return R, (-R @ np.asarray(pos, np.float32)).astype(np.float32)


def _observe(kf_xy, kf_level, kf_desc, kf_obs, kf_fv, k, R, t, X, ids, desc, level):
    """Keyframe k's features: the projections of points X (ids, descriptors,
    levels) that land in the image."""
    Xc = X @ R.T + t
    uv = np.stack([CAM[0] * Xc[:, 0] / Xc[:, 2] + CAM[2], CAM[1] * Xc[:, 1] / Xc[:, 2] + CAM[3]], -1)
    ok = (Xc[:, 2] > 0.1) & (uv[:, 0] > 4) & (uv[:, 0] < W - 4) & (uv[:, 1] > 4) & (uv[:, 1] < H - 4)
    n = int(ok.sum())
    kf_xy[k, :n] = uv[ok]
    kf_level[k, :n] = level[ok]
    kf_desc[k, :n] = desc[ok]
    kf_obs[k, :n] = ids[ok]
    kf_fv[k, :n] = True


def make_revisit_map(seed=0, s_d=1.08):
    """(JAX MapState, n_kf) — see the module docstring; ``s_d``: the drift's
    scale (1 for a metric, inertial map)."""
    rng = np.random.default_rng(seed)
    m = jms.empty_map(K, N, P)
    kf_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    kf_t = np.zeros((K, 3), np.float32)
    kf_xy = np.zeros((K, N, 2), np.float32)
    kf_level = np.zeros((K, N), np.int32)
    kf_desc = np.zeros((K, N, 256), np.int8)
    kf_obs = np.full((K, N), -1, np.int32)
    kf_fv = np.zeros((K, N), bool)
    pt_X = np.zeros((P, 3), np.float32)
    pt_desc = np.zeros((P, 256), np.int8)
    pt_level = np.zeros(P, np.int32)
    pt_first = np.zeros(P, np.int32)
    pt_valid = np.zeros(P, bool)
    # The place: points in front of the candidate (yaw 0 at the origin).
    XA = rng.uniform([-2.5, -1.8, 4.0], [2.5, 1.8, 7.0], (N_PLACE, 3)).astype(np.float32)
    dA = rng.choice(np.array([-1, 1], np.int8), (N_PLACE, 256))
    lA = rng.integers(0, 3, N_PLACE).astype(np.int32)
    idsA = np.arange(N_PLACE, dtype=np.int32)
    # The revisit's duplicates: the place displaced by the drift D.
    s_d = np.float32(s_d)
    R_d = np.asarray(jlie.so3_exp(jnp.asarray([0.02, -0.05, 0.03], jnp.float32)))
    t_d = np.asarray([0.3, -0.1, 0.2], np.float32)
    # Each revisiting keyframe made its own duplicates (as with a tracker
    # that lost the place, so the revisit is not covisible with itself).
    XB = (s_d * XA @ R_d.T + t_d).astype(np.float32)
    idsB = {k: np.arange(N_PLACE * (1 + j), N_PLACE * (2 + j), dtype=np.int32)
            for j, k in enumerate(REVISIT)}
    for ids, X, first in [(idsA, XA, CAND)] + [(idsB[k], XB, k) for k in REVISIT]:
        pt_X[ids], pt_desc[ids], pt_level[ids], pt_first[ids], pt_valid[ids] = X, dA, lA, first, True
    # Unrelated keyframes and their own points elsewhere in the room.
    nxt = N_PLACE * (1 + len(REVISIT))
    for k in range(K - 1):
        if k == CAND:
            R, t = _pose(rng, 0.0, [0.0, 0.0, 0.0])
            _observe(kf_xy, kf_level, kf_desc, kf_obs, kf_fv, k, R, t, XA, idsA, dA, lA)
        elif k in REVISIT:
            # the true pose near the candidate's, stored in the drifted frame:
            # (R_true R_d^T, s t_true - R t_d) maps XB to s times the true
            # camera-frame points, so its features are the true view's
            Rt, tt = _pose(rng, 0.04 * (k - REVISIT[0]), [0.05 * (k - REVISIT[0]), 0.02, -0.05])
            R = (Rt @ R_d.T).astype(np.float32)
            t = (s_d * tt - R @ t_d).astype(np.float32)
            _observe(kf_xy, kf_level, kf_desc, kf_obs, kf_fv, k, R, t, XB, idsB[k], dA, lA)
        else:
            R, t = _pose(rng, np.pi * (0.3 + 0.08 * k), [0.3 * np.cos(k), 0.3 * np.sin(k), 0.0])
            Xo = rng.uniform([-2.0, -1.5, 3.0], [2.0, 1.5, 6.0], (N_OTHER, 3)).astype(np.float32)
            Xo = ((Xo - t) @ R).astype(np.float32)  # in front of this keyframe
            ids = np.arange(nxt, nxt + N_OTHER, dtype=np.int32)
            d = rng.choice(np.array([-1, 1], np.int8), (N_OTHER, 256))
            lv = rng.integers(0, 3, N_OTHER).astype(np.int32)
            pt_X[ids], pt_desc[ids], pt_level[ids], pt_first[ids], pt_valid[ids] = Xo, d, lv, k, True
            nxt += N_OTHER
            if k != BAD:
                _observe(kf_xy, kf_level, kf_desc, kf_obs, kf_fv, k, R, t, Xo, ids, d, lv)
            else:  # features that match nothing of the place
                kf_xy[k, :N_OTHER] = rng.uniform([0, 0], [W, H], (N_OTHER, 2))
                kf_desc[k, :N_OTHER] = rng.choice(np.array([-1, 1], np.int8), (N_OTHER, 256))
                kf_fv[k, :N_OTHER] = True
        kf_R[k], kf_t[k] = R, t
    m = m._replace(
        kf_valid=jnp.asarray(np.arange(K) < K - 1), kf_R=jnp.asarray(kf_R), kf_t=jnp.asarray(kf_t),
        kf_xy=jnp.asarray(kf_xy), kf_level=jnp.asarray(kf_level), kf_desc_sign=jnp.asarray(kf_desc),
        kf_feat_valid=jnp.asarray(kf_fv), kf_obs=jnp.asarray(kf_obs),
        kf_ts=jnp.asarray(np.arange(K, dtype=np.float32)), pt_valid=jnp.asarray(pt_valid),
        pt_X=jnp.asarray(pt_X), pt_desc_sign=jnp.asarray(pt_desc), pt_level=jnp.asarray(pt_level),
        pt_first_kf=jnp.asarray(pt_first),
    )
    return m, K - 1


SLAM_KW = dict(height=H, width=W, cam_params=CAM, n_features=250, max_keyframes=K, max_points=P)
CLOSER_KW = dict(min_gap=8, min_sim3_inliers=15, run_gba=False)


@pytest.fixture(scope="module")
def revisit():
    m, n_kf = make_revisit_map()
    return m, torch_map(m), n_kf


def _jax_pairs(out):
    return [np.asarray(x) for x in out]


def _check_pairs(jout, tout, atol=1e-5):
    X1, X2, ok, pt1, pt2, s1, s2 = _jax_pairs(jout)
    np.testing.assert_array_equal(tout.ok.numpy(), ok)
    np.testing.assert_array_equal(tout.pt1.numpy(), pt1)
    np.testing.assert_array_equal(tout.pt2.numpy()[ok], pt2[ok])
    for want, got in ((X1, tout.X1), (X2, tout.X2), (s1, tout.sig1), (s2, tout.sig2)):
        np.testing.assert_allclose(got.numpy()[ok], want[ok], atol=atol)


@pytest.mark.parametrize("kf1,kf2", [(REVISIT[0], CAND), (REVISIT[1], CAND), (5, CAND), (BAD, CAND)])
def test_match_points_between_matches_jax(revisit, kf1, kf2):
    m, tm, _ = revisit
    jout = jlc._match_points_between(m, jnp.asarray(kf1), jnp.asarray(kf2))
    tout = tlc.match_points_across(tm, kf1, tm, kf2)
    _check_pairs(jout, tout)
    assert int(tout.ok.sum()) == (N_PLACE if kf1 in REVISIT else 0)


def _drift_sim3(m, kf):
    """The Sim(3) S21 the JAX package solves between revisit ``kf`` and the candidate."""
    X1, X2, ok, *_, s1, s2 = jlc._match_points_between(m, jnp.asarray(kf), jnp.asarray(CAND))
    from orb_slam3_ros_tpu.ops import sim3solver as jsim3

    return jsim3.solve_sim3(X1, X2, ok, jnp.asarray(CAM), jax.random.PRNGKey(0), sigma2_1=s1,
                            sigma2_2=s2)


@pytest.mark.parametrize("kf1", [REVISIT[0], REVISIT[2], BAD])
def test_grow_matches_by_sim3_matches_jax(revisit, kf1):
    """SearchBySim3 through K1's plain version (P = N slots, radius 8 px *
    1.2^level, TH_HIGH, no ratio test), under the solved Sim(3)."""
    m, tm, _ = revisit
    res = _drift_sim3(m, REVISIT[0])
    jout = jlc._grow_matches_by_sim3(m, jnp.asarray(kf1), jnp.asarray(CAND), res.s, res.R, res.t,
                                     jnp.asarray(CAM), W, H)
    tout = tlc.search_by_sim3(tm, kf1, tm, CAND, T(res.s), T(res.R), T(res.t), T(CAM), W, H,
                              tlc.SIM3_RADIUS, "sim3")
    _check_pairs(jout, tout)
    if kf1 == REVISIT[0]:
        assert int(tout.ok.sum()) == N_PLACE


@pytest.mark.parametrize("use_covisibility", [True, False])
def test_detect_candidates_batch_is_the_jax_packages(revisit, use_covisibility):
    m, tm, n_kf = revisit
    vocab = tret.default_vocabulary()
    kfs = [REVISIT[0], REVISIT[1], 5, BAD, 10]
    pad = jlc._pad_bucket(kfs)
    want = np.asarray(jlc._detect_candidates_batch(
        m, jnp.asarray(pad), jnp.asarray(n_kf, jnp.int32), jnp.asarray(vocab),
        jnp.asarray(8, jnp.int32), jnp.asarray(0.3, jnp.float32), use_covisibility=use_covisibility,
    ))[: len(kfs)]
    got = tlc._detect_candidates_batch(tm, kfs, n_kf, T(vocab), 8, 0.3, use_covisibility).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:2] == CAND).any(axis=1).all()
    one = tlc._detect_candidates_fused(tm, REVISIT[0], n_kf, T(vocab), 8, 0.3, use_covisibility)
    np.testing.assert_array_equal(one.numpy(), want[0])


def test_fuse_duplicates_is_the_jax_packages(revisit):
    """The Sim(3) inlier pairs of the revisit welded onto the candidate's
    landmarks: every observation redirected, the duplicates dead."""
    m, tm, _ = revisit
    X1, X2, ok, pt1, pt2, *_ = jlc._match_points_between(m, jnp.asarray(REVISIT[0]), jnp.asarray(CAND))
    ok = np.asarray(ok) & (np.random.default_rng(5).random(N) < 0.9)
    want = jlc._fuse_duplicates(m, pt1, pt2, jnp.asarray(ok))
    got = tlc._fuse_duplicates(tm, T(pt1), T(pt2), T(ok))
    np.testing.assert_array_equal(got.kf_obs.numpy(), np.asarray(want.kf_obs))
    np.testing.assert_array_equal(got.pt_valid.numpy(), np.asarray(want.pt_valid))
    assert not got.pt_valid.numpy()[np.asarray(pt1)[ok]].any()


@pytest.mark.parametrize("hier", [False, True])
def test_train_vocabulary_is_the_jax_packages(hier):
    """The numpy k-medians of both packages give the same words, to the bit."""
    rng = np.random.default_rng(6)
    protos = rng.choice(np.array([-1, 1], np.int8), (40, 256))
    desc = protos[rng.integers(0, 40, 3000)].copy()
    flip = rng.random(desc.shape) < 0.1
    desc[flip] = -desc[flip]
    if hier:
        want = jret.train_vocabulary_hier(desc, n_words=1024)
        got = tret.train_vocabulary_hier(desc, n_words=1024)
    else:
        want = jret.train_vocabulary(desc, n_words=256)
        got = tret.train_vocabulary(desc, n_words=256)
    assert got.dtype == np.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    small = desc[:100]  # fewer samples than words: the hierarchy falls back to flat
    np.testing.assert_array_equal(tret.train_vocabulary_hier(small, n_words=1024),
                                  jret.train_vocabulary_hier(small, n_words=1024))


def _pending(m, tm):
    """The hypothesis stashed on the first revisit: S_cw = S21 S_neww."""
    res = _drift_sim3(m, REVISIT[0])
    one = jnp.ones(())
    S_cw = jlie.sim3_mul(res.R, res.t, res.s, m.kf_R[REVISIT[0]], m.kf_t[REVISIT[0]], one)
    return S_cw, tuple(T(x) for x in S_cw)


def _jax_scan(m, kfs, S_cw, required, count0=1, miss0=0):
    pad = jlc._pad_bucket(kfs)
    buf = np.asarray(jlc._verify_pending_scan(
        m, jnp.asarray(pad), jnp.asarray(CAND), S_cw, jnp.asarray(CAM), W, H, 15,
        jnp.asarray(count0, jnp.int32), jnp.asarray(miss0, jnp.int32),
        jnp.asarray(required, jnp.int32)))
    B = len(pad)
    status = buf[: 4 * B].reshape(B, 4)[: len(kfs)] > 0.5
    o = 4 * B
    state, count, miss = (int(v) for v in buf[o: o + 3])
    o += 3
    S = (buf[o: o + 9].reshape(3, 3), buf[o + 9: o + 12], buf[o + 12])
    fire = (buf[o + 13: o + 22].reshape(3, 3), buf[o + 22: o + 25], buf[o + 25], int(buf[o + 26]))
    return status, state, count, miss, S, fire


def test_verify_pending_scan_fires_as_the_jax_scan(revisit):
    """Two more revisits confirm the hypothesis: it fires on the second, with
    the same status rows, counts and refined Sim(3) as the JAX scan."""
    m, tm, _ = revisit
    jS, tS = _pending(m, tm)
    kfs = [REVISIT[1], REVISIT[2]]
    status, state, count, miss, S, fire = _jax_scan(m, kfs, jS, required=3)
    scan = tlc._verify_pending_scan(tm, kfs, CAND, tS, T(CAM), W, H, 15, 1, 0, 3)
    np.testing.assert_array_equal(scan.status, status)
    assert (scan.state, scan.count, scan.miss) == (state, count, miss) == (1, 3, 0)
    fR, ft, fs, fn, fpt1, fpt2, fok = scan.fire
    np.testing.assert_allclose(fR.numpy(), fire[0], atol=1e-4)
    np.testing.assert_allclose(ft.numpy(), fire[1], atol=1e-4)
    np.testing.assert_allclose(float(fs), fire[2], atol=1e-4)
    assert int(fn) == fire[3] == N_PLACE
    np.testing.assert_allclose(float(fs), 1.0 / 1.08, atol=1e-3)  # the drift's scale, undone


def test_a_hit_resets_miss_unlike_the_jax_scan(revisit):
    """hit, miss, hit, miss: the JAX scan never resets ``miss`` on a hit
    (orb_slam3_ros_tpu/models/loop_closing.py:600), so the second miss kills
    the hypothesis there; its sequential path (loop_closing.py:1085-1086)
    and the reference (LoopClosing.cc:1415) reset it, and so does the port's
    scan: the hypothesis lives, two hits up, one miss pending."""
    m, tm, _ = revisit
    jS, tS = _pending(m, tm)
    kfs = [REVISIT[1], BAD, REVISIT[2], BAD]
    status, state, count, miss, _, _ = _jax_scan(m, kfs, jS, required=10)
    assert (state, count, miss) == (2, 3, 2)  # died at the fourth round
    assert status[3, 3] and not status[:3, 3].any()
    scan = tlc._verify_pending_scan(tm, kfs, CAND, tS, T(CAM), W, H, 15, 1, 0, 10)
    np.testing.assert_array_equal(scan.status[:, :2], status[:, :2])  # the same rounds ran and hit
    assert (scan.state, scan.count, scan.miss) == (0, 3, 1)
    assert not scan.status[:, 3].any()


def _slams(tm, m, inertial=False, **closer_kw):
    """A port MonoSlam and a JAX one holding the revisit map, each with a
    loop closer; with ``inertial``, InertialSlams with the IMU initialized."""
    from orb_slam3_ros_tpu.models.inertial_system import InertialSlam as JaxVI
    from orb_slam3_ros_tpu.models.system import MonoSlam as JaxSlam
    from orb_slam3_ros_tpu_torch.models.inertial_system import InertialSlam
    from torch_parity import torch_calib
    from vi_sim import make_calib

    if inertial:
        js = JaxVI(enable_loop_closing=True, calib=make_calib(), **SLAM_KW)
        ts = InertialSlam(enable_loop_closing=True, calib=torch_calib(make_calib()), device="cpu",
                          **SLAM_KW)
        js.imu_initialized = ts.imu_initialized = True
    else:
        js = JaxSlam(enable_loop_closing=True, pipelined=False, **SLAM_KW)
        ts = MonoSlam(enable_loop_closing=True, device="cpu", pipelined=False, **SLAM_KW)
    js.map, js.n_kf, js.n_pts, js.state = m, K - 1, int(np.asarray(m.pt_valid).sum()), OK
    ts.map, ts.n_kf, ts.n_pts, ts.state = copy.deepcopy(tm), K - 1, js.n_pts, OK
    for s in (js, ts):
        for k, v in closer_kw.items():
            setattr(s.loop_closer, k, v)
    return js, ts


def test_try_close_on_the_revisit_map_matches_jax(revisit):
    """Per keyframe: the first revisit stashes the hypothesis, the next two
    confirm it and the third closes the loop; the corrected map (4-dof
    off: a visual map, 7-dof Sim(3) graph), the weld and the refreshed
    points are the JAX package's."""
    m, tm, _ = revisit
    js, ts = _slams(tm, m, **CLOSER_KW)
    key = jax.random.PRNGKey(0)
    for k in REVISIT:
        fj = js.loop_closer.try_close(js, k, key)
        ft = ts.loop_closer.try_close(ts, k)
        assert fj == ft == (k == REVISIT[-1])
    assert ts.loop_closer.closures == js.loop_closer.closures == [(REVISIT[-1], CAND, N_PLACE)]
    assert ts.loop_closer.sim3_searches == 2  # the two pending verifications
    jm, tmap = js.map, ts.map
    np.testing.assert_allclose(tmap.kf_R.numpy(), np.asarray(jm.kf_R), atol=2e-4)
    np.testing.assert_allclose(tmap.kf_t.numpy(), np.asarray(jm.kf_t), atol=2e-4)
    np.testing.assert_array_equal(tmap.kf_obs.numpy(), np.asarray(jm.kf_obs))
    np.testing.assert_array_equal(tmap.pt_valid.numpy(), np.asarray(jm.pt_valid))
    np.testing.assert_allclose(ts.R_cur, np.asarray(js.R_cur), atol=2e-4)
    np.testing.assert_array_equal(ts.loop_closer._edge_i, js.loop_closer._edge_i)
    np.testing.assert_allclose(ts.loop_closer._edge_s, js.loop_closer._edge_s, atol=1e-4)


@pytest.fixture(scope="module")
def metric_revisit():
    m, n_kf = make_revisit_map(s_d=1.0)
    return m, torch_map(m), n_kf


def test_inertial_closure_fixes_scale_and_corrects_in_4dof_as_jax(metric_revisit):
    """On an initialized inertial map: the Sim(3) solved with the scale
    fixed, the 4-dof essential graph (yaw and translation updates from the
    start the loop's Sim(3) propagates through the new keyframe's
    neighbourhood), velocities rotated by each keyframe's correction; the
    JAX package's closure and map."""
    m, tm, _ = metric_revisit
    js, ts = _slams(tm, m, inertial=True, **CLOSER_KW)
    vel = np.random.default_rng(7).normal(size=(K, 3)).astype(np.float32)
    js.map = js.map._replace(kf_v=jnp.asarray(vel))
    ts.map = ts.map._replace(kf_v=T(vel))
    key = jax.random.PRNGKey(0)
    for k in REVISIT:
        assert js.loop_closer.try_close(js, k, key) == ts.loop_closer.try_close(ts, k)
    assert ts.loop_closer.closures == js.loop_closer.closures and ts.loop_closer.closures
    assert ts.loop_closer._edge_s[0] == 1.0  # the scale was fixed
    np.testing.assert_allclose(ts.map.kf_R.numpy(), np.asarray(js.map.kf_R), atol=2e-4)
    np.testing.assert_allclose(ts.map.kf_t.numpy(), np.asarray(js.map.kf_t), atol=2e-4)
    np.testing.assert_allclose(ts.map.kf_v.numpy(), np.asarray(js.map.kf_v), atol=2e-4)


def test_chunk_boundary_closure_carries_the_tracker_pose(metric_revisit):
    """``InertialSlam._close_at_boundary``: the end-of-chunk pose, frames
    past the newest keyframe, rides that keyframe's correction,
    T_cur' = (T_cur T_kf_old^-1) T_kf_new, its velocity rotated alike; the
    chunk's inertial state is rebuilt at the next chunk."""
    m, tm, _ = metric_revisit
    _, ts = _slams(tm, m, inertial=True, **CLOSER_KW)
    ts.n_kf = REVISIT[-1] + 1  # the last revisit is the newest keyframe
    last = REVISIT[-1]
    dR = tlie.so3_exp(torch.tensor([0.01, 0.02, -0.01])).numpy()
    R_old, t_old = ts.map.kf_R[last].numpy(), ts.map.kf_t[last].numpy()
    ts.R_cur, ts.t_cur = (dR @ R_old).astype(np.float32), (dR @ t_old + [0.05, 0.0, 0.02]).astype(np.float32)
    ts.v_cur = np.asarray([0.3, -0.1, 0.05], np.float32)
    R_cur, t_cur, v_cur = ts.R_cur.copy(), ts.t_cur.copy(), ts.v_cur.copy()
    ts._vi_dev_valid = True
    assert not ts._close_at_boundary(list(REVISIT))
    assert ts.loop_closer.closures and not ts._vi_dev_valid
    R_new, t_new = ts.map.kf_R[last].numpy(), ts.map.kf_t[last].numpy()
    assert np.abs(R_new - R_old).max() > 1e-3  # the closure moved the newest keyframe
    R_rel = R_cur @ R_old.T
    np.testing.assert_allclose(ts.R_cur, R_rel @ R_new, atol=1e-5)
    np.testing.assert_allclose(ts.t_cur, R_rel @ t_new + t_cur - R_rel @ t_old, atol=1e-5)
    np.testing.assert_allclose(ts.v_cur, R_new.T @ R_old @ v_cur, atol=1e-5)


def test_try_close_batch_closes_on_the_same_keyframe(revisit):
    """The chunk-boundary form over the three revisits at once: the same
    closure; its two verification rounds are counted as SearchBySim3
    calls."""
    m, tm, _ = revisit
    js, ts = _slams(tm, m, **CLOSER_KW)
    assert js.loop_closer.try_close_batch(js, list(REVISIT), jax.random.PRNGKey(0))
    assert ts.loop_closer.try_close_batch(ts, list(REVISIT))
    assert ts.loop_closer.closures == js.loop_closer.closures
    assert ts.loop_closer.sim3_searches == 2
    np.testing.assert_allclose(ts.map.kf_t.numpy(), np.asarray(js.map.kf_t), atol=2e-4)


def test_closure_starts_the_global_ba_and_flush_folds_it_in(revisit):
    m, tm, _ = revisit
    _, ts = _slams(tm, m, min_gap=8, min_sim3_inliers=15, required_consistency=1, gba_iters=4)
    assert ts.loop_closer.try_close(ts, REVISIT[0])
    assert ts._gba is not None and ts.gba_counts["started"] == 1
    ts.flush()
    assert ts._gba is None and ts.gba_counts == {"started": 1, "finished": 1, "dispatches": 2}
    assert np.isfinite(ts.map.kf_t.numpy()).all()


def test_vocabulary_training_runs_off_the_calling_thread(revisit):
    """With no vocabulary the closer trains one once 12 keyframes exist; the
    result installs at a later check, in the system and the closer both."""
    m, tm, _ = revisit
    _, ts = _slams(tm, m)
    lc = ts.loop_closer
    lc.vocab = None
    lc._poll_vocab_training(ts)
    assert lc._vocab_future is not None
    lc._vocab_future.result()
    lc._poll_vocab_training(ts)
    assert lc._vocab_trained_at == K - 1 and lc._vocab_future is None
    assert lc.vocab is ts.vocab and lc.vocab.shape[1] == 256


def test_remap_slots_moves_and_drops_loop_edges():
    lc = tlc.LoopCloser()
    lc._record_loop_edge(5, 2, np.eye(3), np.zeros(3), 1.0)
    lc._record_loop_edge(7, 1, np.eye(3), np.zeros(3), 1.0)
    lc.last_closed_kf = 7
    lc._pending = {"cand": 2}
    new_of_old = np.asarray([0, -1, 1, 2, 3, 4, -1, 5], np.int32)
    lc.remap_slots(new_of_old)
    assert (lc._edge_i[0], lc._edge_j[0]) == (4, 1) and lc._edge_i[1] == -1
    assert lc.last_closed_kf == 5 and lc._pending is None
    for _ in range(16):
        lc._record_loop_edge(1, 0, np.eye(3), np.zeros(3), 1.0)
    assert lc.max_loop_edges == 32


def test_dump_dir_raises_naming_its_item(monkeypatch):
    # The closer takes its dump directory from the argument, else from
    # ORB_TPU_LOOP_DUMP_DIR, and raises for neither. (The name is kept from
    # when the port refused the dump; it is ported: test_torch_optdump.py.)
    monkeypatch.delenv("ORB_TPU_LOOP_DUMP_DIR", raising=False)
    assert tlc.LoopCloser(dump_dir="somewhere").dump_dir == "somewhere"
    assert tlc.LoopCloser().dump_dir is None
    monkeypatch.setenv("ORB_TPU_LOOP_DUMP_DIR", "elsewhere")
    assert tlc.LoopCloser().dump_dir == "elsewhere"


# ---------------------------------------------------------------------------
# The asynchronous global BA, as ``tests/test_async_gba.py`` holds the JAX
# package's.
GBA_CAM = np.asarray([120.0, 120.0, 96.0, 64.0, 0, 0, 0, 0, 0], np.float32)


def _consistent_system(seed, K_use=6, P_use=48, perturb=0.02):
    """A port MonoSlam whose K_use keyframes all observe the same P_use
    points at their exact projections, poses and points perturbed."""
    rng = np.random.default_rng(seed)
    slam = MonoSlam(height=128, width=192, cam_params=GBA_CAM, n_features=200, max_keyframes=8,
                    max_points=256, device="cpu")
    X = np.stack([rng.uniform(-1.5, 1.5, P_use), rng.uniform(-1.0, 1.0, P_use),
                  rng.uniform(4.0, 6.0, P_use)], axis=1).astype(np.float32)
    Kc, Nc = slam.K_cap, slam.N
    kf_R = np.tile(np.eye(3, dtype=np.float32), (Kc, 1, 1))
    kf_t = np.zeros((Kc, 3), np.float32)
    kf_xy = np.zeros((Kc, Nc, 2), np.float32)
    kf_obs = np.full((Kc, Nc), -1, np.int32)
    fv = np.zeros((Kc, Nc), bool)
    for k in range(K_use):
        kf_t[k] = [0.25 * k, 0.0, 0.0]
        Xc = X + kf_t[k]
        kf_xy[k, :P_use] = np.stack([GBA_CAM[0] * Xc[:, 0] / Xc[:, 2] + GBA_CAM[2],
                                     GBA_CAM[1] * Xc[:, 1] / Xc[:, 2] + GBA_CAM[3]], -1)
        kf_obs[k, :P_use] = np.arange(P_use)
        fv[k, :P_use] = True
    R_gt, t_gt = kf_R.copy(), kf_t.copy()
    for k in range(2, K_use):
        dR = jlie.so3_exp(jnp.asarray(rng.normal(size=3).astype(np.float32) * perturb))
        kf_R[k] = np.asarray(dR) @ kf_R[k]
        kf_t[k] = kf_t[k] + rng.normal(size=3).astype(np.float32) * perturb
    pt_X = np.zeros((slam.P_cap, 3), np.float32)
    pt_X[:P_use] = X + rng.normal(size=X.shape).astype(np.float32) * perturb
    slam.map = slam.map._replace(
        kf_valid=T(np.arange(Kc) < K_use), kf_R=T(kf_R), kf_t=T(kf_t), kf_xy=T(kf_xy),
        kf_obs=T(kf_obs), kf_feat_valid=T(fv), pt_valid=T(np.arange(slam.P_cap) < P_use),
        pt_X=T(pt_X),
    )
    slam.n_kf, slam.n_pts, slam.state = K_use, P_use, OK
    return slam, R_gt, t_gt


def _pose_err(slam, R_gt, t_gt, K_use):
    return float(np.linalg.norm(slam.map.kf_t.numpy()[:K_use] - t_gt[:K_use])
                 + np.linalg.norm(slam.map.kf_R.numpy()[:K_use] - R_gt[:K_use]))


def test_gba_chunks_and_abort():
    slam, R_gt, t_gt = _consistent_system(0)
    err0 = _pose_err(slam, R_gt, t_gt, 6)
    slam._start_async_gba(8, chunk=2)
    assert slam._gba is not None and slam._gba["done"] == 2
    slam._poll_gba(force=True)
    assert slam._gba["done"] == 4
    slam.abort_gba()  # a new keyframe arrived
    slam._poll_gba(force=True)
    assert slam._gba is None
    assert _pose_err(slam, R_gt, t_gt, 6) < err0 * 0.7


def test_gba_full_run_applies():
    slam, R_gt, t_gt = _consistent_system(0)
    err0 = _pose_err(slam, R_gt, t_gt, 6)
    slam._start_async_gba(8, chunk=4)
    slam.flush()
    assert _pose_err(slam, R_gt, t_gt, 6) < err0 * 0.5
    assert slam.gba_counts == {"started": 1, "finished": 1, "dispatches": 2}


def test_keyframe_during_gba_is_propagated():
    """A keyframe inserted during the solve keeps its pose relative to the
    last keyframe the solve saw (LoopClosing.cc:3713)."""
    slam, _, _ = _consistent_system(0, K_use=5)
    slam._start_async_gba(8, chunk=2)
    R4, t4 = slam.map.kf_R[4].clone(), slam.map.kf_t[4].clone()
    R_rel = tlie.so3_exp(torch.tensor([0.0, 0.05, 0.0]))
    t_rel = torch.tensor([0.3, 0.0, 0.0])
    slam.map.kf_valid[5] = True
    slam.map.kf_R[5] = R_rel @ R4
    slam.map.kf_t[5] = R_rel @ t4 + t_rel
    slam.n_kf = 6
    slam.abort_gba()
    slam.flush()
    m = slam.map
    torch.testing.assert_close(m.kf_R[5], R_rel @ m.kf_R[4], atol=1e-5, rtol=0)
    torch.testing.assert_close(m.kf_t[5], R_rel @ m.kf_t[4] + t_rel, atol=1e-5, rtol=0)


def test_a_gba_started_between_chunks_solves_a_snapshot():
    """After a chunk the map's tensors are the chunk loop's buffers, which
    the next chunk overwrites in place. A global BA started between chunks
    must solve, and fold in against, the map as it stood at its start:
    the fold-in equals one computed from a copy taken then (and the next
    chunk did change what the solve reads)."""
    seq = tsynth.make_sequence(n_frames=40, height=240, width=376, dt=0.1, seed=3, device="cpu")
    slam = MonoSlam(height=240, width=376, cam_params=seq.cam_params, n_features=1000,
                    max_keyframes=16, max_points=3072, kf_every=3, lean_after_kf=4, track_cap=768,
                    device="cpu", pipelined=False)
    stack = torch.clamp(seq.images, 0, 255).to(torch.uint8)
    i = 0
    while not slam._chunkable():
        slam.process_frame(seq.images[i], float(seq.timestamps[i]))
        i += 1
    slam.process_frames((stack, i), seq.timestamps[i : i + 4])
    i += 4
    assert slam.map.kf_obs is slam._mono_runner.buf["m.kf_obs"]  # the map is the buffers
    snap = tms.MapState(*(x.clone() for x in slam.map))
    n_kf0 = slam.n_kf
    slam._start_async_gba(8, chunk=2)
    # the same solve on the copy: four dispatches of 2 LM iterations
    prob = tlm.build_global_ba(snap, n_kf0, slam.cam_params)
    for _ in range(4):
        res = ba_pcg.bundle_adjust_pcg(prob, n_iters=2, n_cg=50)
        prob = prob._replace(R=res.R, t=res.t, X=res.X)
    slam.process_frames((stack, i), seq.timestamps[i : i + 6])
    after = tms.MapState(*(x.clone() for x in slam.map))
    old = slice(0, n_kf0)
    assert (after.kf_obs[old] != snap.kf_obs[old]).any() or (after.pt_valid != snap.pt_valid).any()
    slam.flush()
    want = tlm.apply_global_ba_partial(after, res, n_kf0, kf_obs0=snap.kf_obs)
    want = tlc.map_updates.refresh_point_stats(want, n_levels=slam.config.n_levels)
    for f in tms.MapState._fields:
        w, g = getattr(want, f), getattr(slam.map, f)
        if w.dtype.is_floating_point:
            torch.testing.assert_close(g, w, atol=1e-6, rtol=0, msg=f)
        else:
            assert torch.equal(g, w), f
