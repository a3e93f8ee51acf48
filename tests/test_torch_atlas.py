"""The Atlas in the port (``models/atlas.py`` and its hooks in ``MonoSlam`` /
``InertialSlam``) against the JAX package, on maps built with numpy from a
seed: an archived map whose keyframes 2 and 3 observe a place, and a
younger map in a world frame displaced by a Sim(3) whose keyframes 1 and 2
observe the place's duplicates (the same descriptors); the other keyframes
observe points of their own. Checked: the map transform and the bulk copy
(with its overflow result), the cross-map descriptor pairs and SearchBySim3
(K1's plain version on the CPU), the weld of a monocular map (Sim(3)) and
of an inertial one (rigid, the IMU blocks re-indexed, the seam a chain
break; also at a VI chunk boundary, where the tracker snaps to the newest
keyframe) from the JAX package's own RANSAC samples, the archive with and
without IMU and the discard below ``min_kf_keep``, the switch into an
archived map, the lost-frame count with its dense schedule, the archive at
a timestamp jump, and the three faults of the JAX package the port does
not copy, each shown beside the JAX result.

Tolerances: integer and boolean results equal; poses, points and Sim(3)s
to 2e-4 (float32 Umeyama / IRLS in two libraries); signatures to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.models import atlas as jatlas
from orb_slam3_ros_tpu.models import map_state as jms
from orb_slam3_ros_tpu.models import system as jsys
from orb_slam3_ros_tpu.models.inertial_system import InertialSlam as JaxVI
from orb_slam3_ros_tpu.ops import lie as jlie
from orb_slam3_ros_tpu.ops import orb as jorb
from orb_slam3_ros_tpu_torch.models import atlas as tatlas
from orb_slam3_ros_tpu_torch.models import system as tsys
from orb_slam3_ros_tpu_torch.models.inertial_system import InertialSlam
from orb_slam3_ros_tpu_torch.ops import sim3solver as tsim3
from torch_parity import torch_calib, torch_features, torch_map
from vi_sim import make_calib

torch.set_num_threads(1)
H, W = 480, 640
CAM = np.asarray([400.0, 400.0, 320.0, 240.0, 0, 0, 0, 0, 0], np.float32)
K, N, P = 16, 272, 2048
N_PLACE, N_OTHER = 250, 80
A_PLACE, C_PLACE = (2, 3), (1, 2)  # keyframes that see the place, archived / current map
N_KF_A, N_KF_C = 8, 5
SLAM_KW = dict(height=H, width=W, cam_params=CAM, n_features=250, max_keyframes=K, max_points=P)
ATOL = 2e-4


def T(a):
    return torch.from_numpy(np.array(a))


def _rot(phi):
    return np.asarray(jlie.so3_exp(jnp.asarray(phi, jnp.float32)))


def _pose(rng, yaw, pos):
    R_wc = _rot([0.0, yaw, 0.0]) @ _rot(rng.normal(size=3) * 0.01)
    R = R_wc.T.astype(np.float32)
    return R, (-R @ np.asarray(pos, np.float32)).astype(np.float32)


class _Tables:
    """numpy tables of one map under construction."""

    def __init__(self):
        self.kf_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
        self.kf_t = np.zeros((K, 3), np.float32)
        self.kf_xy = np.zeros((K, N, 2), np.float32)
        self.kf_level = np.zeros((K, N), np.int32)
        self.kf_desc = np.zeros((K, N, 256), np.int8)
        self.kf_obs = np.full((K, N), -1, np.int32)
        self.kf_fv = np.zeros((K, N), bool)
        self.pt_X = np.zeros((P, 3), np.float32)
        self.pt_desc = np.zeros((P, 256), np.int8)
        self.pt_level = np.zeros(P, np.int32)
        self.pt_first = np.zeros(P, np.int32)
        self.pt_valid = np.zeros(P, bool)
        self.pt_normal = np.zeros((P, 3), np.float32)
        self.pt_band = np.zeros((P, 2), np.float32)
        self.nxt = 0

    def points(self, X, desc, level, first, rng):
        ids = np.arange(self.nxt, self.nxt + len(X), dtype=np.int32)
        self.nxt += len(X)
        self.pt_X[ids], self.pt_desc[ids], self.pt_level[ids] = X, desc, level
        self.pt_first[ids], self.pt_valid[ids] = first, True
        nrm = rng.normal(size=(len(X), 3)).astype(np.float32)
        self.pt_normal[ids] = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
        self.pt_band[ids] = rng.uniform([0.5, 4.0], [1.0, 9.0], (len(X), 2))
        return ids

    def observe(self, k, R, t, X, ids, desc, level):
        Xc = X @ R.T + t
        uv = np.stack([CAM[0] * Xc[:, 0] / Xc[:, 2] + CAM[2], CAM[1] * Xc[:, 1] / Xc[:, 2] + CAM[3]], -1)
        ok = (Xc[:, 2] > 0.1) & (uv[:, 0] > 4) & (uv[:, 0] < W - 4) & (uv[:, 1] > 4) & (uv[:, 1] < H - 4)
        n = int(ok.sum())
        self.kf_xy[k, :n], self.kf_level[k, :n], self.kf_desc[k, :n] = uv[ok], level[ok], desc[ok]
        self.kf_obs[k, :n], self.kf_fv[k, :n] = ids[ok], True
        self.kf_R[k], self.kf_t[k] = R, t

    def other(self, k, rng, R, t):
        Xo = ((rng.uniform([-2.0, -1.5, 3.0], [2.0, 1.5, 6.0], (N_OTHER, 3)) - t) @ R).astype(np.float32)
        d = rng.choice(np.array([-1, 1], np.int8), (N_OTHER, 256))
        lv = rng.integers(0, 3, N_OTHER).astype(np.int32)
        self.observe(k, R, t, Xo, self.points(Xo, d, lv, k, rng), d, lv)

    def jax_map(self, n_kf, rng):
        m = jms.empty_map(K, N, P)
        vel = rng.normal(size=(K, 3)).astype(np.float32) * (np.arange(K) < n_kf)[:, None]
        return m._replace(
            kf_valid=jnp.asarray(np.arange(K) < n_kf), kf_R=jnp.asarray(self.kf_R),
            kf_t=jnp.asarray(self.kf_t), kf_xy=jnp.asarray(self.kf_xy),
            kf_level=jnp.asarray(self.kf_level), kf_desc_sign=jnp.asarray(self.kf_desc),
            kf_feat_valid=jnp.asarray(self.kf_fv), kf_obs=jnp.asarray(self.kf_obs),
            kf_ts=jnp.asarray(np.arange(K, dtype=np.float32)), kf_v=jnp.asarray(vel),
            pt_valid=jnp.asarray(self.pt_valid), pt_X=jnp.asarray(self.pt_X),
            pt_desc_sign=jnp.asarray(self.pt_desc), pt_level=jnp.asarray(self.pt_level),
            pt_first_kf=jnp.asarray(self.pt_first), pt_normal=jnp.asarray(self.pt_normal),
            pt_min_dist=jnp.asarray(self.pt_band[:, 0]), pt_max_dist=jnp.asarray(self.pt_band[:, 1]),
            pt_found=jnp.asarray(np.where(self.pt_valid, 3, 0).astype(np.int32)),
            pt_visible=jnp.asarray(np.where(self.pt_valid, 4, 0).astype(np.int32)),
        ), self.nxt


def make_two_maps(seed=0, s_d=1.08):
    """(archived JAX map, its n_pts, current JAX map, its n_pts, drift): see
    the module docstring; the current map's world is D(archived world)."""
    rng = np.random.default_rng(seed)
    XA = rng.uniform([-2.5, -1.8, 4.0], [2.5, 1.8, 7.0], (N_PLACE, 3)).astype(np.float32)
    dA = rng.choice(np.array([-1, 1], np.int8), (N_PLACE, 256))
    lA = rng.integers(0, 3, N_PLACE).astype(np.int32)
    s_d = np.float32(s_d)
    R_d = _rot([0.02, -0.35, 0.03])
    t_d = np.asarray([1.3, -0.1, 0.6], np.float32)
    a, c = _Tables(), _Tables()
    ids_a = a.points(XA, dA, lA, A_PLACE[0], rng)
    XC = (s_d * XA @ R_d.T + t_d).astype(np.float32)
    ids_c = c.points(XC, dA, lA, C_PLACE[0], rng)
    for k in range(N_KF_A):
        R, t = _pose(rng, np.pi * (0.3 + 0.08 * k), [0.3 * np.cos(k), 0.3 * np.sin(k), 0.0])
        if k in A_PLACE:
            j = A_PLACE.index(k)
            R, t = _pose(rng, 0.03 * j, [0.05 * j, 0.0, 0.0])
            a.observe(k, R, t, XA, ids_a, dA, lA)
        else:
            a.other(k, rng, R, t)
    for k in range(N_KF_C):
        R, t = _pose(rng, np.pi * (1.1 + 0.1 * k), [0.2 * np.cos(k), 0.0, 0.2 * np.sin(k)])
        if k in C_PLACE:
            j = C_PLACE.index(k)
            Rt, tt = _pose(rng, 0.02 + 0.03 * j, [0.04 + 0.05 * j, 0.02, -0.05])
            # the true pose near the place, in the drifted world
            R = (Rt @ R_d.T).astype(np.float32)
            t = (s_d * tt - R @ t_d).astype(np.float32)
            c.observe(k, R, t, XC, ids_c, dA, lA)
        else:
            c.other(k, rng, R, t)
    ma, na = a.jax_map(N_KF_A, rng)
    mc, nc = c.jax_map(N_KF_C, rng)
    return ma, na, mc, nc


@pytest.fixture(scope="module")
def maps():
    return make_two_maps()


@pytest.fixture(scope="module")
def metric_maps():
    return make_two_maps(seed=1, s_d=1.0)


def _check_map(tm, jm, atol=ATOL):
    for f in jms.MapState._fields:
        want, got = np.asarray(getattr(jm, f)), getattr(tm, f).numpy()
        if want.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, atol=atol, err_msg=f)


def _vocab():
    from orb_slam3_ros_tpu_torch.ops import retrieval

    return retrieval.default_vocabulary()


# ---------------------------------------------------------------------------
# the map transform and the bulk copy


@pytest.mark.parametrize("seed", [0, 1])
def test_transform_map_matches_jax(maps, seed):
    """Poses, points and velocities as the JAX package moves them; the
    cameras see the points scaled by sw, undistorted."""
    _, _, mc, _ = maps
    rng = np.random.default_rng(seed)
    Rw, tw, sw = _rot(rng.normal(size=3) * 0.4), rng.normal(size=3).astype(np.float32), 0.7 + seed
    jm = jatlas._transform_map(mc, jnp.asarray(Rw), jnp.asarray(tw), jnp.asarray(sw, jnp.float32))
    tm = tatlas._transform_map(torch_map(mc), T(Rw), T(tw), torch.tensor(sw, dtype=torch.float32))
    for f in ("pt_X", "kf_R", "kf_t", "kf_v"):
        np.testing.assert_allclose(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)), atol=1e-4,
                                   err_msg=f)
    k, X = C_PLACE[0], np.asarray(mc.pt_X)[:N_PLACE]
    Xc0 = X @ np.asarray(mc.kf_R[k]).T + np.asarray(mc.kf_t[k])
    Xc1 = tm.pt_X.numpy()[:N_PLACE] @ tm.kf_R[k].numpy().T + tm.kf_t[k].numpy()
    np.testing.assert_allclose(Xc1, sw * Xc0, atol=1e-3)


def test_concat_maps_matches_jax(maps):
    """The younger map's keyframes and points in the older one's free
    slots, landmark ids shifted by its point count, creating keyframes by
    its keyframe count: every field the JAX package copies is equal."""
    ma, na, mc, nc = maps
    jm, jk, jp = jatlas._concat_maps(ma, N_KF_A, na, mc, N_KF_C, nc)
    tm, tk, tp = tatlas._concat_maps(torch_map(ma), N_KF_A, na, torch_map(mc), N_KF_C, nc)
    assert (tk, tp) == (jk, jp) == (N_KF_A + N_KF_C, na + nc)
    skip = ("pt_normal", "pt_min_dist", "pt_max_dist")  # see the fault test
    for f in jms.MapState._fields:
        if f not in skip:
            np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)), err_msg=f)
    assert int(tm.kf_obs[N_KF_A + C_PLACE[0]].max()) == na + N_PLACE - 1


@pytest.mark.parametrize("over", ["keyframes", "points"])
def test_concat_maps_overflow_is_none_as_jax(maps, over):
    ma, na, mc, nc = maps
    kf_a, pts_a = (K - 2, na) if over == "keyframes" else (N_KF_A, P - 10)
    want = jatlas._concat_maps(ma, kf_a, pts_a, mc, N_KF_C, nc)
    got = tatlas._concat_maps(torch_map(ma), kf_a, pts_a, torch_map(mc), N_KF_C, nc)
    assert want == (None, 0, 0) and got == (None, 0, 0)


# ---------------------------------------------------------------------------
# cross-map pairs and SearchBySim3


@pytest.mark.parametrize("kc,ka", [(C_PLACE[0], A_PLACE[0]), (C_PLACE[1], A_PLACE[0]),
                                   (C_PLACE[0], A_PLACE[1]), (0, A_PLACE[0])])
def test_cross_map_pairs_match_jax(maps, kc, ka):
    ma, _, mc, _ = maps
    want = [np.asarray(x) for x in jatlas._cross_map_pairs(mc, ma, kc, ka)]
    tc, ta = torch_map(mc), torch_map(ma)
    got = tatlas.match_points_across(tc, kc, ta, ka)
    X1, X2, ok, pt1, pt2 = want
    np.testing.assert_array_equal(got[2].numpy(), ok)
    np.testing.assert_array_equal(got[3].numpy(), pt1)
    np.testing.assert_array_equal(got[4].numpy()[ok], pt2[ok])
    np.testing.assert_allclose(got[0].numpy()[ok], X1[ok], atol=1e-5)
    np.testing.assert_allclose(got[1].numpy()[ok], X2[ok], atol=1e-5)
    assert (int(ok.sum()) > 100) == (kc in C_PLACE)


def _jax_sim3(mc, ma, kc, ka, fix_scale=False):
    from orb_slam3_ros_tpu.ops import sim3solver as jsim3

    X1, X2, ok, _, _ = jatlas._cross_map_pairs(mc, ma, kc, ka)
    return jsim3.solve_sim3(X1, X2, ok, jnp.asarray(CAM), jax.random.PRNGKey(7), min_inliers=8,
                            fix_scale=fix_scale)


@pytest.mark.parametrize("kc", [C_PLACE[0], C_PLACE[1], 0])
def test_cross_map_grow_matches_jax(maps, kc):
    """SearchBySim3 across the maps through K1's plain version (P = N,
    radius 10 px * 1.2^level, TH_HIGH, no ratio test) under the Sim(3) the
    JAX package solves on the first pair."""
    ma, _, mc, _ = maps
    ka = A_PLACE[0]
    res = _jax_sim3(mc, ma, C_PLACE[0], ka)
    assert bool(res.ok)
    want = [np.asarray(x) for x in jatlas._cross_map_grow(
        mc, ma, kc, ka, res.s, res.R, res.t, jnp.asarray(CAM), W, H)]
    got = tatlas.search_by_sim3(torch_map(mc), kc, torch_map(ma), ka, T(res.s), T(res.R), T(res.t),
                                T(CAM), W, H, tatlas.MERGE_RADIUS, "merge")
    ok = want[2]
    np.testing.assert_array_equal(got[2].numpy(), ok)
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    np.testing.assert_array_equal(got[4].numpy()[ok], want[4][ok])
    for i in (0, 1, 5, 6):
        np.testing.assert_allclose(got[i].numpy()[ok], want[i][ok], atol=1e-5)
    assert (int(ok.sum()) > 150) == (kc == C_PLACE[0])


# ---------------------------------------------------------------------------
# the weld


def _jax_samples(ok, n_hyp):
    logits = jnp.where(jnp.asarray(ok), 0.0, -jnp.inf)
    return np.asarray(jax.random.categorical(jax.random.PRNGKey(7), logits[None, :], shape=(n_hyp, 3)))


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's RANSAC draws replaced by the JAX package's (key 7, as the
    tests hand ``merge_current_into``): ``solve_sim3_from_samples``."""
    def solve(X1, X2, ok, cam, gen, **kw):
        samples = T(_jax_samples(ok.numpy(), tsim3.N_HYP))
        return tsim3.solve_sim3_from_samples(X1, X2, ok, cam, samples, **kw)

    monkeypatch.setattr(tsim3, "solve_sim3", solve)


def _systems(ma, na, mc, nc, inertial=False, loop_closing=False):
    """A JAX and a port system holding the current map as active and the
    archived one in their Atlas (signatures from the default vocabulary)."""
    kw = dict(enable_atlas=True, enable_loop_closing=loop_closing, **SLAM_KW)
    if inertial:
        js = JaxVI(calib=make_calib(), **kw)
        ts = InertialSlam(calib=torch_calib(make_calib()), device="cpu", **kw)
    else:
        js = jsys.MonoSlam(pipelined=False, **kw)
        ts = tsys.MonoSlam(device="cpu", pipelined=False, **kw)
    js.map, js.n_kf, js.n_pts, js.state = ma, N_KF_A, na, jsys.OK
    ts.map, ts.n_kf, ts.n_pts, ts.state = torch_map(ma), N_KF_A, na, tsys.OK
    if inertial:
        S = js.imu_cap_kf
        for s in (js, ts):
            r = np.random.default_rng(4)
            s.kf_imu_acc[:N_KF_A] = r.normal(size=(N_KF_A, S, 3))
            s.kf_imu_gyro[:N_KF_A] = r.normal(size=(N_KF_A, S, 3))
            s.kf_imu_dts[:N_KF_A] = 0.005
            s.imu_initialized, s.imu_stage, s.chain_breaks = True, 3, {5}
    assert js.atlas.archive_current(js) and ts.atlas.archive_current(ts)
    js.map, js.n_kf, js.n_pts, js.state = mc, N_KF_C, nc, jsys.OK
    ts.map, ts.n_kf, ts.n_pts, ts.state = torch_map(mc), N_KF_C, nc, tsys.OK
    R0, t0 = np.asarray(mc.kf_R[N_KF_C - 1]), np.asarray(mc.kf_t[N_KF_C - 1])
    for s in (js, ts):
        s.R_cur, s.t_cur = R0.copy(), (t0 + 0.05).astype(np.float32)
    if inertial:
        S = js.imu_cap_kf
        for s in (js, ts):
            r = np.random.default_rng(5)
            s.kf_imu_acc[:N_KF_C] = r.normal(size=(N_KF_C, S, 3))
            s.kf_imu_gyro[:N_KF_C] = r.normal(size=(N_KF_C, S, 3))
            s.kf_imu_dts[:N_KF_C] = 0.007
            s.imu_initialized, s.imu_stage, s.chain_breaks = True, 3, {3}
            s.v_cur = np.asarray([0.3, -0.2, 0.1], np.float32)
    return js, ts


def _record_vi_ba(monkeypatch, slam, calls):
    monkeypatch.setattr(slam, "_run_vi_ba", lambda window, n_iters: calls.append((window, n_iters)))


def test_merge_mono_sim3_weld_matches_jax(maps, jax_draws):
    """A monocular weld (Sim(3), the drift's scale undone): the merged map,
    counters, current pose and the spent Atlas are the JAX package's; one
    cross-map SearchBySim3 was made."""
    ma, na, mc, nc = maps
    js, ts = _systems(ma, na, mc, nc)
    assert js.atlas.merge_current_into(js, 0, jax.random.PRNGKey(7))
    assert ts.atlas.merge_current_into(ts, 0)
    assert (ts.n_kf, ts.n_pts) == (js.n_kf, js.n_pts) == (N_KF_A + N_KF_C, na + nc)
    assert not ts.atlas.maps and not js.atlas.maps and ts.atlas.grow_searches == 1
    skip = ("pt_normal", "pt_min_dist", "pt_max_dist")
    jm = js.map._replace(**{f: getattr(ts.map, f).numpy() for f in skip})
    _check_map(ts.map, jm, atol=5e-4)
    np.testing.assert_allclose(ts.R_cur, np.asarray(js.R_cur), atol=ATOL)
    np.testing.assert_allclose(ts.t_cur, np.asarray(js.t_cur), atol=5e-4)
    # the welded place lands on the archived one: the drift undone
    np.testing.assert_allclose(ts.map.pt_X.numpy()[na : na + N_PLACE], np.asarray(ma.pt_X)[:N_PLACE],
                               atol=2e-3)


def test_merge_metric_rigid_weld_matches_jax(metric_maps, jax_draws, monkeypatch):
    """Both maps IMU-initialized: the weld is rigid (scale fixed), the IMU
    blocks re-indexed, the seam and the shifted breaks are chain breaks,
    the velocity rotates with the world, and the welding VI-BA is called
    over the window with 6 iterations (its solve is held against the JAX
    package in tests/test_torch_vi_mapping.py)."""
    ma, na, mc, nc = metric_maps
    js, ts = _systems(ma, na, mc, nc, inertial=True)
    jcalls, tcalls = [], []
    _record_vi_ba(monkeypatch, js, jcalls)
    _record_vi_ba(monkeypatch, ts, tcalls)
    assert js.atlas.merge_current_into(js, 0, jax.random.PRNGKey(7))
    assert ts.atlas.merge_current_into(ts, 0)
    assert tcalls == jcalls == [(ts.W, 6)]
    skip = ("pt_normal", "pt_min_dist", "pt_max_dist")
    jm = js.map._replace(**{f: getattr(ts.map, f).numpy() for f in skip})
    _check_map(ts.map, jm, atol=5e-4)
    assert ts.chain_breaks == js.chain_breaks == {5, N_KF_A, N_KF_A + 3}
    assert ts.imu_initialized and js.imu_initialized
    for f in ("kf_imu_acc", "kf_imu_gyro", "kf_imu_dts"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f), err_msg=f)
    np.testing.assert_allclose(ts.v_cur, np.asarray(js.v_cur), atol=ATOL)
    np.testing.assert_allclose(ts.t_cur, np.asarray(js.t_cur), atol=5e-4)
    # rigid: keyframe-to-point distances unchanged by the weld
    k = N_KF_A + C_PLACE[0]
    d0 = np.linalg.norm(np.asarray(mc.pt_X)[:N_PLACE] @ np.asarray(mc.kf_R[C_PLACE[0]]).T
                        + np.asarray(mc.kf_t[C_PLACE[0]]), axis=1)
    d1 = np.linalg.norm(ts.map.pt_X.numpy()[na : na + N_PLACE] @ ts.map.kf_R[k].numpy().T
                        + ts.map.kf_t[k].numpy(), axis=1)
    np.testing.assert_allclose(d1, d0, atol=1e-4)


def test_vi_chunk_boundary_weld_matches_jax(metric_maps, monkeypatch):
    """``InertialSlam._close_at_boundary`` after a chunk whose new keyframe
    takes slot 4 (a multiple of 4): the rigid weld, then the chunk's
    inertial state dropped (device state, anchor, prior) and the tracker
    snapped to the newest keyframe's pose, velocity and biases, as the JAX
    package's ``_drain_vi_chunk`` does (inertial_system.py:815-850; driven
    here with a chunk result built on the host). The RANSAC draws are the
    JAX package's from the key its drain hands the Atlas."""
    from orb_slam3_ros_tpu.models import vi_device_loop as jvdl

    ma, na, mc, nc = metric_maps
    rng = np.random.default_rng(6)
    bias = rng.normal(size=(2, K, 3)).astype(np.float32) * 0.01
    mc = mc._replace(kf_bg=jnp.asarray(bias[0]), kf_ba=jnp.asarray(bias[1]))
    js, ts = _systems(ma, na, mc, nc, inertial=True)
    jcalls, tcalls = [], []
    _record_vi_ba(monkeypatch, js, jcalls)
    _record_vi_ba(monkeypatch, ts, tcalls)
    _, sub = jax.random.split(js.key)

    def solve(X1, X2, ok, cam, gen, **kw):
        logits = jnp.where(jnp.asarray(ok.numpy()), 0.0, -jnp.inf)
        samples = jax.random.categorical(sub, logits[None, :], shape=(tsim3.N_HYP, 3))
        return tsim3.solve_sim3_from_samples(X1, X2, ok, cam, T(np.asarray(samples)), **kw)

    monkeypatch.setattr(tsim3, "solve_sim3", solve)
    # the chunk: 3 frames, the second a keyframe in slot 4 = N_KF_C - 1
    C, S, new_kf = 3, js.imu_cap_kf, N_KF_C - 1
    bg0, ba0 = np.full(3, 0.002, np.float32), np.full(3, -0.01, np.float32)
    outs = dict(
        alive=np.ones(C, bool), R=np.tile(js.R_cur, (C, 1, 1)), t=np.tile(js.t_cur, (C, 1)),
        R_cr=np.tile(np.eye(3, dtype=np.float32), (C, 1, 1)), t_cr=np.zeros((C, 3), np.float32),
        ref=np.asarray([new_kf - 1, new_kf, new_kf]), is_kf=np.asarray([False, True, False]),
        n_inliers=np.full(C, 100),
    )
    sc = dict(R=js.R_cur, t=js.t_cur, v=js.v_cur, bg=bg0, ba=ba0, n_kf=N_KF_C, n_pts=nc,
              last_kf_fid=20, alive=True, ref_inl=100)
    blk = np.concatenate([js.kf_imu_acc[new_kf], js.kf_imu_gyro[new_kf], js.kf_imu_dts[new_kf][:, None]],
                         -1)
    new_blk = np.stack([blk, np.zeros_like(blk)])
    monkeypatch.setattr(jvdl, "unpack_vi_chunk_result",
                        lambda *a: (outs, sc, new_blk, np.asarray([True, True])))
    js._vi_chunk_pending = dict(tss=np.arange(C, dtype=np.float64) + 10.0, n_kf0=new_kf,
                                fut=type("F", (), {"result": lambda self: None})(), fid0=18)
    js._drain_vi_chunk()
    ts.bg_cur, ts.ba_cur = bg0.copy(), ba0.copy()
    ts._vi_anchor, ts._vi_prior, ts._vi_dev_valid = object(), object(), True
    assert not ts._close_at_boundary([new_kf])
    assert tcalls == jcalls == [(ts.W, 6)]
    assert not ts.atlas.maps and not js.atlas.maps and ts.n_kf == js.n_kf == N_KF_A + N_KF_C
    assert ts.chain_breaks == js.chain_breaks == {5, N_KF_A, N_KF_A + 3}
    skip = ("pt_normal", "pt_min_dist", "pt_max_dist")
    jm = js.map._replace(**{f: getattr(ts.map, f).numpy() for f in skip})
    _check_map(ts.map, jm, atol=5e-4)
    # snapped to the newest keyframe of the welded map
    last = N_KF_A + N_KF_C - 1
    np.testing.assert_allclose(ts.R_cur, ts.map.kf_R[last].numpy(), atol=1e-6)
    for f in ("R_cur", "t_cur", "v_cur", "bg_cur", "ba_cur", "vel_R", "vel_t"):
        np.testing.assert_allclose(getattr(ts, f), np.asarray(getattr(js, f)), atol=5e-4, err_msg=f)
    np.testing.assert_allclose(ts.bg_cur, bias[0][new_kf], atol=1e-7)
    assert js._vi_dev_state is None and not ts._vi_dev_valid
    assert js._vi_anchor is None and ts._vi_anchor is None
    assert js._vi_prior is None and ts._vi_prior is None


def test_merge_without_overlap_fails_as_jax(maps):
    """An archived map the active one never saw: no pair clears the score
    or the RANSAC, nothing changes in either package."""
    ma, na, mc, nc = maps
    js, ts = _systems(ma, na, mc, nc)
    blank = np.asarray(mc.kf_feat_valid).copy()
    blank[list(C_PLACE)] = False
    js.map = js.map._replace(kf_feat_valid=jnp.asarray(blank))
    ts.map = ts.map._replace(kf_feat_valid=T(blank))
    assert not js.atlas.merge_current_into(js, 0, jax.random.PRNGKey(7))
    assert not ts.atlas.merge_current_into(ts, 0)
    assert len(ts.atlas.maps) == len(js.atlas.maps) == 1 and ts.n_kf == N_KF_C


# ---------------------------------------------------------------------------
# archive, switch, lost frames, timestamp jump


@pytest.mark.parametrize("inertial", [False, True])
@pytest.mark.parametrize("n_kf", [N_KF_A, N_KF_A - 1])
def test_archive_current_matches_jax(maps, inertial, n_kf):
    """At min_kf_keep keyframes the map is archived (its tables, counters,
    signatures and IMU side-state), below it discarded; either way the
    system restarts on an empty map, IMU reset."""
    ma, na, _, _ = maps
    kw = dict(enable_atlas=True, **SLAM_KW)
    if inertial:
        js, ts = JaxVI(calib=make_calib(), **kw), InertialSlam(calib=torch_calib(make_calib()),
                                                               device="cpu", **kw)
    else:
        js, ts = jsys.MonoSlam(pipelined=False, **kw), tsys.MonoSlam(device="cpu", pipelined=False, **kw)
    js.map, js.n_kf, js.n_pts, js.state = ma, n_kf, na, jsys.OK
    ts.map, ts.n_kf, ts.n_pts, ts.state = torch_map(ma), n_kf, na, tsys.OK
    if inertial:
        for s in (js, ts):
            s.kf_imu_dts[:n_kf] = 0.01
            s.imu_initialized, s.imu_stage, s.chain_breaks = True, 2, {4}
            s.v_cur = np.ones(3, np.float32)
    keep = n_kf >= 8
    assert js.atlas.archive_current(js) == ts.atlas.archive_current(ts) == keep
    assert len(ts.atlas.maps) == len(js.atlas.maps) == int(keep)
    assert ts.state == js.state == tsys.NOT_INITIALIZED and ts.n_kf == js.n_kf == 0
    assert not ts.map.kf_valid.any() and ts.R_cur.tolist() == np.eye(3).tolist()
    if inertial:
        assert not ts.imu_initialized and ts.chain_breaks == set() and not ts.kf_imu_dts.any()
        assert not ts.v_cur.any() and not ts._vi_dev_valid
    if keep:
        ja, ta = js.atlas.maps[0], ts.atlas.maps[0]
        assert (ta.n_kf, ta.n_pts) == (ja.n_kf, ja.n_pts)
        _check_map(ta.m, ja.m, atol=0)
        np.testing.assert_allclose(ta.sigs.numpy(), np.asarray(ja.sigs), atol=1e-5)
        if inertial:
            assert ta.imu["chain_breaks"] == ja.imu["chain_breaks"] == {4}
            assert (ta.imu["initialized"], ta.imu["stage"]) == (ja.imu["initialized"], ja.imu["stage"])
            np.testing.assert_array_equal(ta.imu["dts"], ja.imu["dts"])
        else:
            assert ta.imu is ja.imu is None


def _query(m, kf, rng=None):
    """Keyframe ``kf``'s features as a frame's (JAX Features), or random
    descriptors with ``rng``."""
    desc = np.asarray(m.kf_desc_sign[kf])
    if rng is not None:
        desc = rng.choice(np.array([-1, 1], np.int8), desc.shape)
    return jorb.Features(
        xy=m.kf_xy[kf], level=m.kf_level[kf], angle=m.kf_angle[kf],
        response=jnp.zeros((N,), jnp.float32), desc_packed=jnp.zeros((N, 8), jnp.uint32),
        desc_sign=jnp.asarray(desc), valid=m.kf_feat_valid[kf],
    )


def _lost_systems(ma, na, mc, nc, active_kf):
    js, ts = _systems(ma, na, mc, nc)
    for s in (js, ts):
        s.n_kf, s.state = active_kf, tsys.LOST
    return js, ts


@pytest.mark.parametrize("seen", [True, False])
def test_try_relocalize_in_archived_matches_jax(maps, seen):
    """A frame that sees the archived place switches into the archived map
    at the pose the JAX package tracks; one that sees nothing switches in
    neither."""
    ma, na, mc, nc = maps
    js, ts = _lost_systems(ma, na, mc, nc, active_kf=N_KF_C)
    q = _query(ma, A_PLACE[1], None if seen else np.random.default_rng(9))
    assert js.atlas.try_relocalize_in_archived(js, q) == seen
    assert ts.atlas.try_relocalize_in_archived(ts, torch_features(q)) == seen
    if seen:
        assert ts.state == js.state == tsys.OK and not ts.atlas.maps and not js.atlas.maps
        assert (ts.n_kf, ts.n_pts) == (js.n_kf, js.n_pts) == (N_KF_A, na)
        np.testing.assert_allclose(ts.R_cur, np.asarray(js.R_cur), atol=ATOL)
        np.testing.assert_allclose(ts.t_cur, np.asarray(js.t_cur), atol=ATOL)
        np.testing.assert_allclose(ts.t_cur, np.asarray(ma.kf_t[A_PLACE[1]]), atol=1e-3)
    else:
        assert ts.state == js.state == tsys.LOST and len(ts.atlas.maps) == 1


def test_lost_frames_keep_the_dense_schedule_then_archive_as_jax(maps):
    """Each lost frame that neither relocalizes nor switches counts; while
    it counts, tracking uses the dense schedule; at ``lost_patience`` the
    map (below min_kf_keep here: discarded) gives way to a fresh one."""
    ma, na, mc, nc = maps
    js, ts = _lost_systems(ma, na, mc, nc, active_kf=N_KF_C)
    for s in (js, ts):
        s.lost_patience, s.lean_after_kf = 3, 0
    q = _query(mc, 0, np.random.default_rng(11))
    seen = []
    for i in range(3):
        assert js._try_relocalize(q, 1.0 + i) is None
        assert ts._try_relocalize(torch_features(q), 1.0 + i) is None
        seen.append((js.lost_count, ts.lost_count, js._current_schedule() is js._sched_dense,
                     ts._current_schedule() is ts._sched_dense, js.state, ts.state))
    assert seen == [(1, 1, True, True, 2, 2), (2, 2, True, True, 2, 2), (0, 0, False, False, 0, 0)]
    assert len(ts.atlas.maps) == len(js.atlas.maps) == 1 and ts.n_kf == js.n_kf == 0


@pytest.mark.parametrize("gap", [0.5, 1.5])
def test_timestamp_jump_archives_as_jax(maps, gap):
    """A gap over ``ts_jump_threshold`` archives the map (state
    NOT_INITIALIZED), a shorter one changes nothing."""
    ma, na, _, _ = maps
    kw = dict(enable_atlas=True, **SLAM_KW)
    js, ts = jsys.MonoSlam(pipelined=False, **kw), tsys.MonoSlam(device="cpu", pipelined=False, **kw)
    for s, m in ((js, ma), (ts, torch_map(ma))):
        s.map, s.n_kf, s.n_pts, s.state, s._last_frame_ts = m, N_KF_A, na, tsys.OK, 3.0
        s._check_ts_jump(3.0 + gap)
    jump = gap > 1.0
    assert ts.state == js.state == (tsys.NOT_INITIALIZED if jump else tsys.OK)
    assert len(ts.atlas.maps) == len(js.atlas.maps) == int(jump)


def test_set_and_train_vocabulary_reach_the_atlas_as_jax(maps):
    """``train_vocabulary_from_map`` trains the JAX package's words on the
    map's descriptors and installs them in the Atlas too."""
    ma, na, _, _ = maps
    kw = dict(enable_atlas=True, **SLAM_KW)
    js, ts = jsys.MonoSlam(pipelined=False, **kw), tsys.MonoSlam(device="cpu", pipelined=False, **kw)
    js.map, js.n_kf = ma, N_KF_A
    ts.map, ts.n_kf = torch_map(ma), N_KF_A
    want = js.train_vocabulary_from_map(n_words=64)
    got = ts.train_vocabulary_from_map(n_words=64)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(ts.atlas.vocab.numpy(), np.asarray(js.atlas.vocab))


# ---------------------------------------------------------------------------
# the three faults of the JAX package the port does not copy


def test_switch_archives_a_large_active_map_unlike_jax(maps):
    """A lost map with min_kf_keep keyframes or more: the JAX package's
    switch drops it (atlas.py:116-172); the port archives it first, as
    Tracking.cc:2050-2068 keeps such a map, and can come back to it."""
    ma, na, mc, nc = maps
    js, ts = _lost_systems(ma, na, mc, nc, active_kf=N_KF_C)
    for s in (js, ts):
        s.n_kf = 8  # the active map now counts as worth keeping
    q = _query(ma, A_PLACE[1])
    assert js.atlas.try_relocalize_in_archived(js, q)
    assert ts.atlas.try_relocalize_in_archived(ts, torch_features(q))
    assert js.atlas.maps == []  # the JAX package lost the active map
    assert len(ts.atlas.maps) == 1 and ts.atlas.maps[0].n_kf == 8
    np.testing.assert_array_equal(ts.atlas.maps[0].m.kf_obs.numpy(), np.asarray(mc.kf_obs))
    assert ts.n_kf == js.n_kf == N_KF_A
    np.testing.assert_allclose(ts.t_cur, np.asarray(js.t_cur), atol=ATOL)


def test_weld_carries_point_statistics_unlike_jax(maps, jax_draws):
    """The welded points' viewing normals and scale-invariance band: the
    JAX package leaves what the archived map's free slots held (zero,
    atlas.py:398-455); the port carries them across, rotated and scaled
    with the map as ``apply_scaled_rotation`` moves them."""
    ma, na, mc, nc = maps
    js, ts = _systems(ma, na, mc, nc)
    assert js.atlas.merge_current_into(js, 0, jax.random.PRNGKey(7))
    assert ts.atlas.merge_current_into(ts, 0)
    new = slice(na, na + nc)
    assert not np.asarray(js.map.pt_normal)[new].any() and not np.asarray(js.map.pt_max_dist)[new].any()
    # the world-to-world Sim(3) the weld used, recovered from a keyframe
    k = C_PLACE[0]
    R0, R1 = np.asarray(mc.kf_R[k]), ts.map.kf_R[N_KF_A + k].numpy()
    Rw = R1.T @ R0
    sw = float(np.mean(ts.map.pt_max_dist.numpy()[new][:N_PLACE] / np.asarray(mc.pt_max_dist)[:N_PLACE]))
    np.testing.assert_allclose(ts.map.pt_normal.numpy()[new], np.asarray(mc.pt_normal)[:nc] @ Rw.T,
                               atol=1e-4)
    np.testing.assert_allclose(ts.map.pt_min_dist.numpy()[new], sw * np.asarray(mc.pt_min_dist)[:nc],
                               rtol=1e-4)
    np.testing.assert_allclose(sw, 1.0 / 1.08, atol=2e-3)  # the drift's scale, undone
    np.testing.assert_array_equal(ts.map.pt_normal.numpy()[:na], np.asarray(ma.pt_normal)[:na])


def test_loop_edges_follow_their_map_unlike_jax(maps, jax_draws):
    """Loop edges and the pending hypothesis name keyframe slots: the JAX
    package keeps them across an archive, a switch and a weld (atlas.py
    never touches the loop closer); the port drops them with the map at an
    archive and a switch, and shifts them with the welded keyframes."""
    ma, na, mc, nc = maps
    js, ts = _systems(ma, na, mc, nc, loop_closing=True)
    for s in (js, ts):
        s.loop_closer._record_loop_edge(4, 0, np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 1.0)
        s.loop_closer.last_closed_kf = 4
        s.loop_closer._pending = {"cand": 1}
    assert js.atlas.merge_current_into(js, 0, jax.random.PRNGKey(7))
    assert ts.atlas.merge_current_into(ts, 0)
    assert (js.loop_closer._edge_i[0], js.loop_closer._edge_j[0]) == (4, 0)  # archived map's slots now
    assert (ts.loop_closer._edge_i[0], ts.loop_closer._edge_j[0]) == (N_KF_A + 4, N_KF_A)
    assert ts.loop_closer.last_closed_kf == N_KF_A + 4 and ts.loop_closer._pending is None
    assert js.loop_closer._pending is not None
    js.atlas.archive_current(js)
    ts.atlas.archive_current(ts)
    assert js.loop_closer._edge_i[0] == 4  # unchanged: a slot of no map now
    assert (ts.loop_closer._edge_i < 0).all() and ts.loop_closer.last_closed_kf == -100
