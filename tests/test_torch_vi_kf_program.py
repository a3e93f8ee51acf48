"""The VI keyframe program of the per-frame path
(``models/vi_kf_program.py``): ``InertialSlam._insert_keyframe_vi`` through
the program's regions, run eagerly on the CPU, against the eager
``_vi_kf_work`` call it replaced, made the way ``_insert_keyframe_vi``
made it before (``_window``'s device tensors, the fuse / stats / cull flags
from the system's cadence), on a copy of the same system: the map, the
points admitted and the host state after the keyframe equal bit for bit.
The cases: a young window (the whole map, only keyframe 0 fixed), a full
one, one with a chain break, each fuse / stats / cull combination, the
stereo-inertial depth variant (u_r rows, close points from depth) and the
KB8 camera. Then the program against the JAX package's ``_vi_kf_work`` on
the same inputs, at the VI-BA's tolerances (ROADMAP: states within 1e-4).

The maps are made with numpy from a seed: ``tests/vi_sim.py``'s smooth
body trajectory (its IMU samples the keyframe blocks), points drawn in
each keyframe's view and projected into every keyframe with a descriptor
each (a few bits flipped per observation), most of them landmarks bound in
the keyframes, the rest unbound, for the new keyframe to triangulate
against the one before it.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.models import inertial_system as jis
from orb_slam3_ros_tpu_torch.models import inertial_system as tis
from orb_slam3_ros_tpu_torch.models import map_state as tms
from orb_slam3_ros_tpu_torch.models import map_updates as tmu
from orb_slam3_ros_tpu_torch.models import stereo_system as tss
from orb_slam3_ros_tpu_torch.models import vi_kf_program as vkp
from orb_slam3_ros_tpu_torch.ops import cameras as tcam
from orb_slam3_ros_tpu_torch.ops import orb as torb
from orb_slam3_ros_tpu_torch.ops import stereo as tst
from torch_parity import torch_calib
from vi_sim import make_calib

torch.set_num_threads(1)
H, W = 240, 376
N_FEATURES = 100  # 128 feature slots
K_CAP, P_CAP, S = 16, 1024, 64
SAMPLES, DT = 40, 0.005  # IMU samples a keyframe and their spacing
N_KF, PTS_PER_KF = 10, 80  # the scene's keyframes 0..N_KF, points drawn in each one's view
PIN = np.asarray([300, 300, 188, 120, 0, 0, 0, 0, 0], np.float32)
KB8 = np.asarray([150.0, 150.0, 187.5, 119.5, 0.02, 0.001, -0.002, 0.0002], np.float32)
BASELINE = 0.12
SYS_KW = dict(height=H, width=W, n_features=N_FEATURES, max_keyframes=K_CAP, max_points=P_CAP,
              imu_cap_kf=S, device="cpu")


def _so3_exp(w):
    th = np.linalg.norm(w)
    K = np.asarray([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + K
    return np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th**2 * K @ K


def _trajectory(rng, n_kf: int):
    """``vi_sim.simulate_vi``'s smooth body trajectory and its IMU samples,
    integrated with numpy: keyframe states at every ``SAMPLES``-th sample,
    the blocks between them."""
    g = np.asarray([0.0, 0.0, -9.81])
    bg = np.asarray([0.01, -0.02, 0.005])
    omega_base = rng.normal(size=3) * 0.3
    R, p, v = np.eye(3), np.zeros(3), rng.normal(size=3) * 0.5
    Rs, ps, vs, accs, gyros = [R], [p], [v], [], []
    for i in range(n_kf * SAMPLES):
        t = i * DT
        a_w = 0.5 * np.asarray([np.sin(2.2 * t), -np.cos(1.7 * t), np.sin(1.3 * t + 0.4)])
        omega = omega_base + 0.2 * np.asarray([np.sin(0.9 * t), np.cos(1.1 * t), np.sin(0.6 * t)])
        accs.append(R.T @ (a_w - g) + rng.normal(size=3) * 1e-3)
        gyros.append(omega + bg + rng.normal(size=3) * 1e-4)
        p = p + v * DT + 0.5 * a_w * DT * DT
        v = v + a_w * DT
        R = R @ _so3_exp(omega * DT)
        Rs.append(R), ps.append(p), vs.append(v)
    k = np.arange(0, n_kf * SAMPLES + 1, SAMPLES)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(R_wb=f32(Rs)[k], p_wb=f32(ps)[k], v_w=f32(vs)[k], bg=f32(bg),
                acc=f32(accs).reshape(n_kf, SAMPLES, 3), gyro=f32(gyros).reshape(n_kf, SAMPLES, 3),
                dts=np.full((n_kf, SAMPLES), DT, np.float32))


_SCENES = {}


def _scene(cam, cam_model: str):
    """Keyframes 0..N_KF: their poses, IMU blocks and velocities from the
    trajectory, ``PTS_PER_KF`` world points drawn in each keyframe's view,
    and each keyframe's features (the projections of the points it sees,
    a descriptor a point with 6 bits flipped an observation) as numpy. A
    point is a landmark once a keyframe before the one being inserted
    drew it, but for every fourth, which stays for triangulation. Made
    once a camera; a case at keyframe k takes keyframes 0..k."""
    if cam_model in _SCENES:
        return _SCENES[cam_model]
    rng = np.random.default_rng(0)
    sim = _trajectory(rng, N_KF)
    R_cw = np.transpose(sim["R_wb"], (0, 2, 1))  # R_bc = I, t_bc = 0
    t_cw = -np.einsum("kij,kj->ki", R_cw, sim["p_wb"])
    # points in each keyframe's view: pixels inside a margin, depth 1.5-4 m
    X, owner = [], []
    for k in range(N_KF + 1):
        uv = rng.uniform([30, 30], [W - 30, H - 30], (PTS_PER_KF, 2))
        ray = tcam.unproject_model(torch.as_tensor(cam), torch.as_tensor(uv, dtype=torch.float32),
                                   cam_model).numpy()
        Xc = ray / ray[:, 2:3] * rng.uniform(1.5, 4.0, (PTS_PER_KF, 1))
        X.append((Xc - t_cw[k]) @ R_cw[k])
        owner.append(np.full(PTS_PER_KF, k))
    X, owner = np.concatenate(X).astype(np.float32), np.concatenate(owner)
    desc = rng.choice(np.asarray([-1, 1], np.int8), size=(len(X), 256))
    level = rng.choice(3, size=len(X), p=[0.6, 0.3, 0.1]).astype(np.int32)
    N = torb.default_config(H, W, n_features=N_FEATURES).total_cap
    kfs = []
    for k in range(N_KF + 1):
        Xc = X @ R_cw[k].T + t_cw[k]
        uv = tcam.project_model(torch.as_tensor(cam), torch.as_tensor(Xc), cam_model).numpy()
        vis = np.flatnonzero((Xc[:, 2] > 0.5) & (uv[:, 0] > 8) & (uv[:, 0] < W - 8)
                             & (uv[:, 1] > 8) & (uv[:, 1] < H - 8))
        # this keyframe's own points first, then others it sees
        own = vis[owner[vis] == k]
        rest = rng.permutation(vis[owner[vis] != k])
        pts = np.sort(np.concatenate([own, rest])[: N - 8])
        n = len(pts)
        d = desc[pts].copy()
        flip = rng.integers(0, 256, (n, 6))
        np.put_along_axis(d, flip, -np.take_along_axis(d, flip, 1), 1)
        f = dict(xy=np.zeros((N, 2), np.float32), level=np.zeros(N, np.int32),
                 angle=np.zeros(N, np.float32), desc_sign=np.zeros((N, 256), np.int8),
                 valid=np.zeros(N, bool), pts=np.full(N, -1, np.int64), z=np.zeros(N, np.float32))
        f["xy"][:n] = uv[pts] + rng.normal(0, 0.3, (n, 2))
        f["level"][:n], f["desc_sign"][:n], f["valid"][:n] = level[pts], d, True
        f["pts"][:n], f["z"][:n] = pts, Xc[pts, 2]
        kfs.append(f)
    _SCENES[cam_model] = sim, R_cw, t_cw, X, owner, kfs
    return _SCENES[cam_model]


def _system(case: dict):
    """A system at keyframe ``case["kf"]``'s insertion (its map holds
    keyframes 0..kf-1, its host state the new keyframe's tracked pose),
    and the new keyframe's features and landmark bindings."""
    kf, cam_model = case["kf"], case.get("cam_model", "pinhole")
    cam = KB8 if cam_model == "kb8" else PIN
    sim, R_cw, t_cw, X, owner, kfs = _scene(cam, cam_model)
    kw = dict(SYS_KW, cam_params=cam, calib=torch_calib(make_calib(freq=1 / DT)),
              ba_window=case.get("ba_window", 4), ba_fixed=2, cam_model=cam_model,
              fuse_every=case.get("fuse_every", 1), stats_every=case.get("stats_every", 1),
              kf_culling=case.get("cull", True))
    slam = (tss.StereoInertialSlam(baseline=BASELINE, **kw) if case.get("stereo")
            else tis.InertialSlam(**kw))
    # the landmarks: the points keyframes 0..kf-1 drew, but every fourth
    land = np.flatnonzero((owner < kf) & (np.arange(len(X)) % 4 != 0))
    slot = np.full(len(X), -1, np.int32)
    slot[land] = np.arange(len(land))
    rng = np.random.default_rng(1)
    m = tms.to_numpy(tms.empty_map(K_CAP, slam.N, P_CAP, device="cpu"))
    bf = float(cam[0]) * BASELINE
    for k in range(kf):
        f = kfs[k]
        m["kf_valid"][k] = True
        m["kf_R"][k] = R_cw[k] @ _small_rotation(rng, 2e-3)
        m["kf_t"][k] = t_cw[k] + rng.normal(0, 3e-3, 3)
        m["kf_xy"][k], m["kf_level"][k], m["kf_angle"][k] = f["xy"], f["level"], f["angle"]
        m["kf_desc_sign"][k], m["kf_feat_valid"][k] = f["desc_sign"], f["valid"]
        m["kf_obs"][k] = np.where(f["valid"], slot[f["pts"]], -1)
        m["kf_ts"][k] = k * SAMPLES * DT
        m["kf_ur"][k] = np.where(f["valid"] & bool(case.get("stereo")),
                                 f["xy"][:, 0] - bf / np.maximum(f["z"], 1e-3), -1.0)
        m["kf_v"][k] = sim["v_w"][k] + rng.normal(0, 1e-2, 3)
        m["kf_bg"][k], m["kf_ba"][k] = sim["bg"] + rng.normal(0, 1e-3, 3), rng.normal(0, 1e-2, 3)
    n = len(land)
    m["pt_valid"][:n] = True
    m["pt_X"][:n] = X[land] + rng.normal(0, 5e-3, (n, 3))
    m["pt_first_kf"][:n] = owner[land]
    m["pt_found"][:n], m["pt_visible"][:n] = 4, 5
    slam.map = tmu.refresh_point_stats(tms.from_numpy(m, "cpu"), n_levels=slam.config.n_levels)
    slam.n_kf, slam.n_pts, slam.frame_id = kf, n, 10 * kf
    slam.imu_initialized, slam.imu_stage = True, 3
    for k in range(1, kf + 1):
        slam.kf_imu_acc[k, :SAMPLES] = sim["acc"][k - 1]
        slam.kf_imu_gyro[k, :SAMPLES] = sim["gyro"][k - 1]
        slam.kf_imu_dts[k, :SAMPLES] = sim["dts"][k - 1]
    slam.chain_breaks = set(case.get("breaks", ()))
    slam.R_cur = (R_cw[kf] @ _small_rotation(rng, 2e-3)).astype(np.float32)
    slam.t_cur = (t_cw[kf] + rng.normal(0, 3e-3, 3)).astype(np.float32)
    slam.v_cur = (sim["v_w"][kf] + rng.normal(0, 1e-2, 3)).astype(np.float32)
    slam.bg_cur = sim["bg"].astype(np.float32)
    slam.ba_cur = np.zeros(3, np.float32)
    f = kfs[kf]
    feats = torb.Features(
        xy=torch.as_tensor(f["xy"]), level=torch.as_tensor(f["level"]),
        angle=torch.as_tensor(f["angle"]), response=torch.zeros(len(f["valid"])),
        desc_packed=torch.zeros((len(f["valid"]), 8), dtype=torch.int32),
        desc_sign=torch.as_tensor(f["desc_sign"]), valid=torch.as_tensor(f["valid"]))
    if case.get("stereo"):
        close = f["valid"] & (f["z"] < slam.max_depth) & (np.arange(len(f["z"])) % 3 > 0)
        ur = f["xy"][:, 0] - slam.bf / np.maximum(f["z"], 1e-3)
        slam._last_depth = tst.StereoMatch(u_right=torch.as_tensor(np.where(close, ur, -1.0)),
                                           depth=torch.as_tensor(np.where(close, f["z"], -1.0)),
                                           valid=torch.as_tensor(close))
    feat_pt = np.where(f["valid"], slot[f["pts"]], -1).astype(np.int32)
    return slam, feats, torch.as_tensor(feat_pt), kf * SAMPLES * DT


def _small_rotation(rng, sigma):
    w = rng.normal(0, sigma, 3)
    K = np.asarray([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    return (np.eye(3) + K + K @ K / 2).astype(np.float32)


def _eager_insert(slam, feats, feat_pt, ts, kf_id):
    """The VI keyframe as ``_insert_keyframe_vi`` ran it before the program:
    ``_window``'s device tensors and one eager ``_vi_kf_work``, then the
    host read and the host state. Returns the packed [22]."""
    last = kf_id + 1
    lo = max(0, last - slam.W)
    if last <= slam.W:
        fixed = [i == 0 for i in range(lo, last)]
    else:
        fixed = [i == 0 or i < last - slam.ba_window for i in range(lo, last)]
    window_ids, fixed_d, blocks, edge_ok = slam._window(lo, last, fixed, slam.W)
    vb = torch.from_numpy(np.concatenate([slam.v_cur, slam.bg_cur, slam.ba_cur]).astype(np.float32))
    sm = getattr(slam, "_last_depth", None)
    depth_kw = {}
    if sm is not None and slam.bf > 0:
        depth_kw = dict(ur=torch.where(sm.valid, sm.u_right, -1.0),
                        depth=torch.where(sm.valid, sm.depth, -1.0), max_depth=slam.max_depth)
    slam.map, n_new = tis._vi_kf_work(
        slam.map, kf_id, torch.as_tensor(slam.R_cur), torch.as_tensor(slam.t_cur), ts, feats,
        feat_pt, slam.n_pts, slam.P_cap - slam.n_pts, vb, window_ids, fixed_d, blocks, edge_ok,
        slam.calib, slam.cam_params, width=slam.width, height=slam.height,
        fuse_neighbors=slam.fuse_neighbors,
        do_fuse=slam.fuse_neighbors > 0 and kf_id >= 2 and kf_id % slam.fuse_every == 0,
        do_stats=kf_id % slam.stats_every == 0,
        do_cull=slam.kf_culling and kf_id >= 4 and kf_id % slam.cull_every == 0,
        n_iters=slam.local_ba_iters, n_levels=slam.config.n_levels, bf=slam.bf,
        cam_model=slam.cam_model, **depth_kw,
    )
    buf = torch.cat([n_new.to(torch.float32).reshape(1), tis._pack_kf_state(slam.map, kf_id)])
    slam.n_kf += 1
    slam.n_pts += int(buf[0])
    slam._take_kf_state(kf_id, buf[1:].numpy())
    return buf.numpy()


class _Track:
    def __init__(self, feat_pt):
        self.feat_pt = feat_pt


def _both(case: dict):
    """(the system after the program's keyframe, after the eager one, the
    program's packed read, the eager one's, the program)."""
    slam, feats, feat_pt, ts = _system(case)
    ref = copy.deepcopy(slam)
    reads = []
    slam._insert_keyframe_vi(feats, ts, _Track(feat_pt), case["kf"])
    prog = slam._vi_kf_prog
    reads.append(prog.buf["packed"].numpy().copy())
    reads.append(_eager_insert(ref, feats, feat_pt, ts, case["kf"]))
    return slam, ref, reads[0], reads[1], prog


CASES = {
    "young_window": dict(kf=4, ba_window=6),  # 5 keyframes in a window of 8
    "full_window": dict(kf=10),
    "chain_break": dict(kf=10, breaks=(8,)),
    **{f"fuse{a}_stats{b}_cull{c}": dict(kf=8, fuse_every=1 if a else 1000,
                                         stats_every=1 if b else 1000, cull=bool(c))
       for a in (0, 1) for b in (0, 1) for c in (0, 1)},
    "stereo_depth": dict(kf=10, stereo=True),
    "kb8": dict(kf=10, cam_model="kb8"),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    c = CASES[request.param]
    return (request.param, c) + _both(c)


# The program's regions, eagerly on the CPU, against the eager call they
# replaced: every map field, the packed read and the host state equal bit
# for bit; the regions the keyframe's id calls for, each run once.
def test_program_equals_the_eager_keyframe(case):
    name, c, slam, ref, got, want, prog = case
    np.testing.assert_array_equal(got, want)
    for f in tms.MapState._fields:
        assert torch.equal(getattr(slam.map, f), getattr(ref.map, f)), f
    for a in ("n_kf", "n_pts"):
        assert getattr(slam, a) == getattr(ref, a), a
    for a in ("R_cur", "t_cur", "v_cur", "bg_cur", "ba_cur"):
        np.testing.assert_array_equal(getattr(slam, a), getattr(ref, a), err_msg=a)
    segs = tuple(vkp.kf_segments(prog.cfg, c["kf"]))
    assert dict(prog.runs) == {s: 1 for s in segs}
    assert prog.cfg.stereo == bool(c.get("stereo"))


# The cases exercise what their names say: points admitted (from depth too
# in the depth variant), the branches the cadence calls for, the window's
# shape, and the map taken over by the program's buffers.
def test_cases_exercise_their_paths(case):
    name, c, slam, ref, got, want, prog = case
    assert got[0] > 0
    segs = vkp.kf_segments(prog.cfg, c["kf"])
    if name.startswith("fuse"):
        assert ("kf_fuse" in segs, "kf_stats" in segs, "kf_cull" in segs) == (
            c["fuse_every"] == 1, c["stats_every"] == 1, c["cull"])
    x = prog.buf["x"].numpy()
    ids = x[24 : 24 + slam.W].astype(int)
    if name == "young_window":
        assert c["kf"] + 1 <= slam.W and list(ids[: c["kf"] + 1]) == list(range(c["kf"] + 1))
        assert np.all(ids[c["kf"] + 1 :] == K_CAP - 1)
    edge_ok = x[24 + 2 * slam.W :] > 0.5
    if name == "chain_break":
        assert not edge_ok[list(ids[1:]).index(8)] and edge_ok.sum() == slam.W - 2
    assert all(getattr(slam.map, f) is prog.buf[f] for f in tms.MapState._fields)


def test_depth_variant_admits_close_points_from_depth():
    c = CASES["stereo_depth"]
    _, _, slam, ref, got, want, prog = (None, c) + _both(c)
    kf = c["kf"]
    new = np.flatnonzero(slam.map.pt_first_kf.numpy() == kf)
    assert len(new) == int(got[0])
    # the keyframe's u_r row is the depth match's
    ur = slam.map.kf_ur[kf].numpy()
    assert (ur > 0).sum() > 20 and np.all(ur[~slam._last_depth.valid.numpy()] == -1)


# ---- against the JAX package ----
@pytest.fixture(scope="module")
def jax_case():
    """The full-window case through the JAX package's ``_vi_kf_work`` with
    every branch on, from the same map and inputs."""
    c = CASES["full_window"]
    slam, feats, feat_pt, ts = _system(c)
    m0 = {f: v.numpy().copy() for f, v in zip(tms.MapState._fields, slam.map)}
    slam._insert_keyframe_vi(feats, ts, _Track(feat_pt), c["kf"])
    prog = slam._vi_kf_prog
    x = prog.buf["x"].numpy()
    Wn = slam.W
    from orb_slam3_ros_tpu.models import map_state as jms
    from orb_slam3_ros_tpu.ops import orb as jorb

    jm = jms.MapState(**{f: jnp.asarray(v) for f, v in m0.items()})
    jf = jorb.Features(**{f: jnp.asarray(getattr(feats, f).numpy()) for f in jorb.Features._fields})
    small = np.concatenate([x[24 : 24 + Wn], x[24 + Wn :]]).astype(np.float32)
    jm2, packed = jis._vi_kf_work(
        jm, jnp.asarray(c["kf"], jnp.int32), jnp.asarray(x[12:21].reshape(3, 3)),
        jnp.asarray(x[21:24]), jnp.asarray(ts, jnp.float32), jf, jnp.asarray(feat_pt.numpy()),
        jnp.asarray(int(x[2]), jnp.int32), jnp.asarray(P_CAP - int(x[2]), jnp.int32),
        jnp.asarray(x[3:6]), jnp.asarray(x[6:9]), jnp.asarray(x[9:12]),
        jnp.asarray(prog.buf["blocks"].numpy()), jnp.asarray(small), make_calib(freq=1 / DT),
        jnp.asarray(PIN), jnp.asarray(0.0, jnp.float32), W, H, slam.fuse_neighbors, True, True,
        True, slam.local_ba_iters, slam.config.n_levels, "pinhole",
    )
    assert vkp.kf_segments(prog.cfg, c["kf"]) == vkp.REGIONS
    return dict(kf=c["kf"], slam=slam, got=prog.buf["packed"].numpy(), want=np.asarray(packed),
                jm={f: np.asarray(v) for f, v in zip(jm2._fields, jm2)}, m0=m0)


# The same points admitted and the keyframe row inserted the same; the
# window's keyframe poses within 1e-4 (ROADMAP's VI-BA tolerance; measured
# 3.4e-6 rad, 6.2e-5 m); their velocities and biases within 5e-4 (measured
# 1.2e-4, 4e-6 and 1.4e-4: the VI-BA sums its normal equations in another
# order, the JAX body's row_n reduce against index_add_, and 4 LM
# iterations leave the velocity and the accelerometer bias short of
# convergence, where that order shows most); the packed read to the same
# tolerances; landmark positions of the points both keep within 1e-3
# relative (measured 1.2e-4); validity and observations 99% alike
# (measured equal: a culling threshold can fall either side of a float).
def test_program_matches_the_jax_keyframe(jax_case):
    j, kf, m = jax_case["jm"], jax_case["kf"], jax_case["slam"].map
    got, want = jax_case["got"], jax_case["want"]
    assert got[0] == want[0] > 0
    np.testing.assert_allclose(got[1:10], want[1:10], atol=5e-4)  # v, bg, ba
    np.testing.assert_allclose(got[10:], want[10:], atol=1e-4)  # R, t
    for f in ("kf_xy", "kf_level", "kf_desc_sign", "kf_feat_valid", "kf_ts", "kf_ur"):
        np.testing.assert_array_equal(getattr(m, f).numpy()[kf], j[f][kf], err_msg=f)
    lo = kf + 1 - jax_case["slam"].W
    for f, tol in (("kf_R", 1e-4), ("kf_t", 1e-4), ("kf_v", 5e-4), ("kf_bg", 5e-4),
                   ("kf_ba", 5e-4)):
        np.testing.assert_allclose(getattr(m, f).numpy()[lo : kf + 1], j[f][lo : kf + 1],
                                   atol=tol, err_msg=f)
    assert (m.pt_valid.numpy() == j["pt_valid"]).mean() >= 0.99
    assert (m.kf_obs.numpy() == j["kf_obs"]).mean() >= 0.99
    both = m.pt_valid.numpy() & j["pt_valid"]
    Xt, Xj = m.pt_X.numpy()[both], j["pt_X"][both]
    assert (np.linalg.norm(Xt - Xj, axis=1) / np.linalg.norm(Xj, axis=1)).max() <= 1e-3
    np.testing.assert_array_equal(m.kf_valid.numpy(), j["kf_valid"])
