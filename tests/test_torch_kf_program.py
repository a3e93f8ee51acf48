"""The monocular keyframe program of the per-frame path
(``models/kf_program.py``): ``MonoSlam._insert_keyframe`` through the
program's regions, run eagerly on the CPU, against the plain function,
``kf_work.keyframe_work`` with the local BA in its device form, on a deep
copy of the same system: the map, the points admitted, the keyframe's pose,
the BA iterations and the host state after each keyframe equal bit for bit.
Each case runs two keyframes: the first loads a map that is not the
program's buffers, the second the steady state. The cases: each fuse /
stats / cull combination, synchronous and deferred (the pipelined mode's
keyframe, its packed values copied to the host without a wait), and the KB8
camera. Then the gate (the eager path where the JAX package runs its
stages one by one), maps rebound by compaction and by an Atlas archive and
switch, and the program against the JAX package's ``kf_work.keyframe_work``
on the same inputs, at ``test_torch_mapping.py::test_keyframe_work``'s
tolerances.

The maps are made with numpy from a seed: a smooth camera path, points
drawn in each keyframe's view and projected into every keyframe with a
descriptor each (a few bits flipped per observation), most of them
landmarks bound in the keyframes, the rest unbound, for a new keyframe to
triangulate against the one before it.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.models import kf_work as jkf
from orb_slam3_ros_tpu_torch.models import inertial_system as tis
from orb_slam3_ros_tpu_torch.models import kf_program as kfp
from orb_slam3_ros_tpu_torch.models import kf_work as tkf
from orb_slam3_ros_tpu_torch.models import map_state as tms
from orb_slam3_ros_tpu_torch.models import map_updates as tmu
from orb_slam3_ros_tpu_torch.models import system as tsys
from orb_slam3_ros_tpu_torch.ops import cameras as tcam
from orb_slam3_ros_tpu_torch.ops import orb as torb
from test_torch_mapping import assert_map_equal
from torch_parity import torch_calib
from vi_sim import make_calib

torch.set_num_threads(1)
H, W = 240, 376
N_FEATURES = 100  # 128 feature slots
K_CAP, P_CAP = 16, 1024
N_KF, PTS_PER_KF = 10, 80  # the scene's keyframes 0..N_KF, points drawn in each one's view
KF = 7  # a case's first keyframe; its second is KF + 1
DT = 0.2  # seconds between keyframes
BA_WINDOW, BA_FIXED = 4, 2
STEP = 0.25  # metres the camera moves sideways between keyframes
# The map's perturbation (radians and metres, metres) and the tracked pose's.
POSE_NOISE, POINT_NOISE, TRACK_NOISE = 2e-3, 5e-3, 2e-3
PIN = np.asarray([300, 300, 188, 120, 0, 0, 0, 0, 0], np.float32)
KB8 = np.asarray([150.0, 150.0, 187.5, 119.5, 0.02, 0.001, -0.002, 0.0002], np.float32)


def _so3_exp(w):
    th = np.linalg.norm(w)
    K = np.asarray([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + K
    return np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th**2 * K @ K


def _small_rotation(rng, sigma):
    return _so3_exp(rng.normal(0, sigma, 3)).astype(np.float32)


_SCENES = {}


def _scene(cam_model: str):
    """Keyframes 0..N_KF on a smooth path (a slow yaw, ``STEP`` a keyframe
    sideways), ``PTS_PER_KF`` world points drawn in each keyframe's view
    and each keyframe's features (the projections of the points it sees, a
    descriptor a point with 6 bits flipped an observation) as numpy. Made
    once a camera."""
    if cam_model in _SCENES:
        return _SCENES[cam_model]
    cam = KB8 if cam_model == "kb8" else PIN
    rng = np.random.default_rng(0)
    k = np.arange(N_KF + 1)
    R_cw = np.stack([_so3_exp(np.asarray([0.01, 0.03, 0.005]) * i) for i in k]).astype(np.float32)
    centers = np.stack([STEP * k, 0.01 * np.sin(k), 0.02 * k], axis=1)
    t_cw = -np.einsum("kij,kj->ki", R_cw, centers).astype(np.float32)
    X, owner = [], []
    for i in k:
        uv = rng.uniform([30, 30], [W - 30, H - 30], (PTS_PER_KF, 2))
        ray = tcam.unproject_model(torch.as_tensor(cam), torch.as_tensor(uv, dtype=torch.float32),
                                   cam_model).numpy()
        Xc = ray / ray[:, 2:3] * rng.uniform(1.5, 4.0, (PTS_PER_KF, 1))
        X.append((Xc - t_cw[i]) @ R_cw[i])
        owner.append(np.full(PTS_PER_KF, i))
    X, owner = np.concatenate(X).astype(np.float32), np.concatenate(owner)
    desc = rng.choice(np.asarray([-1, 1], np.int8), size=(len(X), 256))
    level = rng.choice(3, size=len(X), p=[0.6, 0.3, 0.1]).astype(np.int32)
    N = torb.default_config(H, W, n_features=N_FEATURES).total_cap
    kfs = []
    for i in k:
        Xc = X @ R_cw[i].T + t_cw[i]
        uv = tcam.project_model(torch.as_tensor(cam), torch.as_tensor(Xc), cam_model).numpy()
        vis = np.flatnonzero((Xc[:, 2] > 0.5) & (uv[:, 0] > 8) & (uv[:, 0] < W - 8)
                             & (uv[:, 1] > 8) & (uv[:, 1] < H - 8))
        own = vis[owner[vis] == i]
        rest = rng.permutation(vis[owner[vis] != i])
        pts = np.sort(np.concatenate([own, rest])[: N - 8])
        n = len(pts)
        d = desc[pts].copy()
        flip = rng.integers(0, 256, (n, 6))
        np.put_along_axis(d, flip, -np.take_along_axis(d, flip, 1), 1)
        f = dict(xy=np.zeros((N, 2), np.float32), level=np.zeros(N, np.int32),
                 angle=np.zeros(N, np.float32), desc_sign=np.zeros((N, 256), np.int8),
                 valid=np.zeros(N, bool), pts=np.full(N, -1, np.int64))
        f["xy"][:n] = uv[pts] + rng.normal(0, 0.3, (n, 2))
        f["level"][:n], f["desc_sign"][:n], f["valid"][:n] = level[pts], d, True
        f["pts"][:n] = pts
        kfs.append(f)
    _SCENES[cam_model] = cam, R_cw, t_cw, X, owner, kfs
    return _SCENES[cam_model]


class _Track:
    """What ``_insert_keyframe`` reads of a tracking result."""

    def __init__(self, feat_pt, R, t):
        self.feat_pt, self.R, self.t = feat_pt, R, t


def _system(case: dict, kf: int = KF, cls=tsys.MonoSlam, **extra):
    """A system at keyframe ``kf``'s insertion: its map holds keyframes
    0..kf-1 (poses perturbed) and the landmarks they drew but every fourth;
    its host state is the new keyframe's tracked pose."""
    cam_model = case.get("cam_model", "pinhole")
    cam, R_cw, t_cw, X, owner, kfs = _scene(cam_model)
    kw = dict(height=H, width=W, cam_params=cam, n_features=N_FEATURES, max_keyframes=K_CAP,
              max_points=P_CAP, ba_window=BA_WINDOW, ba_fixed=BA_FIXED, cam_model=cam_model,
              fuse_every=case.get("fuse_every", 1), stats_every=case.get("stats_every", 1),
              kf_culling=case.get("cull", True), pipelined=case.get("deferred", False),
              covis_ba=case.get("covis_ba", True), device="cpu", **extra)
    slam = cls(**kw)
    land = np.flatnonzero((owner < kf) & (np.arange(len(X)) % 4 != 0))
    slot = np.full(len(X), -1, np.int32)
    slot[land] = np.arange(len(land))
    rng = np.random.default_rng(1)
    m = tms.to_numpy(tms.empty_map(K_CAP, slam.N, P_CAP, device="cpu"))
    for k in range(kf):
        f = kfs[k]
        m["kf_valid"][k] = True
        m["kf_R"][k] = R_cw[k] @ _small_rotation(rng, POSE_NOISE)
        m["kf_t"][k] = t_cw[k] + rng.normal(0, POSE_NOISE, 3)
        m["kf_xy"][k], m["kf_level"][k], m["kf_angle"][k] = f["xy"], f["level"], f["angle"]
        m["kf_desc_sign"][k], m["kf_feat_valid"][k] = f["desc_sign"], f["valid"]
        m["kf_obs"][k] = np.where(f["valid"], slot[f["pts"]], -1)
        m["kf_ts"][k] = k * DT
    n = len(land)
    m["pt_valid"][:n] = True
    m["pt_X"][:n] = X[land] + rng.normal(0, POINT_NOISE, (n, 3))
    m["pt_first_kf"][:n] = owner[land]
    m["pt_found"][:n], m["pt_visible"][:n] = 4, 5
    slam.map = tmu.refresh_point_stats(tms.from_numpy(m, "cpu"), n_levels=slam.config.n_levels)
    slam.n_kf, slam.n_pts, slam.frame_id = kf, n, 10 * kf
    slam.state = tsys.OK
    slam._scene_slot = slot  # the landmark slot of each scene point, for later keyframes
    _set_pose(slam, kf, rng)
    return slam


def _set_pose(slam, kf: int, rng) -> None:
    _, R_cw, t_cw, _, _, _ = _scene(slam.cam_model)
    slam.R_cur = (R_cw[kf] @ _small_rotation(rng, TRACK_NOISE)).astype(np.float32)
    slam.t_cur = (t_cw[kf] + rng.normal(0, TRACK_NOISE, 3)).astype(np.float32)


def _inputs(slam, scene_kf: int):
    """Scene keyframe ``scene_kf``'s features, its landmark bindings and
    timestamp, and the tracking result ``_insert_keyframe`` reads (its pose
    the host's, as a tensor)."""
    f = _scene(slam.cam_model)[5][scene_kf]
    n = len(f["valid"])
    feats = torb.Features(
        xy=torch.as_tensor(f["xy"]), level=torch.as_tensor(f["level"]),
        angle=torch.as_tensor(f["angle"]), response=torch.zeros(n),
        desc_packed=torch.zeros((n, 8), dtype=torch.int32),
        desc_sign=torch.as_tensor(f["desc_sign"]), valid=torch.as_tensor(f["valid"]))
    feat_pt = torch.as_tensor(np.where(f["valid"], slam._scene_slot[f["pts"]], -1).astype(np.int32))
    track = _Track(feat_pt, torch.as_tensor(slam.R_cur), torch.as_tensor(slam.t_cur))
    return feats, track, scene_kf * DT


def _keyframe(slam, scene_kf: int):
    """Scene keyframe ``scene_kf`` through ``_insert_keyframe`` (a deferred
    one absorbed at once). Returns the packed [14] the host took."""
    feats, track, ts = _inputs(slam, scene_kf)
    slam._insert_keyframe(feats, ts, track)
    if slam._kf_async is not None:
        host = slam._kf_async[1]
        slam._apply_kf_async(force=True)
        return host.get()
    return slam._kf_prog.buf["packed"].numpy().copy()


def _eager(slam, scene_kf: int):
    """The plain function on the same inputs at the system's settings (the
    local BA in its device form), and the host state it gives. Returns the
    packed [14]."""
    feats, track, ts = _inputs(slam, scene_kf)
    kf_id = slam.n_kf
    R, t = (track.R, track.t) if slam.pipelined else (torch.as_tensor(slam.R_cur),
                                                        torch.as_tensor(slam.t_cur))
    slam.map, n_new, iters = slam._keyframe_work(kf_id, ts, feats, track.feat_pt, R, t,
                                                 on_device=True)
    buf = torch.cat([n_new.to(torch.float32).reshape(1), slam.map.kf_R[kf_id].reshape(9),
                     slam.map.kf_t[kf_id], iters.to(torch.float32).reshape(1)]).numpy()
    slam.ba_iters.append(int(buf[13]))
    slam.n_kf += 1
    slam.n_pts += int(buf[0])
    if not slam.pipelined:  # a deferred keyframe leaves the tracked pose the host's
        slam.R_cur, slam.t_cur = buf[1:10].reshape(3, 3).copy(), buf[10:13].copy()
    return buf


def _assert_same(slam, ref, pose: bool = True):
    """Maps and host counts equal bit for bit; with ``pose`` the host's
    pose too."""
    for f in tms.MapState._fields:
        assert torch.equal(getattr(slam.map, f), getattr(ref.map, f)), f
    for a in ("n_kf", "n_pts", "ba_iters"):
        assert getattr(slam, a) == getattr(ref, a), a
    for a in ("R_cur", "t_cur") if pose else ():
        np.testing.assert_array_equal(getattr(slam, a), getattr(ref, a), err_msg=a)


def _both(case: dict):
    """Two keyframes (scene keyframes KF, KF + 1) through the program and
    through the plain function on a deep copy. Returns (system, copy,
    [(program's packed, plain packed)] a keyframe, the program, the program's
    region runs after the first keyframe)."""
    slam = _system(case)
    ref = copy.deepcopy(slam)
    reads = []
    for i, scene_kf in enumerate((KF, KF + 1)):
        if i:
            _set_pose(slam, scene_kf, np.random.default_rng(scene_kf))
            _set_pose(ref, scene_kf, np.random.default_rng(scene_kf))
        reads.append((_keyframe(slam, scene_kf), _eager(ref, scene_kf)))
        if not i:
            runs0 = dict(slam._kf_prog.runs)
    return slam, ref, reads, slam._kf_prog, runs0


CASES = {
    **{f"fuse{a}_stats{b}_cull{c}": dict(fuse_every=1 if a else 1000,
                                         stats_every=1 if b else 1000, cull=bool(c))
       for a in (0, 1) for b in (0, 1) for c in (0, 1)},
    "deferred": dict(deferred=True),
    "deferred_fuse0_stats0_cull0": dict(deferred=True, fuse_every=1000, stats_every=1000,
                                        cull=False),
    "kb8": dict(cam_model="kb8"),
    "kb8_deferred": dict(cam_model="kb8", deferred=True),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    c = CASES[request.param]
    return (request.param, c) + _both(c)


# The program's regions, eagerly on the CPU, against the plain function:
# every map field, the packed values and the host state equal bit for bit
# after a first load and after a steady keyframe; the regions each
# keyframe's id calls for, each run once; the program's camera the case's.
def test_program_equals_the_eager_keyframe(case):
    name, c, slam, ref, reads, prog, runs0 = case
    for got, want in reads:
        np.testing.assert_array_equal(got, want)
    _assert_same(slam, ref)
    segs = kfp.kf_segments(prog.cfg, KF)
    assert runs0 == {s: 1 for s in segs}
    assert dict(prog.runs) == {s: 2 for s in segs}
    assert prog.cfg.cam_model == c.get("cam_model", "pinhole")
    assert slam.pipe_counts["kf_deferred"] == (2 if c.get("deferred") else 0)


# The cases exercise what their names say: points admitted, the branches
# the cadence calls for, BA iterations run, and the map taken over by the
# program's buffers.
def test_cases_exercise_their_paths(case):
    name, c, slam, ref, reads, prog, runs0 = case
    assert all(got[0] > 0 and got[13] >= 1 for got, _ in reads)
    segs = kfp.kf_segments(prog.cfg, KF)
    assert ("kf_fuse" in segs, "kf_stats" in segs, "kf_cull" in segs) == (
        c.get("fuse_every", 1) == 1, c.get("stats_every", 1) == 1, c.get("cull", True))
    assert all(getattr(slam.map, f) is prog.buf[f] for f in tms.MapState._fields)


# The deferred keyframe's packed copy is the synchronous read; once absorbed
# the map and counts are the synchronous keyframe's, the refined pose the
# reference keyframe's (the host keeps the tracked pose, as in the JAX
# package's pipelined mode).
@pytest.mark.parametrize("cam_model", ["pinhole", "kb8"])
def test_deferred_copy_matches_the_synchronous_read(cam_model):
    sync = _system(dict(cam_model=cam_model))
    deferred = _system(dict(cam_model=cam_model, deferred=True))
    got_sync = _keyframe(sync, KF)
    feats, track, ts = _inputs(deferred, KF)
    deferred._insert_keyframe(feats, ts, track)
    kf_id, host = deferred._kf_async
    assert kf_id == KF and isinstance(host, kfp.HostCopy)
    np.testing.assert_array_equal(host.get(), got_sync)
    deferred._apply_kf_async(force=True)
    _assert_same(deferred, sync, pose=False)
    _, R_ref, t_ref = deferred._ref_cache
    np.testing.assert_array_equal(R_ref, sync.R_cur)
    np.testing.assert_array_equal(t_ref, sync.t_cur)


# The gate: where the JAX package runs the stages one by one (the initial
# pair's keyframes 0-1, the temporal window of covis_ba=False, the inertial
# system before its IMU is initialized, whose local BA is its own), the
# eager keyframe_work runs and no program is made.
@pytest.mark.parametrize("which", ["kf1", "temporal_window", "inertial_before_imu_init"])
def test_gate_keeps_the_eager_path(which, monkeypatch):
    calls = []
    work = tkf.keyframe_work
    monkeypatch.setattr(tkf, "keyframe_work", lambda *a, **k: calls.append(a[1]) or work(*a, **k))
    if which == "kf1":
        slam = _system({}, kf=1)
    elif which == "temporal_window":
        slam = _system(dict(covis_ba=False))
    else:
        slam = _system({}, cls=tis.InertialSlam, calib=torch_calib(make_calib(freq=100.0)))
        slam._last_kf_ts = (slam.n_kf - 1) * DT
    kf_id = slam.n_kf
    feats, track, ts = _inputs(slam, kf_id)
    slam._insert_keyframe(feats, ts, track)
    assert calls == [kf_id] and slam._kf_prog is None
    assert slam.n_kf == kf_id + 1 and len(slam.ba_iters) == 1


def _rebound(slam, kind: str, eager: bool) -> None:
    """Scene keyframe KF, then a path that rebinds the map, then scene
    keyframe KF + 1 on the rebound map."""
    step = _eager if eager else _keyframe
    step(slam, KF)
    if kind == "compaction":
        slam.map.kf_valid[2] = False  # a culled keyframe: compaction moves the slots after it
        slam._compact_kf_slots()
    else:
        # archive the map, map another scene through the same program, then
        # switch back to the archived map
        at = slam.atlas
        assert at.archive_current(slam)
        other = _system({}, kf=5)
        slot, slam._scene_slot = slam._scene_slot, other._scene_slot
        slam.map, slam.n_kf, slam.n_pts = other.map, other.n_kf, other.n_pts
        slam.R_cur, slam.t_cur, slam.state = other.R_cur, other.t_cur, tsys.OK
        step(slam, 5)
        slam._scene_slot = slot
        am = at.maps.pop(0)
        at._switch_to(slam, am, am.m.kf_R[KF].numpy(), am.m.kf_t[KF].numpy())
        slam.state = tsys.OK
    _set_pose(slam, KF + 1, np.random.default_rng(KF + 1))
    step(slam, KF + 1)


# A map that a path rebinds is copied into the program's buffers at the
# next keyframe: compaction (new tensors, slots moved) and an Atlas archive
# and switch (the program mapped another map meanwhile).
@pytest.mark.parametrize("kind", ["compaction", "atlas"])
def test_rebound_map_is_copied_in(kind):
    extra = dict(enable_atlas=True) if kind == "atlas" else {}
    slam = _system({}, **extra)
    ref = copy.deepcopy(slam)
    _rebound(slam, kind, eager=False)
    _rebound(ref, kind, eager=True)
    _assert_same(slam, ref)
    assert all(getattr(slam.map, f) is slam._kf_prog.buf[f] for f in tms.MapState._fields)
    assert slam._kf_prog.runs["kf_insert"] == (2 if kind == "compaction" else 3)


# ---- against the JAX package ----
@pytest.fixture(scope="module")
def jax_case():
    """Scene keyframe KF through the program (every branch on) and through
    the JAX package's ``kf_work.keyframe_work`` from the same map and
    inputs. The new points enter as the JAX package's triangulation in
    both, as in ``test_torch_mapping.py::test_keyframe_work`` (the port
    solves the DLT by inverse iteration, the JAX package by float32 eigh)."""
    from orb_slam3_ros_tpu.models import map_state as jms
    from orb_slam3_ros_tpu.models import map_updates as jmu
    from orb_slam3_ros_tpu.models import tracking as jtrk
    from orb_slam3_ros_tpu.ops import orb as jorb
    from orb_slam3_ros_tpu_torch.models import tracking as ttrk

    slam = _system({})
    feats, track, ts = _inputs(slam, KF)
    m0 = {f: v.numpy().copy() for f, v in zip(tms.MapState._fields, slam.map)}
    jm = jms.MapState(**{f: jnp.asarray(v) for f, v in m0.items()})
    jf = jorb.Features(**{f: jnp.asarray(getattr(feats, f).numpy()) for f in jorb.Features._fields})
    R, t, jts = jnp.asarray(slam.R_cur), jnp.asarray(slam.t_cur), jnp.asarray(ts, jnp.float32)
    feat_pt = jnp.asarray(track.feat_pt.numpy())
    m_ins = jmu.insert_keyframe(jm, jnp.asarray(KF), R, t, jts, jf, feat_pt)
    jtri = jtrk.triangulate_with_ref(m_ins, jnp.asarray(KF), jnp.asarray(KF - 1), jnp.asarray(PIN))
    tri = ttrk.TriangulationResult(*(torch.as_tensor(np.array(x)) for x in jtri))
    n_pts = slam.n_pts
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrk, "triangulate_with_ref", lambda *a, **k: tri)
        got = _keyframe(slam, KF)
    jm2, n_new = jkf.keyframe_work(
        jm, jnp.asarray(KF), R, t, jts, jf, feat_pt, jnp.asarray(n_pts),
        jnp.asarray(P_CAP - n_pts), jnp.asarray(PIN), jnp.asarray(0.0, jnp.float32),
        w_free=slam.ba_window, w_fixed=slam.ba_fixed, n_iters=slam.local_ba_iters,
        row_n=slam.N, n_levels=slam.config.n_levels, fuse_neighbors=slam.fuse_neighbors,
        do_fuse=True, do_stats=True, do_cull=True, width=W, height=H,
    )
    assert kfp.kf_segments(slam._kf_prog.cfg, KF) == kfp.REGIONS
    return dict(slam=slam, got=got, n_new=int(n_new), jm=jm2)


# Integer and bool fields equal, the points admitted equal; the keyframe
# poses (and the packed pose) within 1e-4 and the landmark geometry by
# assert_points_close (the local BA sums its normal equations in another
# order); the other float fields to 1e-5.
def test_program_matches_the_jax_keyframe(jax_case):
    slam, got, jm = jax_case["slam"], jax_case["got"], jax_case["jm"]
    assert int(got[0]) == jax_case["n_new"] > 0
    np.testing.assert_allclose(got[1:13], np.concatenate([
        np.asarray(jm.kf_R[KF]).reshape(9), np.asarray(jm.kf_t[KF])]), atol=1e-4)
    assert_map_equal(slam.map, jm, fields={"kf_R", "kf_t"}, float_tol=1e-4)
    assert_map_equal(slam.map, jm, fields=set(jm._fields) - {"kf_R", "kf_t"}, solved=True)
