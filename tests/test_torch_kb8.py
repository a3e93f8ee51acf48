"""The port's Kannala-Brandt-8 fisheye camera against the JAX package, from
the camera functions up to ``MonoSlam(cam_model="kb8")`` end to end.

The setup is ``tests/test_kb8_native.py``'s: the repo's test KB8 at 240x376
(``[150, 150, 187.5, 119.5, 0.02, 0.001, -0.002, 0.0002]``, whose image
corners stay under 90 degrees off axis), ``make_room(seed=2)``, the orbit at
10 Hz, 1200 features. The module's fixture renders the 25 frames with the
JAX package (both systems get the same images), runs the JAX ``MonoSlam``
and the port's per frame over them, keeps a copy of the port's system at
its first chunkable frame (with ``lean_after_kf`` 4) and runs one 8-frame
chunk of each package from that copy, as ``tests/test_torch_mono_chunk.py``
does for the pinhole. The stage tests take the JAX run's final map and
frames as their inputs; two-view initialization and relocalization get the
JAX package's RANSAC samples. Tolerances are stated where they are
compared.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.models import device_loop as jdl
from orb_slam3_ros_tpu.models import map_state as jms
from orb_slam3_ros_tpu.models import map_updates as jmu
from orb_slam3_ros_tpu.models import system as jsys
from orb_slam3_ros_tpu.models import tracking as jtrk
from orb_slam3_ros_tpu.ops import ba as jba
from orb_slam3_ros_tpu.ops import ba_pcg as jpcg
from orb_slam3_ros_tpu.ops import cameras as jcam
from orb_slam3_ros_tpu.ops import lie as jlie
from orb_slam3_ros_tpu.ops import matching as jmatch
from orb_slam3_ros_tpu.ops import orb as jorb
from orb_slam3_ros_tpu.ops import pose_opt as jpo
from orb_slam3_ros_tpu.ops import ransac as jransac
from orb_slam3_ros_tpu.ops import rectify as jrect
from orb_slam3_ros_tpu.utils import synth as jsynth
from orb_slam3_ros_tpu_torch.models import device_loop as tdl
from orb_slam3_ros_tpu_torch.models import map_updates as tmu
from orb_slam3_ros_tpu_torch.models import map_state as tms
from orb_slam3_ros_tpu_torch.models import system as tsys
from orb_slam3_ros_tpu_torch.models import tracking as ttrk
from orb_slam3_ros_tpu_torch.models.chunk_runner import read_rows
from orb_slam3_ros_tpu_torch.ops import ba as tba
from orb_slam3_ros_tpu_torch.ops import ba_pcg as tpcg
from orb_slam3_ros_tpu_torch.ops import cameras as tcam
from orb_slam3_ros_tpu_torch.ops import orb as torb
from orb_slam3_ros_tpu_torch.ops import pose_opt as tpo
from orb_slam3_ros_tpu_torch.ops import ransac as transac
from orb_slam3_ros_tpu_torch.ops import rectify as trect
from orb_slam3_ros_tpu_torch.utils import synth as tsynth
from orb_slam3_ros_tpu_torch.utils.evaluate_ate import ate_rmse
from torch_cases import T
from torch_parity import torch_ba_problem, torch_features, torch_map
from test_torch_reloc import jax_samples

torch.set_num_threads(1)
KB8 = np.asarray([150.0, 150.0, 187.5, 119.5, 0.02, 0.001, -0.002, 0.0002], np.float32)
H, W, N_FRAMES, CHUNK = 240, 376, 25, 8
SLAM_KW = dict(height=H, width=W, cam_params=KB8, n_features=1200, max_keyframes=32,
               max_points=4096, cam_model="kb8")


# ---- the camera -------------------------------------------------------------
def _points(n=400, seed=0):
    """Points up to 85 degrees off the optical axis at 0.5-5 m, and four
    near it: 1e-4 and 3e-6 of radial offset, one under the 1e-9 floor, and
    one almost in the image plane."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(0, np.deg2rad(85), n)
    ph = rng.uniform(0, 2 * np.pi, n)
    d = rng.uniform(0.5, 5, n)
    X = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th)], -1) * d[:, None]
    near = [[1e-4, -2e-4, 1.0], [3e-6, 1e-6, 2.0], [1e-10, 2e-10, 1.0], [0.5, 0.1, 1e-3]]
    return np.concatenate([X, near]).astype(np.float32)


def _camera_case(name):
    X = _points()
    if name == "project":
        # pixels to 1e-4 + 1e-6 relative (float32 atan2 and the polynomial;
        # the point almost in the image plane lands thousands of pixels out)
        np.testing.assert_allclose(tcam.kb8_project(T(KB8), T(X)).numpy(),
                                   np.asarray(jcam.kb8_project(KB8, X)), atol=1e-4, rtol=1e-6)
    elif name == "jacobian":
        # the closed form against jax.jacfwd, to 1e-4 of max(1, |entry|),
        # the floored point included (there the floor is a constant in both)
        want = np.asarray(jcam.project_jac_model(KB8, X, "kb8"))
        got = tcam.kb8_project_jac(T(KB8), T(X)).numpy()
        assert np.all(np.abs(got - want) <= 1e-4 * np.maximum(1.0, np.abs(want)))
    elif name == "unproject":
        # rays to 1e-5 over the image and past it (r clamped at pi)
        rng = np.random.default_rng(1)
        uv = rng.uniform([-200, -200], [W + 200, H + 200], (1000, 2)).astype(np.float32)
        uv = np.concatenate([uv, np.asarray(jcam.kb8_project(KB8, X[:-1]))]).astype(np.float32)
        want = np.asarray(jcam.kb8_unproject(KB8, uv))
        got = tcam.kb8_unproject(T(KB8), T(uv)).numpy()
        assert np.all(np.abs(got - want) <= 1e-5 * np.maximum(1.0, np.abs(want)))
    elif name == "round_trip":
        # unproject(project(X)) along X, as test_kb8_native checks it
        rays = tcam.kb8_unproject(T(KB8), tcam.kb8_project(T(KB8), T(X[:-4]))).numpy()
        cos = np.sum(rays * X[:-4], -1) / np.linalg.norm(rays, axis=-1) / np.linalg.norm(X[:-4], axis=-1)
        assert np.max(1.0 - cos) < 1e-4
    elif name == "dispatch":
        for fn_t, fn_j, arg in ((tcam.project_model, jcam.project_model, X),
                                (tcam.project_jac_model, jcam.project_jac_model, X[:-4])):
            np.testing.assert_allclose(fn_t(T(KB8), T(arg), "kb8").numpy(),
                                       np.asarray(fn_j(KB8, arg, "kb8")), atol=1e-3, rtol=1e-5)
        uv = np.asarray(jcam.kb8_project(KB8, X[:-1]))
        np.testing.assert_allclose(tcam.unproject_model(T(KB8), T(uv), "kb8").numpy(),
                                   np.asarray(jcam.unproject_model(KB8, uv, "kb8")), atol=1e-4)
        with pytest.raises(ValueError):
            tcam.check_model("double_sphere")


@pytest.mark.parametrize("name", ["project", "jacobian", "unproject", "round_trip", "dispatch"])
def test_kb8_camera_against_jax(name):
    _camera_case(name)


# ---- the module's runs ------------------------------------------------------
def _jax_frames():
    scene = jsynth.make_room(seed=2)
    R_wc, t_wc, ts = jsynth.orbit_trajectory(N_FRAMES, dt=0.1, seed=2)
    imgs = [np.asarray(jsynth.render(scene, jnp.asarray(R_wc[i]), jnp.asarray(t_wc[i]),
                                     jnp.asarray(KB8), height=H, width=W, cam_model="kb8")[0])
            for i in range(N_FRAMES)]
    return np.stack(imgs), R_wc, t_wc, ts


def _result(slam, t_wc, ts, first):
    traj = slam.get_trajectory()
    tss = np.asarray([t for t, _ in traj])
    est = np.stack([np.asarray(T_)[:3, 3] for _, T_ in traj])
    ate, n, _ = ate_rmse(tss, est, ts.astype(np.float64), t_wc)
    return dict(ate=float(ate), scored=int(n), n_kf=int(slam.n_kf), state=int(slam.state),
                init=first)


def _run(slam, imgs, on_frame=None):
    first = None
    for i in range(N_FRAMES):
        out = slam.process_frame(imgs[i], float(i) * 0.1)
        if out is not None and first is None:
            first = i
        if on_frame is not None:
            on_frame(i, slam)
    return first


def _against_jax_chunk(snap, stack, ts, jax_extract):
    """One CHUNK-frame chunk from the snapshot by both packages."""
    slam = copy.deepcopy(snap)
    i0, cfg = slam.frame_id, slam._chunk_config()
    tss = ts[i0 : i0 + CHUNK].astype(np.float32)
    run = jdl.make_chunk_runner(
        jorb.default_config(H, W, n_features=1200), jnp.asarray(KB8), width=W, height=H,
        kf_every=cfg.kf_every, kf_min_inliers=cfg.kf_min_inliers, kf_ref_ratio=cfg.kf_ref_ratio,
        ba_window=cfg.ba_window, ba_fixed=cfg.ba_fixed, local_ba_iters=cfg.local_ba_iters,
        fuse_neighbors=cfg.fuse_neighbors, fuse_every=cfg.fuse_every,
        stats_every=cfg.stats_every, cull_every=cfg.cull_every, kf_culling=cfg.kf_culling,
        schedule=slam._sched_lean, K_cap=cfg.K_cap, track_cap=cfg.track_cap, cam_model="kb8",
    )
    jm = jms.MapState(**{k: jnp.asarray(v) for k, v in tms.to_numpy(slam.map).items()})
    carry = jdl.LoopCarry(
        m=jm, R=jnp.asarray(slam.R_cur), t=jnp.asarray(slam.t_cur), vel_R=jnp.asarray(slam.vel_R),
        vel_t=jnp.asarray(slam.vel_t), n_kf=jnp.asarray(slam.n_kf, jnp.int32),
        n_pts=jnp.asarray(slam.n_pts, jnp.int32),
        last_kf_fid=jnp.asarray(slam.last_kf_frame, jnp.int32), alive=jnp.asarray(True),
        ref_inl=jnp.full((), -1, jnp.int32),
    )
    jc, jout = run(carry, jnp.asarray(stack[i0 : i0 + CHUNK].numpy()), jnp.asarray(tss),
                   jnp.arange(CHUNK, dtype=jnp.int32) + i0)
    runner = tdl.MonoChunkRunner(cfg, torch.device("cpu"))
    pose = torch.from_numpy(np.concatenate([
        slam.R_cur.reshape(-1), slam.t_cur, slam.vel_R.reshape(-1), slam.vel_t,
    ]).astype(np.float32))
    runner.load(slam.map, pose, slam.n_kf, slam.n_pts, slam.last_kf_frame, -1)
    xs = torch.from_numpy(np.stack([tss, i0 + np.arange(CHUNK)], 1).astype(np.float32))
    rows, kf_ids = runner.run_chunk(stack, i0, xs, slam._sched_lean, slam.n_kf)
    return dict(out=read_rows(rows.numpy()), c=runner.carry(), kf_ids=kf_ids, runner=runner,
                jout={k: np.asarray(v) for k, v in jout._asdict().items()}, jc=jc,
                first_tie=_first_feature_difference(slam, stack[i0 : i0 + CHUNK], jax_extract))


def _first_feature_difference(slam, frames, jax_extract):
    """The first chunk frame whose features the two packages' extractors
    list differently (CHUNK if none): two keypoints whose responses differ
    in the last float32 digits can swap places in the top-k, and from the
    keyframe that holds them on the two maps differ in their point slots."""
    for k in range(len(frames)):
        img = frames[k].to(torch.float32)
        a = torb.extract(img, slam.config)
        b = jax_extract(jnp.asarray(img.numpy()))
        if not (np.array_equal(a.xy.numpy(), np.asarray(b.xy))
                and np.array_equal(a.level.numpy(), np.asarray(b.level))):
            return k
    return len(frames)


@pytest.fixture(scope="module")
def runs():
    imgs, R_wc, t_wc, ts = _jax_frames()
    jslam = jsys.MonoSlam(pipelined=False, **SLAM_KW)
    jslam._warm_schedules = lambda: None  # compiles ahead only
    jfirst = _run(jslam, imgs)
    tslam = tsys.MonoSlam(device="cpu", pipelined=False, **SLAM_KW)
    snaps = []

    def snap_when_chunkable(i, slam):
        # the first frame after which the chunk gate holds with 4 keyframes
        if not snaps and slam.n_kf >= 4 and i + 1 + CHUNK <= N_FRAMES:
            s = copy.deepcopy(slam)
            s.lean_after_kf = 4
            if s._chunkable():
                snaps.append(s)

    tfirst = _run(tslam, imgs, snap_when_chunkable)
    stack = torch.clamp(torch.from_numpy(imgs), 0, 255).to(torch.uint8)
    return dict(imgs=imgs, R_wc=R_wc, t_wc=t_wc, ts=ts, jslam=jslam, tslam=tslam,
                jax=_result(jslam, t_wc, ts, jfirst), port=_result(tslam, t_wc, ts, tfirst),
                chunk=_against_jax_chunk(snaps[0], stack, ts, jslam._extract), snap=snaps[0])


# ---- end to end (test_kb8_native's 25 frames) -------------------------------
# Both initialize within the first 8 frames and track to the end; at least
# 4 keyframes each and counts within 40% of the JAX run's (the weak-tracking
# keyframe rule fires near its 60-inlier bar here, so the counts part with
# float round-off: measured 7 in the port, 10 in the JAX package); the
# Sim(3) ATE within 1.5x + 2 cm of the JAX run's and under
# test_kb8_native's 0.15 m (measured on the CPU: port 0.0570 m, JAX 0.0734
# m, both initialized at frame 1; the JAX package run with pipelined=True,
# as test_kb8_native runs it, measured 0.155 m there).
E2E_CHECKS = {
    "initialized_early": lambda j, p: p["init"] is not None and j["init"] is not None
    and p["init"] <= 8 and j["init"] <= 8,
    "state_ok": lambda j, p: p["state"] == j["state"] == tsys.OK,
    "frames_scored": lambda j, p: p["scored"] >= 12 and p["scored"] >= j["scored"] - 3,
    "keyframes_close": lambda j, p: abs(p["n_kf"] - j["n_kf"]) <= 0.4 * j["n_kf"]
    and min(p["n_kf"], j["n_kf"]) >= 4,
    "ate_close_to_jax": lambda j, p: p["ate"] <= 1.5 * j["ate"] + 0.02,
    "ate_under_the_jax_test_bound": lambda j, p: p["ate"] < 0.15,
}


@pytest.mark.parametrize("name", list(E2E_CHECKS))
def test_kb8_mono_end_to_end_against_jax(runs, name):
    assert E2E_CHECKS[name](runs["jax"], runs["port"]), (name, runs["jax"], runs["port"])


# ---- one 8-frame chunk from a shared snapshot -------------------------------
# test_torch_mono_chunk.py's tolerances hold up to and including the first
# frame whose features the two extractors list in another order (an
# extraction near-tie, not the camera's: on this snapshot frame 1 of the
# chunk, two level-2 keypoints with responses 124.74198 / 124.74178 in the
# port and 124.74175 / 124.74165 in the JAX package): the same keyframe
# flags, inliers within 1% and poses to 5e-4. That frame is a keyframe, and
# its point slots differ from there on, so later frames are held to the
# chunk's outcome: every frame alive in both, keyframes within 1, the end
# pose within 1.5 cm and 0.03 rad of the JAX chunk's (measured: 5.7e-3 m,
# 1.3e-2 rad; inliers 56-94 against 58-86).
def _jc(r, k):
    return np.asarray(getattr(r["jc"], k))


def _upto(r):
    return slice(0, min(r["first_tie"], CHUNK - 1) + 1)


CHUNK_CHECKS = {
    "alive_in_both": lambda r: r["out"].alive.all() and r["jout"]["alive"].all()
    and len(r["out"].alive) == CHUNK,
    "a_keyframe_in_the_chunk": lambda r: len(r["kf_ids"]) >= 1,
    "keyframes_within_1": lambda r: abs(int(r["out"].is_kf.sum()) - int(r["jout"]["is_kf"].sum()))
    <= 1 and abs(int(r["c"].n_kf) - int(_jc(r, "n_kf"))) <= 1,
    "keyframe_flags_equal_to_the_first_tie": lambda r: np.array_equal(
        r["out"].is_kf[_upto(r)], r["jout"]["is_kf"][_upto(r)]),
    "inliers_within_1_percent_to_the_first_tie": lambda r: np.all(
        np.abs(r["out"].n_inliers[_upto(r)] - r["jout"]["n_inliers"][_upto(r)])
        <= 0.01 * r["jout"]["n_inliers"][_upto(r)]),
    "poses_close_to_the_first_tie": lambda r: np.abs(
        r["out"].R[_upto(r)] - r["jout"]["R"][_upto(r)]).max() <= 5e-4
    and np.abs(r["out"].t[_upto(r)] - r["jout"]["t"][_upto(r)]).max() <= 5e-4,
    "end_pose_close": lambda r: np.abs(r["c"].t.numpy() - _jc(r, "t")).max() <= 1.5e-2
    and np.abs(r["c"].R.numpy() - _jc(r, "R")).max() <= 3e-2,
}


@pytest.mark.parametrize("name", list(CHUNK_CHECKS))
def test_kb8_chunk_against_jax(runs, name):
    r = runs["chunk"]
    assert CHUNK_CHECKS[name](r), (name, r["first_tie"], r["out"].n_inliers,
                                   r["jout"]["n_inliers"], r["kf_ids"])


def test_kb8_chunk_config_carries_the_camera(runs):
    cfg = runs["snap"]._chunk_config()
    assert cfg.cam_model == "kb8" and runs["chunk"]["runner"].runs["kf_insert"] >= 1


# ---- the stages, on the JAX run's map ---------------------------------------
def _jmap(runs):
    return runs["jslam"].map, int(runs["jslam"].n_kf)


def _feats(runs, i):
    return runs["jslam"]._extract(jnp.asarray(runs["imgs"][i]))


def test_render_against_jax(runs):
    # The port's KB8 render of frame 3 from the same pose: 99% of the pixels
    # within 0.5 grey levels, the depth within 1e-3 m on 99% (texture
    # lookups at face edges may round to the other face).
    scene = tsynth.make_room(seed=2, device="cpu")
    img, depth = tsynth.render(scene, runs["R_wc"][3], runs["t_wc"][3], KB8, height=H, width=W,
                               cam_model="kb8")
    _, jdepth = jsynth.render(jsynth.make_room(seed=2), jnp.asarray(runs["R_wc"][3]),
                              jnp.asarray(runs["t_wc"][3]), jnp.asarray(KB8), height=H, width=W,
                              cam_model="kb8")
    assert np.quantile(np.abs(img.numpy() - runs["imgs"][3]), 0.99) <= 0.5
    assert np.quantile(np.abs(depth.numpy() - np.asarray(jdepth)), 0.99) <= 1e-3


@pytest.mark.parametrize("part", ["rect_map", "remap", "virtual_pinhole"])
def test_rectify_against_jax(runs, part):
    pin = jrect.virtual_pinhole_params(KB8, H, W)
    if part == "virtual_pinhole":
        np.testing.assert_array_equal(trect.virtual_pinhole_params(KB8, H, W), pin)
        np.testing.assert_array_equal(trect.virtual_pinhole_params(T(KB8), H, W), pin)
        return
    want_map = np.asarray(jrect.kb8_rect_map(jnp.asarray(KB8), jnp.asarray(pin), H, W))
    got_map = trect.kb8_rect_map(T(KB8), pin, H, W)
    if part == "rect_map":
        # source pixels to 1e-3 px
        np.testing.assert_allclose(got_map.numpy(), want_map, atol=1e-3, rtol=0)
        return
    # the remap of frame 0 on the JAX package's map: grey levels to 1e-3,
    # the out-of-bounds samples 0 in both
    img = runs["imgs"][0]
    want = np.asarray(jrect.remap_bilinear(jnp.asarray(img), jnp.asarray(want_map)))
    got = trect.remap_bilinear(T(img), T(want_map)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    assert np.array_equal(got == 0, want == 0)


def test_pose_optimization_kb8_against_jax():
    # 200 points seen through KB8 (0.7 px noise, 10% gross outliers), a
    # perturbed start: R, t to 1e-4, inliers within 2.
    rng = np.random.default_rng(3)
    n = 200
    R_gt = np.asarray(jlie.so3_exp(np.asarray([0.1, -0.2, 0.05], np.float32)))
    t_gt = np.asarray([0.1, -0.3, 0.5], np.float32)
    Xc = _points(n, seed=4)[:n] + np.asarray([0, 0, 0.5], np.float32)
    Xw = ((Xc - t_gt) @ R_gt).astype(np.float32)
    uv = np.asarray(jcam.kb8_project(KB8, Xc)) + rng.normal(0, 0.7, (n, 2))
    uv[: n // 10] += rng.uniform(20, 40, (n // 10, 2))
    uv = uv.astype(np.float32)
    inv_s2 = (1.0 / 1.2 ** (2.0 * rng.integers(0, 4, n))).astype(np.float32)
    valid = rng.random(n) < 0.95
    R0 = np.asarray(jlie.so3_exp(np.asarray([0.13, -0.17, 0.08], np.float32)))
    t0 = t_gt + np.asarray([0.05, -0.04, 0.03], np.float32)
    j = jpo.pose_optimization(R0, t0, Xw, uv, inv_s2, valid, KB8, rounds=3, iters_per_round=5,
                              cam_model="kb8")
    t = tpo.pose_optimization(T(R0), T(t0), T(Xw), T(uv), T(inv_s2), T(valid), T(KB8), rounds=3,
                              iters_per_round=5, cam_model="kb8")
    np.testing.assert_allclose(t.R.numpy(), np.asarray(j.R), atol=1e-4)
    np.testing.assert_allclose(t.t.numpy(), np.asarray(j.t), atol=1e-4)
    assert abs(int(t.n_inliers) - int(j.n_inliers)) <= 2
    np.testing.assert_allclose(t.R.numpy(), R_gt, atol=5e-3)


def _kb8_problem(K=6, P=150, seed=1):
    """K keyframes each seeing all P points through KB8, 0.5 px noise, 3%
    gross outliers, 10% invalid edges, two fixed keyframes, an invalid pad
    slot; poses and points perturbed; every edge given a u_r >= 0 and bf
    > 0, which KB8 ignores."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(1.0, 4.0, P)
    X = _points(P, seed=seed)[:P]
    X = (X / np.linalg.norm(X, axis=-1, keepdims=True) * d[:, None]).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=(K, 3)).astype(np.float32) * 0.05)))
    t = np.stack([[0.1 * k - 0.3, 0.02 * rng.normal(), 0.02 * rng.normal()] for k in range(K)])
    t = t.astype(np.float32)
    Xc = np.einsum("kij,pj->kpi", R, X) + t[:, None]
    uv = np.asarray(jcam.kb8_project(KB8, Xc.reshape(-1, 3)))
    uv = uv + rng.normal(size=uv.shape) * 0.5
    gross = rng.random(K * P) < 0.03
    uv[gross] += rng.normal(size=(int(gross.sum()), 2)) * 30
    dR = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=(K, 3)).astype(np.float32) * 0.01)))
    R0 = np.where((np.arange(K) < 2)[:, None, None], R, dR @ R)
    t0 = np.where((np.arange(K) < 2)[:, None], t, t + rng.normal(size=(K, 3)) * 0.02)
    valid = np.arange(K) < K - 1
    return jba.BAProblem(
        R=jnp.asarray(R0.astype(np.float32)), t=jnp.asarray(t0.astype(np.float32)),
        cam_fixed=jnp.asarray(np.arange(K) < 2), cam_valid=jnp.asarray(valid),
        X=jnp.asarray(X + rng.normal(size=X.shape).astype(np.float32) * 0.03),
        pt_valid=jnp.asarray(np.arange(P) < P - 4),
        cam_idx=jnp.asarray(np.repeat(np.arange(K), P).astype(np.int32)),
        pt_idx=jnp.asarray(np.tile(np.arange(P), K).astype(np.int32)),
        uv=jnp.asarray(uv.astype(np.float32)),
        inv_sigma2=jnp.asarray((1.2 ** (-2.0 * rng.integers(0, 4, K * P))).astype(np.float32)),
        edge_valid=jnp.asarray((rng.random(K * P) < 0.9) & np.repeat(valid, P)),
        cam_params=jnp.asarray(KB8),
        ur=jnp.asarray(np.maximum(uv[:, 0] - 10.0, 0.0).astype(np.float32)),
        bf=jnp.asarray(15.0, jnp.float32),
    )


@pytest.fixture(scope="module")
def kb8_problem():
    return _kb8_problem()


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_bundle_adjust_kb8_against_jax(kb8_problem, solver):
    # Poses within 1e-4, points 99% within 1e-3, cost to 1e-3 relative,
    # inliers within 2: test_torch_ba_pcg.py's tolerances (scatter-adds sum
    # in another order than XLA's); every point within 2e-3 of max(1, |X|)
    # (measured: a point with one inlier edge of three drifts along its ray
    # to 43 m in the dense solve, the two packages 6.5e-2 m apart there).
    tp = torch_ba_problem(kb8_problem)
    if solver == "dense":
        want = jba.bundle_adjust(kb8_problem, n_iters=6, cam_model="kb8")
        got = tba.bundle_adjust(tp, n_iters=6, cam_model="kb8")
    else:
        want = jpcg.bundle_adjust_pcg(kb8_problem, n_iters=4, n_cg=20, cam_model="kb8")
        got = tpcg.bundle_adjust_pcg(tp, n_iters=4, n_cg=20, cam_model="kb8")
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-4)
    d = np.abs(got.X.numpy() - np.asarray(want.X)).max(axis=1)
    scale = np.maximum(1.0, np.abs(np.asarray(want.X)).max(axis=1))
    assert np.quantile(d, 0.99) < 1e-3 and np.all(d <= 2e-3 * scale)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-3)
    assert abs(int(got.n_inliers) - int(want.n_inliers)) <= 2


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_kb8_ur_rows_have_no_effect(kb8_problem, solver):
    # Under KB8 the u_r row is zero (the JAX package's rule, ba.py:109-110,
    # ba_pcg.py:62): the problem with every edge's u_r and bf set solves to
    # the bit as the one with none. The chi2 gate of an edge with u_r >= 0
    # stays the 3-DoF one in both packages, so only the row is compared.
    tp = torch_ba_problem(kb8_problem)
    mono = tp._replace(ur=torch.full_like(tp.ur, -1.0), bf=torch.zeros_like(tp.bf))
    r_st, *_ = tba._gather_edges(tp, tp.cam_idx.long(), tp.pt_idx.long(), tp.R, tp.t, tp.X,
                                 "kb8")
    r_mo, *_ = tba._gather_edges(mono, tp.cam_idx.long(), tp.pt_idx.long(), tp.R, tp.t, tp.X,
                                 "kb8")
    assert torch.equal(r_st, r_mo) and not r_st[:, 2].any()
    solve = (lambda p: tba.bundle_adjust(p, n_iters=3, cam_model="kb8")) if solver == "dense" \
        else (lambda p: tpcg.bundle_adjust_pcg(p, n_iters=3, n_cg=10, cam_model="kb8"))
    # the same gate on both: the stereo problem's ur everywhere >= 0
    a = solve(tp)
    b = solve(tp._replace(bf=torch.zeros_like(tp.bf), ur=tp.ur + 50.0))
    for f in ("R", "t", "X", "cost"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_triangulate_with_ref_kb8_against_jax(runs):
    # The newest keyframe with its observations unbound, against the one
    # before it: the bearing-space epipolar search finds the same pairs, ok
    # agrees on 99%, and the points both keep agree to 1e-3 of their
    # distance on 95% of them and to 2e-2 on all: the port's DLT solves by
    # inverse iteration where the JAX package takes a float32 eigh, and a
    # low-parallax point magnifies the difference (measured on the map of
    # a run with 2048 point slots: one point of 168 1.1e-2 apart; ROADMAP
    # Queue 3, "triangulate_with_ref").
    jm, n_kf = _jmap(runs)
    obs = np.array(jm.kf_obs)
    obs[n_kf - 1] = -1
    jm = jm._replace(kf_obs=jnp.asarray(obs))
    want = jtrk.triangulate_with_ref(jm, jnp.asarray(n_kf - 1), jnp.asarray(n_kf - 2),
                                     jnp.asarray(KB8), cam_model="kb8")
    got = ttrk.triangulate_with_ref(torch_map(jm), n_kf - 1, n_kf - 2, T(KB8), cam_model="kb8")
    ok_w, ok_g = np.asarray(want.ok), got.ok.numpy()
    assert ok_w.sum() >= 50 and (ok_w == ok_g).mean() >= 0.99
    both = ok_w & ok_g
    np.testing.assert_array_equal(got.ref_feat.numpy()[both], np.asarray(want.ref_feat)[both])
    Xw = np.asarray(want.X_w)[both]
    rel = np.linalg.norm(got.X_w.numpy()[both] - Xw, axis=-1) / np.linalg.norm(Xw, axis=-1)
    assert np.quantile(rel, 0.95) <= 1e-3 and rel.max() <= 2e-2, rel.max()


def test_fuse_in_neighbors_kb8_against_jax(runs):
    # Every other observation of the newest keyframe unbound: fusion under
    # KB8 binds them back alike (observations 99.9% equal, the same points
    # alive, n_fused within 1).
    jm, n_kf = _jmap(runs)
    obs = np.array(jm.kf_obs)
    obs[n_kf - 1, ::2] = -1
    jm = jm._replace(kf_obs=jnp.asarray(obs))
    wm, wn = jmu.fuse_in_neighbors(jm, jnp.asarray(n_kf - 1), jnp.asarray(KB8), W, H,
                                   n_neighbors=1, cam_model="kb8")
    gm, gn = tmu.fuse_in_neighbors(torch_map(jm), n_kf - 1, T(KB8), W, H, n_neighbors=1,
                                   cam_model="kb8")
    assert int(wn) >= 20 and abs(int(gn) - int(wn)) <= 1
    assert (gm.kf_obs.numpy() == np.asarray(wm.kf_obs)).mean() >= 0.999
    np.testing.assert_array_equal(gm.pt_valid.numpy(), np.asarray(wm.pt_valid))


def test_track_against_map_kb8_against_jax(runs):
    # Frame 24 from the JAX run's last pose nudged by 1 cm: KB8 projection
    # search and pose optimization give the pose to 5e-4, inliers within 1%
    # (measured: 67 inliers in the JAX package).
    jm, _ = _jmap(runs)
    f = _feats(runs, 24)
    R0 = np.asarray(runs["jslam"].R_cur)
    t0 = np.asarray(runs["jslam"].t_cur) + np.asarray([0.01, -0.005, 0.0], np.float32)
    want = jtrk.track_against_map(jm, f, jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(KB8), W, H,
                                  cam_model="kb8")
    got = ttrk.track_against_map(torch_map(jm), torch_features(f), T(R0), T(t0), T(KB8), W, H,
                                 cam_model="kb8")
    assert int(want.n_inliers) >= 50
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=5e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=5e-4)
    assert abs(int(got.n_inliers) - int(want.n_inliers)) <= 0.01 * int(want.n_inliers)


def test_two_view_init_on_bearings_against_jax(runs):
    # Frames 0 and 5, matched by the JAX package: the port's fx-scaled
    # bearings and virtual camera equal the JAX branch's (to 1e-3 px), and
    # the H/F RANSAC on them with the JAX package's samples reconstructs
    # the same motion (R to 1e-4, the unit t to 5e-4: measured 1.6e-4;
    # good points 99% alike).
    f1, f2 = _feats(runs, 0), _feats(runs, 5)
    idx, _ = jmatch.search_for_initialization(f1, f2, window=100.0)
    idx = np.asarray(idx)
    matched = idx >= 0
    assert matched.sum() >= 60
    fx = float(KB8[0])
    xy1 = np.asarray(f1.xy)
    xy2 = np.asarray(f2.xy)[np.clip(idx, 0, None)]
    b1 = np.asarray(jcam.kb8_unproject(KB8, xy1))[:, :2] * fx
    b2 = np.asarray(jcam.kb8_unproject(KB8, xy2))[:, :2] * fx
    init_cam = np.asarray([fx, fx, 0, 0, 0, 0, 0, 0, 0], np.float32)
    np.testing.assert_allclose(tcam.fx_bearings(T(KB8), T(xy1)).numpy(), b1, atol=1e-3)
    np.testing.assert_array_equal(tcam.bearing_camera(T(KB8)).numpy(), init_cam)
    key = jax.random.PRNGKey(7)
    want = jransac.two_view_init(jnp.asarray(b1), jnp.asarray(b2), jnp.asarray(matched),
                                 jnp.asarray(init_cam), key)
    logits = jnp.where(jnp.asarray(matched), 0.0, -jnp.inf)
    samples = np.asarray(jax.random.categorical(key, logits[None, :], shape=(256, 8)))
    got = transac.two_view_init_from_samples(T(b1), T(b2), T(matched), T(init_cam), T(samples))
    assert bool(want.ok) and bool(got.ok)
    np.testing.assert_allclose(got.R21.numpy(), np.asarray(want.R21), atol=1e-4)
    np.testing.assert_allclose(got.t21.numpy(), np.asarray(want.t21), atol=5e-4)
    assert (got.good.numpy() == np.asarray(want.good)).mean() >= 0.99


def test_reloc_attempt_kb8_against_jax(runs):
    # Frame 24 against the JAX map's newest keyframe: matches -> PnP on
    # bearings (the JAX package's samples) -> KB8 tracking. Pose to 1e-4
    # rad / 5e-4 m, tracking inliers within 1%.
    jm, n_kf = _jmap(runs)
    f = _feats(runs, 24)
    cand = n_kf - 1
    key = jax.random.PRNGKey(4)
    want = np.asarray(jsys._reloc_attempt_fused(jm, jnp.asarray(cand), f, key, jnp.asarray(KB8),
                                                W, H, cam_model="kb8"))
    _, _, ok = jsys._reloc_pnp_inputs(jm, cand, f)
    got = tsys._reloc_attempt(torch_map(jm), cand, torch_features(f), T(KB8), W, H,
                              samples=T(jax_samples(key, np.asarray(ok))),
                              cam_model="kb8").numpy()
    assert int(np.asarray(ok).sum()) >= 15 and want[12] >= 30
    np.testing.assert_allclose(got[:9], want[:9], atol=1e-4)
    np.testing.assert_allclose(got[9:12], want[9:12], atol=5e-4)
    assert abs(got[12] - want[12]) <= 0.01 * want[12], (got[12], want[12])
