"""The KB8 camera on the port's visual-inertial paths (``ops/viba.py``,
``models/inertial_system.py``, ``models/vi_device_loop.py``,
``FisheyeStereoInertialSlam``).

The JAX package projects every VI-BA row and the 15-dof refinement's rows
through the pinhole model whatever the camera (its ``viba.py:88`` and
``:100``), so it has no KB8 rows to compare against. The port's KB8 rows
are held instead to a reference composed in this file from the JAX
package's own ``cameras.kb8_project``, as its ``_visual_residual``
composes the pinhole one, and differentiated with ``jax.jacfwd``. The
pinhole branch is held to the code it replaced, to the bit. End to end, at
``tests/torch_fisheye_scenarios.py``'s test size (240x376, the repo's test
KB8, ``make_vi_sequence(seed=0)``'s trajectory and IMU, the views rendered
KB8 at its poses in its room): ``InertialSlam(cam_model="kb8")``
and ``FisheyeStereoInertialSlam()`` initialize the IMU and keep the
metric ATE within 2x the JAX package's ``cam_model="pinhole"`` run of the
same trajectory and IMU (its tested camera), and the two-device split
runs under KB8. The JAX package's own KB8 runs of the sequence are
recorded in the assertion messages, not asserted. Tolerances are stated
where they are compared.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vi_sim
from orb_slam3_ros_tpu.ops import cameras as jcam
from orb_slam3_ros_tpu.ops import lie as jlie
from orb_slam3_ros_tpu_torch.ops import cameras as tcam
from orb_slam3_ros_tpu_torch.ops import imu as timu
from orb_slam3_ros_tpu_torch.ops import lie as tlie
from orb_slam3_ros_tpu_torch.ops import viba as tviba
from orb_slam3_ros_tpu_torch.parallel import problems
from orb_slam3_ros_tpu_torch.utils import synth as tsynth
from orb_slam3_ros_tpu_torch.utils.evaluate_ate import ate_rmse
import torch_fisheye_scenarios as sc


torch.set_num_threads(1)
T = torch.from_numpy
# TUM-VI cam0 (Examples/Stereo-Inertial/TUM-VI.yaml) at half its 512x512.
KB8 = np.asarray([95.489, 95.4865, 127.466, 128.4485, 0.0034824, 0.00071503, -0.0020532,
                  0.00020294], np.float32)
H = W = 256
R_BC = np.asarray(jlie.so3_exp(jnp.asarray([0.02, -0.03, 0.01], jnp.float32)))
T_BC = np.asarray([0.02, -0.01, 0.03], np.float32)
BF = 12.0


def _edges(n=64, seed=0, max_angle=1.3):
    """Body poses, world points seen by a KB8 camera up to ``max_angle``
    rad off its axis, and their observations with 0.5 px of noise."""
    rng = np.random.default_rng(seed)
    R = np.asarray(jax.vmap(jlie.so3_exp)(jnp.asarray(rng.normal(size=(n, 3)) * 0.3, jnp.float32)))
    p = rng.normal(size=(n, 3)).astype(np.float32)
    th = rng.uniform(0.05, max_angle, n)
    ph = rng.uniform(-np.pi, np.pi, n)
    d = rng.uniform(1.0, 6.0, n)
    Xc = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th)], -1) * d[:, None]
    Xb = Xc @ R_BC.T + T_BC
    X = (np.einsum("nij,nj->ni", R, Xb) + p).astype(np.float32)
    uv = np.asarray(jcam.kb8_project(jnp.asarray(KB8), jnp.asarray(Xc, jnp.float32)))
    uv = (uv + rng.normal(size=uv.shape) * 0.5).astype(np.float32)
    return R, p, X, uv


def _jax_kb8_residual(eps_c, eps_p, R, p, X, uv):
    """The JAX package's ``viba._visual_residual`` with the frame's camera,
    ``cameras.kb8_project``, in place of its pinhole projection."""
    R2 = R @ jlie.so3_exp(eps_c[0:3])
    p2 = p + R @ eps_c[3:6]
    Xb = R2.T @ (X + eps_p - p2)
    Xc = jnp.asarray(R_BC).T @ (Xb - jnp.asarray(T_BC))
    return jcam.kb8_project(jnp.asarray(KB8), Xc) - uv


def _jax_kb8_rows(R, p, X, uv):
    def one(Ri, pi, Xi, uvi):
        f = lambda ec, ep: _jax_kb8_residual(ec, ep, Ri, pi, Xi, uvi)  # noqa: E731
        z6, z3 = jnp.zeros(6), jnp.zeros(3)
        return f(z6, z3), jax.jacfwd(f, 0)(z6, z3), jax.jacfwd(f, 1)(z6, z3)

    return [np.asarray(x) for x in jax.vmap(one)(*(jnp.asarray(a) for a in (R, p, X, uv)))]


def _close(got, want, rtol=1e-4):
    """rtol 1e-4, relative to the largest entry of the quantity (a residual
    near 0 px has no relative error of its own): the float32 round-off of
    two orders of evaluation."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


def test_kb8_visual_rows_match_jacfwd_of_the_jax_projection():
    """``_visual_res`` / ``_visual_res_jac`` under KB8 against the JAX
    package's ``kb8_project`` composed as its ``_visual_residual`` and
    differentiated by ``jax.jacfwd``: rtol 1e-4 on the residuals and both
    Jacobians (the body pose perturbation and the point)."""
    R, p, X, uv = _edges()
    r, Jc, Jp = _jax_kb8_rows(R, p, X, uv)
    args = (T(R), T(p), T(X), T(uv), T(KB8), T(R_BC), T(T_BC))
    gr, gJc, gJp = tviba._visual_res_jac(*args, cam_model="kb8")
    _close(gr + T(uv), np.asarray(r) + uv)  # the predicted pixels
    _close(gr, r)
    _close(gJc, Jc)
    _close(gJp, Jp)
    r_only, _, _ = tviba._visual_res(*args, cam_model="kb8")
    assert torch.equal(r_only, gr)


def test_kb8_third_row_is_masked():
    """A KB8 rig is not rectified: with u_r observations and ``rmask3`` 0
    (the rule ``_vi_lm`` applies to every KB8 edge) the third row and its
    Jacobians are 0 and the first two rows are the mono ones, to the bit."""
    R, p, X, uv = _edges(seed=1)
    args = (T(R), T(p), T(X), T(uv), T(KB8), T(R_BC), T(T_BC))
    ur = T(uv[:, 0] - 3.0)
    r3, Jc3, Jp3 = tviba._visual_res_jac(*args, ur, torch.zeros(len(uv)), torch.tensor(BF),
                                          cam_model="kb8")
    r2, Jc2, Jp2 = tviba._visual_res_jac(*args, cam_model="kb8")
    assert r3.shape[-1] == 3 and Jc3.shape[-2] == 3
    assert not r3[:, 2].any() and not Jc3[:, 2].any() and not Jp3[:, 2].any()
    assert torch.equal(r3[:, :2], r2) and torch.equal(Jc3[:, :2], Jc2) and torch.equal(Jp3[:, :2], Jp2)


# ---- the pinhole branch, bit-equal to the code it replaced -----------------
CAM = np.asarray([300, 300, 188, 120, 0, 0, 0, 0, 0], np.float32)


def _pre_visual_res_jac(R, p, X, uv, cam_params, R_bc, t_bc, ur=None, rmask3=None, bf=None):
    """``viba._visual_res`` / ``_visual_res_jac`` as they were before the
    camera model reached them (pinhole only)."""
    Xb = torch.einsum("...ji,...j->...i", R, X - p)
    Xc = (Xb - t_bc) @ R_bc
    r = tcam.pinhole_project_nodist(cam_params, Xc) - uv
    if ur is not None:
        z = torch.clamp(Xc[..., 2], min=1e-6)
        r3 = (r[..., 0] + uv[..., 0] - bf / z - ur) * rmask3
        r = torch.cat([r, r3[..., None]], dim=-1)
    Jproj = tcam.pinhole_project_jac(cam_params, Xc)
    if ur is not None:
        zc = Xc[..., 2]
        dz = torch.where(zc > 1e-6, bf / torch.clamp(zc, min=1e-6) ** 2, torch.zeros_like(zc))
        e_z = torch.eye(3, dtype=X.dtype, device=X.device)[2]
        Jur = (Jproj[..., 0, :] + e_z * dz[..., None]) * rmask3[..., None]
        Jproj = torch.cat([Jproj, Jur[..., None, :]], dim=-2)
    JXb = Jproj @ R_bc.transpose(-1, -2)
    eye = torch.eye(3, dtype=X.dtype, device=X.device).expand(Xb.shape[:-1] + (3, 3))
    Jc = JXb @ torch.cat([tlie.hat(Xb), -eye], dim=-1)
    Jp = JXb @ R.transpose(-1, -2)
    return r, Jc, Jp


@pytest.mark.parametrize("rows", ["mono", "stereo"])
def test_pinhole_visual_rows_are_the_code_they_replaced(rows):
    rng = np.random.default_rng(2)
    R, p, X, _ = _edges(seed=2, max_angle=0.6)
    Xc = ((X - p)[:, None, :] @ R)[:, 0] - T_BC
    uv = (Xc @ R_BC)[:, :2] * 300.0 / (Xc @ R_BC)[:, 2:3] + [188, 120]
    uv = (uv + rng.normal(size=uv.shape)).astype(np.float32)
    args = (T(R), T(p), T(X), T(uv), T(CAM), T(R_BC), T(T_BC))
    extra = ()
    if rows == "stereo":
        extra = (T(uv[:, 0] - 4.0), T((rng.random(len(uv)) < 0.5).astype(np.float32)),
                 torch.tensor(BF))
    want = _pre_visual_res_jac(*args, *extra)
    got = tviba._visual_res_jac(*args, *extra)
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    assert torch.equal(tviba._visual_res(*args, *extra)[0], want[0])


def _pre_projection(monkeypatch):
    """Route the camera-model dispatch to the direct pinhole calls the
    solvers made before it (``pinhole_project_nodist`` and
    ``pinhole_project_jac``), failing on any other model."""
    def proj(params, X, model="pinhole"):
        assert model == "pinhole"
        return tcam.pinhole_project_nodist(params, X)

    def jac(params, X, model="pinhole"):
        assert model == "pinhole"
        return tcam.pinhole_project_jac(params, X)

    monkeypatch.setattr(tcam, "project_model", proj)
    monkeypatch.setattr(tcam, "project_jac_model", jac)


@pytest.fixture(scope="module")
def vi_scene():
    """``parallel/problems.py``'s simulated IMU trajectory (the JAX tests'
    ``vi_sim.simulate_vi``, in numpy) as a 6-keyframe window: 80 points
    seen through the camera at ``R_BC`` / ``T_BC`` with 0.5 px of noise,
    half the edges stereo, poses 2 cm and points 3 cm off."""
    K, P = 6, 80
    rng = np.random.default_rng(1)
    sim = problems._simulate_vi(rng, K - 1)
    calib = timu.calib_from_numpy(problems.vi_calib(), "cpu")
    pre = timu.preintegrate(T(sim["acc"]), T(sim["gyro"]), T(sim["dts"]), torch.zeros(K - 1, 6),
                            calib)
    X = rng.uniform([-3, -3, 4], [3, 3, 8], (P, 3)).astype(np.float32)
    Rwb, pwb = sim["R_wb"], sim["p_wb"]
    Xc = np.concatenate([((X - pwb[k]) @ Rwb[k] - T_BC) @ R_BC for k in range(K)])
    uv = (Xc[:, :2] * 300.0 / Xc[:, 2:3] + [188, 120]).astype(np.float32)
    uv += rng.normal(size=uv.shape).astype(np.float32) * 0.5
    ur = (uv[:, 0] - BF / Xc[:, 2]).astype(np.float32)
    ur[rng.random(K * P) < 0.5] = -1
    states = tviba.VIStates(
        R_wb=T(Rwb), p_wb=T(pwb + rng.normal(size=(K, 3)).astype(np.float32) * 0.02),
        v_w=T(sim["v_w"]), bg=torch.zeros(K, 3), ba=torch.zeros(K, 3))
    prob = tviba.VIBAProblem(
        states=states, kf_fixed=T(np.arange(K) == 0), kf_valid=torch.ones(K, dtype=torch.bool),
        X=T(X + rng.normal(size=(P, 3)).astype(np.float32) * 0.03),
        pt_valid=torch.ones(P, dtype=torch.bool),
        cam_idx=T(np.repeat(np.arange(K), P).astype(np.int32)),
        pt_idx=T(np.tile(np.arange(P), K).astype(np.int32)), uv=T(uv),
        inv_sigma2=torch.ones(K * P), edge_valid=torch.ones(K * P, dtype=torch.bool),
        ie_i=torch.arange(K - 1, dtype=torch.int32), ie_j=torch.arange(1, K, dtype=torch.int32),
        ie_preint=pre, ie_valid=torch.ones(K - 1, dtype=torch.bool), cam_params=T(CAM),
        R_bc=T(R_BC), t_bc=T(T_BC), ur=T(ur), bf=torch.tensor(BF))
    return dict(sim=sim, pre=pre, prob=prob, uv=uv, X=X)


def test_pinhole_vi_bundle_adjust_is_the_code_it_replaced(vi_scene, monkeypatch):
    """The VI-BA (stereo rows included) under the pinhole model, and the
    same solve with the projections routed to the direct pinhole calls the
    code made before: equal to the bit."""
    prob = vi_scene["prob"]
    got = tviba.vi_bundle_adjust(prob, n_iters=3)
    gs = tviba.vi_bundle_adjust_gs(prob, torch.eye(3), n_iters=3)
    _pre_projection(monkeypatch)
    want = tviba.vi_bundle_adjust(prob, n_iters=3)
    want_gs = tviba.vi_bundle_adjust_gs(prob, torch.eye(3), n_iters=3)
    for w, g in [(want, got), (want_gs, gs)]:
        for a, b in zip(w.states, g.states):
            assert torch.equal(a, b)
        assert torch.equal(w.X, g.X) and torch.equal(w.cost, g.cost)
        assert torch.equal(w.inlier, g.inlier)


def _pose_inertial_args(vi_scene, k=3):
    sim, pre, uv, X = vi_scene["sim"], vi_scene["pre"], vi_scene["uv"], vi_scene["X"]
    P = X.shape[0]
    prek = timu.Preintegrated(*(x[k - 1] for x in pre))
    f = lambda a: T(np.array(a, np.float32))  # noqa: E731
    z = torch.zeros(3)
    state = (f(sim["R_wb"][k]), f(sim["p_wb"][k] + [0.03, -0.02, 0.01]), f(sim["v_w"][k]), z, z)
    anchor = (f(sim["R_wb"][k - 1]), f(sim["p_wb"][k - 1]), f(sim["v_w"][k - 1]), z, z)
    obs = (T(X), T(uv[k * P:(k + 1) * P]), torch.ones(P), torch.ones(P, dtype=torch.bool))
    return state, obs, anchor, prek


def test_pinhole_pose_inertial_optimization_is_the_code_it_replaced(vi_scene, monkeypatch):
    state, obs, anchor, prek = _pose_inertial_args(vi_scene)
    args = (*state, *obs, *anchor, prek, torch.zeros(15, 15), T(CAM), T(R_BC), T(T_BC))
    got = tviba.pose_inertial_optimization(*args)
    _pre_projection(monkeypatch)
    want = tviba.pose_inertial_optimization(*args)
    for a, b in zip(want, got):
        assert torch.equal(a, b)


# ---- KB8 solves --------------------------------------------------------------
def _kb8_problem(vi_scene, with_ur: bool):
    """``vi_scene``'s window re-observed through KB8 (the TUM-VI camera),
    its stereo observations kept where asked (a KB8 problem masks them)."""
    prob, sim, X = vi_scene["prob"], vi_scene["sim"], vi_scene["X"]
    K = sim["R_wb"].shape[0]
    Xc = np.concatenate([((X - sim["p_wb"][k]) @ sim["R_wb"][k] - T_BC) @ R_BC for k in range(K)])
    uv = tcam.kb8_project(T(KB8), T(Xc.astype(np.float32)))
    uv = uv + T(np.random.default_rng(4).normal(size=uv.shape).astype(np.float32) * 0.5)
    return prob._replace(uv=uv, cam_params=T(KB8), ur=prob.ur if with_ur else None)


def test_kb8_vi_bundle_adjust_converges_and_ignores_u_r(vi_scene):
    """The VI-BA on KB8 observations (0.5 px of noise): from states 2 cm
    and points 3 cm off, the cost falls below 1e-3 of its start and the
    median visual chi2 below 1 (the noise gives ~0.35); the u_r
    observations of a KB8 problem change nothing (equal to the bit to the
    problem without them)."""
    prob = _kb8_problem(vi_scene, with_ur=True)
    res = tviba.vi_bundle_adjust(prob, n_iters=8, cam_model="kb8")
    start = tviba.vi_bundle_adjust(prob, n_iters=0, cam_model="kb8")
    assert float(res.cost) < 1e-3 * float(start.cost)
    assert float(torch.median(res.chi2_visual)) < 1.0
    mono = tviba.vi_bundle_adjust(_kb8_problem(vi_scene, with_ur=False), n_iters=8,
                                  cam_model="kb8")
    for a, b in zip(res.states, mono.states):
        assert torch.equal(a, b)
    assert torch.equal(res.X, mono.X) and torch.equal(res.cost, mono.cost)


def test_kb8_pose_inertial_optimization_pulls_back(vi_scene):
    """The 15-dof refinement on KB8 observations of keyframe 3: from a
    pose 3.7 cm off, within 1 cm of the truth with every edge an inlier;
    read as pinhole pixels, the same observations lose edges."""
    k, P = 3, vi_scene["X"].shape[0]
    state, obs, anchor, prek = _pose_inertial_args(vi_scene, k)
    uv = _kb8_problem(vi_scene, with_ur=False).uv[k * P:(k + 1) * P]
    obs = (obs[0], uv, *obs[2:])
    args = (*state, *obs, *anchor, prek, torch.zeros(15, 15), T(KB8), T(R_BC), T(T_BC))
    res = tviba.pose_inertial_optimization(*args, cam_model="kb8")
    err = np.abs(res.p_wb.numpy() - vi_scene["sim"]["p_wb"][k]).max()
    assert err < 0.01 and int(res.n_inliers) == P, (err, int(res.n_inliers))
    assert int(tviba.pose_inertial_optimization(*args).n_inliers) < P


# ---- the slice as a whole ---------------------------------------------------
# ``tests/torch_fisheye_scenarios.py --size test``'s configurations: the
# repo's test KB8 at 240x376 (TEST_KB8; the TUM-VI camera at this size
# would put the image corners past 90 degrees off axis), (f) the
# mono-inertial settings of ``tests/test_torch_inertial_e2e.py`` over its
# 45 frames, (g) the inertial rig of ``tests/test_torch_fisheye_e2e.py``
# (0.12 m along x) over its 40 frames, the views rendered KB8 by the port.

# The JAX package's pinhole runs of the same trajectories and IMU (its
# tested camera): ``torch_fisheye_scenarios.py --package jax --size test
# --part e`` (the record ``tests/test_torch_inertial_e2e.py`` holds its live
# run to) and ``--part c`` (the run ``tests/test_torch_fisheye_e2e.py``
# compares the port with), metric ATE in m. Its KB8 runs (``--part f``,
# ``--part g``) project the visual-inertial rows through the pinhole model:
# recorded in the messages, not asserted.
JAX_PINHOLE = dict(vi=0.02258, rig=0.02216)
JAX_KB8 = dict(vi=0.15945, rig=0.41933)


def _vi_seq(n):
    seq, im = tsynth.make_vi_sequence(**sc._vi_seq_kw(True, n), device="cpu")
    return seq, im, tsynth.make_room(seed=0, device="cpu")


def _view(scene, R, t):
    return tsynth.render(scene, R, t, sc.TEST_KB8, height=sc.TEST_H, width=sc.TEST_W,
                         cam_model="kb8")[0]


def _metric(slam, seq, skip):
    traj = slam.get_trajectory()
    ts = np.asarray([t for t, _ in traj])[skip:]
    est = np.stack([np.asarray(T)[:3, 3] for _, T in traj])[skip:]
    gt_ts = np.asarray(seq.timestamps, np.float64)
    metric, n, _ = ate_rmse(ts, est, gt_ts, seq.t_wc, with_scale=False)
    _, _, scale = ate_rmse(ts, est, gt_ts, seq.t_wc, with_scale=True)
    return dict(metric=float(metric), n=int(n), scale=float(scale))


def _calib():
    return timu.ImuCalib(*(np.asarray(x, np.float32) for x in vi_sim.make_calib(freq=100.0)))


@pytest.fixture(scope="module")
def kb8_runs():
    """The port's ``InertialSlam(cam_model="kb8")`` and
    ``FisheyeStereoInertialSlam()`` at the test size, frame by frame."""
    from orb_slam3_ros_tpu_torch.models import fisheye_stereo as tfs
    from orb_slam3_ros_tpu_torch.models.inertial_system import InertialSlam

    out = {}
    torch.set_num_threads(2)  # the file's two long runs; 1 again after them
    seq, im, scene = _vi_seq(sc.TEST_VI_FRAMES)
    slam = InertialSlam(height=sc.TEST_H, width=sc.TEST_W, cam_params=sc.TEST_KB8, cam_model="kb8",
                        calib=_calib(), device="cpu", **sc.TEST_VI_KW)
    imu_at = None
    for i in range(sc.TEST_VI_FRAMES):
        slam.process_frame(_view(scene, seq.R_wc[i], seq.t_wc[i]), float(seq.timestamps[i]),
                           acc=im["acc"][i], gyro=im["gyro"][i], dts=im["dts"][i])
        if slam.imu_initialized and imu_at is None:
            imu_at = i
    # the frames with a pose, from the trajectory: a VI frame's call returns
    # the frame before it, and ``get_trajectory`` drains the last one
    posed = [int(np.argmin(np.abs(seq.timestamps - t))) for t, _ in slam.get_trajectory()]
    out["vi"] = dict(slam=slam, posed=posed, imu_at=imu_at, **_metric(slam, seq, sc.VI_SKIP))

    seq, im, scene = _vi_seq(sc.TEST_RIG_FRAMES)
    t_rl = np.asarray([-sc.TEST_BASE, 0.0, 0.0], np.float32)
    slam = tfs.FisheyeStereoInertialSlam(height=sc.TEST_H, width=sc.TEST_W, cam_params=sc.TEST_KB8,
                                         calib=_calib(), R_rl=np.eye(3, dtype=np.float32), t_rl=t_rl,
                                         device="cpu", **sc.TEST_RIG_KW)
    posed = []
    for i in range(sc.TEST_RIG_FRAMES):
        c_r = seq.t_wc[i] + seq.R_wc[i] @ (-t_rl)
        if slam.process_frame(_view(scene, seq.R_wc[i], seq.t_wc[i]), _view(scene, seq.R_wc[i], c_r),
                              float(seq.timestamps[i]), acc=im["acc"][i], gyro=im["gyro"][i],
                              dts=im["dts"][i]) is not None:
            posed.append(i)
    out["rig"] = dict(slam=slam, posed=posed, **_metric(slam, seq, 0))
    torch.set_num_threads(1)
    return out


@pytest.mark.parametrize("name", ["vi", "rig"])
def test_kb8_inertial_runs_initialize_the_imu(kb8_runs, name):
    """The IMU initialized in all three stages without a reset, the camera
    KB8, and a pose for every frame from the first posed one on."""
    r = kb8_runs[name]
    slam = r["slam"]
    assert slam.cam_model == "kb8"
    assert slam.imu_initialized and slam.imu_stage == 3 and slam.bad_imu_resets == 0
    n = sc.TEST_VI_FRAMES if name == "vi" else sc.TEST_RIG_FRAMES
    assert r["posed"][0] <= 2 and r["posed"] == list(range(r["posed"][0], n))


@pytest.mark.parametrize("name", ["vi", "rig"])
def test_kb8_inertial_metric_ate_within_2x_the_jax_pinhole_run(kb8_runs, name):
    """The metric ATE (no scale alignment; the mono-inertial run after its
    first 12 poses, as ``bench.py`` scores) within 2x the JAX package's
    pinhole run of the same trajectory and IMU (measured: port KB8 0.0086 m
    and 0.0152 m)."""
    r = kb8_runs[name]
    assert r["metric"] <= 2.0 * JAX_PINHOLE[name], (
        f"port KB8 {r['metric']:.5f} m; the JAX package: pinhole {JAX_PINHOLE[name]} m, "
        f"its KB8 run (pinhole-projected VI rows) {JAX_KB8[name]} m")


def test_kb8_rig_fixes_the_scale(kb8_runs):
    """The rig observes metric scale: the IMU solves with it fixed, and the
    Sim(3) scale of the trajectory stays within phase 16 (c)'s 6%."""
    r = kb8_runs["rig"]
    assert r["slam"].imu_fix_scale
    assert abs(r["scale"] - 1.0) <= 0.06, r["scale"]


def test_kb8_systems_hand_the_camera_to_their_solvers(kb8_runs, monkeypatch):
    """The KB8 system's window VI-BA, its gravity / scale BA and its global
    BA solve under "kb8", and its chunk runner is configured with it."""
    slam = copy.deepcopy(kb8_runs["vi"]["slam"])
    assert slam._vi_chunk_config().cam_model == "kb8"
    seen = []
    for name in ("vi_bundle_adjust", "vi_bundle_adjust_gs"):
        fn = getattr(tviba, name)
        monkeypatch.setattr(tviba, name, lambda *a, _fn=fn, **k: seen.append(k.get("cam_model"))
                            or _fn(*a, **k))
    slam._run_vi_ba(window=slam.W, n_iters=1)
    slam._run_vi_ba_gs(n_iters=1)
    slam._start_async_gba(2)
    slam.flush()
    assert seen == ["kb8"] * 3


# ---- the two-device split under KB8 -----------------------------------------
SPLIT_FRAMES, SPLIT_SKIP = 22, 8


def _split_run(seq, im, frames, devices, mp):
    from orb_slam3_ros_tpu_torch.models import inertial_system as tis
    from orb_slam3_ros_tpu_torch.models import tracking
    from test_torch_two_device import TRACK

    kw = dict(devices=devices) if devices else dict(device="cpu")
    slam = tis.InertialSlam(height=sc.TEST_H, width=sc.TEST_W, cam_params=sc.TEST_KB8,
                            cam_model="kb8", calib=_calib(), n_features=800, max_keyframes=32,
                            max_points=4096, kf_every=3, init_after_kf=4, track_cap=512, **kw)
    replica_reads = []

    def probe(m, *a, **k):
        # a frame tracks the frame or the VI frame program's copy of the
        # map: where that copy was made from
        src = m.pt_X
        for prog in (slam._frame_prog, slam._vi_prog):
            if prog is not None and src is prog.buf["pt_X"]:
                src = prog._map_src["pt_X"][0]
        replica_reads.append(slam._replica is not None
                             and any(src is b.pt_X for b in slam._replica._bufs))
        assert k.get("cam_model") == "kb8"
        return TRACK(m, *a, **k)

    mp.setattr(tracking, "track_against_map", probe)
    for i in range(SPLIT_FRAMES):
        slam.process_frame(frames[i], float(seq.timestamps[i]), acc=im["acc"][i],
                           gyro=im["gyro"][i], dts=im["dts"][i])
    return dict(slam=slam, replica_reads=replica_reads, **_metric(slam, seq, SPLIT_SKIP))


@pytest.fixture(scope="module")
def kb8_split():
    """``InertialSlam(cam_model="kb8", devices=("cpu", "cpu"))`` against the
    same run on one device, sharing one extraction a frame
    (``tests/test_torch_two_device.py``), ``tests/test_torch_two_device_vi.py``'s
    settings over 22 frames."""
    from orb_slam3_ros_tpu_torch.ops import orb
    from test_torch_two_device import SharedExtraction

    seq, im, scene = _vi_seq(SPLIT_FRAMES)
    frames = [_view(scene, seq.R_wc[i], seq.t_wc[i]) for i in range(SPLIT_FRAMES)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(orb, "extract", SharedExtraction())
        split = _split_run(seq, im, frames, ("cpu", "cpu"), mp)
        single = _split_run(seq, im, frames, None, mp)
    return dict(split=split, single=single)


def test_kb8_split_initializes_the_imu_and_matches_one_device(kb8_split):
    """Both runs initialize the IMU (two stages) under KB8; the split
    tracks VI frames against its replica; on the CPU a refresh lands at
    once, so the metric ATE is the one-device run's, to the bit."""
    split, single = kb8_split["split"], kb8_split["single"]
    for r in (split, single):
        assert r["slam"].cam_model == "kb8" and r["slam"].imu_initialized
        assert r["slam"].imu_stage >= 2 and r["slam"].bad_imu_resets == 0
    assert any(split["replica_reads"]) and not any(single["replica_reads"])
    assert split["n"] == single["n"] >= SPLIT_FRAMES - SPLIT_SKIP - 4
    assert split["metric"] == single["metric"], (split["metric"], single["metric"])
