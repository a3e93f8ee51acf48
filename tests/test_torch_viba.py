"""The visual-inertial solvers of the port against the JAX package on the
same simulated problems (``tests/vi_sim.py``): solver OUTPUTS are compared
(states, scale, gravity, cost), never Hessians — information matrices of
float32 covariances span 1e5..1e9."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vi_sim
from orb_slam3_ros_tpu.ops import lie as jlie
from orb_slam3_ros_tpu.ops import viba as jviba
from orb_slam3_ros_tpu_torch.ops import cameras as tcameras
from orb_slam3_ros_tpu_torch.ops import imu as timu
from orb_slam3_ros_tpu_torch.ops import lie as tlie
from orb_slam3_ros_tpu_torch.ops import linalg as tlinalg
from orb_slam3_ros_tpu_torch.ops import viba as tviba
from torch_parity import np_tree, torch_preint, torch_vi_problem

torch.set_num_threads(1)
T = torch.from_numpy
K, P = 8, 200
CAM = np.array([300, 300, 188, 120, 0, 0, 0, 0, 0], np.float32)
R_BC = np.eye(3, dtype=np.float32)
T_BC = np.array([0.02, -0.01, 0.03], np.float32)
BF = 40.0


def _mv(A, x):
    return torch.einsum("...ij,...j->...i", A, x)


# The port's residuals as functions of the perturbation, the form the JAX
# package differentiates (``viba._visual_residual``, ``_inertial_residual24``);
# the port's solvers use closed-form Jacobians instead.
def _visual_residual(eps_c, eps_p, R, p, X, uv, cam_params, R_bc, t_bc):
    R2 = R @ tlie.so3_exp(eps_c[..., 0:3])
    p2 = p + _mv(R, eps_c[..., 3:6])
    Xb = _mv(R2.transpose(-1, -2), X + eps_p - p2)
    Xc = _mv(R_bc.transpose(-1, -2), Xb - t_bc)
    return tcameras.pinhole_project_nodist(cam_params, Xc) - uv


def _inertial_residual24(eps, Ri, pi, vi, bgi, bai, Rj, pj, vj, preint):
    Ri2, pi2, vi2, bgi2, bai2 = tviba._apply_pert(Ri, pi, vi, bgi, bai, eps[..., 0:15])
    Rj2 = Rj @ tlie.so3_exp(eps[..., 15:18])
    pj2 = pj + _mv(Rj, eps[..., 18:21])
    vj2 = vj + eps[..., 21:24]
    b1 = torch.cat([bgi2, bai2], dim=-1)
    return timu.inertial_residual(Ri2, pi2, vi2, b1, Rj2, pj2, vj2, preint)


def _maxdiff(want, got):
    return float(np.abs(np.asarray(want) - got.numpy()).max())


@pytest.fixture(scope="module")
def scene():
    """K keyframes on a simulated trajectory with biased, noisy IMU blocks,
    P points seen from every keyframe with 0.5 px noise and 3% gross
    outliers; the initial states are off by centimetres."""
    rng = np.random.default_rng(1)
    sim = vi_sim.simulate_vi(rng, n_kf=K - 1, samples_per_kf=20, bg=[0.01, -0.02, 0.005],
                             ba=[0.05, 0.02, -0.03], meas_noise=1e-3)
    pre = vi_sim.preintegrate_windows(sim, None, vi_sim.make_calib())
    X = rng.uniform([-3, -3, 4], [3, 3, 8], (P, 3)).astype(np.float32)
    Rwb, pwb = sim["R_wb"], sim["p_wb"]

    def proj(k):
        Xc = ((X - pwb[k]) @ Rwb[k] - T_BC) @ R_BC
        uv = np.stack([CAM[0] * Xc[:, 0] / Xc[:, 2] + CAM[2], CAM[1] * Xc[:, 1] / Xc[:, 2] + CAM[3]], -1)
        return uv, Xc[:, 2]

    uv = np.concatenate([proj(k)[0] for k in range(K)]).astype(np.float32)
    uv += rng.normal(size=uv.shape).astype(np.float32) * 0.5
    gross = rng.random(K * P) < 0.03
    uv[gross] += rng.normal(size=(gross.sum(), 2)).astype(np.float32) * 30
    zs = np.concatenate([proj(k)[1] for k in range(K)])
    ur = (uv[:, 0] - BF / zs).astype(np.float32)
    ur[rng.random(K * P) < 0.5] = -1  # half the edges are mono
    states = jviba.VIStates(
        R_wb=jnp.asarray(Rwb),
        p_wb=jnp.asarray(pwb + rng.normal(size=(K, 3)).astype(np.float32) * 0.02),
        v_w=jnp.asarray(sim["v_w"] + rng.normal(size=(K, 3)).astype(np.float32) * 0.05),
        bg=jnp.zeros((K, 3)), ba=jnp.zeros((K, 3)),
    )
    base = dict(
        states=states, kf_fixed=jnp.asarray(np.arange(K) == 0), kf_valid=jnp.ones(K, bool),
        X=jnp.asarray(X + rng.normal(size=(P, 3)).astype(np.float32) * 0.03),
        pt_valid=jnp.ones(P, bool),
        cam_idx=jnp.asarray(np.repeat(np.arange(K), P).astype(np.int32)),
        pt_idx=jnp.asarray(np.tile(np.arange(P), K).astype(np.int32)),
        uv=jnp.asarray(uv), inv_sigma2=jnp.ones(K * P),
        edge_valid=jnp.asarray(rng.random(K * P) < 0.9),
        ie_i=jnp.arange(K - 1, dtype=jnp.int32), ie_j=jnp.arange(1, K, dtype=jnp.int32),
        ie_preint=pre, ie_valid=jnp.ones(K - 1, bool),
        cam_params=jnp.asarray(CAM), R_bc=jnp.asarray(R_BC), t_bc=jnp.asarray(T_BC),
    )
    return dict(sim=sim, pre=pre, X=X, uv=uv, mono=jviba.VIBAProblem(**base),
                stereo=jviba.VIBAProblem(**base, ur=jnp.asarray(ur), bf=BF))


def _check_states(want, got):
    # Poses within 1e-4 (measured 6e-6 m / 1e-6 rad), velocities 1e-4
    # (1e-5), biases 1e-4 (1e-5). Points: 99% within 2 mm and all within
    # 5 cm: the few landmarks with a gross-outlier observation near the
    # Huber threshold or a narrow baseline move by up to centimetres for a
    # float32-rounding change in their 3x3 block, without moving a pose
    # (measured: median up to 1.4e-4 m, 99% up to 3.5e-4 m, max 1.8e-2 m).
    for f in jviba.VIStates._fields:
        assert _maxdiff(getattr(want.states, f), getattr(got.states, f)) < 1e-4, f
    d = np.abs(np.asarray(want.X) - got.X.numpy()).max(axis=1)
    assert np.quantile(d, 0.99) < 2e-3 and d.max() < 5e-2
    assert abs(float(want.cost) - float(got.cost)) < 0.01 * float(want.cost)
    assert int(want.inlier.sum()) == int(got.inlier.sum())


@pytest.mark.parametrize("kind", ["mono", "stereo"])
def test_vi_bundle_adjust_matches_jax(scene, kind):
    # The JAX solver in its scatter formulation (row_n=None), the one the
    # port carries. The stereo case drives the third residual row (ur, bf)
    # on half the edges and the wider chi2 gate.
    jp = scene[kind]
    want = jviba.vi_bundle_adjust(jp, n_iters=5)
    got = tviba.vi_bundle_adjust(torch_vi_problem(jp), n_iters=5)
    _check_states(want, got)
    assert float(got.cost) < 0.5 * float(
        tviba.vi_bundle_adjust(torch_vi_problem(jp), n_iters=0).cost)  # and it converged


def test_vi_bundle_adjust_bias_priors_and_lam(scene):
    jp = scene["mono"]
    kw = dict(n_iters=3, bias_prior_g=1e2, bias_prior_a=1e4, lam0=1e-2)
    want = jviba.vi_bundle_adjust(jp, **kw)
    got = tviba.vi_bundle_adjust(torch_vi_problem(jp), **kw)
    _check_states(want, got)
    np.testing.assert_allclose(float(got.lam), float(want.lam), rtol=1e-5)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_vi_bundle_adjust_gs_matches_jax(scene, fix_scale):
    # Scale within 1e-3 (measured 5e-5), Rwg within 1e-4 (7e-6).
    jp = scene["mono"]
    kw = dict(n_iters=6, fix_scale=fix_scale, bias_prior_g=1e2 if fix_scale else 0.0,
              bias_prior_a=1e4 if fix_scale else 0.0)
    want = jviba.vi_bundle_adjust_gs(jp, jnp.eye(3), **kw)
    got = tviba.vi_bundle_adjust_gs(torch_vi_problem(jp), torch.eye(3), **kw)
    _check_states(want, got)
    assert abs(float(want.scale) - float(got.scale)) < 1e-3
    assert _maxdiff(want.Rwg, got.Rwg) < 1e-4
    if fix_scale:
        assert float(got.scale) == 1.0
    else:
        assert abs(float(got.scale) - 1.0) > 1e-3  # the scale vertex did move


def test_padded_window_slots_stay_put(scene):
    # Two padded entries (kf_valid False, edges masked) alias the states of
    # slot 0: the reduced system keeps identity rows there, factors, and the
    # padded states come back untouched.
    jp = scene["mono"]
    arrays = np_tree(jp)
    pad = 2
    for k, v in arrays["states"].items():
        arrays["states"][k] = np.concatenate([v, np.repeat(v[:1], pad, 0)])
    arrays["kf_fixed"] = np.concatenate([arrays["kf_fixed"], np.ones(pad, bool)])
    arrays["kf_valid"] = np.concatenate([arrays["kf_valid"], np.zeros(pad, bool)])
    Q = K - 1
    arrays["ie_i"] = np.arange(Q + pad, dtype=np.int32)
    arrays["ie_j"] = np.arange(1, Q + pad + 1, dtype=np.int32)
    arrays["ie_valid"] = np.concatenate([arrays["ie_valid"], np.zeros(pad, bool)])
    arrays["ie_preint"] = {k: np.concatenate([v, np.repeat(v[:1], pad, 0)])
                           for k, v in arrays["ie_preint"].items()}
    padded = tviba.vi_bundle_adjust(tviba.problem_from_numpy(arrays, "cpu"), n_iters=4)
    plain = tviba.vi_bundle_adjust(torch_vi_problem(jp), n_iters=4)
    assert torch.isfinite(padded.cost)
    for f in tviba.VIStates._fields:
        a, b = getattr(padded.states, f), getattr(plain.states, f)
        np.testing.assert_allclose(a[:K].numpy(), b.numpy(), atol=1e-4, err_msg=f)
        np.testing.assert_array_equal(a[K:].numpy(), arrays["states"][f][K:])


def test_inertial_init_matches_jax(scene):
    # Poses of a map that is 1.7x too small and tilted against gravity:
    # both packages recover the same scale (1e-3; measured 2e-6), gravity
    # rotation (1e-5), biases and velocities (1e-5).
    sim, pre = scene["sim"], scene["pre"]
    Rg = np.asarray(jlie.so3_exp(jnp.asarray([0.3, -0.2, 0.1])))
    Rw = np.einsum("ij,kjl->kil", Rg, sim["R_wb"]).astype(np.float32)
    pw = (sim["p_wb"] @ Rg.T / 1.7).astype(np.float32)
    ii, jj = np.arange(K - 1, dtype=np.int32), np.arange(1, K, dtype=np.int32)
    want = jviba.inertial_init(jnp.asarray(Rw), jnp.asarray(pw), jnp.ones(K, bool), jnp.asarray(ii),
                               jnp.asarray(jj), pre, jnp.ones(K - 1, bool), n_iters=30)
    ones = torch.ones(K - 1, dtype=torch.bool)
    got = tviba.inertial_init(T(Rw), T(pw), torch.ones(K, dtype=torch.bool), T(ii), T(jj),
                              torch_preint(pre), ones, n_iters=30)
    assert abs(float(want.scale) - float(got.scale)) < 1e-3
    assert abs(float(want.cost) - float(got.cost)) < 0.01 * float(want.cost)
    for f in ("Rwg", "bg", "ba", "v_w"):
        assert _maxdiff(getattr(want, f), getattr(got, f)) < 1e-5, f
    # gravity comes out along the tilt that was put in
    g = got.Rwg.numpy() @ np.array([0, 0, -1.0])
    np.testing.assert_allclose(g, Rg @ np.array([0, 0, -1.0]), atol=2e-2)
    fixed = tviba.inertial_init(T(Rw), T(pw), torch.ones(K, dtype=torch.bool), T(ii), T(jj),
                                torch_preint(pre), ones, n_iters=5, fix_scale=True)
    assert float(fixed.scale) == 1.0


def _pio_args(scene, k, valid, anc_Sigma):
    sim, pre = scene["sim"], scene["pre"]
    z = np.zeros(3, np.float32)
    uvk = scene["uv"][k * P:(k + 1) * P]
    args = (sim["R_wb"][k], sim["p_wb"][k] + np.float32(0.03), sim["v_w"][k] + np.float32(0.05), z, z,
            scene["X"], uvk, np.ones(P, np.float32), valid,
            sim["R_wb"][k - 1], sim["p_wb"][k - 1], sim["v_w"][k - 1], z, z)
    prek = jax.tree.map(lambda a: a[k - 1], pre)
    tail = (anc_Sigma, CAM, R_BC, T_BC)
    return args, prek, tail


@pytest.mark.parametrize("case", ["exact_anchor", "anchor_cov", "starved"])
def test_pose_inertial_optimization_matches_jax(scene, case):
    # ``anchor_cov``: a non-zero anchor posterior inflates the edge
    # covariances. ``starved``: 4 visual edges, the IMU factor carries the
    # solve. State within 1e-4 (measured 2e-5 m), same inlier count, cost
    # within 1%, posterior covariance within 1e-3 of its largest entry
    # (measured 3e-5).
    rng = np.random.default_rng(2)
    valid = np.arange(P) < 4 if case == "starved" else rng.random(P) < 0.9
    Sigma = np.zeros((15, 15), np.float32) if case == "exact_anchor" else np.eye(15, dtype=np.float32) * 1e-4
    args, prek, tail = _pio_args(scene, 4, valid, Sigma)
    want = jviba.pose_inertial_optimization(*(jnp.asarray(a) for a in args), prek,
                                            *(jnp.asarray(a) for a in tail))
    got = tviba.pose_inertial_optimization(*(T(np.array(a)) for a in args), torch_preint(prek),
                                           *(T(a) for a in tail))
    for f in ("R_wb", "p_wb", "v_w", "bg", "ba"):
        assert _maxdiff(getattr(want, f), getattr(got, f)) < 1e-4, f
    assert int(want.n_inliers) == int(got.n_inliers)
    assert abs(float(want.cost) - float(got.cost)) < 0.01 * float(want.cost)
    S = np.asarray(want.Sigma)
    assert np.abs(S - got.Sigma.numpy()).max() < 1e-3 * np.abs(S).max()
    if case != "starved":
        truth = scene["sim"]["p_wb"][4]
        assert np.abs(got.p_wb.numpy() - truth).max() < 0.02  # pulled back from the 3 cm offset


def test_closed_form_visual_jacobians_match_jax_jacfwd(scene):
    # _visual_res_jac (closed form) against AD of the JAX residual; 3e-3 of
    # entries up to ~100 px/m (measured 2e-4).
    rng = np.random.default_rng(3)
    sim = scene["sim"]
    R, p = sim["R_wb"][2], sim["p_wb"][2]
    X = scene["X"][:20]
    uv = scene["uv"][2 * P:2 * P + 20]
    ur = (uv[:, 0] - rng.uniform(2, 8, 20)).astype(np.float32)

    def one(Xi, uvi, uri):
        f = lambda ec, ep: jviba._visual_residual3(  # noqa: E731
            ec, ep, jnp.asarray(R), jnp.asarray(p), Xi, uvi, uri, jnp.asarray(CAM),
            jnp.asarray(R_BC), jnp.asarray(T_BC), BF)
        z6, z3 = jnp.zeros(6), jnp.zeros(3)
        return f(z6, z3), jax.jacfwd(f, 0)(z6, z3), jax.jacfwd(f, 1)(z6, z3)

    r, Jc, Jp = jax.vmap(one)(jnp.asarray(X), jnp.asarray(uv), jnp.asarray(ur))
    gr, gJc, gJp = tviba._visual_res_jac(
        T(R).expand(20, 3, 3), T(p).expand(20, 3), T(X), T(uv), T(CAM), T(R_BC), T(T_BC),
        T(ur), torch.ones(20), torch.tensor(BF))
    np.testing.assert_allclose(gr.numpy(), np.asarray(r), atol=1e-3)
    np.testing.assert_allclose(gJc.numpy(), np.asarray(Jc), atol=3e-3)
    np.testing.assert_allclose(gJp.numpy(), np.asarray(Jp), atol=3e-3)
    # the port's residual as a function of the perturbation agrees too
    eps = (rng.normal(size=(20, 6)) * 1e-2).astype(np.float32)
    want = jax.vmap(lambda e, Xi, uvi: jviba._visual_residual(
        e, jnp.zeros(3), jnp.asarray(R), jnp.asarray(p), Xi, uvi, jnp.asarray(CAM),
        jnp.asarray(R_BC), jnp.asarray(T_BC)))(jnp.asarray(eps), jnp.asarray(X), jnp.asarray(uv))
    got = _visual_residual(T(eps), torch.zeros(3), T(R), T(p), T(X), T(uv), T(CAM), T(R_BC), T(T_BC))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)


def test_inertial_residual24_matches_jax(scene):
    rng = np.random.default_rng(4)
    sim, pre = scene["sim"], scene["pre"]
    eps = (rng.normal(size=(K - 1, 24)) * 1e-2).astype(np.float32)
    z = np.zeros((K - 1, 3), np.float32)
    a = (sim["R_wb"][:-1], sim["p_wb"][:-1], sim["v_w"][:-1], z, z,
         sim["R_wb"][1:], sim["p_wb"][1:], sim["v_w"][1:])
    want = jax.vmap(jviba._inertial_residual24)(jnp.asarray(eps), *(jnp.asarray(x) for x in a), pre)
    got = _inertial_residual24(T(eps), *(T(np.array(x)) for x in a), torch_preint(pre))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_failed_factorization_rejects_the_step(scene):
    # A non-SPD system gives NaN, not an exception; the LM step built from it
    # has a NaN cost, ``cost_new < cost`` is false, and the state is kept.
    H = torch.tensor([[1.0, 2.0], [2.0, 1.0]])  # indefinite
    assert torch.isnan(tlinalg.cho_solve(H, torch.ones(2))).all()
    assert torch.isnan(tlinalg.inv(torch.zeros(2, 3, 3))).all()  # singular
    ok = tlinalg.inv(torch.eye(3)[None] * 2.0)
    np.testing.assert_allclose(ok.numpy(), np.eye(3)[None] * 0.5)
    # A whole solve whose every step fails: a NaN observation poisons the
    # normal equations (its Huber weight is NaN), Cholesky fails, each of
    # the 3 steps is rejected and the damping grows 5x a step.
    arrays = np_tree(scene["mono"])
    arrays["uv"] = arrays["uv"].copy()
    arrays["uv"][5] = np.nan
    arrays["edge_valid"] = arrays["edge_valid"].copy()
    arrays["edge_valid"][5] = True
    prob = tviba.problem_from_numpy(arrays, "cpu")
    res = tviba.vi_bundle_adjust(prob, n_iters=3)
    for f in tviba.VIStates._fields:
        np.testing.assert_array_equal(getattr(res.states, f).numpy(), arrays["states"][f])
    np.testing.assert_array_equal(res.X.numpy(), arrays["X"])
    np.testing.assert_allclose(float(res.lam), 1e-3 * 125, rtol=1e-5)


def test_camera_body_round_trip(scene):
    sim = scene["sim"]
    R_bc = np.asarray(jlie.so3_exp(jnp.asarray([0.1, 0.2, -0.3])))
    want = jviba.cam_from_body(jnp.asarray(sim["R_wb"]), jnp.asarray(sim["p_wb"]),
                               jnp.asarray(R_bc), jnp.asarray(T_BC))
    got = tviba.cam_from_body(T(sim["R_wb"]), T(sim["p_wb"]), T(R_bc), T(T_BC))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-6)
    back = tviba.body_from_cam(*got, T(R_bc), T(T_BC))
    np.testing.assert_allclose(back[0].numpy(), sim["R_wb"], atol=1e-6)
    np.testing.assert_allclose(back[1].numpy(), sim["p_wb"], atol=5e-5)  # two float32 rotations of ~1 m
