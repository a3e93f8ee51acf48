"""The global BA of loop closing in the port against the JAX package: the
matrix-free Schur-PCG solver (``ops/ba_pcg.py``) and the global-BA builders
and fold-ins of ``models/local_mapping.py`` (``build_global_ba``,
``apply_global_ba_partial`` with and without the snapshot's observation
table, ``apply_global_ba``, ``apply_vi_gba_partial``). Inputs are made with
numpy from a seed and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.models import local_mapping as jlm
from orb_slam3_ros_tpu.models import map_state as jms
from orb_slam3_ros_tpu.ops import ba as jba
from orb_slam3_ros_tpu.ops import ba_pcg as jpcg
from orb_slam3_ros_tpu.ops import lie as jlie
from orb_slam3_ros_tpu.ops import viba as jviba
from orb_slam3_ros_tpu_torch.models import local_mapping as tlm
from orb_slam3_ros_tpu_torch.ops import ba as tba
from orb_slam3_ros_tpu_torch.ops import ba_pcg as tpcg
from orb_slam3_ros_tpu_torch.ops import viba as tviba
from torch_parity import np_tree, torch_ba_problem, torch_calib, torch_map
from vi_sim import make_calib

torch.set_num_threads(1)
CAM = np.asarray([400.0, 400.0, 320.0, 240.0, 0, 0, 0, 0, 0], np.float32)
K, P = 8, 200


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def problem():
    """K keyframes each seeing all P points, 0.5 px noise, 3% gross
    outliers, 10% invalid edges, two fixed keyframes and an invalid pad
    slot; poses and points perturbed (the shape ``test_torch_viba.py``
    uses)."""
    rng = np.random.default_rng(1)
    X = rng.uniform([-3, -3, 4], [3, 3, 8], (P, 3)).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=(K, 3)).astype(np.float32) * 0.05)))
    t = np.stack([[0.3 * k - 1.0, 0.05 * rng.normal(), 0.05 * rng.normal()] for k in range(K)])
    t = t.astype(np.float32)
    Xc = np.einsum("kij,pj->kpi", R, X) + t[:, None]
    uv = np.stack([CAM[0] * Xc[..., 0] / Xc[..., 2] + CAM[2],
                   CAM[1] * Xc[..., 1] / Xc[..., 2] + CAM[3]], -1).reshape(-1, 2)
    uv += rng.normal(size=uv.shape).astype(np.float32) * 0.5
    gross = rng.random(K * P) < 0.03
    uv[gross] += rng.normal(size=(int(gross.sum()), 2)).astype(np.float32) * 30
    dR = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=(K, 3)).astype(np.float32) * 0.01)))
    R0 = np.where((np.arange(K) < 2)[:, None, None], R, dR @ R)
    t0 = np.where((np.arange(K) < 2)[:, None], t, t + rng.normal(size=(K, 3)).astype(np.float32) * 0.02)
    valid = np.arange(K) < K - 1
    return jba.BAProblem(
        R=jnp.asarray(R0.astype(np.float32)), t=jnp.asarray(t0.astype(np.float32)),
        cam_fixed=jnp.asarray(np.arange(K) < 2), cam_valid=jnp.asarray(valid),
        X=jnp.asarray(X + rng.normal(size=X.shape).astype(np.float32) * 0.03),
        pt_valid=jnp.asarray(np.arange(P) < P - 4),
        cam_idx=jnp.asarray(np.repeat(np.arange(K), P).astype(np.int32)),
        pt_idx=jnp.asarray(np.tile(np.arange(P), K).astype(np.int32)),
        uv=jnp.asarray(uv), inv_sigma2=jnp.asarray(1.2 ** (-2.0 * rng.integers(0, 4, K * P))),
        edge_valid=jnp.asarray((rng.random(K * P) < 0.9) & np.repeat(valid, P)),
        cam_params=jnp.asarray(CAM), ur=jnp.full((K * P,), -1.0), bf=jnp.zeros(()),
    )


@pytest.mark.parametrize("n_iters,n_cg", [(2, 50), (6, 20)])
def test_bundle_adjust_pcg_matches_jax(problem, n_iters, n_cg):
    """Poses within 1e-4 and points 99% within 1e-3 (all within 2e-2): the
    scatter-adds sum in another order than XLA's, which moves a landmark on
    a gross outlier near the Huber threshold by float32 round-off scaled by
    its conditioning; the inliers agree to within 2 edges."""
    want = jpcg.bundle_adjust_pcg(problem, n_iters=n_iters, n_cg=n_cg)
    got = tpcg.bundle_adjust_pcg(torch_ba_problem(problem), n_iters=n_iters, n_cg=n_cg)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-4)
    d = np.abs(got.X.numpy() - np.asarray(want.X)).max(axis=1)
    assert np.quantile(d, 0.99) < 1e-3 and d.max() < 2e-2
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-3)
    assert abs(int(got.n_inliers) - int(want.n_inliers)) <= 2
    np.testing.assert_array_equal(got.R[:2].numpy(), np.asarray(problem.R)[:2])


def test_bundle_adjust_pcg_agrees_with_the_dense_solver(problem):
    """The port's PCG and dense Schur solvers land near the same optimum,
    at ``test_ba_pcg.py``'s tolerances for the JAX package's pair (5e-3
    rad, 2e-2 m: ten LM iterations under Huber weights with 3% outliers
    do not converge to the bit)."""
    tp = torch_ba_problem(problem)
    rp = tpcg.bundle_adjust_pcg(tp, n_iters=10, n_cg=50)
    rd = tba.bundle_adjust(tp, n_iters=10)
    np.testing.assert_allclose(rp.R.numpy(), rd.R.numpy(), atol=5e-3)
    np.testing.assert_allclose(rp.t.numpy(), rd.t.numpy(), atol=2e-2)


def test_kb8_raises_naming_its_item(problem):
    # KB8 is ported (tests/test_torch_kb8.py holds its solve against the JAX
    # package); a camera model neither package has raises, naming the ones
    # there are.
    with pytest.raises(ValueError, match="kb8"):
        tpcg.bundle_adjust_pcg(torch_ba_problem(problem), n_iters=1, cam_model="double_sphere")


@pytest.fixture(scope="module")
def small_map():
    """A random map (K 8, N 24, P 64) with 6 live keyframes, some features
    and points invalid, and a perturbed copy of its poses and points as a
    solve's result."""
    rng = np.random.default_rng(2)
    Km, N, Pm = 8, 24, 64
    m = jms.empty_map(Km, N, Pm)
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=(Km, 3)).astype(np.float32) * 0.3)))
    obs = rng.integers(-1, Pm, (Km, N)).astype(np.int32)
    m = m._replace(
        kf_valid=jnp.asarray(np.arange(Km) < 6), kf_R=jnp.asarray(R),
        kf_t=jnp.asarray(rng.normal(size=(Km, 3)).astype(np.float32)),
        kf_xy=jnp.asarray(rng.uniform(0, 600, (Km, N, 2)).astype(np.float32)),
        kf_level=jnp.asarray(rng.integers(0, 8, (Km, N)).astype(np.int32)),
        kf_feat_valid=jnp.asarray(rng.random((Km, N)) < 0.9), kf_obs=jnp.asarray(obs),
        kf_ur=jnp.asarray(np.where(rng.random((Km, N)) < 0.3, 300.0, -1.0).astype(np.float32)),
        pt_valid=jnp.asarray(rng.random(Pm) < 0.9),
        pt_X=jnp.asarray(rng.normal(size=(Pm, 3)).astype(np.float32)),
        pt_first_kf=jnp.asarray(rng.integers(0, 6, Pm).astype(np.int32)),
        kf_v=jnp.asarray(rng.normal(size=(Km, 3)).astype(np.float32)),
        kf_bg=jnp.asarray(rng.normal(size=(Km, 3)).astype(np.float32) * 0.01),
        kf_ba=jnp.asarray(rng.normal(size=(Km, 3)).astype(np.float32) * 0.01),
    )
    dR = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=(Km, 3)).astype(np.float32) * 0.02)))
    res = jba.BAResult(
        R=jnp.asarray(dR @ R), t=m.kf_t + 0.01, X=m.pt_X + 0.02,
        chi2=jnp.zeros(Km * N), inlier=jnp.asarray(rng.random(Km * N) < 0.8),
        cost=jnp.zeros(()), n_inliers=jnp.zeros((), jnp.int32),
    )
    return m, res, rng


def _tres(res):
    d = np_tree(res)
    return tba.BAResult(**{k: T(v) for k, v in d.items()}, iters=0)


def _check_map(jm, tm, atol=1e-5):
    for f in jms.MapState._fields:
        want, got = np.asarray(getattr(jm, f)), getattr(tm, f).numpy()
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, atol=atol, err_msg=f)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("bf", [0.0, 40.0])
def test_build_global_ba_matches_jax(small_map, bf):
    m, _, _ = small_map
    want = jlm.build_global_ba(m, jnp.asarray(5), jnp.asarray(CAM), bf=jnp.asarray(bf))
    got = tlm.build_global_ba(torch_map(m), 5, T(CAM), bf=bf)
    for f in jba.BAProblem._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        np.testing.assert_allclose(g, w, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("with_obs0", [False, True])
def test_apply_global_ba_partial_matches_jax(small_map, with_obs0):
    """Snapshot at 4 keyframes; keyframes 4 and 5 and their points born
    during the solve; with ``kf_obs0`` some bindings changed meanwhile."""
    m, res, rng = small_map
    obs0 = np.asarray(m.kf_obs).copy()
    obs0[rng.random(obs0.shape) < 0.2] = -1
    kw = dict(kf_obs0=jnp.asarray(obs0)) if with_obs0 else {}
    want = jlm.apply_global_ba_partial(m, res, jnp.asarray(4, jnp.int32), **kw)
    got = tlm.apply_global_ba_partial(torch_map(m), _tres(res), 4,
                                      kf_obs0=T(obs0) if with_obs0 else None)
    _check_map(want, got)


def test_apply_global_ba_matches_jax(small_map):
    m, res, _ = small_map
    _check_map(jlm.apply_global_ba(m, res), tlm.apply_global_ba(torch_map(m), _tres(res)))


def test_apply_vi_gba_partial_matches_jax(small_map):
    """A window of the 4 snapshot keyframes padded with an empty slot."""
    m, _, rng = small_map
    calib = make_calib()
    wids = np.asarray([0, 1, 2, 3, 7], np.int32)
    W, N = len(wids), m.N
    R_wb, p_wb = jviba.body_from_cam(m.kf_R[wids], m.kf_t[wids], calib.R_bc, calib.t_bc)
    dR = jlie.so3_exp(jnp.asarray(rng.normal(size=(W, 3)).astype(np.float32) * 0.02))
    states = jviba.VIStates(R_wb=dR @ R_wb, p_wb=p_wb + 0.01, v_w=m.kf_v[wids] + 0.1,
                            bg=m.kf_bg[wids] + 1e-3, ba=m.kf_ba[wids] - 1e-3)
    res = jviba.VIBAResult(states=states, X=m.pt_X + 0.02, cost=jnp.zeros(()),
                           chi2_visual=jnp.zeros(W * N),
                           inlier=jnp.asarray(rng.random(W * N) < 0.8))
    obs0 = np.asarray(m.kf_obs).copy()
    obs0[rng.random(obs0.shape) < 0.2] = -1
    want = jlm.apply_vi_gba_partial(m, jnp.asarray(wids), res, calib, jnp.asarray(4, jnp.int32),
                                    kf_obs0=jnp.asarray(obs0))
    d = np_tree(res)
    tres = tviba.VIBAResult(states=tviba.VIStates(**{k: T(v) for k, v in d["states"].items()}),
                            X=T(d["X"]), cost=T(d["cost"]), chi2_visual=T(d["chi2_visual"]),
                            inlier=T(d["inlier"]))
    got = tlm.apply_vi_gba_partial(torch_map(m), T(wids), tres, torch_calib(calib), 4,
                                   kf_obs0=T(obs0))
    _check_map(want, got)
