"""The port's two-camera (non-rectified) ops against the JAX package:
``twocam.triangulate_cross_camera``, the body-frame residual,
``pose_optimization_two_cam`` and ``fisheye_stereo._twocam_refine``.

The inputs are ``tests/test_twocam.py``'s: the JAX package's features (800
a view) of one KB8 pair at 240x376 from ``make_room(seed=2)``, the right
camera 0.11 m along the left's x, and of the same pair rendered through a
pinhole with KB8's fx, fy, cx, cy for the pinhole branch; the port gets them
through ``tests/torch_parity.py``'s converters. Tolerances are stated where
they are compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.models import fisheye_stereo as jfs
from orb_slam3_ros_tpu.models import map_state as jms
from orb_slam3_ros_tpu.ops import cameras as jcam
from orb_slam3_ros_tpu.ops import lie as jlie
from orb_slam3_ros_tpu.ops import orb as jorb
from orb_slam3_ros_tpu.ops import twocam as jtwo
from orb_slam3_ros_tpu.utils import synth as jsynth
from orb_slam3_ros_tpu_torch.models import fisheye_stereo as tfs
from orb_slam3_ros_tpu_torch.ops import twocam as ttwo
from torch_cases import T
from torch_parity import np_tree, torch_cross, torch_features, torch_map

torch.set_num_threads(1)
KB8 = np.asarray([150.0, 150.0, 187.5, 119.5, 0.02, 0.001, -0.002, 0.0002], np.float32)
# the pinhole of the pinhole pair: KB8's fx, fy, cx, cy
PIN = np.asarray([150.0, 150.0, 187.5, 119.5, 0, 0, 0, 0, 0], np.float32)
CAMS = {"kb8": KB8, "pinhole": PIN}
H, W, BASELINE = 240, 376, 0.11
R_RL = np.eye(3, dtype=np.float32)
T_RL = np.asarray([-BASELINE, 0.0, 0.0], np.float32)  # X_r = X_l - b


@pytest.fixture(scope="module")
def pair():
    scene = jsynth.make_room(seed=2)
    R, t = jnp.eye(3), jnp.zeros(3)
    cfg = jorb.default_config(H, W, n_features=800)
    ext = jax.jit(lambda im: jorb.extract(im, cfg))
    out = {"cross": {}}
    for m, c in CAMS.items():
        img_l, depth = jsynth.render(scene, R, t, jnp.asarray(c), height=H, width=W, cam_model=m)
        img_r, _ = jsynth.render(scene, R, jnp.asarray([BASELINE, 0.0, 0.0]), jnp.asarray(c),
                                 height=H, width=W, cam_model=m)
        f_l, f_r = ext(img_l), ext(img_r)
        out["cross"][m] = jtwo.triangulate_cross_camera(
            f_l, f_r, jnp.asarray(R_RL), jnp.asarray(T_RL), jnp.asarray(c), jnp.asarray(c),
            cam_model=m)
        out[m] = dict(f_l=f_l, f_r=f_r)
        if m == "kb8":
            out.update(f_l=f_l, f_r=f_r, depth=np.asarray(depth))
    return out


def _port_cross(pair, model):
    return ttwo.triangulate_cross_camera(
        torch_features(pair[model]["f_l"]), torch_features(pair[model]["f_r"]), T(R_RL),
        T(T_RL), T(CAMS[model]), T(CAMS[model]), cam_model=model,
    )


@pytest.mark.parametrize("model", ["kb8", "pinhole"])
def test_triangulate_cross_camera_against_jax(pair, model):
    # The same matches (the dense Hamming search is exact), ok on 99.5% of
    # the features alike and n_new within 1 (the reprojection gates compare
    # float32 chi2s), the points both keep to 1e-3 of their depth.
    want, got = pair["cross"][model], _port_cross(pair, model)
    ok_w, ok_g = np.asarray(want.ok), got.ok.numpy()
    assert ok_w.sum() >= 80 and (ok_w == ok_g).mean() >= 0.995
    assert abs(int(got.n_new) - int(want.n_new)) <= 1
    np.testing.assert_array_equal(got.right_feat.numpy(), np.asarray(want.right_feat))
    both = ok_w & ok_g
    Xw, Xg = np.asarray(want.X_l)[both], got.X_l.numpy()[both]
    assert np.all(np.abs(Xg - Xw).max(-1) <= 1e-3 * np.maximum(1.0, Xw[:, 2]))


def test_cross_camera_points_are_metric(pair):
    # test_twocam.py's check on the port's points: the depth along each
    # ray against the rendered depth, median relative error under 12%.
    got = _port_cross(pair, "kb8")
    ok = got.ok.numpy()
    X = got.X_l.numpy()[ok]
    uv = np.asarray(jcam.kb8_project(KB8, X))
    xi = np.clip(uv[:, 0].round().astype(int), 0, W - 1)
    yi = np.clip(uv[:, 1].round().astype(int), 0, H - 1)
    rays = np.asarray(jcam.kb8_unproject(KB8, uv))
    rel = np.abs(X[:, 2] / rays[:, 2] - pair["depth"][yi, xi]) / pair["depth"][yi, xi]
    assert np.median(rel) < 0.12, np.median(rel)


def _edges(pair, model="kb8"):
    """test_twocam.py's mixed table: each cross point's left observation,
    then its right one (world = the left camera at the identity)."""
    cross = pair["cross"][model]
    X_l, ok = np.asarray(cross.X_l), np.asarray(cross.ok)
    N = X_l.shape[0]
    uv_r = np.asarray(pair["f_r"].xy)[np.asarray(cross.right_feat)]
    return dict(
        Xw=np.concatenate([X_l, X_l]).astype(np.float32),
        uv=np.concatenate([np.asarray(pair["f_l"].xy), uv_r]).astype(np.float32),
        is_right=np.concatenate([np.zeros(N, bool), np.ones(N, bool)]),
        valid=np.concatenate([ok, ok]), X_l=X_l.astype(np.float32), uv_r=uv_r.astype(np.float32),
        ok=ok,
    )


R0 = np.asarray(jlie.so3_exp(jnp.asarray([0.02, -0.015, 0.01]))).astype(np.float32)
T0 = np.asarray([0.04, -0.03, 0.05], np.float32)


def test_residual_jac_body_against_jax(pair):
    # Residuals [2] and Jacobians [2, 6] of every row, left and right, at a
    # perturbed pose: to 1e-3 of max(1, |x|) (KB8's Jacobian in closed form
    # against jax.jacfwd).
    e = _edges(pair)
    fn = jax.vmap(lambda X, u, ir: jtwo._residual_jac_body(
        jnp.asarray(R0), jnp.asarray(T0), X, u, ir, jnp.asarray(R_RL), jnp.asarray(T_RL),
        jnp.asarray(KB8), "kb8"))
    rw, Jw = (np.asarray(x) for x in fn(jnp.asarray(e["Xw"]), jnp.asarray(e["uv"]),
                                        jnp.asarray(e["is_right"])))
    rg, Jg = ttwo._residual_jac_body(T(R0), T(T0), T(e["Xw"]), T(e["uv"]), T(e["is_right"]),
                                     T(R_RL), T(T_RL), T(KB8), "kb8")
    v = e["valid"]
    assert np.all(np.abs(rg.numpy()[v] - rw[v]) <= 1e-3 * np.maximum(1.0, np.abs(rw[v])))
    assert np.all(np.abs(Jg.numpy()[v] - Jw[v]) <= 1e-3 * np.maximum(1.0, np.abs(Jw[v])))


@pytest.mark.parametrize("rows", ["mixed", "right_only"])
def test_pose_optimization_two_cam_against_jax(pair, rows):
    # test_twocam.py's two solves from a perturbed pose: the port's pose to
    # 1e-4 of the JAX package's, inliers within 2, and the pose recovered
    # (test_twocam.py's bounds: t under 5e-3 mixed, 1e-2 right only).
    e = _edges(pair)
    if rows == "mixed":
        args = (e["Xw"], e["uv"], e["is_right"], np.ones(len(e["uv"]), np.float32), e["valid"])
        bound = 5e-3
    else:
        n = len(e["X_l"])
        args = (e["X_l"], e["uv_r"], np.ones(n, bool), np.ones(n, np.float32), e["ok"])
        bound = 1e-2
    Xw, uv, is_right, inv_s2, valid = args
    want = jtwo.pose_optimization_two_cam(
        jnp.asarray(R0), jnp.asarray(T0), jnp.asarray(Xw), jnp.asarray(uv), jnp.asarray(is_right),
        jnp.asarray(R_RL), jnp.asarray(T_RL), jnp.asarray(inv_s2), jnp.asarray(valid),
        jnp.asarray(KB8))
    got = ttwo.pose_optimization_two_cam(T(R0), T(T0), T(Xw), T(uv), T(is_right), T(R_RL),
                                         T(T_RL), T(inv_s2), T(valid), T(KB8))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-4)
    assert abs(int(got.n_inliers) - int(want.n_inliers)) <= 2
    assert np.linalg.norm(got.t.numpy()) < bound


def test_twocam_refine_against_jax(pair):
    # The refinement over a map whose points are the cross points (slot i
    # for the i-th kept feature), from the perturbed pose: the port's pose
    # to 1e-4 of the JAX package's, inliers within 2. The cross match goes
    # to the port through torch_cross.
    cross = pair["cross"]["kb8"]
    ok = np.asarray(cross.ok)
    N = ok.shape[0]
    m = {k: np.array(v) for k, v in np_tree(jms.empty_map(4, N, 512)).items()}
    slots = np.nonzero(ok)[0][:512]
    m["pt_valid"][: len(slots)] = True
    m["pt_X"][: len(slots)] = np.asarray(cross.X_l)[slots]
    feat_pt = np.full(N, -1, np.int32)
    feat_pt[slots] = np.arange(len(slots), dtype=np.int32)
    jm = jms.MapState(**{k: jnp.asarray(v) for k, v in m.items()})
    uv_r = jnp.asarray(pair["f_r"].xy)[cross.right_feat]
    want = jfs._twocam_refine(jm, pair["f_l"], jnp.asarray(feat_pt), cross.ok, cross.right_feat,
                              uv_r, jnp.asarray(R0), jnp.asarray(T0), jnp.asarray(R_RL),
                              jnp.asarray(T_RL), jnp.asarray(KB8), "kb8")
    tc = torch_cross(cross)
    got = tfs._twocam_refine(torch_map(jm), torch_features(pair["f_l"]), T(feat_pt), tc.ok,
                             T(np.asarray(uv_r)), T(R0), T(T0), T(R_RL), T(T_RL), T(KB8), "kb8")
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-4)
    assert abs(int(got.n_inliers) - int(want.n_inliers)) <= 2 and int(want.n_inliers) >= 100
    assert tc.right_feat.dtype == torch.int32 and tc.n_new.shape == ()
