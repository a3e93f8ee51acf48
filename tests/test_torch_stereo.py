"""The port's stereo and RGB-D stages against the JAX package's, fed the
same inputs: ``ops/stereo.py::match_stereo`` on the JAX package's features
and images (and on planted cases: keypoints on every border, SAD minima at
the slide window's edges, the mutual check), ``pose_optimization_stereo``
over mixed mono / stereo edges with planted outliers, keyframe insertion
with ``ur``, the capture-safe ``admit_depth_points``,
the RGB-D front end's ``depth_to_match``, and the synthetic right view and VI depth
against the JAX renderer. Tolerances are stated where they are compared.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.models import map_updates as jmu
from orb_slam3_ros_tpu.models.stereo_system import RgbdSlam as JaxRgbdSlam
from orb_slam3_ros_tpu.ops import orb as jorb
from orb_slam3_ros_tpu.ops import pose_opt as jpo
from orb_slam3_ros_tpu.ops import stereo as jst
from orb_slam3_ros_tpu.utils import synth as jsynth
from orb_slam3_ros_tpu_torch.models import map_updates as tmu
from orb_slam3_ros_tpu_torch.models.front_end_program import depth_to_match
from orb_slam3_ros_tpu_torch.ops import pose_opt as tpo
from orb_slam3_ros_tpu_torch.ops import stereo as tst
from orb_slam3_ros_tpu_torch.utils import synth as tsynth
from torch_cases import T
from torch_parity import np_tree, torch_features, torch_map

torch.set_num_threads(1)
H, W, BASELINE, N_FEATURES = 240, 376, 0.12, 800


@pytest.fixture(scope="module")
def seq():
    return jsynth.make_sequence(n_frames=3, height=H, width=W, dt=0.1, seed=3,
                                stereo_baseline=BASELINE, with_depth=True)


@pytest.fixture(scope="module")
def extracted(seq):
    """Both views' JAX features of frames 0, 1 and 2."""
    cfg = jorb.default_config(H, W, n_features=N_FEATURES)
    return {i: (jorb.extract(jnp.asarray(seq.images[i]), cfg),
                jorb.extract(jnp.asarray(seq.images_right[i]), cfg)) for i in (0, 1, 2)}


def _both(fl, fr, il, ir, fx, baseline):
    """(JAX StereoMatch as numpy, the port's as numpy) on the same inputs;
    ``fl`` / ``fr``: JAX Features."""
    j = jst.match_stereo(fl, fr, jnp.asarray(il), jnp.asarray(ir), fx=fx, baseline=baseline)
    t = tst.match_stereo(torch_features(fl), torch_features(fr), T(il), T(ir), fx=fx,
                         baseline=baseline)
    return ({k: np.asarray(v) for k, v in j._asdict().items()},
            {k: v.numpy() for k, v in t._asdict().items()})


# ---- match_stereo on the JAX package's features of rendered pairs ----
# Valid sets >= 99% alike (measured: equal, 330-366 matches a frame);
# u_right within 1e-3 px and depth within 1e-4 relative on the common set
# (measured 3.1e-5 px and 4.7e-6: the SAD sums in another order).
@pytest.mark.parametrize("frame", [0, 1, 2])
def test_match_stereo_against_jax(seq, extracted, frame):
    fl, fr = extracted[frame]
    j, t = _both(fl, fr, seq.images[frame], seq.images_right[frame], float(seq.cam_params[0]),
                 BASELINE)
    assert j["valid"].sum() > 100
    assert (j["valid"] == t["valid"]).mean() >= 0.99
    both = j["valid"] & t["valid"]
    assert np.abs(j["u_right"][both] - t["u_right"][both]).max() <= 1e-3
    assert (np.abs(j["depth"][both] - t["depth"][both]) / j["depth"][both]).max() <= 1e-4
    # invalid entries carry -1 in both
    assert np.all(t["u_right"][~t["valid"]] == -1) and np.all(t["depth"][~t["valid"]] == -1)


def test_match_stereo_depth_against_rendered_depth(seq, extracted):
    # The JAX test's bounds (test_stereo.py::test_depth_against_ground_truth):
    # median relative error under 5%, 80% of matches within 15%.
    fl, fr = extracted[0]
    t = tst.match_stereo(torch_features(fl), torch_features(fr), T(seq.images[0]),
                         T(seq.images_right[0]), fx=float(seq.cam_params[0]), baseline=BASELINE)
    valid = t.valid.numpy()
    xy = np.asarray(fl.xy)[valid]
    d_gt = seq.depths[0][np.clip(xy[:, 1].astype(int), 0, H - 1), np.clip(xy[:, 0].astype(int), 0, W - 1)]
    rel = np.abs(t.depth.numpy()[valid] - d_gt) / d_gt
    assert np.median(rel) < 0.05 and (rel < 0.15).mean() > 0.8


# ---- planted cases ----
def _planted(rng, xl, yl, xr, level=None, h=64, w=96, shift=None):
    """Features for left keypoints (xl, yl) and right keypoints (xr, yl)
    with one random descriptor per pair, and random images, the right one
    the left shifted by ``shift`` px (a rectified pair of disparity
    ``shift``) where given. Returns (JAX left, JAX right, il, ir)."""
    n = len(xl)
    level = np.zeros(n, np.int32) if level is None else np.asarray(level, np.int32)
    sign = (1 - 2 * (rng.random((n, 256)) < 0.5)).astype(np.int8)

    def feats(x):
        return jorb.Features(
            xy=jnp.asarray(np.stack([x, yl], 1).astype(np.float32)), level=jnp.asarray(level),
            angle=jnp.zeros(n), response=jnp.ones(n), desc_packed=jnp.zeros((n, 8), jnp.uint32),
            desc_sign=jnp.asarray(sign), valid=jnp.ones(n, bool),
        )

    il = rng.uniform(0, 255, (h, w)).astype(np.float32)
    if shift is None:
        ir = rng.uniform(0, 255, (h, w)).astype(np.float32)
    else:  # right(x) = left(x + shift)
        ir = np.concatenate([il[:, shift:], rng.uniform(0, 255, (h, shift))], 1).astype(np.float32)
    return feats(np.asarray(xl, np.float32)), feats(np.asarray(xr, np.float32)), il, ir


def test_match_stereo_border_keypoints(rng):
    # Keypoints on each border: the clips move the 11x11 patch and the 11x21
    # strip inside the image, where JAX's dynamic_slice would clamp them;
    # the port must read the same pixels. Equal outputs (u_right to 1e-4 px).
    h, w = 64, 96
    xl = np.array([0.0, 0.4, 3.0, 95.0, 94.6, 50.0, 50.0, 12.0, 60.0, 95.0, 0.0])
    yl = np.array([30.0, 5.0, 0.0, 40.0, 63.0, 0.0, 63.0, 62.7, 1.0, 0.0, 63.0])
    xr = np.clip(xl - np.array([0.0, 0.4, 2.0, 4.0, 8.0, 6.0, 3.0, 1.0, 12.0, 30.0, 0.0]), 0, w - 1)
    fl, fr, il, ir = _planted(rng, xl, yl, xr, h=h, w=w)
    j, t = _both(fl, fr, il, ir, fx=80.0, baseline=0.1)
    np.testing.assert_array_equal(t["valid"], j["valid"])
    np.testing.assert_allclose(t["u_right"], j["u_right"], atol=1e-4)
    np.testing.assert_allclose(t["depth"], j["depth"], rtol=1e-5)


@pytest.mark.parametrize("offset,k,kept", [(5, 0, False), (-5, 10, False), (0, 5, True),
                                           (2, 3, True)])
def test_match_stereo_edge_minimum(rng, offset, k, kept):
    # A rectified pair of disparity 8 px; the right keypoint placed
    # ``offset`` px right of the true match puts the SAD minimum at shift k
    # = 5 - offset: at the slide window's edge (k = 0 or 10) the match is
    # rejected (the reference's bestincR == +-L), inside it is kept at the
    # true disparity (within half a pixel: the parabola through a noise
    # texture's SAD is not symmetric; measured 0.22 px).
    D = 8
    xl = np.array([40.0, 52.0, 61.0])
    yl = np.array([20.0, 33.0, 41.0])
    fl, fr, il, ir = _planted(rng, xl, yl, xl - D + offset, shift=D)
    j, t = _both(fl, fr, il, ir, fx=80.0, baseline=0.1)
    np.testing.assert_array_equal(t["valid"], j["valid"])
    assert t["valid"].all() == kept
    if kept:
        np.testing.assert_allclose(t["u_right"], xl - D, atol=0.5)
        np.testing.assert_allclose(t["u_right"], j["u_right"], atol=1e-4)


def test_match_stereo_mutual_check(rng):
    # Two left keypoints with one descriptor, one right keypoint: both rows
    # pick it, the column picks the first row (argmin's first minimum), and
    # the second row's match is dropped.
    fl, fr, il, ir = _planted(rng, [40.0, 44.0], [20.0, 20.5], [32.0, 36.0], shift=8)
    fr = fr._replace(desc_sign=fr.desc_sign.at[1].set(-fr.desc_sign[1]))  # right 1 matches nothing
    fl = fl._replace(desc_sign=fl.desc_sign.at[1].set(fl.desc_sign[0]))
    j, t = _both(fl, fr, il, ir, fx=80.0, baseline=0.1)
    np.testing.assert_array_equal(t["valid"], j["valid"])
    assert not t["valid"][1]


# ---- pose_optimization_stereo ----
def _pose_case(seed):
    """Points in front of a camera, observed with noise; 40% monocular
    edges (ur = -1), 10% outliers of up to 40 px, 5% invalid edges, and the
    pose perturbed by ~2 degrees and ~8 cm."""
    rng = np.random.default_rng(seed)
    n = 400
    cam = np.array([206.8, 206.8, 187.5, 119.5, 0, 0, 0, 0, 0], np.float32)
    Xc = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(1.5, 8, n)], 1)
    uv = cam[:2] * Xc[:, :2] / Xc[:, 2:] + cam[2:4]
    bf = float(cam[0]) * BASELINE
    ur = uv[:, 0] - bf / Xc[:, 2]
    ur[rng.random(n) < 0.4] = -1
    uv = uv + rng.normal(0, 0.7, uv.shape)
    out = rng.random(n) < 0.1
    uv[out] += rng.uniform(-40, 40, (out.sum(), 2))
    lvl = rng.integers(0, 4, n)
    th = 0.035
    R0 = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(R0=f32(R0), t0=f32([0.05, -0.03, 0.08]), Xw=f32(Xc), uv=f32(uv), ur=f32(ur), bf=bf,
                inv_sigma2=f32(1.2 ** (-2.0 * lvl)), valid=rng.random(n) < 0.95, cam=cam)


# R and t within 2e-5 (measured 1.3e-6 and 5.8e-6 at seed 0), inlier sets
# equal.
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pose_optimization_stereo_against_jax(seed):
    c = _pose_case(seed)
    order = ("R0", "t0", "Xw", "uv", "ur")
    rj = jpo.pose_optimization_stereo(
        *(jnp.asarray(c[k]) for k in order), jnp.asarray(c["bf"], jnp.float32),
        jnp.asarray(c["inv_sigma2"]), jnp.asarray(c["valid"]), jnp.asarray(c["cam"]))
    rt = tpo.pose_optimization_stereo(*(T(c[k]) for k in order), c["bf"], T(c["inv_sigma2"]),
                                      T(c["valid"]), T(c["cam"]))
    assert np.abs(np.asarray(rj.R) - rt.R.numpy()).max() <= 2e-5
    assert np.abs(np.asarray(rj.t) - rt.t.numpy()).max() <= 2e-5
    np.testing.assert_array_equal(rt.inlier.numpy(), np.asarray(rj.inlier))
    assert int(rt.n_inliers) == int(rj.n_inliers) > 250
    # the planted outliers are out
    assert np.abs(rt.R.numpy() - np.eye(3)).max() < 1e-3 and np.abs(rt.t.numpy()).max() < 1e-2


def test_pose_optimization_stereo_all_mono_is_the_mono_edge(rng):
    # With every edge monocular the u_r rows are zero: the stereo solve is
    # the (u, v) solve at the same gates: R, t within 2e-5 of
    # pose_optimization at the stereo solve's 2 x 6 ladder (measured 8.7e-7
    # and 4.1e-6: the normal equations sum the zero rows in), inliers equal.
    c = _pose_case(3)
    ur = np.full_like(c["ur"], -1.0)
    args = (T(c["R0"]), T(c["t0"]), T(c["Xw"]), T(c["uv"]))
    st = tpo.pose_optimization_stereo(*args, T(ur), c["bf"], T(c["inv_sigma2"]), T(c["valid"]),
                                      T(c["cam"]))
    mono = tpo.pose_optimization(*args, T(c["inv_sigma2"]), T(c["valid"]), T(c["cam"]),
                                 rounds=2, iters_per_round=6)
    assert torch.allclose(st.R, mono.R, atol=2e-5) and torch.allclose(st.t, mono.t, atol=2e-5)
    assert torch.equal(st.inlier, mono.inlier)


# ---- the map: insertion with ur, depth points ----
@pytest.fixture(scope="module")
def small_map():
    from orb_slam3_ros_tpu.models import map_state as jms

    return jms.empty_map(4, 64, 128)


def _feats(rng, n):
    return jorb.Features(
        xy=jnp.asarray(rng.uniform(0, 300, (n, 2)).astype(np.float32)),
        level=jnp.asarray(rng.integers(0, 8, n).astype(np.int32)), angle=jnp.zeros(n),
        response=jnp.ones(n), desc_packed=jnp.zeros((n, 8), jnp.uint32),
        desc_sign=jnp.asarray((1 - 2 * (rng.random((n, 256)) < 0.5)).astype(np.int8)),
        valid=jnp.asarray(rng.random(n) < 0.9),
    )


@pytest.mark.parametrize("with_ur", [True, False])
def test_insert_keyframe_with_ur(small_map, rng, with_ur):
    f = _feats(rng, 64)
    ur = np.where(rng.random(64) < 0.5, rng.uniform(0, 300, 64), -1.0).astype(np.float32)
    R, t, pt = np.eye(3, dtype=np.float32), np.float32([0.1, 0, 0]), np.full(64, -1, np.int32)
    jm = jmu.insert_keyframe(small_map, jnp.asarray(2), jnp.asarray(R), jnp.asarray(t),
                             jnp.asarray(1.5, jnp.float32), f, jnp.asarray(pt),
                             ur=jnp.asarray(ur) if with_ur else None)
    tm = tmu.insert_keyframe(torch_map(small_map), 2, T(R), T(t), 1.5, torch_features(f), T(pt),
                             ur=T(ur) if with_ur else None)
    for k, v in np_tree(jm).items():
        np.testing.assert_array_equal(getattr(tm, k).numpy(), v, err_msg=k)
    assert (tm.kf_ur[2].numpy() == (ur if with_ur else -1.0)).all()


def test_admit_depth_points_takes_device_scalars(small_map, rng):
    # The chunk's keyframe body passes the keyframe id, the base slot and
    # the room as 0-d tensors: the same map as with ints, and as JAX's.
    f = _feats(rng, 64)
    pt = np.where(rng.random(64) < 0.3, rng.integers(0, 20, 64), -1).astype(np.int32)
    jm = jmu.insert_keyframe(small_map, jnp.asarray(1), jnp.eye(3), jnp.zeros(3),
                             jnp.asarray(0.0), f, jnp.asarray(pt))
    X = rng.normal(0, 2, (64, 3)).astype(np.float32)
    cand = rng.random(64) < 0.7
    jm2, nj = jmu.admit_depth_points(jm, jnp.asarray(1), jnp.asarray(X), jnp.asarray(cand),
                                     jnp.asarray(20), jnp.asarray(15))
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    a, na = tmu.admit_depth_points(torch_map(jm), 1, T(X), T(cand), 20, 15)
    b, nb = tmu.admit_depth_points(torch_map(jm), i32(1), T(X), T(cand), i32(20), i32(15))
    assert int(na) == int(nb) == int(nj) == 15
    for k, v in np_tree(jm2).items():
        np.testing.assert_array_equal(getattr(a, k).numpy(), v, err_msg=k)
        np.testing.assert_array_equal(getattr(b, k).numpy(), v, err_msg=k)


def test_depth_to_match_against_jax(seq, extracted):
    # The virtual right coordinate u_r = u - bf / d of RGB-D (bf of the 5 cm
    # virtual baseline), with depth holes (d = 0) and features off the map's
    # edge clipped: valid sets equal, u_r within 1e-4 px.
    fl, _ = extracted[0]
    dm = seq.depths[0].copy()
    dm[100:140, 150:250] = 0.0  # a hole
    bf = float(seq.cam_params[0]) * 0.05
    j = JaxRgbdSlam._depth_to_match(SimpleNamespace(bf=bf), fl, jnp.asarray(dm))
    t = depth_to_match(torch_features(fl), T(dm), bf)
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    assert (~t.valid.numpy() & np.asarray(fl.valid)).sum() > 10  # the hole took some
    np.testing.assert_allclose(t.u_right.numpy(), np.asarray(j.u_right), atol=1e-4)
    np.testing.assert_array_equal(t.depth.numpy(), np.asarray(j.depth))


# ---- the synthetic right view and VI depth ----
# test_torch_features.py::test_render_matches_reference's tolerance: 99% of
# pixels within 1e-3 grey, none beyond 0.1; depth to 1e-5 relative.
def _close_render(t_img, j_img):
    diff = np.abs(t_img - j_img)
    assert (diff <= 1e-3).mean() >= 0.99 and diff.max() < 0.1


def test_synth_right_view_matches_reference(seq):
    ts = tsynth.make_sequence(n_frames=2, height=H, width=W, dt=0.1, seed=3,
                              stereo_baseline=BASELINE, device="cpu")
    assert ts.baseline == BASELINE and ts.images_right.shape == (2, H, W)
    _close_render(ts.images_right.numpy(), seq.images_right[:2])


def test_synth_vi_right_view_and_depth_match_reference():
    # test_torch_vi_mapping.py::test_make_vi_sequence_matches_jax's bound:
    # the poses are float64 here, float32 there; the views within 0.05 grey.
    kw = dict(n_frames=2, height=H, width=W, frame_dt=0.1, imu_per_frame=10, seed=0,
              stereo_baseline=0.11, with_depth=True)
    jseq, jimu = jsynth.make_vi_sequence(**kw)
    tseq, timu = tsynth.make_vi_sequence(**kw, device="cpu")
    assert np.abs(tseq.images_right.numpy() - jseq.images_right).max() <= 0.05
    np.testing.assert_allclose(tseq.depths.numpy(), jseq.depths, rtol=1e-4)
    np.testing.assert_allclose(timu["acc"], jimu["acc"], atol=1e-4)
