"""Parity of the PyTorch port's math substrate, renderer and ORB extraction
with the JAX package, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.ops import cameras as jcam
from orb_slam3_ros_tpu.ops import fast as jfast
from orb_slam3_ros_tpu.ops import lie as jlie
from orb_slam3_ros_tpu.ops import orb as jorb
from orb_slam3_ros_tpu.ops import pyramid as jpyr
from orb_slam3_ros_tpu.ops import robust as jrob
from orb_slam3_ros_tpu.ops import stereo as jstereo
from orb_slam3_ros_tpu.utils import synth as jsynth
from orb_slam3_ros_tpu_torch.ops import cameras as tcam
from orb_slam3_ros_tpu_torch.ops import fast as tfast
from orb_slam3_ros_tpu_torch.ops import lie as tlie
from orb_slam3_ros_tpu_torch.ops import orb as torb
from orb_slam3_ros_tpu_torch.ops import pyramid as tpyr
from orb_slam3_ros_tpu_torch.ops import robust as trob
from orb_slam3_ros_tpu_torch.ops import stereo as tstereo
from orb_slam3_ros_tpu_torch.utils import synth as tsynth
from torch_cases import T

torch.set_num_threads(1)

H, W = 120, 188
CAM = np.asarray([0.55 * W, 0.55 * W, (W - 1) / 2, (H - 1) / 2, 0, 0, 0, 0, 0], np.float32)


@pytest.fixture(scope="module")
def seq():
    return jsynth.make_sequence(n_frames=2, height=H, width=W, dt=0.1, seed=3, with_depth=True)


@pytest.fixture(scope="module")
def config():
    return jorb.default_config(H, W, n_features=300)


class TestMath:
    # float32 transcendental / summation-order differences: 1e-6 absolute
    # on O(1) values.
    def test_lie(self, rng):
        xi = (rng.normal(size=(64, 6)) * [1, 1, 1, 0.8, 0.8, 0.8]).astype(np.float32)
        xi[:4, 3:] *= 1e-5  # Taylor branch
        np.testing.assert_allclose(tlie.hat(T(xi[:, 3:])).numpy(), np.asarray(jlie.hat(xi[:, 3:])))
        np.testing.assert_allclose(
            tlie.so3_exp(T(xi[:, 3:])).numpy(), np.asarray(jlie.so3_exp(xi[:, 3:])), atol=1e-6
        )
        Rj, tj = jlie.se3_exp(xi)
        Rt, tt = tlie.se3_exp(T(xi))
        np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-6)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-6)
        # Two float32 SVD implementations (LAPACK via torch vs XLA's own)
        # agree to a few ulps of the O(1) entries: 1e-5.
        noisy = np.asarray(Rj) + rng.normal(size=(64, 3, 3)).astype(np.float32) * 1e-3
        np.testing.assert_allclose(
            tlie.normalize_rotation(T(noisy)).numpy(),
            np.asarray(jlie.normalize_rotation(noisy)), atol=1e-5,
        )

    def test_cameras_robust_backproject(self, rng):
        X = np.concatenate(
            [rng.normal(size=(50, 2)), rng.uniform(0.5, 5, size=(50, 1))], -1
        ).astype(np.float32)
        dist_cam = CAM.copy()
        dist_cam[4:7] = [0.01, -0.002, 0.001]
        for fn_t, fn_j, cam in (
            (tcam.pinhole_project, jcam.pinhole_project, dist_cam),
            (tcam.project_model, jcam.project_model, CAM),
            (tcam.project_jac_model, jcam.project_jac_model, CAM),
        ):
            np.testing.assert_allclose(
                fn_t(T(cam), T(X)).numpy(), np.asarray(fn_j(cam, X)), rtol=1e-6, atol=1e-4
            )
        uv = rng.uniform(-5, 200, size=(50, 2)).astype(np.float32)
        np.testing.assert_array_equal(
            tcam.in_image(T(uv), W, H, 2.0).numpy(), np.asarray(jcam.in_image(uv, W, H, 2.0))
        )
        # the KB8 branch of the dispatcher (tests/test_torch_kb8.py holds the
        # camera itself against the JAX package)
        kb8 = np.asarray([150.0, 150.0, 187.5, 119.5, 0.02, 0.001, -0.002, 0.0002], np.float32)
        np.testing.assert_allclose(
            tcam.project_model(T(kb8), T(X), "kb8").numpy(),
            np.asarray(jcam.project_model(kb8, X, "kb8")), rtol=1e-6, atol=1e-4,
        )
        chi2 = rng.uniform(0, 20, 100).astype(np.float32)
        np.testing.assert_allclose(
            trob.huber_weight(T(chi2), trob.CHI2_MONO).numpy(),
            np.asarray(jrob.huber_weight(chi2, jrob.CHI2_MONO)), rtol=1e-6,
        )
        d = rng.uniform(0.5, 6, 50).astype(np.float32)
        np.testing.assert_allclose(
            tstereo.backproject(T(CAM), T(uv), T(d)).numpy(),
            np.asarray(jstereo.backproject(CAM, uv, d)), rtol=1e-6, atol=1e-6,
        )

    def test_pack_and_expand(self, rng):
        bits = rng.random((40, 256)) < 0.5
        packed = torb.pack_bits(T(bits)).numpy().view(np.uint32)
        np.testing.assert_array_equal(packed, np.asarray(jorb.pack_bits(bits)))
        np.testing.assert_array_equal(
            torb.sign_expand(T(bits)).numpy(), np.asarray(jorb.sign_expand(bits))
        )
        np.testing.assert_array_equal(torb.PATTERN, jorb.PATTERN)


def test_render_matches_reference(seq):
    # Same textures and trajectory; float op order differs (einsum, ray
    # divisions), which moves a few bilinear samples by more than 1e-3 grey.
    ts = tsynth.make_sequence(n_frames=2, height=H, width=W, dt=0.1, seed=3, with_depth=True,
                              device="cpu")
    np.testing.assert_array_equal(ts.R_wc, seq.R_wc)
    np.testing.assert_array_equal(ts.cam_params, seq.cam_params)
    diff = np.abs(ts.images.numpy() - seq.images)
    assert (diff <= 1e-3).mean() >= 0.99
    assert diff.max() < 0.1
    np.testing.assert_allclose(ts.depths.numpy(), seq.depths, rtol=1e-5)


def test_pyramid_levels(seq):
    # jax.image.resize antialiases; F.interpolate(antialias=True) applies
    # the same triangle filter up to float rounding: 5e-3 grey.
    img = seq.images[0]
    jl = jpyr.build_pyramid(jnp.asarray(img), 8, 1.2)
    tl = tpyr.build_pyramid(T(img), 8, 1.2)
    assert [tuple(t.shape) for t in tl] == [tuple(j.shape) for j in jl]
    for j, t in zip(jl, tl):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=5e-3)


def _strip(img, config):
    """The JAX extractor's strip canvas, for stage-isolated tests."""
    M = jorb.PATCH_RAW - 19 + 2
    parts = []
    for lv in jpyr.build_pyramid(jnp.asarray(img), config.n_levels, config.scale):
        parts.append(jnp.pad(lv, ((M, config.height + M - lv.shape[0]), (M, M)), mode="edge"))
    return np.asarray(jnp.concatenate(parts, axis=1))


def test_fast_score_map(seq, config):
    # Corner masks are integer logic: exact. Scores are sums of 16 floats
    # in another order: 1e-6 relative (1e6 bump included).
    strip = _strip(seq.images[0], config)
    sj = np.asarray(jfast.score_map_combined(jnp.asarray(strip), 20.0, 7.0))
    st = tfast.score_map_combined(T(strip), 20.0, 7.0).numpy()
    np.testing.assert_array_equal(np.isfinite(st), np.isfinite(sj))
    fin = np.isfinite(sj)
    assert fin.sum() > 100
    np.testing.assert_allclose(st[fin], sj[fin], rtol=1e-6, atol=1e-3)


def test_select_grid_sets(seq, config):
    # Fed the same (JAX) score map, both select the same keypoint set.
    strip = _strip(seq.images[0], config)
    score = np.asarray(jfast.score_map_combined(jnp.asarray(strip), 20.0, 7.0))
    M = jorb.PATCH_RAW - 19 + 2
    h, w = config.level_shape(0)
    sc = score[M : M + h, M : M + w]
    ys, xs = np.mgrid[0:h, 0:w]
    inb = (ys >= 19) & (ys < h - 19) & (xs >= 19) & (xs < w - 19)
    cap, cell = config.caps[0], config.cell_size(0)
    xj, rj, vj = (np.asarray(a) for a in jfast.select_grid(jnp.asarray(sc), jnp.asarray(inb), cap, cell))
    xt, rt, vt = (a.numpy() for a in tfast.select_grid(T(sc), T(inb), cap, cell))
    assert vj.sum() == vt.sum() > 20
    assert set(map(tuple, xj[vj])) == set(map(tuple, xt[vt]))
    np.testing.assert_array_equal(np.sort(rt[vt]), np.sort(rj[vj]))


def test_extract_parity(seq, config):
    # Keypoints, levels and validity agree exactly; angles to float
    # rounding; descriptor bits may flip where a rotated test offset sits
    # on a rounding boundary: >= 98% of valid descriptors agree.
    img = seq.images[0]
    jf = jax.jit(jorb.extract, static_argnums=1)(jnp.asarray(img), config)
    tf = torb.extract(T(img), torb.default_config(H, W, n_features=300))
    jv = np.asarray(jf.valid)
    np.testing.assert_array_equal(tf.valid.numpy(), jv)
    assert jv.sum() > 100
    np.testing.assert_array_equal(tf.xy.numpy(), np.asarray(jf.xy))
    np.testing.assert_array_equal(tf.level.numpy(), np.asarray(jf.level))
    assert tf.level.dtype == torch.int32 and tf.desc_sign.dtype == torch.int8
    dang = np.angle(np.exp(1j * (tf.angle.numpy() - np.asarray(jf.angle))))[jv]
    assert np.abs(dang).max() < 1e-3
    same = np.all(tf.desc_sign.numpy()[jv] == np.asarray(jf.desc_sign)[jv], axis=1)
    assert same.mean() >= 0.98
    packed = torb.features_to_numpy(tf)["desc_packed"]
    assert (np.all(packed[jv] == np.asarray(jf.desc_packed)[jv], axis=1)).mean() >= 0.98
    np.testing.assert_array_equal(tf.desc_sign.numpy()[~jv], 0)
