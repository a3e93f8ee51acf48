"""Parity of the port's public helpers that no path of the port runs with
the JAX package's functions of the same module and name, on the same seeded
numpy inputs: one case a function. ``orb.extract_looped``, the JAX
package's per-level extractor that calls most of them, is not ported; its
pieces are (``fast``, ``pyramid``, ``orb``), with ``robust``'s other
kernels, ``hamming``'s packed distance, ``lie.se3_apply``,
``loop_closing.LoopCandidate`` and ``kf_work.keyframe_work_impl``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.models import loop_closing as jlc
from orb_slam3_ros_tpu.models import map_updates as jmu
from orb_slam3_ros_tpu.models import tracking as jtrk
from orb_slam3_ros_tpu.ops import fast as jfast
from orb_slam3_ros_tpu.ops import hamming as jham
from orb_slam3_ros_tpu.ops import lie as jlie
from orb_slam3_ros_tpu.ops import orb as jorb
from orb_slam3_ros_tpu.ops import pyramid as jpyr
from orb_slam3_ros_tpu.ops import robust as jrob
from orb_slam3_ros_tpu.utils import synth as jsynth
from orb_slam3_ros_tpu_torch.models import kf_work as tkf
from orb_slam3_ros_tpu_torch.models import loop_closing as tlc
from orb_slam3_ros_tpu_torch.models import tracking as ttrk
from orb_slam3_ros_tpu_torch.ops import fast as tfast
from orb_slam3_ros_tpu_torch.ops import hamming as tham
from orb_slam3_ros_tpu_torch.ops import lie as tlie
from orb_slam3_ros_tpu_torch.ops import orb as torb
from orb_slam3_ros_tpu_torch.ops import pyramid as tpyr
from orb_slam3_ros_tpu_torch.ops import robust as trob
from torch_cases import T
from torch_parity import jax_mapping_run, np_tree, torch_features, torch_map

torch.set_num_threads(1)

H, W = 120, 188


@pytest.fixture(scope="module")
def img():
    return jsynth.make_sequence(n_frames=2, height=H, width=W, dt=0.1, seed=3).images[0]


def _keypoints(img):
    """Level-0 keypoints of ``img`` by the JAX package's detector."""
    cfg = jorb.default_config(H, W, n_features=300)
    xy, _, valid = jfast.detect_grid(jnp.asarray(img), cfg.caps[0], cfg.cell_size(0))
    xy, valid = np.asarray(xy), np.asarray(valid)
    assert valid.sum() > 50
    return xy[valid]


def _wrapped(a, b):
    return np.abs(np.angle(np.exp(1j * (a - b))))


def _check_robust(name, rng):
    # Elementwise float32 arithmetic: to 1e-6 relative.
    chi2 = rng.uniform(0.0, 20.0, size=1000).astype(np.float32)
    np.testing.assert_allclose(getattr(trob, name)(T(chi2), 5.991).numpy(),
                               np.asarray(getattr(jrob, name)(jnp.asarray(chi2), 5.991)),
                               rtol=1e-6, atol=1e-7)


def check_cauchy_weight(rng, img):
    _check_robust("cauchy_weight", rng)


def check_tukey_weight(rng, img):
    _check_robust("tukey_weight", rng)


def check_fast_score_map(rng, img):
    # Corner masks are integer logic: equal. Scores are sums of 16 floats
    # in another order: 1e-6 relative.
    tc, ts_ = tfast.fast_score_map(T(img), 20.0)
    jc, js = jfast.fast_score_map(jnp.asarray(img), 20.0)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert np.asarray(jc).sum() > 50
    np.testing.assert_allclose(ts_.numpy(), np.asarray(js), rtol=1e-6, atol=1e-3)


def check_detect_grid(rng, img):
    # The same corners, one a cell: the same set of positions and responses
    # (tied cells may come in another order).
    cfg = jorb.default_config(H, W, n_features=300)
    xt, rt, vt = (a.numpy() for a in tfast.detect_grid(T(img), cfg.caps[0], cfg.cell_size(0)))
    xj, rj, vj = (np.asarray(a) for a in jfast.detect_grid(jnp.asarray(img), cfg.caps[0],
                                                           cfg.cell_size(0)))
    assert vt.sum() == vj.sum() > 50
    assert set(map(tuple, xt[vt])) == set(map(tuple, xj[vj]))
    np.testing.assert_allclose(np.sort(rt[vt]), np.sort(rj[vj]), rtol=1e-6)


def _words(rng, *shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def check_popcount32(rng, img):
    # Integer logic: equal (the port's words are int32 bit patterns).
    x = _words(rng, 64, 8)
    x[0, :3] = (0, 0xFFFFFFFF, 0x80000000)
    np.testing.assert_array_equal(tham.popcount32(T(x.view(np.int32))).numpy(),
                                  np.asarray(jham.popcount32(jnp.asarray(x))))


def check_hamming_packed(rng, img):
    a, b = _words(rng, 50, 8), _words(rng, 50, 8)
    got = tham.hamming_packed(T(a.view(np.int32)), T(b.view(np.int32))).numpy()
    np.testing.assert_array_equal(got, np.asarray(jham.hamming_packed(jnp.asarray(a),
                                                                      jnp.asarray(b))))


def check_gaussian_blur(rng, img):
    # Seven-tap sums of grey levels in another order: 1e-3 grey.
    np.testing.assert_allclose(tpyr.gaussian_blur(T(img)).numpy(),
                               np.asarray(jpyr.gaussian_blur(jnp.asarray(img))), atol=1e-3)


def check_gaussian_blur_batched(rng, img):
    stack = np.stack([img, img[::-1].copy(), rng.uniform(0, 255, img.shape).astype(np.float32)])
    np.testing.assert_allclose(tpyr.gaussian_blur_batched(T(stack), 5, 1.5).numpy(),
                               np.asarray(jpyr.gaussian_blur_batched(jnp.asarray(stack), 5, 1.5)),
                               atol=1e-3)


def check_conv2d_same(rng, img):
    # A 5x7 correlation of grey levels: 1e-5 relative to the largest output.
    k = rng.normal(size=(5, 7)).astype(np.float32)
    got = tpyr.conv2d_same(T(img), T(k)).numpy()
    want = np.asarray(jpyr.conv2d_same(jnp.asarray(img), jnp.asarray(k)))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def check_orientation_maps(rng, img):
    # 961-tap moment sums of grey levels: 1e-5 relative to the largest.
    for got, want in zip(torb.orientation_maps(T(img)), jorb.orientation_maps(jnp.asarray(img))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max())


def check_angles_at_dense(rng, img):
    # Angles to float rounding (test_torch_features.py's 1e-3).
    xy = _keypoints(img)
    got = torb.angles_at_dense(T(img), T(xy)).numpy()
    assert _wrapped(got, np.asarray(jorb.angles_at_dense(jnp.asarray(img), jnp.asarray(xy)))).max() < 1e-3


def check_angles_at(rng, img):
    # Keypoints off the border too: their patches are clamped alike.
    xy = np.concatenate([_keypoints(img), [[2.0, 3.0], [W - 1.0, H - 2.0]]]).astype(np.float32)
    got = torb.angles_at(T(img), T(xy)).numpy()
    assert _wrapped(got, np.asarray(jorb.angles_at(jnp.asarray(img), jnp.asarray(xy)))).max() < 1e-3


def check_compute_descriptors(rng, img):
    # The same blurred image, keypoints and angles: a bit flips only where a
    # rotated test offset sits on a rounding boundary (test_torch_features.py:
    # >= 98% of descriptors agree); samples off the image clamp alike.
    xy = np.concatenate([_keypoints(img), [[1.0, 1.0]]]).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, size=len(xy)).astype(np.float32)
    blurred = np.asarray(jpyr.gaussian_blur(jnp.asarray(img)))
    got = torb.compute_descriptors(T(blurred), T(xy), T(ang)).numpy()
    want = np.asarray(jorb.compute_descriptors(jnp.asarray(blurred), jnp.asarray(xy),
                                               jnp.asarray(ang)))
    assert got.shape == want.shape == (len(xy), 256) and got.dtype == bool
    assert np.all(got == want, axis=1).mean() >= 0.98


def check_se3_apply(rng, img):
    # A batch of poses broadcast over point batches: 1e-5 on O(1) values.
    R = np.asarray(jlie.so3_exp(rng.normal(size=(6, 1, 3)).astype(np.float32)))
    t = rng.normal(size=(6, 1, 3)).astype(np.float32)
    x = rng.normal(size=(6, 40, 3)).astype(np.float32)
    np.testing.assert_allclose(tlie.se3_apply(T(R), T(t), T(x)).numpy(),
                               np.asarray(jlie.se3_apply(R, t, x)), atol=1e-5)


def check_loop_candidate(rng, img):
    assert tlc.LoopCandidate._fields == jlc.LoopCandidate._fields
    vals = (3, 1.02, np.eye(3, dtype=np.float32), np.ones(3, np.float32), 41)
    t, j = tlc.LoopCandidate(*vals), jlc.LoopCandidate(*vals)
    assert all(a is b for a, b in zip(t, j)) and t.cand_kf == 3 and t.n_inliers == 41


def check_keyframe_work_impl(rng, img):
    """The last keyframe step of the JAX package's 14-frame mapping run
    (``test_torch_mapping.py``'s map: 240x376, seed 3) from its own inputs,
    the JAX package's triangulation fed to both, under that file's
    ``test_keyframe_work`` tolerances: integer and bool fields equal, poses
    to 1e-4, landmark geometry 99% to 1e-4 relative and all to 2e-3."""
    from test_torch_mapping import N_FRAMES, SLAM_KW, assert_map_equal

    seq = jsynth.make_sequence(n_frames=N_FRAMES, height=240, width=376, dt=0.1, seed=3)
    _, calls = jax_mapping_run(seq, N_FRAMES, **SLAM_KW)
    args, kw, (jm, nj) = calls[-1]
    m0, kf, R, t, ts, feats, feat_pt, n_pts, room, cam, bf = args
    assert kw["do_fuse"] and kw["do_cull"]
    jtri = ttrk.TriangulationResult(*(T(np.asarray(x)) for x in jtrk.triangulate_with_ref(
        jmu.insert_keyframe(m0, kf, R, t, ts, feats, feat_pt), kf, kf - 1, cam)))
    kw = {k: v for k, v in kw.items() if k != "row_n"}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrk, "triangulate_with_ref", lambda *a, **k: jtri)
        tm, nt = tkf.keyframe_work_impl(
            torch_map(m0), int(kf), T(np.asarray(R)), T(np.asarray(t)), float(ts),
            torch_features(feats), T(np.asarray(feat_pt)), int(n_pts), int(room), T(cam),
            float(bf), **kw)
    assert int(nt) == int(nj) > 0
    assert_map_equal(tm, jm, fields={"kf_R", "kf_t"}, float_tol=1e-4)
    assert_map_equal(tm, jm, fields=set(np_tree(jm)) - {"kf_R", "kf_t"}, solved=True)


CASES = {
    "robust.cauchy_weight": check_cauchy_weight, "robust.tukey_weight": check_tukey_weight,
    "fast.fast_score_map": check_fast_score_map, "fast.detect_grid": check_detect_grid,
    "hamming.popcount32": check_popcount32, "hamming.hamming_packed": check_hamming_packed,
    "pyramid.gaussian_blur": check_gaussian_blur,
    "pyramid.gaussian_blur_batched": check_gaussian_blur_batched,
    "pyramid.conv2d_same": check_conv2d_same, "orb.orientation_maps": check_orientation_maps,
    "orb.angles_at_dense": check_angles_at_dense, "orb.angles_at": check_angles_at,
    "orb.compute_descriptors": check_compute_descriptors, "lie.se3_apply": check_se3_apply,
    "loop_closing.LoopCandidate": check_loop_candidate,
    "kf_work.keyframe_work_impl": check_keyframe_work_impl,
}


@pytest.mark.parametrize("name", list(CASES))
def test_helper_matches_jax(name, rng, img):
    CASES[name](rng, img)
