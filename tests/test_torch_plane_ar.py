"""The port's plane detection (``ops/plane.py``), AR overlay
(``utils/ar.py``) and map drawing (``utils/viz.py``) against the JAX
package's.

``detect_plane_from_samples`` is fed the JAX package's hypothesis samples
(``jax.random.categorical`` with the same key): the normal (up to sign)
and ``d`` within 1e-5, the inlier set, its count and ``ok`` equal, on
``tests/test_ar.py``'s synthetic plane (70% of points on a plane), on its
unstructured cloud, and with a third of the points invalid. The NaN
median equals ``jnp.nanmedian`` (exact; even and odd counts). The cube's
vertices equal JAX's to 1e-5 and its drawing pixel for pixel. ``ARDemo``
finds the room's wall on a port map seeded from rendered depth and draws
the cube; ``draw_map`` and ``draw_tracking`` write PNGs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.ops import lie as jlie
from orb_slam3_ros_tpu.ops import plane as jplane
from orb_slam3_ros_tpu.utils import ar as jar
from orb_slam3_ros_tpu_torch.models import system as tsys
from orb_slam3_ros_tpu_torch.ops import plane as tplane
from orb_slam3_ros_tpu_torch.utils import ar as tar
from orb_slam3_ros_tpu_torch.utils import synth

torch.set_num_threads(1)


def _plane_cloud(n=400, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, n).astype(np.float32)
    y = rng.uniform(-2, 2, n).astype(np.float32)
    X = np.stack([x, y, 2.0 + 0.3 * x - 0.2 * y], -1)
    is_out = rng.uniform(size=n) < 0.3
    X[is_out] = rng.uniform(-3, 3, (n, 3)).astype(np.float32)[is_out]
    return X, np.ones(n, bool)


def _cases():
    X, v = _plane_cloud()
    rng = np.random.default_rng(3)
    partial = rng.uniform(size=len(X)) > 0.33
    cloud = np.random.default_rng(1).uniform(-2, 2, (300, 3)).astype(np.float32)
    return {
        "plane": (X, v, 0, {}),
        "plane_partly_invalid": (X, partial, 0, {}),
        "unstructured": (cloud, np.ones(300, bool), 1, dict(min_inlier_frac=0.5)),
    }


@pytest.mark.parametrize("name", list(_cases()))
def test_detect_plane_on_the_jax_samples(name):
    X, valid, seed, kw = _cases()[name]
    key = jax.random.PRNGKey(seed)
    want = jax.device_get(jplane.detect_plane(jnp.asarray(X), jnp.asarray(valid), key, **kw))
    # the JAX package's draw (plane.py:48-49)
    logits = jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)
    idx = np.asarray(jax.random.categorical(key, logits[None, :], shape=(128, 3)))
    got = tplane.detect_plane_from_samples(torch.from_numpy(X), torch.from_numpy(valid),
                                           torch.from_numpy(idx), **kw)
    assert bool(got.ok) == bool(want.ok) == (name != "unstructured")
    sign = 1.0 if float(np.dot(got.normal.numpy(), want.normal)) > 0 else -1.0
    np.testing.assert_allclose(sign * got.normal.numpy(), want.normal, atol=1e-5)
    np.testing.assert_allclose(sign * float(got.d), float(want.d), atol=1e-5)
    np.testing.assert_array_equal(got.inlier.numpy(), np.asarray(want.inlier))
    assert int(got.n_inliers) == int(want.n_inliers)
    np.testing.assert_allclose(got.anchor.numpy(), want.anchor, atol=1e-5)
    if name == "plane":
        n_true = np.array([-0.3, 0.2, 1.0]) / np.linalg.norm([-0.3, 0.2, 1.0])
        assert abs(float(got.normal.numpy() @ n_true)) > 0.99


def test_detect_plane_draws_with_a_generator():
    X, valid = _plane_cloud()
    g = torch.Generator().manual_seed(5)
    res = tplane.detect_plane(torch.from_numpy(X), torch.from_numpy(valid), g)
    idx = tplane.sample_hypotheses(torch.from_numpy(valid), torch.Generator().manual_seed(5))
    again = tplane.detect_plane_from_samples(torch.from_numpy(X), torch.from_numpy(valid), idx)
    assert bool(res.ok) and torch.equal(res.inlier, again.inlier)
    # invalid points are never drawn
    part = torch.from_numpy(valid.copy())
    part[::2] = False
    assert bool(part[tplane.sample_hypotheses(part, g, 64)].all())


@pytest.mark.parametrize("n", [1, 2, 7, 8])
def test_nanmedian_equals_jax(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    x[rng.uniform(size=(n, 3)) < 0.3] = np.nan
    x[:, 2] = np.nan  # an all-NaN column
    got = tplane._nanmedian(torch.from_numpy(x), 0).numpy()
    want = np.asarray(jnp.nanmedian(jnp.asarray(x), axis=0))
    np.testing.assert_array_equal(got, want)


def _pose(seed):
    rng = np.random.default_rng(seed)
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=3).astype(np.float32) * 0.2)))
    return R, np.asarray([0.1, -0.2, 4.0], np.float32) + rng.normal(size=3).astype(np.float32) * 0.1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cube_vertices_and_drawing_equal_jax(seed):
    rng = np.random.default_rng(seed)
    anchor = rng.normal(size=3).astype(np.float32) * 0.3
    normal = rng.normal(size=3)
    if seed == 2:
        normal = np.asarray([0.97, 0.1, 0.05])  # the other in-plane basis branch
    vt, vj = tar.cube_vertices(anchor, normal, 0.8), jar.cube_vertices(anchor, normal, 0.8)
    np.testing.assert_allclose(vt, vj, atol=1e-5)
    R, t = _pose(seed)
    cam = np.asarray([200, 200, 187.5, 119.5, 0, 0, 0, 0, 0], np.float32)
    img = rng.uniform(0, 200, (240, 376)).astype(np.float32)
    got = tar.draw_cube(img, vj, R, t, cam)
    want = jar.draw_cube(img, vj, R, t, cam)
    np.testing.assert_array_equal(got, want)
    assert (got != img).sum() > 50
    # a tensor frame draws the same
    np.testing.assert_array_equal(tar.draw_cube(torch.from_numpy(img), vj, R, t, cam), got)


@pytest.fixture(scope="module")
def seeded():
    seq = synth.make_sequence(n_frames=13, height=240, width=376, dt=0.1, seed=3, with_depth=True,
                              device="cpu")
    slam = tsys.MonoSlam(height=240, width=376, cam_params=seq.cam_params, n_features=800,
                         max_keyframes=16, max_points=4096, device="cpu", pipelined=False)
    m, n_kf, n_pts = synth.seed_map_from_depth(seq, 6, slam)
    R0 = seq.R_wc[-1].T
    slam.set_map(m, n_kf, n_pts, R0, -R0 @ seq.t_wc[-1])
    return slam, seq


def test_ar_demo_finds_the_wall_and_draws(seeded):
    slam, seq = seeded
    demo = tar.ARDemo(slam)
    assert demo.try_detect_plane(), "no dominant plane on the map"
    n, d, anchor = demo.plane
    assert np.abs(n).max() > 0.9  # the room is a box: a wall's normal is an axis
    C = -slam.R_cur.T @ slam.t_cur
    assert C @ n + d > 0  # the camera-facing side
    v0 = demo.verts.copy()
    out = demo.render(seq.images[-1])
    assert out.shape == (240, 376) and out.dtype == np.float32
    assert (np.abs(out - seq.images[-1].numpy()) > 0).sum() > 50
    demo.render(seq.images[-2])
    np.testing.assert_array_equal(demo.verts, v0)  # anchored in the world


def test_viz_writes_pngs(tmp_path, seeded):
    pytest.importorskip("matplotlib")
    from orb_slam3_ros_tpu_torch.ops import orb
    from orb_slam3_ros_tpu_torch.utils import viz

    slam, seq = seeded
    p = viz.draw_map(slam, str(tmp_path / "map.png"), gt_positions=seq.t_wc)
    assert open(p, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    feats = orb.extract(seq.images[0], slam.config)
    fp = torch.where(torch.arange(feats.xy.shape[0]) % 3 == 0, 1, -1)
    q = viz.draw_tracking(seq.images[0], feats, fp, str(tmp_path / "track.png"))
    assert open(q, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
