"""Relocalization in the port against the JAX package: the frame-to-frame
descriptor search (``matching.search_frame_frame``), retrieval
(``ops/retrieval.py``: signatures, the grouped candidate ranking, the
shipped vocabulary), PnP RANSAC (``ops/pnp.py``), one relocalization
attempt and the candidate detection (``models/system.py``), and
``MonoSlam`` recovering from a timestamp jump. Inputs are made with numpy
from a seed or by the JAX package's extractor, and handed to both packages;
the map is one the port builds over the first 20 frames of
``make_sequence(seed=3)`` at 240x376. Where both packages draw random
hypotheses, the test gives the port the JAX package's samples.
``tests/test_torch_inertial_e2e.py`` holds ``InertialSlam``'s recovery
from LOST, on the run its fixture already made.
"""

import copy
import filecmp
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.models import map_state as jms
from orb_slam3_ros_tpu.models import system as jsys
from orb_slam3_ros_tpu.ops import cameras as jcam
from orb_slam3_ros_tpu.ops import lie as jlie
from orb_slam3_ros_tpu.ops import matching as jmatch
from orb_slam3_ros_tpu.ops import orb as jorb
from orb_slam3_ros_tpu.ops import pnp as jpnp
from orb_slam3_ros_tpu.ops import retrieval as jret
from orb_slam3_ros_tpu_torch.models import map_state as tms
from orb_slam3_ros_tpu_torch.models import system as tsys
from orb_slam3_ros_tpu_torch.ops import matching as tmatch
from orb_slam3_ros_tpu_torch.ops import pnp as tpnp
from orb_slam3_ros_tpu_torch.ops import retrieval as tret
from orb_slam3_ros_tpu_torch.utils import synth as tsynth
from torch_parity import torch_features

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
H, W, N_MAP = 240, 376, 20
SLAM_KW = dict(height=H, width=W, n_features=1000, max_keyframes=32, max_points=4096,
               lean_after_kf=4, track_cap=768, pipelined=False)
CAM = np.asarray([400.0, 400.0, 320.0, 240.0, 0, 0, 0, 0, 0], np.float32)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def mapped():
    """A port system over the first N_MAP frames, the JAX extractor's
    features of every frame of the sequence, and the map as JAX arrays."""
    seq = tsynth.make_sequence(n_frames=40, height=H, width=W, dt=0.1, seed=3, device="cpu")
    slam = tsys.MonoSlam(cam_params=seq.cam_params, device="cpu", **SLAM_KW)
    for i in range(N_MAP):
        slam.process_frame(seq.images[i], float(seq.timestamps[i]))
    assert slam.state == tsys.OK and slam.n_kf >= 4
    ext = jax.jit(lambda im: jorb.extract(im, jorb.default_config(H, W, n_features=1000)))
    feats = [ext(jnp.asarray(seq.images[i].numpy())) for i in range(40)]
    jm = jms.MapState(**{k: jnp.asarray(v) for k, v in tms.to_numpy(slam.map).items()})
    return dict(seq=seq, slam=slam, feats=feats, jm=jm)


# ---- the frame-to-frame search ----
@pytest.mark.parametrize("pair", [(0, 1), (3, 9), (12, 30)])
@pytest.mark.parametrize("kw", [{}, dict(max_dist=64, ratio=0.8), dict(use_rotation=False)])
def test_search_frame_frame_matches_jax(mapped, pair, kw):
    # Integer distances and the same tie rules: indices and distances exact.
    f1, f2 = (mapped["feats"][i] for i in pair)
    ji, jd = jmatch.search_frame_frame(f1, f2, **kw)
    ti, td = tmatch.search_frame_frame(torch_features(f1), torch_features(f2), **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert (ti >= 0).sum() > 20


# ---- retrieval ----
def test_vocabulary_copy_is_the_jax_packages_file():
    port = ROOT / "orb_slam3_ros_tpu_torch" / "data" / "default_vocab.npz"
    assert filecmp.cmp(port, ROOT / "orb_slam3_ros_tpu" / "data" / "default_vocab.npz", shallow=False)
    assert Path(tret.VOCAB_PATH).resolve() == port.resolve()
    np.testing.assert_array_equal(tret.default_vocabulary(), jret.default_vocabulary())
    np.testing.assert_array_equal(tret.ANCHORS, jret.ANCHORS)


def _descriptors(rng, shape, zero_rows=0.1):
    d = rng.choice(np.array([-1, 1], np.int8), size=shape + (256,))
    d[rng.random(shape) < zero_rows] = 0  # invalid features carry zero rows
    return d, rng.random(shape) > 0.2


@pytest.mark.parametrize("vocab", ["default", "anchors"])
def test_signatures_match_jax(vocab):
    # Word ids exact (integer correlations; the first maximum among ties);
    # signatures to 1e-6 (the norm's float sum). "anchors": the JAX
    # package's fallback for no vocabulary against the port's ANCHORS.
    rng = np.random.default_rng(5)
    d, v = _descriptors(rng, (6, 300))
    jv = None if vocab == "anchors" else jnp.asarray(jret.default_vocabulary())
    tv = T(tret.ANCHORS if vocab == "anchors" else tret.default_vocabulary())
    np.testing.assert_array_equal(tret.descriptor_words(T(d[0]), tv).numpy(),
                                  np.asarray(jret.descriptor_words(jnp.asarray(d[0]), jv)))
    np.testing.assert_allclose(tret.signature(T(d[0]), T(v[0]), tv).numpy(),
                               np.asarray(jret.signature(jnp.asarray(d[0]), jnp.asarray(v[0]), jv)),
                               atol=1e-6)
    np.testing.assert_allclose(tret.kf_signatures(T(d), T(v), tv).numpy(),
                               np.asarray(jret.kf_signatures(jnp.asarray(d), jnp.asarray(v), jv)),
                               atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grouped_candidates_match_jax(seed):
    # Random signatures and a covisibility matrix of small integer weights
    # (many ties): the candidate ids as sets, the accumulated scores to 1e-5.
    rng = np.random.default_rng(seed)
    K, A = 24, 64
    sigs = rng.random((K, A)).astype(np.float32)
    sigs /= np.linalg.norm(sigs, axis=1, keepdims=True)
    q = sigs[rng.integers(K)] + 0.1 * rng.random(A).astype(np.float32)
    cov = rng.integers(0, 30, (K, K)).astype(np.int32)
    cov = np.maximum(cov, cov.T)
    np.fill_diagonal(cov, 0)
    valid = rng.random(K) > 0.15
    excl = rng.random(K) > 0.9
    jid, jacc = jret.detect_candidates_grouped(*(jnp.asarray(a) for a in (q, sigs, cov, valid, excl)))
    tid, tacc = tret.detect_candidates_grouped(*(T(a) for a in (q, sigs, cov, valid, excl)))
    assert set(tid.tolist()) == set(np.asarray(jid).tolist())
    np.testing.assert_allclose(np.sort(tacc.numpy()), np.sort(np.asarray(jacc)), atol=1e-5)
    jid2, _ = jret.detect_candidates(*(jnp.asarray(a) for a in (q, sigs, valid, excl)))
    tid2, _ = tret.detect_candidates(*(T(a) for a in (q, sigs, valid, excl)))
    assert set(tid2.tolist()) == set(np.asarray(jid2).tolist())


def test_reloc_detection_matches_jax(mapped):
    # The whole detection on the port's map for a frame it saw: the same
    # candidates, as a set.
    slam, f = mapped["slam"], mapped["feats"][15]
    want = jsys._reloc_detect_fused(mapped["jm"], f.desc_sign, f.valid,
                                    jnp.asarray(jret.default_vocabulary()))
    tf = torch_features(f)
    got = tsys._reloc_detect(slam.map, tf.desc_sign, tf.valid, slam.vocab)
    assert set(got.tolist()) == set(np.asarray(want).tolist()) and (got >= 0).any()


# ---- PnP ----
def pnp_scene(rng, n=200, outlier_frac=0.3, noise=0.4):
    """``tests/test_pnp.py``'s scene."""
    X = rng.uniform([-3, -2, 4], [3, 2, 12], size=(n, 3)).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.15, -0.3, 0.4])), np.float32)
    t = np.asarray([0.5, -0.2, 1.0], np.float32)
    uv = np.array(jcam.pinhole_project_nodist(jnp.asarray(CAM), jnp.asarray(X @ R.T + t)))
    uv += rng.normal(size=uv.shape).astype(np.float32) * noise
    n_out = int(n * outlier_frac)
    out = rng.choice(n, n_out, replace=False)
    uv[out] += rng.uniform(15, 120, size=(n_out, 2)).astype(np.float32) * np.sign(
        rng.normal(size=(n_out, 2))).astype(np.float32)
    return X, uv, R, t, out


def jax_samples(key, valid, n_hyp=256):
    """The samples ``pnp.solve_pnp`` draws inside with ``key``."""
    u = jax.random.uniform(key, (n_hyp, len(valid)), jnp.float32, 1e-9, 1.0 - 1e-9)
    scores = -jnp.log(-jnp.log(u)) + jnp.where(jnp.asarray(valid), 0.0, -1e9)
    return np.asarray(jax.lax.top_k(scores, 6)[1])


@pytest.mark.parametrize("noise", [0.0, 0.4])
def test_dlt_pose_matches_jax(noise):
    # 64 six-point samples of inliers: poses to 1e-3 (float32 SVD of a
    # 12x12 system; both fix the null vector's sign by det > 0).
    rng = np.random.default_rng(3)
    X, uv, _, _, out = pnp_scene(rng, outlier_frac=0.0, noise=noise)
    xy = (uv - CAM[2:4]) / CAM[0:2]
    samp = np.stack([rng.choice(len(X), 6, replace=False) for _ in range(64)])
    jR, jt = jax.vmap(lambda s: jpnp._dlt_pose(jnp.asarray(X)[s], jnp.asarray(xy)[s]))(jnp.asarray(samp))
    tR, tt = tpnp._dlt_pose(T(X)[samp], T(xy.astype(np.float32))[samp])
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-3 * (1 + 100 * noise))


@pytest.mark.parametrize("seed", [0, 1])
def test_solve_pnp_from_samples_matches_jax(seed):
    # The JAX package's own samples: the same winner, the refined pose to
    # 1e-4 rad / 1e-3 m, inlier sets 99% alike.
    rng = np.random.default_rng(seed)
    X, uv, _, _, _ = pnp_scene(rng)
    valid = np.ones(len(X), bool)
    valid[rng.random(len(X)) < 0.1] = False
    key = jax.random.PRNGKey(seed)
    want = jpnp.solve_pnp(jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid), jnp.asarray(CAM), key)
    got = tpnp.solve_pnp_from_samples(T(X), T(uv), T(valid), T(CAM), T(jax_samples(key, valid)))
    assert bool(got.ok) == bool(want.ok)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-3)
    assert (got.inlier.numpy() == np.asarray(want.inlier)).mean() >= 0.99
    assert abs(int(got.n_inliers) - int(want.n_inliers)) <= 2


class TestPnPOwnGenerator:
    """``tests/test_pnp.py``'s three cases, the samples drawn by the port."""

    @staticmethod
    def gen(seed):
        return torch.Generator().manual_seed(seed)

    def test_recovers_pose_with_outliers(self, rng):
        X, uv, R, t, out = pnp_scene(rng)
        res = tpnp.solve_pnp(T(X), T(uv), torch.ones(len(X), dtype=torch.bool), T(CAM), self.gen(0))
        assert bool(res.ok)
        np.testing.assert_allclose(res.R.numpy(), R, atol=2e-3)
        np.testing.assert_allclose(res.t.numpy(), t, atol=1e-2)
        inl = res.inlier.numpy()
        assert inl[out].mean() < 0.1
        assert inl[np.setdiff1d(np.arange(len(X)), out)].mean() > 0.9

    def test_rejects_when_too_few_valid(self, rng):
        X, uv, R, t, out = pnp_scene(rng, n=40)
        valid = np.zeros(40, bool)
        valid[:8] = True
        uv[:8] = rng.uniform(0, 640, size=(8, 2)).astype(np.float32)  # garbage
        res = tpnp.solve_pnp(T(X), T(uv), T(valid), T(CAM), self.gen(1))
        assert not bool(res.ok)

    def test_respects_valid_mask(self, rng):
        X, uv, R, t, _ = pnp_scene(rng, outlier_frac=0.0)
        valid = np.ones(len(X), bool)
        valid[::2] = False  # the masked-out half is garbage
        uv[::2] = rng.uniform(0, 640, size=(len(X) // 2, 2)).astype(np.float32)
        res = tpnp.solve_pnp(T(X), T(uv), T(valid), T(CAM), self.gen(2))
        assert bool(res.ok)
        np.testing.assert_allclose(res.R.numpy(), R, atol=2e-3)
        assert not res.inlier.numpy()[::2].any()


# ---- one relocalization attempt ----
@pytest.fixture(scope="module")
def attempt(mapped):
    """One attempt of each package on the same map, query frame and
    candidate, the port given the JAX package's PnP samples."""
    slam, jm, f = mapped["slam"], mapped["jm"], mapped["feats"][15]
    cand = int(tsys._reloc_detect(slam.map, torch_features(f).desc_sign, torch_features(f).valid,
                                  slam.vocab)[0])
    key = jax.random.PRNGKey(4)
    cam = jnp.asarray(mapped["seq"].cam_params)
    want = np.asarray(jsys._reloc_attempt_fused(jm, jnp.asarray(cand), f, key, cam, W, H))
    _, _, ok = jsys._reloc_pnp_inputs(jm, cand, f)
    got = tsys._reloc_attempt(slam.map, cand, torch_features(f), slam.cam_params, W, H,
                              samples=T(jax_samples(key, np.asarray(ok))))
    return dict(cand=cand, want=want, got=got.numpy(), n_matches=int(np.asarray(ok).sum()))


def test_reloc_attempt_matches_jax(attempt):
    # Pose to 1e-4 rad / 5e-4 m, tracking inliers within 1%.
    want, got = attempt["want"], attempt["got"]
    assert attempt["n_matches"] >= 15 and want[12] >= 30
    np.testing.assert_allclose(got[:9], want[:9], atol=1e-4)
    np.testing.assert_allclose(got[9:12], want[9:12], atol=5e-4)
    assert abs(got[12] - want[12]) <= 0.01 * want[12], (got[12], want[12])


def test_reloc_attempt_finds_the_frames_pose(attempt, mapped):
    # frame 15 was tracked when the map was made: the attempt lands on its pose
    R_log = [T_wc for ts, T_wc in mapped["slam"].get_trajectory() if abs(ts - 1.5) < 1e-6][0]
    Rcw = attempt["got"][:9].reshape(3, 3)
    twc = -Rcw.T @ attempt["got"][9:12]
    assert np.abs(twc - R_log[:3, 3]).max() < 5e-3


# ---- MonoSlam ----
def test_timestamp_jump_relocalizes(mapped):
    # A 2 s gap after frame 19: frame 20 goes LOST and relocalizes on the
    # spot; the motion model restarts and tracking goes on.
    slam, seq = copy.deepcopy(mapped["slam"]), mapped["seq"]
    out = slam.process_frame(seq.images[20], float(seq.timestamps[20]) + 2.0)
    assert out is not None and slam.state == tsys.OK
    np.testing.assert_array_equal(slam.vel_R, np.eye(3, dtype=np.float32))
    assert not slam.vel_t.any()
    for i in range(21, 25):
        assert slam.process_frame(seq.images[i], float(seq.timestamps[i]) + 2.0) is not None
    assert slam.state == tsys.OK


def test_timestamp_jump_in_a_chunk_relocalizes(mapped):
    # The chunk gate sees the gap and sends the chunk per frame: its first
    # frame relocalizes, and the next chunk runs on the chunk loop.
    slam, seq = copy.deepcopy(mapped["slam"]), mapped["seq"]
    stack = torch.clamp(seq.images, 0, 255).to(torch.uint8)
    tss = seq.timestamps.astype(np.float64) + 2.0
    slam.process_frames((stack, 20), tss[20:28])
    assert slam.state == tsys.OK and slam._mono_runner is None
    slam.process_frames((stack, 28), tss[28:36])
    assert slam.state == tsys.OK and slam._mono_runner is not None
    assert len([t for t, _ in slam.get_trajectory() if t > 3.5]) == 16


def test_lost_without_keyframes_stays_lost():
    # Relocalization needs two keyframes (the JAX package's guard).
    cam = np.asarray([200, 200, 187.5, 119.5, 0, 0, 0, 0, 0], np.float32)
    slam = tsys.MonoSlam(cam_params=cam, device="cpu", **SLAM_KW)
    slam.state = tsys.LOST
    assert slam.process_frame(np.zeros((H, W), np.float32), 0.0) is None
    assert slam.state == tsys.LOST


def test_set_vocabulary_installs_a_device_copy(mapped):
    slam = copy.deepcopy(mapped["slam"])
    np.testing.assert_array_equal(slam.vocab.numpy(), tret.default_vocabulary())
    slam.set_vocabulary(torch.from_numpy(tret.ANCHORS))
    assert slam.vocab.dtype == torch.int8 and torch.equal(slam.vocab, T(tret.ANCHORS))
