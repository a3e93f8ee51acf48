"""Sim(3) in the port against the JAX package: the SE(3) log and the Sim(3)
maps of ``ops/lie.py``, and ``ops/sim3solver.py`` (Umeyama, the RANSAC
solve from given samples, the IRLS refinement), each with and without a
fixed scale. Inputs are made with numpy from a seed; where the JAX package
draws RANSAC samples, the port is handed the same samples.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.ops import lie as jlie
from orb_slam3_ros_tpu.ops import sim3solver as jsim3
from orb_slam3_ros_tpu_torch.ops import lie as tlie
from orb_slam3_ros_tpu_torch.ops import sim3solver as tsim3

torch.set_num_threads(1)
CAM = np.asarray([400.0, 400.0, 320.0, 240.0, 0, 0, 0, 0, 0], np.float32)
LIE_ATOL = 1e-5


def T(a):
    return torch.from_numpy(np.array(a))


def _tangents(seed, dim, scale):
    """Random tangents with the small-angle and zero-scale branches hit too."""
    z = (np.random.default_rng(seed).normal(size=(64, dim)) * scale).astype(np.float32)
    z[:8, 3:6] = 0.0  # theta = 0
    if dim == 7:
        z[8:16, 6] = 0.0  # sigma = 0
    return z


@pytest.mark.parametrize("scale", [1e-6, 1e-2, 0.4, 1.2])
def test_sim3_exp_log_match_jax(scale):
    """exp and log agree with the JAX package to 1e-5 (float32 round-off:
    measured <= 6e-6 up to rotations of 2 rad), and log inverts exp."""
    z = _tangents(0, 7, scale)
    R, t, s = jlie.sim3_exp(jnp.asarray(z))
    Rt, tt, st = tlie.sim3_exp(T(z))
    for want, got in ((R, Rt), (t, tt), (s, st)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LIE_ATOL)
    lt = tlie.sim3_log(T(np.asarray(R)), T(np.asarray(t)), T(np.asarray(s)))
    np.testing.assert_allclose(lt.numpy(), np.asarray(jlie.sim3_log(R, t, s)), atol=LIE_ATOL)
    if scale < 1.0:  # below pi: log is the inverse of exp
        np.testing.assert_allclose(lt.numpy(), z, atol=LIE_ATOL)


@pytest.mark.parametrize("scale", [1e-6, 0.4])
def test_se3_log_and_sim3_group_ops_match_jax(scale):
    za, zb = _tangents(1, 7, scale), _tangents(2, 7, scale)
    Ra, ta, sa = jlie.sim3_exp(jnp.asarray(za))
    Rb, tb, sb = jlie.sim3_exp(jnp.asarray(zb))
    ja = [T(np.asarray(x)) for x in (Ra, ta, sa)]
    jb = [T(np.asarray(x)) for x in (Rb, tb, sb)]
    pairs = [
        (jlie.sim3_mul(Ra, ta, sa, Rb, tb, sb), tlie.sim3_mul(*ja, *jb)),
        (jlie.sim3_inv(Ra, ta, sa), tlie.sim3_inv(*ja)),
        ((jlie.sim3_apply(Ra, ta, sa, tb),), (tlie.sim3_apply(*ja, jb[1]),)),
        ((jlie.se3_log(Ra, ta),), (tlie.se3_log(ja[0], ja[1]),)),
        (jlie.se3_mul(Ra, ta, Rb, tb), tlie.se3_mul(ja[0], ja[1], jb[0], jb[1])),
        (jlie.se3_inv(Ra, ta), tlie.se3_inv(ja[0], ja[1])),
    ]
    for want, got in pairs:
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=LIE_ATOL)


def _matches(seed, fix_scale, N=240, outliers=0.2):
    """Camera-frame points X1 of keyframe 1 and X2 = S21 X1 (+ noise) of
    keyframe 2, with gross outliers, invalid slots and octave variances."""
    rng = np.random.default_rng(seed)
    X1 = rng.uniform([-2, -1.5, 3], [2, 1.5, 7], (N, 3)).astype(np.float32)
    R21 = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=3) * 0.2, jnp.float32)))
    t21 = rng.normal(size=3).astype(np.float32) * 0.3
    s21 = np.float32(1.0 if fix_scale else 1.4)
    X2 = s21 * X1 @ R21.T + t21 + rng.normal(size=(N, 3)).astype(np.float32) * 0.003
    bad = rng.random(N) < outliers
    X2[bad] += rng.normal(size=(int(bad.sum()), 3)).astype(np.float32) * 0.5
    valid = rng.random(N) < 0.9
    sig1 = (1.2 ** (2.0 * rng.integers(0, 8, N))).astype(np.float32)
    sig2 = (1.2 ** (2.0 * rng.integers(0, 8, N))).astype(np.float32)
    return X1, X2.astype(np.float32), valid, sig1, sig2, (s21, R21, t21)


def _check_result(want, got, inlier_share=0.99):
    """s, R, t within 1e-4 (measured ~1e-6: the refit is one SVD of a 3x3
    weighted covariance); the inlier sets agree on >= 99% of the matches
    (a match on its gate's edge may flip with the round-off)."""
    assert bool(want.ok) == bool(got.ok)
    np.testing.assert_allclose(float(got.s), float(want.s), atol=1e-4)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-4)
    agree = np.mean(np.asarray(want.inlier) == got.inlier.numpy())
    assert agree >= inlier_share, agree
    assert abs(int(want.n_inliers) - int(got.n_inliers)) <= 2


@pytest.mark.parametrize("fix_scale", [False, True])
def test_umeyama_matches_jax(fix_scale):
    X1, X2, valid, *_ = _matches(3, fix_scale, outliers=0.0)
    w = np.random.default_rng(4).random((5, X1.shape[0])).astype(np.float32) * valid
    src = np.broadcast_to(X1, (5,) + X1.shape)
    dst = np.broadcast_to(X2, (5,) + X2.shape)
    want = jsim3.umeyama(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), fix_scale=fix_scale)
    got = tsim3.umeyama(T(src), T(dst), T(w), fix_scale=fix_scale)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)


@pytest.mark.parametrize("fix_scale", [False, True])
@pytest.mark.parametrize("seed", [5, 6])
def test_solve_sim3_from_the_jax_packages_samples(seed, fix_scale):
    """The JAX package's RANSAC with key ``seed`` and the port's solve from
    the same 128 x 3 samples find the same Sim(3) and inliers, and the truth."""
    X1, X2, valid, sig1, sig2, (s21, R21, t21) = _matches(seed, fix_scale)
    key = jax.random.PRNGKey(seed)
    kw = dict(min_inliers=20, fix_scale=fix_scale)
    want = jsim3.solve_sim3(jnp.asarray(X1), jnp.asarray(X2), jnp.asarray(valid), jnp.asarray(CAM),
                            key, sigma2_1=jnp.asarray(sig1), sigma2_2=jnp.asarray(sig2), **kw)
    logits = jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)
    samples = np.asarray(jax.random.categorical(key, logits[None, :], shape=(tsim3.N_HYP, 3)))
    got = tsim3.solve_sim3_from_samples(T(X1), T(X2), T(valid), T(CAM), T(samples),
                                        sigma2_1=T(sig1), sigma2_2=T(sig2), **kw)
    _check_result(want, got)
    assert bool(got.ok)
    np.testing.assert_allclose(float(got.s), s21, atol=5e-3)
    np.testing.assert_allclose(got.R.numpy(), R21, atol=5e-3)


def test_solve_sim3_draws_from_valid_matches_with_a_generator():
    X1, X2, valid, sig1, sig2, (s21, _, _) = _matches(7, False)
    g = torch.Generator().manual_seed(0)
    samples = tsim3.sample_sim3(T(valid), g)
    assert samples.shape == (tsim3.N_HYP, 3)
    assert valid[samples.numpy()].all()
    res = tsim3.solve_sim3(T(X1), T(X2), T(valid), T(CAM), torch.Generator().manual_seed(0),
                           sigma2_1=T(sig1), sigma2_2=T(sig2))
    assert bool(res.ok) and abs(float(res.s) - s21) < 5e-3


@pytest.mark.parametrize("fix_scale", [False, True])
def test_refine_sim3_matches_jax(fix_scale):
    """From a perturbed start, the IRLS refinement lands where the JAX
    package's does."""
    X1, X2, valid, sig1, sig2, (s21, R21, t21) = _matches(8, fix_scale)
    # a start that gates a well-posed set (a 2-point fit has a rank-1
    # covariance whose SVD null space each library fills its own way)
    dR = np.asarray(jlie.so3_exp(jnp.asarray([0.002, -0.003, 0.002], jnp.float32)))
    s0, R0, t0 = np.float32(s21 * 1.002), (dR @ R21).astype(np.float32), t21 + 0.004
    kw = dict(min_inliers=20, fix_scale=fix_scale)
    want = jsim3.refine_sim3(jnp.asarray(X1), jnp.asarray(X2), jnp.asarray(valid), jnp.asarray(CAM),
                             jnp.asarray(s0), jnp.asarray(R0), jnp.asarray(t0),
                             sigma2_1=jnp.asarray(sig1), sigma2_2=jnp.asarray(sig2), **kw)
    got = tsim3.refine_sim3(T(X1), T(X2), T(valid), T(CAM), T(s0), T(R0), T(t0),
                            sigma2_1=T(sig1), sigma2_2=T(sig2), **kw)
    _check_result(want, got)
