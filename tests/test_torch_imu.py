"""IMU preintegration and the SO(3) additions of the port against the JAX
package on the same numpy inputs (mirrors
``tests/test_imu_cameras.py::TestPreintegration``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.ops import imu as jimu
from orb_slam3_ros_tpu.ops import lie as jlie
from orb_slam3_ros_tpu.ops import viba as jviba
from orb_slam3_ros_tpu_torch.ops import imu as timu
from orb_slam3_ros_tpu_torch.ops import lie as tlie
from test_imu_cameras import make_calib, simulate_trajectory
from torch_parity import np_tree, torch_calib, torch_preint

torch.set_num_threads(1)
T = torch.from_numpy


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


@functools.lru_cache(maxsize=None)
def _trajectory(n, dt=0.005):
    """``simulate_trajectory`` of the JAX tests, once per length: it steps
    through eager JAX calls, seconds per call of it."""
    return simulate_trajectory(n, dt, np.random.default_rng(n))


def _case(rng, n, pad_mid=True):
    accs, gyros, *_ = _trajectory(max(n, 2))
    accs, gyros = accs[:n], gyros[:n]
    dts = np.full((n,), 0.005, np.float32)
    if pad_mid and n >= 7:
        dts[n // 2] = 0.0  # padding row mid-stream
    b = (rng.normal(size=6) * 0.01).astype(np.float32)
    return accs, gyros, dts, b


# ------------------------------------------------------------------ lie


def _rotations(rng):
    """Angles at 0, tiny, generic and within 0.1 rad of pi."""
    phi = rng.normal(size=(40, 3)).astype(np.float32)
    phi[:10] *= 1e-4
    ax = phi[10:20] / np.linalg.norm(phi[10:20], axis=1, keepdims=True)
    phi[10:20] = ax * (np.pi - rng.uniform(0, 0.1, (10, 1))).astype(np.float32)
    phi[20] = 0.0
    return phi, np.asarray(jlie.so3_exp(jnp.asarray(phi)))


def test_so3_log_matches_jax_in_all_branches(rng):
    # 1e-5: float32 rounding of atan2 / sqrt between XLA and torch at theta
    # near pi, where the axis comes from sqrt of a diagonal; measured 3e-8.
    phi, R = _rotations(rng)
    got = tlie.so3_log(T(R)).numpy()
    np.testing.assert_allclose(got, np.asarray(jlie.so3_log(jnp.asarray(R))), atol=1e-5)
    assert np.all(got[20] == 0.0)  # log(I) = 0 exactly
    # and it inverts exp away from pi (the generic branch)
    np.testing.assert_allclose(got[21:], phi[21:], atol=2e-5)


def test_so3_log_jacfwd_at_identity_is_finite():
    # Every zero-residual inertial edge differentiates so3_log exactly here;
    # d log / dR at I is the vee of the skew part, 0.5 per off-diagonal pair.
    J = torch.func.jacfwd(tlie.so3_log)(torch.eye(3))
    assert torch.isfinite(J).all()
    Jj = np.asarray(jax.jacfwd(jlie.so3_log)(jnp.eye(3)))
    np.testing.assert_allclose(J.numpy().astype(np.float32), Jj, atol=1e-7)


def test_so3_log_jacfwd_batched_matches_jax(rng):
    # Tolerance 2e-3 relative to the largest entry: near pi the derivative
    # reaches ~30 and float32 cancellation differs; measured 6e-5 absolute.
    _, R = _rotations(rng)
    R = R[20:]  # zero and generic angles
    J = torch.func.vmap(torch.func.jacfwd(tlie.so3_log))(T(R)).numpy()
    Jj = np.asarray(jax.vmap(jax.jacfwd(jlie.so3_log))(jnp.asarray(R)))
    assert np.isfinite(J).all()
    assert _rel(Jj, J) < 2e-3


@pytest.mark.parametrize("name", ["so3_left_jacobian_inv", "so3_right_jacobian",
                                  "so3_right_jacobian_inv", "vee"])
def test_lie_additions_match_jax(rng, name):
    # 5e-4: (t - sin t)/t^3 cancels in float32 right above the Taylor
    # switch (theta^2 = 1e-8); both packages compute the same expression
    # with different sin roundings there. Measured 2e-4, elsewhere 1e-7.
    phi, R = _rotations(rng)
    x = np.asarray(jlie.hat(jnp.asarray(phi))) if name == "vee" else phi
    want = np.asarray(getattr(jlie, name)(jnp.asarray(x)))
    got = getattr(tlie, name)(T(x)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-4)


# -------------------------------------------------------- preintegration


@pytest.mark.parametrize("n", [1, 7, 20, 64])
def test_tree_matches_jax_tree(rng, n):
    # Same pairing order as the JAX tree, so the two agree to rounding:
    # 1e-5 relative to each field's largest entry, C 1e-4 (measured 6e-6
    # and 2e-7).
    accs, gyros, dts, b = _case(rng, n)
    jc = make_calib()
    want = jimu.preintegrate(*(jnp.asarray(x) for x in (accs, gyros, dts, b)), jc)
    got = timu.preintegrate(T(accs), T(gyros), T(dts), T(b), torch_calib(jc))
    for f in timu.Preintegrated._fields:
        tol = 1e-4 if f == "C" else 1e-5
        assert _rel(getattr(want, f), getattr(got, f).numpy()) < tol, f


@pytest.mark.parametrize("n", [1, 7, 20, 64])
def test_sequential_matches_jax_sequential(rng, n):
    accs, gyros, dts, b = _case(rng, n)
    jc = make_calib()
    want = jimu.preintegrate_sequential(*(jnp.asarray(x) for x in (accs, gyros, dts, b)), jc)
    got = timu.preintegrate_sequential(T(accs), T(gyros), T(dts), T(b), torch_calib(jc))
    for f in timu.Preintegrated._fields:
        tol = 1e-4 if f == "C" else 1e-5
        assert _rel(getattr(want, f), getattr(got, f).numpy()) < tol, f


@pytest.mark.parametrize("n", [7, 20, 64])
def test_tree_matches_sequential(rng, n):
    # The JAX test's reassociation tolerance (test_imu_cameras.py).
    accs, gyros, dts, b = _case(rng, n)
    tc = torch_calib(make_calib())
    fast = timu.preintegrate(T(accs), T(gyros), T(dts), T(b), tc)
    seq = timu.preintegrate_sequential(T(accs), T(gyros), T(dts), T(b), tc)
    for f in ("dR", "dV", "dP", "dT", "JRg", "JVg", "JVa", "JPg", "JPa"):
        np.testing.assert_allclose(getattr(fast, f).numpy(), getattr(seq, f).numpy(),
                                   rtol=2e-4, atol=2e-6, err_msg=f)
    np.testing.assert_allclose(fast.C.numpy(), seq.C.numpy(), rtol=2e-3, atol=1e-10)


def test_batched_window_equals_per_block(rng):
    # The port batches over a leading window axis where JAX uses vmap.
    cases = [_case(rng, 20) for _ in range(3)]
    cases = [(a + rng.normal(size=a.shape).astype(np.float32) * 0.1, g, d, b) for a, g, d, b in cases]
    tc = torch_calib(make_calib())
    stack = [T(np.stack([c[i] for c in cases])) for i in range(4)]
    both = timu.preintegrate(*stack, tc)
    both_seq = timu.preintegrate_sequential(*stack, tc)
    for k, c in enumerate(cases):
        one = timu.preintegrate(*(T(x) for x in c), tc)
        one_seq = timu.preintegrate_sequential(*(T(x) for x in c), tc)
        # batched and single matmuls round differently: 1e-5 of each field's
        # largest entry (measured 5e-7)
        for f in timu.Preintegrated._fields:
            assert _rel(getattr(one, f).numpy(), getattr(both, f)[k].numpy()) < 1e-5, f
            assert _rel(getattr(one_seq, f).numpy(), getattr(both_seq, f)[k].numpy()) < 1e-5, f


@pytest.mark.parametrize("integrate", ["preintegrate", "preintegrate_sequential"])
def test_padding_is_noop(rng, integrate):
    n, dt, pad = 16, 0.005, 8
    accs, gyros, *_ = _trajectory(n, dt)
    tc = torch_calib(make_calib())
    fn = getattr(timu, integrate)
    s1 = fn(T(accs), T(gyros), torch.full((n,), dt), torch.zeros(6), tc)
    accs_p = np.concatenate([accs, rng.normal(size=(pad, 3)).astype(np.float32)])
    gyros_p = np.concatenate([gyros, rng.normal(size=(pad, 3)).astype(np.float32)])
    dts_p = np.concatenate([np.full(n, dt, np.float32), np.zeros(pad, np.float32)])
    s2 = fn(T(accs_p), T(gyros_p), T(dts_p), torch.zeros(6), tc)
    for a, b in zip(s1, s2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_bias_jacobian_first_order(rng):
    """delta_with_bias(b + db) ~ reintegration at b + db."""
    n, dt = 20, 0.005
    accs, gyros, *_ = _trajectory(n, dt)
    tc = torch_calib(make_calib())
    db = T((rng.normal(size=6) * 3e-3).astype(np.float32))
    args = (T(accs), T(gyros), torch.full((n,), dt))
    s0 = timu.preintegrate(*args, torch.zeros(6), tc)
    dR_c, dV_c, dP_c = timu.delta_with_bias(s0, db)
    s1 = timu.preintegrate(*args, db, tc)
    np.testing.assert_allclose(dR_c.numpy(), s1.dR.numpy(), atol=2e-4)
    np.testing.assert_allclose(dV_c.numpy(), s1.dV.numpy(), atol=2e-3)
    np.testing.assert_allclose(dP_c.numpy(), s1.dP.numpy(), atol=2e-3)


def _states(rng, n=20, dt=0.005):
    accs, gyros, Rs, ps, vs = _trajectory(n, dt)
    jc = make_calib()
    b = (rng.normal(size=6) * 0.01).astype(np.float32)
    pre = jimu.preintegrate(jnp.asarray(accs), jnp.asarray(gyros), jnp.full((n,), dt),
                            jnp.zeros(6), jc)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    st = (f32(Rs[0]), f32(ps[0]), f32(vs[0]), b, f32(Rs[-1]), f32(ps[-1]) + 0.01, f32(vs[-1]) - 0.02)
    return st, pre, (Rs, ps, vs)


def test_predict_state_matches_jax_and_truth(rng):
    st, pre, (Rs, ps, vs) = _states(rng)
    z = np.zeros(6, np.float32)
    want = jimu.predict_state(*(jnp.asarray(x) for x in (*st[:3], z)), pre)
    got = timu.predict_state(*(T(x) for x in (*st[:3], z)), torch_preint(pre))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-6)
    np.testing.assert_allclose(got[0].numpy(), Rs[-1], atol=1e-3)
    np.testing.assert_allclose(got[1].numpy(), ps[-1], atol=2e-3)
    np.testing.assert_allclose(got[2].numpy(), vs[-1], atol=2e-3)


def test_residuals_match_jax(rng):
    # 5e-6 absolute on residuals of size ~1e-2 (measured 4e-7).
    st, pre, _ = _states(rng)
    tp = torch_preint(pre)
    want = jimu.inertial_residual(*(jnp.asarray(x) for x in st), pre)
    got = timu.inertial_residual(*(T(x) for x in st), tp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-6)
    g = np.asarray([0.3, -0.2, -9.7], np.float32)
    want = jimu.inertial_residual_gs(*(jnp.asarray(x) for x in st), pre, jnp.asarray(g), 1.3)
    got = timu.inertial_residual_gs(*(T(x) for x in st), tp, T(g), 1.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-6)


def test_closed_form_jacobians_match_jax_jacfwd(rng):
    # The port's closed-form Jacobians against forward-mode AD of the JAX
    # residual over the 27-dim perturbation [state_i, pose_j, v_j, gravity
    # direction, log scale]. 1e-4 of entries of size ~1 (measured 1.5e-5:
    # float32 AD against float32 closed form).
    st, pre, _ = _states(rng)
    R1, p1, v1, b, R2, p2, v2 = st
    Rwg = np.asarray(jlie.so3_exp(jnp.asarray([0.1, -0.2, 0.0])))
    s = 1.3
    J = np.asarray(jax.jacfwd(lambda e: jviba._inertial_residual_gs27(
        e, *(jnp.asarray(x) for x in (R1, p1, v1, b[:3], b[3:], R2, p2, v2)), pre,
        jnp.asarray(Rwg), jnp.asarray(s, jnp.float32)))(jnp.zeros(27)))
    g_ref = timu.gravity_vec(torch.zeros(1))
    out = timu.inertial_residual_jac(*(T(x) for x in st), torch_preint(pre),
                                     gravity=T(Rwg) @ g_ref, scale=torch.tensor(s))
    dG = -(T(Rwg) @ tlie.hat(g_ref))[:, :2]
    got = torch.cat([out.pose1, out.v1, out.bg, out.ba, out.pose2, out.v2,
                     out.gravity @ dG, out.log_scale], dim=-1).numpy()
    np.testing.assert_allclose(got, J, atol=1e-4)
    r = jviba._inertial_residual_gs27(
        jnp.zeros(27), *(jnp.asarray(x) for x in (R1, p1, v1, b[:3], b[3:], R2, p2, v2)), pre,
        jnp.asarray(Rwg), jnp.asarray(s, jnp.float32))
    np.testing.assert_allclose(out.r.numpy(), np.asarray(r), atol=5e-6)


def test_numpy_round_trip(rng):
    st, pre, _ = _states(rng)
    tp = torch_preint(pre)
    back = timu.preintegrated_to_numpy(tp)
    for k, v in np_tree(pre).items():
        np.testing.assert_array_equal(back[k], v)
