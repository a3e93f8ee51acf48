"""SO(3) / SE(3) / Sim(3) operations in torch — the subset of
``orb_slam3_ros_tpu.ops.lie`` that pose optimization, bundle adjustment, the
inertial factors and loop closing (Sim(3) solving, the pose graphs) need.

Conventions are the JAX package's: rotations are 3x3 matrices, se(3)
tangent vectors are ``xi = [rho, phi]`` (translation first) with
``exp(xi) = (exp(phi^), J_l(phi) rho)``, and small-angle branches use
Taylor series selected with ``torch.where`` on sanitized inputs. Every
function is batched over leading dimensions and free of in-place writes
and data-dependent Python branches, so it traces under
``torch.func.jacfwd`` and ``vmap`` (``tests/test_torch_imu.py``
differentiates ``so3_log`` so, at the identity and batched). The per-frame
and keyframe solvers do not differentiate through these functions:
forward-mode AD promotes the tangent of a float32 tensor times a 0-dim
tensor to float64, which then meets float32 matmuls, and costs functorch's
overhead per operation, so the inertial and visual Jacobians are closed
forms (``imu.inertial_residual_jac``, ``viba._visual_res_jac``). The pose
graphs of loop closing (``pgo.py``), which run once a closure, take
forward-mode derivatives of their Sim(3) / SE(3) residuals, batched over
the edges so that no scalar is 0-dim.
"""

from __future__ import annotations

import torch

_EPS = 1e-8  # theta^2 threshold below which Taylor branches take over


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: [..., 3] -> [..., 3, 3] skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`: [..., 3, 3] -> [..., 3]."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sincos_coeffs(theta2: torch.Tensor):
    """(A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3), NaN-safe."""
    small = theta2 < _EPS
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    t = torch.sqrt(safe_t2)
    a_exact = torch.sin(t) / t
    b_exact = (1.0 - torch.cos(t)) / safe_t2
    c_exact = (t - torch.sin(t)) / (safe_t2 * t)
    a_taylor = 1.0 - theta2 / 6.0 + theta2 * theta2 / 120.0
    b_taylor = 0.5 - theta2 / 24.0 + theta2 * theta2 / 720.0
    c_taylor = 1.0 / 6.0 - theta2 / 120.0 + theta2 * theta2 / 5040.0
    return (
        torch.where(small, a_taylor, a_exact),
        torch.where(small, b_taylor, b_exact),
        torch.where(small, c_taylor, c_exact),
    )


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: [..., 3] -> [..., 3, 3]."""
    theta2 = torch.sum(phi * phi, dim=-1)
    A, B, _ = _sincos_coeffs(theta2)
    W = hat(phi)
    return _eye_like(W) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Matrix logarithm of a rotation: [..., 3, 3] -> [..., 3]. Taylor
    branch at theta ~ 0, axis from the diagonal of R at theta ~ pi."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    vee_part = vee(R - R.transpose(-1, -2))  # = 2 sin(theta) * axis
    # sin(theta) from |vee|, so that dividing vee by it is self-consistent
    # near pi. Safe to differentiate at the identity: ||vee|| has a NaN
    # derivative at 0 and every zero-residual inertial edge evaluates its
    # Jacobian exactly there, so the small-angle branch never touches theta
    # and the guard sits BEFORE the sqrt / atan2.
    n2 = torch.sum(vee_part * vee_part, dim=-1)
    small = (n2 < 1e-10) & (cos_t > 0.0)  # ||vee|| is also ~0 at theta ~ pi
    safe_n2 = torch.where(small, torch.ones_like(n2), n2)
    sin_t = 0.5 * torch.sqrt(safe_n2)  # dummy 0.5 in the small branch
    theta = torch.where(small, torch.zeros_like(n2), torch.atan2(sin_t, cos_t))

    # Generic branch: phi = theta / (2 sin theta) * vee(R - R^T).
    near_pi = theta > 3.0
    k = torch.where(small, torch.full_like(n2, 0.5), theta / (2.0 * sin_t))
    phi_generic = k[..., None] * vee_part

    # Near-pi branch: diag(R)_i = cos + (1 - cos) a_i^2; the dominant axis
    # component is taken positive and the others come from the symmetric
    # part (R + R^T)/2 = cos I + (1 - cos) a a^T.
    one_minus_cos = torch.clamp(1.0 - cos_t, min=1e-12)
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    a2 = torch.clamp((diag - cos_t[..., None]) / one_minus_cos[..., None], min=0.0)
    a_abs = torch.sqrt(a2)
    sym = 0.5 * (R + R.transpose(-1, -2))
    k_idx = torch.argmax(a_abs, dim=-1)
    eye = torch.eye(3, dtype=torch.bool, device=R.device)

    def take_axis(i):
        ak = torch.clamp(a_abs[..., i], min=1e-12)
        a = sym[..., i, :] / one_minus_cos[..., None] / ak[..., None]
        return torch.where(eye[i], ak[..., None], a)

    axes = torch.stack([take_axis(i) for i in range(3)], dim=-2)  # [..., 3, 3]
    a_pi = torch.gather(axes, -2, k_idx[..., None, None].expand(k_idx.shape + (1, 3)))[..., 0, :]
    a_pi = a_pi / torch.clamp(torch.linalg.vector_norm(a_pi, dim=-1, keepdim=True), min=1e-12)
    # Sign of the axis from vee where it is informative (exactly at pi
    # vee = 0 and either sign is a valid log).
    neg = torch.sum(a_pi * vee_part, dim=-1, keepdim=True) < 0.0
    phi_pi = theta[..., None] * torch.where(neg, -a_pi, a_pi)
    return torch.where(near_pi[..., None], phi_pi, phi_generic)


def so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J_l of SO(3)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    _, B, C = _sincos_coeffs(theta2)
    W = hat(phi)
    return _eye_like(W) + B[..., None, None] * W + C[..., None, None] * (W @ W)


def so3_left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian (closed form)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    small = theta2 < _EPS
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    half_t = 0.5 * torch.sqrt(safe_t2)
    k_exact = (1.0 - half_t / torch.tan(half_t)) / safe_t2
    k_taylor = 1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0
    k = torch.where(small, k_taylor, k_exact)
    W = hat(phi)
    return _eye_like(W) - 0.5 * W + k[..., None, None] * (W @ W)


def so3_right_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """Right Jacobian J_r(phi) = J_l(-phi) (the reference's
    ``RightJacobianSO3`` of IMU preintegration)."""
    return so3_left_jacobian(-phi)


def so3_right_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian."""
    return so3_left_jacobian_inv(-phi)


def se3_exp(xi: torch.Tensor):
    """exp: [..., 6] (rho, phi) -> (R [..., 3, 3], t [..., 3])."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = torch.einsum("...ij,...j->...i", so3_left_jacobian(phi), rho)
    return R, t


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] by the triple product (no LU launch)."""
    return torch.sum(M[..., 0, :] * torch.linalg.cross(M[..., 1, :], M[..., 2, :]), dim=-1)


POLAR_ITERS = 5  # float32 round-off reached for inputs up to 1.0 off a rotation


def normalize_rotation(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation onto SO(3) (the reference's
    ``IMU::NormalizeRotation``): its orthogonal polar factor, by
    determinant-scaled Newton iteration X <- (g X + cof(X) / (g det X)) / 2,
    g = |det X|^(-1/3), with the cofactor rows taken as cross products of
    the rows (cof(X) = det(X) X^-T). A fixed number of elementwise steps: no
    solver call and no host read, so it runs inside a captured CUDA graph.
    For a nonsingular input with det > 0 this is the SVD projection of the
    JAX package; an input with a non-finite entry (an LM step from a failed
    Cholesky) gives NaN, as there."""
    X = R
    for _ in range(POLAR_ITERS):
        cof = torch.linalg.cross(X.roll(-1, dims=-2), X.roll(-2, dims=-2))
        det = torch.sum(X * cof, dim=(-1, -2)) / 3.0  # each row's dot product is det
        g = torch.abs(det).pow(-1.0 / 3.0)
        X = 0.5 * (g[..., None, None] * X + cof / (g * det)[..., None, None])
    return X


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """log: (R, t) -> [..., 6] (rho, phi)."""
    phi = so3_log(R)
    rho = torch.einsum("...ij,...j->...i", so3_left_jacobian_inv(phi), t)
    return torch.cat([rho, phi], dim=-1)


def se3_mul(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb)."""
    return Ra @ Rb, torch.einsum("...ij,...j->...i", Ra, tb) + ta


def se3_inv(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -torch.einsum("...ij,...j->...i", Rt, t)


def se3_apply(R, t, x):
    """Apply the pose (R, t) to points ``x`` [..., 3] (broadcasting over
    point batches)."""
    return torch.einsum("...ij,...j->...i", R, x) + t


# ---------------------------------------------------------------------------
# Sim(3): (R, t, s) with action x -> s R x + t; tangent zeta = (rho, phi, sigma).
# ---------------------------------------------------------------------------


def _sim3_V(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The [..., 3, 3] matrix V with t = V rho in exp(rho, phi, sigma):
    A I + B hat(phi) + C hat(phi)^2, the coefficients of integrating
    exp(sigma u) exp(phi^ u) over u in [0, 1] (g2o's sim3.h closed form),
    with the JAX package's Taylor branches at sigma ~ 0 and theta ~ 0."""
    theta2 = torch.sum(phi * phi, dim=-1)
    small_t = theta2 < _EPS
    one = torch.ones_like(theta2)
    safe_t2 = torch.where(small_t, one, theta2)
    theta = torch.sqrt(safe_t2)
    small_s = torch.abs(sigma) < 1e-5
    safe_sigma = torch.where(small_s, one, sigma)
    sig2 = safe_sigma * safe_sigma
    es = torch.exp(sigma)

    A_big = torch.where(small_s, one, (es - 1.0) / safe_sigma)
    A_taylor = 1.0 + sigma / 2.0 + sigma * sigma / 6.0
    A = torch.where(small_s, A_taylor, A_big)

    denom = sig2 + safe_t2
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    B_full = (es * sin_t * safe_sigma + (1.0 - es * cos_t) * theta) / (theta * denom)
    B_sigma0 = (1.0 - cos_t) / safe_t2
    B = torch.where(small_s, B_sigma0, B_full)
    B_t0 = torch.where(small_s, 0.5 * one, (safe_sigma * es - es + 1.0) / sig2)
    B = torch.where(small_t, B_t0, B)

    C_full = (A - ((es * cos_t - 1.0) * safe_sigma + es * sin_t * theta) / denom) / safe_t2
    C_sigma0 = (theta - sin_t) / (safe_t2 * theta)
    C = torch.where(small_s, C_sigma0, C_full)
    C_t0 = torch.where(
        small_s, one / 6.0, ((0.5 * sig2 - safe_sigma + 1.0) * es - 1.0) / (sig2 * safe_sigma)
    )
    C = torch.where(small_t, C_t0, C)

    W = hat(phi)
    return A[..., None, None] * _eye_like(W) + B[..., None, None] * W + C[..., None, None] * (W @ W)


def sim3_exp(zeta: torch.Tensor):
    """exp: [..., 7] (rho, phi, sigma) -> (R, t, s)."""
    rho, phi, sigma = zeta[..., :3], zeta[..., 3:6], zeta[..., 6]
    t = torch.einsum("...ij,...j->...i", _sim3_V(phi, sigma), rho)
    return so3_exp(phi), t, torch.exp(sigma)


def sim3_log(R: torch.Tensor, t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """log: (R, t, s) -> [..., 7], the inverse of :func:`sim3_exp`: rho
    solves V rho = t, by the closed-form 3x3 inverse (no solver call)."""
    from .ba import inv3x3

    phi = so3_log(R)
    sigma = torch.log(s)
    rho = torch.einsum("...ij,...j->...i", inv3x3(_sim3_V(phi, sigma)), t)
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def sim3_mul(Ra, ta, sa, Rb, tb, sb):
    """Composition of x -> sa Ra x + ta after x -> sb Rb x + tb."""
    return Ra @ Rb, sa[..., None] * torch.einsum("...ij,...j->...i", Ra, tb) + ta, sa * sb


def sim3_inv(R, t, s):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return Rt, -s_inv[..., None] * torch.einsum("...ij,...j->...i", Rt, t), s_inv


def sim3_apply(R, t, s, x):
    return s[..., None] * torch.einsum("...ij,...j->...i", R, x) + t


# ---------------------------------------------------------------------------
# Quaternion <-> matrix (serialization: the loop-closure problem dump,
# ``utils/optdump.py``). ``utils/trajectory.py`` keeps its own numpy copy.
# ---------------------------------------------------------------------------


def quat_from_rotmat(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> unit quaternion [..., 4] as (qw, qx, qy, qz), qw >= 0.

    Branch-free Shepperd method: the candidate built on the largest of the
    four squared magnitudes, as the JAX package's."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = torch.clamp(1.0 + tr, min=0.0)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)
    cand = torch.stack([
        torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], dim=-1),
    ], dim=-2)  # [..., 4 (candidate), 4 (component)]
    idx = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)
    q = torch.gather(cand, -2, idx[..., None, None].expand(*idx.shape, 1, 4))[..., 0, :]
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def rotmat_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (qw, qx, qy, qz) [..., 4], normalized first -> [..., 3, 3]."""
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)
