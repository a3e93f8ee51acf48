"""IMU preintegration on manifold — port of ``orb_slam3_ros_tpu.ops.imu``
(the reference's ``IMU::Preintegrated``, ImuTypes.cc:177-312).

State per keyframe pair: ``dR`` [3,3], ``dV`` [3], ``dP`` [3], bias
Jacobians ``JRg JVg JVa JPg JPa`` [3,3], covariance ``C`` [15,15] over
[theta(3), v(3), p(3), bg(3), ba(3)], integrated time ``dT`` and the
linearization bias ``b_lin`` [6] = [bg, ba] (gyro first).

Measurements come in fixed-capacity buffers ``(acc [N,3], gyro [N,3],
dt [N])`` whose ``dt == 0`` rows are padding and integrate as no-ops.
Every function here is batched over leading dimensions: where the JAX
package maps ``preintegrate`` over a window of keyframe pairs with
``jax.vmap``, the port passes ``acc [W,N,3]``, ``b_lin [W,6]`` at once.

Two integrators, as in the JAX package: ``preintegrate_sequential`` is the
reference's per-sample recursion, ``preintegrate`` composes per-sample
segments pairwise in a log2(N)-depth tree (same pairing order as the JAX
package's, so the two trees agree to rounding).

The JAX package differentiates the residuals with forward-mode AD. Here
``inertial_residual_jac`` returns the residual with its closed-form
Jacobians (those of the reference's ``EdgeInertial::linearizeOplus``,
G2oTypes.cc): eager torch pays for every launched operation, and the
closed form is a few dozen of them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from . import lie


class ImuCalib(NamedTuple):
    """Noise calibration (role of ``IMU::Calib``). ``sigma_g/sigma_a`` are
    the discrete noise densities (continuous density * sqrt(rate)), the
    walk sigmas divided by sqrt(rate); ``R_bc/t_bc`` the camera-in-body
    extrinsics."""

    sigma_g: torch.Tensor  # [3] gyro noise (discrete)
    sigma_a: torch.Tensor  # [3] accel noise (discrete)
    sigma_gw: torch.Tensor  # [3] gyro random walk (discrete)
    sigma_aw: torch.Tensor  # [3] accel random walk (discrete)
    R_bc: torch.Tensor  # [3,3]
    t_bc: torch.Tensor  # [3]


GRAVITY = 9.81  # reference GRAVITY_VALUE


def gravity_vec(like: torch.Tensor) -> torch.Tensor:
    """(0, 0, -GRAVITY) with the dtype and device of ``like``."""
    return torch.eye(3, dtype=like.dtype, device=like.device)[2] * -GRAVITY


class Preintegrated(NamedTuple):
    """Preintegration state (role of ``IMU::Preintegrated``); every field
    may carry leading batch dimensions."""

    dR: torch.Tensor  # [3,3]
    dV: torch.Tensor  # [3]
    dP: torch.Tensor  # [3]
    JRg: torch.Tensor  # [3,3] d(dR)/d(bg)
    JVg: torch.Tensor  # [3,3]
    JVa: torch.Tensor  # [3,3]
    JPg: torch.Tensor  # [3,3]
    JPa: torch.Tensor  # [3,3]
    C: torch.Tensor  # [15,15] cov of [theta, v, p, bg, ba]
    dT: torch.Tensor  # [] total time
    b_lin: torch.Tensor  # [6] linearization bias [bg, ba]


def calib_from_numpy(arrays, device) -> ImuCalib:
    """ImuCalib on ``device`` from a mapping (or NamedTuple ``_asdict``) of
    numpy arrays keyed by field name."""
    return ImuCalib(**{
        k: torch.from_numpy(np.array(arrays[k], dtype=np.float32, copy=True)).to(device)
        for k in ImuCalib._fields
    })


def preintegrated_from_numpy(arrays, device) -> Preintegrated:
    """Preintegrated on ``device`` from a mapping of numpy arrays keyed by
    field name and laid out like the JAX package's."""
    return Preintegrated(**{
        k: torch.from_numpy(np.array(arrays[k], copy=True)).to(device)
        for k in Preintegrated._fields
    })


def preintegrated_to_numpy(pre: Preintegrated) -> dict:
    return {k: getattr(pre, k).detach().cpu().numpy() for k in Preintegrated._fields}


def init_preintegrated(b_lin=None, dtype=torch.float32, device=None, batch=()) -> Preintegrated:
    """The identity element. On ``b_lin``'s device when it is given, else on
    ``device`` (None: the CUDA device)."""
    batch = tuple(batch)
    device = b_lin.device if b_lin is not None else resolve_device(device)
    kw = dict(dtype=dtype, device=device)
    z33 = torch.zeros(batch + (3, 3), **kw)
    z3 = torch.zeros(batch + (3,), **kw)
    return Preintegrated(
        dR=torch.eye(3, **kw).expand(batch + (3, 3)),
        dV=z3, dP=z3, JRg=z33, JVg=z33, JVa=z33, JPg=z33, JPa=z33,
        C=torch.zeros(batch + (15, 15), **kw),
        dT=torch.zeros(batch, **kw),
        b_lin=torch.zeros(batch + (6,), **kw) if b_lin is None else b_lin,
    )


def _noise(calib: ImuCalib, dtype):
    nga = torch.cat([calib.sigma_g**2, calib.sigma_a**2]).to(dtype)
    nga_walk = torch.cat([calib.sigma_gw**2, calib.sigma_aw**2]).to(dtype)
    return nga, nga_walk


def _mv(A, x):
    return torch.einsum("...ij,...j->...i", A, x)


def _T(A):
    return A.transpose(-1, -2)


def _block(rows):
    """Block matrix [..., 3r, 3c] from rows of [..., 3, 3] blocks."""
    return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)


def _integrate_step(state: Preintegrated, acc_raw, gyro_raw, dt, nga, nga_walk) -> Preintegrated:
    """One measurement update (ImuTypes.cc:177-235); ``dt`` [...] with a
    ``dt == 0`` row a no-op."""
    bg, ba = state.b_lin[..., :3], state.b_lin[..., 3:]
    acc = acc_raw - ba
    omega = gyro_raw - bg
    dR, dV, dP = state.dR, state.dV, state.dP
    d1 = dt[..., None]
    d2 = dt[..., None, None]

    # Position/velocity first (they use the pre-update rotation).
    Ra = _mv(dR, acc)
    dP_new = dP + dV * d1 + 0.5 * Ra * d1 * d1
    dV_new = dV + Ra * d1

    # Bias Jacobians (pre-update rotation, pre-update JRg).
    RW = dR @ lie.hat(acc)
    RWJ = RW @ state.JRg
    JPa_new = state.JPa + state.JVa * d2 - 0.5 * d2 * d2 * dR
    JPg_new = state.JPg + state.JVg * d2 - 0.5 * d2 * d2 * RWJ
    JVa_new = state.JVa - dR * d2
    JVg_new = state.JVg - d2 * RWJ

    # Rotation increment.
    phi = omega * d1
    dRi = lie.so3_exp(phi)
    rightJ = lie.so3_right_jacobian(phi)
    dR_new = lie.normalize_rotation(dR @ dRi)
    JRg_new = _T(dRi) @ state.JRg - rightJ * d2

    # Covariance propagation: x9 = [theta, v, p], A [9,9], B [9,6] with
    # noise vector [n_g, n_a].
    I3 = torch.eye(3, dtype=dR.dtype, device=dR.device).expand(dR.shape)
    Z3 = torch.zeros_like(dR)
    A = _block([
        [_T(dRi), Z3, Z3],
        [-d2 * RW, I3, Z3],
        [-0.5 * d2 * d2 * RW, I3 * d2, I3],
    ])
    B = _block([
        [rightJ * d2, Z3],
        [Z3, dR * d2],
        [Z3, 0.5 * d2 * d2 * dR],
    ])
    C9 = state.C[..., :9, :9]
    C9_new = A @ C9 @ _T(A) + (B * nga) @ _T(B)
    on = dt > 0
    on1, on2 = on[..., None], on[..., None, None]
    Cw = state.C[..., 9:, 9:] + torch.diag(nga_walk) * on2.to(dR.dtype)
    Z96 = torch.zeros(dR.shape[:-2] + (9, 6), dtype=dR.dtype, device=dR.device)
    C_new = torch.cat([
        torch.cat([torch.where(on2, C9_new, C9), Z96], dim=-1),
        torch.cat([_T(Z96), Cw], dim=-1),
    ], dim=-2)
    return Preintegrated(
        dR=torch.where(on2, dR_new, dR),
        dV=torch.where(on1, dV_new, dV),
        dP=torch.where(on1, dP_new, dP),
        JRg=torch.where(on2, JRg_new, state.JRg),
        JVg=torch.where(on2, JVg_new, state.JVg),
        JVa=torch.where(on2, JVa_new, state.JVa),
        JPg=torch.where(on2, JPg_new, state.JPg),
        JPa=torch.where(on2, JPa_new, state.JPa),
        C=C_new,
        dT=state.dT + dt,
        b_lin=state.b_lin,
    )


def preintegrate_sequential(acc, gyro, dts, b_lin, calib: ImuCalib) -> Preintegrated:
    """Per-sample recursion over the N rows (the reference's
    ``Reintegrate`` loop) — the parity reference of ``preintegrate``.
    ``acc/gyro`` [..., N, 3], ``dts`` [..., N], ``b_lin`` [..., 6]."""
    nga, nga_walk = _noise(calib, acc.dtype)
    state = init_preintegrated(b_lin, acc.dtype, acc.device, batch=acc.shape[:-2])
    for k in range(acc.shape[-2]):
        state = _integrate_step(
            state, acc[..., k, :], gyro[..., k, :], dts[..., k].to(acc.dtype), nga, nga_walk
        )
    return state


def _compose_preint(a: dict, b: dict) -> dict:
    """Exact composition of two preintegrated segments (A then B, same
    linearization bias) — the algebra of the reference's ``MergePrevious``
    with covariance and bias Jacobians composed in closed form. Elements
    are dicts of stacked tensors with leading batch dims."""
    dR_A, dV_A, dP_A, dT_A = a["dR"], a["dV"], a["dP"], a["dT"]
    dR_B, dV_B, dP_B, dT_B = b["dR"], b["dV"], b["dP"], b["dT"]
    e = dT_B[..., None]
    e2 = e[..., None]
    dV = dV_A + _mv(dR_A, dV_B)
    dP = dP_A + dV_A * e + _mv(dR_A, dP_B)
    hV = lie.hat(dV_B)
    hP = lie.hat(dP_B)
    JRg = _T(dR_B) @ a["JRg"] + b["JRg"]
    JVa = a["JVa"] + dR_A @ b["JVa"]
    JVg = a["JVg"] + dR_A @ b["JVg"] - dR_A @ (hV @ a["JRg"])
    JPa = a["JPa"] + a["JVa"] * e2 + dR_A @ b["JPa"]
    JPg = a["JPg"] + a["JVg"] * e2 + dR_A @ b["JPg"] - dR_A @ (hP @ a["JRg"])
    # 9x9 error-state composition: C = F C_A F^T + T C_B T^T with
    # F = [[dR_B^T,0,0],[-dR_A hat(dV_B),I,0],[-dR_A hat(dP_B),dT_B,I]]
    # and T = diag(I, dR_A, dR_A).
    I3 = torch.eye(3, dtype=dR_A.dtype, device=dR_A.device).expand(dR_A.shape)
    Z3 = torch.zeros_like(dR_A)
    F = _block([
        [_T(dR_B), Z3, Z3],
        [-(dR_A @ hV), I3, Z3],
        [-(dR_A @ hP), I3 * e2, I3],
    ])
    T = _block([[I3, Z3, Z3], [Z3, dR_A, Z3], [Z3, Z3, dR_A]])
    C9 = F @ (a["C9"] @ _T(F)) + T @ (b["C9"] @ _T(T))
    return dict(
        dR=lie.normalize_rotation(dR_A @ dR_B),
        dV=dV, dP=dP, dT=dT_A + dT_B,
        JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa,
        C9=C9, Cw=a["Cw"] + b["Cw"],
    )


def preintegrate(acc, gyro, dts, b_lin, calib: ImuCalib) -> Preintegrated:
    """Integrate a (padded) window of measurements from scratch by tree
    reduction: per-sample segment statistics once, then log2(N) pairwise
    ``_compose_preint`` halvings.

    ``acc/gyro`` [..., N, 3] (body frame, gravity included), ``dts``
    [..., N] with 0 rows as padding, ``b_lin`` [..., 6]. Matches
    ``preintegrate_sequential`` up to reassociation."""
    dtype, dev = acc.dtype, acc.device
    batch = acc.shape[:-2]
    N = acc.shape[-2]
    nga, nga_walk = _noise(calib, dtype)
    a_c = acc - b_lin[..., None, 3:]
    w_c = gyro - b_lin[..., None, :3]
    dt = dts.to(dtype)
    on = dt > 0
    active = on.to(dtype)
    # Per-sample standalone segments (prefix rotation = identity); dt == 0
    # rows are the identity element.
    phi = w_c * dt[..., None]
    dRi = lie.so3_exp(phi)
    rJ = lie.so3_right_jacobian(phi)
    eye = torch.eye(3, dtype=dtype, device=dev).expand(batch + (N, 3, 3))
    dtc = dt[..., None, None]
    onc = on[..., None, None]
    Z3 = torch.zeros_like(eye)
    B = _block([[rJ * dtc, Z3], [Z3, eye * dtc], [Z3, 0.5 * eye * dtc * dtc]])
    elems = dict(
        dR=torch.where(onc, dRi, eye),
        dV=a_c * (dt * active)[..., None],
        dP=0.5 * a_c * (dt * dt * active)[..., None],
        dT=dt * active,
        JRg=-rJ * dtc * onc,
        JVg=Z3,
        JVa=-eye * dtc,
        JPg=Z3,
        JPa=-0.5 * eye * dtc * dtc,
        C9=((B * nga) @ _T(B)) * onc,
        Cw=active[..., None, None] * torch.diag(nga_walk),
    )
    # Pad to a power of two with identity elements, halve log2(N) times.
    P2 = 1 << max(0, (N - 1).bit_length())
    if P2 != N:
        n_pad = P2 - N
        axis = len(batch)

        def pad(name, x):
            shape = x.shape[:axis] + (n_pad,) + x.shape[axis + 1:]
            if name == "dR":
                fill = torch.eye(3, dtype=dtype, device=dev).expand(shape)
            else:
                fill = torch.zeros(shape, dtype=dtype, device=dev)
            return torch.cat([x, fill], dim=axis)

        elems = {k: pad(k, v) for k, v in elems.items()}
    axis = len(batch)
    n = P2
    while n > 1:
        ev = torch.arange(0, n, 2, device=dev)
        left = {k: v.index_select(axis, ev) for k, v in elems.items()}
        right = {k: v.index_select(axis, ev + 1) for k, v in elems.items()}
        elems = _compose_preint(left, right)
        n //= 2
    total = {k: v.select(axis, 0) for k, v in elems.items()}
    Z96 = torch.zeros(batch + (9, 6), dtype=dtype, device=dev)
    C = torch.cat([
        torch.cat([total["C9"], Z96], dim=-1),
        torch.cat([_T(Z96), total["Cw"]], dim=-1),
    ], dim=-2)
    return Preintegrated(
        dR=total["dR"], dV=total["dV"], dP=total["dP"],
        JRg=total["JRg"], JVg=total["JVg"], JVa=total["JVa"],
        JPg=total["JPg"], JPa=total["JPa"],
        C=C, dT=total["dT"], b_lin=b_lin,
    )


def delta_with_bias(state: Preintegrated, b_new: torch.Tensor):
    """First-order bias-corrected deltas (the reference's GetDeltaRotation /
    GetDeltaVelocity / GetDeltaPosition): (dR, dV, dP) at the new bias
    without re-integration."""
    db = b_new - state.b_lin
    dbg, dba = db[..., :3], db[..., 3:]
    dR = state.dR @ lie.so3_exp(_mv(state.JRg, dbg))
    dV = state.dV + _mv(state.JVg, dbg) + _mv(state.JVa, dba)
    dP = state.dP + _mv(state.JPg, dbg) + _mv(state.JPa, dba)
    return dR, dV, dP


def predict_state(R_wb, p_wb, v_w, b, preint: Preintegrated, gravity=None):
    """Dead-reckon a body state through a preintegrated window (the
    reference's ``Tracking::PredictStateIMU``). World frame throughout;
    returns (R_wb2, p_wb2, v_w2)."""
    g = gravity_vec(p_wb) if gravity is None else gravity
    t = preint.dT[..., None]
    dR, dV, dP = delta_with_bias(preint, b)
    R2 = lie.normalize_rotation(R_wb @ dR)
    v2 = v_w + g * t + _mv(R_wb, dV)
    p2 = p_wb + v_w * t + 0.5 * g * t * t + _mv(R_wb, dP)
    return R2, p2, v2


def inertial_residual(R1, p1, v1, b1, R2, p2, v2, preint: Preintegrated, gravity=None):
    """9-dim preintegration factor residual [er, ev, ep] (the reference's
    ``EdgeInertial::computeError``); ``b1`` is the bias at the first
    keyframe."""
    g = gravity_vec(p1) if gravity is None else gravity
    return inertial_residual_gs(R1, p1, v1, b1, R2, p2, v2, preint, g, 1.0)


def inertial_residual_gs(R1, p1, v1, b1, R2, p2, v2, preint: Preintegrated, gravity, scale):
    """Preintegration residual with a free metric scale on the visual-frame
    velocity / position differences (``EdgeInertialGS::computeError``):
    ev = R1^T (s (v2 - v1) - g dt) - dV,
    ep = R1^T (s (p2 - p1 - v1 dt) - 0.5 g dt^2) - dP."""
    t = preint.dT[..., None]
    dR, dV, dP = delta_with_bias(preint, b1)
    R1t = _T(R1)
    er = lie.so3_log(_T(dR) @ R1t @ R2)
    ev = _mv(R1t, scale * (v2 - v1) - gravity * t) - dV
    ep = _mv(R1t, scale * (p2 - p1 - v1 * t) - 0.5 * gravity * t * t) - dP
    return torch.cat([er, ev, ep], dim=-1)


class InertialJac(NamedTuple):
    """Residual of one preintegration factor with its Jacobians, for the
    state perturbation R <- R exp(phi), p <- p + R dp, the rest additive.
    Columns of the pose blocks are [phi, dp]. ``gravity`` is the Jacobian
    with respect to the world gravity VECTOR and ``log_scale`` the one with
    respect to the log of the scale (zero rows for er)."""

    r: torch.Tensor  # [..., 9]
    pose1: torch.Tensor  # [..., 9, 6]
    v1: torch.Tensor  # [..., 9, 3]
    bg: torch.Tensor  # [..., 9, 3]
    ba: torch.Tensor  # [..., 9, 3]
    pose2: torch.Tensor  # [..., 9, 6]
    v2: torch.Tensor  # [..., 9, 3]
    gravity: torch.Tensor  # [..., 9, 3]
    log_scale: torch.Tensor  # [..., 9, 1]


def inertial_residual_jac(
    R1, p1, v1, b1, R2, p2, v2, preint: Preintegrated, gravity=None, scale=1.0
) -> InertialJac:
    """``inertial_residual_gs`` and its closed-form Jacobians at the given
    states (``EdgeInertial(GS)::linearizeOplus`` of the reference, with the
    scale entering as exp of its log)."""
    g = gravity_vec(p1) if gravity is None else gravity
    t = preint.dT[..., None]
    t2 = t[..., None]
    db = b1 - preint.b_lin
    phi_b = _mv(preint.JRg, db[..., :3])
    dR = preint.dR @ lie.so3_exp(phi_b)
    dV = preint.dV + _mv(preint.JVg, db[..., :3]) + _mv(preint.JVa, db[..., 3:])
    dP = preint.dP + _mv(preint.JPg, db[..., :3]) + _mv(preint.JPa, db[..., 3:])
    R1t = _T(R1)
    eR = _T(dR) @ R1t @ R2
    er = lie.so3_log(eR)
    dv_w = scale * (v2 - v1) - g * t
    dp_w = scale * (p2 - p1 - v1 * t) - 0.5 * g * t * t
    ev_b = _mv(R1t, dv_w)
    ep_b = _mv(R1t, dp_w)
    r = torch.cat([er, ev_b - dV, ep_b - dP], dim=-1)

    invJr = lie.so3_right_jacobian_inv(er)
    Z3 = torch.zeros(
        torch.broadcast_shapes(R1.shape, R2.shape, preint.dR.shape), dtype=R1.dtype, device=R1.device
    )
    I3 = torch.eye(3, dtype=R1.dtype, device=R1.device).expand(Z3.shape)
    R1t = R1t.expand(Z3.shape)
    sR1t = scale * R1t
    pose1 = torch.cat([
        torch.cat([-invJr @ _T(R2) @ R1, Z3], dim=-1),
        torch.cat([lie.hat(ev_b), Z3], dim=-1),
        torch.cat([lie.hat(ep_b), -scale * I3], dim=-1),
    ], dim=-2)
    Jv1 = torch.cat([Z3, -sR1t, -sR1t * t2], dim=-2)
    Jbg = torch.cat([
        -invJr @ _T(eR) @ lie.so3_right_jacobian(phi_b) @ preint.JRg,
        -preint.JVg.expand(Z3.shape), -preint.JPg.expand(Z3.shape),
    ], dim=-2)
    Jba = torch.cat([Z3, -preint.JVa.expand(Z3.shape), -preint.JPa.expand(Z3.shape)], dim=-2)
    pose2 = torch.cat([
        torch.cat([invJr, Z3], dim=-1),
        torch.cat([Z3, Z3], dim=-1),
        torch.cat([Z3, sR1t @ R2], dim=-1),
    ], dim=-2)
    Jv2 = torch.cat([Z3, sR1t, Z3], dim=-2)
    Jg = torch.cat([Z3, -R1t * t2, -0.5 * R1t * t2 * t2], dim=-2)
    z = torch.zeros_like(er)
    Js = torch.cat([
        z, _mv(R1t, scale * (v2 - v1)), _mv(R1t, scale * (p2 - p1 - v1 * t)),
    ], dim=-1)[..., None]
    return InertialJac(r, pose1, Jv1, Jbg, Jba, pose2, Jv2, Jg, Js)
