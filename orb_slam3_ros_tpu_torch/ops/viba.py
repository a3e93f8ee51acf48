"""Visual-inertial bundle adjustment, IMU initialization and the per-frame
15-dof pose optimization — port of ``orb_slam3_ros_tpu.ops.viba`` (the
reference's ``LocalInertialBA``, ``FullInertialBA``,
``InertialOptimization`` and ``PoseInertialOptimizationLast*``).

Body state per keyframe: (R_wb [3,3], p_wb [3], v_w [3], bg [3], ba [3]).
Perturbation (15): [phi, dp, dv, dbg, dba] with R <- R exp(phi^),
p <- p + R dp (body frame), the rest additive.

Differences of form from the JAX package, none of result:

* The JAX package takes every Jacobian by forward-mode AD of the residual
  functions. Here they are closed forms (``imu.inertial_residual_jac``,
  ``_visual_res_jac``): eager torch pays for each launched operation. The
  tests hold them against AD of the residuals as functions of the
  perturbation (``tests/test_torch_viba.py``, ``tests/test_torch_imu.py``).
* ``vi_bundle_adjust`` and ``vi_bundle_adjust_gs`` share one LM loop: the
  plain solver is the gravity/scale one with its three extra unknowns
  masked out (identity rows in the reduced system) at Rwg = I, s = 1.
* Only the scatter formulation (``index_add_``) of the block accumulation
  is ported; the ``row_n`` compare-reduce form was a TPU workaround.
* A Cholesky factorization or an inverse that fails gives NaN instead of
  raising (``ops/linalg.py``); the step's cost is then NaN and the step is
  rejected by ``cost_new < cost``, as in the JAX package. No solver reads
  anything back to the host.

One difference of result: the visual rows project through the frame's
camera (the solvers' ``cam_model``: pinhole or KB8, as ORB-SLAM3's
EdgeMono projects through ``pCamera``); the JAX package projects them
through the pinhole model whatever the camera (viba.py:88, :100; ROADMAP
"Known faults"). The pinhole rows are unchanged.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import cameras, imu, lie, linalg, robust
from .ba import inv3x3, reduce, schur_rows


class VIStates(NamedTuple):
    R_wb: torch.Tensor  # [K,3,3]
    p_wb: torch.Tensor  # [K,3]
    v_w: torch.Tensor  # [K,3]
    bg: torch.Tensor  # [K,3]
    ba: torch.Tensor  # [K,3]


class VIBAProblem(NamedTuple):
    states: VIStates
    kf_fixed: torch.Tensor  # [K] bool (the 6-dof pose only; v and biases stay free)
    kf_valid: torch.Tensor  # [K]
    X: torch.Tensor  # [P,3]
    pt_valid: torch.Tensor  # [P]
    # visual edges
    cam_idx: torch.Tensor  # [E]
    pt_idx: torch.Tensor  # [E]
    uv: torch.Tensor  # [E,2]
    inv_sigma2: torch.Tensor  # [E]
    edge_valid: torch.Tensor  # [E]
    # inertial edges (consecutive keyframe pairs i -> j)
    ie_i: torch.Tensor  # [Q] int32
    ie_j: torch.Tensor  # [Q]
    ie_preint: imu.Preintegrated  # stacked [Q, ...]
    ie_valid: torch.Tensor  # [Q]
    # calibration
    cam_params: torch.Tensor  # [9]
    R_bc: torch.Tensor  # [3,3] camera-in-body
    t_bc: torch.Tensor  # [3]
    # stereo rows: observed right-image u (u_r = u - bf/z); ur < 0 marks a
    # mono-only edge
    ur: torch.Tensor | None = None  # [E]
    bf: torch.Tensor | float = 0.0  # fx * baseline


def states_from_numpy(arrays, device) -> VIStates:
    return VIStates(**{
        k: torch.from_numpy(np.array(arrays[k], copy=True)).to(device) for k in VIStates._fields
    })


def problem_from_numpy(arrays, device) -> VIBAProblem:
    """VIBAProblem on ``device`` from a mapping of numpy arrays keyed by
    field name, with ``states`` and ``ie_preint`` mappings of their own
    (the JAX package's problem as a numpy tree)."""
    kw = {}
    for k in VIBAProblem._fields:
        v = arrays[k]
        if k == "states":
            kw[k] = states_from_numpy(v, device)
        elif k == "ie_preint":
            kw[k] = imu.preintegrated_from_numpy(v, device)
        elif v is None:
            kw[k] = None
        else:
            kw[k] = torch.from_numpy(np.array(v, copy=True)).to(device)
    return VIBAProblem(**kw)


# ---------------------------------------------------------------------------
# Camera <-> body pose conversion (role of g2o ImuCamPose)
# ---------------------------------------------------------------------------


def body_from_cam(R_cw, t_cw, R_bc, t_bc):
    """Tcw (camera) -> (R_wb, p_wb): X_b = R_bc X_c + t_bc."""
    R_bw = torch.einsum("ij,...jk->...ik", R_bc, R_cw)
    t_bw = torch.einsum("ij,...j->...i", R_bc, t_cw) + t_bc
    R_wb = R_bw.transpose(-1, -2)
    p_wb = -torch.einsum("...ij,...j->...i", R_wb, t_bw)
    return R_wb, p_wb


def cam_from_body(R_wb, p_wb, R_bc, t_bc):
    """(R_wb, p_wb) -> Tcw."""
    R_bw = R_wb.transpose(-1, -2)
    t_bw = -torch.einsum("...ij,...j->...i", R_bw, p_wb)
    R_cw = torch.einsum("ji,...jk->...ik", R_bc, R_bw)
    t_cw = torch.einsum("ji,...j->...i", R_bc, t_bw - t_bc)
    return R_cw, t_cw


# ---------------------------------------------------------------------------
# Residuals
# ---------------------------------------------------------------------------


def _mv(A, x):
    return torch.einsum("...ij,...j->...i", A, x)


def _apply_pert(R, p, v, bg, ba, eps):
    """15-dim state perturbation (batched over leading dimensions)."""
    R2 = R @ lie.so3_exp(eps[..., 0:3])
    p2 = p + _mv(R, eps[..., 3:6])
    return R2, p2, v + eps[..., 6:9], bg + eps[..., 9:12], ba + eps[..., 12:15]


def _visual_res(R, p, X, uv, cam_params, R_bc, t_bc, ur=None, rmask3=None, bf=None,
                cam_model="pinhole"):
    """Per-edge reprojection residual through the body pose (EdgeMono with
    ImuCamPose, G2oTypes.h:342, which projects through the frame's camera
    object): [E,2], or [E,3] = (u, v, u_r) when ``ur`` is given, the third
    row multiplied by ``rmask3`` (0 on mono edges; the caller zeroes it on
    every edge of a KB8 camera). ``cam_model`` selects the projection
    (``cameras.project_model``). Also returns the point in the body and
    camera frames."""
    Xb = torch.einsum("...ji,...j->...i", R, X - p)
    Xc = (Xb - t_bc) @ R_bc
    r = cameras.project_model(cam_params, Xc, cam_model) - uv
    if ur is not None:
        z = torch.clamp(Xc[..., 2], min=1e-6)
        r3 = (r[..., 0] + uv[..., 0] - bf / z - ur) * rmask3
        r = torch.cat([r, r3[..., None]], dim=-1)
    return r, Xb, Xc


def _visual_res_jac(R, p, X, uv, cam_params, R_bc, t_bc, ur=None, rmask3=None, bf=None,
                    cam_model="pinhole"):
    """``_visual_res`` with its Jacobians with respect to the body pose
    perturbation [phi, dp] ([E,r,6]) and the point ([E,r,3]); the
    projection's Jacobian is ``cameras.project_jac_model``'s (KB8's in
    closed form)."""
    r, Xb, Xc = _visual_res(R, p, X, uv, cam_params, R_bc, t_bc, ur, rmask3, bf, cam_model)
    Jproj = cameras.project_jac_model(cam_params, Xc, cam_model)  # [E,2,3]
    if ur is not None:
        # d(u - bf/z)/dXc = du/dXc + (bf / z^2) e_z where z is not clamped
        zc = Xc[..., 2]
        dz = torch.where(zc > 1e-6, bf / torch.clamp(zc, min=1e-6) ** 2, torch.zeros_like(zc))
        e_z = torch.eye(3, dtype=X.dtype, device=X.device)[2]
        Jur = (Jproj[..., 0, :] + e_z * dz[..., None]) * rmask3[..., None]
        Jproj = torch.cat([Jproj, Jur[..., None, :]], dim=-2)  # [E,3,3]
    JXb = Jproj @ R_bc.transpose(-1, -2)  # dXc/dXb = R_bc^T
    eye = torch.eye(3, dtype=X.dtype, device=X.device).expand(Xb.shape[:-1] + (3, 3))
    # Xb(phi, dp) = exp(-phi^) R^T (X - p) - dp
    Jc = JXb @ torch.cat([lie.hat(Xb), -eye], dim=-1)
    Jp = JXb @ R.transpose(-1, -2)
    return r, Jc, Jp


def _sym(M):
    return 0.5 * (M + M.transpose(-1, -2))


def _info_from_cov(C, dim_slice, eps=1e-8):
    """Robust inverse of a covariance block (batched over leading dims)."""
    Cb = C[..., dim_slice, dim_slice]
    eye = torch.eye(Cb.shape[-1], dtype=C.dtype, device=C.device)
    return linalg.inv(_sym(Cb) + eps * eye)


def _edge_info15(C):
    """[Q,15,15] block-diagonal information of one inertial edge's 15
    residual rows: the 9-dim preintegration factor, then the gyro and the
    accelerometer bias walks (EdgeInertial / EdgeGyroRW / EdgeAccRW)."""
    info = torch.zeros_like(C)
    info[..., 0:9, 0:9] = _info_from_cov(C, slice(0, 9))
    info[..., 9:12, 9:12] = _info_from_cov(C, slice(9, 12))
    info[..., 12:15, 12:15] = _info_from_cov(C, slice(12, 15))
    return info


def _huber_rho(chi2, delta2):
    return torch.where(
        chi2 <= delta2, chi2, 2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=1e-12)) - delta2
    )


class VIBAResult(NamedTuple):
    states: VIStates
    X: torch.Tensor
    cost: torch.Tensor
    chi2_visual: torch.Tensor  # [E]
    inlier: torch.Tensor  # [E]
    lam: torch.Tensor | None = None  # final LM damping


class VIBAGSResult(NamedTuple):
    states: VIStates
    X: torch.Tensor
    Rwg: torch.Tensor  # [3,3] refined gravity-alignment rotation
    scale: torch.Tensor  # [] refined metric scale of the visual map
    cost: torch.Tensor
    chi2_visual: torch.Tensor
    inlier: torch.Tensor


def _vi_lm(
    prob: VIBAProblem, Rwg0, free_g, n_iters, chi2_th, use_robust, bias_prior_g, bias_prior_a, lam0,
    comm=None, cam_model="pinhole",
):
    """The LM loop of both VI bundle adjustments: 15-dof body states, Schur-
    eliminated landmarks and a 3-dim border [dtheta_gx, dtheta_gy, dlog_s]
    (gravity direction about x/y, metric scale) whose free entries
    ``free_g`` selects. Returns (states, X, Rwg, s, lam, cost, chi2,
    delta2).

    ``comm``: this rank's share of a sharded problem (``ba.bundle_adjust``):
    the visual rows are summed as there; the states, the inertial chain and
    the bias priors are the same on every rank, which each adds once after
    the sums. ``cam_model``: the projection of the visual rows."""
    st = prob.states
    K = st.R_wb.shape[0]
    P = prob.X.shape[0]
    D, G = 15, 3
    KD = K * D
    dtype, dev = prob.X.dtype, prob.X.device
    cam = prob.cam_idx.long()
    pt = prob.pt_idx.long()
    ii = prob.ie_i.long()
    jj = prob.ie_j.long()
    pre = prob.ie_preint

    # Stereo rows: per-edge (u, v, u_r) with the third row masked on mono
    # edges; stereo edges get the 3-dof chi2 gate. A KB8 camera is not
    # rectified, so u_r = u - bf/z does not hold there: every edge of a KB8
    # problem is a mono edge (third row masked, mono gate), the rule
    # ``ba.py`` keeps for the KB8 BA.
    ur = prob.ur if prob.ur is not None else torch.full_like(prob.uv[:, 0], -1.0)
    bf = torch.as_tensor(prob.bf, dtype=dtype, device=dev)
    has_ur = (ur >= 0.0) & (bf > 0.0)
    if cam_model == "kb8":
        has_ur = torch.zeros_like(has_ur)
    rmask3 = has_ur.to(dtype)
    delta2 = torch.where(
        has_ur,
        torch.full_like(ur, chi2_th * (robust.CHI2_STEREO / robust.CHI2_MONO)),
        torch.full_like(ur, chi2_th),
    )
    ur_s = torch.where(has_ur, ur, torch.zeros_like(ur))
    cal = (prob.cam_params, prob.R_bc, prob.t_bc, ur_s, rmask3, bf, cam_model)

    wq = prob.ie_valid.to(dtype)
    infoW = _edge_info15(pre.C) * wq[:, None, None]  # [Q,15,15]
    ev_w = prob.edge_valid.to(dtype)
    g_ref = imu.gravity_vec(prob.X)
    neg_hat_g = -lie.hat(g_ref)[:, :2]  # d(R exp([th,0]^) g_ref)/dth = R @ this

    def inertial_res15(st, Rwg, s):
        ri = imu.inertial_residual_gs(
            st.R_wb[ii], st.p_wb[ii], st.v_w[ii], torch.cat([st.bg[ii], st.ba[ii]], dim=-1),
            st.R_wb[jj], st.p_wb[jj], st.v_w[jj], pre, Rwg @ g_ref, s,
        )
        return torch.cat([ri, st.bg[jj] - st.bg[ii], st.ba[jj] - st.ba[ii]], dim=-1)

    def visual_chi2(st, X):
        r, _, _ = _visual_res(st.R_wb[cam], st.p_wb[cam], X[pt], prob.uv, *cal)
        return torch.sum(r * r, dim=-1) * prob.inv_sigma2

    def total_cost(st, X, Rwg, s):
        chi2 = visual_chi2(st, X)
        rho = _huber_rho(chi2, delta2) if use_robust else chi2
        c_vis = reduce(comm, "world", torch.sum(rho * ev_w))
        r15 = inertial_res15(st, Rwg, s)
        c_in = torch.einsum("qi,qij,qj->", r15, infoW, r15)
        c_prior = bias_prior_g * torch.sum(st.bg * st.bg) + bias_prior_a * torch.sum(st.ba * st.ba)
        return c_vis + c_in + c_prior

    # ``kf_fixed`` freezes only the 6-dof pose; velocities and biases are
    # free for every valid keyframe.
    free_pose = (prob.kf_valid & ~prob.kf_fixed).to(dtype)  # [K]
    free_d = torch.cat(
        [free_pose[:, None].expand(K, 6), prob.kf_valid.to(dtype)[:, None].expand(K, 9)], dim=1
    )  # [K,15]
    free_full = torch.cat([free_d.reshape(KD), free_g.to(dtype)])  # [KD+3]
    free_poseb = free_pose > 0
    diag = torch.arange(K, device=dev)
    wcp_row = cam * P + pt
    pair_idx = torch.cat([ii * K + ii, jj * K + jj, ii * K + jj, jj * K + ii])
    ij_idx = torch.cat([ii, jj])
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eyeG = torch.eye(G, dtype=dtype, device=dev)
    pr = torch.zeros((D,), dtype=dtype, device=dev)
    pr[9:12] = bias_prior_g
    pr[12:15] = bias_prior_a
    Q = ii.shape[0]
    # Bias-walk rows r = b_j - b_i of the 15-row edge Jacobian over
    # [state_i(15), state_j(15), dtheta_g(2), dlog_s(1)].
    J_walk = torch.zeros((Q, 6, 2 * D + G), dtype=dtype, device=dev)
    J_walk[:, :, 9:15] = -torch.eye(6, dtype=dtype, device=dev)
    J_walk[:, :, D + 9 : D + 15] = torch.eye(6, dtype=dtype, device=dev)
    Z93 = torch.zeros((Q, 9, 3), dtype=dtype, device=dev)

    def step(st, X, Rwg, s, lam, cost):
        # ---- visual edges ----
        r, Jc, Jp = _visual_res_jac(st.R_wb[cam], st.p_wb[cam], X[pt], prob.uv, *cal)
        chi2 = torch.sum(r * r, dim=-1) * prob.inv_sigma2
        w_rob = robust.huber_weight(chi2, delta2) if use_robust else torch.ones_like(chi2)
        w = prob.inv_sigma2 * w_rob * ev_w
        JcW = Jc * w[:, None, None]
        JpW = Jp * w[:, None, None]
        Hcc = torch.zeros((K, 6, 6), dtype=dtype, device=dev).index_add_(
            0, cam, JcW.transpose(1, 2) @ Jc
        )
        gc = torch.zeros((K, 6), dtype=dtype, device=dev).index_add_(
            0, cam, -torch.einsum("eia,ei->ea", JcW, r)
        )
        Hpp = torch.zeros((P, 3, 3), dtype=dtype, device=dev).index_add_(
            0, pt, JpW.transpose(1, 2) @ Jp
        )
        gp = torch.zeros((P, 3), dtype=dtype, device=dev).index_add_(
            0, pt, -torch.einsum("eia,ei->ea", JpW, r)
        )
        Wcp = torch.zeros((K * P, 6, 3), dtype=dtype, device=dev).index_add_(
            0, wcp_row, JcW.transpose(1, 2) @ Jp
        ).reshape(K, P, 6, 3)
        reduce(comm, "world", Hcc, gc)
        reduce(comm, "obs", Hpp, gp, Wcp)

        # ---- inertial + bias-walk edges: 15 rows over 33 columns ----
        b_i = torch.cat([st.bg[ii], st.ba[ii]], dim=-1)
        ij = imu.inertial_residual_jac(
            st.R_wb[ii], st.p_wb[ii], st.v_w[ii], b_i,
            st.R_wb[jj], st.p_wb[jj], st.v_w[jj], pre, Rwg @ g_ref, s,
        )
        J9 = torch.cat([
            ij.pose1, ij.v1, ij.bg, ij.ba, ij.pose2, ij.v2, Z93, Z93,
            ij.gravity @ (Rwg @ neg_hat_g), ij.log_scale,
        ], dim=-1)  # [Q,9,33]
        J15 = torch.cat([J9, J_walk], dim=1)
        r15 = torch.cat([ij.r, st.bg[jj] - st.bg[ii], st.ba[jj] - st.ba[ii]], dim=-1)
        JtI = J15.transpose(1, 2) @ infoW  # [Q,33,15]
        Hq = JtI @ J15  # [Q,33,33]
        gq = -_mv(JtI, r15)  # [Q,33]
        H = torch.zeros((K * K, D, D), dtype=dtype, device=dev).index_add_(
            0, pair_idx,
            torch.cat([Hq[:, :D, :D], Hq[:, D:2 * D, D:2 * D], Hq[:, :D, D:2 * D], Hq[:, D:2 * D, :D]]),
        ).reshape(K, K, D, D)
        g = torch.zeros((K, D), dtype=dtype, device=dev).index_add_(
            0, ij_idx, torch.cat([gq[:, :D], gq[:, D:2 * D]])
        )
        Hg = torch.zeros((K, G, D), dtype=dtype, device=dev).index_add_(
            0, ij_idx, torch.cat([Hq[:, 2 * D:, :D], Hq[:, 2 * D:, D:2 * D]])
        )
        Hgg = torch.sum(Hq[:, 2 * D:, 2 * D:], dim=0)
        gg = torch.sum(gq[:, 2 * D:], dim=0)
        H[diag, diag, :6, :6] += Hcc
        g[:, :6] += gc

        # ---- bias priors (pull to zero; zero weight is a no-op) ----
        H[diag, diag] += torch.diag(pr)
        g[:, 9:12] -= bias_prior_g * st.bg
        g[:, 12:15] -= bias_prior_a * st.ba

        # ---- damping + landmark Schur (visual part only) ----
        diagH = torch.diagonal(H[diag, diag], dim1=-2, dim2=-1)  # [K,D]
        H[diag, diag] += torch.diag_embed(lam * diagH + 1e-6)
        Hgg_d = Hgg + (lam * torch.diagonal(Hgg) + 1e-6) * eyeG
        Hpp_d = Hpp + (lam * torch.diagonal(Hpp, dim1=-2, dim2=-1) + 1e-6)[..., :, None] * eye3
        Hpp_inv = inv3x3(Hpp_d)
        rows = schur_rows(comm)
        Y = torch.einsum("kpab,pbc->kpac", Wcp[:, rows], Hpp_inv[rows])  # [K,P,6,3]
        YW = torch.einsum("kpac,lpbc->klab", Y, Wcp[:, rows])
        Yg = torch.einsum("kpab,pb->ka", Y, gp[rows])
        reduce(comm, "world", YW, Yg)
        H[:, :, :6, :6] -= YW
        g[:, :6] -= Yg

        # ---- the bordered system [KD+3, KD+3]; fixed / padded unknowns
        # become identity rows and columns with a zero right-hand side ----
        Hg_flat = Hg.permute(1, 0, 2).reshape(G, KD)
        Hfull = torch.cat([
            torch.cat([H.permute(0, 2, 1, 3).reshape(KD, KD), Hg_flat.T], dim=1),
            torch.cat([Hg_flat, Hgg_d], dim=1),
        ], dim=0)
        Hm = Hfull * free_full[:, None] * free_full[None, :] + torch.diag(1.0 - free_full)
        delta_full = linalg.cho_solve(Hm, torch.cat([g.reshape(KD), gg]) * free_full) * free_full
        delta = delta_full[:KD].reshape(K, D)
        dgs = delta_full[KD:]

        rhs_p = gp - torch.einsum("kpab,ka->pb", Wcp, delta[:, :6])
        delta_p = torch.einsum("pab,pb->pa", Hpp_inv, rhs_p) * prob.pt_valid[:, None].to(dtype)

        # ---- candidate update ----
        newR = lie.normalize_rotation(st.R_wb @ lie.so3_exp(delta[:, 0:3]))
        newp = st.p_wb + _mv(st.R_wb, delta[:, 3:6])
        st_new = VIStates(
            R_wb=torch.where(free_poseb[:, None, None], newR, st.R_wb),
            p_wb=torch.where(free_poseb[:, None], newp, st.p_wb),
            v_w=st.v_w + delta[:, 6:9],
            bg=st.bg + delta[:, 9:12],
            ba=st.ba + delta[:, 12:15],
        )
        X_new = X + delta_p
        Rwg_new = lie.normalize_rotation(
            Rwg @ lie.so3_exp(torch.cat([dgs[0:2], torch.zeros_like(dgs[:1])]))
        )
        s_new = s * torch.exp(dgs[2])
        cost_new = total_cost(st_new, X_new, Rwg_new, s_new)
        better = cost_new < cost
        st = VIStates(*(torch.where(better, b, a) for a, b in zip(st, st_new)))
        X = torch.where(better, X_new, X)
        Rwg = torch.where(better, Rwg_new, Rwg)
        s = torch.where(better, s_new, s)
        lam = torch.where(better, torch.clamp(lam * 0.4, min=1e-8), torch.clamp(lam * 5.0, max=1e6))
        cost = torch.where(better, cost_new, cost)
        return st, X, Rwg, s, lam, cost

    X = prob.X
    Rwg = Rwg0.to(dtype)
    s = torch.ones((), dtype=dtype, device=dev)
    lam = (torch.as_tensor(lam0, dtype=dtype, device=dev) if isinstance(lam0, torch.Tensor)
           else torch.full((), lam0, dtype=dtype, device=dev))
    cost = total_cost(st, X, Rwg, s)
    for _ in range(n_iters):
        st, X, Rwg, s, lam, cost = step(st, X, Rwg, s, lam, cost)
    chi2 = visual_chi2(st, X)
    inlier = prob.edge_valid & (chi2 <= delta2)
    return st, X, Rwg, s, lam, cost, chi2, inlier


def vi_bundle_adjust(
    prob: VIBAProblem,
    n_iters: int = 8,
    chi2_th: float = robust.CHI2_MONO,
    use_robust: bool = True,
    bias_prior_g: float = 0.0,
    bias_prior_a: float = 0.0,
    lam0: float | torch.Tensor = 1e-3,
    comm=None,
    cam_model: str = "pinhole",
) -> VIBAResult:
    """Joint visual-inertial LM with Schur-eliminated landmarks (the
    reference's ``LocalInertialBA`` / ``FullInertialBA``): ``n_iters``
    iterations, no early stop, no host read. ``bias_prior_*``: zero-mean
    bias priors (the priorG / priorA schedule during IMU init). ``comm``:
    this rank's share of a sharded problem (``_vi_lm``). ``cam_model``: the
    projection of the visual rows (pinhole or KB8; under KB8 every u_r row
    is masked)."""
    dev = prob.X.device
    st, X, _, _, lam, cost, chi2, inlier = _vi_lm(
        prob, torch.eye(3, dtype=prob.X.dtype, device=dev), torch.zeros(3, device=dev),
        n_iters, chi2_th, use_robust, bias_prior_g, bias_prior_a, lam0, comm, cam_model,
    )
    return VIBAResult(states=st, X=X, cost=cost, chi2_visual=chi2, inlier=inlier, lam=lam)


def vi_bundle_adjust_gs(
    prob: VIBAProblem,
    Rwg0: torch.Tensor,
    n_iters: int = 15,
    chi2_th: float = robust.CHI2_MONO,
    use_robust: bool = True,
    bias_prior_g: float = 0.0,
    bias_prior_a: float = 0.0,
    fix_scale: bool = False,
    lam0: float | torch.Tensor = 1e-3,
    cam_model: str = "pinhole",
) -> VIBAGSResult:
    """Full inertial BA that co-optimizes the gravity direction (2-dof) and
    a global metric scale with all body states and landmarks (the
    reference's ``FullInertialBA(..., bInit=true)`` with EdgeInertialGS).
    The visual map stays in its own scale inside the solve; the caller
    applies the returned (Rwg, scale) to the map afterwards. ``cam_model``
    as in ``vi_bundle_adjust``."""
    free_g = torch.tensor([1.0, 1.0, 0.0 if fix_scale else 1.0], device=prob.X.device)
    st, X, Rwg, s, _, cost, chi2, inlier = _vi_lm(
        prob, Rwg0, free_g, n_iters, chi2_th, use_robust, bias_prior_g, bias_prior_a, lam0,
        cam_model=cam_model,
    )
    return VIBAGSResult(
        states=st, X=X, Rwg=Rwg, scale=s, cost=cost, chi2_visual=chi2, inlier=inlier
    )


# ---------------------------------------------------------------------------
# IMU initialization: gravity direction + scale + shared biases + velocities
# ---------------------------------------------------------------------------


class InertialInitResult(NamedTuple):
    Rwg: torch.Tensor  # [3,3] gravity-alignment rotation (g_w = Rwg * g_ref)
    scale: torch.Tensor  # []
    bg: torch.Tensor  # [3]
    ba: torch.Tensor  # [3]
    v_w: torch.Tensor  # [K,3]
    cost: torch.Tensor


def inertial_init(
    R_wb: torch.Tensor,
    p_wb: torch.Tensor,
    kf_valid: torch.Tensor,
    ie_i: torch.Tensor,
    ie_j: torch.Tensor,
    ie_preint: imu.Preintegrated,
    ie_valid: torch.Tensor,
    prior_g: float = 1e2,
    prior_a: float = 1e6,
    n_iters: int = 30,
    fix_scale: bool = False,
    vis_sigma_rot: float = 4e-3,
    vis_sigma_vel: float = 0.03,
    vis_sigma_pos: float = 8e-3,
) -> InertialInitResult:
    """Estimate gravity direction, metric scale, shared biases and
    per-keyframe velocities with the poses fixed (the reference's
    ``Optimizer::InertialOptimization``). The residual is the
    preintegration factor on scaled positions p' = s p and rotated gravity
    g_w = Rwg (0, 0, -G). Unknowns: [dtheta_g(2), dlog_s(1), bg(3), ba(3),
    v(3K)]."""
    K = R_wb.shape[0]
    dtype, dev = R_wb.dtype, R_wb.device
    ii, jj = ie_i.long(), ie_j.long()
    Q = ii.shape[0]
    # The fixed keyframe poses are visual estimates, not ground truth: their
    # uncertainty is a floor added to the preintegration covariance, else
    # the raw IMU information overweights the position channel and the
    # solve can prefer collapsing the scale.
    vis_floor = torch.tensor(
        [vis_sigma_rot**2] * 3 + [vis_sigma_vel**2] * 3 + [vis_sigma_pos**2] * 3,
        dtype=dtype, device=dev,
    )
    wq = ie_valid.to(dtype)
    infoW = linalg.inv(_sym(ie_preint.C[:, :9, :9]) + torch.diag(vis_floor)) * wq[:, None, None]
    g_ref = imu.gravity_vec(R_wb)
    hat_g = lie.hat(g_ref)
    nS = 9 + 3 * K
    Ri, Rj, pi, pj = R_wb[ii], R_wb[jj], p_wb[ii], p_wb[jj]
    qidx = torch.arange(Q, device=dev)
    pr = torch.zeros((nS,), dtype=dtype, device=dev)
    pr[3:6] = prior_g
    pr[6:9] = prior_a

    def unpack(x):
        # gravity perturbation only about x/y (2 dof), scale as log
        dth = torch.cat([x[0:2], torch.zeros_like(x[:1])])
        s = s0 if fix_scale else s0 * torch.exp(x[2])
        return dth, s, x[3:6], x[6:9], x[9:].reshape(K, 3)

    def residuals(x, jac):
        dth, s, bg, ba, v = unpack(x)
        Rwg = Rwg0 @ lie.so3_exp(dth)
        b = torch.cat([bg, ba]).expand(Q, 6)
        args = (Ri, s * pi, v[ii], b, Rj, s * pj, v[jj], ie_preint, Rwg @ g_ref)
        if not jac:
            return imu.inertial_residual(*args)
        out = imu.inertial_residual_jac(*args)
        # g_w(dth + d) = g_w - Rwg hat(g_ref) Jr(dth) d
        dG = -(Rwg @ hat_g @ lie.so3_right_jacobian(dth))[:, :2]
        if fix_scale:
            J_s = torch.zeros((Q, 9, 1), dtype=dtype, device=dev)
        else:
            # only the positions are scaled: d ep / d log s = R_i^T s (p_j - p_i)
            z = torch.zeros((Q, 6), dtype=dtype, device=dev)
            J_s = torch.cat([z, torch.einsum("qji,qj->qi", Ri, s * (pj - pi))], dim=-1)[..., None]
        Jv = torch.zeros((Q, 9, K, 3), dtype=dtype, device=dev)
        Jv[qidx, :, ii] = out.v1
        Jv[qidx, :, jj] += out.v2
        J = torch.cat([out.gravity @ dG, J_s, out.bg, out.ba, Jv.reshape(Q, 9, 3 * K)], dim=-1)
        return out.r, J

    def cost_of(x):
        r = residuals(x, jac=False)
        return (
            torch.einsum("qi,qij,qj->", r, infoW, r)
            + prior_g * torch.sum(x[3:6] ** 2) + prior_a * torch.sum(x[6:9] ** 2)
        )

    # Seed the gravity direction from the summed preintegrated velocity (the
    # reference's dirG accumulation): sum_q R_wb_i dV_q ~ -g * T.
    dV_sum = torch.sum(_mv(Ri, ie_preint.dV) * wq[:, None], dim=0)
    g_dir = -dV_sum / torch.clamp(torch.linalg.vector_norm(dV_sum), min=1e-9)
    g_ref_dir = torch.tensor([0.0, 0.0, -1.0], dtype=dtype, device=dev)
    axis = torch.linalg.cross(g_ref_dir, g_dir)
    sin_a = torch.linalg.vector_norm(axis)
    angle = torch.atan2(sin_a, torch.dot(g_ref_dir, g_dir))
    Rwg0 = lie.so3_exp(axis / torch.clamp(sin_a, min=1e-9) * angle)
    s0 = torch.ones((), dtype=dtype, device=dev)
    x = torch.zeros((nS,), dtype=dtype, device=dev)
    eye = torch.eye(nS, dtype=dtype, device=dev)

    lam = torch.tensor(1e-2, dtype=dtype, device=dev)
    cost = cost_of(x)
    for _ in range(n_iters):
        r, J = residuals(x, jac=True)
        JtI = J.transpose(1, 2) @ infoW  # [Q,nS,9]
        H = torch.sum(JtI @ J, dim=0) + torch.diag(pr)
        g = -torch.sum(_mv(JtI, r), dim=0) - pr * x
        Hd = H + (lam * torch.clamp(torch.diagonal(H), min=1e-8) + 1e-8) * eye
        x_new = x + linalg.cho_solve(Hd, g)
        cost_new = cost_of(x_new)
        better = cost_new < cost
        x = torch.where(better, x_new, x)
        lam = torch.where(better, torch.clamp(lam * 0.3, min=1e-9), torch.clamp(lam * 6.0, max=1e8))
        cost = torch.where(better, cost_new, cost)
    dth, s, bg, ba, v = unpack(x)
    return InertialInitResult(Rwg=Rwg0 @ lie.so3_exp(dth), scale=s, bg=bg, ba=ba, v_w=v, cost=cost)


# ---------------------------------------------------------------------------
# VI motion-only pose optimization with anchor-uncertainty propagation — the
# roles of Optimizer::PoseInertialOptimizationLastKeyFrame / LastFrame with
# ConstraintPoseImu / EdgePriorPoseImu. One 15-dof state (frame body pose +
# velocity + biases) against masked mono reprojection edges, the 9-dim
# preintegration factor to the anchor state (last keyframe or last frame)
# and the 6-dim bias random walk.
#
# The reference keeps two vertices and marginalizes; here the anchor is
# eliminated algebraically: its posterior covariance ``anc_Sigma`` inflates
# the edge covariances (W' = (W^-1 + A Sigma A^T)^-1 with A the residual
# Jacobian wrt the anchor), the Schur-exact single-vertex form. Returns the
# posterior information H and covariance Sigma at the optimum; the caller
# carries Sigma as the next frame's anchor uncertainty (zeros = exact
# anchor, e.g. right after a BA-refined keyframe).
# ---------------------------------------------------------------------------


class PoseInertialResult(NamedTuple):
    R_wb: torch.Tensor  # [3,3] optimized body pose
    p_wb: torch.Tensor  # [3]
    v_w: torch.Tensor  # [3]
    bg: torch.Tensor  # [3]
    ba: torch.Tensor  # [3]
    inlier: torch.Tensor  # [N] visual edges' final chi2 classification
    n_inliers: torch.Tensor  # [] int32
    H: torch.Tensor  # [15,15] recovered information at the optimum
    Sigma: torch.Tensor  # [15,15] posterior covariance (next anchor unc.)
    cost: torch.Tensor


def pose_inertial_optimization(
    R_wb0, p_wb0, v0, bg0, ba0,
    Xw,  # [N,3] matched landmark positions
    uv,  # [N,2] observations
    inv_sigma2,  # [N]
    valid,  # [N]
    R_anc, p_anc, v_anc, bg_anc, ba_anc,  # anchor (last keyframe / last frame) body state
    preint: imu.Preintegrated,  # anchor -> frame
    anc_Sigma,  # [15,15] anchor posterior cov (zeros = exact)
    cam_params, R_bc, t_bc,
    rounds: int = 3,
    iters_per_round: int = 4,
    chi2_th: float = 5.991,
    cam_model: str = "pinhole",
) -> PoseInertialResult:
    """``rounds`` rounds of ``iters_per_round`` LM steps with Huber weights;
    the inlier set is reclassified after each round. Fixed iteration
    counts, acceptance by ``torch.where``: no host read. ``cam_model``: the
    projection of the visual rows."""
    dtype, dev = R_wb0.dtype, R_wb0.device
    eye15 = torch.eye(15, dtype=dtype, device=dev)

    C_i = _sym(preint.C[0:9, 0:9])
    C_b = _sym(torch.block_diag(preint.C[9:12, 9:12], preint.C[12:15, 12:15]))

    # Anchor elimination: inflate the edge covariances by the anchor
    # posterior mapped through the residual's anchor Jacobian, taken once at
    # the linearization point. The factor's bias is the frame's, so the
    # anchor's bias columns are zero; the bias-walk residual
    # rb = b_frame - b_anchor has -I there.
    b0 = torch.cat([bg0, ba0])
    a0 = imu.inertial_residual_jac(R_anc, p_anc, v_anc, b0, R_wb0, p_wb0, v0, preint)
    A_i = torch.cat([a0.pose1, a0.v1, torch.zeros((9, 6), dtype=dtype, device=dev)], dim=-1)
    S_b = anc_Sigma[9:15, 9:15]  # A_b Sigma A_b^T with A_b = [0 | -I]
    info_i = _sym(linalg.inv(C_i + A_i @ anc_Sigma @ A_i.T + 1e-12 * eye15[:9, :9]))
    info_b = _sym(linalg.inv(C_b + S_b + 1e-12 * eye15[:6, :6]))
    info_b15 = F.pad(info_b, (9, 0, 9, 0))  # J_b^T info_b J_b with J_b = [0 | I]
    b_anc = torch.cat([bg_anc, ba_anc])
    cal = (cam_params, R_bc, t_bc)

    def tail_cost(chi2, active, ri, rb):
        return (
            torch.sum(torch.where(active, torch.clamp(chi2, max=chi2_th), torch.zeros_like(chi2)))
            + ri @ info_i @ ri + rb @ info_b @ rb
        )

    def costf(R, p, v, bg, ba, active):
        """Residual-only cost (no Jacobians: the cheap accept check)."""
        rv, _, _ = _visual_res(R, p, Xw, uv, *cal, cam_model=cam_model)
        b = torch.cat([bg, ba])
        ri = imu.inertial_residual(R_anc, p_anc, v_anc, b, R, p, v, preint)
        chi2 = torch.sum(rv * rv, dim=-1) * inv_sigma2
        return tail_cost(chi2, active, ri, b - b_anc), chi2

    def quad(R, p, v, bg, ba, active):
        rv, Jv, _ = _visual_res_jac(R, p, Xw, uv, *cal, cam_model=cam_model)  # [N,2], [N,2,6]
        b = torch.cat([bg, ba])
        ij = imu.inertial_residual_jac(R_anc, p_anc, v_anc, b, R, p, v, preint)
        Ji = torch.cat([ij.pose2, ij.v2, ij.bg, ij.ba], dim=-1)  # [9,15]
        rb = b - b_anc
        chi2 = torch.sum(rv * rv, dim=-1) * inv_sigma2
        w = inv_sigma2 * robust.huber_weight(chi2, chi2_th) * active.to(dtype)
        JvW = Jv * w[:, None, None]
        H6 = torch.einsum("nia,nib->ab", JvW, Jv)
        g6 = -torch.einsum("nia,ni->a", JvW, rv)
        JtI = Ji.T @ info_i
        H = F.pad(H6, (0, 9, 0, 9)) + JtI @ Ji + info_b15
        g = F.pad(g6, (0, 9)) - JtI @ ij.r - F.pad(info_b @ rb, (9, 0))
        return H, g, tail_cost(chi2, active, ij.r, rb), chi2

    R, p, v, bg, ba = R_wb0, p_wb0, v0, bg0, ba0
    active = valid
    lam = torch.full((), 1e-2, dtype=dtype, device=dev)
    for _ in range(rounds):
        for _ in range(iters_per_round):
            H, g, cost, _ = quad(R, p, v, bg, ba, active)
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-6 * eye15
            delta = linalg.cho_solve(Hd, g)
            R2, p2, v2, bg2, ba2 = _apply_pert(R, p, v, bg, ba, delta)
            R2 = lie.normalize_rotation(R2)
            cost_new, _ = costf(R2, p2, v2, bg2, ba2, active)
            better = cost_new < cost
            R = torch.where(better, R2, R)
            p = torch.where(better, p2, p)
            v = torch.where(better, v2, v)
            bg = torch.where(better, bg2, bg)
            ba = torch.where(better, ba2, ba)
            lam = torch.where(better, torch.clamp(lam * 0.5, min=1e-6), torch.clamp(lam * 4.0, max=1e4))
        _, chi2 = costf(R, p, v, bg, ba, valid)
        active = valid & (chi2 <= chi2_th)
    H, _, cost, chi2 = quad(R, p, v, bg, ba, active)
    H = _sym(H)
    inlier = valid & (chi2 <= chi2_th)
    Sigma = _sym(linalg.inv(H + 1e-6 * eye15))
    return PoseInertialResult(
        R_wb=R, p_wb=p, v_w=v, bg=bg, ba=ba,
        inlier=inlier, n_inliers=torch.sum(inlier, dtype=torch.int32),
        H=H, Sigma=Sigma, cost=cost,
    )
