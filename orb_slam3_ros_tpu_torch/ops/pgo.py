"""Pose-graph optimization of the essential graph — port of
``orb_slam3_ros_tpu.ops.pgo`` (the role of the reference's
``Optimizer::OptimizeEssentialGraph``, Optimizer.cc:1504-1929, and of its
4-dof inertial variant, Optimizer.cc:5437).

States are S_iw per keyframe (world -> keyframe). The 7-dof graph
perturbs them on the left, S <- exp(zeta) S; an edge (i, j) with
measurement S_ji has the residual log(S_ji S_iw S_wj), zero when the
states agree with it. The 4-dof graph (inertial maps) perturbs each camera
pose in the world by a yaw and a translation, so roll and pitch against
gravity stay as they are, and drops the scales.

Each solve runs a fixed number of Levenberg-Marquardt iterations over the
dense [K*D, K*D] normal equations, solved by Cholesky (448 x 448 at K 64 in
the 7-dof graph). A step is accepted when it lowers the cost; accept,
reject and damping stay on the device, so a solve reads nothing back. The
edge Jacobians are exact forward-mode derivatives of the residual (one
``jvp`` batched over the 2 D basis directions and over the edges), as the
JAX package's ``jacfwd``.

On the card a solve is one replay of a CUDA graph of all its iterations
(``graphs.replay``); off the card the same function runs eagerly.

With ``comm`` (``parallel.dist_ba``) the 7-dof solve runs over edge tables
split across processes: J^T J, J^T r and the cost are summed over all ranks
and every rank solves the same dense system. Such a solve runs eagerly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jvp, vmap

from . import graphs, lie, linalg
from .ba import reduce


class PGOProblem(NamedTuple):
    R: torch.Tensor  # [K,3,3] S_iw rotation
    t: torch.Tensor  # [K,3]
    s: torch.Tensor  # [K] scale
    kf_fixed: torch.Tensor  # [K] bool
    kf_valid: torch.Tensor  # [K] bool
    e_i: torch.Tensor  # [E] int edge from-vertex
    e_j: torch.Tensor  # [E]
    e_R: torch.Tensor  # [E,3,3] measured S_ji rotation
    e_t: torch.Tensor  # [E,3]
    e_s: torch.Tensor  # [E]
    e_valid: torch.Tensor  # [E] bool
    e_weight: torch.Tensor  # [E] information scale


class PGOResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor
    cost: torch.Tensor


def _edge_residual(eps_i, eps_j, Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    """r = log(S_ji_meas * (exp(eps_i) S_iw) * (exp(eps_j) S_jw)^-1), [E, 7]."""
    Ri2, ti2, si2 = lie.sim3_mul(*lie.sim3_exp(eps_i), Ri, ti, si)
    Rj2, tj2, sj2 = lie.sim3_mul(*lie.sim3_exp(eps_j), Rj, tj, sj)
    Rji, tji, sji = lie.sim3_mul(Rm, tm, sm, Ri2, ti2, si2)
    return lie.sim3_log(*lie.sim3_mul(Rji, tji, sji, *lie.sim3_inv(Rj2, tj2, sj2)))


def _res_and_jacs(res_fn, E: int, D: int, like: torch.Tensor):
    """(r [E, Dr], J_i [E, Dr, D], J_j [E, Dr, D]) of ``res_fn(eps_i, eps_j)``
    at zero perturbations: one forward-mode pass batched over the 2 D basis
    directions of (eps_i, eps_j), all edges at once."""
    z = torch.zeros((E, 2 * D), dtype=like.dtype, device=like.device)
    basis = torch.eye(2 * D, dtype=like.dtype, device=like.device)[:, None, :].expand(2 * D, E, 2 * D)
    r, J = vmap(lambda v: jvp(lambda e: res_fn(e[:, :D], e[:, D:]), (z,), (v,)),
                out_dims=(None, 0))(basis)
    J = J.permute(1, 2, 0)  # [E, Dr, 2 D]
    return r, J[..., :D], J[..., D:]


def _lm_system(prob: PGOProblem, r, Ji, Jj, lam, free, w_e, D: int, comm=None):
    """The damped normal equations of one LM step, fixed keyframes pinned:
    returns the step [K, D] (zero on fixed keyframes). With ``comm`` the
    edge sums are summed over all ranks first."""
    K = prob.R.shape[0]
    ei, ej = prob.e_i.long(), prob.e_j.long()
    JiW = Ji * w_e[:, None, None]
    JjW = Jj * w_e[:, None, None]
    H = torch.zeros((K * K, D, D), dtype=r.dtype, device=r.device)
    H.index_add_(0, ei * K + ei, torch.einsum("eia,eib->eab", JiW, Ji))
    H.index_add_(0, ej * K + ej, torch.einsum("eia,eib->eab", JjW, Jj))
    H.index_add_(0, ei * K + ej, torch.einsum("eia,eib->eab", JiW, Jj))
    H.index_add_(0, ej * K + ei, torch.einsum("eia,eib->eab", JjW, Ji))
    H = H.reshape(K, K, D, D)
    g = torch.zeros((K, D), dtype=r.dtype, device=r.device)
    g.index_add_(0, ei, -torch.einsum("eia,ei->ea", JiW, r))
    g.index_add_(0, ej, -torch.einsum("eia,ei->ea", JjW, r))
    reduce(comm, "world", H, g)
    eye = torch.eye(D, dtype=r.dtype, device=r.device)
    k = torch.arange(K, device=r.device)
    diagH = torch.diagonal(H[k, k], dim1=-2, dim2=-1)  # [K, D]
    Hd = H[k, k] + (lam * diagH + 1e-8)[..., :, None] * eye
    Hm = H.clone()
    Hm[k, k] = Hd
    Hm = Hm * free[:, None, None, None] * free[None, :, None, None]
    Hm[k, k] += (1.0 - free)[:, None, None] * eye
    A = Hm.permute(0, 2, 1, 3).reshape(K * D, K * D)
    delta = linalg.cho_solve(A, (g * free[:, None]).reshape(K * D))
    return delta.reshape(K, D) * free[:, None]


def _accept(better, new, old):
    """``new`` where ``better`` (a 0-d bool), else ``old``."""
    return torch.where(better, new, old)


def optimize_pose_graph(prob: PGOProblem, n_iters: int = 20, lam0: float = 1e-4,
                        comm=None) -> PGOResult:
    """7-dof Sim(3) pose-graph LM over ``n_iters`` fixed iterations;
    ``comm``: this rank's share of the edges (module docstring)."""
    if comm is not None:
        return _solve_7dof(prob, n_iters, lam0, comm)
    return graphs.replay(_solve_7dof, prob, n_iters, lam0)


def _solve_7dof(prob: PGOProblem, n_iters: int, lam0: float, comm=None) -> PGOResult:
    dtype, dev = prob.R.dtype, prob.R.device
    E = prob.e_i.shape[0]
    ei, ej = prob.e_i.long(), prob.e_j.long()
    free = (prob.kf_valid & ~prob.kf_fixed).to(dtype)
    w_e = prob.e_weight * prob.e_valid.to(dtype)

    def residual_fn(R, t, s):
        Ri, ti, si, Rj, tj, sj = R[ei], t[ei], s[ei], R[ej], t[ej], s[ej]
        return lambda a, b: _edge_residual(a, b, Ri, ti, si, Rj, tj, sj,
                                           prob.e_R, prob.e_t, prob.e_s)

    def cost_of(R, t, s):
        z = torch.zeros((E, 7), dtype=dtype, device=dev)
        r = residual_fn(R, t, s)(z, z)
        return reduce(comm, "world", torch.sum(w_e * torch.sum(r * r, -1)))

    R, t, s = prob.R, prob.t, prob.s
    lam = torch.full((), lam0, dtype=dtype, device=dev)
    cost = cost_of(R, t, s)
    for _ in range(n_iters):
        r, Ji, Jj = _res_and_jacs(residual_fn(R, t, s), E, 7, R)
        delta = _lm_system(prob, r, Ji, Jj, lam, free, w_e, 7, comm)
        R2, t2, s2 = lie.sim3_mul(*lie.sim3_exp(delta), R, t, s)
        fb = free > 0
        R2 = torch.where(fb[:, None, None], lie.normalize_rotation(R2), R)
        t2 = torch.where(fb[:, None], t2, t)
        s2 = torch.where(fb, s2, s)
        cost_new = cost_of(R2, t2, s2)
        better = cost_new < cost
        R, t, s = _accept(better, R2, R), _accept(better, t2, t), _accept(better, s2, s)
        lam = torch.where(better, torch.clamp(lam * 0.3, min=1e-9), torch.clamp(lam * 5.0, max=1e6))
        cost = _accept(better, cost_new, cost)
    return PGOResult(R=R, t=t, s=s, cost=cost)


def _apply_pert4(eps, R_iw, t_iw):
    """Perturb world -> keyframe poses [..., 3, 3] / [..., 3] by a
    world-frame translation and yaw eps [..., 4] = (dt_w, dyaw): the camera
    pose in the world is left-multiplied by (Rz(dyaw), dt_w), so its roll
    and pitch against gravity are kept (the reference's VertexPose4DoF)."""
    z = torch.zeros_like(eps[..., 3])
    dR = lie.so3_exp(torch.stack([z, z, eps[..., 3]], dim=-1))
    R_wi = R_iw.transpose(-1, -2)
    p = -torch.einsum("...ij,...j->...i", R_wi, t_iw)
    R2 = (dR @ R_wi).transpose(-1, -2)
    p2 = torch.einsum("...ij,...j->...i", dR, p) + eps[..., 0:3]
    return R2, -torch.einsum("...ij,...j->...i", R2, p2)


def _edge_residual_4dof(eps_i, eps_j, Ri, ti, Rj, tj, Rm, tm):
    """r = log_se3(T_ji_meas * T_iw' * T_wj'), [E, 6]."""
    Ri2, ti2 = _apply_pert4(eps_i, Ri, ti)
    Rj2, tj2 = _apply_pert4(eps_j, Rj, tj)
    Ra, ta = lie.se3_mul(Rm, tm, Ri2, ti2)
    return lie.se3_log(*lie.se3_mul(Ra, ta, *lie.se3_inv(Rj2, tj2)))


def optimize_pose_graph_4dof(prob: PGOProblem, n_iters: int = 20, lam0: float = 1e-4) -> PGOResult:
    """SE(3) pose-graph LM with 4-dof (world yaw + translation) updates per
    keyframe, ``n_iters`` fixed iterations. Edge scales are ignored
    (metric maps); the returned ``s`` is all ones."""
    return graphs.replay(_solve_4dof, prob, n_iters, lam0)


def _solve_4dof(prob: PGOProblem, n_iters: int, lam0: float) -> PGOResult:
    K = prob.R.shape[0]
    dtype, dev = prob.R.dtype, prob.R.device
    E = prob.e_i.shape[0]
    ei, ej = prob.e_i.long(), prob.e_j.long()
    free = (prob.kf_valid & ~prob.kf_fixed).to(dtype)
    w_e = prob.e_weight * prob.e_valid.to(dtype)

    def residual_fn(R, t):
        Ri, ti, Rj, tj = R[ei], t[ei], R[ej], t[ej]
        return lambda a, b: _edge_residual_4dof(a, b, Ri, ti, Rj, tj, prob.e_R, prob.e_t)

    def cost_of(R, t):
        z = torch.zeros((E, 4), dtype=dtype, device=dev)
        r = residual_fn(R, t)(z, z)
        return torch.sum(w_e * torch.sum(r * r, -1))

    R, t = prob.R, prob.t
    lam = torch.full((), lam0, dtype=dtype, device=dev)
    cost = cost_of(R, t)
    for _ in range(n_iters):
        r, Ji, Jj = _res_and_jacs(residual_fn(R, t), E, 4, R)
        delta = _lm_system(prob, r, Ji, Jj, lam, free, w_e, 4)
        R2, t2 = _apply_pert4(delta, R, t)
        fb = free > 0
        R2 = torch.where(fb[:, None, None], lie.normalize_rotation(R2), R)
        t2 = torch.where(fb[:, None], t2, t)
        cost_new = cost_of(R2, t2)
        better = cost_new < cost
        R, t = _accept(better, R2, R), _accept(better, t2, t)
        lam = torch.where(better, torch.clamp(lam * 0.3, min=1e-9), torch.clamp(lam * 5.0, max=1e6))
        cost = _accept(better, cost_new, cost)
    return PGOResult(R=R, t=t, s=torch.ones((K,), dtype=dtype, device=dev), cost=cost)


def correct_points(X, pt_ref_kf, R_old, t_old, s_old, R_new, t_new, s_new):
    """Move map points with their reference keyframes after a PGO: each
    point by S_new^-1 S_old of its reference keyframe (Optimizer.cc:
    1832-1870). X [P, 3]; pt_ref_kf [P] keyframe ids; *_old / *_new: the
    [K] Sim(3) states before and after."""
    k = pt_ref_kf.long()
    Xc = s_old[k][:, None] * torch.einsum("pij,pj->pi", R_old[k], X) + t_old[k]
    return torch.einsum("pji,pj->pi", R_new[k], Xc - t_new[k]) / s_new[k][:, None]
