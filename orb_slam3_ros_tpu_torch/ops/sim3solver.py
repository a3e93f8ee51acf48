"""Sim(3) between keyframes — port of ``orb_slam3_ros_tpu.ops.sim3solver``
(the role of the reference's ``Sim3Solver``, Sim3Solver.cc, and of
``OptimizeSim3``'s refit after SearchBySim3).

Horn / Umeyama's closed form, RANSAC over 3-point samples with every
hypothesis in one batch, inliers by two-way reprojection gated at
``chi2_th`` times each match's octave variance, and the winner refit on its
inliers. The draw is split from the solve: ``sample_sim3`` draws the
hypotheses' samples with a ``torch.Generator``, ``solve_sim3_from_samples``
solves from given samples (so a test can hand both packages the same
draws), ``solve_sim3`` does both. Nothing reads back to the host.

The two-way reprojections go through the keyframes' camera (``cam_model``:
pinhole or KB8, as Sim3Solver projects through the keyframe's camera
object); the JAX package projects them through the pinhole model whatever
the camera (sim3solver.py:101-157, ROADMAP "Known faults").
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import cameras, linalg
from .lie import _det3

N_HYP = 128
CHI2_SIM3 = 9.21


def umeyama(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor, fix_scale: bool = False):
    """Weighted least-squares similarity dst ~ s R src + t, batched over
    leading dims: src / dst [..., M, 3], w [..., M] >= 0 (the math of the
    reference's ``ComputeSim3``). ``fix_scale``: s = 1 (inertial maps).
    Returns (s [...], R [..., 3, 3], t [..., 3])."""
    wsum = torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-9)
    wn = w / wsum
    mu_s = torch.sum(src * wn[..., None], dim=-2)
    mu_d = torch.sum(dst * wn[..., None], dim=-2)
    xs = src - mu_s[..., None, :]
    xd = dst - mu_d[..., None, :]
    C = torch.einsum("...m,...mi,...mj->...ij", wn, xd, xs)
    U, D, Vt = linalg.svd(C)
    sign = torch.sign(_det3(U) * _det3(Vt))
    S = torch.stack([torch.ones_like(sign), torch.ones_like(sign), sign], dim=-1)
    R = (U * S[..., None, :]) @ Vt
    var_s = torch.einsum("...m,...mi,...mi->...", wn, xs, xs)
    if fix_scale:
        s = torch.ones_like(var_s)
    else:
        s = torch.sum(D * S, dim=-1) / torch.clamp(var_s, min=1e-12)
    t = mu_d - s[..., None] * torch.einsum("...ij,...j->...i", R, mu_s)
    return s, R, t


class Sim3Result(NamedTuple):
    ok: torch.Tensor  # [] bool: n_inliers >= min_inliers
    s: torch.Tensor  # [] scale (2 <- 1)
    R: torch.Tensor  # [3,3]
    t: torch.Tensor  # [3]
    inlier: torch.Tensor  # [N] bool
    n_inliers: torch.Tensor  # [] int32


def _gates(X1, sigma2_1, sigma2_2, chi2_th):
    """(gate in image 1 [N], gate in image 2 [N], information [N]): the
    reference's ``mvnMaxError = 9.21 * sigma2(octave)`` and OptimizeSim3's
    inverse-variance edge weights."""
    ones = torch.ones(X1.shape[:1], dtype=X1.dtype, device=X1.device)
    s1 = ones if sigma2_1 is None else sigma2_1
    s2 = ones if sigma2_2 is None else sigma2_2
    th1, th2 = chi2_th * s1, chi2_th * s2
    return th1, th2, 1.0 / torch.sqrt((th1 / chi2_th) * (th2 / chi2_th))


def _two_way_inliers(s, R, t, X1, X2, match_valid, cam_params, th1, th2,
                     cam_model: str = "pinhole"):
    """Inliers [..., N] of S21 = (s, R, t) (batched over leading dims):
    X1 projected through S21 into image 2 and X2 through its inverse into
    image 1, each within its gate, through the keyframes' camera
    ``cam_model`` (Sim3Solver::Project uses the keyframe's camera
    object)."""
    def proj(X):
        return cameras.project_model(cam_params, X, cam_model)

    X1in2 = s[..., None, None] * torch.einsum("...ij,nj->...ni", R, X1) + t[..., None, :]
    e2 = torch.sum((proj(X1in2) - proj(X2)) ** 2, -1)
    X2in1 = torch.einsum("...ji,...nj->...ni", R, X2 - t[..., None, :]) / s[..., None, None]
    e1 = torch.sum((proj(X2in1) - proj(X1)) ** 2, -1)
    return (e1 < th1) & (e2 < th2) & match_valid


def sample_sim3(match_valid: torch.Tensor, generator: torch.Generator, n_hyp: int = N_HYP):
    """[n_hyp, 3] int64: three indices a hypothesis, each drawn uniformly
    and independently from the valid matches (with replacement, as the JAX
    package's categorical draw; Gumbel argmax; index 0 when none is
    valid)."""
    u = torch.rand((n_hyp, 3, match_valid.shape[0]), generator=generator, device=match_valid.device)
    gumbel = -torch.log(-torch.log(torch.clamp(u, 1e-9, 1.0 - 1e-7)))
    return torch.argmax(gumbel + torch.where(match_valid, 0.0, -float("inf")), dim=-1)


def solve_sim3_from_samples(
    X1: torch.Tensor,
    X2: torch.Tensor,
    match_valid: torch.Tensor,
    cam_params: torch.Tensor,
    samples: torch.Tensor,
    fix_scale: bool = False,
    chi2_th: float = CHI2_SIM3,
    min_inliers: int = 20,
    sigma2_1: torch.Tensor | None = None,
    sigma2_2: torch.Tensor | None = None,
    cam_model: str = "pinhole",
) -> Sim3Result:
    """S21 (X2 ~ s R X1 + t) from matched camera-frame points X1 / X2 [N, 3]
    by RANSAC over the hypotheses' samples [S, 3] (Sim3Solver::iterate +
    CheckInliers): every hypothesis's Umeyama fit and two-way inlier count
    at once, the most supported one refit on its inliers with information
    weights, and its inliers counted again. ``cam_model``: the projection
    of the inlier test (``_two_way_inliers``)."""
    th1, th2, info = _gates(X1, sigma2_1, sigma2_2, chi2_th)
    samples = samples.long()
    w3 = torch.ones(samples.shape, dtype=X1.dtype, device=X1.device)
    s, R, t = umeyama(X1[samples], X2[samples], w3, fix_scale=fix_scale)
    inl_all = _two_way_inliers(s, R, t, X1, X2, match_valid, cam_params, th1, th2, cam_model)
    best = torch.argmax(torch.sum(inl_all, dim=-1, dtype=torch.int32))  # the first maximum
    w_best = inl_all[best].to(X1.dtype) * info
    s_f, R_f, t_f = umeyama(X1, X2, w_best, fix_scale=fix_scale)
    inl = _two_way_inliers(s_f, R_f, t_f, X1, X2, match_valid, cam_params, th1, th2, cam_model)
    n_inl = torch.sum(inl, dtype=torch.int32)
    return Sim3Result(ok=n_inl >= min_inliers, s=s_f, R=R_f, t=t_f, inlier=inl, n_inliers=n_inl)


def solve_sim3(X1, X2, match_valid, cam_params, generator: torch.Generator, **kw) -> Sim3Result:
    """``solve_sim3_from_samples`` with ``N_HYP`` hypotheses drawn by
    ``generator`` (on the tensors' device)."""
    return solve_sim3_from_samples(
        X1, X2, match_valid, cam_params, sample_sim3(match_valid, generator), **kw
    )


def refine_sim3(
    X1: torch.Tensor,
    X2: torch.Tensor,
    match_valid: torch.Tensor,
    cam_params: torch.Tensor,
    s0: torch.Tensor,
    R0: torch.Tensor,
    t0: torch.Tensor,
    iters: int = 3,
    fix_scale: bool = False,
    chi2_th: float = CHI2_SIM3,
    min_inliers: int = 20,
    sigma2_1: torch.Tensor | None = None,
    sigma2_2: torch.Tensor | None = None,
    cam_model: str = "pinhole",
) -> Sim3Result:
    """IRLS refinement of S21 from (s0, R0, t0) over a (grown) match set
    (the role of ``OptimizeSim3`` after ``SearchBySim3``): gate by two-way
    reprojection under the current estimate (through ``cam_model``), refit
    Umeyama on the inliers, ``iters`` times."""
    th1, th2, info = _gates(X1, sigma2_1, sigma2_2, chi2_th)
    s, R, t = s0, R0, t0
    inl = _two_way_inliers(s, R, t, X1, X2, match_valid, cam_params, th1, th2, cam_model)
    for _ in range(iters):
        s, R, t = umeyama(X1, X2, inl.to(X1.dtype) * info, fix_scale=fix_scale)
        inl = _two_way_inliers(s, R, t, X1, X2, match_valid, cam_params, th1, th2, cam_model)
    n_inl = torch.sum(inl, dtype=torch.int32)
    return Sim3Result(ok=n_inl >= min_inliers, s=s, R=R, t=t, inlier=inl, n_inliers=n_inl)
