"""Two-view reconstruction for monocular initialization — port of
``orb_slam3_ros_tpu.ops.ransac``: ``n_hyp`` fundamental and homography
hypotheses fitted and scored in parallel, the winners refined and
decomposed into motion (the reference's ``TwoViewReconstruction``).

Differences from the JAX package, none of them in what is computed:

- ``two_view_init`` is split. ``two_view_init_from_samples`` takes the
  ``[n_hyp, 8]`` hypothesis indices; ``two_view_init`` draws them with a
  ``torch.Generator``, uniformly with replacement among valid matches (what
  ``jax.random.categorical`` over 0 / -inf logits does). The two
  generators give different draws, so tests feed the JAX draw to
  ``two_view_init_from_samples``.
- Singular and non-finite matrices give inf/NaN and never raise
  (``inv_ex``, ``linalg.eigh`` / ``linalg.svd``), as ``jnp.linalg`` does;
  what follows treats NaN as the JAX package does (``argmax`` takes the
  first NaN, comparisons with NaN are false).
- Eigenvectors and singular vectors have no fixed sign, so F is defined
  up to sign and the four (R, t) candidates of ``reconstruct_from_F`` may
  come in another order; the motion chosen when ``ok`` is the same.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import cameras, lie, linalg, triangulate

TH_F = 3.841  # chi2 1-DoF 95% (TwoViewReconstruction.cc CheckFundamental)
TH_H = 5.991  # chi2 2-DoF 95%
TH_SCORE = 5.991


def _inv(A: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv_ex(A)[0]


def _normalize_pts(p):
    """Hartley normalization over the sample axis. p [..., M, 2] ->
    (pn, T) with T [..., 3, 3] mapping original -> normalized."""
    mean = torch.mean(p, dim=-2, keepdim=True)
    d = torch.mean(torch.abs(p - mean), dim=-2, keepdim=True)
    s = 1.0 / torch.clamp(d, min=1e-8)
    pn = (p - mean) * s
    sx, sy = s[..., 0, 0], s[..., 0, 1]
    mx, my = mean[..., 0, 0], mean[..., 0, 1]
    z = torch.zeros_like(sx)
    o = torch.ones_like(sx)
    T = torch.stack(
        [
            torch.stack([sx, z, -mx * sx], -1),
            torch.stack([z, sy, -my * sy], -1),
            torch.stack([z, z, o], -1),
        ],
        dim=-2,
    )
    return pn, T


def _rank2(f):
    u, s, vt = linalg.svd(f)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    return u @ (s[..., :, None] * vt)


def _fundamental_rows(p1n, p2n):
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    return torch.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, torch.ones_like(x1)], dim=-1
    )


def fit_fundamental(p1, p2):
    """Normalized 8-point algorithm, batched. p1/p2 [..., 8, 2] -> F [..., 3, 3]."""
    p1n, T1 = _normalize_pts(p1)
    p2n, T2 = _normalize_pts(p2)
    A = _fundamental_rows(p1n, p2n)  # [..., 8, 9]
    _, vecs = linalg.eigh(A.transpose(-1, -2) @ A)
    f = vecs[..., :, 0].reshape(p1.shape[:-2] + (3, 3))
    F = T2.transpose(-1, -2) @ _rank2(f) @ T1
    return F / torch.clamp(torch.abs(F[..., 2:3, 2:3]), min=1e-12)


def fit_fundamental_masked(p1, p2, w):
    """Least-squares 8-point fit over all N correspondences weighted by
    ``w`` [N] (the refit on the RANSAC winner's inliers; zero-weight rows
    drop out of A^T A)."""
    wsum = torch.clamp(torch.sum(w), min=1.0)
    mean1 = torch.sum(p1 * w[:, None], 0) / wsum
    mean2 = torch.sum(p2 * w[:, None], 0) / wsum
    d1 = torch.sum(torch.abs(p1 - mean1) * w[:, None], 0) / wsum
    d2 = torch.sum(torch.abs(p2 - mean2) * w[:, None], 0) / wsum
    s1 = 1.0 / torch.clamp(d1, min=1e-8)
    s2 = 1.0 / torch.clamp(d2, min=1e-8)

    def T_of(s, m):
        z, o = torch.zeros_like(s[0]), torch.ones_like(s[0])
        return torch.stack([
            torch.stack([s[0], z, -m[0] * s[0]]),
            torch.stack([z, s[1], -m[1] * s[1]]),
            torch.stack([z, z, o]),
        ])

    T1, T2 = T_of(s1, mean1), T_of(s2, mean2)
    A = _fundamental_rows((p1 - mean1) * s1, (p2 - mean2) * s2) * w[:, None]
    _, vecs = linalg.eigh(A.T @ A)
    f = vecs[:, 0].reshape(3, 3)
    F = T2.T @ _rank2(f) @ T1
    return F / torch.clamp(torch.abs(F[2, 2]), min=1e-12)


def fit_homography(p1, p2):
    """Normalized DLT homography from 4+ correspondences, batched."""
    p1n, T1 = _normalize_pts(p1)
    p2n, T2 = _normalize_pts(p2)
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    rowA = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    rowB = torch.stack([z, z, z, x1, y1, o, -y2 * x1, -y2 * y1, -y2], dim=-1)
    A = torch.cat([rowA, rowB], dim=-2)  # [..., 2M, 9]
    _, vecs = linalg.eigh(A.transpose(-1, -2) @ A)
    h = vecs[..., :, 0].reshape(p1.shape[:-2] + (3, 3))
    H = _inv(T2) @ h @ T1
    h22 = H[..., 2:3, 2:3]
    return H / torch.where(torch.abs(h22) < 1e-12, torch.full_like(h22, 1e-12), h22)


def _homog(a):
    return torch.cat([a, torch.ones_like(a[..., :1])], -1)


def _epipolar_chi2(F, p1, p2, inv_sigma2=1.0):
    """(chi1, chi2): squared point-to-epipolar-line distances both ways."""

    def point_line(Fm, a, b):
        # lines in image b from points a: l = F a
        l = _homog(a) @ Fm.transpose(-1, -2)
        num = torch.sum(l[..., :2] * b, dim=-1) + l[..., 2]
        den = torch.sum(l[..., :2] ** 2, dim=-1)
        return num * num / torch.clamp(den, min=1e-12)

    chi1 = point_line(F, p1, p2) * inv_sigma2  # p1 -> line in 2
    chi2 = point_line(F.transpose(-1, -2), p2, p1) * inv_sigma2
    return chi1, chi2


def score_fundamental(F, p1, p2, match_valid, inv_sigma2=1.0):
    """Symmetric epipolar-transfer score (CheckFundamental semantics).

    Returns (score [...], inlier [..., N])."""
    chi1, chi2 = _epipolar_chi2(F, p1, p2, inv_sigma2)
    ok = (chi1 < TH_F) & (chi2 < TH_F) & match_valid
    zero = torch.zeros_like(chi1)
    sc = torch.where(chi1 < TH_F, TH_SCORE - chi1, zero) + torch.where(
        chi2 < TH_F, TH_SCORE - chi2, zero
    )
    return torch.sum(torch.where(match_valid, sc, zero), dim=-1), ok


def score_homography(H, p1, p2, match_valid, inv_sigma2=1.0):
    """Symmetric transfer score for H (CheckHomography semantics)."""
    Hinv = _inv(H)

    def transfer(Hm, a, b):
        q = _homog(a) @ Hm.transpose(-1, -2)
        qz = q[..., 2:3]
        q = q[..., :2] / torch.where(torch.abs(qz) < 1e-12, torch.full_like(qz, 1e-12), qz)
        return torch.sum((q - b) ** 2, dim=-1)

    chi1 = transfer(H, p1, p2) * inv_sigma2
    chi2 = transfer(Hinv, p2, p1) * inv_sigma2
    ok = (chi1 < TH_H) & (chi2 < TH_H) & match_valid
    zero = torch.zeros_like(chi1)
    sc = torch.where(chi1 < TH_H, TH_H - chi1, zero) + torch.where(
        chi2 < TH_H, TH_H - chi2, zero
    )
    return torch.sum(torch.where(match_valid, sc, zero), dim=-1), ok


class TwoViewResult(NamedTuple):
    ok: torch.Tensor  # [] bool
    used_H: torch.Tensor  # [] bool: which model won the score
    R21: torch.Tensor  # [3,3] pose of cam1 in cam2
    t21: torch.Tensor  # [3] (unit norm: monocular scale is free)
    X1: torch.Tensor  # [N,3] triangulated points in the cam1 frame
    good: torch.Tensor  # [N] bool triangulation accepted
    n_good: torch.Tensor  # [] int32
    score_F: torch.Tensor
    score_H: torch.Tensor


def _check_rt(R21, t21, rays1, rays2, inlier, cam_params, p1, p2, sigma2=1.0):
    """Cheirality + reprojection test of one (R, t) candidate over all
    inlier matches (CheckRT). Returns (n_good, good_mask, X1, parallax_cos)."""
    X1 = triangulate.triangulate_dlt(rays1, rays2, R21, t21)
    X2 = X1 @ R21.T + t21
    finite = torch.all(torch.isfinite(X1), dim=-1)
    z_ok = (X1[..., 2] > 0) & (X2[..., 2] > 0)
    cospar = triangulate.parallax_cos(X1, -R21.T @ t21)
    par_ok = cospar < 0.99998
    e1 = torch.sum((cameras.pinhole_project_nodist(cam_params, X1) - p1) ** 2, -1)
    e2 = torch.sum((cameras.pinhole_project_nodist(cam_params, X2) - p2) ** 2, -1)
    reproj_ok = (e1 < 4.0 * sigma2) & (e2 < 4.0 * sigma2)
    good = inlier & finite & z_ok & par_ok & reproj_ok
    return torch.sum(good, dtype=torch.int32), good, X1, cospar


def _pick_candidate(cands, rays1, rays2, inlier, cam_params, p1, p2):
    """Run ``_check_rt`` on every (R, t) candidate and take the one seen by
    the most points (first on ties). Returns (R, t, X1, good, counts,
    n_best) with counts [n_cand] int32."""
    counts, goods, Xs = [], [], []
    for R21, t21 in cands:
        n, good, X1, _ = _check_rt(R21, t21, rays1, rays2, inlier, cam_params, p1, p2)
        counts.append(n)
        goods.append(good)
        Xs.append(X1)
    counts = torch.stack(counts)
    best = torch.argmax(counts)
    R = torch.stack([c[0] for c in cands])[best]
    t = torch.stack([c[1] for c in cands])[best]
    return R, t, torch.stack(Xs)[best], torch.stack(goods)[best], counts, counts[best]


def _unique_support(counts, n_best, inlier):
    """The reference's support and uniqueness conditions: the winner is
    seen by more than max(30, 0.75 n_inliers) points and the runner-up by
    fewer than 0.85 of the winner's."""
    n_second = torch.sort(counts).values[-2]
    n_inl = torch.sum(inlier, dtype=torch.int32)
    bar = torch.clamp((0.75 * n_inl).to(torch.int32), min=30)
    return (n_best > bar) & (n_second < (0.85 * n_best).to(torch.int32))


def reconstruct_from_F(F, p1, p2, inlier, cam_params):
    """E = K^T F K, 4-way decomposition, the candidate seen by the most
    points (ReconstructF). Returns (ok, R21, t21, X1, good, n_best)."""
    K = triangulate.K_matrix(cam_params)
    E = K.T @ F @ K
    u, _, vt = linalg.svd(E)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=F.dtype, device=F.device)
    Ra = u @ W @ vt
    Rb = u @ W.T @ vt
    Ra = Ra * torch.sign(lie._det3(Ra))
    Rb = Rb * torch.sign(lie._det3(Rb))
    tu = u[:, 2]
    tu = tu / torch.clamp(torch.linalg.norm(tu), min=1e-12)
    rays1 = cameras.pinhole_unproject(cam_params, p1)
    rays2 = cameras.pinhole_unproject(cam_params, p2)
    cands = [(Ra, tu), (Ra, -tu), (Rb, tu), (Rb, -tu)]
    R21, t21, X1, good, counts, n_best = _pick_candidate(
        cands, rays1, rays2, inlier, cam_params, p1, p2
    )
    ok = _unique_support(counts, n_best, inlier)
    return ok, R21, t21, X1, good, n_best


def reconstruct_from_H(H, p1, p2, inlier, cam_params):
    """Faugeras-Lustman homography decomposition: 8 candidate (R, t) from
    A = K^-1 H K, chosen by cheirality like the F path (ReconstructH).
    Returns (ok, R21, t21, X1, good, n_best)."""
    K = triangulate.K_matrix(cam_params)
    A = _inv(K) @ H @ K
    U, d, Vt = linalg.svd(A)
    s_det = lie._det3(U) * lie._det3(Vt)
    d1, d2, d3 = d[0], d[1], d[2]
    # Degenerate if singular values are too close (pure rotation).
    distinct = (d1 / torch.clamp(d2, min=1e-9) > 1.0001) & (
        d2 / torch.clamp(d3, min=1e-9) > 1.0001
    )
    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    x1m = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / denom, min=0.0))
    x3m = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / denom, min=0.0))
    # Case d' = +d2: theta; case d' = -d2: phi.
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    sin_t = root / torch.clamp((d1 + d3) * d2, min=1e-12)
    cos_t = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)
    sin_p = root / torch.clamp((d1 - d3) * d2, min=1e-12)
    cos_p = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)
    rays1 = cameras.pinhole_unproject(cam_params, p1)
    rays2 = cameras.pinhole_unproject(cam_params, p2)
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)

    def mat(rows):
        return torch.stack([torch.stack(r) for r in rows])

    cands = []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            x1, x3 = e1 * x1m, e3 * x3m
            st = e1 * e3 * sin_t
            Rp = mat([[cos_t, zero, -st], [zero, one, zero], [st, zero, cos_t]])
            tp = (d1 - d3) * torch.stack([x1, zero, -x3])
            cands.append((s_det * U @ Rp @ Vt, U @ tp))
            sp = e1 * e3 * sin_p
            Rn = mat([[cos_p, zero, sp], [zero, -one, zero], [sp, zero, -cos_p]])
            tn = (d1 + d3) * torch.stack([x1, zero, x3])
            cands.append((s_det * U @ Rn @ Vt, U @ tn))
    cands = [(R, t / torch.clamp(torch.linalg.norm(t), min=1e-12)) for R, t in cands]
    R21, t21, X1, good, counts, n_best = _pick_candidate(
        cands, rays1, rays2, inlier, cam_params, p1, p2
    )
    ok = distinct & _unique_support(counts, n_best, inlier)
    return ok, R21, t21, X1, good, n_best


def sample_hypotheses(match_valid: torch.Tensor, generator: torch.Generator,
                      n_hyp: int = 256) -> torch.Tensor:
    """[n_hyp, 8] int64 indices drawn uniformly with replacement among the
    valid matches (all indices when none is valid), without a host sync."""
    order = torch.argsort((~match_valid).to(torch.uint8), stable=True)  # valid first
    n_valid = torch.clamp(torch.sum(match_valid), min=1)
    u = torch.rand((n_hyp, 8), generator=generator, device=match_valid.device)
    r = torch.minimum((u * n_valid).to(torch.int64), n_valid - 1)
    return order[r]


def two_view_init_from_samples(
    xy1: torch.Tensor,
    xy2: torch.Tensor,
    match_valid: torch.Tensor,
    cam_params: torch.Tensor,
    idx: torch.Tensor,
    sigma: float = 1.0,
) -> TwoViewResult:
    """Monocular two-view initialization from matched level-0 keypoints
    (xy1[i] <-> xy2[i], mask ``match_valid``) and the hypotheses' sample
    indices ``idx`` [n_hyp, 8]: H and F RANSAC side by side, an IRLS refit
    of F on its inliers, and the reconstruction of the selected model (an
    H winner whose decomposition fails its gates falls back to a passing
    F reconstruction)."""
    inv_sigma2 = 1.0 / (sigma * sigma)
    idx = idx.long()
    s1 = xy1[idx]  # [S, 8, 2]
    s2 = xy2[idx]
    F_all = fit_fundamental(s1, s2)
    H_all = fit_homography(s1, s2)
    scF, _ = score_fundamental(F_all, xy1[None], xy2[None], match_valid[None], inv_sigma2)
    scH, _ = score_homography(H_all, xy1[None], xy2[None], match_valid[None], inv_sigma2)
    F = F_all[torch.argmax(scF)]
    bH = torch.argmax(scH)
    H = H_all[bH]
    score_H_best = scH[bH]
    _, inlF = score_fundamental(F, xy1, xy2, match_valid, inv_sigma2)
    # Gold-standard IRLS refit on the winner's inliers, rows weighted by a
    # Cauchy factor of their symmetric transfer error.
    w = inlF.to(xy1.dtype)
    for _ in range(3):
        F = fit_fundamental_masked(xy1, xy2, w)
        chi1, chi2 = _epipolar_chi2(F, xy1, xy2, inv_sigma2)
        inlF = (chi1 < TH_F) & (chi2 < TH_F) & match_valid
        chi = chi1 + chi2
        w = inlF.to(xy1.dtype) * torch.sqrt(1.0 / (1.0 + chi))
    score_F_best, _ = score_fundamental(F, xy1, xy2, match_valid, inv_sigma2)

    rh = score_H_best / torch.clamp(score_H_best + score_F_best, min=1e-9)
    used_H = rh > 0.45  # the reference selects H when rh > 0.40
    ok_f, R_f, t_f, X_f, good_f, n_f = reconstruct_from_F(F, xy1, xy2, inlF, cam_params)
    _, inlH = score_homography(H, xy1, xy2, match_valid, inv_sigma2)
    ok_h, R_h, t_h, X_h, good_h, n_h = reconstruct_from_H(H, xy1, xy2, inlH, cam_params)
    use_h = used_H & ok_h
    ok = use_h | ok_f
    good = torch.where(use_h, good_h, good_f)
    n_good = torch.where(use_h, n_h, n_f)
    return TwoViewResult(
        ok=ok,
        used_H=used_H,
        R21=torch.where(use_h, R_h, R_f),
        t21=torch.where(use_h, t_h, t_f),
        X1=torch.where(use_h, X_h, X_f),
        good=good & ok,
        n_good=torch.where(ok, n_good, torch.zeros_like(n_good)),
        score_F=score_F_best,
        score_H=score_H_best,
    )


def two_view_init(
    xy1: torch.Tensor,
    xy2: torch.Tensor,
    match_valid: torch.Tensor,
    cam_params: torch.Tensor,
    generator: torch.Generator,
    n_hyp: int = 256,
    sigma: float = 1.0,
) -> TwoViewResult:
    """``two_view_init_from_samples`` with ``n_hyp`` hypotheses drawn by
    ``generator`` (on the tensors' device)."""
    idx = sample_hypotheses(match_valid, generator, n_hyp)
    return two_view_init_from_samples(xy1, xy2, match_valid, cam_params, idx, sigma)

