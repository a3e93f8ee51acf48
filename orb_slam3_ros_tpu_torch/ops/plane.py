"""Dominant-plane detection on map points by batched RANSAC — port of
``orb_slam3_ros_tpu.ops.plane``.

Role of the reference AR demo's ``ViewerAR::DetectPlane``
(src/AR/ViewerAR.cc: 3-point plane hypotheses over the tracked map points,
inliers by point-plane distance, a refit on the inliers). All hypotheses
are scored at once and the winner is refit twice by SVD.

The hypotheses' points are drawn with a ``torch.Generator``
(``detect_plane``), which draws differently from ``jax.random``: the rest
is ``detect_plane_from_samples``, so a test can feed it the JAX package's
samples, as ``ransac.py`` does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

N_HYP = 128  # plane hypotheses a detection scores
REL_TH = 0.03  # inlier distance / the cloud's median spread


class PlaneResult(NamedTuple):
    ok: torch.Tensor  # [] bool
    normal: torch.Tensor  # [3] unit normal (world)
    d: torch.Tensor  # [] plane offset: n . X + d = 0
    inlier: torch.Tensor  # [N] bool
    n_inliers: torch.Tensor  # [] int32
    anchor: torch.Tensor  # [3] inlier centroid (the cube's anchor)


def _nanmedian(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.nanmedian`` along ``dim``: the mean of the two middle values of
    the non-NaN entries when their count is even (``torch.nanmedian`` takes
    the lower one); NaN where all are NaN."""
    n = torch.sum(~torch.isnan(x), dim=dim, keepdim=True)
    xs, _ = torch.sort(x, dim=dim)  # NaN sorts last
    lo = torch.gather(xs, dim, torch.clamp((n - 1) // 2, min=0))
    hi = torch.gather(xs, dim, torch.clamp(n // 2, min=0))
    med = (0.5 * (lo + hi)).squeeze(dim)
    return torch.where(n.squeeze(dim) > 0, med, torch.full_like(med, float("nan")))


def sample_hypotheses(valid: torch.Tensor, generator: torch.Generator | None,
                      n_hyp: int = N_HYP) -> torch.Tensor:
    """[n_hyp, 3] point indices drawn uniformly (with replacement) among the
    valid points, on ``valid``'s device."""
    w = valid.to(torch.float32)
    return torch.multinomial(w, n_hyp * 3, replacement=True, generator=generator).reshape(n_hyp, 3)


def detect_plane(X: torch.Tensor, valid: torch.Tensor, generator: torch.Generator | None = None,
                 min_inlier_frac: float = 0.15) -> PlaneResult:
    """Fit the dominant plane to [N, 3] world points (``valid`` [N] bool,
    at least one valid): ``N_HYP`` hypotheses drawn by ``generator``, then
    ``detect_plane_from_samples``."""
    return detect_plane_from_samples(X, valid, sample_hypotheses(valid, generator, N_HYP),
                                     min_inlier_frac=min_inlier_frac)


def detect_plane_from_samples(X: torch.Tensor, valid: torch.Tensor, idx: torch.Tensor,
                              min_inlier_frac: float = 0.15) -> PlaneResult:
    """The plane through the best of the hypotheses ``idx`` [S, 3].

    ``REL_TH``: the inlier distance as a fraction of the cloud's median
    distance to its per-axis median (a monocular map has no unit). The
    winner is refit twice (SVD of the centred inliers, re-gate, refit): the
    second round takes in the points the minimal hypothesis missed. ``ok``:
    at least ``min_inlier_frac`` of the valid points are inliers."""
    p = X[idx.long()]  # [S, 3, 3]
    n = torch.linalg.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-12)
    d = -torch.einsum("si,si->s", n, p[:, 0])

    nan = torch.full_like(X, float("nan"))
    med = _nanmedian(torch.where(valid[:, None], X, nan), 0)
    r = torch.linalg.vector_norm(X - med, dim=-1)
    scale = _nanmedian(torch.where(valid, r, torch.full_like(r, float("nan"))), 0)
    th = REL_TH * torch.clamp(scale, min=1e-9)

    dist = torch.abs(torch.einsum("si,ni->sn", n, X) + d[:, None])
    inl = (dist < th) & valid
    best = torch.argmax(torch.sum(inl, dim=-1))

    def refit(w):
        # the plane through the weighted centroid; normal: the smallest
        # singular vector of the centred, weighted points
        c = torch.sum(X * w[:, None], dim=0) / torch.clamp(torch.sum(w), min=1e-9)
        _, _, Vh = torch.linalg.svd((X - c) * w[:, None], full_matrices=False)
        n_f = Vh[-1] / torch.clamp(torch.linalg.vector_norm(Vh[-1]), min=1e-12)
        d_f = -n_f @ c
        return n_f, d_f, c, (torch.abs(X @ n_f + d_f) < th) & valid

    n_f, d_f, c, inlier = refit(inl[best].to(X.dtype))
    n_f, d_f, c, inlier = refit(inlier.to(X.dtype))
    n_inl = torch.sum(inlier.to(torch.int32))
    n_valid = torch.clamp(torch.sum(valid.to(torch.int32)), min=1)
    ok = n_inl.to(torch.float32) >= min_inlier_frac * n_valid.to(torch.float32)
    return PlaneResult(ok=ok, normal=n_f, d=d_f, inlier=inlier, n_inliers=n_inl, anchor=c)
