"""Perspective-n-Point RANSAC — port of ``orb_slam3_ros_tpu.ops.pnp`` (the
role of the reference's ``MLPnPsolver`` in ``Tracking::Relocalization``,
Tracking.cc:3695-3720).

``N_HYP`` hypotheses side by side: each draws 6 distinct valid
correspondences (Gumbel top-k on the validity mask), solves a 6-point DLT
for [R|t] on normalized rays, projects R onto SO(3) and fixes the sign,
and counts its inliers by pixel reprojection chi2 over all
correspondences; the best hypothesis seeds ``REFINE_ITERS`` damped
Gauss-Newton refits on its running inlier set. The Gauss-Newton Jacobian is closed form (the JAX
package takes ``jax.jacfwd``; torch's forward mode promotes float * 0-dim
tangents to float64 and pays per op eagerly, see ``ops/lie.py``).

``solve_pnp_from_samples`` takes the hypotheses' sample indices, so a test
can give both packages the same samples; ``solve_pnp`` draws them with a
``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import cameras, lie, linalg

CHI2_PNP = 5.991  # 2-DoF 95%, the reference's per-level threshold base
N_HYP = 256  # hypotheses a solve
MIN_INLIERS = 15  # inliers for a pose to count as found
REFINE_ITERS = 6  # Gauss-Newton refits of the best hypothesis


class PnPResult(NamedTuple):
    ok: torch.Tensor  # [] bool
    R: torch.Tensor  # [3,3] world -> camera
    t: torch.Tensor  # [3]
    inlier: torch.Tensor  # [N] bool
    n_inliers: torch.Tensor  # [] int32


def _dlt_pose(X: torch.Tensor, xy: torch.Tensor):
    """6-point DLT for P = [R|t] from world points X [..., 6, 3] and
    normalized image coordinates xy [..., 6, 2] (rays with z = 1), batched
    over the leading axes. Returns (R [..., 3, 3], t [..., 3])."""
    x, y = xy[..., 0:1], xy[..., 1:2]
    Xh = torch.cat([X, torch.ones_like(x)], dim=-1)  # [..., 6, 4]
    zero = torch.zeros_like(Xh)
    # rows [X 0 -x X ; 0 X -y X] of the homogeneous X
    A = torch.cat([torch.cat([Xh, zero, -x * Xh], dim=-1),
                   torch.cat([zero, Xh, -y * Xh], dim=-1)], dim=-2)  # [..., 12, 12]
    _, _, Vt = linalg.svd(A)
    P = Vt[..., -1, :].reshape(X.shape[:-2] + (3, 4))
    # The null vector's sign: M = s R has det(M) = s^3, so a positive det
    # puts the points in front of the camera.
    sgn = torch.sign(torch.linalg.det(P[..., :3]))
    P = P * torch.where(sgn == 0, torch.ones_like(sgn), sgn)[..., None, None]
    M = P[..., :3]
    U, S, Vt2 = linalg.svd(M)  # M = s R, R by Procrustes
    detUV = torch.linalg.det(U @ Vt2)
    D = torch.diag_embed(torch.stack([torch.ones_like(detUV), torch.ones_like(detUV), detUV], -1))
    R = U @ D @ Vt2
    s = (S[..., 0] + S[..., 1] + detUV * S[..., 2]) / 3.0
    t = P[..., 3] / torch.clamp(s, min=1e-12)[..., None]
    return R, t


def sample_pnp(valid: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """[N_HYP, 6] int64: 6 distinct indices a hypothesis, drawn uniformly
    from the valid correspondences (Gumbel top-k on the mask; from all of
    them when fewer than 6 are valid)."""
    u = torch.rand((N_HYP, valid.shape[0]), generator=generator, device=valid.device)
    gumbel = -torch.log(-torch.log(torch.clamp(u, 1e-9, 1.0 - 1e-7)))
    scores = gumbel + torch.where(valid, 0.0, -1e9)
    return torch.topk(scores, 6, dim=1).indices


def solve_pnp_from_samples(
    X: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    cam_params: torch.Tensor,
    samples: torch.Tensor,
) -> PnPResult:
    """RANSAC PnP over [N] 2D-3D matches (X [N, 3] world points, uv [N, 2]
    pixels, ``valid`` [N]) with the hypotheses' samples [S, 6]; every match
    has unit information."""
    N = X.shape[0]
    dtype = X.dtype
    xy_n = cameras.pinhole_unproject(cam_params, uv)[:, :2]
    # the observations as undistorted pixels
    uv_ud = torch.stack([cam_params[0] * xy_n[:, 0] + cam_params[2],
                         cam_params[1] * xy_n[:, 1] + cam_params[3]], dim=1)
    samples = samples.long()
    R_h, t_h = _dlt_pose(X[samples], xy_n[samples])  # [S, 3, 3], [S, 3]

    def classify(R, t):
        """Inliers of pose(s) R [..., 3, 3], t [..., 3] over all matches."""
        Xc = torch.einsum("...ij,nj->...ni", R, X) + t[..., None, :]
        uvp = cameras.pinhole_project_nodist(cam_params, Xc)
        chi2 = torch.sum((uvp - uv_ud) ** 2, dim=-1)
        return valid & (chi2 < CHI2_PNP) & (Xc[..., 2] > 0), Xc

    inl_h, _ = classify(R_h, t_h)
    best = torch.argmax(torch.sum(inl_h, dim=-1, dtype=torch.int32))  # the first maximum
    R, t, inl = R_h[best], t_h[best], inl_h[best]
    eye6 = torch.eye(6, dtype=dtype, device=X.device)
    for _ in range(REFINE_ITERS):
        # Damped Gauss-Newton on the running inlier set (MLPnPsolver::Refine),
        # in the left perturbation (rotation, translation) of the pose.
        Xc = X @ R.T + t
        r = cameras.pinhole_project_nodist(cam_params, Xc) - uv_ud  # [N, 2]
        J = cameras.pinhole_project_jac(cam_params, Xc) @ torch.cat(
            [-lie.hat(Xc), torch.eye(3, dtype=dtype, device=X.device).expand(N, 3, 3)], dim=-1)
        JW = J * inl.to(dtype)[:, None, None]
        H = torch.einsum("nia,nib->ab", JW, J) + 1e-4 * eye6
        g = -torch.einsum("nia,ni->a", JW, r)
        eps = linalg.solve(H, g)
        dR = lie.so3_exp(eps[:3])
        R = lie.normalize_rotation(dR @ R)
        t = dR @ t + eps[3:6]
        inl, _ = classify(R, t)
    n_inl = torch.sum(inl, dtype=torch.int32)
    return PnPResult(ok=n_inl >= MIN_INLIERS, R=R, t=t, inlier=inl, n_inliers=n_inl)


def solve_pnp(
    X: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    cam_params: torch.Tensor,
    generator: torch.Generator,
) -> PnPResult:
    """``solve_pnp_from_samples`` with ``N_HYP`` hypotheses drawn by
    ``generator`` (on the tensors' device)."""
    return solve_pnp_from_samples(X, uv, valid, cam_params, sample_pnp(valid, generator))
