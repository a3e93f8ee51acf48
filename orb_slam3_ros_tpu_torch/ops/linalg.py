"""``torch.linalg`` factorizations with the JAX package's NaN semantics.

``jnp.linalg.eigh`` and ``jnp.linalg.svd`` return NaN for a matrix with a
non-finite entry, ``cho_factor`` for one that is not positive definite and
``jnp.linalg.inv`` NaN or inf for a singular one; the torch functions
raise. The solvers feed them such matrices on purpose: an LM step from a
failed Cholesky, an IRLS weight of a non-finite residual. These wrappers
return NaN in place of each such matrix of the batch, without reading
anything back to the host; an LM step built from NaN has a NaN cost and is
rejected.
"""

from __future__ import annotations

import torch


def _finite(A: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(A).all(dim=-1).all(dim=-1)


def _stand_in(A: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(A.shape)
    return torch.where(ok[..., None, None], A, eye)


def _nan_where_not(ok: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    ok = ok.reshape(ok.shape + (1,) * (x.dim() - ok.dim()))
    return torch.where(ok, x, torch.full_like(x, float("nan")))


def eigh(A: torch.Tensor):
    """(eigenvalues ascending, eigenvectors as columns) of symmetric [..., n, n]."""
    ok = _finite(A)
    w, v = torch.linalg.eigh(_stand_in(A, ok))
    return _nan_where_not(ok, w), _nan_where_not(ok, v)


def svd(A: torch.Tensor):
    """(U, S, Vh) of [..., m, m]."""
    ok = _finite(A)
    u, s, vh = torch.linalg.svd(_stand_in(A, ok))
    return _nan_where_not(ok, u), _nan_where_not(ok, s), _nan_where_not(ok, vh)


def cho_solve(H: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve ``H x = rhs`` ([n, n], [n]) by Cholesky; NaN where ``H`` is not
    positive definite."""
    L, info = torch.linalg.cholesky_ex(H)
    L = torch.where(info == 0, L, torch.full_like(L, float("nan")))
    return torch.cholesky_solve(rhs[:, None], L)[:, 0]


def inv(A: torch.Tensor) -> torch.Tensor:
    """Inverse of [..., n, n]; NaN for a singular or non-finite matrix."""
    Ai, info = torch.linalg.inv_ex(A)
    return _nan_where_not((info == 0) & _finite(A), Ai)


def solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = b`` ([..., n, n], [..., n]) by LU; NaN for a singular
    or non-finite ``A``."""
    x, info = torch.linalg.solve_ex(A, b)
    return _nan_where_not((info == 0) & _finite(A), x)
