"""Projection-guided descriptor matching: the hand-written Hopper kernel
(``csrc/project_match.cu``) that replaces the JAX package's Pallas kernel
``ops/pallas_match.py::_kernel``, and its plain torch version.

Both compute the contract of ``matching.search_by_projection``'s dense path
in the JAX package (``hamming.masked_best2`` + ``hamming.mutual_nn``),
exactly, ties included. ``project_match`` picks the route by where its
tensors lie: CPU tensors take ``project_match_reference``; CUDA tensors
always launch the kernel, or raise.
"""

from __future__ import annotations

import ctypes

import torch

from . import hamming

# Kernel launches since import (or since a caller reset them), by call site
# ("track": tracking's passes, "fuse": landmark fusion): lets a run show
# that its main path went through the kernel.
LAUNCHES = {"track": 0, "fuse": 0}

_ROW_BITS = 20  # row index bits of the kernel's packed column words
_LIB = None


def build():
    """Build (at first call) and load the kernel library; returns the
    ctypes library. Raises if nvcc is missing or the build fails."""
    global _LIB
    if _LIB is None:
        from ..utils import kernel_build

        lib, _ = kernel_build.build_shared_library("project_match", ["project_match.cu"])
        fn = lib.project_match
        fn.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_float]
            + [ctypes.c_void_p] * 4
        )
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def project_match_reference(
    proj_uv, proj_valid, proj_level, proj_sign, radius,
    feat_xy, feat_level, feat_valid, feat_sign,
    level_slack: int = 1, max_dist: int = hamming.TH_HIGH, ratio: float = 0.9,
):
    """Plain torch version: dense [P, N] distances and mask, then mutual NN
    with the ratio test. ``radius`` is per point, already scaled by level.

    Returns (match_idx [P] int32, -1 if none; match_dist [P] int32)."""
    dist = hamming.hamming_matrix(proj_sign, feat_sign)  # [P, N]
    # Validity folds into the radius test: an invalid row's r^2 is -1,
    # below any d^2, and an invalid feature sits at x = +inf.
    r2 = torch.where(proj_valid, radius**2, -1.0)
    fx = torch.where(feat_valid, feat_xy[:, 0], float("inf"))
    dx = proj_uv[:, None, 0] - fx[None, :]
    dy = proj_uv[:, None, 1] - feat_xy[None, :, 1]
    in_rad = dx * dx + dy * dy <= r2[:, None]  # the sum over (x, y), unfused
    lvl_ok = torch.abs(feat_level[None, :] - proj_level[:, None]) <= level_slack
    mask = in_rad & lvl_ok
    return hamming.mutual_nn(dist, mask, max_dist=max_dist, ratio=ratio)


_SPEC = (
    # name, dtype, trailing shape (None = the row count)
    ("proj_uv", torch.float32, (2,)),
    ("proj_valid", torch.bool, ()),
    ("proj_level", torch.int32, ()),
    ("proj_sign", torch.int8, (256,)),
    ("radius", torch.float32, ()),
    ("feat_xy", torch.float32, (2,)),
    ("feat_level", torch.int32, ()),
    ("feat_valid", torch.bool, ()),
    ("feat_sign", torch.int8, (256,)),
)


def _check(tensors: dict, P: int, N: int, device: torch.device) -> None:
    for name, dtype, tail in _SPEC:
        t = tensors[name]
        rows = P if name.startswith("proj") or name == "radius" else N
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
        if tuple(t.shape) != (rows, *tail):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(rows, *tail)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("proj_sign", "feat_sign"):
        if tensors[name].data_ptr() % 4:
            raise ValueError(f"{name} must be 4-byte aligned (read as int32 words)")
    if N == 0:
        raise ValueError("the kernel needs at least one feature")
    if P >= 1 << _ROW_BITS:
        raise ValueError(f"P={P} exceeds the kernel's {_ROW_BITS}-bit row index")


def project_match_cuda(
    proj_uv, proj_valid, proj_level, proj_sign, radius,
    feat_xy, feat_level, feat_valid, feat_sign,
    level_slack: int = 1, max_dist: int = hamming.TH_HIGH, ratio: float = 0.9,
    site: str = "track",
):
    """Launch the kernel on the current stream: the masked best-2 search,
    the column argmins and the ``max_dist`` / ratio / mutual epilogue in one
    host call, counted in ``LAUNCHES[site]``. Returns (match_idx [P] int32,
    -1 if none; match_dist [P] int32), equal to ``project_match_reference``."""
    if site not in LAUNCHES:
        raise ValueError(f"unknown launch site {site!r}")
    tensors = dict(
        proj_uv=proj_uv, proj_valid=proj_valid, proj_level=proj_level,
        proj_sign=proj_sign, radius=radius, feat_xy=feat_xy,
        feat_level=feat_level, feat_valid=feat_valid, feat_sign=feat_sign,
    )
    device = proj_uv.device
    if device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {device}")
    P, N = proj_uv.shape[0], feat_xy.shape[0]
    _check(tensors, P, N, device)
    fn = build().project_match
    workspace = torch.empty((3 * P + N,), dtype=torch.int32, device=device)
    out = torch.empty((2, P), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            *(tensors[name].data_ptr() for name, _, _ in _SPEC),
            P, N, int(level_slack), int(max_dist), float(ratio),
            workspace.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"project_match kernel launch failed: cudaError {err}")
    LAUNCHES[site] += 1
    return out[0], out[1]


def project_match(
    proj_uv, proj_valid, proj_level, proj_sign, radius,
    feat_xy, feat_level, feat_valid, feat_sign,
    level_slack: int = 1, max_dist: int = hamming.TH_HIGH, ratio: float = 0.9,
    site: str = "track",
):
    """(match_idx [P] int32, match_dist [P] int32) of the projection search.

    CPU tensors go through ``project_match_reference``; CUDA tensors through
    the kernel (``project_match_cuda``, which counts the launch under
    ``site``), which raises on what it does not take and never falls back."""
    args = (
        proj_uv, proj_valid, proj_level, proj_sign, radius,
        feat_xy, feat_level, feat_valid, feat_sign,
    )
    kw = dict(level_slack=level_slack, max_dist=max_dist, ratio=ratio)
    if proj_uv.device.type == "cpu":
        return project_match_reference(*args, **kw)
    return project_match_cuda(*args, **kw, site=site)
