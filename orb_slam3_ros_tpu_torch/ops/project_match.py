"""Projection-guided descriptor matching: the hand-written Hopper kernel
(``csrc/project_match.cu``) that replaces the JAX package's Pallas kernel
``ops/pallas_match.py::_kernel``, and its plain torch version.

Both compute the contract of ``matching.search_by_projection``'s dense path
in the JAX package (``hamming.masked_best2`` + ``hamming.mutual_nn``),
exactly, ties included. ``project_match`` picks the route by where its
tensors lie: CPU tensors take ``project_match_reference``; CUDA tensors
always launch the kernel, or raise. A search on the card is one kernel
launch and allocates only its output: the kernel's scratch state lives in
a persistent workspace that every call leaves as it found it.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from . import hamming

# Kernel launches since import (or since a caller reset them), by call site
# ("track": tracking's passes, "fuse": landmark fusion, "sim3": loop
# closing's SearchBySim3, "merge": the Atlas's SearchBySim3 across maps):
# lets a run show that its main path went through the kernel.
LAUNCHES = {"track": 0, "fuse": 0, "sim3": 0, "merge": 0}

_IDX_BITS = 20  # index bits of the kernel's packed (dist, row) and (dist, column) words
_IDX_MASK = (1 << _IDX_BITS) - 1
_COL_INIT = hamming.INVALID_DIST << _IDX_BITS  # a column word no row has claimed
_ROW_INIT = _COL_INIT | _IDX_MASK  # a row word no candidate has reached
_LIB = None
# One workspace per (device, stream, P, N): the kernel leaves it as it found
# it, so a search allocates only its output. Calls on one stream run in
# order; another stream gets its own. The newest _MAX_WORKSPACES are kept
# (see ``_workspace`` for the cache's lifetime).
_WORKSPACES: dict = {}
_MAX_WORKSPACES = 32


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
        for name in ("project_match_workspace_ints", "project_match_split_cols"):
            getattr(lib, name).argtypes = [ctypes.c_int, ctypes.c_int]
            getattr(lib, name).restype = ctypes.c_int
        lib.project_match_init_workspace.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.project_match_init_workspace.restype = ctypes.c_int
        lib.project_match_empty_launch.argtypes = [ctypes.c_void_p]
        lib.project_match_empty_launch.restype = ctypes.c_int
        lib.project_match_launches_queued.argtypes = []
        lib.project_match_launches_queued.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _window_mask(
    proj_uv, proj_valid, proj_level, radius, feat_xy, feat_level, feat_valid,
    level_slack: int,
):
    """[P, N] bool: the pairs a search considers (both valid, inside the
    row's radius, levels within ``level_slack``)."""
    # Validity folds into the radius test: an invalid row's r^2 is -1,
    # below any d^2, and an invalid feature sits at x = +inf.
    r2 = torch.where(proj_valid, radius**2, -1.0)
    fx = torch.where(feat_valid, feat_xy[:, 0], float("inf"))
    dx = proj_uv[:, None, 0] - fx[None, :]
    dy = proj_uv[:, None, 1] - feat_xy[None, :, 1]
    in_rad = dx * dx + dy * dy <= r2[:, None]  # the sum over (x, y), unfused
    lvl_ok = torch.abs(feat_level[None, :] - proj_level[:, None]) <= level_slack
    return in_rad & lvl_ok


def project_match_reference(
    proj_uv, proj_valid, proj_level, proj_sign, radius,
    feat_xy, feat_level, feat_valid, feat_sign,
    level_slack: int = 1, max_dist: int = hamming.TH_HIGH, ratio: float = 0.9,
):
    """Plain torch version: dense [P, N] distances and mask, then mutual NN
    with the ratio test. ``radius`` is per point, already scaled by level.

    Returns (match_idx [P] int32, -1 if none; match_dist [P] int32)."""
    dist = hamming.hamming_matrix(proj_sign, feat_sign)  # [P, N]
    mask = _window_mask(
        proj_uv, proj_valid, proj_level, radius, feat_xy, feat_level, feat_valid, level_slack
    )
    return hamming.mutual_nn(dist, mask, max_dist=max_dist, ratio=ratio)


def split_ranges(N: int, splits: int) -> list[tuple[int, int]]:
    """The contiguous column ranges the kernel's grid cuts N features into
    when it aims at ``splits`` of them: equal widths, a multiple of 32, the
    last range short (so fewer than ``splits`` ranges can come back)."""
    groups = -(-N // 32)
    cols = 32 * -(-groups // splits)
    return [(c0, min(c0 + cols, N)) for c0 in range(0, N, cols)]


def project_match_reference_split(
    proj_uv, proj_valid, proj_level, proj_sign, radius,
    feat_xy, feat_level, feat_valid, feat_sign,
    level_slack: int = 1, max_dist: int = hamming.TH_HIGH, ratio: float = 0.9,
    splits: int = 1,
):
    """The kernel's cross-block logic in plain torch: the search run apart
    on each range of ``split_ranges(N, splits)``, then the kernel's merge
    and finish. Every range with a candidate packs its best as a word
    ``(dist << 20) | column`` and its second as ``(second << 20) | 0xFFFFF``;
    a row's word 0 is the minimum of the best words, its word 1 the minimum
    of every word that lost a minimum against word 0 and of the second
    words (so a tie of two ranges' bests gives second == best and the lower
    column); per-column words ``(dist << 20) | row`` are minimised over
    rows; the max_dist / ratio / mutual tests read those words. Equal to
    ``project_match_reference``; the tests hold the merge rule against it,
    nothing on the main path calls it."""
    dist = hamming.hamming_matrix(proj_sign, feat_sign).long()
    mask = _window_mask(
        proj_uv, proj_valid, proj_level, radius, feat_xy, feat_level, feat_valid, level_slack
    )
    P, N = dist.shape
    rows = torch.arange(P, device=dist.device)
    word0 = torch.full((P,), _ROW_INIT, dtype=torch.int64, device=dist.device)
    word1 = word0.clone()
    col_word = torch.empty((N,), dtype=torch.int64, device=dist.device)
    for c0, c1 in split_ranges(N, splits):
        d, m = dist[:, c0:c1], mask[:, c0:c1]
        o_idx, o_best, o_second = hamming.masked_best2(d, m)
        # A range without a candidate (or without a second) adds nothing:
        # the initial word loses every minimum.
        best_word = torch.where(
            o_best < hamming.INVALID_DIST, (o_best << _IDX_BITS) | (o_idx + c0), _ROW_INIT
        )
        second_word = torch.where(
            o_second < hamming.INVALID_DIST, (o_second << _IDX_BITS) | _IDX_MASK, _ROW_INIT
        )
        loser = torch.maximum(word0, best_word)
        word0 = torch.minimum(word0, best_word)
        word1 = torch.minimum(word1, torch.minimum(loser, second_word))
        col_word[c0:c1] = torch.where(m, (d << _IDX_BITS) | rows[:, None], _COL_INIT).amin(dim=0)
    best, second = word0 >> _IDX_BITS, word1 >> _IDX_BITS
    # A row without a candidate reads column 0, as argmin over an empty row.
    idx = torch.where(best < hamming.INVALID_DIST, word0 & _IDX_MASK, 0)
    ok = (
        (best <= max_dist)
        & (best.to(torch.float32) <= ratio * second.to(torch.float32))
        & ((col_word[idx] & _IDX_MASK) == rows)
    )
    return (
        torch.where(ok, idx, -1).to(torch.int32),
        torch.where(ok, best, hamming.INVALID_DIST).to(torch.int32),
    )


_SPEC = (
    # name, dtype, trailing shape, whether its rows are the P landmarks
    ("proj_uv", torch.float32, (2,), True),
    ("proj_valid", torch.bool, (), True),
    ("proj_level", torch.int32, (), True),
    ("proj_sign", torch.int8, (256,), True),
    ("radius", torch.float32, (), True),
    ("feat_xy", torch.float32, (2,), False),
    ("feat_level", torch.int32, (), False),
    ("feat_valid", torch.bool, (), False),
    ("feat_sign", torch.int8, (256,), False),
)
_SIGN_ARGS = (3, 8)  # positions of proj_sign and feat_sign


def _check(tensors, P: int, N: int, device: torch.device, level_slack: int = 0) -> None:
    """Raise on what the kernel does not take. ``tensors``: the nine inputs
    in ``_SPEC``'s order."""
    for t, (name, dtype, tail, per_row) in zip(tensors, _SPEC):
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
        if t.shape != ((P if per_row else N), *tail):
            raise ValueError(
                f"{name} has shape {tuple(t.shape)}, expected {((P if per_row else N), *tail)}"
            )
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for i in _SIGN_ARGS:
        if tensors[i].data_ptr() % 16:
            raise ValueError(
                f"{_SPEC[i][0]} must be 16-byte aligned (its rows are read in 8-byte words)"
            )
    if P == 0 or N == 0:
        raise ValueError("the kernel needs at least one landmark row and one feature")
    if level_slack < 0:
        raise ValueError("level_slack must not be negative")
    if max(P, N) >= _IDX_MASK:
        raise ValueError(f"P={P}, N={N}: the kernel packs row and column indices in {_IDX_BITS} bits")


def drop_workspaces() -> None:
    """Forget every cached workspace; the next search of each shape builds
    its own anew. For a caller that destroys streams (a new stream may get
    a destroyed one's handle) or wants the memory back."""
    _WORKSPACES.clear()


def _workspace(lib, key: tuple, device: torch.device) -> int:
    """Address of the persistent workspace of ``key`` = (device index,
    stream handle, P, N); allocated, and filled by the library, at first use
    (on that stream, with ``device`` current).

    Lifetime: an entry lives until ``_MAX_WORKSPACES`` newer ones exist,
    until ``drop_workspaces()``, or until a launch on it reports an error
    (``project_match_cuda`` drops it, so the next call starts clean). An
    evicted buffer goes back to torch's allocator, which hands it out again
    only in the order of the stream it was made on, after the searches
    queued on it. A workspace is clean whenever its last launch ran to its
    end; a kernel that faults mid-run leaves a sticky CUDA error, after
    which the process can launch nothing more on the card, so no later
    search reads what it left."""
    ws = _WORKSPACES.get(key)
    if ws is None:
        _, _, P, N = key
        n = lib.project_match_workspace_ints(P, N)
        ws = torch.empty((n,), dtype=torch.int32, device=device)
        err = lib.project_match_init_workspace(ws.data_ptr(), P, N, key[1])
        if err != 0:
            raise RuntimeError(f"project_match workspace init failed: cudaError {err}")
        while len(_WORKSPACES) >= _MAX_WORKSPACES:
            del _WORKSPACES[next(iter(_WORKSPACES))]
        _WORKSPACES[key] = ws
    return ws.data_ptr()


def project_match_cuda(
    proj_uv, proj_valid, proj_level, proj_sign, radius,
    feat_xy, feat_level, feat_valid, feat_sign,
    level_slack: int = 1, max_dist: int = hamming.TH_HIGH, ratio: float = 0.9,
    site: str = "track",
):
    """Launch the kernel on the current stream: the masked best-2 search,
    the column argmins and the ``max_dist`` / ratio / mutual finish in one
    kernel launch, counted in ``LAUNCHES[site]``; the call allocates only
    its output. Returns (match_idx [P] int32, -1 if none; match_dist [P]
    int32), equal to ``project_match_reference``."""
    if site not in LAUNCHES:
        raise ValueError(f"unknown launch site {site!r}")
    tensors = (
        proj_uv, proj_valid, proj_level, proj_sign, radius,
        feat_xy, feat_level, feat_valid, feat_sign,
    )
    device = proj_uv.device
    if device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {device}")
    P, N = proj_uv.shape[0], feat_xy.shape[0]
    _check(tensors, P, N, device, level_slack)
    lib = build()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        key = (device.index, stream, P, N)
        workspace = _workspace(lib, key, device)
        out = torch.empty((2, P), dtype=torch.int32, device=device)
        err = lib.project_match(
            *(t.data_ptr() for t in tensors),
            P, N, int(level_slack), int(max_dist), float(ratio),
            workspace, out.data_ptr(), out.data_ptr() + 4 * P, stream,
        )
    if err != 0:
        _WORKSPACES.pop(key, None)
        raise RuntimeError(f"project_match kernel launch failed: cudaError {err}")
    LAUNCHES[site] += 1
    return out[0], out[1]


@contextlib.contextmanager
def captured_launches():
    """For a CUDA graph capture: the launches counted inside the block are
    taken back out of ``LAUNCHES`` (a capture queues no kernel) and left in
    the yielded dict, by site, for ``count_replay`` to add per replay."""
    before = dict(LAUNCHES)
    held = {}
    try:
        yield held
    finally:
        for site in LAUNCHES:
            held[site] = LAUNCHES[site] - before[site]
            LAUNCHES[site] = before[site]


def count_replay(launches: dict) -> None:
    """Count the launches of one replay of a captured graph."""
    for site, n in launches.items():
        LAUNCHES[site] += n


def stream_workspaces(stream: int) -> list:
    """The workspaces of the stream with handle ``stream``: a captured
    graph holds their addresses, so its owner keeps them alive."""
    return [ws for key, ws in _WORKSPACES.items() if key[1] == stream]


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
