"""Binary-descriptor Hamming distance as a matrix product — port of
``orb_slam3_ros_tpu.ops.hamming``.

With descriptors sign-expanded to s in {-1, +1}^256,
``hamming(a, b) = (256 - dot(s_a, s_b)) / 2``. The product runs in float32:
sums of 256 values in {-1, 0, +1} are exact there, and CUDA has no int8
``matmul`` in torch. These functions are the plain reference of the
projection matcher kernel (``project_match.py``).
"""

from __future__ import annotations

import torch

N_BITS = 256

# Matching thresholds (reference ORBmatcher.cc:35-37).
TH_LOW = 50
TH_HIGH = 100
INVALID_DIST = 999  # sentinel > any real distance (max 256)


def hamming_matrix(sign_a: torch.Tensor, sign_b: torch.Tensor) -> torch.Tensor:
    """[N, 256] int8 x [M, 256] int8 -> [N, M] int32 Hamming distances.

    All-zero rows (invalid features) land at distance 128."""
    # 128 - dot / 2 in one product of the halved signs: every partial sum
    # is a multiple of 0.5 below 2^24, so float32 is exact.
    half = sign_a.to(torch.float32) * -0.5
    bias = torch.full((), N_BITS / 2, dtype=torch.float32, device=sign_a.device)
    return torch.addmm(bias, half, sign_b.to(torch.float32).T).to(torch.int32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit-population count of 32-bit words (SWAR), as int32. ``x`` holds
    the words as int32 (two's complement of the uint32 pattern, as
    ``orb.Features.desc_packed`` does) or int64; the arithmetic runs in
    int64 on the low 32 bits, masked after each product, because torch's
    uint32 supports few operations."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def hamming_packed(packed_a: torch.Tensor, packed_b: torch.Tensor) -> torch.Tensor:
    """[..., 8] packed descriptors (int32 words) -> their distance along
    the last axis, pair by pair (no pairwise matrix)."""
    return torch.sum(popcount32(packed_a ^ packed_b), dim=-1, dtype=torch.int32)


def _best2(d: torch.Tensor):
    """(best_idx, best, second) per row of an already masked matrix. The
    second-best excludes only the argmin column: the two smallest values
    of the row, a tie of the best counting twice."""
    best_idx = torch.argmin(d, dim=1)  # first minimum
    two = torch.topk(d, min(2, d.shape[1]), dim=1, largest=False).values
    second = two[:, 1] if d.shape[1] > 1 else torch.full_like(two[:, 0], INVALID_DIST)
    return best_idx, two[:, 0], second


def masked_best2(dist: torch.Tensor, mask: torch.Tensor):
    """Per-row best and second-best over a masked distance matrix.

    Returns (best_idx [N] int64, best [N], second [N]) with INVALID_DIST
    fills; ties in the best go to the lowest column, and the second-best
    excludes only that column."""
    return _best2(torch.where(mask, dist, INVALID_DIST))


def mutual_nn(dist: torch.Tensor, mask: torch.Tensor, max_dist: int = TH_LOW, ratio: float = 1.0):
    """Mutual nearest-neighbour matching with a Lowe ratio test.

    Returns (match_idx [N] int32, -1 if none; match_dist [N] int32)."""
    d = torch.where(mask, dist, INVALID_DIST)
    best_idx, best, second = _best2(d)
    ok = (best <= max_dist) & (best.to(torch.float32) <= ratio * second.to(torch.float32))
    # Mutual check: the row must also be the best for its matched column.
    col_best_row = torch.argmin(d, dim=0)  # [M], first minimum
    rows = torch.arange(dist.shape[0], device=dist.device)
    ok = ok & (col_best_row[best_idx] == rows)
    return (
        torch.where(ok, best_idx, -1).to(torch.int32),
        torch.where(ok, best, INVALID_DIST).to(torch.int32),
    )
