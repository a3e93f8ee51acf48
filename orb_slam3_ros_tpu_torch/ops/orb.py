"""Oriented binary descriptors + the multi-level feature extractor — port of
``orb_slam3_ros_tpu.ops.orb`` (``extract``, what it calls, and the per-level
helpers ``orientation_maps``, ``angles_at(_dense)`` and
``compute_descriptors``; ``extract_looped`` is not ported).

Layouts match the JAX package's ``Features``: int32 levels, int8 +-1 sign
descriptors. ``desc_packed`` is int32 carrying the uint32 bit pattern of the
JAX field (torch's uint32 supports few operations); ``features_to_numpy``
views it back as uint32.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import fast as fast_mod
from . import pyramid as pyr_mod
from .tables import device_table

PATCH_R = 15  # orientation patch radius (reference HALF_PATCH_SIZE = 15)
PAIR_CLIP = 13  # descriptor test offsets stay within +-13
N_BITS = 256


def _make_pattern(seed: int = 42) -> np.ndarray:
    """[256, 2, 2] (pair, endpoint, xy) Gaussian BRIEF pattern, fixed —
    the same numpy recipe and seed as the JAX package, so the two packages'
    descriptors are comparable bit for bit."""
    rng = np.random.default_rng(seed)
    sigma = (2 * PAIR_CLIP + 1) / 5.0
    pat = rng.normal(0.0, sigma, size=(N_BITS, 2, 2))
    return np.clip(np.round(pat), -PAIR_CLIP, PAIR_CLIP).astype(np.float32)


PATTERN = _make_pattern()


def _moment_kernels() -> tuple[np.ndarray, np.ndarray]:
    """31x31 (m10, m01) kernels over the circular intensity-centroid patch."""
    ys, xs = np.mgrid[-PATCH_R : PATCH_R + 1, -PATCH_R : PATCH_R + 1]
    mask = (xs**2 + ys**2) <= PATCH_R**2
    return (xs * mask).astype(np.float32), (ys * mask).astype(np.float32)


_KX, _KY = _moment_kernels()


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[N, 256] bool -> [N, 8] int32 (bit i of word j = bit 32j+i), each
    word the two's-complement reading of the JAX package's uint32 word."""
    n = bits.shape[0]
    b = bits.reshape(n, 8, 32).to(torch.int64)
    weights = torch.ones((), dtype=torch.int64, device=bits.device) << torch.arange(
        32, dtype=torch.int64, device=bits.device
    )
    words = torch.sum(b * weights, dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def sign_expand(bits: torch.Tensor) -> torch.Tensor:
    """[N, 256] bool -> [N, 256] int8 in {-1, +1} (bit set -> -1)."""
    return (1 - 2 * bits.to(torch.int8)).to(torch.int8)


class ExtractorConfig(NamedTuple):
    """Static extractor configuration (the ORBextractor constructor args)."""

    height: int
    width: int
    n_levels: int = 8
    scale: float = 1.2
    caps: Sequence[int] = (256, 192, 160, 128, 112, 96, 80, 64)
    ini_threshold: float = 20.0
    min_threshold: float = 7.0

    @property
    def total_cap(self) -> int:
        return int(sum(self.caps))

    def level_shape(self, l: int):
        return pyr_mod.level_shapes(self.height, self.width, self.n_levels, self.scale)[l]

    def cell_size(self, l: int) -> int:
        h, w = self.level_shape(l)
        return max(12, int(np.sqrt(h * w / (2.5 * self.caps[l]))))


def default_config(height: int, width: int, n_features: int = 1000, **kw) -> ExtractorConfig:
    """Per-level capacities on the reference's geometric series, rounded up
    to multiples of 8."""
    n_levels = kw.pop("n_levels", 8)
    scale = kw.pop("scale", 1.2)
    q = 1.0 / scale
    f = n_features * (1 - q) / (1 - q**n_levels)
    caps = tuple(int(np.ceil(f * q**l / 8) * 8) for l in range(n_levels))
    return ExtractorConfig(
        height=height, width=width, n_levels=n_levels, scale=scale, caps=caps, **kw
    )


class Features(NamedTuple):
    """Fixed-capacity per-frame feature set."""

    xy: torch.Tensor  # [N, 2] float32 level-0 pixel coords
    level: torch.Tensor  # [N] int32 pyramid level
    angle: torch.Tensor  # [N] float32 radians
    response: torch.Tensor  # [N] float32
    desc_packed: torch.Tensor  # [N, 8] int32 holding uint32 bit patterns
    desc_sign: torch.Tensor  # [N, 256] int8 (+-1, 0 on invalid slots)
    valid: torch.Tensor  # [N] bool


def features_from_numpy(arrays, device) -> Features:
    """Features on ``device`` from a mapping of numpy arrays keyed by field
    name, laid out like the JAX package's."""
    out = {}
    for k in Features._fields:
        a = np.ascontiguousarray(np.asarray(arrays[k]))
        if k == "desc_packed":
            a = a.view(np.int32)
        out[k] = torch.from_numpy(a.copy()).to(device)
    return Features(**out)


def features_to_numpy(f: Features) -> dict:
    """Numpy arrays with the JAX package's dtypes (``desc_packed`` uint32)."""
    out = {k: getattr(f, k).detach().cpu().numpy() for k in Features._fields}
    out["desc_packed"] = out["desc_packed"].view(np.uint32)
    return out


PATCH_RAW = 21  # raw patch radius: 18 px max steered-pair reach + 3 blur
_BLUR_R = 18  # blurred patch radius after VALID 7-tap blur


def _blur_band_matrix(S: int, ksize: int, sigma: float) -> np.ndarray:
    """[S, S-ksize+1] banded Toeplitz of the 1-D Gaussian (VALID)."""
    k = np.asarray(pyr_mod._gaussian_kernel1d(ksize, sigma), np.float32)
    out = S - ksize + 1
    B = np.zeros((S, out), np.float32)
    for j in range(out):
        B[j : j + ksize, j] = k
    return B


def _pattern() -> np.ndarray:
    return PATTERN


def _moment_matrix() -> np.ndarray:
    """[31*31, 2]: the x / y moment weights of the centre disc."""
    return np.stack([_KX.reshape(-1), _KY.reshape(-1)], axis=-1)


def _patch_blur(patches: torch.Tensor, ksize: int = 7, sigma: float = 2.0):
    """Blur [N, S, S] patches with the descriptor Gaussian, VALID
    (output [N, S-6, S-6]), as two banded-matrix contractions."""
    S = patches.shape[-1]
    B = device_table(_blur_band_matrix, (S, ksize, sigma), None, patches.device)
    x = torch.einsum("nij,ik->nkj", patches, B)  # rows (dim 1), VALID
    return torch.einsum("nkj,jl->nkl", x, B)  # cols (dim 2), VALID


def _steered_offsets(angle: torch.Tensor) -> torch.Tensor:
    """[N, P, 2 (endpoint), 2 (xy)]: the test pattern rotated by each
    keypoint's angle, rounded half to even (``jnp.round``'s rule)."""
    ca, sa = torch.cos(angle), torch.sin(angle)
    rot = torch.stack(
        [torch.stack([ca, -sa], -1), torch.stack([sa, ca], -1)], dim=-2
    )  # [N, 2, 2]
    pat = device_table(_pattern, (), None, angle.device)  # [P, 2, 2]
    return torch.round(torch.einsum("nij,pkj->npki", rot, pat))


def _gather_patches(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, S: int):
    """[N, S, S] patches of ``img`` at top-left corners (y0, x0) [N]
    (int64, already in range)."""
    ar = torch.arange(S, device=img.device)
    return img[(y0[:, None] + ar)[:, :, None], (x0[:, None] + ar)[:, None, :]]


def _patch_angles(center: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientations [N] of [N, 31, 31] patches (their
    moments as one product with the disc's weights)."""
    kern = device_table(_moment_matrix, (), None, center.device)
    mom = center.reshape(center.shape[0], -1) @ kern  # [N, 2]
    return torch.atan2(mom[:, 1], mom[:, 0])


def orientation_maps(img: torch.Tensor):
    """(m10 map, m01 map): each pixel's intensity-centroid moments over the
    31-px disc, as two zero-padded convolutions."""
    return tuple(pyr_mod.conv2d_same(img, torch.as_tensor(k, device=img.device))
                 for k in (_KX, _KY))


def angles_at_dense(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Keypoint orientations [N] read from the whole-image moment maps
    (``orientation_maps``; the test reference of ``angles_at``)."""
    m10, m01 = orientation_maps(img)
    xi = torch.clamp(xy[:, 0].to(torch.int64), 0, img.shape[1] - 1)
    yi = torch.clamp(xy[:, 1].to(torch.int64), 0, img.shape[0] - 1)
    return torch.atan2(m01[yi, xi], m10[yi, xi])


def angles_at(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Keypoint orientations [N] (radians) from 31x31 patches gathered at
    the keypoints (``extract``'s orientation stage); a patch that would
    leave the image is clamped inside it."""
    h, w = img.shape
    S = 2 * PATCH_R + 1
    x0 = torch.clamp(xy[:, 0].to(torch.int64) - PATCH_R, 0, w - S)
    y0 = torch.clamp(xy[:, 1].to(torch.int64) - PATCH_R, 0, h - S)
    return _patch_angles(_gather_patches(img, y0, x0, S))


def compute_descriptors(blurred: torch.Tensor, xy: torch.Tensor, angle: torch.Tensor):
    """Steered 256-bit binary descriptors sampled from a blurred level
    image [H, W] at keypoints ``xy`` [N, 2] (level pixels) with
    orientations ``angle`` [N]; each sample clamped into the image.
    Returns bits [N, 256] bool."""
    h, w = blurred.shape
    coords = xy[:, None, None, :] + _steered_offsets(angle)  # [N, P, 2, 2]
    xi = torch.clamp(coords[..., 0].to(torch.int64), 0, w - 1)
    yi = torch.clamp(coords[..., 1].to(torch.int64), 0, h - 1)
    vals = blurred[yi, xi]  # [N, P, 2]
    return vals[..., 0] < vals[..., 1]


def _descriptors_from_patches(bpatch: torch.Tensor, angle: torch.Tensor):
    """Steered 256-pair tests sampled from blurred patches [N, D, D]."""
    n, D, _ = bpatch.shape
    off = _steered_offsets(angle).to(torch.int64)
    cx = torch.clamp(off[..., 0] + _BLUR_R, 0, D - 1)  # [N, P, 2]
    cy = torch.clamp(off[..., 1] + _BLUR_R, 0, D - 1)
    flat_idx = (cy * D + cx).reshape(n, -1)  # [N, P*2]
    vals = torch.gather(bpatch.reshape(n, D * D), 1, flat_idx).reshape(n, -1, 2)
    return vals[..., 0] < vals[..., 1]


def extract(img: torch.Tensor, config: ExtractorConfig) -> Features:
    """ORB-style extraction over the pyramid; ``img`` [H, W] float32 in
    [0, 255] on the device that runs it.

    FAST runs once over a horizontally strip-packed canvas of the levels
    (each with an M-px edge-replicated margin); per-level top-K selection
    keeps each level's own cell grid; one 43x43 patch per keypoint then
    feeds orientation (centre 31x31 moments), a banded-matrix blur and
    descriptor sampling. The patch gather clamps its start indices into the
    strip as ``lax.dynamic_slice`` does: the margin makes the clamp
    unreachable for valid keypoints, and invalid slots (xy = 0) clamp the
    same way in both packages.
    """
    L = config.n_levels
    H0 = config.height
    dev = img.device
    M = PATCH_RAW - 19 + 2  # margin so patch slices never clamp
    levels = pyr_mod.build_pyramid(img, config.n_levels, config.scale)
    parts, offs = [], []
    x_cursor = 0
    for lv in levels:
        hl, wl = lv.shape
        parts.append(
            torch.nn.functional.pad(
                lv[None, None], (M, M, M, H0 + M - hl), mode="replicate"
            )[0, 0]
        )
        offs.append(x_cursor + M)  # column of level content in the strip
        x_cursor += wl + 2 * M
    strip = torch.cat(parts, dim=1)  # [H0+2M, sum(Wl+2M)]

    score = fast_mod.score_map_combined(strip, config.ini_threshold, config.min_threshold)

    out_xy, out_lvl, out_resp, out_valid = [], [], [], []
    border = 19
    for l in range(L):
        h, w = config.level_shape(l)
        sc = score[M : M + h, offs[l] : offs[l] + w]
        ys = torch.arange(h, device=dev)[:, None]
        xs = torch.arange(w, device=dev)[None, :]
        inb = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
        xy, resp, valid = fast_mod.select_grid(sc, inb, config.caps[l], config.cell_size(l))
        out_xy.append(xy)
        out_lvl.append(torch.full((config.caps[l],), l, dtype=torch.int32, device=dev))
        out_resp.append(resp)
        out_valid.append(valid)
    xy_lv = torch.cat(out_xy)  # [N, 2] level coords
    lvl = torch.cat(out_lvl)
    resp = torch.cat(out_resp)
    valid = torch.cat(out_valid)

    # One raw patch per keypoint from the strip (level offset folded into
    # the column index), start indices clamped like lax.dynamic_slice.
    S = 2 * PATCH_RAW + 1
    Hs, Ws = strip.shape
    offs_arr = device_table(np.asarray, (tuple(offs),), torch.int64, dev)[lvl.long()]
    y0 = torch.clamp(xy_lv[:, 1].to(torch.int64) + M - PATCH_RAW, 0, Hs - S)
    x0 = torch.clamp(xy_lv[:, 0].to(torch.int64) + offs_arr - PATCH_RAW, 0, Ws - S)
    patches = _gather_patches(strip, y0, x0, S)

    # Orientation from the centre 31x31.
    c0 = PATCH_RAW - PATCH_R
    ang = _patch_angles(patches[:, c0 : c0 + 2 * PATCH_R + 1, c0 : c0 + 2 * PATCH_R + 1])

    bits = _descriptors_from_patches(_patch_blur(patches), ang)

    scale_l = device_table(
        np.asarray, (tuple(config.scale**l for l in range(L)),), torch.float32, dev
    )[lvl.long()][:, None]
    xy = xy_lv * scale_l
    return Features(
        xy=torch.where(valid[:, None], xy, torch.zeros_like(xy)),
        level=lvl,
        angle=ang,
        response=resp,
        desc_packed=pack_bits(bits),
        desc_sign=torch.where(
            valid[:, None], sign_expand(bits), torch.zeros((), dtype=torch.int8, device=dev)
        ),
        valid=valid,
    )
