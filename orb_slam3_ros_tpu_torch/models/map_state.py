"""Fixed-capacity map state — port of ``orb_slam3_ros_tpu.models.map_state``.

The map is one NamedTuple of fixed-capacity tensors with validity masks,
with the JAX package's field names, dtypes and layouts. ``from_numpy`` /
``to_numpy`` carry it across packages: a map built or saved by the JAX
package becomes a ``MapState`` here and back without conversion of meaning.
Only the scatter formulation of ``obs_matrix`` is ported; the dense one was
a TPU workaround. ``covisibility`` and ``point_obs_count`` derive from it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device


class MapState(NamedTuple):
    # --- keyframes ---
    kf_valid: torch.Tensor  # [K] bool
    kf_R: torch.Tensor  # [K,3,3] Tcw rotation
    kf_t: torch.Tensor  # [K,3] Tcw translation
    kf_xy: torch.Tensor  # [K,N,2] undistorted level-0 keypoint coords
    kf_level: torch.Tensor  # [K,N] int32
    kf_angle: torch.Tensor  # [K,N]
    kf_desc_sign: torch.Tensor  # [K,N,256] int8
    kf_feat_valid: torch.Tensor  # [K,N] bool
    kf_obs: torch.Tensor  # [K,N] int32 map-point id or -1
    kf_ts: torch.Tensor  # [K] timestamps
    kf_ur: torch.Tensor  # [K,N] right-image x of a stereo match, -1 = mono
    # --- map points ---
    pt_valid: torch.Tensor  # [P] bool
    pt_X: torch.Tensor  # [P,3] world position
    pt_desc_sign: torch.Tensor  # [P,256] int8 representative descriptor
    pt_level: torch.Tensor  # [P] int32 reference octave
    pt_found: torch.Tensor  # [P] int32 found counter (tracking inlier)
    pt_visible: torch.Tensor  # [P] int32 visible counter (in frustum)
    pt_first_kf: torch.Tensor  # [P] int32 creating keyframe
    pt_normal: torch.Tensor  # [P,3] mean unit view direction (world)
    pt_min_dist: torch.Tensor  # [P] scale-invariance band lower edge
    pt_max_dist: torch.Tensor  # [P] scale-invariance band upper edge (0 = unset)
    # --- inertial body state per keyframe (zeros until IMU init) ---
    kf_v: torch.Tensor  # [K,3]
    kf_bg: torch.Tensor  # [K,3]
    kf_ba: torch.Tensor  # [K,3]

    @property
    def K(self) -> int:
        return self.kf_valid.shape[0]

    @property
    def P(self) -> int:
        return self.pt_valid.shape[0]

    @property
    def N(self) -> int:
        return self.kf_obs.shape[1]


def empty_map(K: int, N: int, P: int, dtype=torch.float32, device=None) -> MapState:
    """An empty map on ``device`` (None: the CUDA device, see
    ``orb_slam3_ros_tpu_torch.default_device``)."""
    device = resolve_device(device)
    kw = dict(device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return MapState(
        kf_valid=torch.zeros((K,), dtype=torch.bool, **kw),
        kf_R=torch.eye(3, dtype=dtype, **kw).repeat(K, 1, 1),
        kf_t=torch.zeros((K, 3), dtype=dtype, **kw),
        kf_xy=torch.zeros((K, N, 2), dtype=dtype, **kw),
        kf_level=torch.zeros((K, N), **i32),
        kf_angle=torch.zeros((K, N), dtype=dtype, **kw),
        kf_desc_sign=torch.zeros((K, N, 256), dtype=torch.int8, **kw),
        kf_feat_valid=torch.zeros((K, N), dtype=torch.bool, **kw),
        kf_obs=torch.full((K, N), -1, **i32),
        kf_ts=torch.zeros((K,), dtype=dtype, **kw),
        kf_ur=torch.full((K, N), -1.0, dtype=dtype, **kw),
        pt_valid=torch.zeros((P,), dtype=torch.bool, **kw),
        pt_X=torch.zeros((P, 3), dtype=dtype, **kw),
        pt_desc_sign=torch.zeros((P, 256), dtype=torch.int8, **kw),
        pt_level=torch.zeros((P,), **i32),
        pt_found=torch.zeros((P,), **i32),
        pt_visible=torch.zeros((P,), **i32),
        pt_first_kf=torch.zeros((P,), **i32),
        pt_normal=torch.zeros((P, 3), dtype=dtype, **kw),
        pt_min_dist=torch.zeros((P,), dtype=dtype, **kw),
        pt_max_dist=torch.zeros((P,), dtype=dtype, **kw),
        kf_v=torch.zeros((K, 3), dtype=dtype, **kw),
        kf_bg=torch.zeros((K, 3), dtype=dtype, **kw),
        kf_ba=torch.zeros((K, 3), dtype=dtype, **kw),
    )


def from_numpy(arrays, device) -> MapState:
    """MapState on ``device`` from a mapping of numpy arrays keyed by field
    name and laid out like the JAX package's (a dict, or a loaded
    checkpoint npz)."""
    return MapState(**{
        k: torch.from_numpy(np.array(arrays[k], copy=True)).to(device)
        for k in MapState._fields
    })


def to_numpy(m: MapState) -> dict:
    """Dict of numpy arrays with the JAX package's dtypes and layouts."""
    return {k: getattr(m, k).detach().cpu().numpy() for k in MapState._fields}


def kf_index(kf, device) -> torch.Tensor:
    """Keyframe slot ``kf`` (an int or a 0-d tensor) as a 1-element int64
    index for ``index_select`` / ``index_copy``. Indexing with a 0-d tensor
    would read it back to the host (a sync on the card)."""
    if isinstance(kf, torch.Tensor):
        return kf.reshape(1).long()
    return torch.full((1,), kf, dtype=torch.int64, device=device)


def obs_matrix(m: MapState) -> torch.Tensor:
    """[K, P] bool: keyframe k observes point p (scatter formulation)."""
    K, N, P = m.K, m.N, m.P
    mask = m.kf_feat_valid & (m.kf_obs >= 0) & m.kf_valid[:, None]
    flat = (
        torch.arange(K, device=m.kf_obs.device).repeat_interleave(N) * P
        + torch.clamp(m.kf_obs.reshape(-1).long(), 0, P - 1)
    )
    out = torch.zeros((K * P,), dtype=torch.uint8, device=m.kf_obs.device)
    out.scatter_reduce_(0, flat, mask.reshape(-1).to(torch.uint8), "amax")
    return out.reshape(K, P).bool()


def covisibility(m: MapState) -> torch.Tensor:
    """[K, K] int32 shared-point counts (KeyFrame::UpdateConnections
    weights), zero on the diagonal: one float32 matrix product over the
    observation matrix, exact for counts below 2^24."""
    obs = obs_matrix(m).to(torch.float32)
    cov = obs @ obs.T
    cov.fill_diagonal_(0.0)
    return cov.to(torch.int32)


def point_obs_count(m: MapState) -> torch.Tensor:
    """[P] int32 number of keyframes observing each point."""
    return torch.sum(obs_matrix(m), dim=0, dtype=torch.int32)
