"""One keyframe's mapping work (LocalMapping::Run's per-keyframe body) —
port of ``orb_slam3_ros_tpu.models.kf_work``: insert, triangulate against
the previous keyframe, admit, fuse with the covisible neighbour, the
covisibility local BA, point culling, point statistics, keyframe culling.

The JAX package jits this sequence into one program to save per-dispatch
latency; here it is the same stages called one after another. A caller
may pass the local-BA window; by default it is the covisibility window
chosen after fusion (the JAX package's ``keyframe_work``).
"""

from __future__ import annotations

import torch

from ..ops.orb import Features
from . import local_mapping, map_updates, tracking
from .map_state import MapState


def keyframe_work(
    m: MapState,
    kf_id: int,
    R_cur: torch.Tensor,
    t_cur: torch.Tensor,
    ts: float,
    feats: Features,
    feat_pt: torch.Tensor,
    n_pts: int,
    free_cap: int,
    cam_params: torch.Tensor,
    bf: float = 0.0,
    *,
    w_free: int,
    w_fixed: int,
    n_iters: int,
    n_levels: int,
    fuse_neighbors: int,
    do_fuse: bool,
    do_stats: bool,
    do_cull: bool,
    width: int,
    height: int,
    window: tuple | None = None,
    cam_model: str = "pinhole",
    on_device: bool = False,
) -> tuple[MapState, torch.Tensor, int | torch.Tensor]:
    """One keyframe's full mapping work on ``m`` (whose tensors it updates
    in place where the stages do). ``window``: the local-BA window as
    (window_ids, fixed_mask, entry_valid or None); None selects the
    covisibility window of ``w_free`` + ``w_fixed`` entries. ``cam_model``:
    the camera of triangulation, fusion and the BA rows (pinhole | kb8).
    ``on_device``: the local BA in ``ba.bundle_adjust``'s device form, so
    that the whole work is queued with no host read (the pipelined mode's
    deferred keyframe; the results are the same to the bit). Returns (map,
    n_new_points as a 0-d int32 tensor, local-BA iterations run: an int, or
    a 0-d int32 tensor with ``on_device``)."""
    m = map_updates.insert_keyframe(m, kf_id, R_cur, t_cur, ts, feats, feat_pt)
    tri = tracking.triangulate_with_ref(m, kf_id, kf_id - 1, cam_params, cam_model=cam_model)
    m, n_new = map_updates.admit_new_points(m, kf_id, kf_id - 1, tri, n_pts, free_cap)
    if do_fuse:
        m, _ = map_updates.fuse_in_neighbors(
            m, kf_id, cam_params, width, height, n_neighbors=fuse_neighbors,
            cam_model=cam_model,
        )
    if window is None:
        window = local_mapping.select_covis_window(m, kf_id, w_free, w_fixed)
    m, iters = local_mapping.local_ba(m, window, cam_params, n_iters, bf, cam_model,
                                      on_device=on_device)
    m = map_updates.cull_points(m, kf_id + 1)
    if do_stats:
        m = map_updates.refresh_point_stats(m, n_levels=n_levels)
    if do_cull:
        m, _ = map_updates.cull_keyframes(m, kf_id + 1, n_levels=n_levels)
    return m, n_new, iters


def keyframe_work_impl(*args, **kw) -> tuple[MapState, torch.Tensor]:
    """The JAX package's ``keyframe_work_impl``: ``keyframe_work`` without
    the iteration count, (map, n_new_points). Its ``row_n`` BA formulation
    is a TPU workaround, not ported; under KB8 the JAX function reads the
    camera as pinhole (ROADMAP "Known faults"), this one keeps
    ``cam_model``."""
    return keyframe_work(*args, **kw)[:2]
