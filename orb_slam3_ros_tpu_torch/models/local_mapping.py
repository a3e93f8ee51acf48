"""Local BA of the keyframe path — port of the mono and mono-inertial parts
of ``orb_slam3_ros_tpu.models.local_mapping``: covisibility window
selection, the window -> ``BAProblem`` gather and the scatter back into
the map (the reference's LocalMapping local-BA dispatch,
Optimizer.cc:1120-1460), the temporal-window visual-inertial problem
``build_vi_ba`` / ``apply_vi_ba`` (``LocalInertialBA``, Optimizer.cc:2528),
and the global BA of loop closing: ``build_global_ba`` and the fold-ins of a
result solved on a snapshot, ``apply_global_ba_partial`` /
``apply_vi_gba_partial`` (LoopClosing.cc:3660-3780).

Keyframe ids may be 0-d device tensors (the chunk loop's): the mono and VI
windows, their gathers and their write-backs read nothing back to the host.

Window entries that do not exist (fewer covisible keyframes than the
window holds) carry ``entry_valid`` False; their ids may alias live
entries. The JAX package routes their writes out of bounds and lets
``mode="drop"`` discard them; here they go to a spare row past the end
of a one-row-longer buffer, which is then cut off.
"""

from __future__ import annotations

import torch

from ..ops import ba, imu, viba
from ..ops.topk import top_k
from .map_state import MapState, covisibility, kf_index, obs_matrix

P_BA = 2048  # compacted landmark capacity of a local-BA window


def _scalar(x, dtype, device) -> torch.Tensor:
    """``x`` (a float or a 0-d tensor) as a 0-d tensor on ``device``, made
    there: no copy from the host."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype, device=device)
    return torch.full((), x, dtype=dtype, device=device)


def select_covis_window(m: MapState, last, w_free: int, w_fixed: int):
    """Covisibility local-BA window around keyframe ``last`` (an int, or a
    0-d tensor on the map's device: no host read): free set =
    ``last`` + its top-(w_free - 1) keyframes by covisibility weight; fixed
    set = the top-w_fixed other keyframes by the number of the free set's
    points they observe. Slot 0 (the gauge root) is always fixed, and the
    weakest free entries are demoted until >= 2 cameras are fixed (mono
    gauge). Ties rank the lower slot first, as ``lax.top_k`` does.

    Returns (window_ids [w_free + w_fixed] int32, fixed_mask, entry_valid)."""
    K = m.K
    dev = m.kf_valid.device
    valid = m.kf_valid
    k = kf_index(last, dev)
    row = covisibility(m).index_select(0, k)[0].to(torch.float32)
    row = torch.where(valid, row, torch.full_like(row, -float("inf")))
    row.index_fill_(0, k, float("inf"))  # the current keyframe always leads the window
    fv, fids = top_k(row, w_free)
    f_ok = fv > 0.0  # self, or shares >= 1 point
    obsM = obs_matrix(m)  # [K,P]
    free_k = torch.zeros((K,), dtype=torch.bool, device=dev)
    free_k[fids] = f_ok  # top-k indices are distinct
    local_pts = torch.any(obsM & free_k[:, None], dim=0)  # [P]
    fx_score = torch.sum(obsM & local_pts[None, :], dim=-1).to(torch.float32)
    fx_score = torch.where(valid & ~free_k, fx_score, torch.full_like(fx_score, -float("inf")))
    xv, xids = top_k(fx_score, w_fixed)
    x_ok = xv > 0.0
    fixed_free0 = (fids == 0) & f_ok
    n_anchor = torch.sum(x_ok, dtype=torch.int32) + torch.sum(fixed_free0, dtype=torch.int32)
    n_free = torch.sum(f_ok, dtype=torch.int32)
    need = torch.clamp(2 - n_anchor, min=0)
    pos = torch.arange(w_free, device=dev)
    demote = f_ok & ~fixed_free0 & (pos > 0) & (pos >= n_free - need)
    window_ids = torch.cat([fids, xids]).to(torch.int32)
    fixed_mask = torch.cat([fixed_free0 | demote, torch.ones((w_fixed,), dtype=torch.bool, device=dev)])
    entry_valid = torch.cat([f_ok, x_ok])
    return window_ids, fixed_mask, entry_valid


def build_local_ba(
    m: MapState,
    window_ids: torch.Tensor,  # [W] int32 keyframe ids (free + fixed)
    fixed_mask: torch.Tensor,  # [W] bool
    cam_params: torch.Tensor,
    scale: float = 1.2,
    bf: float = 0.0,
    entry_valid: torch.Tensor | None = None,
):
    """Gather the window into a fixed-capacity BA problem: one edge per
    (window keyframe, feature) slot with a bound live point, the observed
    points compacted into P_BA slots in index order (edges beyond P_BA are
    masked out).

    Returns (BAProblem, sel [P_BA] int32): ``sel`` maps compact slots back
    to point ids, P for unused slots."""
    W = window_ids.shape[0]
    N, P = m.N, m.P
    dev = m.kf_obs.device
    wid = window_ids.long()
    cam_ok = m.kf_valid[wid]
    if entry_valid is not None:
        cam_ok = cam_ok & entry_valid  # dead entries: no camera, no edges
    obs = m.kf_obs[wid].reshape(-1)  # [W*N]
    pt_idx = torch.clamp(obs, 0, P - 1).long()
    edge_valid = (
        (obs >= 0)
        & m.kf_feat_valid[wid].reshape(-1)
        & cam_ok.repeat_interleave(N)
        & m.pt_valid[pt_idx]
    )
    inv_sigma2 = 1.0 / scale ** (2.0 * m.kf_level[wid].reshape(-1).to(torch.float32))
    # Compact the observed points into P_BA slots: the observed ids in
    # ascending order (a stable sort of the unobserved flag, which needs
    # no host sync), padded with P.
    mark = torch.zeros((P,), dtype=torch.int32, device=dev).index_add_(
        0, pt_idx, edge_valid.to(torch.int32)
    ) > 0
    order = torch.argsort((~mark).to(torch.uint8), stable=True)[:P_BA].to(torch.int32)
    sel = torch.full((P_BA,), P, dtype=torch.int32, device=dev)
    sel[: order.shape[0]] = order
    slot_valid = torch.arange(P_BA, device=dev) < torch.sum(mark)
    sel = torch.where(slot_valid, sel, P)
    # inverse map point id -> compact slot; the pad slots all write -1 at P
    inv = torch.full((P + 1,), -1, dtype=torch.int32, device=dev)
    inv[sel.long()] = torch.where(slot_valid, torch.arange(P_BA, dtype=torch.int32, device=dev), -1)
    pt_c = inv[pt_idx]  # -1 for unobserved / overflow
    edge_valid = edge_valid & (pt_c >= 0)
    prob = ba.BAProblem(
        R=m.kf_R[wid],
        t=m.kf_t[wid],
        cam_fixed=fixed_mask,
        cam_valid=cam_ok,
        X=m.pt_X[torch.clamp(sel, 0, P - 1).long()],
        pt_valid=slot_valid,
        cam_idx=torch.arange(W, dtype=torch.int32, device=dev).repeat_interleave(N),
        pt_idx=torch.clamp(pt_c, 0, P_BA - 1),
        uv=m.kf_xy[wid].reshape(-1, 2),
        inv_sigma2=inv_sigma2,
        edge_valid=edge_valid,
        cam_params=cam_params,
        ur=m.kf_ur[wid].reshape(-1),
        bf=_scalar(bf, m.kf_t.dtype, dev),
    )
    return prob, sel


def _live_ids(m: MapState, window_ids, entry_valid):
    """Window ids as int64 write indices, dead entries routed to K."""
    ids = window_ids.long()
    if entry_valid is not None:
        ids = torch.where(entry_valid, ids, m.K)
    return ids


def _write_rows(table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table`` with ``rows`` written at ``ids``, writes at index
    len(table) dropped (the spare row of a one-row-longer buffer)."""
    buf = torch.cat([table, table[:1]])
    buf[ids] = rows
    return buf[:-1]


def apply_local_ba(
    m: MapState,
    window_ids: torch.Tensor,
    sel: torch.Tensor,
    res: ba.BAResult,
    entry_valid: torch.Tensor | None = None,
) -> MapState:
    """Scatter the optimized poses and compacted points back into the map
    (pad slots of ``sel`` and dead window entries are dropped)."""
    ids = _live_ids(m, window_ids, entry_valid)
    return m._replace(
        kf_R=_write_rows(m.kf_R, ids, res.R),
        kf_t=_write_rows(m.kf_t, ids, res.t),
        pt_X=_write_rows(m.pt_X, sel.long(), res.X),
    )


def local_ba(m: MapState, window, cam_params: torch.Tensor, n_iters: int, bf: float = 0.0,
             cam_model: str = "pinhole", on_device: bool = False):
    """One local BA over ``window`` = (window_ids, fixed_mask, entry_valid
    or None): build the problem, solve it under ``cam_model`` (stopping at
    rel_tol 1e-3; with ``on_device`` in ``ba.bundle_adjust``'s device form,
    no host read), write the poses and points back, unbind the outlier
    observations. Returns (map, LM iterations run: an int, or a 0-d int32
    tensor with ``on_device``)."""
    window_ids, fixed_mask, entry_valid = window
    prob, sel = build_local_ba(m, window_ids, fixed_mask, cam_params, bf=bf, entry_valid=entry_valid)
    res = ba.bundle_adjust(prob, n_iters=n_iters, rel_tol=1e-3, on_device=on_device,
                           cam_model=cam_model)
    m = apply_local_ba(m, window_ids, sel, res, entry_valid)
    return drop_ba_outlier_obs(m, window_ids, res, entry_valid), res.iters


def drop_ba_outlier_obs(
    m: MapState,
    window_ids: torch.Tensor,
    res: ba.BAResult,
    entry_valid: torch.Tensor | None = None,
) -> MapState:
    """Unbind the observations whose BA edge ended as an outlier (the
    reference erases them after local BA, Optimizer.cc:1438-1460). For a
    bound observation, ~inlier means a chi2 outlier or a dead point: both
    are cleared."""
    W, N = window_ids.shape[0], m.N
    ids = _live_ids(m, window_ids, entry_valid)
    obs_w = m.kf_obs[torch.clamp(ids, 0, m.K - 1)]
    clear = ((obs_w.reshape(-1) >= 0) & ~res.inlier).reshape(W, N)
    return m._replace(kf_obs=_write_rows(m.kf_obs, ids, torch.where(clear, -1, obs_w)))


def build_vi_ba(
    m: MapState,
    window_ids: torch.Tensor,  # [W] keyframe ids in time order
    fixed_mask: torch.Tensor,  # [W] bool
    acc_w: torch.Tensor,  # [W-1, S, 3] IMU blocks integrating id[i] -> id[i+1]
    gyro_w: torch.Tensor,  # [W-1, S, 3]
    dts_w: torch.Tensor,  # [W-1, S]
    edge_ok: torch.Tensor,  # [W-1] bool (consecutive-in-time pairs)
    calib: imu.ImuCalib,
    cam_params: torch.Tensor,
    scale: float = 1.2,
    bf: float | torch.Tensor = 0.0,
) -> viba.VIBAProblem:
    """Assemble a visual-inertial BA window: one visual edge per (window
    keyframe, feature) slot over the whole point table, plus preintegration
    edges between consecutive window keyframes, re-integrated at the earlier
    keyframe's current bias estimate (the reference calls Reintegrate on
    bias updates); all W-1 blocks in one batched call of the tree
    integrator."""
    W = window_ids.shape[0]
    N, P = m.N, m.P
    dev = m.kf_obs.device
    wid = window_ids.long()
    kf_valid = m.kf_valid[wid]
    obs = m.kf_obs[wid].reshape(-1)
    pt_idx = torch.clamp(obs, 0, P - 1)
    edge_valid = (
        (obs >= 0)
        & m.kf_feat_valid[wid].reshape(-1)
        & kf_valid.repeat_interleave(N)
        & m.pt_valid[pt_idx.long()]
    )
    inv_sigma2 = 1.0 / scale ** (2.0 * m.kf_level[wid].reshape(-1).to(torch.float32))
    R_wb, p_wb = viba.body_from_cam(m.kf_R[wid], m.kf_t[wid], calib.R_bc, calib.t_bc)
    bg, ba_ = m.kf_bg[wid], m.kf_ba[wid]
    states = viba.VIStates(R_wb=R_wb, p_wb=p_wb, v_w=m.kf_v[wid], bg=bg, ba=ba_)
    # linearize each edge at the earlier keyframe's bias
    b_lin = torch.cat([bg[:-1], ba_[:-1]], dim=1)  # [W-1, 6]
    pre = imu.preintegrate(acc_w, gyro_w, dts_w, b_lin, calib)
    ie_valid = edge_ok & kf_valid[:-1] & kf_valid[1:] & (pre.dT > 1e-6)
    return viba.VIBAProblem(
        states=states,
        kf_fixed=fixed_mask,
        kf_valid=kf_valid,
        X=m.pt_X,
        pt_valid=m.pt_valid,
        cam_idx=torch.arange(W, dtype=torch.int32, device=dev).repeat_interleave(N),
        pt_idx=pt_idx.to(torch.int32),
        uv=m.kf_xy[wid].reshape(-1, 2),
        inv_sigma2=inv_sigma2,
        edge_valid=edge_valid,
        ie_i=torch.arange(W - 1, dtype=torch.int32, device=dev),
        ie_j=torch.arange(1, W, dtype=torch.int32, device=dev),
        ie_preint=pre,
        ie_valid=ie_valid,
        cam_params=cam_params,
        R_bc=calib.R_bc,
        t_bc=calib.t_bc,
        # stereo disparity rows; kf_ur < 0 marks mono observations
        ur=m.kf_ur[wid].reshape(-1),
        bf=_scalar(bf, m.kf_t.dtype, dev),
    )


def apply_vi_ba(m: MapState, window_ids: torch.Tensor, res, calib: imu.ImuCalib) -> MapState:
    """Scatter VI-BA results (poses converted back to Tcw, velocities,
    biases, landmarks) into the map. Padded window entries all alias one
    empty slot and were never moved by the solve, so every write to it
    carries the same values."""
    R_cw, t_cw = viba.cam_from_body(res.states.R_wb, res.states.p_wb, calib.R_bc, calib.t_bc)
    wid = window_ids.long()

    def put(table, rows):
        return table.index_copy(0, wid, rows)

    return m._replace(
        kf_R=put(m.kf_R, R_cw),
        kf_t=put(m.kf_t, t_cw),
        kf_v=put(m.kf_v, res.states.v_w),
        kf_bg=put(m.kf_bg, res.states.bg),
        kf_ba=put(m.kf_ba, res.states.ba),
        pt_X=res.X,
    )


def build_global_ba(m: MapState, n_kf, cam_params: torch.Tensor, scale: float = 1.2,
                    bf: float | torch.Tensor = 0.0) -> ba.BAProblem:
    """The all-keyframe, all-landmark problem of the global BA (the
    reference's ``GlobalBundleAdjustemnt``, Optimizer.cc:52: every keyframe,
    keyframe 0 fixed, every point): one edge per (keyframe, feature) slot,
    K * N rows, uncompacted, for ``ba_pcg.bundle_adjust_pcg``. ``n_kf``: an
    int or a 0-d tensor."""
    K, N, P = m.K, m.N, m.P
    dev = m.kf_obs.device
    ids = torch.arange(K, device=dev)
    valid = m.kf_valid & (ids < n_kf)
    cam_idx = ids.to(torch.int32).repeat_interleave(N)
    flat_obs = m.kf_obs.reshape(-1)
    pt_idx = torch.clamp(flat_obs, 0, P - 1)
    edge_valid = (
        (flat_obs >= 0) & m.kf_feat_valid.reshape(-1) & valid.repeat_interleave(N)
        & m.pt_valid[pt_idx.long()]
    )
    inv_sigma2 = 1.0 / scale ** (2.0 * m.kf_level.reshape(-1).to(torch.float32))
    return ba.BAProblem(
        R=m.kf_R, t=m.kf_t, cam_fixed=(ids == 0) | ~valid, cam_valid=valid,
        X=m.pt_X, pt_valid=m.pt_valid, cam_idx=cam_idx, pt_idx=pt_idx.to(torch.int32),
        uv=m.kf_xy.reshape(-1, 2), inv_sigma2=inv_sigma2, edge_valid=edge_valid,
        cam_params=cam_params, ur=m.kf_ur.reshape(-1), bf=_scalar(bf, m.kf_t.dtype, dev),
    )


def _propagated_poses(m: MapState, R_s, t_s, n_kf0):
    """Poses after a solve of the keyframes below ``n_kf0`` (the snapshot's
    keyframes) whose optimized poses are (R_s, t_s): those take them, and
    every later keyframe keeps its pose relative to the reference keyframe
    r = n_kf0 - 1 (LoopClosing.cc:3660-3780's spanning-tree propagation,
    collapsed to the temporal parent). Returns (kf_R, kf_t, old_kf, r's
    pre- and post-solve pose)."""
    K = m.K
    dev = m.kf_R.device
    ids = torch.arange(K, device=dev)
    old_kf = ids < n_kf0
    r = kf_index(torch.clamp(torch.as_tensor(n_kf0, device=dev) - 1, 0, K - 1), dev)
    Rr_o, tr_o = m.kf_R.index_select(0, r)[0], m.kf_t.index_select(0, r)[0]
    Rr_n, tr_n = R_s.index_select(0, r)[0], t_s.index_select(0, r)[0]
    # T_k<-r = Tcw_k * Twc_r(old), held fixed; then Tcw_k' = T_k<-r * Tcw_r'
    Rk_r = m.kf_R @ Rr_o.T
    tk_r = m.kf_t - torch.einsum("kij,j->ki", Rk_r, tr_o)
    kf_R = torch.where(old_kf[:, None, None], R_s, Rk_r @ Rr_n)
    kf_t = torch.where(old_kf[:, None], t_s, torch.einsum("kij,j->ki", Rk_r, tr_n) + tk_r)
    return kf_R, kf_t, old_kf, (Rr_o, tr_o, Rr_n, tr_n)


def _propagated_points(m: MapState, X_s, n_kf0, ref_pose):
    """Points after a solve: those of the snapshot's keyframes take the
    solve's positions, those born later move with the reference keyframe's
    correction (world -> r's old camera -> new world)."""
    Rr_o, tr_o, Rr_n, tr_n = ref_pose
    old_pt = m.pt_first_kf < n_kf0
    X_prop = (m.pt_X @ Rr_o.T + tr_o - tr_n) @ Rr_n
    return torch.where((old_pt & m.pt_valid)[:, None], X_s,
                       torch.where(m.pt_valid[:, None], X_prop, m.pt_X))


def apply_global_ba_partial(m: MapState, res: ba.BAResult, n_kf0,
                            kf_obs0: torch.Tensor | None = None) -> MapState:
    """Fold in a global-BA result solved on a snapshot while tracking kept
    inserting keyframes (LoopClosing::RunGlobalBundleAdjustment's post-GBA
    update, LoopClosing.cc:3660-3780): keyframes below ``n_kf0`` take their
    optimized poses, later ones and the points they made ride the
    correction of keyframe ``n_kf0 - 1``. Outlier observations are unbound
    on the snapshot's keyframes only, and (given ``kf_obs0``, the
    snapshot's observation table) only where the binding is unchanged since
    the snapshot: a binding made during the solve was never in it."""
    K, N = m.K, m.N
    kf_R, kf_t, old_kf, ref_pose = _propagated_poses(m, res.R, res.t, n_kf0)
    clear = ((m.kf_obs.reshape(-1) >= 0) & ~res.inlier).reshape(K, N) & old_kf[:, None]
    if kf_obs0 is not None:
        clear = clear & (m.kf_obs == kf_obs0)
    return m._replace(
        kf_R=kf_R, kf_t=kf_t, pt_X=_propagated_points(m, res.X, n_kf0, ref_pose),
        kf_obs=torch.where(clear, -1, m.kf_obs),
    )


def apply_global_ba(m: MapState, res: ba.BAResult) -> MapState:
    """Scatter a global-BA result back (every keyframe was in the problem;
    fixed and invalid slots come back unchanged) and unbind the chi2
    outlier observations."""
    clear = ((m.kf_obs.reshape(-1) >= 0) & ~res.inlier).reshape(m.K, m.N)
    return m._replace(
        kf_R=res.R, kf_t=res.t, pt_X=torch.where(m.pt_valid[:, None], res.X, m.pt_X),
        kf_obs=torch.where(clear, -1, m.kf_obs),
    )


def apply_vi_gba_partial(m: MapState, window_ids: torch.Tensor, res, calib: imu.ImuCalib,
                         n_kf0, kf_obs0: torch.Tensor | None = None) -> MapState:
    """Fold in a full-inertial-BA result solved on a snapshot (the inertial
    twin of ``apply_global_ba_partial``, the reference's FullInertialBA
    branch of RunGlobalBundleAdjustment): keyframes the solve saw take
    their optimized pose, velocity and biases; later keyframes keep their
    pose relative to keyframe ``n_kf0 - 1`` with their world velocity
    rotated by its correction, and the points they made move with it.
    Outliers are unbound only on rows the solve saw, on the snapshot's
    keyframes, where the binding is unchanged since ``kf_obs0``."""
    K, N = m.K, m.N
    R_cw, t_cw = viba.cam_from_body(res.states.R_wb, res.states.p_wb, calib.R_bc, calib.t_bc)
    wid = window_ids.long()

    def put(table, rows):
        return table.index_copy(0, wid, rows)

    kf_R, kf_t, old_kf, ref_pose = _propagated_poses(m, put(m.kf_R, R_cw), put(m.kf_t, t_cw), n_kf0)
    Rr_o, _, Rr_n, _ = ref_pose
    R_corr = Rr_n.T @ Rr_o  # new world <- old world
    kf_v = torch.where(old_kf[:, None], put(m.kf_v, res.states.v_w), m.kf_v @ R_corr.T)
    kf_bg = torch.where(old_kf[:, None], put(m.kf_bg, res.states.bg), m.kf_bg)
    kf_ba = torch.where(old_kf[:, None], put(m.kf_ba, res.states.ba), m.kf_ba)
    W = window_ids.shape[0]
    inl = torch.ones((K, N), dtype=torch.bool, device=m.kf_obs.device).index_copy(
        0, wid, res.inlier.reshape(W, N))
    clear = (m.kf_obs >= 0) & ~inl & old_kf[:, None]
    if kf_obs0 is not None:
        clear = clear & (m.kf_obs == kf_obs0)
    return m._replace(
        kf_R=kf_R, kf_t=kf_t, kf_v=kf_v, kf_bg=kf_bg, kf_ba=kf_ba,
        pt_X=_propagated_points(m, res.X, n_kf0, ref_pose),
        kf_obs=torch.where(clear, -1, m.kf_obs),
    )
