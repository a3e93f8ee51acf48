"""The loop-closure problem dump and its offline re-optimization — port of
``orb_slam3_ros_tpu.utils.optdump``.

Role of the fork's data-dump subsystem inside ``LoopClosing``:
``SaveOptimizationData`` (orb_slam3/src/LoopClosing.cc:125),
``SaveCompleteTrajectory`` (:377), ``SaveCovisibilityGraph`` (:630),
``SaveEssentialGraph`` (:713) and ``SaveIMUStates`` (:768), which write the
whole pre / post pose-graph problem to disk so that an offline solver can
re-solve it and compare.

The files are the JAX package's, one text file a section (keyframe poses,
covisibility weights, essential-graph edges with their relative Sim(3)
measurements, loop constraints, IMU states, map points): a dump written by
either package loads in the other. ``dump_from_map`` reads a port
``MapState``; ``reoptimize`` re-solves a dump with the port's pose-graph
optimizer (``ops/pgo.py``) on a torch device.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..models import map_state
from ..ops import lie, pgo

COV_MIN = 100  # covisibility weight that makes an extra edge (the reference's minFeat)


class OptDump(NamedTuple):
    kf_id: np.ndarray  # [K] int
    kf_ts: np.ndarray  # [K]
    kf_R: np.ndarray  # [K,3,3] Tcw rotation
    kf_t: np.ndarray  # [K,3]
    cov_i: np.ndarray  # [C] covisibility edges
    cov_j: np.ndarray
    cov_w: np.ndarray  # [C] shared-point weight
    e_i: np.ndarray  # [E] essential-graph edges (incl. loop edges)
    e_j: np.ndarray
    e_R: np.ndarray  # [E,3,3] measured relative S_ji rotation
    e_t: np.ndarray  # [E,3]
    e_s: np.ndarray  # [E]
    e_kind: np.ndarray  # [E] 0=spanning-tree/seq, 1=loop
    kf_v: np.ndarray  # [K,3] IMU velocity
    kf_bg: np.ndarray  # [K,3]
    kf_ba: np.ndarray  # [K,3]
    pt_X: np.ndarray  # [P,3]
    pt_ref_kf: np.ndarray  # [P]


def _quat_wxyz(R) -> np.ndarray:
    """Rotation matrices [..., 3, 3] -> (qw, qx, qy, qz), ``lie.quat_from_rotmat``."""
    return lie.quat_from_rotmat(torch.as_tensor(np.asarray(R, np.float32))).numpy()


def _rot_from_quat(q) -> np.ndarray:
    return lie.rotmat_from_quat(torch.as_tensor(np.asarray(q, np.float32))).numpy()


def save_optimization_data(
    dirpath: str,
    kf_id,
    kf_ts,
    kf_R,
    kf_t,
    cov,  # [K,K] covisibility weights (int) or None
    e_i,
    e_j,
    e_R,
    e_t,
    e_s,
    e_kind,
    kf_v=None,
    kf_bg=None,
    kf_ba=None,
    pt_X=None,
    pt_ref_kf=None,
) -> None:
    """Write one optimization problem to ``dirpath`` (created).

    File-per-section layout mirrors the fork's optimization_data dirs
    (LoopClosing.cc:125-1074 writes keyframe poses, covisibility with
    weights, essential graph, loop Sim3 constraints, IMU states, map
    points as separate text files).
    """
    os.makedirs(dirpath, exist_ok=True)
    kf_R = np.asarray(kf_R)
    kf_t = np.asarray(kf_t)
    K = len(kf_R)
    q = _quat_wxyz(kf_R)
    with open(os.path.join(dirpath, "keyframe_poses.txt"), "w") as f:
        f.write("# id ts qw qx qy qz tx ty tz  (T_cw)\n")
        for k in range(K):
            f.write(
                f"{int(kf_id[k])} {float(kf_ts[k]):.9f} "
                + " ".join(f"{v:.9f}" for v in q[k])
                + " "
                + " ".join(f"{v:.9f}" for v in kf_t[k])
                + "\n"
            )
    if cov is not None:
        cov = np.asarray(cov)
        ii, jj = np.nonzero(np.triu(cov, 1))
        with open(os.path.join(dirpath, "covisibility_graph.txt"), "w") as f:
            f.write("# i j weight\n")
            for a, b in zip(ii, jj):
                f.write(f"{int(kf_id[a])} {int(kf_id[b])} {int(cov[a, b])}\n")
    e_R = np.asarray(e_R)
    e_t = np.asarray(e_t)
    qe = _quat_wxyz(e_R) if len(e_R) else np.zeros((0, 4))
    with open(os.path.join(dirpath, "essential_graph.txt"), "w") as f:
        f.write("# i j kind s qw qx qy qz tx ty tz  (S_ji; kind 0=seq 1=loop)\n")
        for n in range(len(e_i)):
            f.write(
                f"{int(e_i[n])} {int(e_j[n])} {int(e_kind[n])} {float(e_s[n]):.9f} "
                + " ".join(f"{v:.9f}" for v in qe[n])
                + " "
                + " ".join(f"{v:.9f}" for v in e_t[n])
                + "\n"
            )
    if kf_v is not None:
        kf_v, kf_bg, kf_ba = (np.asarray(a) for a in (kf_v, kf_bg, kf_ba))
        with open(os.path.join(dirpath, "imu_states.txt"), "w") as f:
            f.write("# id vx vy vz bgx bgy bgz bax bay baz\n")
            for k in range(K):
                f.write(
                    f"{int(kf_id[k])} "
                    + " ".join(f"{v:.9f}" for v in kf_v[k])
                    + " "
                    + " ".join(f"{v:.9f}" for v in kf_bg[k])
                    + " "
                    + " ".join(f"{v:.9f}" for v in kf_ba[k])
                    + "\n"
                )
    if pt_X is not None:
        pt_X = np.asarray(pt_X)
        pt_ref_kf = np.asarray(pt_ref_kf)
        with open(os.path.join(dirpath, "map_points.txt"), "w") as f:
            f.write("# id x y z ref_kf\n")
            for p in range(len(pt_X)):
                f.write(
                    f"{p} "
                    + " ".join(f"{v:.9f}" for v in pt_X[p])
                    + f" {int(pt_ref_kf[p])}\n"
                )


def load_optimization_data(dirpath: str) -> OptDump:
    """Parse a dump directory back into arrays (role of the parsing half
    of 3DCERES/loop_optimization.cpp / test_op_data.cpp)."""
    kp = np.loadtxt(os.path.join(dirpath, "keyframe_poses.txt"), ndmin=2)
    kf_id = kp[:, 0].astype(np.int32)
    kf_ts = kp[:, 1]
    kf_R = _rot_from_quat(kp[:, 2:6].astype(np.float32))
    kf_t = kp[:, 6:9].astype(np.float32)

    cov_path = os.path.join(dirpath, "covisibility_graph.txt")
    if os.path.exists(cov_path) and os.path.getsize(cov_path) > 20:
        cg = np.loadtxt(cov_path, ndmin=2)
        if cg.size == 0:
            cg = np.zeros((0, 3))
    else:
        cg = np.zeros((0, 3))
    eg = np.loadtxt(os.path.join(dirpath, "essential_graph.txt"), ndmin=2)
    if eg.size == 0:
        eg = np.zeros((0, 11))
    imu_path = os.path.join(dirpath, "imu_states.txt")
    if os.path.exists(imu_path):
        st = np.loadtxt(imu_path, ndmin=2)
        kf_v = st[:, 1:4].astype(np.float32)
        kf_bg = st[:, 4:7].astype(np.float32)
        kf_ba = st[:, 7:10].astype(np.float32)
    else:
        kf_v = kf_bg = kf_ba = np.zeros((len(kf_id), 3), np.float32)
    pt_path = os.path.join(dirpath, "map_points.txt")
    if os.path.exists(pt_path) and os.path.getsize(pt_path) > 20:
        mp = np.loadtxt(pt_path, ndmin=2)
        pt_X = mp[:, 1:4].astype(np.float32) if mp.size else np.zeros((0, 3), np.float32)
        pt_ref = mp[:, 4].astype(np.int32) if mp.size else np.zeros((0,), np.int32)
    else:
        pt_X = np.zeros((0, 3), np.float32)
        pt_ref = np.zeros((0,), np.int32)
    return OptDump(
        kf_id=kf_id,
        kf_ts=kf_ts,
        kf_R=kf_R,
        kf_t=kf_t,
        cov_i=cg[:, 0].astype(np.int32),
        cov_j=cg[:, 1].astype(np.int32),
        cov_w=cg[:, 2].astype(np.int32),
        e_i=eg[:, 0].astype(np.int32),
        e_j=eg[:, 1].astype(np.int32),
        e_kind=eg[:, 2].astype(np.int32),
        e_s=eg[:, 3].astype(np.float32),
        e_R=_rot_from_quat(eg[:, 4:8].astype(np.float32)),
        e_t=eg[:, 8:11].astype(np.float32),
        kf_v=kf_v,
        kf_bg=kf_bg,
        kf_ba=kf_ba,
        pt_X=pt_X,
        pt_ref_kf=pt_ref,
    )


def dump_from_map(m, n_kf: int, loop_edges=None) -> dict:
    """The dump's arrays from a port ``MapState``, read to the host: the
    sequential spanning-tree edges between consecutive keyframes, with their
    relative Sim(3) S_ji = S_jw S_iw^-1 (scale 1), plus the loop constraints
    ``loop_edges`` [(i, j, R_ji, t_ji, s_ji), ...]. Keyword arguments of
    ``save_optimization_data``."""
    kf_R, kf_t = m.kf_R[:n_kf], m.kf_t[:n_kf]
    ones = torch.ones((n_kf - 1,), dtype=kf_t.dtype, device=kf_t.device)
    Rm, tm, sm = lie.sim3_mul(kf_R[1:], kf_t[1:], ones, *lie.sim3_inv(kf_R[:-1], kf_t[:-1], ones))
    host = [map_state.covisibility(m)[:n_kf, :n_kf], kf_R, kf_t, m.kf_ts[:n_kf], Rm, tm, sm,
            m.kf_v[:n_kf], m.kf_bg[:n_kf], m.kf_ba[:n_kf], m.pt_valid, m.pt_X, m.pt_first_kf]
    cov, kf_R, kf_t, kf_ts, Rm, tm, sm, kf_v, kf_bg, kf_ba, pt_valid, pt_X, pt_first = [
        x.cpu().numpy() for x in host]
    e_i, e_j = list(range(n_kf - 1)), list(range(1, n_kf))
    e_R, e_t, e_s, e_kind = list(Rm), list(tm), list(sm), [0] * (n_kf - 1)
    for i, j, R_ji, t_ji, s_ji in loop_edges or []:
        e_i.append(int(i))
        e_j.append(int(j))
        e_R.append(np.asarray(R_ji))
        e_t.append(np.asarray(t_ji))
        e_s.append(float(s_ji))
        e_kind.append(1)
    return dict(
        kf_id=np.arange(n_kf), kf_ts=kf_ts, kf_R=kf_R, kf_t=kf_t, cov=cov,
        e_i=np.asarray(e_i), e_j=np.asarray(e_j), e_R=np.stack(e_R), e_t=np.stack(e_t),
        e_s=np.asarray(e_s, np.float32), e_kind=np.asarray(e_kind),
        kf_v=kf_v, kf_bg=kf_bg, kf_ba=kf_ba, pt_X=pt_X[pt_valid], pt_ref_kf=pt_first[pt_valid],
    )


def reoptimize(dump: OptDump, n_iters: int = 30, four_dof: bool = False,
               loop_weight: float = 5.0, device=None):
    """Re-solve a dump's essential graph with ``ops/pgo.py`` on ``device``
    (None: the CUDA device): the offline-solver workflow (parse the dump,
    rebuild vertices and edges, optimize, compare before / after).

    Strong covisibility pairs (weight >= ``COV_MIN``, the reference's
    minFeat = 100 covisibility edges, Optimizer.cc:1711) not already edges
    become extra edges measured from the dump's poses; the loop edges weigh
    ``loop_weight`` and their endpoints j are fixed with the first keyframe
    (the reference fixes the loop keyframe, Optimizer.cc:1535).

    Returns (R [K, 3, 3], t [K, 3] (divided by the scale), s [K], cost),
    numpy and a float."""
    dev = resolve_device(device)
    K = len(dump.kf_id)
    id_to_idx = {int(v): k for k, v in enumerate(dump.kf_id)}
    e_i = np.asarray([id_to_idx[int(v)] for v in dump.e_i], np.int32)
    e_j = np.asarray([id_to_idx[int(v)] for v in dump.e_j], np.int32)
    w = np.where(dump.e_kind == 1, loop_weight, 1.0).astype(np.float32)
    e_R = dump.e_R.astype(np.float32)
    e_t = dump.e_t.astype(np.float32)
    e_s = dump.e_s.astype(np.float32)
    if len(dump.cov_i):
        have = {(int(a), int(b)) for a, b in zip(e_i, e_j)}
        have |= {(b, a) for a, b in have}
        ci = np.asarray([id_to_idx[int(v)] for v in dump.cov_i], np.int32)
        cj = np.asarray([id_to_idx[int(v)] for v in dump.cov_j], np.int32)
        keep = (dump.cov_w >= COV_MIN) & np.asarray(
            [(int(a), int(b)) not in have for a, b in zip(ci, cj)], bool)
        if keep.any():
            ci, cj = ci[keep], cj[keep]
            R = torch.from_numpy(dump.kf_R.astype(np.float32))
            t = torch.from_numpy(dump.kf_t.astype(np.float32))
            ones = torch.ones((len(ci),), dtype=torch.float32)
            Rm, tm, sm = lie.sim3_mul(R[cj], t[cj], ones,
                                      *lie.sim3_inv(R[ci], t[ci], ones))
            e_i, e_j = np.concatenate([e_i, ci]), np.concatenate([e_j, cj])
            e_R = np.concatenate([e_R, Rm.numpy()])
            e_t = np.concatenate([e_t, tm.numpy()])
            e_s = np.concatenate([e_s, sm.numpy()])
            w = np.concatenate([w, np.ones((len(ci),), np.float32)])
    fixed = np.zeros((K,), bool)
    fixed[0] = True
    fixed[e_j[: len(dump.e_kind)][dump.e_kind == 1]] = True

    def dv(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    prob = pgo.PGOProblem(
        R=dv(dump.kf_R, torch.float32), t=dv(dump.kf_t, torch.float32),
        s=torch.ones((K,), dtype=torch.float32, device=dev), kf_fixed=dv(fixed),
        kf_valid=torch.ones((K,), dtype=torch.bool, device=dev), e_i=dv(e_i), e_j=dv(e_j),
        e_R=dv(e_R), e_t=dv(e_t), e_s=dv(e_s),
        e_valid=torch.ones((len(e_i),), dtype=torch.bool, device=dev), e_weight=dv(w),
    )
    solve = pgo.optimize_pose_graph_4dof if four_dof else pgo.optimize_pose_graph
    res = solve(prob, n_iters=n_iters)
    R_new, t_new, s_new, cost = (x.cpu().numpy() for x in (res.R, res.t, res.s, res.cost))
    s_new = np.maximum(s_new, 1e-6)
    return R_new, t_new / s_new[:, None], s_new, float(cost)


def trajectory_from_poses(kf_ts, kf_R, kf_t):
    """Tcw arrays -> [(ts, Twc 4x4)] for ``trajectory.save_tum``."""
    out = []
    for k in range(len(kf_ts)):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = kf_R[k].T
        T[:3, 3] = -kf_R[k].T @ kf_t[k]
        out.append((float(kf_ts[k]), T))
    return out
