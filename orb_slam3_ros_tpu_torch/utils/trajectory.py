"""Trajectory export in the reference's formats — a numpy copy of
``orb_slam3_ros_tpu.utils.trajectory`` (importing that module imports the
JAX package).

``System::SaveTrajectoryTUM`` / ``EuRoC`` / ``KITTI`` (System.cc:553, :646,
:1190): TUM = ``ts x y z qx qy qz qw``, EuRoC differs only in its
nanosecond timestamps, KITTI = the flattened 3x4 row-major pose.
"""

from __future__ import annotations

import numpy as np


def quat_from_rotmat(R: np.ndarray) -> np.ndarray:
    """[..., 3, 3] -> unit quaternion [..., 4] as (qw, qx, qy, qz), qw >= 0
    (Shepperd's method: the candidate built on the largest of the four
    magnitudes, as the JAX package's ``lie.quat_from_rotmat``)."""
    R = np.asarray(R)
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = np.maximum(1.0 + tr, 0.0)
    qx2 = np.maximum(1.0 + m00 - m11 - m22, 0.0)
    qy2 = np.maximum(1.0 - m00 + m11 - m22, 0.0)
    qz2 = np.maximum(1.0 - m00 - m11 + m22, 0.0)
    cand = np.stack([
        np.stack([qw2, m21 - m12, m02 - m20, m10 - m01], axis=-1),
        np.stack([m21 - m12, qx2, m01 + m10, m02 + m20], axis=-1),
        np.stack([m02 - m20, m01 + m10, qy2, m12 + m21], axis=-1),
        np.stack([m10 - m01, m02 + m20, m12 + m21, qz2], axis=-1),
    ], axis=-2)
    idx = np.argmax(np.stack([qw2, qx2, qy2, qz2], axis=-1), axis=-1)
    q = np.take_along_axis(cand, idx[..., None, None], axis=-2)[..., 0, :]
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    return q * np.where(q[..., :1] < 0, -1.0, 1.0).astype(q.dtype)


def _quat_xyzw(Rwc: np.ndarray) -> np.ndarray:
    q = quat_from_rotmat(Rwc)  # (w, x, y, z)
    return np.concatenate([q[..., 1:], q[..., :1]], axis=-1)


def save_tum(path: str, trajectory) -> None:
    """trajectory: iterable of (ts, Twc [4, 4])."""
    with open(path, "w") as f:
        for ts, T in trajectory:
            q = _quat_xyzw(T[:3, :3])
            t = T[:3, 3]
            f.write(
                f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
            )


def save_euroc(path: str, trajectory) -> None:
    """EuRoC format (System::SaveTrajectoryEuRoC, System.cc:646): integer
    nanosecond timestamps, then the TUM pose and quaternion (x, y, z, w)."""
    with open(path, "w") as f:
        for ts, T in trajectory:
            q = _quat_xyzw(T[:3, :3])
            t = T[:3, 3]
            f.write(
                f"{int(round(ts * 1e9))} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n"
            )


def save_kitti(path: str, trajectory) -> None:
    with open(path, "w") as f:
        for _, T in trajectory:
            row = T[:3, :4].reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in row) + "\n")


def load_tum(path: str):
    """(timestamps [N], positions [N, 3], quaternions (x, y, z, w) [N, 4])."""
    data = np.loadtxt(path)
    return data[:, 0], data[:, 1:4], data[:, 4:8]
