"""Headless visualization: map and trajectory renders to PNG — port of
``orb_slam3_ros_tpu.utils.viz``.

Role of the reference's Pangolin viewer stack (``Viewer`` / ``FrameDrawer``
/ ``MapDrawer``, orb_slam3/src/Viewer.cc:162, MapDrawer.cc), drawn on
demand with matplotlib: map points, keyframe centres, the frame
trajectory, and the tracking overlay (keypoints on the current image).
Matplotlib is imported inside the functions, so importing this module (and
the package) does not need it; a machine without it cannot draw.
"""

from __future__ import annotations

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def draw_map(slam, path: str, gt_positions=None) -> str:
    """Top-down (x-y) render of the map's points, keyframe centres and the
    trajectory (and ``gt_positions`` [N, 3] if given) into ``path``."""
    plt = _pyplot()
    m = slam.map
    ptv = m.pt_valid.cpu().numpy()
    X = m.pt_X.cpu().numpy()[ptv]
    kfv = m.kf_valid.cpu().numpy()
    kf_R = m.kf_R.cpu().numpy()[kfv]
    kf_t = m.kf_t.cpu().numpy()[kfv]
    centers = -np.einsum("kij,ki->kj", kf_R, kf_t)  # camera centres R^T t

    fig, ax = plt.subplots(figsize=(8, 8))
    if len(X):
        ax.scatter(X[:, 0], X[:, 1], s=1, c="#888888", label="map points")
    if len(centers):
        ax.plot(centers[:, 0], centers[:, 1], "b.-", ms=4, label="keyframes")
    traj = slam.get_trajectory()
    if traj:
        p = np.stack([T[:3, 3] for _, T in traj])
        ax.plot(p[:, 0], p[:, 1], "g-", lw=0.8, label="trajectory")
    if gt_positions is not None:
        ax.plot(gt_positions[:, 0], gt_positions[:, 1], "r--", lw=0.8, label="ground truth")
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=8)
    ax.set_title(f"map: {slam.n_kf} KFs, {slam.n_pts} points")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def draw_tracking(img, feats, feat_pt, path: str) -> str:
    """Tracking overlay (the FrameDrawer role): green, features bound to a
    landmark (``feat_pt`` >= 0); blue, the others."""
    plt = _pyplot()
    xy = feats.xy.cpu().numpy()
    valid = feats.valid.cpu().numpy()
    fp = feat_pt.cpu().numpy() if feat_pt is not None else None
    if hasattr(img, "cpu"):
        img = img.cpu().numpy()

    fig, ax = plt.subplots(figsize=(8, 5))
    ax.imshow(np.asarray(img), cmap="gray", vmin=0, vmax=255)
    tracked = valid & (fp >= 0) if fp is not None else np.zeros_like(valid)
    other = valid & ~tracked
    ax.plot(xy[other, 0], xy[other, 1], "b.", ms=2)
    ax.plot(xy[tracked, 0], xy[tracked, 1], "g+", ms=5)
    ax.set_title(f"{int(tracked.sum())} tracked / {int(valid.sum())} features")
    ax.axis("off")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path
