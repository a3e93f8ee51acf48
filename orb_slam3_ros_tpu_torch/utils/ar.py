"""Headless AR overlay: a virtual cube anchored on a detected map plane and
drawn into tracked frames — port of ``orb_slam3_ros_tpu.utils.ar``.

Role of the reference's AR demo (src/AR/ros_mono_ar.cc + ViewerAR.cc:
detect a plane on the tracked map points, render virtual cubes on it with
the live camera pose). No OpenGL here: the cube's 12 edges are projected
with the pinhole model and rasterized into the grayscale frame on the host.
The plane is found on the map's device (``ops/plane.py``), with one host
read of its result.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.chunk_runner import read_host
from ..ops import cameras, plane


def cube_vertices(anchor: np.ndarray, normal: np.ndarray, size: float) -> np.ndarray:
    """The 8 world vertices [8, 3] of a cube of side ``size`` standing on the
    plane (one face on it, centred at the anchor)."""
    n = np.asarray(normal, np.float64)
    n = n / max(np.linalg.norm(n), 1e-12)
    # an in-plane orthonormal basis
    a = np.array([1.0, 0.0, 0.0])
    if abs(n @ a) > 0.9:
        a = np.array([0.0, 1.0, 0.0])
    u = np.cross(n, a)
    u /= max(np.linalg.norm(u), 1e-12)
    v = np.cross(n, u)
    h = size / 2.0
    c = np.asarray(anchor, np.float64)
    verts = []
    for dz in (0.0, size):
        for du, dv in ((-h, -h), (h, -h), (h, h), (-h, h)):
            verts.append(c + du * u + dv * v + dz * n)
    return np.asarray(verts, np.float32)


CUBE_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def _draw_line(img: np.ndarray, p0, p1, value: float) -> None:
    """Rasterize a segment into ``img`` in place (DDA)."""
    h, w = img.shape
    x0, y0 = float(p0[0]), float(p0[1])
    x1, y1 = float(p1[0]), float(p1[1])
    steps = int(max(abs(x1 - x0), abs(y1 - y0), 1))
    ts = np.linspace(0.0, 1.0, steps + 1)
    xs = np.round(x0 + ts * (x1 - x0)).astype(int)
    ys = np.round(y0 + ts * (y1 - y0)).astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = value


def draw_cube(img, verts_w: np.ndarray, R_cw: np.ndarray, t_cw: np.ndarray, cam_params,
              value: float = 255.0) -> np.ndarray:
    """Project the cube into the camera and draw its edges; an edge with an
    end behind the camera is skipped. Returns a drawn float32 copy of
    ``img`` (numpy, or a tensor read to the host)."""
    if isinstance(img, torch.Tensor):
        img = img.cpu().numpy()
    out = np.asarray(img, np.float32).copy()
    Xc = verts_w @ np.asarray(R_cw).T + np.asarray(t_cw)
    cam = torch.as_tensor(cam_params, dtype=torch.float32).cpu()
    uv = cameras.pinhole_project_nodist(cam, torch.from_numpy(np.asarray(Xc, np.float32))).numpy()
    infront = Xc[:, 2] > 0.05
    for i, j in CUBE_EDGES:
        if infront[i] and infront[j]:
            _draw_line(out, uv[i], uv[j], value)
    return out


class ARDemo:
    """An AR session attached to a system: find a plane on its map once,
    then draw a cube on it in every later frame (the reference's ViewerAR
    thread). The hypotheses are drawn by a ``torch.Generator`` seeded with
    3 on the system's device; the cube's edge is a tenth of the inlier
    cloud's extent."""

    def __init__(self, slam):
        self.slam = slam
        self.generator = torch.Generator(device=slam.device)
        self.generator.manual_seed(3)
        self.verts = None
        self.plane = None

    def try_detect_plane(self) -> bool:
        m = self.slam.map
        res = plane.detect_plane(m.pt_X, m.pt_valid, self.generator)
        ok, normal, d, anchor, inlier = read_host(res.ok, res.normal, res.d, res.anchor,
                                                  res.inlier)
        if not ok > 0.5:
            return False
        pts = m.pt_X[torch.as_tensor(inlier > 0.5, device=m.pt_X.device)].cpu().numpy()
        size = 0.1 * float(np.median(np.linalg.norm(pts - pts.mean(0), axis=-1)) * 2.0)
        # anchor on the camera-facing side of the plane
        n = normal
        C_w = -np.asarray(self.slam.R_cur).T @ np.asarray(self.slam.t_cur)
        if (C_w @ n + float(d)) < 0:
            n = -n
        self.plane = (n, float(d), anchor)
        self.verts = cube_vertices(anchor, n, size)
        return True

    def render(self, img) -> np.ndarray:
        """The frame with the cube drawn at the tracker's current pose; the
        frame unchanged (float32) while no plane has been found."""
        if self.verts is None and not self.try_detect_plane():
            return np.asarray(img.cpu() if isinstance(img, torch.Tensor) else img, np.float32)
        return draw_cube(img, self.verts, self.slam.R_cur, self.slam.t_cur, self.slam.cam_params)
