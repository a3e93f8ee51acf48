"""Synthetic dataset: a ray-traced textured room with exact ground-truth
poses and depth — port of ``orb_slam3_ros_tpu.utils.synth``: pinhole and
KB8 fisheye rendering (``render(cam_model=)``), the orbit, loop and multi-loop
sequences and the visual-inertial "wander" and "loop" sequences with
their exact IMU samples, each with a rectified right view
(``stereo_baseline``) and depth where asked.

The port carries its own renderer because the machine that runs it on the
GPU has no JAX. Textures and trajectories are the same numpy code as the
JAX package's, and ``render`` runs on the device that holds the scene.
Sequences are not cached on disk.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..models import map_state, map_updates
from ..ops import cameras, orb, stereo


def _value_noise_texture(size: int, seed: int, octaves: int = 5) -> np.ndarray:
    """Multi-octave value noise in [0, 255], strong corner content."""
    rng = np.random.default_rng(seed)
    tex = np.zeros((size, size), np.float32)
    amp = 1.0
    for o in range(octaves):
        n = 2 ** (o + 3)
        coarse = rng.uniform(-1, 1, size=(n, n)).astype(np.float32)
        # bilinear upsample to size
        idx = np.linspace(0, n - 1, size)
        xi = np.clip(idx.astype(int), 0, n - 2)
        fx = idx - xi
        row = coarse[:, xi] * (1 - fx) + coarse[:, np.minimum(xi + 1, n - 1)] * fx
        tex += amp * (
            row[xi, :] * (1 - fx[:, None]) + row[np.minimum(xi + 1, n - 1), :] * fx[:, None]
        )
        amp *= 0.55
    # Add salt-like blobs for distinct FAST corners.
    n_dots = size * size // 256
    ys = rng.integers(2, size - 3, n_dots)
    xs = rng.integers(2, size - 3, n_dots)
    pol = rng.choice([-1.0, 1.0], n_dots)
    for y, x, p in zip(ys, xs, pol):
        tex[y - 1 : y + 2, x - 1 : x + 2] += 2.5 * p
    tex = tex - tex.min()
    tex = tex / tex.max() * 235.0 + 10.0
    return tex.astype(np.float32)


class RoomScene(NamedTuple):
    half: torch.Tensor  # [3] box half-extents
    textures: torch.Tensor  # [6, S, S] one per face (+x,-x,+y,-y,+z,-z)


def make_room(seed: int = 0, device=None) -> RoomScene:
    """The JAX package's default room: 8 x 6 x 5 m, 1024^2 textures, on
    ``device`` (None: the CUDA device)."""
    device = resolve_device(device)
    texs = np.stack([_value_noise_texture(1024, seed * 7 + i) for i in range(6)])
    return RoomScene(
        half=torch.tensor((4.0, 3.0, 2.5), dtype=torch.float32, device=device),
        textures=torch.from_numpy(texs).to(device),
    )


def _ray_box_hits(origin, dirs, half):
    """For rays inside the box, the exit distance per face and face uv:
    t_face [..., 6] (inf where the ray exits through another face) and
    uv in [0, 1]^2 per face [..., 6, 2]."""
    inf = torch.tensor(float("inf"), dtype=dirs.dtype, device=dirs.device)
    ts, uvs = [], []
    for k in range(6):
        ax = k // 2
        sgn = 1.0 if k % 2 == 0 else -1.0
        denom = dirs[..., ax]
        t = (sgn * half[ax] - origin[..., ax]) / torch.where(
            torch.abs(denom) < 1e-9, torch.full_like(denom, 1e-9), denom
        )
        t = torch.where((t > 1e-4) & (torch.sign(denom) == sgn), t, inf)
        p = origin + t[..., None] * dirs
        a1, a2 = [a for a in range(3) if a != ax]
        u = (p[..., a1] / half[a1] + 1.0) * 0.5
        v = (p[..., a2] / half[a2] + 1.0) * 0.5
        inside = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
        ts.append(torch.where(inside, t, inf))
        uvs.append(torch.stack([u, v], dim=-1))
    return torch.stack(ts, dim=-1), torch.stack(uvs, dim=-2)


def _sample_tex(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    s = tex.shape[0]
    x = torch.clamp(uv[..., 0], 0.0, 1.0) * (s - 1)
    y = torch.clamp(uv[..., 1], 0.0, 1.0) * (s - 1)
    x0 = torch.clamp(x.to(torch.int64), 0, s - 2)
    y0 = torch.clamp(y.to(torch.int64), 0, s - 2)
    fx = x - x0
    fy = y - y0
    return (
        tex[y0, x0] * (1 - fx) * (1 - fy)
        + tex[y0, x0 + 1] * fx * (1 - fy)
        + tex[y0 + 1, x0] * (1 - fx) * fy
        + tex[y0 + 1, x0 + 1] * fx * fy
    )


def render(scene: RoomScene, R_wc, t_wc, cam_params, height: int = 480, width: int = 752,
           cam_model: str = "pinhole"):
    """Grayscale view [H, W] float32 in [0, 255] and camera z-depth [H, W]
    for the camera-to-world pose (R_wc, t_wc), on the scene's device.
    ``cam_model="kb8"`` renders raw fisheye imagery: one ray per pixel from
    the KB8 unprojection (past theta = pi/2 the ray points backwards and the
    corner shows the scene mirrored, as in the JAX package); the depth is
    then the ray parameter of its z = 1 direction."""
    dev = scene.textures.device
    R_wc = torch.as_tensor(R_wc, dtype=torch.float32, device=dev)
    t_wc = torch.as_tensor(t_wc, dtype=torch.float32, device=dev)
    cam = torch.as_tensor(cam_params, dtype=torch.float32, device=dev)
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    if cam_model == "kb8":
        dirs_c = cameras.kb8_unproject(cam, torch.stack([xg, yg], dim=-1))
    else:
        fx, fy, cx, cy = cam[0], cam[1], cam[2], cam[3]
        dirs_c = torch.stack([(xg - cx) / fx, (yg - cy) / fy, torch.ones_like(xg)], dim=-1)
    dirs_w = torch.einsum("ij,hwj->hwi", R_wc, dirs_c)
    origin = t_wc.expand(dirs_w.shape)
    ts, uvs = _ray_box_hits(origin, dirs_w, scene.half)
    face = torch.argmin(ts, dim=-1)  # [H, W]
    t_hit = torch.min(ts, dim=-1).values
    uv = torch.gather(uvs, -2, face[..., None, None].expand(height, width, 1, 2))[..., 0, :]
    vals = torch.stack([_sample_tex(scene.textures[k], uv) for k in range(6)], dim=-1)
    img = torch.gather(vals, -1, face[..., None])[..., 0]
    # The hit point in the camera frame is t_hit * dirs_c with dirs_c.z = 1,
    # so t_hit is the camera z-depth.
    return img, t_hit


def orbit_trajectory(n_frames: int, dt: float = 0.05):
    """Smooth camera trajectory inside the room: slow orbit + bobbing,
    looking at a target wandering on the +x wall. Returns numpy
    (R_wc [N,3,3], t_wc [N,3], timestamps [N])."""
    t = np.arange(n_frames) * dt
    px = 1.8 * np.sin(0.25 * t)
    py = 1.2 * np.sin(0.17 * t + 0.8)
    pz = 0.4 * np.sin(0.33 * t)
    pos = np.stack([px, py, pz], axis=-1).astype(np.float64)
    look = np.stack(
        [np.full_like(t, 4.0), 1.5 * np.sin(0.11 * t), 0.8 * np.cos(0.13 * t)],
        axis=-1,
    )
    Rs = []
    for i in range(n_frames):
        z = look[i] - pos[i]
        z = z / np.linalg.norm(z)
        up = np.array([0.0, 0.0, 1.0])
        x = np.cross(z, up)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        Rs.append(np.stack([x, y, z], axis=-1))  # columns = camera axes in world
    return np.asarray(Rs, np.float32), pos.astype(np.float32), t


def loop_trajectory(n_frames: int, dt: float = 0.1, radius: float = 1.2):
    """Closed circular trajectory: the camera orbits the room center
    looking outward and returns to its start (the loop-closure case),
    one revolution over ``n_frames - 6`` frames."""
    t = np.arange(n_frames) * dt
    th = 2 * np.pi * np.arange(n_frames) / (n_frames - 6)  # revisit at the end
    pos = np.stack([radius * np.cos(th), radius * np.sin(th), 0.15 * np.sin(2 * th)], axis=-1)
    return _outward_rotations(th), pos.astype(np.float32), t


def multiloop_trajectory(n_frames: int, dt: float = 0.1, radius: float = 1.2, revs: int = 3):
    """``revs`` orbits of the room looking outward, with a slow vertical and
    radial modulation so that the revisits are close but not identical (a
    loop closure can fire once a revolution)."""
    t = np.arange(n_frames) * dt
    th = 2 * np.pi * revs * np.arange(n_frames) / (n_frames - 6)
    r = radius * (1.0 + 0.04 * np.sin(0.07 * t))
    pz = 0.12 * np.sin(2 * th) + 0.05 * np.sin(0.11 * t)
    pos = np.stack([r * np.cos(th), r * np.sin(th), pz], axis=-1)
    return _outward_rotations(th), pos.astype(np.float32), t


def _outward_rotations(th: np.ndarray) -> np.ndarray:
    """[N, 3, 3] camera-to-world rotations looking outward along heading
    ``th`` with the world z axis up."""
    Rs = []
    for a in th:
        z = np.array([np.cos(a), np.sin(a), 0.0])
        x = np.cross(z, np.array([0.0, 0.0, 1.0]))
        x /= np.linalg.norm(x)
        Rs.append(np.stack([x, np.cross(z, x), z], axis=-1))
    return np.asarray(Rs, np.float32)


class SynthSequence(NamedTuple):
    images: torch.Tensor  # [N, H, W] float32, on the rendering device
    R_wc: np.ndarray  # [N, 3, 3]
    t_wc: np.ndarray  # [N, 3]
    timestamps: np.ndarray  # [N]
    cam_params: np.ndarray  # [9] pinhole
    depths: torch.Tensor | None  # [N, H, W] float32 camera z-depth
    images_right: torch.Tensor | None = None  # [N, H, W] float32 rectified right view
    baseline: float = 0.0


def _right_origin(R_wc: np.ndarray, t_wc: np.ndarray, baseline: float) -> np.ndarray:
    """The rectified right camera's centre: ``baseline`` metres along the
    left camera's own x axis."""
    return (t_wc + R_wc @ np.asarray([baseline, 0.0, 0.0], np.float32)).astype(np.float32)


def make_sequence(
    n_frames: int = 30,
    height: int = 240,
    width: int = 376,
    dt: float = 0.1,
    seed: int = 0,
    with_depth: bool = False,
    trajectory: str = "orbit",
    stereo_baseline: float = 0.0,
    device=None,
) -> SynthSequence:
    """Render a sequence on ``device`` (None: the CUDA device) along
    ``trajectory``: "orbit", "loop" (one closed revolution) or
    "multiloop" / "multiloopN" (3 or N revolutions). ``stereo_baseline``
    > 0 also renders a rectified right view, from the camera moved by
    +baseline along its own x axis."""
    scene = make_room(seed=seed, device=device)
    f = 0.55 * width
    cam = np.asarray([f, f, (width - 1) / 2.0, (height - 1) / 2.0, 0, 0, 0, 0, 0], np.float32)
    if trajectory == "loop":
        R_wc, t_wc, ts = loop_trajectory(n_frames, dt=dt)
    elif trajectory.startswith("multiloop"):
        revs = int(trajectory[len("multiloop"):] or 3)
        R_wc, t_wc, ts = multiloop_trajectory(n_frames, dt=dt, revs=revs)
    else:
        R_wc, t_wc, ts = orbit_trajectory(n_frames, dt=dt)
    imgs, deps, imgs_r = [], [], []
    for i in range(n_frames):
        img, dep = render(scene, R_wc[i], t_wc[i], cam, height=height, width=width)
        imgs.append(img)
        if with_depth:
            deps.append(dep)
        if stereo_baseline > 0:
            t_r = _right_origin(R_wc[i], t_wc[i], stereo_baseline)
            imgs_r.append(render(scene, R_wc[i], t_r, cam, height=height, width=width)[0])
    return SynthSequence(
        images=torch.stack(imgs),
        R_wc=R_wc,
        t_wc=t_wc,
        timestamps=ts,
        cam_params=cam,
        depths=torch.stack(deps) if with_depth else None,
        images_right=torch.stack(imgs_r) if stereo_baseline > 0 else None,
        baseline=stereo_baseline,
    )


# ---------------------------------------------------------------------------
# Visual-inertial sequence: an analytic trajectory whose exact derivatives
# give the IMU measurements (gyro = vee(R^T dR/dt), specific force =
# R^T (a - g)), not finite differences.
# ---------------------------------------------------------------------------


def _vi_pose_fn(t: torch.Tensor):
    """Smooth body pose (R_wb(t) [3,3], p_wb(t) [3]) inside the room,
    looking mostly at the +x wall — the JAX package's "wander" trajectory.
    Deliberately dynamic (peak acceleration ~5 m/s^2): IMU scale and
    gravity observability need excitation."""
    px = 1.0 * torch.sin(0.45 * t) + 0.12 * torch.sin(2.6 * t)
    py = 0.7 * torch.sin(0.31 * t + 0.7) + 0.10 * torch.sin(3.1 * t + 0.4)
    pz = 0.3 * torch.sin(0.53 * t) + 0.08 * torch.sin(2.2 * t + 1.1)
    p = torch.stack([px, py, pz])
    look = torch.stack([4.0 + 0.0 * t, 1.4 * torch.sin(0.23 * t), 0.9 * torch.cos(0.19 * t)])
    z = look - p
    z = z / torch.linalg.vector_norm(z)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=t.dtype)
    x = torch.linalg.cross(z, up)
    x = x / torch.linalg.vector_norm(x)
    y = torch.linalg.cross(z, x)
    return torch.stack([x, y, z], dim=-1), p


_VI_LOOP_T = 12.0  # seconds a revolution of the VI "loop" trajectory


def _vi_pose_loop_fn(t: torch.Tensor):
    """Smooth looping body pose: a circular sweep inside the room looking
    outward, back at the start view after ``_VI_LOOP_T`` seconds (the
    visual-inertial loop-closure sequence), with high-frequency excitation
    for gravity and scale observability — the JAX package's "loop"."""
    th = 2.0 * math.pi * t / _VI_LOOP_T
    p = torch.stack([
        torch.cos(th) + 0.10 * torch.sin(2.6 * t),
        torch.sin(th) + 0.09 * torch.sin(3.1 * t + 0.4),
        0.22 * torch.sin(0.9 * t) + 0.07 * torch.sin(2.2 * t + 1.1),
    ])
    look = torch.stack([3.5 * torch.cos(th), 3.5 * torch.sin(th), 0.5 * torch.sin(0.23 * t)])
    z = look - p
    z = z / torch.linalg.vector_norm(z)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=t.dtype)
    x = torch.linalg.cross(z, up)
    x = x / torch.linalg.vector_norm(x)
    y = torch.linalg.cross(z, x)
    return torch.stack([x, y, z], dim=-1), p


def make_vi_sequence(
    n_frames: int = 40,
    height: int = 240,
    width: int = 376,
    frame_dt: float = 0.1,
    imu_per_frame: int = 10,
    seed: int = 0,
    gravity=None,
    bg=None,
    ba=None,
    noise_g: float = 0.0,
    noise_a: float = 0.0,
    stereo_baseline: float = 0.0,
    with_depth: bool = False,
    trajectory: str = "wander",
    device=None,
):
    """Render frames on ``device`` (None: the CUDA device) and make the
    exact IMU samples of the analytic ``trajectory`` ("wander" or "loop").
    ``stereo_baseline`` > 0 also renders the rectified right view (the
    camera moved by +baseline along its own x axis), ``with_depth`` the
    left view's depth.

    Returns (SynthSequence, imu dict of numpy arrays) where imu has the
    per-frame sample blocks ``acc [N, M, 3], gyro [N, M, 3], dts [N, M]``
    covering the interval ending at each frame (block i integrates frame
    i-1 -> i; block 0 is zeros), the true velocities ``vel [N, 3]`` and
    ``gravity``, ``bg``, ``ba``. Angular velocity, velocity and acceleration
    are forward-mode derivatives of the pose function in float64 on the
    host; the noise stream (``default_rng(seed + 100)``, gyro then
    accelerometer per sample) is the JAX package's."""
    pose_fn = {"wander": _vi_pose_fn, "loop": _vi_pose_loop_fn}[trajectory]
    from torch.func import jacfwd, vmap

    g = np.array([0.0, 0.0, -9.81]) if gravity is None else np.asarray(gravity)
    bg = np.zeros(3) if bg is None else np.asarray(bg)
    ba = np.zeros(3) if ba is None else np.asarray(ba)
    rng = np.random.default_rng(seed + 100)
    f64 = torch.float64

    ts = np.arange(n_frames) * frame_dt
    pos = lambda t: pose_fn(t)[1]
    R_all, p_all = vmap(pose_fn)(torch.as_tensor(ts, dtype=f64))
    vel = vmap(jacfwd(pos))(torch.as_tensor(ts, dtype=f64)).numpy().astype(np.float32)
    R_wc = R_all.numpy().astype(np.float32)
    t_wc = p_all.numpy().astype(np.float32)

    scene = make_room(seed=seed, device=device)
    fl = 0.55 * width
    cam = np.asarray([fl, fl, (width - 1) / 2.0, (height - 1) / 2.0, 0, 0, 0, 0, 0], np.float32)
    imgs, deps, imgs_r = [], [], []
    for i in range(n_frames):
        img, dep = render(scene, R_wc[i], t_wc[i], cam, height=height, width=width)
        imgs.append(img)
        if with_depth:
            deps.append(dep)
        if stereo_baseline > 0:
            t_r = _right_origin(R_wc[i], t_wc[i], stereo_baseline)
            imgs_r.append(render(scene, R_wc[i], t_r, cam, height=height, width=width)[0])

    dt_imu = frame_dt / imu_per_frame
    acc = np.zeros((n_frames, imu_per_frame, 3), np.float32)
    gyro = np.zeros((n_frames, imu_per_frame, 3), np.float32)
    dts = np.zeros((n_frames, imu_per_frame), np.float32)
    if n_frames > 1:
        # sample k of frame i is taken at ts[i-1] + k * dt_imu
        tk = torch.as_tensor(
            ts[:-1, None] + np.arange(imu_per_frame)[None, :] * dt_imu, dtype=f64
        ).reshape(-1)
        R_k = vmap(lambda t: pose_fn(t)[0])(tk).numpy()
        dR_k = vmap(jacfwd(lambda t: pose_fn(t)[0]))(tk).numpy()
        a_k = vmap(jacfwd(jacfwd(pos)))(tk).numpy()
        w_hat = np.einsum("nji,njk->nik", R_k, dR_k)
        omega = np.stack([w_hat[:, 2, 1], w_hat[:, 0, 2], w_hat[:, 1, 0]], axis=-1)
        f_b = np.einsum("nji,nj->ni", R_k, a_k - g)
        noise = rng.normal(size=(tk.shape[0], 2, 3))  # per sample: gyro draw, then accel draw
        gyro[1:] = (omega + bg + noise[:, 0] * noise_g).reshape(n_frames - 1, imu_per_frame, 3)
        acc[1:] = (f_b + ba + noise[:, 1] * noise_a).reshape(n_frames - 1, imu_per_frame, 3)
        dts[1:] = dt_imu
    seq = SynthSequence(
        images=torch.stack(imgs), R_wc=R_wc, t_wc=t_wc, timestamps=ts, cam_params=cam,
        depths=torch.stack(deps) if with_depth else None,
        images_right=torch.stack(imgs_r) if stereo_baseline > 0 else None,
        baseline=stereo_baseline,
    )
    return seq, dict(acc=acc, gyro=gyro, dts=dts, vel=vel, gravity=g, bg=bg, ba=ba)


MAX_DEPTH = 8.0  # RgbdSlam's default depth cut-off (m)


def seed_map_from_depth(seq: SynthSequence, kf_every: int, slam):
    """Test and smoke fixture, not a SLAM feature: a map seeded from
    rendered depth at ground-truth keyframe poses, for localization-mode
    tracking against it.

    Every ``kf_every``-th frame becomes a keyframe through the JAX package's
    RGB-D point-creation calls, in their order: ``orb.extract``, depth
    sampled at the features (``RgbdSlam._depth_to_match``: valid if
    > 0.05 m, a candidate if also < MAX_DEPTH), ``insert_keyframe`` with
    no bound points, ``stereo.backproject``, ``admit_depth_points`` until
    the point capacity is full; then one ``refresh_point_stats``. Uses the
    capacities, extractor config, camera and device of ``slam`` (a
    ``MonoSlam``). Returns (map, n_kf, n_pts)."""
    dev = slam.device
    m = map_state.empty_map(slam.K_cap, slam.N, slam.P_cap, device=dev)
    n_kf = n_pts = 0
    h, w = seq.images.shape[1:]
    for i in range(0, seq.images.shape[0], kf_every):
        if n_kf >= slam.K_cap:
            break
        feats = orb.extract(seq.images[i].to(dev), slam.config)
        dm = seq.depths[i].to(dev)
        xi = torch.clamp(feats.xy[:, 0].to(torch.int64), 0, w - 1)
        yi = torch.clamp(feats.xy[:, 1].to(torch.int64), 0, h - 1)
        d = dm[yi, xi]
        cand = feats.valid & (d > 0.05) & (d < MAX_DEPTH)
        R_cw = seq.R_wc[i].T
        t_cw = -R_cw @ seq.t_wc[i]
        R_t = torch.as_tensor(R_cw, device=dev)
        t_t = torch.as_tensor(t_cw, device=dev)
        m = map_updates.insert_keyframe(
            m, n_kf, R_t, t_t, float(seq.timestamps[i]), feats,
            torch.full((slam.N,), -1, dtype=torch.int32, device=dev),
        )
        X_c = stereo.backproject(slam.cam_params, feats.xy, d)
        X_w = (X_c - t_t) @ R_t
        m, n_new = map_updates.admit_depth_points(m, n_kf, X_w, cand, n_pts, slam.P_cap - n_pts)
        n_pts += int(n_new)
        n_kf += 1
    m = map_updates.refresh_point_stats(m, n_levels=slam.config.n_levels)
    return m, n_kf, n_pts


def make_search_case(
    seed: int, P: int, N: int, W: int = 752, H: int = 480, tie_columns: tuple = ()
) -> dict:
    """Test and smoke fixture: inputs of ``matching.search_by_projection``
    for P landmarks and N features in a W x H image, as numpy arrays made
    from ``seed``, with planted ties: duplicated feature descriptors next
    to their originals (best-distance ties), duplicated landmark rows
    (column-argmin ties), all-zero invalid rows. The radius is left to the
    caller.

    ``tie_columns``: for each column b in it (0 < b < N), features b - 1
    and b become valid copies of one descriptor a pixel apart, and two
    landmark rows with one descriptor are aimed at them from under a pixel
    away: a best-distance tie across the boundary at b of a search that
    splits its columns there, and a column-argmin tie between the rows."""
    rng = np.random.default_rng(seed)
    feat_xy = rng.uniform([0, 0], [W, H], (N, 2)).astype(np.float32)
    feat_level = rng.integers(0, 8, N).astype(np.int32)
    feat_valid = rng.random(N) < 0.9
    bits = rng.random((N, 256)) < 0.5
    dup = rng.choice(N, N // 10, replace=False)
    tgt = rng.permutation(np.setdiff1d(np.arange(N), dup))[: len(dup)]
    bits[tgt] = bits[dup]
    feat_level[tgt] = feat_level[dup]
    feat_valid[tgt] = feat_valid[dup]
    feat_xy[tgt] = feat_xy[dup] + rng.uniform(-2, 2, (len(dup), 2)).astype(np.float32)
    sign = (1 - 2 * bits).astype(np.int8)
    feat_sign = np.where(feat_valid[:, None], sign, 0).astype(np.int8)

    src = rng.integers(0, N, P)
    flip = rng.random((P, 256)) < 0.08
    proj_sign = np.where(flip, -sign[src], sign[src]).astype(np.int8)
    proj_uv = (feat_xy[src] + rng.normal(0, 4, (P, 2))).astype(np.float32)
    proj_level = np.clip(feat_level[src] + rng.integers(-1, 2, P), 0, 7).astype(np.int32)
    proj_valid = rng.random(P) < 0.9
    rows = rng.choice(P, P // 10, replace=False)
    to = rng.permutation(np.setdiff1d(np.arange(P), rows))[: len(rows)]
    for a in (proj_sign, proj_uv, proj_level, proj_valid):
        a[to] = a[rows]
    proj_sign[~proj_valid] = 0
    for j, b in enumerate(c for c in tie_columns if 0 < c < N):
        feat_valid[b - 1 : b + 1] = True
        feat_sign[b - 1 : b + 1] = sign[b - 1]
        feat_level[b] = feat_level[b - 1]
        feat_xy[b] = feat_xy[b - 1] + np.float32([1.0, 0.5])
        rows = [(2 * j) % P, (2 * j + 1) % P]
        proj_sign[rows] = sign[b - 1]
        proj_sign[rows, :5] *= -1  # distance 5 to both copies
        proj_uv[rows] = feat_xy[b - 1] + np.float32(0.5)
        proj_level[rows] = feat_level[b - 1]
        proj_valid[rows] = True
    return dict(
        proj_uv=proj_uv, proj_valid=proj_valid, proj_level=proj_level,
        proj_sign=proj_sign, feat_xy=feat_xy, feat_level=feat_level,
        feat_valid=feat_valid, feat_sign=feat_sign,
    )
