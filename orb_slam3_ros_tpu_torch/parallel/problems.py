"""Generators of the scale-out solvers' test and benchmark problems, as
numpy trees (dicts of arrays keyed by field name, nested for
``states`` / ``ie_preint``), and their conversion to the solvers' tensors.

* ``ba_problem``: the JAX package's realistic global-BA problem
  (``__graft_entry__._ba_problem``; K=64, P=8192, E=65536 is the
  pipeline's global-BA shape), the same draws from the same seed;
* ``vi_problem``: the visual-inertial window of the JAX package's
  distributed-BA tests (``tests/vi_sim.py::simulate_vi`` and
  ``tests/test_viba.py::build_vi_problem``);
* ``pgo_problem``: their noisy ring pose graph with random covisibility
  edges.

Rotations come from the port's ``lie`` (float32, the JAX formulas) on the
CPU. ``save`` / ``load`` carry such trees through one ``.npz`` file.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ba, imu, lie, pgo, viba

CAM_GBA = np.asarray([200.0, 200.0, 96.0, 64.0, 0, 0, 0, 0, 0], np.float32)
CAM_VI = np.asarray([400.0, 400.0, 320.0, 240.0, 0, 0, 0, 0, 0], np.float32)


def _so3_exp(phi) -> np.ndarray:
    return lie.so3_exp(torch.from_numpy(np.asarray(phi, np.float32))).numpy()


def _project(cam: np.ndarray, Xc: np.ndarray) -> np.ndarray:
    """Distortion-free pinhole projection in float32 (the JAX package's
    ``pinhole_project_nodist``)."""
    z = Xc[..., 2]
    inv_z = np.float32(1.0) / np.where(np.abs(z) < 1e-9, np.float32(1e-9), z)
    return np.stack([cam[0] * Xc[..., 0] * inv_z + cam[2],
                     cam[1] * Xc[..., 1] * inv_z + cam[3]], axis=-1).astype(np.float32)


def ba_problem(K: int = 64, P: int = 8192, E: int = 65536, seed: int = 0) -> dict:
    """K cameras 0.2 m apart along x with 0.05 rad of random rotation, P
    points in a box 4-8 m ahead, E random (camera, point) edges with 0.5 px
    of pixel noise, the first two cameras fixed, the points 2 cm off."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-2, -1.5, 4], [2, 1.5, 8], size=(P, 3)).astype(np.float32)
    Rs, ts = [], []
    for k in range(K):
        phi = rng.normal(size=3).astype(np.float32) * 0.05
        Rs.append(_so3_exp(phi))
        ts.append(np.asarray([0.2 * k, 0, 0], np.float32))
    Rs, ts = np.stack(Rs), np.stack(ts)
    cam_idx = rng.integers(0, K, E).astype(np.int32)
    pt_idx = rng.integers(0, P, E).astype(np.int32)
    Xc = np.einsum("eij,ej->ei", Rs[cam_idx], X[pt_idx]) + ts[cam_idx]
    uv = _project(CAM_GBA, Xc.astype(np.float32))
    uv += rng.normal(size=uv.shape).astype(np.float32) * 0.5
    return dict(
        R=Rs, t=ts, cam_fixed=np.arange(K) < 2, cam_valid=np.ones((K,), bool),
        X=X + rng.normal(size=X.shape).astype(np.float32) * 0.02,
        pt_valid=np.ones((P,), bool), cam_idx=cam_idx, pt_idx=pt_idx, uv=uv,
        inv_sigma2=np.ones((E,), np.float32), edge_valid=np.ones((E,), bool),
        cam_params=CAM_GBA.copy(), ur=np.full((E,), -1.0, np.float32),
        bf=np.zeros((), np.float32),
    )


def vi_calib(freq: float = 200.0) -> dict:
    """The IMU noise of the JAX tests' ``make_calib`` (camera = body)."""
    return dict(
        sigma_g=np.full((3,), 1.7e-4 * np.sqrt(freq), np.float32),
        sigma_a=np.full((3,), 2e-3 * np.sqrt(freq), np.float32),
        sigma_gw=np.full((3,), 1.9e-5 / np.sqrt(freq), np.float32),
        sigma_aw=np.full((3,), 3e-3 / np.sqrt(freq), np.float32),
        R_bc=np.eye(3, dtype=np.float32), t_bc=np.zeros(3, np.float32),
    )


def _simulate_vi(rng, n_kf: int, samples_per_kf: int = 20, dt: float = 0.005) -> dict:
    """A smooth body trajectory sampled at ``dt`` with its IMU readings,
    cut into ``n_kf`` keyframe windows (``vi_sim.simulate_vi``, no bias or
    noise)."""
    g = np.array([0.0, 0.0, -imu.GRAVITY])
    n_steps = n_kf * samples_per_kf
    omega_base = rng.normal(size=3) * 0.3
    R, v, p = np.eye(3), rng.normal(size=3) * 0.4, np.zeros(3)
    Rs, ps, vs = [R.copy()], [p.copy()], [v.copy()]
    accs, gyros = [], []
    sub = 16
    h = dt / sub
    for i in range(n_steps):
        t = i * dt
        a_w = np.array([1.2 * np.sin(2.2 * t), -0.9 * np.cos(1.7 * t), 0.5 * np.sin(1.3 * t + 0.4)])
        omega = omega_base + 0.2 * np.array([np.sin(0.9 * t), np.cos(1.1 * t), np.sin(0.6 * t)])
        # the reference simulator draws its (here zero) measurement noise
        accs.append(R.T @ (a_w - g) + rng.normal(size=3) * 0.0)
        gyros.append(omega + rng.normal(size=3) * 0.0)
        dR = _so3_exp(omega * h)
        for _ in range(sub):
            p = p + v * h + 0.5 * a_w * h * h
            v = v + a_w * h
            R = R @ dR
        Rs.append(R.copy())
        ps.append(p.copy())
        vs.append(v.copy())
    kf = np.arange(0, n_steps + 1, samples_per_kf)
    return dict(
        R_wb=np.asarray(Rs, np.float32)[kf], p_wb=np.asarray(ps, np.float32)[kf],
        v_w=np.asarray(vs, np.float32)[kf],
        acc=np.asarray(accs, np.float32).reshape(n_kf, samples_per_kf, 3),
        gyro=np.asarray(gyros, np.float32).reshape(n_kf, samples_per_kf, 3),
        dts=np.full((n_kf, samples_per_kf), dt, np.float32),
    )


def vi_problem(n_kf: int = 24, n_pts: int = 512, seed: int = 0, perturb: float = 0.02,
               vel_perturb: float = 0.05, bias_perturb: float = 1e-3, pt_noise: float = 0.02,
               px_noise: float = 0.3) -> dict:
    """The distributed VI-BA tests' window: ``n_kf`` + 1 keyframes every 0.1 s
    of a simulated IMU trajectory, each seeing ``n_pts`` points (edges behind
    0.3 m invalid), the first keyframe fixed, poses, velocities, biases and
    points perturbed."""
    rng = np.random.default_rng(seed)
    sim = _simulate_vi(rng, n_kf)
    calib = imu.calib_from_numpy(vi_calib(), "cpu")
    pre = imu.preintegrate(torch.from_numpy(sim["acc"]), torch.from_numpy(sim["gyro"]),
                           torch.from_numpy(sim["dts"]), torch.zeros(n_kf, 6), calib)
    K = len(sim["R_wb"])
    X = rng.uniform([-4, -4, 1.5], [4, 4, 6], size=(n_pts, 3)).astype(np.float32)
    cam_idx = np.repeat(np.arange(K), n_pts).astype(np.int32)
    pt_idx = np.tile(np.arange(n_pts), K).astype(np.int32)
    Xb = np.einsum("eji,ej->ei", sim["R_wb"][cam_idx], X[pt_idx] - sim["p_wb"][cam_idx])
    uv = _project(CAM_VI, Xb.astype(np.float32))
    uv += rng.normal(size=uv.shape).astype(np.float32) * px_noise
    R0, p0 = sim["R_wb"].copy(), sim["p_wb"].copy()
    v0 = sim["v_w"] + rng.normal(size=(K, 3)).astype(np.float32) * vel_perturb
    for k in range(1, K):
        dxi = rng.normal(size=3).astype(np.float32) * perturb
        R0[k] = R0[k] @ _so3_exp(dxi)
        p0[k] = p0[k] + rng.normal(size=3).astype(np.float32) * perturb
    bg0 = rng.normal(size=(K, 3)).astype(np.float32) * bias_perturb
    ba0 = rng.normal(size=(K, 3)).astype(np.float32) * bias_perturb
    return dict(
        states=dict(R_wb=R0, p_wb=p0, v_w=v0.astype(np.float32), bg=bg0, ba=ba0),
        kf_fixed=np.arange(K) < 1, kf_valid=np.ones(K, bool),
        X=X + rng.normal(size=X.shape).astype(np.float32) * pt_noise,
        pt_valid=np.ones(n_pts, bool), cam_idx=cam_idx, pt_idx=pt_idx, uv=uv,
        inv_sigma2=np.ones(len(cam_idx), np.float32), edge_valid=Xb[:, 2] > 0.3,
        ie_i=np.arange(K - 1, dtype=np.int32), ie_j=np.arange(1, K, dtype=np.int32),
        ie_preint=imu.preintegrated_to_numpy(pre), ie_valid=np.ones(K - 1, bool),
        cam_params=CAM_VI.copy(), R_bc=np.eye(3, dtype=np.float32),
        t_bc=np.zeros(3, np.float32), ur=None, bf=0.0,
    )


def pgo_problem(K: int = 64, E: int = 256, seed: int = 0) -> dict:
    """A ring of K keyframes (1 m radius, yaw noise 0.02 rad, 5 cm position
    noise) with E edges from each keyframe to one of its next three, whose
    measurements are the noisy states' own relative Sim(3)s; keyframe 0
    fixed."""
    rng = np.random.default_rng(seed)
    angles = np.linspace(0, 2 * np.pi, K, endpoint=False)
    R = np.stack([_so3_exp([0, 0, a + rng.normal() * 0.02]) for a in angles])
    t = np.stack([np.array([np.cos(a), np.sin(a), 0], np.float32)
                  + rng.normal(size=3).astype(np.float32) * 0.05 for a in angles])
    e_i = rng.integers(0, K, size=E).astype(np.int32)
    e_j = (e_i + 1 + rng.integers(0, 3, size=E).astype(np.int32)) % K
    Rt, tt = torch.from_numpy(R), torch.from_numpy(t.astype(np.float32))
    one = torch.ones(E)
    eR, et, es = lie.sim3_mul(Rt[e_j], tt[e_j], one, *lie.sim3_inv(Rt[e_i], tt[e_i], one))
    return dict(
        R=R, t=t.astype(np.float32), s=np.ones(K, np.float32), kf_fixed=np.arange(K) == 0,
        kf_valid=np.ones(K, bool), e_i=e_i, e_j=e_j.astype(np.int32), e_R=eR.numpy(),
        e_t=et.numpy(), e_s=es.numpy(), e_valid=np.ones(E, bool),
        e_weight=np.ones(E, np.float32),
    )


def to_ba(arrays: dict, device) -> ba.BAProblem:
    return ba.ba_problem_from_numpy(arrays, device)


def to_vi(arrays: dict, device) -> viba.VIBAProblem:
    return viba.problem_from_numpy(arrays, device)


def to_pgo(arrays: dict, device) -> pgo.PGOProblem:
    return pgo.PGOProblem(**{
        k: torch.from_numpy(np.array(arrays[k], copy=True)).to(device)
        for k in pgo.PGOProblem._fields
    })


def save(path, **trees) -> None:
    """Write numpy trees to one ``.npz`` (keys "tree/field[/field]"; a None
    leaf is left out and reads back as None)."""
    flat = {}

    def walk(prefix, x):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(f"{prefix}/{k}", v)
        elif x is not None:
            flat[prefix] = np.asarray(x)

    for name, tree in trees.items():
        walk(name, tree)
    np.savez(path, **flat)


def load(path) -> dict:
    """The trees ``save`` wrote, by name; the fields of ``viba.VIBAProblem``
    that were None come back as None."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    for tree in out.values():
        if "ie_preint" in tree:  # a VI problem
            tree.setdefault("ur", None)
            tree["bf"] = float(tree.get("bf", 0.0))
    return out
