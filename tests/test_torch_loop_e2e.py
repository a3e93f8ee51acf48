"""Loop closing as a whole in the port against the JAX package: the closed
loop of ``tests/test_loop_closing.py`` (``make_sequence(trajectory="loop",
seed=5)`` at 240x376, local-map tracking over the last 8 keyframes,
``kf_every`` 3, ``min_gap`` 8, ``min_sim3_inliers`` 15, chunks of 10).

The JAX ``MonoSlam`` runs the sequence per frame to the chunk gate and in
chunks up to ``SNAP``, a chunk boundary before the revisit's keyframes; its
state there (map, pose, motion model, trajectory logs, the loop closer) is
carried into a port ``MonoSlam``, and both run the remaining frames in
chunks on the same images, then flush. Required: the closure fires on the
same keyframe with the same candidate in both; its Sim(3) and the corrected
keyframe poses agree within the tolerances stated below; the recomposed
trajectory's ATE is within a stated margin of the JAX package's and below
the JAX test's bound.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.models.system import MonoSlam as JaxSlam
from orb_slam3_ros_tpu.utils import synth as jsynth
from orb_slam3_ros_tpu_torch.models import map_state as tms
from orb_slam3_ros_tpu_torch.models.system import OK, MonoSlam
from orb_slam3_ros_tpu_torch.utils.evaluate_ate import ate_rmse
from torch_parity import np_tree

torch.set_num_threads(1)
H, W, N_FRAMES, CHUNK = 240, 376, 90, 10
SLAM_KW = dict(height=H, width=W, n_features=1200, max_keyframes=48, max_points=6144, kf_every=3,
               track_window=8, enable_loop_closing=True)
SNAP = 64  # a chunk boundary before the revisit (the JAX run chunks from frame 34 on)


def _closer(slam):
    slam.loop_closer.min_gap = 8
    slam.loop_closer.min_sim3_inliers = 15
    return slam


def _record_closures(slam, to_np):
    """Keep the Sim(3) and the corrected keyframe poses of every closure."""
    lc, apply = slam.loop_closer, slam.loop_closer._apply_closure
    seen = []

    def recorded(s, new_kf, cand, R, t, sc, *a, **kw):
        out = apply(s, new_kf, cand, R, t, sc, *a, **kw)
        seen.append(dict(new_kf=new_kf, cand=cand, R=to_np(R), t=to_np(t), s=float(to_np(sc)),
                         kf_R=to_np(s.map.kf_R)[: s.n_kf], kf_t=to_np(s.map.kf_t)[: s.n_kf]))
        return out

    lc._apply_closure = recorded
    return seen


def _port_from_jax(js) -> MonoSlam:
    """A port MonoSlam in the JAX system's state (between chunks, drained)."""
    ts = _closer(MonoSlam(cam_params=np.asarray(js.cam_params), device="cpu", pipelined=False,
                          **SLAM_KW))
    ts.map = tms.from_numpy(np_tree(js.map), "cpu")
    for f in ("n_kf", "n_pts", "frame_id", "last_kf_frame", "_ref_kf_inl", "_last_frame_ts",
              "state"):
        setattr(ts, f, copy.copy(getattr(js, f)))
    ts._cap_retry_frame = getattr(js, "_cap_retry_frame", -999)
    for f in ("R_cur", "t_cur", "vel_R", "vel_t"):
        setattr(ts, f, np.asarray(getattr(js, f), np.float32).copy())
    ts.trajectory = [(t, np.asarray(T)) for t, T in js.trajectory]
    ts.rel_traj = [(t, int(r), np.asarray(R), np.asarray(tt)) for t, r, R, tt in js.rel_traj]
    ts.frozen_traj = [(t, np.asarray(T)) for t, T in js.frozen_traj]
    jl, tl = js.loop_closer, ts.loop_closer
    for f in ("last_closed_kf", "closures", "_vocab_trained_at", "max_loop_edges", "_n_edges"):
        setattr(tl, f, copy.copy(getattr(jl, f)))
    for f in ("_edge_i", "_edge_j", "_edge_R", "_edge_t", "_edge_s"):
        setattr(tl, f, np.asarray(getattr(jl, f)).copy())
    if jl._pending is not None:
        p = dict(jl._pending)
        p["S_cw"] = tuple(torch.from_numpy(np.asarray(x)) for x in p["S_cw"])
        tl._pending = p
    assert js._gba is None
    return ts


@pytest.fixture(scope="module")
def runs():
    seq = jsynth.make_sequence(n_frames=N_FRAMES, height=H, width=W, dt=0.1, seed=5,
                               trajectory="loop")
    imgs = np.stack(seq.images).astype(np.float32)
    js = _closer(JaxSlam(cam_params=seq.cam_params, pipelined=False, **SLAM_KW))
    jstack = jnp.asarray(np.clip(imgs, 0, 255).astype(np.uint8))
    tstack = torch.from_numpy(np.clip(imgs, 0, 255).astype(np.uint8))
    i = 0
    while i < SNAP:
        if js.state == OK and js._chunkable() and i + CHUNK <= SNAP:
            js.process_frames((jstack, i), seq.timestamps[i : i + CHUNK])
            i += CHUNK
        else:
            js.process_frame(imgs[i], float(seq.timestamps[i]))
            i += 1
    js.flush()
    assert i == SNAP and js._chunk_run is not None and js._chunkable()
    assert not js.loop_closer.closures and js.loop_closer._pending is None
    ts = _port_from_jax(js)
    seen = {"jax": _record_closures(js, np.asarray),
            "port": _record_closures(ts, lambda x: x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x))}
    for slam, stack in ((js, jstack), (ts, tstack)):
        j = i
        while j + CHUNK <= N_FRAMES:
            slam.process_frames((stack, j), seq.timestamps[j : j + CHUNK])
            j += CHUNK
        for k in range(j, N_FRAMES):
            slam.process_frame(imgs[k], float(seq.timestamps[k]))
        slam.flush()

    def ate(slam):
        traj = slam.get_trajectory()
        tss = np.asarray([t for t, _ in traj])
        est = np.stack([np.asarray(T)[:3, 3] for _, T in traj])
        return ate_rmse(tss, est, seq.timestamps.astype(np.float64), seq.t_wc)[0]

    return dict(jax=js, port=ts, seen=seen, ate={"jax": ate(js), "port": ate(ts)})


def test_the_closure_fires_on_the_same_keyframe_and_candidate(runs):
    j, p = runs["seen"]["jax"], runs["seen"]["port"]
    assert j, "the JAX package closed no loop after the snapshot"
    assert [(c["new_kf"], c["cand"]) for c in p] == [(c["new_kf"], c["cand"]) for c in j]
    assert [c[:2] for c in runs["port"].loop_closer.closures] == \
        [c[:2] for c in runs["jax"].loop_closer.closures]


def test_the_loop_sim3_agrees(runs):
    """The Sim(3) of each closure: 1e-4 in rotation and translation, 1e-3
    in scale (measured 1.6e-6, 2.0e-6 and 1.8e-4: the guided verification's
    refit on the same inliers; the two RANSAC draws differ)."""
    for j, p in zip(runs["seen"]["jax"], runs["seen"]["port"]):
        np.testing.assert_allclose(p["R"], j["R"], atol=1e-4)
        assert np.linalg.norm(p["t"] - j["t"]) <= 1e-4
        assert abs(p["s"] - j["s"]) <= 1e-3


def test_the_corrected_keyframe_poses_agree(runs):
    """The keyframe poses right after the essential-graph correction: within
    1e-3 (measured 1.2e-4 rad, 1.3e-4 map units: the maps entered the
    closure after two chunks and five frames in each package, and the PGO
    spreads their small differences over the graph)."""
    for j, p in zip(runs["seen"]["jax"], runs["seen"]["port"]):
        np.testing.assert_allclose(p["kf_R"], j["kf_R"], atol=1e-3)
        np.testing.assert_allclose(p["kf_t"], j["kf_t"], atol=1e-3)


def test_ate_is_within_the_jax_packages(runs):
    """The recomposed trajectory's ATE (Sim(3)-aligned): within 0.002 of
    the JAX package's (measured 0.03829 against 0.03829) and under the 0.25
    bound of ``test_loop_closing.py``."""
    a = runs["ate"]
    assert a["port"] <= a["jax"] + 0.002, a
    assert a["port"] < 0.25, a


def test_every_global_ba_folded_in(runs):
    ts = runs["port"]
    assert ts._gba is None
    assert ts.gba_counts["started"] == ts.gba_counts["finished"] >= 1
    assert ts.loop_closer.sim3_searches >= 2
