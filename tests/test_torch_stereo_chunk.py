"""The port's stereo chunk loop (``device_loop``'s stereo branch through
``StereoSlam.process_frames``) on the CPU, where its regions run eagerly on
the same buffers its CUDA graphs use on the card, against the JAX package's
``device_loop.make_chunk_runner(stereo=True)``. The setup is
``tests/test_stereo.py::TestStereoChunk``'s: ``make_sequence(seed=3)`` with
a 0.12 m baseline at 240x376, 800 features, ``kf_every`` 4,
``lean_after_kf`` 3, chunks of 8.

The module's fixture runs the port per frame until the chunk gate holds
(frame 9) and keeps that system as the snapshot:

- (a) one 8-frame chunk of the JAX package's program and of the port's
  runner from the same map, pose and motion model;
- (b) ``TestStereoChunk``'s protocol end to end: 48 frames per frame to
  the gate, then chunks, with that test's bounds.

Tolerances are stated where they are compared.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.models import device_loop as jdl
from orb_slam3_ros_tpu.models import map_state as jms
from orb_slam3_ros_tpu.ops import orb as jorb
from orb_slam3_ros_tpu.utils import synth as jsynth
from orb_slam3_ros_tpu_torch.models import device_loop as tdl
from orb_slam3_ros_tpu_torch.models import map_state as tms
from orb_slam3_ros_tpu_torch.models import system as tsys
from orb_slam3_ros_tpu_torch.models.chunk_runner import read_rows
from orb_slam3_ros_tpu_torch.models.stereo_system import StereoSlam
from orb_slam3_ros_tpu_torch.utils.evaluate_ate import ate_rmse

torch.set_num_threads(1)
H, W, BASELINE, N_FRAMES, CHUNK = 240, 376, 0.12, 48, 8
SLAM_KW = dict(height=H, width=W, n_features=800, max_keyframes=32, max_points=4096,
               baseline=BASELINE, kf_every=4, lean_after_kf=3)


def _frame(slam, seq, i):
    return slam.process_frame(seq.images[i], seq.images_right[i], float(seq.timestamps[i]))


def _against_jax(snap, seq, pairs):
    """One CHUNK-frame chunk from the snapshot by both packages."""
    slam = copy.deepcopy(snap)
    i0, cfg = slam.frame_id, slam._chunk_config()
    tss = seq.timestamps[i0 : i0 + CHUNK].astype(np.float32)
    run = jdl.make_chunk_runner(
        jorb.default_config(H, W, n_features=800), jnp.asarray(seq.cam_params), width=W,
        height=H, kf_every=cfg.kf_every, kf_min_inliers=cfg.kf_min_inliers,
        kf_ref_ratio=cfg.kf_ref_ratio, ba_window=cfg.ba_window, ba_fixed=cfg.ba_fixed,
        local_ba_iters=cfg.local_ba_iters, fuse_neighbors=cfg.fuse_neighbors,
        fuse_every=cfg.fuse_every, stats_every=cfg.stats_every, cull_every=cfg.cull_every,
        kf_culling=cfg.kf_culling, schedule=slam._sched_lean, K_cap=cfg.K_cap,
        track_cap=cfg.track_cap, bf=cfg.bf, baseline=cfg.baseline, max_depth=cfg.max_depth,
        stereo=True,
    )
    jm = jms.MapState(**{k: jnp.asarray(v) for k, v in tms.to_numpy(slam.map).items()})
    carry = jdl.LoopCarry(
        m=jm, R=jnp.asarray(slam.R_cur), t=jnp.asarray(slam.t_cur), vel_R=jnp.asarray(slam.vel_R),
        vel_t=jnp.asarray(slam.vel_t), n_kf=jnp.asarray(slam.n_kf, jnp.int32),
        n_pts=jnp.asarray(slam.n_pts, jnp.int32),
        last_kf_fid=jnp.asarray(slam.last_kf_frame, jnp.int32), alive=jnp.asarray(True),
        ref_inl=jnp.full((), -1, jnp.int32),
    )
    jc, jout = run(carry, jnp.asarray(pairs[i0 : i0 + CHUNK].numpy()), jnp.asarray(tss),
                   jnp.arange(CHUNK, dtype=jnp.int32) + i0)
    runner = tdl.MonoChunkRunner(cfg, torch.device("cpu"))
    pose = torch.from_numpy(np.concatenate([
        slam.R_cur.reshape(-1), slam.t_cur, slam.vel_R.reshape(-1), slam.vel_t,
    ]).astype(np.float32))
    runner.load(slam.map, pose, slam.n_kf, slam.n_pts, slam.last_kf_frame, -1)
    xs = torch.from_numpy(np.stack([tss, i0 + np.arange(CHUNK)], 1).astype(np.float32))
    rows, kf_ids = runner.run_chunk(pairs, i0, xs, slam._sched_lean, slam.n_kf)
    return dict(out=read_rows(rows.numpy()), c=runner.carry(), kf_ids=kf_ids, runner=runner,
                jout={k: np.asarray(v) for k, v in jout._asdict().items()}, jc=jc)


def _metric_ate(slam, seq):
    traj = slam.get_trajectory()
    ts = np.asarray([t for t, _ in traj])
    est = np.stack([T[:3, 3] for _, T in traj])
    rmse, n, _ = ate_rmse(ts, est, seq.timestamps.astype(np.float64), seq.t_wc, with_scale=False)
    return rmse, n


def _protocol(seq, pairs):
    """TestStereoChunk's chunked run: per frame to the gate, chunks of 8,
    the rest per frame. Returns (system, gate frame, process_frame
    calls)."""
    slam = StereoSlam(cam_params=seq.cam_params, device="cpu", **SLAM_KW)
    calls = []
    per_frame = slam.process_frame

    def counted(*a, **k):
        calls.append(1)
        return per_frame(*a, **k)

    slam.process_frame = counted
    i = 0
    while i < N_FRAMES and not slam._chunkable():
        _frame(slam, seq, i)
        i += 1
    gate = i
    while i + CHUNK <= N_FRAMES:
        slam.process_frames((pairs, i), seq.timestamps[i : i + CHUNK])
        i += CHUNK
    while i < N_FRAMES:
        _frame(slam, seq, i)
        i += 1
    slam.flush()
    return slam, gate, len(calls)


@pytest.fixture(scope="module")
def runs():
    seq = jsynth.make_sequence(n_frames=N_FRAMES, height=H, width=W, dt=0.1, seed=3,
                               stereo_baseline=BASELINE)
    pairs = torch.from_numpy(np.stack([seq.images, seq.images_right], 1).astype(np.float32))
    slam = StereoSlam(cam_params=seq.cam_params, device="cpu", **SLAM_KW)
    i = 0
    while not slam._chunkable():
        _frame(slam, seq, i)
        i += 1
    out = dict(seq=seq, snap=slam, i0=i, jax=_against_jax(slam, seq, pairs))
    out["chunked"] = _protocol(seq, pairs)
    return out


# ---- (a) the port's chunk against the JAX package's, from one snapshot ----
# The same frames are keyframes and alive, with the same reference
# keyframes; keyframe, point and frame counters equal; inliers within 1% a
# frame (measured: 7 of 8 equal, one 221 against 222, at the last
# keyframe, whose count the thRefRatio bar carries on). Poses up to the chunk's last keyframe within
# 5e-4 (measured 2.3e-4 m, 5.4e-5 rad); the last keyframe adopts its
# local-BA pose, within 2e-2 m / 5e-3 rad (measured 8.9e-3 m, 2.0e-3 rad):
# the JAX chunk's compiled extraction makes one stereo match more than
# either package's eager extraction at the chunk's first keyframe (352
# against 351), so one depth landmark more and every later slot shifted.
# Keyframe u_r rows 99% alike (measured: all but one entry).
def _jc(r, k):
    return np.asarray(getattr(r["jc"], k))


def _pose_err(r, rows):
    o, j = r["out"], r["jout"]
    return (np.abs(o.t[rows] - j["t"][rows]).max(), np.abs(o.R[rows] - j["R"][rows]).max())


def _before_last_kf(r):
    return slice(0, int(np.nonzero(r["jout"]["is_kf"])[0][-1]))


JAX_CHECKS = {
    "keyframes_and_alive_equal": lambda r: np.array_equal(r["out"].is_kf, r["jout"]["is_kf"])
    and np.array_equal(r["out"].alive, r["jout"]["alive"]) and r["out"].alive.all(),
    "a_keyframe_in_the_chunk": lambda r: len(r["kf_ids"]) >= 1,
    "inliers_within_1_percent": lambda r: np.all(
        np.abs(r["out"].n_inliers - r["jout"]["n_inliers"]) <= 0.01 * r["jout"]["n_inliers"]),
    "reference_keyframes_equal": lambda r: np.array_equal(r["out"].ref, r["jout"]["ref"]),
    "poses_before_the_last_keyframe_close": lambda r: max(_pose_err(r, _before_last_kf(r)))
    <= 5e-4,
    "every_pose_close": lambda r: _pose_err(r, slice(None))[0] <= 2e-2
    and _pose_err(r, slice(None))[1] <= 5e-3,
    "counters_equal": lambda r: int(r["c"].n_kf) == int(_jc(r, "n_kf"))
    and int(r["c"].n_pts) == int(_jc(r, "n_pts"))
    and int(r["c"].last_kf_fid) == int(_jc(r, "last_kf_fid")),
    "reference_inliers_within_1_percent": lambda r: abs(int(r["c"].ref_inl) - int(_jc(r, "ref_inl")))
    <= 0.01 * int(_jc(r, "ref_inl")),
    "keyframe_right_coordinates_alike": lambda r: (np.abs(
        r["c"].m.kf_ur.numpy() - np.asarray(r["jc"].m.kf_ur)) <= 1e-3).mean() >= 0.99,
    "keyframe_poses_close": lambda r: np.abs(
        r["c"].m.kf_t.numpy() - np.asarray(r["jc"].m.kf_t)).max() <= 2e-2,
    "live_points_alike": lambda r: abs(int(r["c"].m.pt_valid.sum())
                                       - int(np.asarray(r["jc"].m.pt_valid).sum())) <= 0.02
    * int(np.asarray(r["jc"].m.pt_valid).sum()),
}


@pytest.mark.parametrize("name", list(JAX_CHECKS))
def test_stereo_chunk_against_jax(runs, name):
    r = runs["jax"]
    assert JAX_CHECKS[name](r), (name, r["out"].n_inliers, r["jout"]["n_inliers"], r["kf_ids"],
                                 _pose_err(r, slice(None)))


def test_stereo_chunk_ran_the_stereo_branch(runs):
    # 8 step runs on [2, H, W] pairs; each keyframe's segments; the
    # keyframes' right-image coordinates and depth buffered for them.
    r = runs["jax"]["runner"]
    assert r.stereo and r.buf["img"].shape == (2, H, W) and "f_depth" in r.buf
    assert sum(v for k, v in r.runs.items() if isinstance(k, tuple)) == CHUNK and not r.graphs
    assert r.runs["kf_insert"] == r.runs["kf_ba"] == r.runs["kf_end"] == len(runs["jax"]["kf_ids"])


def test_process_frames_takes_left_and_right_lists(runs):
    # StereoSlam.process_frames(lefts, tss, imgs_right=rights) stacks the
    # pairs ([C, 2, H, W], uint8 with transfer_uint8) and runs the same
    # chunk as the runner from the snapshot in (a): the same end pose and
    # counters.
    seq, snap = runs["seq"], runs["snap"]
    i0 = runs["i0"]
    frames = range(i0, i0 + CHUNK)
    slam = copy.deepcopy(snap)
    slam.process_frames([seq.images[i] for i in frames], seq.timestamps[i0 : i0 + CHUNK],
                        imgs_right=[seq.images_right[i] for i in frames])
    c = runs["jax"]["c"]
    assert slam.frame_id == i0 + CHUNK and slam.n_kf == int(c.n_kf)
    assert np.array_equal(slam.t_cur, c.t.numpy()) and np.array_equal(slam.R_cur, c.R.numpy())
    u8 = copy.deepcopy(snap)
    u8.transfer_uint8 = True
    st = u8._frame_stack([np.stack([seq.images[i], seq.images_right[i]]) for i in frames])
    assert st.shape == (CHUNK, 2, H, W) and st.dtype == torch.uint8


def test_stereo_gate_and_config(runs):
    snap = runs["snap"]
    cfg = snap._chunk_config()
    assert snap._chunk_stereo() and cfg.stereo and cfg.bf == pytest.approx(snap.bf)
    assert cfg.fx == pytest.approx(float(snap.cam_params[0])) and cfg.max_depth == snap.max_depth
    # a MonoSlam with bf > 0 and no stereo branch does not chunk
    mono = copy.deepcopy(snap)
    mono._chunk_stereo = lambda: False
    assert not mono._chunkable()


# ---- (b) TestStereoChunk's protocol end to end ----
# The JAX test's bounds: the gate by frame 24, at most 8 frames per frame
# after it, 40+ poses scored, the chunked metric ATE under max(0.08, 2.5 x
# the per-frame run's + 0.02), which is 0.08 m with the per-frame runs'
# 0.0145 m (both packages, test_torch_stereo_e2e.py's 25 frames; 0.0118 m
# measured chunked here, 0.0407 m in the JAX package's chunked run); and
# keyframes within 2 of the per-frame run's 12 at this cadence.
def test_chunked_protocol(runs):
    seq = runs["seq"]
    slam_c, gate, pf_calls = runs["chunked"]
    assert slam_c.state == tsys.OK
    assert gate <= 24, f"chunk never engaged (steady at {gate})"
    assert pf_calls - gate <= 8
    assert slam_c.n_kf >= 12 - 2
    rmse_c, nm_c = _metric_ate(slam_c, seq)
    assert nm_c >= N_FRAMES - 8
    assert rmse_c < 0.08, rmse_c
