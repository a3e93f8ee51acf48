"""The port's monocular chunk loop (``models/device_loop.py`` and
``MonoSlam.process_frames``) on the CPU, where its regions run eagerly on
the same buffers its CUDA graphs use on the card, against the JAX package's
``device_loop.make_chunk_runner``. The setup is ``tests/test_device_loop.py``'s:
``make_sequence(seed=3)`` at 240x376, 1200 features, ``lean_after_kf`` 4,
chunks of 8.

The module's fixture runs the port per frame until the chunk gate holds and
keeps that system as the snapshot the cases start from:

- (a) one 8-frame chunk of the JAX package's program and of the port's
  runner from the same map, pose and motion model (carried across as
  numpy);
- (b) the local BA's two early-stop forms (``ba.bundle_adjust``: leaving
  the loop on the host, or freezing the state on the device) on the
  snapshot's own window, to the bit;
- (c) localization mode in chunks;
- (d) the gate, and the keyframe rule's ``min_kf``.

Tolerances are stated where they are compared. ``tests/test_torch_mono_chunk_loop.py``
holds the copies of ``tests/test_device_loop.py``'s end-to-end cases.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.models import device_loop as jdl
from orb_slam3_ros_tpu.models import map_state as jms
from orb_slam3_ros_tpu.ops import orb as jorb
from orb_slam3_ros_tpu_torch.models import device_loop as tdl
from orb_slam3_ros_tpu_torch.models import local_mapping as tlm
from orb_slam3_ros_tpu_torch.models import map_state as tms
from orb_slam3_ros_tpu_torch.models import system as tsys
from orb_slam3_ros_tpu_torch.models import vi_device_loop as tvdl
from orb_slam3_ros_tpu_torch.models.chunk_runner import read_rows
from orb_slam3_ros_tpu_torch.ops import ba as tba
from orb_slam3_ros_tpu_torch.utils import synth as tsynth
from orb_slam3_ros_tpu_torch.utils.evaluate_ate import ate_rmse

torch.set_num_threads(1)
H, W, N_FRAMES, CHUNK = 240, 376, 40, 8
SLAM_KW = dict(height=H, width=W, n_features=1200, max_keyframes=32, max_points=4096,
               lean_after_kf=4, pipelined=False)


def _pose_upload(slam):
    return torch.from_numpy(np.concatenate([
        slam.R_cur.reshape(-1), slam.t_cur, slam.vel_R.reshape(-1), slam.vel_t,
    ]).astype(np.float32))


def _against_jax(snap, seq, stack):
    """One CHUNK-frame chunk from the snapshot by both packages."""
    slam = copy.deepcopy(snap)
    i0, cfg = slam.frame_id, slam._chunk_config()
    tss = seq.timestamps[i0 : i0 + CHUNK].astype(np.float32)
    run = jdl.make_chunk_runner(
        jorb.default_config(H, W, n_features=1200), jnp.asarray(seq.cam_params), width=W,
        height=H, kf_every=cfg.kf_every, kf_min_inliers=cfg.kf_min_inliers,
        kf_ref_ratio=cfg.kf_ref_ratio, ba_window=cfg.ba_window, ba_fixed=cfg.ba_fixed,
        local_ba_iters=cfg.local_ba_iters, fuse_neighbors=cfg.fuse_neighbors,
        fuse_every=cfg.fuse_every, stats_every=cfg.stats_every, cull_every=cfg.cull_every,
        kf_culling=cfg.kf_culling, schedule=slam._sched_lean, K_cap=cfg.K_cap,
        track_cap=cfg.track_cap,
    )
    jm = jms.MapState(**{k: jnp.asarray(v) for k, v in tms.to_numpy(slam.map).items()})
    carry = jdl.LoopCarry(
        m=jm, R=jnp.asarray(slam.R_cur), t=jnp.asarray(slam.t_cur), vel_R=jnp.asarray(slam.vel_R),
        vel_t=jnp.asarray(slam.vel_t), n_kf=jnp.asarray(slam.n_kf, jnp.int32),
        n_pts=jnp.asarray(slam.n_pts, jnp.int32),
        last_kf_fid=jnp.asarray(slam.last_kf_frame, jnp.int32), alive=jnp.asarray(True),
        ref_inl=jnp.full((), -1, jnp.int32),
    )
    jc, jout = run(carry, jnp.asarray(stack[i0 : i0 + CHUNK].numpy()), jnp.asarray(tss),
                   jnp.arange(CHUNK, dtype=jnp.int32) + slam.frame_id)
    runner = tdl.MonoChunkRunner(cfg, torch.device("cpu"))
    runner.load(slam.map, _pose_upload(slam), slam.n_kf, slam.n_pts, slam.last_kf_frame, -1)
    xs = torch.from_numpy(np.stack([tss, i0 + np.arange(CHUNK)], 1).astype(np.float32))
    rows, kf_ids = runner.run_chunk(stack, i0, xs, slam._sched_lean, slam.n_kf)
    return dict(out=read_rows(rows.numpy()), c=runner.carry(), kf_ids=kf_ids, runner=runner,
                jout={k: np.asarray(v) for k, v in jout._asdict().items()}, jc=jc)


@pytest.fixture(scope="module")
def runs():
    seq = tsynth.make_sequence(n_frames=N_FRAMES, height=H, width=W, dt=0.1, seed=3, device="cpu")
    slam = tsys.MonoSlam(cam_params=seq.cam_params, device="cpu", **SLAM_KW)
    i = 0
    while i < N_FRAMES and not slam._chunkable():
        slam.process_frame(seq.images[i], float(seq.timestamps[i]))
        i += 1
    assert i <= N_FRAMES - 2 * CHUNK, f"steady state reached only at frame {i}"
    stack = torch.clamp(seq.images, 0, 255).to(torch.uint8)  # the stack bench.py hands in
    out = dict(seq=seq, snap=slam, i0=i, stack=stack)
    out["jax"] = _against_jax(slam, seq, stack)
    loc = copy.deepcopy(slam)
    loc.activate_localization_mode()
    for j in (i, i + CHUNK):
        loc.process_frames((stack, j), seq.timestamps[j : j + CHUNK])
    out["localization"] = loc
    return out


# ---- (a) the port's chunk against the JAX package's, from one snapshot ----
# The same frames are keyframes and alive, in both; inliers agree to 1% a
# frame (measured: 7 of 8 equal, one 114 against 113); frame poses to 5e-4
# rad / 5e-4 m (measured: 1.2e-4 / 1.0e-4 on the frame with one inlier
# more, under 3e-6 on the others); the end pose, motion model and keyframe
# poses to 5e-4 (measured under 2e-6: the keyframe's local BA sums in
# another order, the JAX chunk's normal equations by the row_n
# compare-reduce, the port's by index_add_); counters exactly; the map's
# observations 99.9% alike (measured: all).
def _jc(r, k):
    return np.asarray(getattr(r["jc"], k))


JAX_CHECKS = {
    "keyframes_and_alive_equal": lambda r: np.array_equal(r["out"].is_kf, r["jout"]["is_kf"])
    and np.array_equal(r["out"].alive, r["jout"]["alive"]) and r["out"].alive.all(),
    "a_keyframe_in_the_chunk": lambda r: len(r["kf_ids"]) >= 1,
    "inliers_within_1_percent": lambda r: np.all(
        np.abs(r["out"].n_inliers - r["jout"]["n_inliers"]) <= 0.01 * r["jout"]["n_inliers"]),
    "reference_keyframes_equal": lambda r: np.array_equal(r["out"].ref, r["jout"]["ref"]),
    "poses_close": lambda r: np.abs(r["out"].R - r["jout"]["R"]).max() <= 5e-4
    and np.abs(r["out"].t - r["jout"]["t"]).max() <= 5e-4
    and np.abs(r["out"].t_cr - r["jout"]["t_cr"]).max() <= 5e-4,
    "end_pose_and_motion_close": lambda r: all(
        np.abs(getattr(r["c"], k).numpy() - _jc(r, k)).max() <= 5e-4
        for k in ("R", "t", "vel_R", "vel_t")),
    "keyframe_and_point_counts_equal": lambda r: int(r["c"].n_kf) == int(_jc(r, "n_kf"))
    and int(r["c"].n_pts) == int(_jc(r, "n_pts"))
    and int(r["c"].last_kf_fid) == int(_jc(r, "last_kf_fid"))
    and int(r["c"].ref_inl) == int(_jc(r, "ref_inl")),
    "map_observations_alike": lambda r: np.array_equal(
        r["c"].m.pt_valid.numpy(), np.asarray(r["jc"].m.pt_valid))
    and (r["c"].m.kf_obs.numpy() == np.asarray(r["jc"].m.kf_obs)).mean() >= 0.999,
    "keyframe_poses_close": lambda r: np.abs(
        r["c"].m.kf_t.numpy() - np.asarray(r["jc"].m.kf_t)).max() <= 5e-4,
}


@pytest.mark.parametrize("name", list(JAX_CHECKS))
def test_chunk_against_jax(runs, name):
    r = runs["jax"]
    assert JAX_CHECKS[name](r), (name, r["out"].n_inliers, r["jout"]["n_inliers"], r["kf_ids"])


def test_chunk_ran_its_regions(runs):
    # 8 step runs, each keyframe's six segments minus the cadence's skips
    r = runs["jax"]["runner"]
    steps = sum(v for k, v in r.runs.items() if isinstance(k, tuple))
    assert steps == CHUNK and not r.graphs
    assert r.runs["kf_insert"] == r.runs["kf_ba"] == r.runs["kf_end"] == len(runs["jax"]["kf_ids"])


# ---- (b) the two early-stop forms of the local BA ----
def _ba_problem(snap):
    m = snap.map
    window = tlm.select_covis_window(m, torch.tensor(snap.n_kf - 1, dtype=torch.int32),
                                     snap.ba_window, snap.ba_fixed)
    prob, _ = tlm.build_local_ba(m, window[0], window[1], snap.cam_params, entry_valid=window[2])
    return prob


@pytest.mark.parametrize("n_iters,rel_tol", [(20, 1e-3), (6, 1e-3), (20, 1e-1), (4, 0.0)])
def test_device_form_ba_equals_host_exit(runs, n_iters, rel_tol):
    # Same problem, same steps: the device form runs all n_iters and freezes
    # the state from the step that set ``done``; the host form leaves the
    # loop there. Equal to the bit, the iterations counted alike.
    prob = _ba_problem(runs["snap"])
    host = tba.bundle_adjust(prob, n_iters=n_iters, rel_tol=rel_tol)
    dev = tba.bundle_adjust(prob, n_iters=n_iters, rel_tol=rel_tol, on_device=True)
    for f in ("R", "t", "X", "chi2", "inlier", "cost", "n_inliers"):
        assert torch.equal(getattr(host, f), getattr(dev, f)), f
    assert int(dev.iters) == host.iters
    if rel_tol == 1e-1:
        assert host.iters < n_iters  # the early stop did happen


def test_select_covis_window_takes_a_device_id(runs):
    # The chunk's 0-d keyframe id selects the same window as a Python int.
    m, last = runs["snap"].map, runs["snap"].n_kf - 1
    a = tlm.select_covis_window(m, last, 8, 4)
    b = tlm.select_covis_window(m, torch.tensor(last, dtype=torch.int32), 8, 4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---- (c) localization mode in chunks ----
def test_localization_chunks_insert_no_keyframe(runs):
    loc, snap = runs["localization"], runs["snap"]
    assert loc.state == tsys.OK and loc.n_kf == snap.n_kf
    assert loc.last_kf_frame == snap.last_kf_frame  # the sentinel stayed on the device
    assert torch.equal(loc.map.kf_valid, snap.map.kf_valid)
    assert loc._mono_runner.runs["kf_insert"] == 0


def test_localization_chunks_track_every_frame(runs):
    loc, seq = runs["localization"], runs["seq"]
    traj = loc.get_trajectory()
    assert len(traj) == len(runs["snap"].get_trajectory()) + 2 * CHUNK
    ts = np.asarray([t for t, _ in traj])
    est = np.stack([T[:3, 3] for _, T in traj])
    rmse, n, _ = ate_rmse(ts, est, seq.timestamps.astype(np.float64), seq.t_wc)
    assert n == len(traj) and rmse < 0.05, rmse


# ---- (d) the gate and the keyframe rule ----
def test_gate_on_a_young_map_runs_per_frame(runs):
    seq, stack = runs["seq"], runs["stack"]
    slam = tsys.MonoSlam(cam_params=seq.cam_params, device="cpu", **SLAM_KW)
    slam.process_frames((stack, 0), seq.timestamps[0:3])
    assert slam._mono_runner is None and slam.frame_id == 3


def test_gate_on_a_timestamp_gap_runs_per_frame(runs):
    slam, seq, i = copy.deepcopy(runs["snap"]), runs["seq"], runs["i0"]
    tss = seq.timestamps[i : i + 2].astype(np.float64) + 5.0
    slam.process_frames((runs["stack"], i), tss)
    assert slam._mono_runner is None and slam.frame_id == runs["snap"].frame_id + 2


@pytest.mark.parametrize("n_kf,want", [(1, False), (2, True), (5, True)])
def test_keyframe_rule_needs_two_keyframes(n_kf, want):
    # The monocular rule (JAX device_loop.py:273-278): n_kf >= 2 on top of
    # the VI rule, shared through ``min_kf``.
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    got = tvdl.need_keyframe(torch.tensor(True), i32(290), i32(10), i32(300), i32(n_kf),
                             K_cap=8, kf_every=10, kf_min_inliers=60, kf_ref_ratio=0.5, min_kf=2)
    assert bool(got) == want
