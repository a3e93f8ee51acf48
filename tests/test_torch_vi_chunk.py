"""The port's VI chunk loop (``models/vi_device_loop.py`` and
``InertialSlam.process_frames``) on the CPU, where its regions run eagerly
on the same buffers its CUDA graphs use on the card. The setup is
``tests/test_vi_chunk.py``'s: ``make_vi_sequence(seed=0)`` at 240x376, 1200
features, ``kf_every`` 3, ``ba_window=4, ba_fixed=2`` (W = 6), chunks of 8.

The module's fixture runs the port per frame until the chunk gate holds and
keeps that system as the snapshot every case starts from:

- (a) one 8-frame chunk of the JAX package's ``make_vi_chunk_runner`` and
  of the port's runner from the same map and inertial state (carried across
  as numpy);
- (b) the steady tail chunked against the same tail per frame;
- (c) the host's keyframe IMU mirror against the device blocks;
- (d) a blackout mid-chunk: the hand-off to RECENTLY_LOST and the replayed
  tail, no IMU sample counted twice;
- (e) the gate; (f) the chunk's keyframe rule; (g) the two pieces made
  free of host reads, ``normalize_rotation`` and the DLT, against the JAX
  package.

The tolerances are stated where they are compared. The file holds 20+
cases so that ``--dist loadfile`` starts it among the first files.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.models import map_state as jms
from orb_slam3_ros_tpu.models import vi_device_loop as jvdl
from orb_slam3_ros_tpu.ops import lie as jlie
from orb_slam3_ros_tpu.ops import orb as jorb
from orb_slam3_ros_tpu.ops import triangulate as jtri
from orb_slam3_ros_tpu_torch.models import inertial_system as tis
from orb_slam3_ros_tpu_torch.models import map_state as tms
from orb_slam3_ros_tpu_torch.models import system as tsys
from orb_slam3_ros_tpu_torch.models import vi_device_loop as tvdl
from orb_slam3_ros_tpu_torch.models.chunk_runner import read_rows
from orb_slam3_ros_tpu_torch.ops import lie as tlie
from orb_slam3_ros_tpu_torch.ops import triangulate as ttri
from orb_slam3_ros_tpu_torch.utils import synth as tsynth
from orb_slam3_ros_tpu_torch.utils.evaluate_ate import ate_rmse
from torch_parity import torch_calib
from vi_sim import make_calib

torch.set_num_threads(1)
N_FRAMES, CHUNK, N_SKIP = 56, 8, 12
SEQ_KW = dict(n_frames=N_FRAMES, height=240, width=376, frame_dt=0.1, imu_per_frame=10, seed=0,
              bg=np.array([0.01, -0.015, 0.02]), noise_g=1e-4, noise_a=1e-3)
SLAM_KW = dict(height=240, width=376, n_features=1200, max_keyframes=32, max_points=4096,
               kf_every=3, ba_window=4, ba_fixed=2, init_after_kf=6)


def _kw(imu, i, n=1):
    return dict(acc=imu["acc"][i : i + n], gyro=imu["gyro"][i : i + n], dts=imu["dts"][i : i + n])


def _frame(slam, seq, imu, i):
    return slam.process_frame(seq.images[i], float(seq.timestamps[i]),
                              acc=imu["acc"][i], gyro=imu["gyro"][i], dts=imu["dts"][i])


def _tail(slam, seq, imu, i, chunked, stack):
    """Frames i.. to the end: chunks of CHUNK while they fit, then per frame.
    Records the keyframe count after the last chunk as ``n_kf_chunks``."""
    while chunked and i + CHUNK <= N_FRAMES:
        slam.process_frames((stack, i), seq.timestamps[i : i + CHUNK], **_kw(imu, i, CHUNK))
        i += CHUNK
    slam.n_kf_chunks = slam.n_kf
    while i < N_FRAMES:
        _frame(slam, seq, imu, i)
        i += 1
    return slam


def _ate(slam, seq):
    traj = slam.get_trajectory()
    ts = np.asarray([t for t, _ in traj])[N_SKIP:]
    est = np.stack([T[:3, 3] for _, T in traj])[N_SKIP:]
    return ate_rmse(ts, est, seq.timestamps.astype(np.float64), seq.t_wc, with_scale=True)


def _inputs(slam, imu, tss, i, C):
    """The chunk's per-frame input rows (IMU block, timestamp, frame id), as
    ``InertialSlam._run_vi_chunk`` builds them."""
    M = slam.imu_cap_frame
    xs = np.zeros((C, M * 7 + 2), np.float32)
    for j in range(C):
        n = len(imu["dts"][i + j])
        blk = xs[j, : M * 7].reshape(M, 7)
        blk[:n, 0:3], blk[:n, 3:6], blk[:n, 6] = imu["acc"][i + j], imu["gyro"][i + j], imu["dts"][i + j]
        xs[j, M * 7 :] = (tss[i + j], slam.frame_id + j)
    return xs


def _against_jax(snap, seq, imu, i0):
    """One CHUNK-frame chunk from the snapshot by both packages."""
    slam = copy.deepcopy(snap)
    st = slam._fresh_vi_dev_state()
    cfg = slam._vi_chunk_config()
    xs = _inputs(slam, imu, seq.timestamps, i0, CHUNK)
    ref_inl = slam._ref_kf_inl if slam._ref_kf_inl > 0 else -1
    M = slam.imu_cap_frame
    jm = jms.MapState(**{k: jnp.asarray(v) for k, v in tms.to_numpy(slam.map).items()})
    jst = jvdl.VIDevState(**{k: jnp.asarray(getattr(st, k).numpy()) for k in st._fields})
    run = jvdl.make_vi_chunk_runner(
        jorb.default_config(240, 376, n_features=1200), jnp.asarray(seq.cam_params),
        make_calib(freq=100.0), width=376, height=240, kf_every=cfg.kf_every,
        kf_min_inliers=cfg.kf_min_inliers, kf_ref_ratio=cfg.kf_ref_ratio, W=cfg.W,
        ba_window=cfg.ba_window, local_ba_iters=cfg.local_ba_iters,
        fuse_neighbors=cfg.fuse_neighbors, fuse_every=cfg.fuse_every,
        stats_every=cfg.stats_every, cull_every=cfg.cull_every, kf_culling=cfg.kf_culling,
        schedule=slam._current_schedule(), K_cap=cfg.K_cap, imu_cap_frame=M,
        imu_cap_kf=cfg.imu_cap_kf, track_cap=cfg.track_cap,
    )
    pk = np.concatenate([
        np.asarray([slam.n_kf, slam.n_pts, slam.last_kf_frame, 1.0, ref_inl, slam.frame_id, i0],
                   np.float32),
        xs[:, M * 7], xs[:, : M * 7].reshape(-1),
    ])
    jm2, _, packed = run(jm, jst, jnp.asarray(seq.images.numpy()), jnp.asarray(pk), chunk=CHUNK)
    kmax = (CHUNK + 1) // 2
    jout, jsc, jblk, jok = jvdl.unpack_vi_chunk_result(np.asarray(packed), CHUNK, kmax, cfg.imu_cap_kf)
    runner = tvdl.VIChunkRunner(cfg, torch.device("cpu"))
    runner.load(slam.map, st, slam.n_kf, slam.n_pts, slam.last_kf_frame, ref_inl)
    rows, kf_ids = runner.run_chunk(
        seq.images, i0, torch.from_numpy(xs), slam._current_schedule(), slam.n_kf
    )
    c = runner.carry()
    return dict(out=read_rows(rows.numpy()), c=c, kf_ids=kf_ids, jout=jout, jsc=jsc,
                jblk=jblk, jok=jok, jm=jm2, n_kf0=slam.n_kf)


@pytest.fixture(scope="module")
def runs():
    seq, imu = tsynth.make_vi_sequence(**SEQ_KW, device="cpu")
    slam = tis.InertialSlam(cam_params=seq.cam_params, calib=torch_calib(make_calib(freq=100.0)),
                            device="cpu", **SLAM_KW)
    i = 0
    while i < N_FRAMES and not slam._vi_chunkable():
        _frame(slam, seq, imu, i)
        i += 1
    assert i <= N_FRAMES - 2 * CHUNK, f"steady state reached only at frame {i}"
    stack = torch.clamp(seq.images, 0, 255).to(torch.uint8)  # the stack bench.py hands in
    out = dict(seq=seq, imu=imu, snap=slam, i0=i, stack=stack)
    out["jax"] = _against_jax(slam, seq, imu, i)
    out["chunked"] = _tail(copy.deepcopy(slam), seq, imu, i, True, stack)
    out["per_frame"] = _tail(copy.deepcopy(slam), seq, imu, i, False, stack)
    # (d) frames 3 and 4 of the first chunk blank: the step of frame 3 finds
    # no inliers and hands off to the per-frame path.
    blank = stack.clone()
    blank[i + 3 : i + 5] = 0
    b = copy.deepcopy(slam)
    calls = []
    per_frame = b.process_frame

    def counted(*args, **kw):
        calls.append(float(args[1]))
        return per_frame(*args, **kw)

    b.process_frame = counted
    b.process_frames((blank, i), seq.timestamps[i : i + CHUNK], **_kw(imu, i, CHUNK))
    b.process_frame = per_frame
    out["blackout"] = dict(slam=b, calls=calls,
                           state_after=b.state, tail=list(seq.timestamps[i + 3 : i + CHUNK]))
    _tail(b, seq, imu, i + CHUNK, True, stack)
    return out


# ---- (a) the port's chunk against the JAX package's, from one snapshot ----
# The same frames are keyframes and alive, in both; inliers agree to 1% a
# frame (measured: 7 of 8 frames equal, one 280 against 282); poses to
# 1e-4 rad / 5e-4 m (measured 4e-6 / 5e-5: the keyframe's VI-BA sums in
# another order); counters and the new keyframes' IMU blocks exactly; the
# map's observations 99.9% alike (measured 99.98%: the DLT, see (g)).
JAX_CHECKS = {
    "keyframes_and_alive_equal": lambda r: np.array_equal(r["out"].is_kf, r["jout"]["is_kf"])
    and np.array_equal(r["out"].alive, r["jout"]["alive"]) and r["out"].alive.all(),
    "a_keyframe_in_the_chunk": lambda r: len(r["kf_ids"]) >= 1,
    "inliers_within_1_percent": lambda r: np.all(
        np.abs(r["out"].n_inliers - r["jout"]["n_inliers"]) <= 0.01 * r["jout"]["n_inliers"]),
    "reference_keyframes_equal": lambda r: np.array_equal(r["out"].ref, r["jout"]["ref"]),
    "poses_close": lambda r: np.abs(r["out"].R - r["jout"]["R"]).max() <= 1e-4
    and np.abs(r["out"].t - r["jout"]["t"]).max() <= 5e-4
    and np.abs(r["out"].t_cr - r["jout"]["t_cr"]).max() <= 5e-4,
    "keyframe_and_point_counts_equal": lambda r: int(r["c"].n_kf) == r["jsc"]["n_kf"]
    and int(r["c"].n_pts) == r["jsc"]["n_pts"] and int(r["c"].last_kf_fid) == r["jsc"]["last_kf_fid"],
    "new_keyframe_imu_blocks_exact": lambda r: all(
        np.array_equal(r["c"].st.kf_blk[k].numpy(), r["jblk"][j])
        and bool(r["c"].st.kf_edge_ok[k]) == bool(r["jok"][j])
        for j, k in enumerate(r["kf_ids"])),
    "map_observations_alike": lambda r: np.array_equal(r["c"].m.pt_valid.numpy(), np.asarray(r["jm"].pt_valid))
    and (r["c"].m.kf_obs.numpy() == np.asarray(r["jm"].kf_obs)).mean() >= 0.999,
}


@pytest.mark.parametrize("name", list(JAX_CHECKS))
def test_chunk_against_jax(runs, name):
    r = runs["jax"]
    assert JAX_CHECKS[name](r), (name, r["out"].n_inliers, r["jout"]["n_inliers"], r["kf_ids"])


# ---- (b) chunked against per frame over the steady tail ----
# tests/test_vi_chunk.py's bounds, kept for this shorter run.
def test_chunked_ate_against_per_frame(runs):
    (rc, nc, _), (rf, nf, _) = _ate(runs["chunked"], runs["seq"]), _ate(runs["per_frame"], runs["seq"])
    assert nc == nf >= 30
    assert rc < max(0.08, 2.5 * rf + 0.02), (rc, rf)


def test_chunked_scale_within_10_percent(runs):
    _, _, s = _ate(runs["chunked"], runs["seq"])
    assert abs(s - 1.0) < 0.10, s


def test_chunked_keyframes_against_per_frame(runs):
    c, f = runs["chunked"], runs["per_frame"]
    assert c.state == tsys.OK and c.n_kf >= f.n_kf - 2 and c.bad_imu_resets == 0
    assert len(c.get_trajectory()) == len(f.get_trajectory())


def test_chunks_ran_on_the_runner(runs):
    # two chunks of 8: 16 step runs, a keyframe body per keyframe inserted
    c = runs["chunked"]
    r = c._vi_runner
    steps = sum(v for k, v in r.runs.items() if isinstance(k, tuple))
    assert steps == 2 * CHUNK and not r.graphs
    assert r.runs["kf_insert"] == r.runs["kf_ba"] == r.runs["kf_end"] >= 2


# ---- (c) the host mirror of the keyframe IMU blocks ----
def test_host_imu_mirror_equals_device_blocks(runs):
    # every slot up to the last chunk's keyframes: those before the chunks
    # were uploaded from the mirror, the chunks' own were mirrored back
    c = runs["chunked"]
    dev = c._vi_runner.carry().st.kf_blk.numpy()
    assert c.n_kf_chunks > runs["snap"].n_kf
    for k in range(1, c.n_kf_chunks):
        host = np.concatenate([c.kf_imu_acc[k], c.kf_imu_gyro[k], c.kf_imu_dts[k][:, None]], axis=-1)
        np.testing.assert_array_equal(host, dev[k], err_msg=f"keyframe {k}")
        assert (c.kf_imu_dts[k] > 0).any(), f"keyframe {k} has an empty block"


def test_keyframe_blocks_span_their_edges(runs):
    # each chunk keyframe's block integrates exactly the time since the
    # previous keyframe
    c = runs["chunked"]
    kts = c.map.kf_ts.numpy()
    for k in range(runs["snap"].n_kf, c.n_kf):
        np.testing.assert_allclose(c.kf_imu_dts[k].sum(), kts[k] - kts[k - 1], atol=1e-4)


# ---- (d) blackout mid-chunk ----
def test_blackout_hands_off_to_recently_lost(runs):
    b = runs["blackout"]
    # the chunk stopped at the first blank frame and the per-frame path
    # replayed it and the frames after it
    assert b["calls"] == [float(t) for t in b["tail"]]
    assert b["state_after"] in (tsys.RECENTLY_LOST, tsys.OK)


def test_blackout_counts_no_imu_sample_twice(runs):
    b = runs["blackout"]["slam"]
    ts = [e[0] for e in b._imu_history]
    assert len(ts) == len(set(ts))
    kts = b.map.kf_ts.numpy()
    for k in range(runs["snap"].n_kf, b.n_kf):
        np.testing.assert_allclose(b.kf_imu_dts[k].sum(), kts[k] - kts[k - 1], atol=1e-4)


def test_blackout_recovers(runs):
    # tracking recovers and the chunks after it run again: the 4 steps of
    # the cut chunk (frames 0..3) and at least one whole chunk after it
    b = runs["blackout"]["slam"]
    assert b.state == tsys.OK and b.bad_imu_resets == 0
    steps = sum(v for k, v in b._vi_runner.runs.items() if isinstance(k, tuple))
    assert steps >= 4 + CHUNK, steps


# ---- (e) the gate ----
def test_gate_before_stage_3_runs_per_frame(runs):
    seq, imu, stack = runs["seq"], runs["imu"], runs["stack"]
    slam = tis.InertialSlam(cam_params=seq.cam_params, calib=torch_calib(make_calib(freq=100.0)),
                            device="cpu", **SLAM_KW)
    slam.process_frames((stack, 0), seq.timestamps[0:4], **_kw(imu, 0, 4))
    assert slam._vi_runner is None and slam.frame_id == 4 and slam.imu_stage == 0


def test_gate_with_a_list_of_images_runs_per_frame(runs):
    seq, imu, i = runs["seq"], runs["imu"], runs["i0"]
    slam = copy.deepcopy(runs["snap"])
    assert slam._vi_chunkable()
    slam.process_frames([seq.images[i], seq.images[i + 1]], seq.timestamps[i : i + 2], **_kw(imu, i, 2))
    assert slam._vi_runner is None and slam.frame_id == runs["snap"].frame_id + 2


def test_without_imu_an_inertial_slam_runs_per_frame(runs):
    # Without IMU samples, MonoSlam.process_frames: its chunk gate keeps an
    # InertialSlam (its own local BA) per frame, as in the JAX package.
    slam, i = copy.deepcopy(runs["snap"]), runs["i0"]
    assert not slam._chunkable()
    slam.process_frames((runs["stack"], i), runs["seq"].timestamps[i : i + 2])
    assert slam._mono_runner is None and slam._vi_runner is None
    assert slam.frame_id == runs["snap"].frame_id + 2 and slam.state == tsys.OK


# ---- (f) the chunk's keyframe rule, after tests/test_need_keyframe.py ----
RULE = dict(K_cap=8, kf_every=10, kf_min_inliers=60, kf_ref_ratio=0.5)
RULE_CASES = {  # (ok, n_vis, since, ref_inl, n_kf, rule overrides) -> need_kf
    "ratio_fires_on_relative_sag": [((1, 200, 3, 300, 4, {}), False), ((1, 140, 3, 300, 4, {}), True)],
    "absolute_floor_still_fires": [((1, 140, 3, 300, 4, {"kf_ref_ratio": 0.0}), False),
                                   ((1, 50, 3, 300, 4, {"kf_ref_ratio": 0.0}), True)],
    # frame_step seeds an unseeded reference (-1) with the frame's own count
    "unseeded_reference_is_inert": [((1, 140, 3, 140, 4, {}), False)],
    "periodic_cadence": [((1, 290, 10, 300, 4, {}), True), ((1, 290, 9, 300, 4, {}), False)],
    "weak_waits_two_frames": [((1, 50, 1, 300, 4, {}), False), ((1, 50, 2, 300, 4, {}), True)],
    "never_at_capacity": [((1, 50, 10, 300, 8, {}), False)],
    "never_when_lost": [((0, 290, 10, 300, 4, {}), False)],
}


@pytest.mark.parametrize("name", list(RULE_CASES))
def test_keyframe_rule(name):
    for (ok, n_vis, since, ref_inl, n_kf, over), want in RULE_CASES[name]:
        i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
        got = tvdl.need_keyframe(torch.tensor(bool(ok)), i32(n_vis), i32(since), i32(ref_inl),
                                 i32(n_kf), **{**RULE, **over})
        assert bool(got) == want, (name, n_vis, since, want)


# ---- (g) the two pieces free of host reads, against the JAX package ----
def _rotations(n, seed):
    rng = np.random.default_rng(seed)
    return np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 1.0, (n, 3)).astype(np.float32))))


@pytest.mark.parametrize("eps", [0.0, 1e-6, 1e-4, 1e-2, 1e-1])
def test_normalize_rotation_matches_jax(eps):
    # The polar factor of the JAX package's SVD projection: 2e-6 (float32
    # round-off of either; measured <= 3e-7 against a float64 SVD).
    rng = np.random.default_rng(7)
    R = _rotations(500, 1) + eps * rng.normal(size=(500, 3, 3)).astype(np.float32)
    want = np.asarray(jlie.normalize_rotation(jnp.asarray(R)))
    got = tlie.normalize_rotation(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_normalize_rotation_of_long_products_matches_jax():
    # 300 small steps multiplied in float32 without normalizing, then one
    # projection: the drift an LM loop would accumulate.
    steps = np.asarray(jlie.so3_exp(jnp.asarray(
        np.random.default_rng(3).normal(0, 0.05, (300, 3)).astype(np.float32))))
    R = np.eye(3, dtype=np.float32)
    for S in steps:
        R = (R @ S).astype(np.float32)
    want = np.asarray(jlie.normalize_rotation(jnp.asarray(R)))
    got = tlie.normalize_rotation(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)
    np.testing.assert_allclose(got @ got.T, np.eye(3), atol=2e-6)


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_normalize_rotation_of_a_non_finite_input_is_nan(bad):
    R = np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))
    R[1, 0, 1] = bad
    got = tlie.normalize_rotation(torch.from_numpy(R)).numpy()
    assert np.isnan(got[1]).all() and np.isfinite(got[0]).all()
    assert np.isnan(np.asarray(jlie.normalize_rotation(jnp.asarray(R)))[1]).all()


def _dlt64(r1, r2, R21, t21):
    """The DLT in float64 (numpy eigh): the reference both are held to."""
    P2 = np.concatenate([R21, t21[:, None]], axis=1)
    z, o = np.zeros(len(r1)), np.ones(len(r1))
    A = np.stack([np.stack([o, z, -r1[:, 0], z], -1), np.stack([z, o, -r1[:, 1], z], -1),
                  r2[:, 0:1] * P2[2] - P2[0], r2[:, 1:2] * P2[2] - P2[1]], axis=1)
    h = np.linalg.eigh(np.swapaxes(A, 1, 2) @ A)[1][:, :, 0]
    return h[:, :3] / h[:, 3:4]


@pytest.mark.parametrize("baseline", [0.3, 0.15, 0.08])
def test_triangulation_matches_jax(baseline):
    # Points 2-8 m away seen from two cameras ``baseline`` apart with
    # quarter-pixel noise. Where the parallax passes triangulate_with_ref's
    # gate (cos < 0.9998), the two packages agree to
    # test_torch_mapping.py's DLT bound, 5e-3 relative for 99% of the
    # points; over all points the port is at least as close to the float64
    # DLT as the JAX package's float32 eigh (measured at 0.05 m: median
    # 9e-6 against 1.3e-4).
    rng = np.random.default_rng(11)
    n = 2000
    X = np.c_[rng.uniform(-2, 2, (n, 2)), rng.uniform(2, 8, n)]
    R21 = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 0.05, 3).astype(np.float32))), np.float64)
    t21 = np.array([-baseline, 0.01, 0.0])
    X2 = X @ R21.T + t21
    r1, r2 = X / X[:, 2:], X2 / X2[:, 2:]
    r1[:, :2] += rng.normal(size=(n, 2)) / 1600
    r2[:, :2] += rng.normal(size=(n, 2)) / 1600
    args = [a.astype(np.float32) for a in (r1, r2, R21, t21)]
    want = np.asarray(jtri.triangulate_dlt(*(jnp.asarray(a) for a in args)))
    got = ttri.triangulate_dlt(*(torch.from_numpy(a) for a in args)).numpy()
    exact = _dlt64(*(a.astype(np.float64) for a in args))
    assert np.isfinite(got).all()

    def rel(a, b):
        return np.linalg.norm(a - b, axis=1) / np.linalg.norm(b, axis=1)

    C2 = -R21.T @ t21
    cospar = np.sum(X * (X - C2), 1) / np.linalg.norm(X, axis=1) / np.linalg.norm(X - C2, axis=1)
    gated = cospar < 0.9998
    assert gated.sum() > 100
    assert np.quantile(rel(got, want)[gated], 0.99) <= 5e-3
    assert np.median(rel(got, exact)) <= np.median(rel(want, exact))
