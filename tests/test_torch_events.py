"""The ``on_frame`` / ``points_every`` events and the stage timer of the port's
systems against the JAX package's.

(a) Localization on a stored map, as ``test_torch_slice.py`` runs it (the
JAX package seeds the map from rendered depth at 240x376, both packages
load it and track frames 1..15 from frame 0's true pose) with
``points_every`` 4: the sequence of event kinds, ``ts``, ``state``,
``n_kf`` equal; ``Twc`` within the slice's 5 mm; the map_points and
kf_markers counts equal; tracked_points within 5% (the trackers' inlier
sets differ by a few points). Both packages track the same frames here;
in mapping their two-view initializations fire at different frames
(ROADMAP "Divergences"), so events are not compared pose by pose there.
The stage timer's keys and call counts equal the JAX run's.

(b) The port's chunk loop: from one mapping snapshot at the chunk gate
(keyframes by the periodic rule alone, as the weak-tracking bar reseeds at
a chunk's start), 8 frames per frame and the same 8 frames as one chunk
emit equal frame and keyframe events (kinds, ts, n_kf, kf_id; Twc within 1e-2 m, the
per-frame and chunk paths' BA forms differing by summation order: 4.5e-3 m
measured), and the
chunk emits its point events once, at its boundary, from one read.

(c) The inertial chunk's absorb emits the events of its rows (frame rows
alive, keyframe rows flagged), and the bad-IMU reset logs at NORMAL.

(d) ``run_synth --json``'s ``per_stage_ms`` keys equal the JAX CLI's on the
same flags.
"""

import contextlib
import copy
import io
import json

import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu import run_synth as jrun
from orb_slam3_ros_tpu.models.system import MonoSlam as JaxSlam
from orb_slam3_ros_tpu.utils import checkpoint as jckpt
from orb_slam3_ros_tpu.utils import synth as jsynth
from orb_slam3_ros_tpu_torch import run_synth as trun
from orb_slam3_ros_tpu_torch.models import inertial_system as tis
from orb_slam3_ros_tpu_torch.models import system as tsys
from orb_slam3_ros_tpu_torch.models.chunk_runner import ChunkOut
from orb_slam3_ros_tpu_torch.utils import obslog as tlog
from orb_slam3_ros_tpu_torch.utils import synth as tsynth
from torch_parity import jax_seed_map

torch.set_num_threads(1)
H, W, NF, N_FRAMES, KF_EVERY, EVERY = 240, 376, 500, 16, 6, 4
SLAM_KW = dict(height=H, width=W, n_features=NF, max_keyframes=64, max_points=4096,
               track_cap=768, lean_after_kf=4)


def _recorder():
    evs = []
    return evs, evs.append


@pytest.fixture(scope="module")
def localization(tmp_path_factory):
    seq = jsynth.make_sequence(n_frames=N_FRAMES, height=H, width=W, dt=0.1, seed=3,
                               with_depth=True)
    jslam = JaxSlam(cam_params=seq.cam_params, pipelined=False, points_every=EVERY, **SLAM_KW)
    m, n_kf, n_pts = jax_seed_map(seq, KF_EVERY, jslam)
    R0 = seq.R_wc[0].T
    counters = {"n_kf": n_kf, "n_pts": n_pts, "frame_id": 0, "state": 1,
                "R_cur": R0.tolist(), "t_cur": (-R0 @ seq.t_wc[0]).tolist()}
    path = str(tmp_path_factory.mktemp("events") / "map.npz")
    jckpt.save_map(path, m, counters)
    jckpt.load_system(path, jslam)
    tslam = tsys.MonoSlam(cam_params=seq.cam_params, points_every=EVERY, device="cpu",
                         pipelined=False, **SLAM_KW)
    tslam.load_map(path)
    out = {}
    for name, slam in (("jax", jslam), ("port", tslam)):
        evs, slam.on_frame = _recorder()
        slam.activate_localization_mode()
        for i in range(1, N_FRAMES):
            assert slam.process_frame(seq.images[i], float(seq.timestamps[i])) is not None
        out[name] = dict(events=evs, timing=slam.timing_summary())
    return out


def _key(ev):
    return tuple(ev.get(k) for k in ("event", "ts", "state", "n_kf", "kf_id"))


def test_event_sequence_equals_jax(localization):
    j, t = localization["jax"]["events"], localization["port"]["events"]
    assert [_key(e) for e in t] == [_key(e) for e in j]
    kinds = [e["event"] for e in t]
    assert kinds.count("frame") == N_FRAMES - 1
    # the point events every 4 frames, at frame ids 3, 7 and 11 of 0..14
    # (the JAX rule: the first at 4 frames after id -1)
    assert kinds.count("map_points") == kinds.count("kf_markers") == kinds.count(
        "tracked_points") == 3


def test_frame_poses_within_the_slice_tolerance(localization):
    def poses(evs):
        return np.stack([np.asarray(e["Twc"]) for e in evs if e["event"] == "frame"])

    pj, pt = poses(localization["jax"]["events"]), poses(localization["port"]["events"])
    assert pt.dtype == np.float32 and pt.shape == pj.shape
    np.testing.assert_allclose(pt[:, :3, 3], pj[:, :3, 3], atol=0.005)
    np.testing.assert_allclose(pt[:, :3, :3], pj[:, :3, :3], atol=0.005)


def test_point_events_equal_jax(localization):
    def of(evs, kind):
        return [e for e in evs if e["event"] == kind]

    j, t = localization["jax"]["events"], localization["port"]["events"]
    for kind, key in (("map_points", "points"), ("kf_markers", "centers")):
        for a, b in zip(of(t, kind), of(j, kind)):
            assert a["n"] == b["n"] and a[key].shape == (a["n"], 3)
            assert a[key].dtype == np.float32
            np.testing.assert_allclose(a[key], np.asarray(b[key]), atol=1e-4)
    for a, b in zip(of(t, "tracked_points"), of(j, "tracked_points")):
        assert abs(a["n"] - b["n"]) <= 0.05 * b["n"] and a["points"].shape == (a["n"], 3)
    assert all(isinstance(v, (int, float, np.ndarray)) for e in t for k, v in e.items()
               if k != "event")


def test_stage_timer_keys_and_counts_equal_jax(localization):
    j, t = localization["jax"]["timing"], localization["port"]["timing"]
    assert set(t) == set(j) == {"extract+track", "frame"}
    assert {k: v[2] for k, v in t.items()} == {k: v[2] for k, v in j.items()}
    assert all(v[2] == N_FRAMES - 1 and v[0] > 0 and v[1] >= 0 for v in t.values())


@pytest.fixture(scope="module")
def chunk_runs():
    seq = tsynth.make_sequence(n_frames=18, height=H, width=W, dt=0.1, seed=3, device="cpu")
    # keyframes by the periodic rule only (the weak-tracking rule's bar
    # reseeds at a chunk's start, by design in both packages)
    slam = tsys.MonoSlam(cam_params=seq.cam_params, device="cpu", n_features=800,
                         max_keyframes=32, max_points=4096, kf_every=3, kf_min_inliers=20,
                         kf_ref_ratio=0.0, lean_after_kf=3, track_cap=768, height=H, width=W,
                         points_every=EVERY, pipelined=False)
    i = 0
    while not slam._chunkable():
        slam.process_frame(seq.images[i], float(seq.timestamps[i]))
        i += 1
    timing = {k: v[2] for k, v in slam.timing_summary().items()}
    out = dict(i0=i, timing=timing, frames=i)
    for name in ("per_frame", "chunk"):
        s = copy.deepcopy(slam)
        evs, s.on_frame = _recorder()
        if name == "per_frame":
            for k in range(i, i + 8):
                s.process_frame(seq.images[k], float(seq.timestamps[k]))
        else:
            s.process_frames((seq.images, i), seq.timestamps[i : i + 8])
            out["runner"] = s._mono_runner is not None
        out[name] = dict(events=evs, n_kf=s.n_kf, traj=dict(s.trajectory),
                         timing={k: v[2] for k, v in s.timing_summary().items()})
    return out


def test_chunk_events_equal_per_frame(chunk_runs):
    assert chunk_runs["runner"]

    def core(evs):
        return [e for e in evs if e["event"] in ("frame", "keyframe")]

    a, b = core(chunk_runs["chunk"]["events"]), core(chunk_runs["per_frame"]["events"])
    # As in the JAX package: a chunk's frame event counts the keyframe its
    # frame made (the row's reference slot after the decision, plus one);
    # the per-frame path emits before it inserts one.
    kf_ts = {e["ts"] for e in b if e["event"] == "keyframe"}
    want = [_key(e)[:3] + ((e["n_kf"] + 1) if e["ts"] in kf_ts and e["event"] == "frame"
                           else e.get("n_kf"), e.get("kf_id")) for e in b]
    assert [_key(e) for e in a] == want
    assert sum(e["event"] == "keyframe" for e in a) >= 2
    assert chunk_runs["chunk"]["n_kf"] == chunk_runs["per_frame"]["n_kf"]
    traj = chunk_runs["chunk"]["traj"]
    for x, y in zip(a, b):
        if x["event"] == "frame":
            np.testing.assert_array_equal(x["Twc"], traj[x["ts"]])  # the chunk's logged pose
            np.testing.assert_allclose(x["Twc"][:3, 3], y["Twc"][:3, 3], atol=1e-2)


def test_chunk_point_events_at_its_boundary(chunk_runs):
    evs = chunk_runs["chunk"]["events"]
    kinds = [e["event"] for e in evs]
    last_ts = max(e["ts"] for e in evs if e["event"] == "frame")
    # one map_points / kf_markers pair, after the chunk's rows, at its last
    # frame; no tracked_points (a chunk reads no found mask)
    assert kinds[-2:] == ["map_points", "kf_markers"] and "tracked_points" not in kinds
    assert evs[-1]["ts"] == last_ts and evs[-1]["n"] == chunk_runs["chunk"]["n_kf"]


def test_stage_timer_counts_the_per_frame_calls(chunk_runs):
    # frames before tracking: "extract"; tracked frames: "extract+track";
    # all: "frame"; the chunk adds none (as the JAX package's chunk loop)
    t, i0 = chunk_runs["timing"], chunk_runs["frames"]
    assert set(t) == {"extract", "extract+track", "frame"}
    assert t["frame"] == i0 and t["extract"] + t["extract+track"] == i0
    assert chunk_runs["chunk"]["timing"] == t
    assert chunk_runs["per_frame"]["timing"]["extract+track"] == t["extract+track"] + 8


def test_inertial_chunk_rows_emit_their_events():
    cam = np.asarray([200, 200, 187.5, 119.5, 0, 0, 0, 0, 0], np.float32)
    f = 100.0
    calib = tis.imu_ops.ImuCalib(
        sigma_g=torch.full((3,), 1.7e-4 * f ** 0.5), sigma_a=torch.full((3,), 2e-3 * f ** 0.5),
        sigma_gw=torch.full((3,), 1.9e-5 / f ** 0.5), sigma_aw=torch.full((3,), 3e-3 / f ** 0.5),
        R_bc=torch.eye(3), t_bc=torch.zeros(3))
    slam = tis.InertialSlam(cam_params=cam, calib=calib, device="cpu", points_every=1, **SLAM_KW)
    evs, slam.on_frame = _recorder()
    C = 4
    R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    out = ChunkOut(R=R, t=np.zeros((C, 3), np.float32), R_cr=R, t_cr=np.zeros((C, 3), np.float32),
                   ref=np.asarray([5, 6, 6, 6]), n_inliers=np.asarray([90, 80, 70, 0]),
                   is_kf=np.asarray([False, True, False, False]),
                   alive=np.asarray([True, True, True, False]))
    tss = np.asarray([1.0, 1.1, 1.2, 1.3])
    blk = np.zeros((1, slam.imu_cap_frame * 0 + 1, 7), np.float32)
    slam._absorb_vi_chunk(out, R[0], np.zeros(3, np.float32), np.zeros(3, np.float32),
                          np.zeros(3, np.float32), np.zeros(3, np.float32),
                          np.asarray([7, 100, 9, 0, 80], np.float32), [6],
                          np.zeros((1, blk.shape[1], 7), np.float32), np.asarray([True]), tss)
    assert [(e["event"], e["ts"], e.get("n_kf"), e.get("kf_id")) for e in evs] == [
        ("frame", 1.0, 6, None), ("frame", 1.1, 7, None), ("keyframe", 1.1, None, 6),
        ("frame", 1.2, 7, None)]
    assert [e["n_inliers"] for e in evs if e["event"] == "frame"] == [90, 80, 70]
    assert all(e["state"] == tsys.OK for e in evs if e["event"] == "frame")
    # the bad-IMU reset logs at NORMAL
    sink, level = tlog._sink, tlog.get_level()
    buf = io.StringIO()
    tlog._sink = buf
    tlog.set_level(tlog.NORMAL)
    try:
        slam.v_cur = np.asarray([1e3, 0, 0], np.float32)
        assert slam._check_bad_imu()
    finally:
        tlog._sink, _ = sink, tlog.set_level(level)
    assert "bad IMU solve" in buf.getvalue() and "[orb-tpu normal]" in buf.getvalue()


def _cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_run_synth_stage_keys_equal_jax(monkeypatch):
    # Both CLIs' systems run in the pipelined one-frame-lag mode by default:
    # the stage names of each package's synchronous path are compared here,
    # the pipelined path's in tests/test_torch_pipelined.py.
    from orb_slam3_ros_tpu.models import system as jsys

    port_slam = tsys.MonoSlam
    monkeypatch.setattr(jsys, "MonoSlam",
                        lambda *a, **kw: JaxSlam(*a, pipelined=False, **kw))
    monkeypatch.setattr(tsys, "MonoSlam",
                        lambda *a, **kw: port_slam(*a, pipelined=False, **kw))
    argv = ["--frames", "6", "--features", "800", "--json"]
    want = _cli(jrun.main, argv + ["--platform", "cpu"])
    got = _cli(trun.main, argv + ["--device", "cpu"])
    assert set(got["per_stage_ms"]) == set(want["per_stage_ms"]) == {"extract", "extract+track",
                                                                     "frame"}
    assert set(got) == set(want)
