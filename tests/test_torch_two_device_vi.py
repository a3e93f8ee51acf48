"""The two-device split of the port's ``InertialSlam`` (``devices=
(track_device, map_device)``) on the CPU against the same run on one
device: a short mono-inertial run on ``tests/vi_sim.py``'s calibration,
long enough for the IMU initialization and its second stage, so that the
replica is refreshed after keyframes and after each initialization stage
and the 15-dof frames track against it. Both runs share one extraction per
frame (see ``test_torch_two_device.py``)."""

import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu_torch.models import inertial_system as tis
from orb_slam3_ros_tpu_torch.models import system as tsys
from orb_slam3_ros_tpu_torch.models import tracking
from orb_slam3_ros_tpu_torch.ops import orb
from orb_slam3_ros_tpu_torch.utils import synth
from orb_slam3_ros_tpu_torch.utils.evaluate_ate import ate_rmse
from test_torch_two_device import TRACK, SharedExtraction
from torch_parity import torch_calib
from vi_sim import make_calib

torch.set_num_threads(1)
N_FRAMES, N_SKIP = 22, 8  # the first keyframes are pre-metric
SEQ_KW = dict(n_frames=N_FRAMES, height=240, width=376, frame_dt=0.1, imu_per_frame=10, seed=0,
              bg=np.array([0.01, -0.015, 0.02]), noise_g=1e-4, noise_a=1e-3)
SLAM_KW = dict(height=240, width=376, n_features=800, max_keyframes=32, max_points=4096,
               kf_every=3, init_after_kf=4, track_cap=512)


def run(seq, imu, devices, mp):
    kw = dict(devices=devices) if devices else dict(device="cpu")
    slam = tis.InertialSlam(cam_params=seq.cam_params, calib=torch_calib(make_calib(freq=100.0)),
                            **SLAM_KW, **kw)
    reads, stages = [], []
    timed_stage = slam._timed_stage

    def counted_stage(stage, fn, **k):
        stages.append(stage)
        return timed_stage(stage, fn, **k)

    def probe(m, *a, **k):
        # a frame tracks the frame or the VI frame program's copy of the
        # map: where that copy was made from
        src = m.pt_X
        for prog in (slam._frame_prog, slam._vi_prog):
            if prog is not None and src is prog.buf["pt_X"]:
                src = prog._map_src["pt_X"][0]
        reads.append((slam.imu_initialized, slam._replica is not None
                      and any(src is b.pt_X for b in slam._replica._bufs)))
        return TRACK(m, *a, **k)

    mp.setattr(tracking, "track_against_map", probe)
    slam._timed_stage = counted_stage
    for i in range(N_FRAMES):
        slam.process_frame(seq.images[i], float(seq.timestamps[i]), acc=imu["acc"][i],
                           gyro=imu["gyro"][i], dts=imu["dts"][i])
    traj = slam.get_trajectory()
    ts = np.asarray([t for t, _ in traj])[N_SKIP:]
    est = np.stack([T[:3, 3] for _, T in traj])[N_SKIP:]
    metric, n, _ = ate_rmse(ts, est, seq.timestamps.astype(np.float64), seq.t_wc,
                            with_scale=False)
    return dict(slam=slam, metric=metric, n=n, reads=reads, stages=stages)


@pytest.fixture(scope="module")
def runs():
    seq, imu = synth.make_vi_sequence(**SEQ_KW, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(orb, "extract", SharedExtraction())
        split = run(seq, imu, ("cpu", "cpu"), mp)
        single = run(seq, imu, None, mp)
    return dict(split=split, single=single)


def test_split_initializes_the_imu_and_matches_one_device(runs):
    split, single = runs["split"], runs["single"]
    for r in (split, single):
        assert r["slam"].state == tsys.OK and r["slam"].imu_initialized
        assert r["slam"].imu_stage >= 2 and r["slam"].bad_imu_resets == 0
    assert split["n"] == single["n"] >= N_FRAMES - N_SKIP - 4
    assert split["metric"] <= 2.0 * single["metric"], (split["metric"], single["metric"])
    assert split["metric"] == single["metric"]  # on the CPU a refresh lands at once


def test_vi_frames_track_against_the_replica(runs):
    reads = runs["split"]["reads"]
    assert sum(vi for vi, _ in reads) >= 5  # 15-dof frames after the IMU initialization
    assert all(on_replica for _, on_replica in reads)
    assert not any(on_replica for _, on_replica in runs["single"]["reads"])


def test_replica_refreshed_after_keyframes_and_initialization_stages(runs):
    split = runs["split"]
    slam = split["slam"]
    c = slam._replica.counts
    assert c["copies"] == slam.n_kf - 2  # every keyframe after the initial two
    # the two-view initialization and each IMU initialization stage run (a
    # stage-1 solve that leaves the IMU uninitialized is tried again)
    assert set(split["stages"]) == {1, 2}
    assert c["syncs"] == 1 + len(split["stages"])
    # a stage right after its keyframe's refresh adopts that refresh first
    assert c["forced"] == len(split["stages"])
    assert c["stale_frames"] == 0 and c["adopted"] == c["copies"]
    assert not slam._vi_chunkable()
