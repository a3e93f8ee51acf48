"""The port's mapping options that the end-to-end test leaves at their
defaults: keyframe-slot recycling at capacity (the shape of
``test_compaction.py::TestLongRunNoStall`` at a small size: with 8 slots,
mapping goes on past the capacity by culling or evicting a keyframe and
compacting the slots, without a stall or a lost frame), the temporal
local-BA window and ``track_window``."""

import numpy as np
import torch

from orb_slam3_ros_tpu_torch.models import system as tsys
from orb_slam3_ros_tpu_torch.utils import synth

torch.set_num_threads(1)

N_FRAMES, K_CAP = 50, 8


def test_keyframes_recycle_at_capacity():
    seq = synth.make_sequence(n_frames=N_FRAMES, height=240, width=376, dt=0.1, seed=3, device="cpu")
    slam = tsys.MonoSlam(
        device="cpu", pipelined=False,
        height=240, width=376, cam_params=seq.cam_params, n_features=1200,
        max_keyframes=K_CAP, max_points=4096,
    )
    kf_frames, n_kf_seen = [], set()
    for i in range(N_FRAMES):
        out = slam.process_frame(seq.images[i], float(seq.timestamps[i]))
        if slam.state == tsys.OK:
            assert out is not None and np.isfinite(out).all(), f"frame {i}"
        if slam.last_kf_frame == i and slam.state == tsys.OK:
            kf_frames.append(i)
        n_kf_seen.add(slam.n_kf)
        assert slam.n_kf <= K_CAP
    assert max(n_kf_seen) == K_CAP
    assert any(f >= N_FRAMES - 10 for f in kf_frames), kf_frames  # still mapping
    m = slam.map
    assert int(m.kf_valid.sum()) == slam.n_kf and bool(m.kf_valid[: slam.n_kf].all())
    assert int(m.pt_first_kf.max()) < slam.n_kf
    traj = slam.get_trajectory()
    assert len(traj) >= N_FRAMES - 4
    assert all(np.isfinite(T).all() for _, T in traj)


def test_temporal_window_options():
    # The JAX package's other local-BA window (covis_ba=False: the last
    # ba_window keyframes free, the ba_fixed before them fixed) and local
    # tracking of the points of the last track_window keyframes.
    seq = synth.make_sequence(n_frames=20, height=240, width=376, dt=0.1, seed=3, device="cpu")
    slam = tsys.MonoSlam(
        device="cpu", pipelined=False,
        height=240, width=376, cam_params=seq.cam_params, n_features=1200,
        max_keyframes=16, max_points=4096, kf_every=3, ba_window=2, ba_fixed=1,
        covis_ba=False, track_window=4,
    )
    outs = [slam.process_frame(seq.images[i], float(seq.timestamps[i])) for i in range(20)]
    assert slam.state == tsys.OK and slam.n_kf >= 5
    assert sum(o is not None for o in outs) >= 17
    assert all(n >= 1 for n in slam.ba_iters)
    assert all(np.isfinite(T).all() for _, T in slam.get_trajectory())
