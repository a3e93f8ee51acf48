"""``tests/test_device_loop.py``'s first two cases on the port (``MonoSlam``
through ``process_frames``, its chunk loop running eagerly on the CPU):
chunked against per frame, and the preloaded ``(stack, offset)`` window
against the list of frames; ``tests/test_torch_mono_chunk_blackout.py``
holds the other two. The setup is that file's: ``make_sequence(seed=3)``, 40
frames at 240x376, 1200 features, ``lean_after_kf`` 4, chunks of 8, and its
bounds; besides, ``track_cap`` 768 (``bench.py``'s): without a cap the plain
matcher searches all 4096 points on the CPU, 1.7x the time of a run.

The runs are made once, in the module's fixture, and each case reads them.
"""

import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu_torch.models import system as tsys
from orb_slam3_ros_tpu_torch.utils import synth as tsynth
from orb_slam3_ros_tpu_torch.utils.evaluate_ate import ate_rmse

torch.set_num_threads(1)
N, CHUNK, DARK = 40, 8, (20, 23)
SLAM_KW = dict(height=240, width=376, n_features=1200, max_keyframes=32, max_points=4096,
               pipelined=False, lean_after_kf=4, track_cap=768)


def _run(seq, chunked, preloaded=False, images=None, **kw):
    """``test_device_loop.py``'s ``_run`` on the port. Returns (rmse,
    matched poses, system, frames that went through ``process_frame``,
    relocalization calls as (frame, recovered))."""
    slam = tsys.MonoSlam(cam_params=seq.cam_params, device="cpu", **{**SLAM_KW, **kw})
    imgs = seq.images if images is None else images
    per_frame, relocs = [], []
    frame, reloc = slam.process_frame, slam._try_relocalize

    def counted(img, ts):
        per_frame.append(int(round(ts / 0.1)))
        return frame(img, ts)

    def logged(feats, ts):
        out = reloc(feats, ts)
        relocs.append((int(round(ts / 0.1)), out is not None))
        return out

    slam.process_frame, slam._try_relocalize = counted, logged
    i = 0
    if chunked:
        stack = torch.clamp(imgs, 0, 255).to(torch.uint8) if preloaded else None
        while slam.state != tsys.OK and i < N:
            slam.process_frame(imgs[i], float(seq.timestamps[i]))
            i += 1
        while i < N:
            j = min(i + CHUNK, N)
            if preloaded and j - i == CHUNK:
                slam.process_frames((stack, i), seq.timestamps[i:j])
            else:
                slam.process_frames([imgs[k] for k in range(i, j)], seq.timestamps[i:j])
            i = j
    else:
        for i in range(N):
            slam.process_frame(imgs[i], float(seq.timestamps[i]))
    slam.flush()
    traj = slam.get_trajectory()
    ts = np.asarray([t for t, _ in traj])
    est = np.stack([T[:3, 3] for _, T in traj])
    rmse, nm, _ = ate_rmse(ts, est, seq.timestamps.astype(np.float64), seq.t_wc)
    return rmse, nm, slam, per_frame, relocs


def _sequence():
    seq = tsynth.make_sequence(n_frames=N, height=240, width=376, dt=0.1, seed=3, device="cpu")
    assert np.allclose(seq.timestamps, 0.1 * np.arange(N))  # frame = round(ts / 0.1)
    return seq


@pytest.fixture(scope="module")
def runs():
    seq = _sequence()
    return dict(chunked=_run(seq, True), per_frame=_run(seq, False), preloaded=_run(seq, True, True))


def test_chunked_matches_per_frame(runs):
    rmse_c, nm_c, slam_c, per_frame, _ = runs["chunked"]
    rmse_f, nm_f, _, _, _ = runs["per_frame"]
    assert nm_c >= nm_f - 2
    assert rmse_c < max(1.5 * rmse_f, 0.05), (rmse_c, rmse_f)
    assert slam_c.n_kf >= 4
    # the chunk loop really ran: after the gate no frame went per frame
    steps = sum(v for k, v in slam_c._mono_runner.runs.items() if isinstance(k, tuple))
    assert steps + len(per_frame) == N and steps >= 2 * CHUNK, (steps, per_frame)


def test_preloaded_window_matches_list_path(runs):
    rmse_p, nm_p, slam_p, _, _ = runs["preloaded"]
    rmse_l, nm_l, _, _, _ = runs["chunked"]
    assert nm_p >= nm_l - 2
    assert rmse_p < max(1.5 * rmse_l, 0.05), (rmse_p, rmse_l)
    assert slam_p.n_kf >= 4
