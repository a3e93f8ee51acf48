"""``tests/test_device_loop.py``'s last two cases on the port: ``track_cap``
quality, and a blackout in a chunk, which now must relocalize. The setup
and the run are ``tests/test_torch_mono_chunk_loop.py``'s (``_run``). The
blackout case sets ``lean_after_kf`` 4 as the other cases do (the JAX test
keeps the default 12, under which its 40 frames never reach the chunk
gate), so that the chunk holding the blackout hands its dead tail to
relocalization. The JAX package recovers at the first good frame after the
same blackout at ``bench.py``'s protocol (``scripts/reloc_blackout.py``).
"""

import numpy as np
import pytest

from orb_slam3_ros_tpu_torch.models import system as tsys
from test_torch_mono_chunk_loop import CHUNK, DARK, N, _run, _sequence


@pytest.fixture(scope="module")
def runs():
    seq = _sequence()
    dark = seq.images.clone()
    dark[DARK[0] : DARK[1]] = 0.0
    return dict(capped=_run(seq, True, track_cap=2048), blackout=_run(seq, True, images=dark))


def test_track_cap_quality(runs):
    rmse, nm, _, _, _ = runs["capped"]
    assert nm >= N - 5
    assert rmse < 0.06, rmse


def test_blackout_hands_off_and_relocalizes(runs):
    rmse, nm, slam, per_frame, relocs = runs["blackout"]
    # the chunk stopped at the first dark frame; it and the rest of its
    # chunk went through the per-frame path, the dark ones failing to
    # relocalize and the first good frame after them succeeding
    assert all(f in per_frame for f in range(DARK[0], DARK[1] + 1)), per_frame
    assert relocs == [(f, f == DARK[1]) for f in range(DARK[0], DARK[1] + 1)], relocs
    assert slam.state == tsys.OK and slam.n_kf >= 4


def test_blackout_keeps_the_trajectory(runs):
    rmse, nm, slam, _, _ = runs["blackout"]
    traj = slam.get_trajectory()
    est = np.stack([T[:3, 3] for _, T in traj])
    assert np.isfinite(est).all()
    posed = {int(round(t / 0.1)) for t, _ in traj}
    assert posed.isdisjoint(range(*DARK)) and set(range(DARK[1], N)) <= posed
    # every frame posed but the two-view reference frame(s) and the dark ones
    assert nm >= N - (DARK[1] - DARK[0]) - 2 and rmse < 0.05, (nm, rmse)


def test_blackout_chunks_resume_after_relocalization(runs):
    # after the recovery the next chunks run on the chunk loop again: only
    # the frames before the gate and the rest of the dark chunk went per frame
    _, _, slam, per_frame, _ = runs["blackout"]
    assert max(per_frame) < DARK[0] + CHUNK
    steps = sum(v for k, v in slam._mono_runner.runs.items() if isinstance(k, tuple))
    assert steps + len(per_frame) == N + 1  # the dark frame ran in both
