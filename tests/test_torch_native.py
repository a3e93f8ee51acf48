"""The port's measurement-sync binding (``native.py``) against the JAX
package's, the host-compiler build of ``utils/kernel_build.py``, and
``run_synth --native-feed`` against the plain per-frame loop.

``tests/test_native.py``'s cases (bundle pairing, rgb -> gray, ring
overflow, a threaded producer) go through both bindings with the same
pushes and must give equal bundles: exact, but for the grey of a colour
frame, within 1 ulp (rtol 2.4e-7): the JAX package loads the committed
library, built with ``-march=native``, whose weighted sum contracts into
FMAs; the port builds without it. The port
builds the library from ``native/measurement_sync.cpp`` with g++ into its
``_build/``; the native feed's trajectory equals, bit for bit, the plain
loop's on the same frames cast to uint8 (what the feed carries).
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.native import MeasurementSync as JaxSync
from orb_slam3_ros_tpu_torch import native as tnative
from orb_slam3_ros_tpu_torch import run_synth
from orb_slam3_ros_tpu_torch.utils import kernel_build

torch.set_num_threads(1)
BINDINGS = {"jax": JaxSync, "torch": tnative.MeasurementSync}


def _drain(ms):
    got = []
    while (b := ms.pop_bundle()) is not None:
        got.append(b)
    return got


def _pairing(cls):
    rng = np.random.default_rng(0)
    ms = cls(height=8, width=10)
    imgs = [rng.integers(0, 255, (8, 10)).astype(np.uint8) for _ in range(3)]
    for k in range(35):
        ms.push_imu(0.005 + k * 0.01, np.full(3, k, np.float32), np.full(3, -k, np.float32))
    for i, im in enumerate(imgs):
        ms.push_frame(0.1 * (i + 1), im)
    return _drain(ms)


def _rgb(cls):
    rng = np.random.default_rng(1)
    ms = cls(height=4, width=4)
    ms.push_imu(0.05, np.zeros(3), np.zeros(3))
    ms.push_frame(0.1, rng.integers(0, 255, (4, 4, 3)).astype(np.uint8))
    ms.push_frame(0.2, rng.uniform(-20, 300, (4, 4)))  # float input: clipped and cast
    ms.push_imu(0.25, np.ones(3), np.ones(3))  # releases the second frame
    return _drain(ms)


def _overflow(cls):
    ms = cls(height=2, width=2, frame_cap_log2=2)  # 4 slots
    pushed = [ms.push_frame(0.1 * i, np.full((2, 2), i, np.uint8)) for i in range(8)]
    return [pushed, ms.n_frames, ms.n_imu] + _drain(ms)


def _threaded(cls):
    ms = cls(height=16, width=16)
    n_frames = 40

    def produce():
        for i in range(n_frames):
            t = 0.02 * (i + 1)
            for k in range(4):
                ms.push_imu(t - 0.02 + 0.005 * (k + 1), np.full(3, i, np.float32), np.zeros(3))
            while not ms.push_frame(t, np.full((16, 16), i, np.uint8)):
                time.sleep(0.0005)

    th = threading.Thread(target=produce)
    th.start()
    got, deadline = [], time.time() + 10
    while len(got) < n_frames and time.time() < deadline:
        b = ms.pop_bundle()
        if b is None:
            time.sleep(0.0002)
            continue
        got.append(b)
    th.join(timeout=10)
    return got


def _same(a, b, rtol):
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y, rtol)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=rtol, atol=0)
    else:
        assert a == b


@pytest.mark.parametrize("case,rtol", [(_pairing, 0), (_rgb, 2.4e-7), (_overflow, 0),
                                       (_threaded, 0)],
                         ids=["pairing", "rgb_to_gray", "ring_overflow", "threaded_producer"])
def test_bundles_equal_jax(case, rtol):
    want, got = case(BINDINGS["jax"]), case(BINDINGS["torch"])
    assert len(got) >= 2
    _same(got, want, rtol)


def test_host_build_reuses_the_first_build(tmp_path, monkeypatch):
    # A fresh build root: the first call compiles (build.log written), the
    # second finds the library by its hash and does not run the compiler.
    monkeypatch.setattr(kernel_build, "BUILD_ROOT", tmp_path)
    lib, d = kernel_build.build_host_library("measurement_sync", [tnative.SOURCE])
    log = (d / "build.log").read_text()
    assert "g++" in log.splitlines()[0] and "-march" not in log
    assert d.parent == tmp_path and (d / "libmeasurement_sync.so").is_file()
    calls = []
    monkeypatch.setattr(kernel_build, "find_host_compiler", lambda: calls.append(1) or "g++")
    lib2, d2 = kernel_build.build_host_library("measurement_sync", [tnative.SOURCE])
    assert d2 == d and calls == [] and lib2.msync_create
    assert not (tnative.SOURCE.parent / "libmeasurement_sync.so").samefile(d / "libmeasurement_sync.so")


def test_failed_host_build_raises_with_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(kernel_build, "BUILD_ROOT", tmp_path)
    bad = tmp_path / "bad.cpp"
    bad.write_text("int broken( {\n")
    with pytest.raises(RuntimeError, match="bad.cpp"):
        kernel_build.build_host_library("bad", [bad])


def test_native_feed_equals_the_plain_loop(tmp_path, capsys):
    argv = ["--device", "cpu", "--frames", "8", "--features", "800", "--json"]
    rc = run_synth.main(argv + ["--native-feed", "--save-traj", str(tmp_path / "n.txt")])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc in (0, 1) and summary["native_feed"]["push_waits"] >= 0
    # the plain loop on the same frames as the feed carries them (uint8)
    args = run_synth.parse_args(argv)
    from orb_slam3_ros_tpu_torch.models.system import MonoSlam
    from orb_slam3_ros_tpu_torch.utils import synth, trajectory

    seq = synth.make_sequence(n_frames=8, height=240, width=376, dt=0.1, seed=3, device="cpu")
    slam = MonoSlam(height=240, width=376, cam_params=seq.cam_params, n_features=800,
                    max_keyframes=64, max_points=8192, device="cpu")
    frames = np.clip(seq.images.numpy(), 0, 255).astype(np.uint8).astype(np.float32)
    for i in range(args.frames):
        slam.process_frame(frames[i], float(seq.timestamps[i]))
    trajectory.save_tum(str(tmp_path / "p.txt"), slam.trajectory)
    assert summary["tracked"] == len(slam.trajectory) >= 5
    assert (tmp_path / "n.txt").read_text() == (tmp_path / "p.txt").read_text()


class _SlowSlam:
    """Stands in for a system in ``run_synth._native_replay``: tracks each
    frame in 2 ms and keeps what it was given."""

    def __init__(self):
        self.got = []

    def process_frame(self, gray, ts):
        time.sleep(0.002)
        self.got.append((ts, gray))
        return ts


def test_native_replay_waits_for_a_free_slot():
    # A 2-frame ring and a SLAM thread slower than the producer: the
    # producer waits on its semaphore (no refused push, no retry) and every
    # frame arrives once, in order, as pushed.
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 255, (12, 6, 5)).astype(np.uint8)
    tss = 0.1 * np.arange(1, 13)
    ms = tnative.MeasurementSync(height=6, width=5, frame_cap_log2=1)
    polls = []
    slam = _SlowSlam()
    tracked, waits = run_synth._native_replay(slam, ms, imgs, tss, lambda: polls.append(1))
    ms.close()
    assert tracked == len(polls) == 12 and waits["push_waits"] >= 1 and waits["push_wait_s"] > 0
    assert [t for t, _ in slam.got] == tss.tolist()
    for (_, g), im in zip(slam.got, imgs):
        np.testing.assert_array_equal(g, im.astype(np.float32))


def test_native_replay_raises_a_refused_push():
    class Refusing:
        frame_capacity = 4

        def push_imu(self, ts, acc, gyro):
            return True

        def push_frame(self, ts, img):
            return False

    with pytest.raises(RuntimeError, match="refused frame 0"):
        run_synth._native_replay(_SlowSlam(), Refusing(), np.zeros((3, 2, 2), np.uint8),
                                 np.arange(3.0), lambda: None)
