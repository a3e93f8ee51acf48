"""The port's control socket (``utils/control.py``) on a port ``MonoSlam``
on the CPU at 240x376 over 12 frames, against the JAX server's replies.

- ``status`` gives the JAX server's keys; ``save_traj`` writes the bytes
  the JAX package's ``trajectory.save_*`` writes for the same trajectory;
  ``save_map`` writes a session that both packages' ``load_atlas`` load;
  ``localization_mode`` toggles; ``subscribe`` receives the frame events.
- A subscriber that never reads does not stall the SLAM thread: 50
  ``_publish`` calls of 64 KiB events, which fill its socket's buffer,
  take under 1 s while another subscriber receives them all; past its
  queue (``QUEUE_LINES``) it is dropped.

Every socket wait has its own short timeout (5 s; ``tests/test_control.py``
waits 60 s, which a loaded host can exceed).
"""

import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.models.system import MonoSlam as JaxSlam
from orb_slam3_ros_tpu.utils import checkpoint as jck
from orb_slam3_ros_tpu.utils import control as jctl
from orb_slam3_ros_tpu.utils import trajectory as jtraj
from orb_slam3_ros_tpu_torch.models import system as tsys
from orb_slam3_ros_tpu_torch.utils import checkpoint as tck
from orb_slam3_ros_tpu_torch.utils import synth
from orb_slam3_ros_tpu_torch.utils import control
from orb_slam3_ros_tpu_torch.utils.control import ControlClient, ControlServer

torch.set_num_threads(1)
H, W, N = 240, 376, 12
KW = dict(height=H, width=W, n_features=800, max_keyframes=16, max_points=4096)
WAIT = 5.0


def _serve(server, fn):
    """Run ``fn`` (a client's blocking call) on a thread while this, the
    SLAM thread, polls the server; return its result."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except Exception as e:  # re-raised below, on the test's thread
            box["err"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    deadline = time.time() + WAIT
    while th.is_alive() and time.time() < deadline:
        server.poll()
        time.sleep(0.005)
    th.join(timeout=0.1)
    assert not th.is_alive(), "no reply in time"
    if "err" in box:
        raise box["err"]
    return box["out"]


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    d = tmp_path_factory.mktemp("control")
    seq = synth.make_sequence(n_frames=N, height=H, width=W, dt=0.1, seed=3, device="cpu")
    slam = tsys.MonoSlam(cam_params=seq.cam_params, device="cpu", pipelined=False, **KW)
    server = ControlServer(slam, str(d / "slam.sock"))
    sub = ControlClient(server.sock_path, timeout=WAIT)
    events = []

    def listen():
        try:
            for ev in sub.subscribe():
                events.append(ev)
        except (OSError, ValueError):
            pass

    threading.Thread(target=listen, daemon=True).start()
    deadline = time.time() + WAIT
    while not server._subscribers and time.time() < deadline:
        time.sleep(0.01)
    for i in range(N):
        slam.process_frame(seq.images[i], float(seq.timestamps[i]))
        server.poll()
    client = ControlClient(server.sock_path, timeout=WAIT)
    yield dict(slam=slam, server=server, client=client, events=events, dir=d, seq=seq)
    client.close()
    sub.close()
    server.close()


def test_status_has_the_jax_keys(session):
    slam, server, client = session["slam"], session["server"], session["client"]
    got = _serve(server, lambda: client.call("status"))
    cam = np.asarray([200, 200, 187.5, 119.5, 0, 0, 0, 0, 0], np.float32)
    jslam = JaxSlam(pipelined=False, cam_params=cam, **KW)
    want = jctl.ControlServer._execute(type("S", (), {"slam": jslam})(), {"cmd": "status"})
    assert set(got) == set(want)
    assert got["ok"] and got["state"] == tsys.OK and got["frame_id"] == N
    assert got["n_kf"] == slam.n_kf >= 2 and got["n_pts"] == slam.n_pts
    assert got["localization_only"] is False and got["n_closures"] == 0


@pytest.mark.parametrize("fmt", ["tum", "euroc", "kitti"])
def test_save_traj_writes_the_jax_bytes(session, fmt):
    slam, server, client = session["slam"], session["server"], session["client"]
    path = str(session["dir"] / f"traj.{fmt}")
    r = _serve(server, lambda: client.call("save_traj", path=path, format=fmt))
    traj = slam.get_trajectory()
    assert r == {"ok": True, "path": path, "n_poses": len(traj)} and len(traj) >= N - 3
    want = str(session["dir"] / f"want.{fmt}")
    getattr(jtraj, f"save_{fmt}")(want, traj)
    assert open(path, "rb").read() == open(want, "rb").read()


def test_unknown_format_and_command_are_refused(session):
    server, client = session["server"], session["client"]
    r = _serve(server, lambda: client.call("save_traj", path="x", format="bad"))
    assert r["ok"] is False and "unknown format" in r["error"]
    assert _serve(server, lambda: client.call("nope"))["ok"] is False


def test_save_map_loads_in_both_packages(session):
    slam, server, client = session["slam"], session["server"], session["client"]
    path = str(session["dir"] / "session")
    r = _serve(server, lambda: client.call("save_map", path=path))
    assert r["ok"] and len(r["md5"]) == 32
    kw = dict(cam_params=session["seq"].cam_params, **KW)
    t = tsys.MonoSlam(device="cpu", pipelined=False, **kw)
    tck.load_atlas(path, t)
    j = JaxSlam(pipelined=False, **kw)
    jck.load_atlas(path, j)
    assert t.n_kf == j.n_kf == slam.n_kf and t.n_pts == slam.n_pts
    np.testing.assert_array_equal(t.map.pt_X.numpy(), slam.map.pt_X.numpy())
    np.testing.assert_array_equal(np.asarray(j.map.kf_R), slam.map.kf_R.numpy())


def test_localization_mode_toggles(session):
    slam, server, client = session["slam"], session["server"], session["client"]
    assert _serve(server, lambda: client.call("localization_mode", on=True)) == {
        "ok": True, "localization_only": True}
    assert slam.localization_only
    assert _serve(server, lambda: client.call("localization_mode", on=False))[
        "localization_only"] is False
    assert not slam.localization_only and slam.last_kf_frame == slam.frame_id


def test_subscriber_receives_frame_events(session):
    evs, slam = session["events"], session["slam"]
    deadline = time.time() + WAIT
    n_frames = len(slam.trajectory) - 1  # the initializing frame emits no event
    while sum(e.get("event") == "frame" for e in evs) < n_frames and time.time() < deadline:
        time.sleep(0.01)
    frames = [e for e in evs if e.get("event") == "frame"]
    assert len(frames) == n_frames
    assert [e["ts"] for e in frames] == [ts for ts, _ in slam.trajectory[1:]]
    assert all(len(e["Twc"]) == 4 and e["state"] == tsys.OK for e in frames)
    assert any(e.get("event") == "keyframe" for e in evs)


def test_a_subscriber_that_never_reads_does_not_stall_publishing(tmp_path):
    slam = type("S", (), {"on_frame": None})()
    server = ControlServer(slam, str(tmp_path / "s.sock"))
    try:
        stuck = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        stuck.settimeout(WAIT)
        stuck.connect(server.sock_path)
        stuck.sendall(b'{"cmd": "subscribe"}\n')  # and never reads again
        reader = ControlClient(server.sock_path, timeout=WAIT)
        got = []

        def read():
            for e in reader.subscribe():
                got.append(e)
                if len(got) == 50:
                    return

        th = threading.Thread(target=read, daemon=True)
        th.start()
        deadline = time.time() + WAIT
        while len(server._subscribers) < 2 and time.time() < deadline:
            time.sleep(0.01)
        assert len(server._subscribers) == 2
        # 50 events of 64 KiB: the stuck socket's buffer fills after a few,
        # its writer thread blocks, the SLAM thread does not
        ev = dict(event="frame", ts=0.0, Twc=np.eye(4, dtype=np.float32), n_inliers=100,
                  state=1, n_kf=3, pad="x" * 65536)
        t0 = time.perf_counter()
        for i in range(50):
            slam.on_frame({**ev, "ts": float(i)})
        spent = time.perf_counter() - t0
        assert spent < 1.0, spent
        th.join(timeout=WAIT)
        assert [e["ts"] for e in got] == [float(i) for i in range(50)]
        assert server.dropped == 0
        # past its queue the stuck subscriber is dropped; publishing goes on
        reader.close()
        t0 = time.perf_counter()
        for i in range(control.QUEUE_LINES + 50):
            slam.on_frame({**ev, "ts": float(50 + i)})
        assert time.perf_counter() - t0 < 4.0
        assert server.dropped >= 1 and len(server._subscribers) <= 1
        stuck.close()
    finally:
        server.close()


def test_run_synth_serves_the_socket_between_frames(tmp_path, capsys):
    from orb_slam3_ros_tpu_torch import run_synth

    sock = str(tmp_path / "cli.sock")
    box = {}

    def client():
        deadline = time.time() + 60
        while not os.path.exists(sock) and time.time() < deadline:
            time.sleep(0.02)
        c = ControlClient(sock, timeout=WAIT)
        box["status"] = c.call("status")
        c.close()

    th = threading.Thread(target=client, daemon=True)
    th.start()
    rc = run_synth.main(["--device", "cpu", "--frames", "8", "--features", "800",
                         "--control", sock, "--json"])
    th.join(timeout=WAIT)
    assert not th.is_alive() and rc in (0, 1)
    st = box["status"]
    assert st["ok"] and 0 < st["frame_id"] <= 8 and not os.path.exists(sock)
