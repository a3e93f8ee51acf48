"""Writer wake-ups of the control socket a frame, on the CPU.

A stand-in SLAM thread emits phase 17's event mix (a frame event, the three
point events, a keyframe event every 8th frame) to a ``ControlServer`` and
calls ``poll()`` between frames; one subscriber reads in a second process.
Prints, for the tree's ``utils/control.py`` and for each other copy named
with ``--other`` (e.g. a parent commit's, from ``git show``), the
``sendall`` calls its writer threads made a frame (one a wake-up), the
lines the reader received, and the publishing thread's CPU seconds.
``--spin`` makes each frame's work a pure-Python loop that holds the
interpreter lock (a host-bound SLAM thread) instead of a sleep.

    python3 scripts/control_wakeups.py [--frames 200] [--spin] [--other OLD.py]
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READER = r"""
import socket, sys
s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
s.connect(sys.argv[1])
s.sendall(b'{"cmd": "subscribe"}\n')
print(sum(1 for _ in s.makefile("r")))
"""


def _load(path: str):
    spec = importlib.util.spec_from_file_location(f"control_{abs(hash(path))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Counting:
    """A socket whose ``sendall`` calls are counted."""

    def __init__(self, sock, counter: list):
        self._sock, self._counter = sock, counter

    def sendall(self, data):
        self._counter[0] += 1
        return self._sock.sendall(data)

    def __getattr__(self, name):
        return getattr(self._sock, name)


def run(path: str, frames: int, spin: bool) -> dict:
    ctl = _load(path)
    calls = [0]
    init = ctl._Conn.__init__
    ctl._Conn.__init__ = lambda self, sock: init(self, _Counting(sock, calls))
    slam = type("Slam", (), {"on_frame": None})()
    tmp = tempfile.mkdtemp(prefix="wakeups-")
    server = ctl.ControlServer(slam, os.path.join(tmp, "s.sock"))
    reader = subprocess.Popen([sys.executable, "-c", READER, server.sock_path],
                              stdout=subprocess.PIPE, text=True)
    while not server._subscribers:
        time.sleep(0.01)
    calls[0] = 0
    T = np.eye(4, dtype=np.float32)
    cpu0 = time.thread_time()
    for f in range(frames):
        slam.on_frame(dict(event="frame", ts=0.1 * f, Twc=T, n_inliers=345, state=1, n_kf=12))
        if spin:
            end = time.perf_counter() + 0.004
            while time.perf_counter() < end:
                pass
        else:
            time.sleep(0.004)
        if f % 8 == 0:
            slam.on_frame(dict(event="keyframe", ts=0.1 * f, kf_id=f))
        slam.on_frame(dict(event="map_points", ts=0.1 * f, n=2500, points=np.zeros(7500)))
        slam.on_frame(dict(event="kf_markers", ts=0.1 * f, n=16, centers=np.zeros(48)))
        slam.on_frame(dict(event="tracked_points", ts=0.1 * f, n=300, points=np.zeros(900)))
        server.poll()
    cpu = time.thread_time() - cpu0
    time.sleep(0.2)  # let the writers drain
    n_calls = calls[0]
    server.close()
    lines = int(reader.communicate(timeout=60)[0] or 0)
    return dict(sendall_a_frame=n_calls / frames, lines_received=lines,
                publishing_thread_cpu_s=round(cpu, 4), dropped=server.dropped)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--spin", action="store_true")
    ap.add_argument("--other", action="append", default=[])
    args = ap.parse_args(argv)
    tree = os.path.join(HERE, "orb_slam3_ros_tpu_torch", "utils", "control.py")
    for path in [tree] + args.other:
        print(path, run(path, args.frames, args.spin), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
