"""Phase 17's frame rates, repeated in one process on the card.

``chip_smoke.py`` phase 17 holds the control socket's run (b) to 90% of
the native feed's run (a). This script gives that ratio's spread, and
splits the gap to phase 7's plain loop by what each replay adds. It runs
phase 7 once, then ``--rounds`` rounds of the replays ``--kinds`` names,
each of phase 7's sequence and configuration through ``run_synth.run``
under the same instrumentation (``chip_smoke.SurfaceCounters``):

  plain   per frame, no events
  stream  per frame, the JSONL event stream, ``points_every`` 1, log level 1
  feed    phase 17 (a): ``stream`` fed by the native measurement sync
  server  ``feed`` with the control socket and no client
  socket  phase 17 (b): ``feed`` with the control socket and its clients
          (in a second process)

and prints each run's frames/s over the whole run, the steady rate that
phase 7 reports, the median frame rate, the host's speed over the run's
frames (``chip_smoke.HostProbe``, a second process) and the median rate
over it, which phase 17 (b) is held to, and the CPU seconds of the run's
process, of its SLAM thread and of the clients' process, and of the SLAM
thread inside the control server (publishing, ``poll``, each command);
per kind the mean, min and max;
and for each ``server`` or ``socket`` run its ratio to the mean of the
nearest ``feed`` runs before and after it, as phase 17 holds (b). First it measures how many lines of (b)'s event mix a
subscriber that never reads takes before the server drops it. Long output
goes to ``chiprun_out/surface_rates.json``.

Usage (on the card, from the repo root):
  python3 scripts/surface_rates.py [--rounds 3] [--kinds plain,stream,feed,socket,feed]
  python3 scripts/surface_rates.py --rounds 3 --kinds feed,server,socket,feed
"""

from __future__ import annotations

import argparse
import resource
import json
import os
import platform
import shutil
import socket
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
import numpy as np  # noqa: E402


def stuck_capacity() -> dict:
    """Lines of phase 17 (b)'s event mix (a frame event and three point
    events a frame) that a subscriber that never reads holds before the
    server drops it."""
    from orb_slam3_ros_tpu_torch.utils.control import ControlServer

    slam = type("S", (), {"on_frame": None})()
    d = tempfile.mkdtemp(prefix="stuck-")
    server = ControlServer(slam, os.path.join(d, "s.sock"))
    stuck = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    stuck.connect(server.sock_path)
    stuck.sendall(b'{"cmd": "subscribe"}\n')
    while not server._subscribers:
        time.sleep(0.01)
    sndbuf = server._subscribers[0].sock.getsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF)
    T = np.eye(4, dtype=np.float32) + np.float32(0.123456)
    n = 0
    while server.dropped == 0 and n < 20000:
        f = n // 4
        slam.on_frame([dict(event="frame", ts=0.1 * f, Twc=T, n_inliers=345, state=1, n_kf=12),
                       dict(event="map_points", ts=0.1 * f, n=2500, points=np.zeros(7500)),
                       dict(event="kf_markers", ts=0.1 * f, n=16, centers=np.zeros(48)),
                       dict(event="tracked_points", ts=0.1 * f, n=300, points=np.zeros(900))][n % 4])
        n += 1
        time.sleep(0.001)  # let the writer thread hand each line to the kernel
    out = dict(lines=n, dropped=server.dropped, server_sndbuf=sndbuf)
    stuck.close()
    server.close()
    shutil.rmtree(d)
    return out


class ServerClock:
    """The SLAM thread's CPU seconds and calls inside the control server
    (``ControlServer._publish``, ``poll`` and each command ``poll`` runs),
    for the replays with the socket; the server's own threads are not in
    it."""

    def __init__(self):
        from orb_slam3_ros_tpu_torch.utils import control

        self.cls, self.spent = control.ControlServer, {}
        self.orig = {n: getattr(self.cls, n) for n in ("_publish", "poll", "_execute")}

    def __enter__(self):
        spent = self.spent

        def clocked(name, fn):
            def run(server, arg=None, *a):
                key = f"cmd {arg.get('cmd')}" if name == "_execute" else name
                t0 = time.thread_time()
                try:
                    return fn(server, *((arg,) if arg is not None else ()), *a)
                finally:
                    n, sec = spent.get(key, (0, 0.0))
                    spent[key] = (n + 1, sec + time.thread_time() - t0)
            return run

        for name, fn in self.orig.items():
            setattr(self.cls, name, clocked(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.cls, name, fn)

    def report(self) -> dict:
        return {k: dict(calls=n, thread_cpu_s=round(sec, 4)) for k, (n, sec) in self.spent.items()}


def _cpu_of(ru) -> float:
    return ru.ru_utime + ru.ru_stime


def _cpu(who) -> float:
    """User + system CPU seconds of ``who`` (``resource.RUSAGE_*``)."""
    return _cpu_of(resource.getrusage(who))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--kinds", default="plain,stream,feed,socket,feed")
    args = ap.parse_args(argv)
    kinds = args.kinds.split(",")
    import torch

    from orb_slam3_ros_tpu_torch.ops import project_match

    cs.check(torch.cuda.is_available(), "no CUDA device: this script measures the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    print(f"host: {os.cpu_count()} CPUs, torch threads {torch.get_num_threads()}")
    wmem = open("/proc/sys/net/core/wmem_default").read().strip() \
        if os.path.exists("/proc/sys/net/core/wmem_default") else "unreadable"
    caps = stuck_capacity()
    print(f"kernel {platform.release()}, net.core.wmem_default {wmem}; a subscriber that never "
          f"reads: {caps}")
    project_match.build()
    mp, _ = cs.phase_mapping(torch, project_match)
    runs = []
    root = tempfile.mkdtemp(prefix="surface-rates-")
    try:
        with cs.HostProbe(os.path.join(root, "probe.txt")) as probe:
            for r in range(args.rounds):
                for k, kind in enumerate(kinds):
                    tmp = os.path.join(root, f"{kind}{r}-{k}")
                    os.makedirs(tmp)
                    argv_k = cs.surface_args(tmp, kind in ("server", "socket"))
                    if kind in ("plain", "stream"):
                        argv_k.remove("--native-feed")
                    if kind == "plain":
                        i = argv_k.index("--stream")
                        del argv_k[i:i + 4]  # --stream FILE --verbose 1
                    cpu0, thr0 = time.process_time(), time.thread_time()
                    kids0 = resource.getrusage(resource.RUSAGE_CHILDREN)
                    with ServerClock() as clock:
                        slam, _, summary, cnt, box = cs.surface_replay(project_match, tmp,
                                                                       kind == "socket", argv_k)
                    cnt.check_launches(kind)
                    run = dict(round=r, kind=kind, fps=summary["fps"], steady_fps=cnt.steady_fps(),
                               median_fps=cnt.median_fps(), tracked=summary["tracked"],
                               keyframes=slam.n_kf,
                               dropped=summary.get("control", {}).get("dropped"),
                               subscriber_frames=box.get("frame_events"),
                               per_stage_ms=summary["per_stage_ms"],
                               cpu_s=time.process_time() - cpu0, wall_s=summary["wall_s"],
                               slam_thread_cpu_s=time.thread_time() - thr0,
                               clients_cpu_s=_cpu(resource.RUSAGE_CHILDREN) - _cpu_of(kids0),
                               server_thread=clock.report(),
                               host_rate=probe.rate(*cnt.steady_window()))
                    run["per_rate"] = run["median_fps"] / run["host_rate"] * 1e6
                    print(json.dumps(run))
                    run["frame_ms"] = cnt.steady_ms()  # the JSON file only
                    runs.append(run)
    finally:
        shutil.rmtree(root)
    print(f"phase 7 (plain loop, no instrumentation): {mp['frames_per_s']:.3f} frames/s steady")
    for kind in dict.fromkeys(kinds):
        for key in ("fps", "steady_fps", "median_fps", "host_rate", "per_rate"):
            v = [x[key] for x in runs if x["kind"] == kind]
            print(f"{kind:7s} {key:10s} mean {sum(v) / len(v):.3f} min {min(v):.3f} "
                  f"max {max(v):.3f} over {len(v)}")
    ratios = {}
    feeds = [i for i, x in enumerate(runs) if x["kind"] == "feed"]
    for i, x in enumerate(runs):
        before = [j for j in feeds if j < i]
        after = [j for j in feeds if j > i]
        if x["kind"] not in ("server", "socket") or not before or not after:
            continue
        a1, a2 = runs[before[-1]], runs[after[0]]
        for key in ("median_fps", "per_rate", "fps"):
            ratios.setdefault(f"{x['kind']} {key}", []).append(x[key] / ((a1[key] + a2[key]) / 2))
    for name, v in ratios.items():
        print(f"{name} / mean of the feed runs around it, by round: {[round(y, 4) for y in v]}, "
              f"min {min(v):.4f} max {max(v):.4f}")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "surface_rates.json"), "w") as f:
        json.dump(dict(card=card, stuck_capacity=caps, phase7_steady_fps=mp["frames_per_s"],
                       runs=runs, ratios=ratios), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
