"""Dataset replay on the synthetic sequence — port of
``orb_slam3_ros_tpu.run_synth`` (the reference's non-ROS examples,
Examples/mono_euroc.cc:40-120: load images, loop TrackMonocular, save and
evaluate the trajectory), with the ray-traced room rendered on the device.

Usage:
    python -m orb_slam3_ros_tpu_torch.run_synth --frames 40 [--device cpu]
        [--height 240 --width 376] [--features 1200] [--chunk 15]
        [--native-feed] [--stream events.jsonl] [--verbose 1]
        [--control /tmp/slam.sock]
        [--save-traj out.txt] [--save-map session] [--json]

The flags and the summary are the JAX CLI's; ``--platform`` is ``--device``
(default: the CUDA device). ``--native-feed`` feeds the frames through the
C++ measurement sync (``native.py``) from a producer thread, with one zero
IMU sample a frame, as the JAX CLI does; the SLAM thread pops each bundle
and tracks its frame (the reference's ROS callback-thread topology). The
feed carries uint8 frames, so its trajectory is the plain loop's on the
frames rounded down to integers. ``--stream`` writes the ``on_frame``
events as JSON lines (``utils.obslog.FrameStreamer``), ``--verbose`` sets
the log level. ``--control`` (the port's) serves ``utils.control``'s socket
at that path, its commands run between frames (between chunks with
``--chunk``). ``per_stage_ms`` is ``timing_summary()``'s mean a stage
(``MonoSlam._tic``). With ``--native-feed`` the summary adds
``native_feed``: how often, and how long, the producer waited for room in
the frame ring; with ``--control`` it adds ``control``: the subscribers
the server dropped for a full queue or a dead socket.

``run(parse_args(argv), slam_kw)`` is the replay without the printing, for
a caller that sets more of ``MonoSlam``'s arguments and keeps the system.
The summary of a per-frame run, as the JAX CLI's, folds in no global BA
still in flight unless ``--stream`` is set (the JAX CLI flushes there).
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--width", type=int, default=376)
    ap.add_argument("--features", type=int, default=1200)
    ap.add_argument("--dt", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--trajectory", default="orbit", choices=["orbit", "loop"])
    ap.add_argument("--loop-closing", action="store_true")
    ap.add_argument("--track-window", type=int, default=None)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    ap.add_argument("--chunk", type=int, default=0,
                    help="process frames through the chunk loop, N frames per call (0 = per frame)")
    ap.add_argument("--native-feed", action="store_true",
                    help="feed frames through the C++ measurement sync from a producer thread")
    ap.add_argument("--save-traj", default=None, help="write TUM-format trajectory")
    ap.add_argument("--save-map", default=None,
                    help="write a whole-session checkpoint (npz + json manifest)")
    ap.add_argument("--json", action="store_true", help="print one summary JSON line")
    ap.add_argument("--stream", default=None,
                    help="write per-frame pose/state events to this JSONL file")
    ap.add_argument("--verbose", type=int, default=0, help="log verbosity 0-3")
    ap.add_argument("--control", default=None,
                    help="serve the JSONL control socket at this path (utils/control.py)")
    return ap.parse_args(argv)


def _native_replay(slam, ms, images, tss, between) -> tuple[int, dict]:
    """A producer thread pushes every frame (``images``: uint8 [N, H, W],
    as a camera delivers them; after one zero IMU sample at its stamp) into
    ``ms``; this thread pops the bundles and tracks them. Two semaphores
    count the ring's free slots and its ready bundles, so neither thread
    polls: the producer sleeps while the ring is full (a frame takes longer
    to track than to push) and the SLAM thread while it is empty. Returns
    (frames tracked, how often and how long the producer waited for a free
    slot)."""
    import numpy as np

    free, ready = threading.Semaphore(ms.frame_capacity), threading.Semaphore(0)
    waits = {"push_waits": 0, "push_wait_s": 0.0}
    failed = []

    def produce():
        zero = np.zeros(3, np.float32)
        try:
            for i in range(len(tss)):
                if not free.acquire(blocking=False):
                    t0 = time.perf_counter()
                    free.acquire()
                    waits["push_waits"] += 1
                    waits["push_wait_s"] += time.perf_counter() - t0
                if not (ms.push_imu(float(tss[i]), zero, zero)
                        and ms.push_frame(float(tss[i]), images[i])):
                    raise RuntimeError(f"the measurement sync refused frame {i} with a slot free")
                ready.release()
        except BaseException as e:  # re-raised on the SLAM thread
            failed.append(e)
            ready.release()

    th = threading.Thread(target=produce, daemon=True)
    th.start()
    tracked = 0
    for _ in range(len(tss)):
        ready.acquire()
        if failed:
            raise failed[0]
        b = ms.pop_bundle()
        if b is None:
            raise RuntimeError("the measurement sync held no bundle after a push")
        free.release()
        ts, gray, *_ = b
        tracked += slam.process_frame(gray, ts) is not None
        between()
    th.join()
    return tracked, waits


def run(args, slam_kw: dict | None = None):
    """Replay the sequence ``args`` describe. ``slam_kw``: ``MonoSlam``
    arguments over the CLI's. Returns (the system, the sequence, the
    summary, the exit code: 0 when tracking is OK at the end with an ATE
    under 0.2)."""
    import numpy as np
    import torch

    from .models.system import OK, MonoSlam
    from .utils import obslog, synth
    from .utils.evaluate_ate import ate_rmse

    print(f"rendering {args.frames} frames...", file=sys.stderr, flush=True)
    seq = synth.make_sequence(
        n_frames=args.frames, height=args.height, width=args.width, dt=args.dt,
        seed=args.seed, trajectory=args.trajectory, device=args.device,
    )
    slam = MonoSlam(**{
        **dict(height=args.height, width=args.width, cam_params=seq.cam_params,
               n_features=args.features, max_keyframes=64, max_points=8192,
               enable_loop_closing=args.loop_closing, track_window=args.track_window,
               device=args.device),
        **(slam_kw or {}),
    })
    if args.verbose:
        obslog.set_level(args.verbose)
    streamer = server = None
    if args.stream:
        streamer = obslog.FrameStreamer(args.stream)
        slam.on_frame = streamer
    if args.control:
        from .utils.control import ControlServer

        server = ControlServer(slam, args.control)
    between = server.poll if server is not None else (lambda: None)
    extra = {}
    t_start = time.time()
    tracked = 0
    try:
        if args.native_feed:
            from .native import MeasurementSync

            # the producer's frames, on the host as uint8 once: a retry on a
            # full ring then converts nothing (the SLAM thread shares the GIL)
            images = torch.clamp(seq.images, 0, 255).to(torch.uint8).cpu().numpy()
            ms = MeasurementSync(height=args.height, width=args.width)
            t_start = time.time()
            tracked, extra["native_feed"] = _native_replay(slam, ms, images, seq.timestamps,
                                                           between)
            ms.close()
        elif args.chunk > 0:
            i = 0
            while slam.state != OK and i < args.frames:
                tracked += slam.process_frame(seq.images[i], float(seq.timestamps[i])) is not None
                between()
                i += 1
            while i < args.frames:
                j = min(i + args.chunk, args.frames)
                slam.process_frames((seq.images, i), seq.timestamps[i:j])
                between()
                i = j
            slam.flush()
            tracked = len(slam.trajectory)
        else:
            for i in range(args.frames):
                tracked += slam.process_frame(seq.images[i], float(seq.timestamps[i])) is not None
                between()
        if streamer is not None:
            slam.flush()
        between()
    finally:
        if server is not None:
            server.close()
            extra["control"] = {"dropped": server.dropped}
        if streamer is not None:
            streamer.close()
    wall = time.time() - t_start

    ts = np.asarray([t for t, _ in slam.trajectory])
    est = np.stack([T[:3, 3] for _, T in slam.trajectory]) if slam.trajectory else np.zeros((0, 3))
    rmse, n, scale = (
        ate_rmse(ts, est, seq.timestamps.astype(np.float64), seq.t_wc)
        if len(est) >= 3
        else (float("inf"), 0, 1.0)
    )
    if args.save_map:
        from .utils import checkpoint

        digest = checkpoint.save_atlas(args.save_map, slam)
        print(f"map checkpoint: {args.save_map}.npz md5={digest}", file=sys.stderr, flush=True)
    if args.save_traj:
        from .utils.trajectory import save_tum

        save_tum(args.save_traj, slam.trajectory)

    summary = {
        "frames": args.frames,
        "tracked": tracked,
        "state_ok": slam.state == OK,
        "n_keyframes": slam.n_kf,
        "n_points": slam.n_pts,
        "ate_rmse_m": round(rmse, 4),
        "ate_scale": round(scale, 4),
        "fps": round(args.frames / wall, 2),
        "wall_s": round(wall, 2),
        "per_stage_ms": {k: round(1000 * v[0], 1) for k, v in slam.timing_summary().items()},
        "loop_closures": slam.loop_closer.closures if slam.loop_closer is not None else [],
        **extra,
    }
    return slam, seq, summary, 0 if (slam.state == OK and rmse < 0.2) else 1


def main(argv=None):
    args = parse_args(argv)
    _, _, summary, rc = run(args)
    if args.json:
        print(json.dumps(summary))
    else:
        for k, v in summary.items():
            print(f"{k}: {v}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
