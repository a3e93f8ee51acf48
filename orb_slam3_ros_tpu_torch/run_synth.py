"""Dataset replay on the synthetic sequence — port of
``orb_slam3_ros_tpu.run_synth`` (the reference's non-ROS examples,
Examples/mono_euroc.cc:40-120: load images, loop TrackMonocular, save and
evaluate the trajectory), with the ray-traced room rendered on the device.

Usage:
    python -m orb_slam3_ros_tpu_torch.run_synth --frames 40 [--device cpu]
        [--height 240 --width 376] [--features 1200] [--chunk 15]
        [--save-traj out.txt] [--save-map session] [--json]

The flags and the summary are the JAX CLI's; ``--platform`` is ``--device``
(default: the CUDA device). ``--native-feed``, ``--stream`` and
``--verbose`` need the native runtime and the observation log, which are not
ported, and raise. ``per_stage_ms`` holds the host's mean wall ms per
``process_frame`` call ("frame") and per ``process_frames`` chunk ("chunk").
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None):
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
                    help="feed frames through the C++ measurement-sync runtime (not ported)")
    ap.add_argument("--save-traj", default=None, help="write TUM-format trajectory")
    ap.add_argument("--save-map", default=None,
                    help="write a whole-session checkpoint (npz + json manifest)")
    ap.add_argument("--json", action="store_true", help="print one summary JSON line")
    ap.add_argument("--stream", default=None,
                    help="write per-frame pose/state events to this JSONL file (not ported)")
    ap.add_argument("--verbose", type=int, default=0, help="log verbosity 0-3 (not ported)")
    args = ap.parse_args(argv)
    for flag, on in (("--native-feed", args.native_feed), ("--stream", args.stream),
                     ("--verbose", args.verbose)):
        if on:
            raise NotImplementedError(
                f"{flag} needs the native runtime and the observation log, which are not "
                "ported (ROADMAP Queue 1 item 7)"
            )

    import numpy as np

    from .models.system import OK, MonoSlam
    from .utils import synth
    from .utils.evaluate_ate import ate_rmse

    print(f"rendering {args.frames} frames...", file=sys.stderr, flush=True)
    seq = synth.make_sequence(
        n_frames=args.frames, height=args.height, width=args.width, dt=args.dt,
        seed=args.seed, trajectory=args.trajectory, device=args.device,
    )
    slam = MonoSlam(
        height=args.height, width=args.width, cam_params=seq.cam_params,
        n_features=args.features, max_keyframes=64, max_points=8192,
        enable_loop_closing=args.loop_closing, track_window=args.track_window,
        device=args.device,
    )
    timing = {"frame": [], "chunk": []}

    def frame(i):
        t0 = time.perf_counter()
        T = slam.process_frame(seq.images[i], float(seq.timestamps[i]))
        timing["frame"].append(time.perf_counter() - t0)
        return T

    t_start = time.time()
    tracked = 0
    if args.chunk > 0:
        i = 0
        while slam.state != OK and i < args.frames:
            tracked += frame(i) is not None
            i += 1
        while i < args.frames:
            j = min(i + args.chunk, args.frames)
            t0 = time.perf_counter()
            slam.process_frames((seq.images, i), seq.timestamps[i:j])
            timing["chunk"].append(time.perf_counter() - t0)
            i = j
        slam.flush()
        tracked = len(slam.trajectory)
    else:
        for i in range(args.frames):
            tracked += frame(i) is not None
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
        "per_stage_ms": {k: round(1000 * float(np.mean(v)), 1) for k, v in timing.items() if v},
        "loop_closures": slam.loop_closer.closures if slam.loop_closer is not None else [],
    }
    if args.json:
        print(json.dumps(summary))
    else:
        for k, v in summary.items():
            print(f"{k}: {v}")
    return 0 if (slam.state == OK and rmse < 0.2) else 1


if __name__ == "__main__":
    sys.exit(main())
