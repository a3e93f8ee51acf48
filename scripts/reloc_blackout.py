"""Frames a monocular system needs to relocalize after a camera blackout,
run by the JAX package or by the port on the CPU.

    python3 scripts/reloc_blackout.py --package jax  [--height 240 --width 376]
    python3 scripts/reloc_blackout.py --package torch [--height 240 --width 376]

``bench.py::main``'s protocol and configuration at the given size:
``make_sequence(seed=3)``, 120 frames, frame by frame until the chunk gate
holds, then chunks of 15 from frame 45 on, with frames 60..62 set to zero.
The chunk that holds the blackout stops at its first dark frame, the system
goes LOST and the frames from there are replayed one at a time through
relocalization. Prints one JSON line: the frame at which relocalization
first succeeded, how many frames after the first good one (63) that was,
every relocalization call's frame and outcome, keyframes, the state at the
end and the frames without a pose after the blackout. Both packages run
with ``pipelined=False`` (each frame tracked at once); the chunk loop is the
same either way.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N_FRAMES, WARM, CHUNK, DARK = 120, 45, 15, (60, 63)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--width", type=int, default=376)
    a = ap.parse_args()
    kw = dict(n_features=1000, max_keyframes=64, max_points=4096, kf_every=8, fuse_every=3,
              stats_every=3, cull_every=3, lean_after_kf=4, track_cap=768, transfer_uint8=True,
              pipelined=False)
    if a.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        import jax.numpy as jnp

        from orb_slam3_ros_tpu.models.system import LOST, OK, MonoSlam
        from orb_slam3_ros_tpu.utils import synth

        seq = synth.make_sequence(n_frames=N_FRAMES, height=a.height, width=a.width, dt=0.1, seed=3)
        images = np.stack(seq.images)
        slam = MonoSlam(height=a.height, width=a.width, cam_params=seq.cam_params, **kw)
        stack = jnp.asarray(np.clip(images, 0, 255).astype(np.uint8))
        stack = stack.at[DARK[0] : DARK[1]].set(0)
    else:
        import torch

        from orb_slam3_ros_tpu_torch.models.system import LOST, OK, MonoSlam
        from orb_slam3_ros_tpu_torch.utils import synth

        seq = synth.make_sequence(n_frames=N_FRAMES, height=a.height, width=a.width, dt=0.1, seed=3,
                                  device="cpu")
        images = seq.images.numpy()
        slam = MonoSlam(height=a.height, width=a.width, cam_params=seq.cam_params, device="cpu", **kw)
        stack = torch.clamp(seq.images, 0, 255).to(torch.uint8)
        stack[DARK[0] : DARK[1]] = 0
    slam._sched_lean = ((40.0, 2, 4), (4.0, 2, 4))
    tss = np.asarray(seq.timestamps, np.float64)
    calls = []
    reloc = slam._try_relocalize

    def logged(feats, ts):
        out = reloc(feats, ts)
        calls.append((int(round((ts - tss[0]) / 0.1)), out is not None))
        return out

    slam._try_relocalize = logged
    t0 = time.time()
    i = 0
    while (slam.state != OK or not slam._chunkable()) and i < WARM - CHUNK:
        slam.process_frame(images[i], float(tss[i]))
        i += 1
    while i + CHUNK <= N_FRAMES:
        slam.process_frames((stack, i), tss[i : i + CHUNK])
        i += CHUNK
    while i < N_FRAMES:
        slam.process_frame(images[i], float(tss[i]))
        i += 1
    slam.flush()
    ok_at = [f for f, ok in calls if ok]
    first = ok_at[0] if ok_at else None
    posed = {int(round((t - tss[0]) / 0.1)) for t, _ in slam.get_trajectory()}
    print(json.dumps(dict(
        package=a.package, height=a.height, width=a.width, dark=list(range(*DARK)),
        relocalized_at=first, frames_after_first_good=None if first is None else first - DARK[1],
        reloc_calls=calls, keyframes=int(slam.n_kf),
        state_at_end={OK: "OK", LOST: "LOST"}.get(slam.state, slam.state),
        frames_without_pose_after_blackout=[f for f in range(DARK[0], N_FRAMES) if f not in posed],
        wall_s=round(time.time() - t0, 1),
    )))
    return 0


if __name__ == "__main__":
    sys.exit(main())
