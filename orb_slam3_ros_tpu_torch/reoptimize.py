"""Offline pose-graph re-optimization CLI — port of ``orb_slam3_ros_tpu.reoptimize``.

Role of the fork's standalone experiments (3DCERES/loop_optimization.cpp
main :1946-2022, test_op_data.cpp): parse a problem dump written by the live
system (``utils/optdump.py``; either package's), re-solve the essential
graph with the port's pose-graph optimizer, and write before / after TUM
trajectories for comparison.

Usage:
  python -m orb_slam3_ros_tpu_torch.reoptimize DUMP_DIR [--four-dof]
      [--iters N] [--loop-weight W] [--out OUT_DIR] [--device cpu]

The flags are the JAX CLI's; ``--platform`` is ``--device`` (default: the
CUDA device).
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dump_dir")
    ap.add_argument("--four-dof", action="store_true",
                    help="4-dof (yaw + translation) optimization for inertial maps")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--loop-weight", type=float, default=5.0)
    ap.add_argument("--out", default=None, help="output dir (default: the dump dir)")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    from .utils import optdump, trajectory

    dump = optdump.load_optimization_data(args.dump_dir)
    out_dir = args.out or args.dump_dir
    os.makedirs(out_dir, exist_ok=True)

    before = optdump.trajectory_from_poses(dump.kf_ts, dump.kf_R, dump.kf_t)
    trajectory.save_tum(os.path.join(out_dir, "trajectory_before.txt"), before)

    R_new, t_new, _, cost = optdump.reoptimize(
        dump, n_iters=args.iters, four_dof=args.four_dof, loop_weight=args.loop_weight,
        device=args.device,
    )
    after = optdump.trajectory_from_poses(dump.kf_ts, R_new, t_new)
    trajectory.save_tum(os.path.join(out_dir, "trajectory_after.txt"), after)

    n_loop = int((dump.e_kind == 1).sum())
    print(
        f"reoptimize: K={len(dump.kf_id)} edges={len(dump.e_i)} (loop={n_loop}) "
        f"iters={args.iters} mode={'4dof' if args.four_dof else 'sim3'} final_cost={cost:.6f}",
        file=sys.stderr,
    )
    print(os.path.join(out_dir, "trajectory_after.txt"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
