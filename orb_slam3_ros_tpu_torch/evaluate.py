"""CLI: ATE evaluation of TUM-format trajectories — port of
``orb_slam3_ros_tpu.evaluate`` (the reference's
``evaluation/evaluate_ate_scale.py`` + ``associate.py``): associate two TUM
trajectories by timestamp, Horn / Umeyama-align (with scale for monocular,
unless ``--no-scale``), print the ATE RMSE as one JSON line.

Usage: python -m orb_slam3_ros_tpu_torch.evaluate est.txt gt.txt [--no-scale]
       [--max-dt 0.02] [--plot out.png]
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("est", help="estimated trajectory (TUM format)")
    ap.add_argument("gt", help="ground-truth trajectory (TUM format)")
    ap.add_argument("--no-scale", action="store_true",
                    help="rigid alignment only (stereo/RGB-D/inertial)")
    ap.add_argument("--max-dt", type=float, default=0.02)
    ap.add_argument("--plot", default=None, help="write alignment plot PNG")
    args = ap.parse_args(argv)

    import numpy as np

    from .utils.evaluate_ate import align_umeyama, ate_rmse
    from .utils.trajectory import load_tum

    ts_e, pos_e, _ = load_tum(args.est)
    ts_g, pos_g, _ = load_tum(args.gt)
    rmse, n, s = ate_rmse(ts_e, pos_e, ts_g, pos_g, with_scale=not args.no_scale,
                          max_dt=args.max_dt)
    print(json.dumps({"ate_rmse_m": round(float(rmse), 5), "pairs": int(n),
                      "scale": round(float(s), 5)}))
    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        # associate by timestamp before aligning (lost frames shorten est)
        j = np.clip(np.searchsorted(ts_g, ts_e), 1, len(ts_g) - 1)
        jj = np.where(np.abs(ts_g[j - 1] - ts_e) < np.abs(ts_g[j] - ts_e), j - 1, j)
        ok = np.abs(ts_g[jj] - ts_e) <= args.max_dt
        pe, pg = pos_e[ok], pos_g[jj][ok]
        sc, R, t = align_umeyama(pe, pg, with_scale=not args.no_scale)
        aligned = (sc * (R @ pe.T)).T + t
        fig, ax = plt.subplots(figsize=(7, 7))
        ax.plot(pg[:, 0], pg[:, 1], "k-", lw=1, label="ground truth")
        ax.plot(aligned[:, 0], aligned[:, 1], "b-", lw=1, label="estimated")
        ax.set_aspect("equal")
        ax.legend()
        ax.set_title(f"ATE RMSE {rmse:.4f} m (n={n}, s={s:.3f})")
        fig.savefig(args.plot, dpi=120, bbox_inches="tight")
    return 0


if __name__ == "__main__":
    sys.exit(main())
