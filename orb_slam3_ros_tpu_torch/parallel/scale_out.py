"""Run the sharded solvers once per process and check them: Schur-LM BA,
PCG BA, VI-BA and the 7-dof PGO (``dist_ba``) over the process world, each
timed and held to the same solve without a communicator.

    # N processes, each told its rank (gloo on the CPU, or N processes that
    # share one card with --backend gloo --device cuda):
    python -m orb_slam3_ros_tpu_torch.parallel.scale_out --world N --rank R \\
        --coordinator 127.0.0.1:29500 --device cpu --problems probs.npz --out DIR
    # one process per card, NCCL (torchrun sets RANK, WORLD_SIZE, MASTER_ADDR,
    # MASTER_PORT and LOCAL_RANK):
    torchrun --nproc-per-node N -m orb_slam3_ros_tpu_torch.parallel.scale_out --compare

Problems: ``--problems`` reads a ``problems.save`` file with the trees "ba",
"vi" and "pgo"; without it they are generated (the global-BA shape K=64,
P=8192, E=65536; the VI window of 24 keyframes and 512 points; the ring of
64 keyframes and 256 edges). Each solver runs ``ITERS`` iterations, once to
warm up and once timed. Rank 0 prints one line ``SCALE_OUT {json}`` (ms per
LM iteration by solver, bytes the solver summed per iteration, peak device
memory and shard sizes by rank, and with ``--compare`` the largest
differences to the reference solve and whether each is within the JAX
package's distributed tests' tolerances) and, with ``--out``, writes its
results to ``DIR/result.npz``. The exit code is 1 when a comparison fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
import torch.distributed as dist

from . import dist_ba, multihost, problems
from .. import to_device
from ..ops import ba, ba_pcg, pgo, viba

SOLVERS = ("lm", "pcg", "vi", "pgo")
# LM iterations by solver (lm: Schur-LM, pcg: PCG BA with n_cg CG steps each)
ITERS = dict(lm=2, pcg=2, n_cg=20, vi=4, pgo=6)
# The JAX package's tests/test_dist_ba.py tolerances: field -> (rtol, atol), met
# where |got - want| <= atol + rtol |want| (numpy's assert_allclose)
TOL = {
    "lm": {"cost": (1e-3, 0.0), "R": (0.0, 1e-4), "t": (0.0, 1e-3), "X": (0.0, 3e-3)},
    "pcg": {"cost": (1e-3, 0.0), "R": (0.0, 1e-4)},
    "vi": {"cost": (1e-3, 0.0), "p_wb": (0.0, 1e-3), "v_w": (0.0, 1e-2), "X": (0.0, 3e-3)},
    "pgo": {"cost": (1e-3, 1e-6), "t": (0.0, 1e-3)},
}
GBA_MIN_INLIERS = 60000  # at K=64, P=8192, E=65536 (tests/test_dist_ba.py)


def fields(name: str, res) -> dict:
    """A result's arrays by name (VI states flattened)."""
    if name == "vi":
        return dict(**res.states._asdict(), X=res.X, cost=res.cost, chi2=res.chi2_visual,
                    inlier=res.inlier)
    if name == "pgo":
        return res._asdict()
    return dict(R=res.R, t=res.t, X=res.X, cost=res.cost, chi2=res.chi2, inlier=res.inlier,
                n_inliers=res.n_inliers)


def _solve(name: str, prob, mesh):
    kw = dict(n_iters=ITERS[name])
    if name == "lm":
        if mesh is None:
            return ba.bundle_adjust(prob, **kw)
        return dist_ba.distributed_bundle_adjust(prob, mesh, **kw)
    if name == "pcg":
        kw["n_cg"] = ITERS["n_cg"]
        if mesh is None:
            return ba_pcg.bundle_adjust_pcg(prob, **kw)
        return dist_ba.distributed_bundle_adjust_pcg(prob, mesh, **kw)
    if name == "vi":
        if mesh is None:
            return viba.vi_bundle_adjust(prob, **kw)
        return dist_ba.distributed_vi_bundle_adjust(prob, mesh, **kw)
    if mesh is None:
        return pgo.optimize_pose_graph(prob, **kw)
    return dist_ba.distributed_pose_graph(prob, mesh, **kw)


def host_problem(name: str, trees: dict):
    """The solver's problem on the CPU from the numpy trees."""
    if name in ("lm", "pcg"):
        return problems.to_ba(trees["ba"], "cpu")
    if name == "vi":
        return problems.to_vi(trees["vi"], "cpu")
    return problems.to_pgo(trees["pgo"], "cpu")


def _shard_sizes(name: str, prob, mesh) -> list:
    """(edges, points, cameras) of this rank's shard."""
    if name == "pgo":
        sh = dist_ba.shard_pgo_problem(prob, mesh)
        return [sh.e_i.shape[0], 0, sh.R.shape[0]]
    sh = (dist_ba.shard_vi_problem if name == "vi" else dist_ba.shard_problem)(prob, mesh)
    K = sh.prob.states.R_wb.shape[0] if name == "vi" else sh.prob.R.shape[0]
    return [sh.prob.uv.shape[0], sh.prob.X.shape[0], K]


def _per_rank(mesh, values: list) -> list:
    """Every rank's ``values`` (floats), gathered by one sum over the world."""
    buf = torch.zeros((mesh.size, len(values)), dtype=torch.float64, device=mesh.device)
    buf[mesh.rank] = torch.tensor(values, dtype=torch.float64)
    mesh.sum("world", buf)
    return buf.cpu().tolist()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def compare(name: str, got: dict, ref: dict) -> dict:
    """The largest |difference| of each field held by ``TOL``, the largest
    share of its bound it takes, and whether every element is within."""
    diff, share = {}, {}
    for f, (rtol, atol) in TOL[name].items():
        a, b = got[f].double().cpu(), ref[f].double().cpu()
        d = (a - b).abs()
        diff[f] = float(d.max())
        share[f] = float((d / (atol + rtol * b.abs()).clamp(min=1e-300)).max())
    return dict(max_diff=diff, of_bound=share, ok=all(v <= 1.0 for v in share.values()))


def run(mesh, trees: dict, check: bool = False) -> tuple:
    """Each solver on this rank: its shard's sizes, one warm solve, one
    timed solve and (``check``) rank 0's reference solve without a
    communicator on the same device. Returns (report, {solver: result
    arrays on the host}); the report holds ms per LM iteration, summed bytes
    per iteration and, for each rank, the peak device memory its solves took
    above what it held before them."""
    dev = mesh.device
    report = dict(world=mesh.size, mesh=list(mesh.shape), device=str(dev),
                  backend=dist.get_backend(), solvers={})
    results = {}
    for name in SOLVERS:
        prob = host_problem(name, trees)
        iters = ITERS[name]
        entry = dict(iters=iters, shard=_per_rank(mesh, _shard_sizes(name, prob, mesh)))
        held = 0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
        _solve(name, prob, mesh)
        _sync(dev)
        mesh.stats.update(calls=0, bytes=0)
        dist.barrier()
        t0 = time.perf_counter()
        if dev.type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
        res = _solve(name, prob, mesh)
        if dev.type == "cuda":
            b.record()
            b.synchronize()
            ms = a.elapsed_time(b)
        else:
            ms = (time.perf_counter() - t0) * 1e3
        entry.update(ms_per_iter=_per_rank(mesh, [ms / iters]),
                     sums_per_iter=mesh.stats["calls"] / iters,
                     bytes_per_iter=mesh.stats["bytes"] / iters)
        peak = torch.cuda.max_memory_allocated(dev) - held if dev.type == "cuda" else 0
        entry["peak_mib"] = [r[0] / 2**20 for r in _per_rank(mesh, [peak])]
        got = fields(name, res)
        if check and mesh.rank == 0:
            ref = fields(name, _solve(name, to_device(prob, dev), None))
            entry["check"] = compare(name, got, ref)
            if name == "lm" and prob.uv.shape[0] == 65536:
                n_inl = int(got["n_inliers"])
                entry["check"]["n_inliers"] = n_inl
                entry["check"]["ok"] = entry["check"]["ok"] and n_inl > GBA_MIN_INLIERS
        report["solvers"][name] = entry
        results[name] = {k: v.detach().cpu().numpy() for k, v in got.items()}
    return report, results


def _trees(args) -> dict:
    if args.problems:
        return problems.load(args.problems)
    return dict(ba=problems.ba_problem(), vi=problems.vi_problem(), pgo=problems.pgo_problem())


def main(argv=None) -> int:
    env = os.environ
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=int(env.get("WORLD_SIZE", 1)))
    ap.add_argument("--rank", type=int, default=int(env.get("RANK", 0)))
    ap.add_argument("--coordinator", default=(
        f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}" if "MASTER_ADDR" in env else None))
    ap.add_argument("--backend", default=None, help="nccl (default on a card) or gloo")
    ap.add_argument("--device", default=None,
                    help="cpu, cuda or cuda:K (default: cuda:LOCAL_RANK)")
    ap.add_argument("--problems", default=None, help="a problems.save file (ba, vi, pgo)")
    ap.add_argument("--compare", action="store_true",
                    help="hold rank 0's results to the solves without a communicator")
    ap.add_argument("--out", default=None, help="directory for rank 0's result.npz")
    args = ap.parse_args(argv)
    if args.coordinator is None:
        ap.error("--coordinator (or MASTER_ADDR / MASTER_PORT) is required")
    device = args.device or f"cuda:{env.get('LOCAL_RANK', 0)}"
    trees = _trees(args)
    multihost.init(args.coordinator, args.world, args.rank, backend=args.backend, device=device)
    try:
        report, results = run(multihost.global_mesh(), trees, check=args.compare)
    except BaseException:
        multihost.shutdown(barrier=False)  # a peer may wait in a collective this rank left
        raise
    multihost.shutdown()
    if args.rank == 0:
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            problems.save(os.path.join(args.out, "result.npz"), **results)
        print("SCALE_OUT " + json.dumps(report), flush=True)
        if args.compare and not all(e["check"]["ok"] for e in report["solvers"].values()):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
