"""The port's scale-out solvers (``orb_slam3_ros_tpu_torch/parallel``)
against the JAX package's: the sharded Schur-LM BA, PCG BA, VI-BA and
pose-graph solves over ``torch.distributed`` against the JAX package's
single-device and GSPMD-sharded solves (the conftest's 8-device CPU mesh),
at ``tests/test_dist_ba.py``'s tolerances.

The port's ranks are subprocesses, one a rank, joined by gloo on
127.0.0.1: ``python -m orb_slam3_ros_tpu_torch.parallel.scale_out`` (the
runner a user starts on the card too), which imports no JAX. They read the
problems from one ``.npz`` written here and rank 0 writes its results back.
All worker groups start at once and run while the JAX references compile.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from orb_slam3_ros_tpu.ops import ba as jba
from orb_slam3_ros_tpu.ops import ba_pcg as jpcg
from orb_slam3_ros_tpu.ops import imu as jimu
from orb_slam3_ros_tpu.ops import pgo as jpgo
from orb_slam3_ros_tpu.ops import viba as jviba
from orb_slam3_ros_tpu.parallel import dist_ba as jdist
from orb_slam3_ros_tpu_torch.ops import ba as tba
from orb_slam3_ros_tpu_torch.ops import ba_pcg as tpcg
from orb_slam3_ros_tpu_torch.ops import pgo as tpgo
from orb_slam3_ros_tpu_torch.ops import viba as tviba
from orb_slam3_ros_tpu_torch.parallel import dist_ba, problems
from orb_slam3_ros_tpu_torch.parallel.multihost import free_port
from orb_slam3_ros_tpu_torch.parallel.scale_out import ITERS
from torch_parity import np_tree

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, P, E = 16, 1024, 8192  # the equivalence shape: a quarter of the global-BA K and P
WORLDS = (1, 2, 4)


def start_workers(world: int, probs: str, out: str) -> list:
    """``world`` scale-out ranks on the CPU over gloo, one process each."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    coord = f"127.0.0.1:{free_port()}"
    args = ["--world", str(world), "--coordinator", coord, "--device", "cpu", "--problems",
            probs, "--out", out]
    return [
        subprocess.Popen(
            [sys.executable, "-m", "orb_slam3_ros_tpu_torch.parallel.scale_out", *args,
             "--rank", str(r)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT,
        )
        for r in range(world)
    ]


def finish_workers(procs: list) -> dict:
    """Wait for the ranks (any failing fails the test) and return rank 0's
    report."""
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
        assert p.returncode == 0, out[-3000:]
    line = [ln for ln in outs[0].splitlines() if ln.startswith("SCALE_OUT ")]
    assert line, outs[0][-3000:]
    return json.loads(line[0][len("SCALE_OUT "):])


def jax_vi(arrays: dict) -> jviba.VIBAProblem:
    kw = {k: (None if v is None else jnp.asarray(v)) for k, v in arrays.items()
          if k not in ("states", "ie_preint", "bf")}
    return jviba.VIBAProblem(
        states=jviba.VIStates(**{k: jnp.asarray(v) for k, v in arrays["states"].items()}),
        ie_preint=jimu.Preintegrated(**{k: jnp.asarray(v) for k, v in arrays["ie_preint"].items()}),
        bf=arrays["bf"], **kw,
    )


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every worker group's results by world size, the JAX references and the
    port's single-process solves."""
    tmp = tmp_path_factory.mktemp("dist_ba")
    trees = dict(ba=np_tree(graft._toy_problem(K=K, P=P, E=E)),
                 vi=problems.vi_problem(n_kf=24, n_pts=512),
                 pgo=problems.pgo_problem(K=64, E=256))
    probs = str(tmp / "problems.npz")
    problems.save(probs, **trees)
    groups = {w: start_workers(w, probs, str(tmp / f"w{w}")) for w in WORLDS}
    try:
        jprob = jba.BAProblem(**{k: jnp.asarray(v) for k, v in trees["ba"].items()})
        jvi, jpg = jax_vi(trees["vi"]), jpgo.PGOProblem(**{
            k: jnp.asarray(v) for k, v in trees["pgo"].items()})
        mesh = jdist.make_mesh(n_devices=8)
        jax_res = dict(
            lm=jba.bundle_adjust(jprob, n_iters=ITERS["lm"]),
            pcg=jpcg.bundle_adjust_pcg(jprob, n_iters=ITERS["pcg"], n_cg=ITERS["n_cg"]),
            lm_dist=jdist.distributed_bundle_adjust(jprob, mesh, n_iters=ITERS["lm"]),
            vi_dist=jdist.distributed_vi_bundle_adjust(jvi, mesh, n_iters=ITERS["vi"]),
            pgo_dist=jdist.distributed_pose_graph(jpg, mesh, n_iters=ITERS["pgo"]),
        )
        tprob = problems.to_ba(trees["ba"], "cpu")
        port = dict(
            lm=tba.bundle_adjust(tprob, n_iters=ITERS["lm"]),
            pcg=tpcg.bundle_adjust_pcg(tprob, n_iters=ITERS["pcg"], n_cg=ITERS["n_cg"]),
            vi=tviba.vi_bundle_adjust(problems.to_vi(trees["vi"], "cpu"), n_iters=ITERS["vi"]),
            pgo=tpgo.optimize_pose_graph(problems.to_pgo(trees["pgo"], "cpu"),
                                         n_iters=ITERS["pgo"]),
        )
        reports = {w: finish_workers(g) for w, g in groups.items()}
    finally:
        for g in groups.values():
            for p in g:
                if p.poll() is None:
                    p.kill()
    results = {w: problems.load(str(tmp / f"w{w}" / "result.npz")) for w in WORLDS}
    return dict(jax=jax_res, port=port, reports=reports, results=results, trees=trees)


def close(got, want, rtol=0.0, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("ref", ["lm", "lm_dist"])
def test_schur_lm_matches_jax(runs, world, ref):
    got, want = runs["results"][world]["lm"], runs["jax"][ref]
    close(got["cost"], want.cost, rtol=1e-3)
    close(got["R"], want.R, atol=1e-4)
    close(got["t"], want.t, atol=1e-3)
    close(got["X"], want.X, atol=3e-3)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_pcg_matches_jax(runs, world):
    got, want = runs["results"][world]["pcg"], runs["jax"]["pcg"]
    close(got["cost"], want.cost, rtol=1e-3)
    close(got["R"], want.R, atol=1e-4)


def test_vi_ba_matches_jax_distributed(runs):
    got, want = runs["results"][2]["vi"], runs["jax"]["vi_dist"]
    close(got["cost"], want.cost, rtol=1e-3)
    close(got["p_wb"], want.states.p_wb, atol=1e-3)
    close(got["v_w"], want.states.v_w, atol=1e-2)
    close(got["X"], want.X, atol=3e-3)


def test_pose_graph_matches_jax_distributed(runs):
    got, want = runs["results"][2]["pgo"], runs["jax"]["pgo_dist"]
    close(got["cost"], want.cost, rtol=1e-3, atol=1e-6)
    close(got["t"], want.t, atol=1e-3)


def test_vi_ba_and_pose_graph_at_world_four_match_jax_distributed(runs):
    # the (2, 2) mesh: both axes split
    got, want = runs["results"][4]["vi"], runs["jax"]["vi_dist"]
    close(got["cost"], want.cost, rtol=1e-3)
    close(got["p_wb"], want.states.p_wb, atol=1e-3)
    close(got["v_w"], want.states.v_w, atol=1e-2)
    close(got["X"], want.X, atol=3e-3)
    got, want = runs["results"][4]["pgo"], runs["jax"]["pgo_dist"]
    close(got["cost"], want.cost, rtol=1e-3, atol=1e-6)
    close(got["t"], want.t, atol=1e-3)


@pytest.mark.parametrize("solver", ["lm", "pcg", "vi", "pgo"])
def test_world_of_one_is_the_single_process_solve(runs, solver):
    # One rank holds every edge in its order and every point: each sum is
    # over one rank, so the sharded solve is the comm=None solve to the bit.
    got = runs["results"][1][solver]
    ref = runs["port"][solver]
    want = dict(R=ref.R, t=ref.t, cost=ref.cost) if solver == "pgo" else (
        dict(p_wb=ref.states.p_wb, v_w=ref.states.v_w, X=ref.X, cost=ref.cost)
        if solver == "vi" else dict(R=ref.R, t=ref.t, X=ref.X, cost=ref.cost, chi2=ref.chi2))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=f"{solver}.{k}")


@pytest.mark.parametrize("world", [2, 4])
def test_per_edge_outputs_are_assembled_in_edge_order(runs, world):
    # chi2 and the inlier flags come back for every edge of the full problem
    got, ref = runs["results"][world]["lm"], runs["port"]["lm"]
    assert got["chi2"].shape == (E,) and got["inlier"].shape == (E,)
    close(got["chi2"], ref.chi2.numpy(), rtol=2e-2, atol=1e-2)
    assert (got["inlier"] == ref.inlier.numpy()).mean() > 0.999
    assert int(got["n_inliers"]) == int(got["inlier"].sum())


@pytest.mark.parametrize("world,solver", [(2, "lm"), (4, "lm"), (2, "vi"), (2, "pgo"),
                                          (4, "vi"), (4, "pgo")])
def test_sharding_actually_applied(runs, world, solver):
    # edges over 'obs' (each on one rank), points over 'pt', cameras replicated
    shards = np.asarray(runs["reports"][world]["solvers"][solver]["shard"], np.int64)
    a, b = dist_ba.mesh_shape(world)
    tree = runs["trees"]["pgo" if solver == "pgo" else "vi" if solver == "vi" else "ba"]
    n_edges = len(tree["e_i"] if solver == "pgo" else tree["uv"])
    n_cams = len(tree["R"] if solver != "vi" else tree["states"]["R_wb"])
    assert shards[:, 0].sum() == n_edges
    assert shards[:, 0].max() - shards[:, 0].min() <= 0.1 * n_edges / world
    assert (shards[:, 2] == n_cams).all()
    if solver != "pgo":
        n_pts = len(tree["X"])
        assert (shards[:, 1] == n_pts // b).all() and b == 2


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_factoring_matches_jax(n):
    assert dist_ba.mesh_shape(n) == jdist.make_mesh(n_devices=n).devices.shape


def test_problem_generator_is_the_graft_entry_problem():
    want = np_tree(graft._ba_problem(8, 256, 1024, seed=3))
    got = problems.ba_problem(8, 256, 1024, seed=3)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64), rtol=0, atol=1e-6, err_msg=k)
