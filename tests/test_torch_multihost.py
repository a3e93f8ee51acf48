"""The port's multi-process runtime (``parallel/multihost.py``, the
counterpart of ``tests/test_multihost.py``): two processes join a gloo
rendezvous on 127.0.0.1 through ``multihost.init``, build the global mesh
and their shards of one host problem with ``global_mesh`` /
``replicated_problem``, and solve it; the cost must match the JAX package's
single-device ``ba.bundle_adjust``. A rendezvous that fails raises: there
is no single-process fallback."""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import __graft_entry__ as graft
from orb_slam3_ros_tpu.ops import ba as jba
from orb_slam3_ros_tpu_torch.parallel.multihost import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent(
    """
    import sys
    import torch
    torch.set_num_threads(1)
    proc, port = int(sys.argv[1]), sys.argv[2]
    from orb_slam3_ros_tpu_torch.ops import ba
    from orb_slam3_ros_tpu_torch.parallel import dist_ba, multihost, problems
    assert "jax" not in sys.modules
    multihost.init(coordinator=f"127.0.0.1:{port}", num_processes=2, process_id=proc,
                   device="cpu")
    prob = problems.to_ba(problems.ba_problem(K=8, P=512, E=2048), "cpu")
    mesh = multihost.global_mesh()
    assert mesh.shape == (1, 2) and multihost.global_mesh() is mesh
    shard = multihost.replicated_problem(prob)
    res = ba.bundle_adjust(shard.prob, n_iters=3, comm=mesh.comm(shard.pt_rows))
    full = dist_ba.distributed_bundle_adjust(prob, mesh, n_iters=3)
    print("COST", float(res.cost), float(full.cost), shard.prob.uv.shape[0],
          shard.prob.X.shape[0], flush=True)
    """
)

_BAD_RENDEZVOUS = textwrap.dedent(
    """
    import sys
    import torch.distributed as dist
    from orb_slam3_ros_tpu_torch.parallel import multihost
    rank, port = int(sys.argv[1]), sys.argv[2]
    multihost.TIMEOUT_S = 3.0
    try:
        multihost.init(f"127.0.0.1:{port}", 2, rank, device="cpu")
    except Exception as e:
        print("RAISED", type(e).__name__, flush=True)
    print("INITIALIZED", dist.is_initialized(), flush=True)
    """
)


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_two_process_ba_matches_single(tmp_path):
    port = free_port()
    wf = tmp_path / "worker.py"
    wf.write_text(_WORKER)
    procs = [
        subprocess.Popen([sys.executable, str(wf), str(i), str(port)], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, env=_env(), text=True)
        for i in range(2)
    ]
    # the JAX package's single-device solve while the ranks run
    res = jba.bundle_adjust(graft._toy_problem(K=8, P=512, E=2048), n_iters=3)
    lines = []
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out[-3000:]
        line = [ln for ln in out.splitlines() if ln.startswith("COST ")]
        assert line, out[-3000:]
        lines.append(line[0].split()[1:])
    costs = np.asarray([[float(c) for c in ln[:2]] for ln in lines])
    # both ranks hold the same replicated cost, by either entry point
    assert np.all(costs == costs[0, 0])
    np.testing.assert_allclose(costs[0, 0], float(res.cost), rtol=1e-3)
    # each rank held its half of the points and about half of the edges
    assert [int(ln[3]) for ln in lines] == [256, 256]
    assert sum(int(ln[2]) for ln in lines) == 2048


@pytest.mark.parametrize("case", ["coordinator port taken", "no coordinator"])
def test_a_failed_rendezvous_raises(tmp_path, case):
    wf = tmp_path / "bad.py"
    wf.write_text(_BAD_RENDEZVOUS)
    if case == "coordinator port taken":
        # rank 0 must listen at the coordinator's address: it is in use
        held = socket.socket()
        held.bind(("127.0.0.1", 0))
        held.listen(1)
        rank, port = 0, held.getsockname()[1]
    else:
        # rank 1 dials a coordinator that never comes up
        held, rank, port = None, 1, free_port()
    try:
        out = subprocess.run([sys.executable, str(wf), str(rank), str(port)], env=_env(),
                             capture_output=True, text=True, timeout=120).stdout
    finally:
        if held is not None:
            held.close()
    assert "RAISED" in out and "INITIALIZED False" in out, out
