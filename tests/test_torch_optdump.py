"""The port's loop-closure problem dump (``utils/optdump.py``), its offline
re-optimization (``optdump.reoptimize``, the ``reoptimize`` CLI) and the
loop closer's dump hook, against the JAX package's.

- Dumps written by either package load in the other with equal arrays
  (text at 9 decimals: rotations through quaternions to 1e-6, the rest to
  the text's precision, 1e-6), on ``test_optdump.py``'s drifted loop with
  every section filled and on the revisit map below.
- ``dump_from_map`` on the same map (the JAX map through its checkpoint,
  loaded by the port's) gives equal arrays: integers exact, floats to 1e-6
  (the relative Sim(3) of consecutive keyframes, float32 by two
  libraries).
- ``reoptimize`` on the same dump: poses within the PGO's pinned 7.3e-5,
  scales within 1e-4, and the cost falls; 7- and 4-dof, with and without
  covisibility edges. The CLIs write the same before / after trajectories
  (before to 1e-6, after within 7.3e-5).
- The closer's hook (``LoopCloser(dump_dir=...)`` and
  $ORB_TPU_LOOP_DUMP_DIR) writes ``closure_<kf>_pre`` / ``_post`` on the
  revisit map of ``test_torch_loop_closing.py``, equal to the JAX closer's
  dumps within that file's 2e-4.
"""

import os

import jax
import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu import reoptimize as jcli
from orb_slam3_ros_tpu.utils import checkpoint as jck
from orb_slam3_ros_tpu.utils import optdump as jod
from orb_slam3_ros_tpu_torch import reoptimize as tcli
from orb_slam3_ros_tpu_torch.models import loop_closing as tlc
from orb_slam3_ros_tpu_torch.utils import checkpoint as tck
from orb_slam3_ros_tpu_torch.utils import optdump as tod
from test_loop_math import make_loop_problem
from test_optdump import problem_to_dump_args
from test_torch_loop_closing import CLOSER_KW, REVISIT, _slams, make_revisit_map

torch.set_num_threads(1)
PGO_TOL = 7.3e-5


def _assert_dumps_equal(a, b, atol=1e-6, rot_atol=1e-6):
    assert a._fields == b._fields
    for f in a._fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.shape == y.shape, f
        if x.dtype.kind in "iub":
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            np.testing.assert_allclose(x, y, atol=rot_atol if f in ("kf_R", "e_R") else atol,
                                       rtol=0, err_msg=f)


def _full_args(prob):
    """``test_optdump.py``'s dump of the drifted loop, with every section:
    covisibility weights (pairs two and three apart, weights 40..230), IMU
    states and map points."""
    rng = np.random.default_rng(1)
    args = problem_to_dump_args(prob)
    K = len(args["kf_id"])
    cov = np.zeros((K, K), np.int32)
    for i in range(K - 3):
        cov[i, i + 2] = cov[i + 2, i] = 40 + 15 * i
        cov[i, i + 3] = cov[i + 3, i] = 230 - 10 * i
    args.update(cov=cov, kf_v=rng.normal(size=(K, 3)), kf_bg=rng.normal(size=(K, 3)) * 1e-2,
                kf_ba=rng.normal(size=(K, 3)) * 1e-1,
                pt_X=rng.normal(size=(50, 3)).astype(np.float32),
                pt_ref_kf=rng.integers(0, K, 50))
    return args


@pytest.fixture(scope="module")
def loop_dump(tmp_path_factory):
    prob, R_gt, t_gt, _ = make_loop_problem(np.random.default_rng(0))
    d = str(tmp_path_factory.mktemp("loop") / "dump")
    jod.save_optimization_data(d, **problem_to_dump_args(prob))
    full = str(tmp_path_factory.mktemp("loop") / "full")
    jod.save_optimization_data(full, **_full_args(prob))
    return d, t_gt, full, _full_args(prob)


@pytest.fixture(scope="module")
def revisit_map():
    m, _ = make_revisit_map()
    return m


def test_dumps_load_in_both_packages(tmp_path, loop_dump, revisit_map):
    full_args = loop_dump[3]
    map_args = jod.dump_from_map(revisit_map, 15, loop_edges=[
        (14, 2, np.eye(3, dtype=np.float32), np.asarray([0.1, 0, 0], np.float32), 1.05)])
    for case, args in (("full", full_args), ("map", map_args)):
        for writer, name in ((jod, "j"), (tod, "t")):
            writer.save_optimization_data(str(tmp_path / case / name), **args)
        jj, jt = (jod.load_optimization_data(str(tmp_path / case / n)) for n in "jt")
        tj, tt = (tod.load_optimization_data(str(tmp_path / case / n)) for n in "jt")
        assert len(tt.pt_X) > 0 and tt.e_kind[-1] == 1
        assert case != "full" or len(tt.cov_i) == 2 * (len(tt.kf_id) - 3)
        _assert_dumps_equal(tj, jj)  # the JAX dump, loaded by each package
        _assert_dumps_equal(tt, jt)  # the port's dump, loaded by each package
        _assert_dumps_equal(tt, jj)  # the two packages' dumps
        np.testing.assert_allclose(tt.kf_R, np.asarray(args["kf_R"]), atol=1e-6)


def test_dump_from_map_equals_jax_through_the_checkpoint(tmp_path, revisit_map):
    path = str(tmp_path / "map")
    jck.save_map(path, revisit_map, {"n_kf": 15})
    tm, _ = tck.load_map(path, device="cpu")
    edges = [(14, 2, np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 0.97)]
    want = jod.dump_from_map(revisit_map, 15, loop_edges=edges)
    got = tod.dump_from_map(tm, 15, loop_edges=edges)
    assert set(got) == set(want)
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert g.shape == w.shape, k
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("four_dof", [False, True], ids=["sim3", "4dof"])
def test_reoptimize_equals_jax(loop_dump, four_dof):
    d, t_gt = loop_dump[:2]
    dump_j, dump_t = jod.load_optimization_data(d), tod.load_optimization_data(d)
    Rj, tj, sj, cj = jod.reoptimize(dump_j, n_iters=25, four_dof=four_dof)
    Rt, tt, st, ct = tod.reoptimize(dump_t, n_iters=25, four_dof=four_dof, device="cpu")
    np.testing.assert_allclose(Rt, Rj, atol=PGO_TOL)
    np.testing.assert_allclose(tt * st[:, None], tj * sj[:, None], atol=PGO_TOL)
    np.testing.assert_allclose(st, sj, atol=1e-4)
    *_, c0 = tod.reoptimize(dump_t, n_iters=0, four_dof=four_dof, device="cpu")
    assert ct < c0 and abs(ct - cj) <= 1e-4 * max(1.0, cj)
    if not four_dof:  # as test_optdump.py: the drift is removed
        assert np.linalg.norm(tt * st[:, None] - t_gt, axis=-1).max() < 0.15


@pytest.mark.parametrize("cov_min", [100, 50], ids=["cov100", "cov50"])
def test_reoptimize_with_covisibility_edges_equals_jax(loop_dump, cov_min, monkeypatch):
    full = loop_dump[2]
    dump = tod.load_optimization_data(full)
    monkeypatch.setattr(tod, "COV_MIN", cov_min)  # the port's threshold is a constant
    Rj, tj, sj, cj = jod.reoptimize(jod.load_optimization_data(full), n_iters=15, cov_min=cov_min)
    Rt, tt, st, ct = tod.reoptimize(dump, n_iters=15, device="cpu")
    np.testing.assert_allclose(Rt, Rj, atol=PGO_TOL)
    np.testing.assert_allclose(tt * st[:, None], tj * sj[:, None], atol=PGO_TOL)
    assert ct < tod.reoptimize(dump, n_iters=0, device="cpu")[3]
    assert abs(ct - cj) <= 1e-4 * max(1.0, cj)


def test_cli_writes_before_after_as_jax(tmp_path, loop_dump):
    d = loop_dump[0]
    assert jcli.main([d, "--iters", "15", "--out", str(tmp_path / "j"), "--platform", "cpu"]) == 0
    assert tcli.main([d, "--iters", "15", "--out", str(tmp_path / "t"), "--device", "cpu"]) == 0
    for name, tol in (("trajectory_before.txt", 1e-6), ("trajectory_after.txt", PGO_TOL)):
        a, b = np.loadtxt(tmp_path / "t" / name), np.loadtxt(tmp_path / "j" / name)
        assert a.shape == b.shape == (12, 8)
        np.testing.assert_allclose(a, b, atol=tol, rtol=0)
    assert not np.allclose(np.loadtxt(tmp_path / "t" / "trajectory_before.txt"),
                           np.loadtxt(tmp_path / "t" / "trajectory_after.txt"))


def test_closer_dumps_pre_and_post_as_jax(tmp_path, monkeypatch, revisit_map):
    from torch_parity import torch_map

    js, ts = _slams(torch_map(revisit_map), revisit_map, **CLOSER_KW)
    js.loop_closer.dump_dir = str(tmp_path / "j")
    ts.loop_closer.dump_dir = str(tmp_path / "t")
    key = jax.random.PRNGKey(0)
    for k in REVISIT:
        js.loop_closer.try_close(js, k, key)
        ts.loop_closer.try_close(ts, k)
    assert ts.loop_closer.closures == js.loop_closer.closures and ts.loop_closer.closures
    kf = REVISIT[-1]
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j")) == [f"closure_{kf}_post", f"closure_{kf}_pre"]
    for tag in ("pre", "post"):
        got = tod.load_optimization_data(str(tmp_path / "t" / f"closure_{kf}_{tag}"))
        want = tod.load_optimization_data(str(tmp_path / "j" / f"closure_{kf}_{tag}"))
        _assert_dumps_equal(got, want, atol=2e-4, rot_atol=2e-4)
        assert got.e_kind[-1] == 1 and (got.e_i[-1], got.e_j[-1]) == (kf, ts.loop_closer.closures[0][1])
    pre = tod.load_optimization_data(str(tmp_path / "t" / f"closure_{kf}_pre"))
    post = tod.load_optimization_data(str(tmp_path / "t" / f"closure_{kf}_post"))
    assert np.abs(post.kf_t - pre.kf_t).max() > 1e-3  # the correction moved the keyframes
    # the constructor's argument, else the environment variable
    monkeypatch.delenv("ORB_TPU_LOOP_DUMP_DIR", raising=False)
    assert tlc.LoopCloser(dump_dir="x").dump_dir == "x" and tlc.LoopCloser().dump_dir is None
    monkeypatch.setenv("ORB_TPU_LOOP_DUMP_DIR", str(tmp_path / "env"))
    assert tlc.LoopCloser().dump_dir == str(tmp_path / "env")
