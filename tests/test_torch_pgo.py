"""The pose-graph solves of loop closing in the port against the JAX
package: 7-dof and 4-dof essential-graph PGO (``ops/pgo.py`` through
``loop_closing._essential_graph_pgo``), the chain PGO
(``_pgo_over_chain``) and ``correct_points``, on the drifted-loop map of
``tests/test_essential_graph.py`` (hand-authored observations, drifted
odometry around a circle); then the essential graph against the chain and
the persistent loop edges, as that file checks the JAX package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.models import loop_closing as jlc
from orb_slam3_ros_tpu.ops import lie as jlie
from orb_slam3_ros_tpu.ops import pgo as jpgo
from orb_slam3_ros_tpu_torch.models import loop_closing as tlc
from orb_slam3_ros_tpu_torch.ops import lie as tlie
from orb_slam3_ros_tpu_torch.ops import pgo as tpgo
from test_essential_graph import _aligned_rmse, _loop_meas, _no_past, make_drifted_loop_map
from torch_parity import torch_map

torch.set_num_threads(1)
K, CAND = 18, 4
# Poses within 2e-4 (measured <= 7.3e-5 m after 30 LM iterations of a
# float32 dense solve: the Cholesky here, LU in the JAX package), points
# within 5e-4 (measured 7.2e-5), cost to 1e-4 relative.
POSE_TOL, PT_TOL = 2e-4, 5e-4


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def drifted():
    m, R_gt, t_gt = make_drifted_loop_map(np.random.default_rng(0), K=K, boost_until=CAND,
                                          boost=3.0)
    return m, R_gt, t_gt, _loop_meas(R_gt, t_gt, K - 1, CAND)


def _tm(jm):
    return tlc.MapState(*torch_map(jm))


def _check_maps(jm, tm, jc, tc):
    np.testing.assert_allclose(tm.kf_R.numpy(), np.asarray(jm.kf_R), atol=POSE_TOL)
    np.testing.assert_allclose(tm.kf_t.numpy(), np.asarray(jm.kf_t), atol=POSE_TOL)
    np.testing.assert_allclose(tm.pt_X.numpy(), np.asarray(jm.pt_X), atol=PT_TOL)
    np.testing.assert_allclose(tm.kf_v.numpy(), np.asarray(jm.kf_v), atol=POSE_TOL)
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-4)


@pytest.mark.parametrize("four_dof", [False, True])
def test_essential_graph_pgo_matches_jax(drifted, four_dof):
    m, _, _, (lR, lt, ls) = drifted
    jm, jc = jlc._essential_graph_pgo(m, jnp.asarray(K - 1), jnp.asarray(CAND), lR, lt, ls,
                                      jnp.asarray(K), *_no_past(), n_iters=30, four_dof=four_dof)
    tm, tc = tlc._essential_graph_pgo(_tm(m), K - 1, CAND, T(lR), T(lt), T(ls), K,
                                      *[T(x) for x in _no_past()], n_iters=30, four_dof=four_dof)
    _check_maps(jm, tm, jc, tc)


@pytest.mark.parametrize("four_dof", [False, True])
def test_chain_pgo_matches_jax(drifted, four_dof):
    m, _, _, (lR, lt, ls) = drifted
    jm, jc = jlc._pgo_over_chain(m, jnp.asarray(K - 1), jnp.asarray(CAND), lR, lt, ls,
                                 jnp.asarray(K), n_iters=30, four_dof=four_dof)
    tm, tc = tlc._pgo_over_chain(_tm(m), K - 1, CAND, T(lR), T(lt), T(ls), K, n_iters=30,
                                 four_dof=four_dof)
    _check_maps(jm, tm, jc, tc)


@pytest.mark.parametrize("four_dof", [False, True])
def test_optimize_pose_graph_with_weights_and_fixed_matches_jax(four_dof):
    """The solver alone on a random graph with edge weights, invalid edges,
    fixed and invalid keyframes and non-unit scales."""
    rng = np.random.default_rng(3)
    Kg, E = 10, 30
    R, t, s = jlie.sim3_exp(jnp.asarray(rng.normal(size=(Kg, 7)).astype(np.float32) * 0.3))
    eR, et, es = jlie.sim3_exp(jnp.asarray(rng.normal(size=(E, 7)).astype(np.float32) * 0.3))
    prob = dict(
        R=R, t=t, s=s, kf_fixed=np.arange(Kg) < 2, kf_valid=np.arange(Kg) < Kg - 1,
        e_i=rng.integers(0, Kg, E).astype(np.int32), e_j=rng.integers(0, Kg, E).astype(np.int32),
        e_R=eR, e_t=et, e_s=es, e_valid=rng.random(E) < 0.8,
        e_weight=rng.uniform(0.5, 2.0, E).astype(np.float32),
    )
    jp = jpgo.PGOProblem(**{k: jnp.asarray(v) for k, v in prob.items()})
    tp = tpgo.PGOProblem(**{k: T(v) for k, v in prob.items()})
    jfn = jpgo.optimize_pose_graph_4dof if four_dof else jpgo.optimize_pose_graph
    tfn = tpgo.optimize_pose_graph_4dof if four_dof else tpgo.optimize_pose_graph
    jr, tr = jfn(jp, n_iters=8), tfn(tp, n_iters=8)
    for f in ("R", "t", "s"):
        np.testing.assert_allclose(getattr(tr, f).numpy(), np.asarray(getattr(jr, f)), atol=POSE_TOL)
    np.testing.assert_allclose(float(tr.cost), float(jr.cost), rtol=1e-4)
    np.testing.assert_array_equal(tr.R[:2].numpy(), np.asarray(R)[:2])  # fixed stay put


def test_correct_points_matches_jax():
    rng = np.random.default_rng(4)
    Kc, P = 6, 50
    Ro, to, so = jlie.sim3_exp(jnp.asarray(rng.normal(size=(Kc, 7)).astype(np.float32) * 0.3))
    Rn, tn, sn = jlie.sim3_exp(jnp.asarray(rng.normal(size=(Kc, 7)).astype(np.float32) * 0.3))
    X = rng.normal(size=(P, 3)).astype(np.float32)
    ref = rng.integers(0, Kc, P).astype(np.int32)
    want = jpgo.correct_points(jnp.asarray(X), jnp.asarray(ref), Ro, to, so, Rn, tn, sn)
    got = tpgo.correct_points(T(X), T(ref), *[T(x) for x in (Ro, to, so, Rn, tn, sn)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_graph_beats_chain_on_drifted_loop(drifted):
    """As ``test_essential_graph.py`` holds the JAX package: with the drift
    before the candidate, the graph (only the candidate fixed) corrects
    better than the chain (keyframe 0 and the candidate fixed), which
    cannot move the 0 -> candidate segment."""
    m, R_gt, t_gt, (lR, lt, ls) = drifted
    tm0 = _tm(m)
    m_chain, _ = tlc._pgo_over_chain(tm0, K - 1, CAND, T(lR), T(lt), T(ls), K, n_iters=30)
    m_graph, _ = tlc._essential_graph_pgo(tm0, K - 1, CAND, T(lR), T(lt), T(ls), K,
                                          *[T(x) for x in _no_past()], n_iters=30)
    rmse = {k: _aligned_rmse(mm, R_gt, t_gt) for k, mm in
            (("before", m), ("chain", m_chain), ("graph", m_graph))}
    assert rmse["before"] > 0.25
    assert rmse["graph"] < rmse["chain"]
    assert rmse["graph"] < 0.8 * rmse["before"]

    def rel_err(mm):
        R, t = np.asarray(mm.kf_R), np.asarray(mm.kf_t)
        Rr = R[CAND] @ R[0].T
        Rg = R_gt[CAND] @ R_gt[0].T
        return float(np.linalg.norm(t[CAND] - Rr @ t[0] - (t_gt[CAND] - Rg @ t_gt[0])))

    assert abs(rel_err(m_chain) - rel_err(m)) < 1e-5
    assert np.linalg.norm(m_graph.kf_t[0].numpy() - np.asarray(m.kf_t[0])) > 0.02


def test_past_loop_edges_constrain():
    """A second closure keeps honouring the first closure's stored edge."""
    m, R_gt, t_gt = make_drifted_loop_map(np.random.default_rng(0), K=K)
    new1, cand1 = K - 1, 4
    lR1, lt1, ls1 = (T(x) for x in _loop_meas(R_gt, t_gt, new1, cand1))
    no_past = [T(x) for x in _no_past()]
    m1, _ = tlc._essential_graph_pgo(_tm(m), new1, cand1, lR1, lt1, ls1, K, *no_past, n_iters=30)
    L = 16
    pi = torch.full((L,), -1, dtype=torch.int32)
    pj = pi.clone()
    pi[0], pj[0] = new1, cand1
    pR = torch.eye(3).repeat(L, 1, 1)
    pR[0] = lR1
    pt = torch.zeros((L, 3))
    pt[0] = lt1
    pv = torch.zeros((L,), dtype=torch.bool)
    pv[0] = True
    new2, cand2 = K - 2, 2
    lR2, lt2, ls2 = (T(x) for x in _loop_meas(R_gt, t_gt, new2, cand2))
    m_with, _ = tlc._essential_graph_pgo(m1, new2, cand2, lR2, lt2, ls2, K, pi, pj, pR, pt,
                                         torch.ones((L,)), pv, n_iters=30)
    m_without, _ = tlc._essential_graph_pgo(m1, new2, cand2, lR2, lt2, ls2, K, *no_past,
                                            n_iters=30)

    def first_edge_resid(mm):
        R21 = mm.kf_R[cand1] @ mm.kf_R[new1].T
        t21 = mm.kf_t[cand1] - R21 @ mm.kf_t[new1]
        rot = torch.linalg.vector_norm(tlie.so3_log(R21 @ lR1.T))
        return float(rot + torch.linalg.vector_norm(t21 - lt1))

    assert first_edge_resid(m_with) < 0.8 * first_edge_resid(m_without)
