"""The KB8 camera in the port's loop closing and Atlas
(``ops/sim3solver.py``, ``models/loop_closing.py``, ``models/atlas.py``,
``utils/checkpoint.py``).

The JAX package projects the Sim(3) solver's two-way inlier test,
SearchBySim3 and the Atlas's cross-map search through the pinhole model
whatever the camera (its ``sim3solver.py:101-157``,
``loop_closing.py:105``, ``atlas.py:342``). The port's KB8 forms are held
to references composed here from the JAX package's own pieces with its
``cameras.kb8_project`` in place of the pinhole projection: the inlier
masks equal, SearchBySim3's pairs equal (K1's plain version on the CPU).
The pinhole forms are held to the code they replaced, to the bit. On maps
built with numpy from a seed whose keyframes see their points through a
KB8 camera (``tests/test_torch_loop_closing.py``'s revisit and
``tests/test_torch_atlas.py``'s two maps, observed through KB8): a KB8
loop closes, a KB8 map welds into an archived one, and a KB8 session saves
and loads as KB8. Tolerances are stated where they are compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_atlas as ta
from orb_slam3_ros_tpu.models import loop_closing as jlc
from orb_slam3_ros_tpu.ops import cameras as jcam
from orb_slam3_ros_tpu.ops import hamming as jham
from orb_slam3_ros_tpu.ops import matching as jmatch
from orb_slam3_ros_tpu_torch.models import loop_closing as tlc
from orb_slam3_ros_tpu_torch.models import system as tsys
from orb_slam3_ros_tpu_torch.ops import cameras as tcam
from orb_slam3_ros_tpu_torch.ops import sim3solver as tsim3
from orb_slam3_ros_tpu_torch.utils import checkpoint as tck
from test_torch_kb8_vi import _pre_projection
from torch_parity import torch_map

torch.set_num_threads(1)
H, W, K, N, P = ta.H, ta.W, ta.K, ta.N, ta.P
# A KB8 camera over the maps' 640x480 images (the repo's test KB8's
# distortion, a focal length that keeps the places inside the image).
KB8 = np.asarray([260.0, 260.0, 319.5, 239.5, 0.02, 0.001, -0.002, 0.0002], np.float32)
CAND, REVISIT = 2, (11, 12, 13)
N_PLACE = ta.N_PLACE
SLAM_KW = dict(height=H, width=W, cam_params=KB8, cam_model="kb8", n_features=250,
               max_keyframes=K, max_points=P, device="cpu", pipelined=False)


def T(a):
    return torch.from_numpy(np.array(a))


def _kb8(Xc):
    return np.asarray(jcam.kb8_project(jnp.asarray(KB8), jnp.asarray(Xc, jnp.float32)))


class KB8Tables(ta._Tables):
    """``tests/test_torch_atlas.py``'s map tables, the keyframes observing
    their points through ``KB8``."""

    def observe(self, k, R, t, X, ids, desc, level):
        Xc = X @ R.T + t
        uv = _kb8(Xc)
        ok = (Xc[:, 2] > 0.1) & (uv[:, 0] > 4) & (uv[:, 0] < W - 4) & (uv[:, 1] > 4) & (uv[:, 1] < H - 4)
        n = int(ok.sum())
        self.kf_xy[k, :n], self.kf_level[k, :n], self.kf_desc[k, :n] = uv[ok], level[ok], desc[ok]
        self.kf_obs[k, :n], self.kf_fv[k, :n] = ids[ok], True
        self.kf_R[k], self.kf_t[k] = R, t


def _place(rng):
    XA = rng.uniform([-2.5, -1.8, 4.0], [2.5, 1.8, 7.0], (N_PLACE, 3)).astype(np.float32)
    dA = rng.choice(np.array([-1, 1], np.int8), (N_PLACE, 256))
    lA = rng.integers(0, 3, N_PLACE).astype(np.int32)
    return XA, dA, lA


def kb8_revisit_map(seed=0, s_d=1.08):
    """``tests/test_torch_loop_closing.py``'s revisit map through KB8: the
    candidate keyframe sees a place, three revisiting keyframes see its
    duplicates displaced by a Sim(3) drift (the same descriptors), the
    other keyframes points of their own. Returns (JAX map, drift (s, R, t))."""
    rng = np.random.default_rng(seed)
    XA, dA, lA = _place(rng)
    R_d, t_d = ta._rot([0.02, -0.05, 0.03]), np.asarray([0.3, -0.1, 0.2], np.float32)
    XB = (np.float32(s_d) * XA @ R_d.T + t_d).astype(np.float32)
    m = KB8Tables()
    ids_a = m.points(XA, dA, lA, CAND, rng)
    ids_b = {k: m.points(XB, dA, lA, k, rng) for k in REVISIT}
    for k in range(K - 1):
        if k == CAND:
            m.observe(k, *ta._pose(rng, 0.0, [0.0, 0.0, 0.0]), XA, ids_a, dA, lA)
        elif k in REVISIT:
            j = k - REVISIT[0]
            Rt, tt = ta._pose(rng, 0.04 * j, [0.05 * j, 0.02, -0.05])
            R = (Rt @ R_d.T).astype(np.float32)
            m.observe(k, R, (np.float32(s_d) * tt - R @ t_d).astype(np.float32), XB, ids_b[k],
                      dA, lA)
        else:
            m.other(k, rng, *ta._pose(rng, np.pi * (0.3 + 0.08 * k),
                                      [0.3 * np.cos(k), 0.3 * np.sin(k), 0.0]))
    return m.jax_map(K - 1, rng)[0], (s_d, R_d, t_d)


@pytest.fixture(scope="module")
def revisit():
    m, drift = kb8_revisit_map()
    return m, torch_map(m), drift


# ---- the Sim(3) pieces against the JAX package's, through KB8 ---------------
def _sim3_case(seed=0, n=200):
    """Matched camera-frame points seen up to 70 degrees off axis, three
    Sim(3) hypotheses (the true one and two others), 10% gross outliers,
    per-match octave variances."""
    rng = np.random.default_rng(seed)
    th, ph = rng.uniform(0.05, 1.2, n), rng.uniform(-np.pi, np.pi, n)
    d = rng.uniform(1.5, 6.0, n)
    X1 = (np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th)], -1)
          * d[:, None]).astype(np.float32)
    s, R, t = 1.1, ta._rot([0.03, -0.04, 0.02]), np.asarray([0.1, -0.05, 0.08], np.float32)
    X2 = (s * X1 @ R.T + t + rng.normal(size=X1.shape) * 0.004).astype(np.float32)
    X2[rng.random(n) < 0.1] += rng.normal(size=3).astype(np.float32)
    hyp_s = np.asarray([s, 1.0, 1.2], np.float32)
    hyp_R = np.stack([R, ta._rot([0.0, 0.02, 0.0]) @ R, R]).astype(np.float32)
    hyp_t = np.stack([t, t, t + 0.05]).astype(np.float32)
    sig = (1.2 ** (2.0 * rng.integers(0, 3, (2, n)))).astype(np.float32)
    return X1, X2, (hyp_s, hyp_R, hyp_t), sig


def _jax_two_way(s, R, t, X1, X2, th1, th2):
    """The JAX package's two-way reprojection errors (sim3solver.py:95-110)
    with ``kb8_project`` in place of its pinhole projection."""
    X1in2 = s[:, None, None] * np.einsum("hij,nj->hni", R, X1) + t[:, None, :]
    X2in1 = np.einsum("hji,hnj->hni", R, X2[None] - t[:, None, :]) / s[:, None, None]
    e2 = np.sum((_kb8(X1in2) - _kb8(X2)[None]) ** 2, -1)
    e1 = np.sum((_kb8(X2in1) - _kb8(X1)[None]) ** 2, -1)
    return e1, e2


def test_two_way_inliers_kb8_match_the_jax_projection():
    """``_two_way_inliers`` under KB8 against the JAX package's errors
    through its ``kb8_project``: the masks equal on every match whose
    errors are not within 1% of a gate (those may round either way in
    float32); the true hypothesis keeps the inliers, the others fewer."""
    X1, X2, (s, R, t), sig = _sim3_case()
    th1, th2 = tsim3.CHI2_SIM3 * sig[0], tsim3.CHI2_SIM3 * sig[1]
    e1, e2 = _jax_two_way(s, R, t, X1, X2, th1, th2)
    clear = (np.abs(e1 / th1 - 1) > 0.01) & (np.abs(e2 / th2 - 1) > 0.01)
    ok = np.ones(len(X1), bool)
    got = tsim3._two_way_inliers(T(s), T(R), T(t), T(X1), T(X2), T(ok), T(KB8), T(th1), T(th2),
                                 "kb8").numpy()
    want = (e1 < th1) & (e2 < th2)
    np.testing.assert_array_equal(got[:, clear.all(0)], want[:, clear.all(0)])
    assert want[0].sum() > 150 and want[1:].sum(1).max() < want[0].sum()


def _jax_search_by_sim3(m, kf1, kf2, s, R, t, radius):
    """SearchBySim3 as the JAX package composes it (its
    ``_grow_matches_by_sim3`` / ``_cross_map_grow``) with ``kb8_project``
    in place of its pinhole projection: (ok [N], pt2 [N])."""
    pt1 = np.asarray(m.kf_obs[kf1])
    p1c = np.clip(pt1, 0, P - 1)
    X1 = np.asarray(m.pt_X)[p1c] @ np.asarray(m.kf_R[kf1]).T + np.asarray(m.kf_t[kf1])
    X1in2 = (s * X1 @ R.T + t).astype(np.float32)
    uv2 = jnp.asarray(_kb8(X1in2))
    src_ok = (jnp.asarray(pt1 >= 0) & m.kf_feat_valid[kf1] & m.pt_valid[p1c]
              & jnp.asarray(X1in2[:, 2] > 0.05) & jcam.in_image(uv2, W, H, 2.0))
    f2 = jlc._kf_features(m, kf2)
    f2 = f2._replace(valid=f2.valid & (m.kf_obs[kf2] >= 0))
    idx, _ = jmatch.search_by_projection(uv2, src_ok, m.pt_level[p1c], m.pt_desc_sign[p1c], f2,
                                         radius=radius, max_dist=jham.TH_HIGH, ratio=1.0)
    idx = np.asarray(idx)
    pt2 = np.asarray(m.kf_obs[kf2])[np.clip(idx, 0, N - 1)]
    ok = np.asarray(src_ok) & (idx >= 0) & (pt2 >= 0) & np.asarray(m.pt_valid)[np.clip(pt2, 0, P - 1)]
    return ok, pt2


def _revisit_sim3(tm, kf1, cam_model="kb8"):
    pr = tlc.match_points_across(tm, kf1, tm, CAND)
    gen = torch.Generator().manual_seed(0)
    return tsim3.solve_sim3(pr.X1, pr.X2, pr.ok, T(KB8), gen, sigma2_1=pr.sig1,
                            sigma2_2=pr.sig2, cam_model=cam_model)


@pytest.mark.parametrize("kf1", [REVISIT[0], REVISIT[2], 5])
def test_search_by_sim3_kb8_matches_the_jax_projection(revisit, kf1):
    """SearchBySim3 through K1's plain version (P = N slots, radius 8 px *
    1.2^level, TH_HIGH, no ratio test) under the Sim(3) the KB8 solver finds
    between the first revisit and the candidate: the pairs equal the JAX
    package's search fed the KB8 projection; the first revisit pairs every
    place point, an unrelated keyframe none."""
    m, tm, _ = revisit
    res = _revisit_sim3(tm, REVISIT[0])
    assert bool(res.ok)
    got = tlc.search_by_sim3(tm, kf1, tm, CAND, res.s, res.R, res.t, T(KB8), W, H,
                             tlc.SIM3_RADIUS, "sim3", "kb8")
    ok, pt2 = _jax_search_by_sim3(m, kf1, CAND, res.s.numpy(), res.R.numpy(), res.t.numpy(),
                                  tlc.SIM3_RADIUS)
    np.testing.assert_array_equal(got.ok.numpy(), ok)
    np.testing.assert_array_equal(got.pt2.numpy()[ok], pt2[ok])
    if kf1 != REVISIT[2]:  # under another keyframe's Sim(3): parity only
        assert int(got.ok.sum()) == (N_PLACE if kf1 == REVISIT[0] else 0)


# ---- the pinhole forms, bit-equal to the code they replaced -----------------
def _pre_two_way_inliers(s, R, t, X1, X2, match_valid, cam_params, th1, th2):
    """``sim3solver._two_way_inliers`` as it was before the camera model
    reached it."""
    X1in2 = s[..., None, None] * torch.einsum("...ij,nj->...ni", R, X1) + t[..., None, :]
    e2 = torch.sum((tcam.pinhole_project_nodist(cam_params, X1in2)
                    - tcam.pinhole_project_nodist(cam_params, X2)) ** 2, -1)
    X2in1 = torch.einsum("...ji,...nj->...ni", R, X2 - t[..., None, :]) / s[..., None, None]
    e1 = torch.sum((tcam.pinhole_project_nodist(cam_params, X2in1)
                    - tcam.pinhole_project_nodist(cam_params, X1)) ** 2, -1)
    return (e1 < th1) & (e2 < th2) & match_valid


CAM = ta.CAM


def test_pinhole_sim3_pieces_are_the_code_they_replaced(monkeypatch):
    """``_two_way_inliers`` against a copy of the code it replaced, and the
    RANSAC solve, the refit and SearchBySim3 (on the pinhole revisit map of
    ``tests/test_torch_loop_closing.py``) against themselves with the
    projection routed to the direct pinhole calls: equal to the bit."""
    import test_torch_loop_closing as tl

    X1, X2, (s, R, t), sig = _sim3_case(seed=1)
    X1 = (X1 + [0.0, 0.0, 2.0]).astype(np.float32)  # in front of the pinhole
    X2 = (s[0] * X1 @ R[0].T + t[0]).astype(np.float32)
    args = (T(s), T(R), T(t), T(X1), T(X2), torch.ones(len(X1), dtype=torch.bool), T(CAM),
            T(tsim3.CHI2_SIM3 * sig[0]), T(tsim3.CHI2_SIM3 * sig[1]))
    assert torch.equal(tsim3._two_way_inliers(*args), _pre_two_way_inliers(*args))
    jm, _ = tl.make_revisit_map()
    tm = torch_map(jm)
    pr = tlc.match_points_across(tm, tl.REVISIT[0], tm, tl.CAND)
    samples = tsim3.sample_sim3(pr.ok, torch.Generator().manual_seed(3))

    def run():
        res = tsim3.solve_sim3_from_samples(pr.X1, pr.X2, pr.ok, T(CAM), samples,
                                            sigma2_1=pr.sig1, sigma2_2=pr.sig2)
        grown = tlc.search_by_sim3(tm, tl.REVISIT[1], tm, tl.CAND, res.s, res.R, res.t, T(CAM),
                                   tl.W, tl.H, tlc.SIM3_RADIUS, "sim3")
        ref = tsim3.refine_sim3(grown.X1, grown.X2, grown.ok, T(CAM), res.s, res.R, res.t,
                                sigma2_1=grown.sig1, sigma2_2=grown.sig2)
        return [*res, *grown, *ref]

    got = run()
    _pre_projection(monkeypatch)
    want = run()
    assert all(torch.equal(a, b) for a, b in zip(want, got))


# ---- a KB8 loop closes -------------------------------------------------------
def _closer_slam(tm, n_pts):
    slam = tsys.MonoSlam(enable_loop_closing=True, **SLAM_KW)
    slam.map, slam.n_kf, slam.n_pts, slam.state = tm, K - 1, n_pts, tsys.OK
    lc = slam.loop_closer
    lc.min_gap, lc.min_sim3_inliers, lc.run_gba = 8, 15, False
    return slam


def test_kb8_loop_closes_and_undoes_the_drift(revisit):
    """``MonoSlam(cam_model="kb8", enable_loop_closing=True)`` on the KB8
    revisit map: the first revisit stashes the hypothesis, the next two
    confirm it through SearchBySim3 on KB8 projections and the third closes
    the loop with every place point an inlier; the duplicates are welded
    and the corrected revisits see the candidate's points where their
    features are (median reprojection through KB8 under 1 px)."""
    m, tm, _ = revisit
    slam = _closer_slam(torch_map(m), int(np.asarray(m.pt_valid).sum()))
    fired = [slam.loop_closer.try_close(slam, k) for k in REVISIT]
    lc = slam.loop_closer
    assert fired == [False, False, True]
    assert lc.closures == [(REVISIT[-1], CAND, N_PLACE)] and lc.sim3_searches == 2
    k = REVISIT[-1]
    assert not slam.map.pt_valid[N_PLACE * 3:N_PLACE * 4].any()  # its duplicates died
    obs = slam.map.kf_obs[k]
    bound = obs >= 0
    X = slam.map.pt_X[obs[bound].long()]
    uv = tcam.kb8_project(T(KB8), X @ slam.map.kf_R[k].T + slam.map.kf_t[k])
    err = torch.linalg.vector_norm(uv - slam.map.kf_xy[k][bound], dim=-1)
    assert bool((obs[bound] < N_PLACE).all()) and float(err.median()) < 1.0, float(err.median())


def test_kb8_batched_verification_closes_on_the_same_keyframe(revisit):
    """The chunk-boundary form over the three revisits at once: the same
    closure, its two verification rounds counted."""
    m, _, _ = revisit
    slam = _closer_slam(torch_map(m), int(np.asarray(m.pt_valid).sum()))
    assert slam.loop_closer.try_close_batch(slam, list(REVISIT))
    assert slam.loop_closer.closures == [(REVISIT[-1], CAND, N_PLACE)]
    assert slam.loop_closer.sim3_searches == 2


# ---- a KB8 map welds ---------------------------------------------------------
def kb8_two_maps(seed=0, s_d=1.08):
    """``tests/test_torch_atlas.py``'s two maps through KB8: an archived map
    whose keyframes 2 and 3 see a place, a younger map in a world displaced
    by a Sim(3) whose keyframes 1 and 2 see its duplicates."""
    rng = np.random.default_rng(seed)
    XA, dA, lA = _place(rng)
    R_d, t_d = ta._rot([0.02, -0.35, 0.03]), np.asarray([1.3, -0.1, 0.6], np.float32)
    a, c = KB8Tables(), KB8Tables()
    ids_a = a.points(XA, dA, lA, ta.A_PLACE[0], rng)
    XC = (np.float32(s_d) * XA @ R_d.T + t_d).astype(np.float32)
    ids_c = c.points(XC, dA, lA, ta.C_PLACE[0], rng)
    for k in range(ta.N_KF_A):
        if k in ta.A_PLACE:
            j = ta.A_PLACE.index(k)
            a.observe(k, *ta._pose(rng, 0.03 * j, [0.05 * j, 0.0, 0.0]), XA, ids_a, dA, lA)
        else:
            a.other(k, rng, *ta._pose(rng, np.pi * (0.3 + 0.08 * k),
                                      [0.3 * np.cos(k), 0.3 * np.sin(k), 0.0]))
    for k in range(ta.N_KF_C):
        if k in ta.C_PLACE:
            j = ta.C_PLACE.index(k)
            Rt, tt = ta._pose(rng, 0.02 + 0.03 * j, [0.04 + 0.05 * j, 0.02, -0.05])
            R = (Rt @ R_d.T).astype(np.float32)
            c.observe(k, R, (np.float32(s_d) * tt - R @ t_d).astype(np.float32), XC, ids_c, dA, lA)
        else:
            c.other(k, rng, *ta._pose(rng, np.pi * (1.1 + 0.1 * k),
                                      [0.2 * np.cos(k), 0.0, 0.2 * np.sin(k)]))
    (ma, na), (mc, nc) = a.jax_map(ta.N_KF_A, rng), c.jax_map(ta.N_KF_C, rng)
    return torch_map(ma), na, torch_map(mc), nc


def _atlas_slam(ma, na, mc, nc, cam_model="kb8"):
    """A KB8 system with the younger map active and the archived one in
    its Atlas (signatures from the default vocabulary)."""
    slam = tsys.MonoSlam(enable_atlas=True, **{**SLAM_KW, "cam_model": cam_model})
    slam.map, slam.n_kf, slam.n_pts, slam.state = ma.__class__(*(x.clone() for x in ma)), \
        ta.N_KF_A, na, tsys.OK
    assert slam.atlas.archive_current(slam)
    slam.map, slam.n_kf, slam.n_pts, slam.state = mc.__class__(*(x.clone() for x in mc)), \
        ta.N_KF_C, nc, tsys.OK
    slam.R_cur, slam.t_cur = mc.kf_R[ta.N_KF_C - 1].numpy(), mc.kf_t[ta.N_KF_C - 1].numpy() + 0.05
    return slam


@pytest.fixture(scope="module")
def two_maps():
    return kb8_two_maps()


def test_kb8_map_welds_into_the_archived_one(two_maps):
    """``MonoSlam(cam_model="kb8", enable_atlas=True)``: the archived map
    keeps the camera, the weld holds (one cross-map SearchBySim3 on KB8
    projections), the maps are one, and the welded place lands on the
    archived one: the drift undone to 3 mm (float32 Umeyama / IRLS)."""
    ma, na, mc, nc = two_maps
    slam = _atlas_slam(ma, na, mc, nc)
    assert slam.atlas.maps[0].cam_model == "kb8"
    assert slam.atlas.merge_current_into(slam, 0)
    assert (slam.n_kf, slam.n_pts) == (ta.N_KF_A + ta.N_KF_C, na + nc) and not slam.atlas.maps
    assert slam.atlas.grow_searches >= 1
    np.testing.assert_allclose(slam.map.pt_X.numpy()[na:na + N_PLACE], ma.pt_X.numpy()[:N_PLACE],
                               atol=3e-3)


def test_kb8_lost_frame_switches_into_the_archived_map(two_maps, monkeypatch):
    """A lost frame tries the archived map through KB8 tracking: the
    camera model reaches ``track_against_map``."""
    from orb_slam3_ros_tpu_torch.models import atlas as tatlas
    from orb_slam3_ros_tpu_torch.ops import orb

    ma, na, mc, nc = two_maps
    slam = _atlas_slam(ma, na, mc, nc)
    seen = []
    track = tatlas.tracking.track_against_map
    monkeypatch.setattr(tatlas.tracking, "track_against_map",
                        lambda *a, **k: seen.append(k.get("cam_model")) or track(*a, **k))
    k = ta.A_PLACE[0]
    feats = orb.Features(xy=ma.kf_xy[k], level=ma.kf_level[k], angle=ma.kf_angle[k],
                         response=None, desc_packed=None, desc_sign=ma.kf_desc_sign[k],
                         valid=ma.kf_feat_valid[k])
    assert slam.atlas.try_relocalize_in_archived(slam, feats)
    assert seen and set(seen) == {"kb8"} and slam.n_kf == ta.N_KF_A


# ---- a KB8 session saves and loads as KB8 -----------------------------------
def test_kb8_session_saves_and_loads_as_kb8(two_maps, tmp_path):
    """``save_atlas`` records the camera (a manifest key the JAX loader does
    not read); the session loads into a KB8 system with its archived map's
    camera, and into a pinhole system it raises; a manifest without the key
    (the JAX package's) loads into either. The map checkpoint
    (``save_system`` / ``load_system``) does the same."""
    import json

    ma, na, mc, nc = two_maps
    slam = _atlas_slam(ma, na, mc, nc)
    path = str(tmp_path / "session")
    tck.save_atlas(path, slam)
    manifest = json.load(open(path + ".json"))
    assert manifest["counters"]["cam_model"] == "kb8"
    assert [e["cam_model"] for e in manifest["archived"]] == ["kb8"]
    back = tsys.MonoSlam(enable_atlas=True, **SLAM_KW)
    tck.load_atlas(path, back)
    assert back.cam_model == "kb8" and back.n_kf == ta.N_KF_C
    assert [am.cam_model for am in back.atlas.maps] == ["kb8"] and back.atlas.maps[0].n_kf == ta.N_KF_A
    pin = tsys.MonoSlam(enable_atlas=True, **{**SLAM_KW, "cam_params": CAM, "cam_model": "pinhole"})
    with pytest.raises(ValueError, match="kb8"):
        tck.load_atlas(path, pin)
    del manifest["counters"]["cam_model"]
    for e in manifest["archived"]:
        del e["cam_model"]
    json.dump(manifest, open(path + ".json", "w"))
    tck.load_atlas(path, pin)
    assert pin.n_kf == ta.N_KF_C and pin.cam_model == "pinhole"
    mpath = str(tmp_path / "map")
    tck.save_system(mpath, slam)
    kb8_sys = tsys.MonoSlam(**SLAM_KW)
    tck.load_system(mpath, kb8_sys)
    assert kb8_sys.n_kf == ta.N_KF_C
    with pytest.raises(ValueError, match="kb8"):
        tck.load_system(mpath, tsys.MonoSlam(**{**SLAM_KW, "cam_params": CAM, "cam_model": "pinhole"}))


def test_the_jax_package_loads_a_kb8_session(two_maps, tmp_path):
    """The port's KB8 session file is the JAX format: the JAX package's
    ``load_atlas`` reads it (it has no use for the camera key)."""
    from orb_slam3_ros_tpu.models import system as jsys
    from orb_slam3_ros_tpu.utils import checkpoint as jck

    ma, na, mc, nc = two_maps
    path = str(tmp_path / "session")
    tck.save_atlas(path, _atlas_slam(ma, na, mc, nc))
    js = jsys.MonoSlam(height=H, width=W, cam_params=KB8, cam_model="kb8", n_features=250,
                       max_keyframes=K, max_points=P, enable_atlas=True, pipelined=False)
    jck.load_atlas(path, js)
    assert js.n_kf == ta.N_KF_C and len(js.atlas.maps) == 1 and js.atlas.maps[0].n_kf == ta.N_KF_A
