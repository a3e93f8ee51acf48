"""Parity of the port's keyframe path with the JAX package, stage by stage,
on a map the JAX package built: triangulation, admission, fusion, the
covisibility window, local BA and its scatter-back, point and keyframe
culling, eviction, slot compaction, and one whole ``keyframe_work`` step.
Each stage gets the JAX package's own intermediate as input. Integer and
bool fields must be equal; float fields agree to the tolerance stated
where they are compared."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.models import local_mapping as jlm
from orb_slam3_ros_tpu.models import map_state as jms
from orb_slam3_ros_tpu.models import map_updates as jmu
from orb_slam3_ros_tpu.models import tracking as jtrk
from orb_slam3_ros_tpu.ops import ba as jba
from orb_slam3_ros_tpu.ops import lie as jlie
from orb_slam3_ros_tpu.utils import synth as jsynth
from orb_slam3_ros_tpu_torch.models import kf_work as tkf
from orb_slam3_ros_tpu_torch.models import local_mapping as tlm
from orb_slam3_ros_tpu_torch.models import map_state as tms
from orb_slam3_ros_tpu_torch.models import map_updates as tmu
from orb_slam3_ros_tpu_torch.models import tracking as ttrk
from orb_slam3_ros_tpu_torch.ops import ba as tba
from test_solvers import CAM, build_problem, make_scene
from torch_cases import T
from torch_parity import jax_mapping_run, np_tree, torch_ba_problem, torch_features, torch_map

torch.set_num_threads(1)

H, W, NF, N_FRAMES = 240, 376, 1000, 14
SLAM_KW = dict(height=H, width=W, n_features=NF, max_keyframes=16, max_points=2048, kf_every=3)
INT_KINDS = "biu"


# Landmark geometry after an LM solve. Normal equations summed in another
# order move weakly observed points (few observers, low parallax) the most:
# the JAX package's own two BA formulations differ by up to 2e-3 in X
# (test_solvers.py::TestRowStructuredBA). So 99% of the points agree to
# 1e-4 relative, all of them to 2e-3 relative.
POINT_FIELDS = ("pt_X", "pt_normal", "pt_min_dist", "pt_max_dist")


def assert_points_close(got, want, name="X"):
    got = got.reshape(len(got), -1)
    want = want.reshape(len(want), -1)
    scale = np.maximum(np.abs(want).max(axis=1), 1.0)
    rel = np.abs(got - want).max(axis=1) / scale
    assert (rel <= 1e-4).mean() >= 0.99, (name, np.sort(rel)[-5:])
    assert rel.max() <= 2e-3, (name, rel.max())


def assert_map_equal(tm, jm, float_tol=1e-5, fields=None, solved=False):
    """Integer/bool fields equal, float fields to ``float_tol`` (rtol and
    atol); with ``solved``, the landmark geometry of a BA solve by
    ``assert_points_close``."""
    for k, v in np_tree(jm).items():
        if fields is not None and k not in fields:
            continue
        got = getattr(tm, k).numpy()
        assert got.dtype == v.dtype, k
        if v.dtype.kind in INT_KINDS:
            np.testing.assert_array_equal(got, v, err_msg=k)
        elif solved and k in POINT_FIELDS:
            assert_points_close(got, v, k)
        else:
            np.testing.assert_allclose(got, v, rtol=float_tol, atol=float_tol, err_msg=k)


@pytest.fixture(scope="module")
def run():
    """The JAX package maps the first 14 frames; the inputs of its last
    keyframe step and the intermediate maps of that step's stages."""
    seq = jsynth.make_sequence(n_frames=N_FRAMES, height=H, width=W, dt=0.1, seed=3)
    slam, calls = jax_mapping_run(seq, N_FRAMES, **SLAM_KW)
    args, kw, out = calls[-1]
    m0, kf, R, t, ts, feats, feat_pt, n_pts, room, cam, bf = args
    assert int(kf) >= 4 and kw["do_fuse"] and kw["do_cull"]
    st = dict(args=args, kw=kw, out=out, kf=int(kf), cam=cam, n_pts=int(n_pts), room=int(room))
    st["m1"] = jmu.insert_keyframe(m0, kf, R, t, ts, feats, feat_pt)
    st["tri"] = jtrk.triangulate_with_ref(st["m1"], kf, kf - 1, cam)
    st["m2"], _ = jmu.admit_new_points(st["m1"], kf, kf - 1, st["tri"], n_pts, room)
    st["m3"], _ = jmu.fuse_in_neighbors(st["m2"], kf, cam, W, H, n_neighbors=1)
    st["win"] = jlm.select_covis_window(st["m3"], kf, kw["w_free"], kw["w_fixed"])
    st["prob"], st["sel"] = jlm.build_local_ba(
        st["m3"], st["win"][0], st["win"][1], cam, bf=bf, entry_valid=st["win"][2]
    )
    st["res"] = jba.bundle_adjust(st["prob"], n_iters=kw["n_iters"], rel_tol=1e-3)
    return st


def test_triangulate_with_ref(run):
    # The epipolar search is integer logic over exact distances: equal.
    # The DLT point is the smallest eigenvector of a 4x4 system that is
    # ill-conditioned at low parallax, so the two packages' float32 eigh
    # (other LAPACK builds) differ by up to 2.5e-3 relative there
    # (measured): points to 5e-3, and the rows accepted at the
    # reprojection thresholds >= 99% alike.
    kf, j = run["kf"], run["tri"]
    t = ttrk.triangulate_with_ref(torch_map(run["m1"]), kf, kf - 1, T(run["cam"]))
    assert int(j.n_new) > 10
    assert t.ref_feat.dtype == torch.int32
    np.testing.assert_array_equal(t.ref_feat.numpy(), np.asarray(j.ref_feat))
    ok_t, ok_j = t.ok.numpy(), np.asarray(j.ok)
    assert (ok_t == ok_j).mean() >= 0.99
    both = ok_t & ok_j
    np.testing.assert_allclose(t.X_w.numpy()[both], np.asarray(j.X_w)[both], rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("room", [None, 7])
def test_admit_new_points(run, room):
    # Fed the JAX triangulation: the masked scatter-adds are exact.
    kf = run["kf"]
    room = run["room"] if room is None else room
    jm, nj = jmu.admit_new_points(run["m1"], kf, kf - 1, run["tri"], run["n_pts"], room)
    tri = ttrk.TriangulationResult(*(T(np.asarray(x)) for x in run["tri"]))
    tm, nt = tmu.admit_new_points(torch_map(run["m1"]), kf, kf - 1, tri, run["n_pts"], room)
    assert int(nt) == int(nj) > 0
    assert_map_equal(tm, jm)


def plant_duplicate(jm, kf):
    """A copy of a landmark that keyframe ``kf`` and its most covisible
    neighbour both observe, in a free slot, with ``kf``'s observation moved
    to the copy: fusing the two keyframes must merge it back."""
    m = {k: np.array(v) for k, v in np_tree(jm).items()}
    obs = np.asarray(jms.obs_matrix(jm, dense=False))
    w = obs.astype(np.float32) @ obs[kf].astype(np.float32)
    w[kf] = -1
    nk = int(np.argmax(np.where(m["kf_valid"], w, -1)))
    common = np.flatnonzero(obs[kf] & obs[nk] & m["pt_valid"])
    q = int(common[0])
    p = int(np.flatnonzero(~m["pt_valid"])[0])
    for k in ("pt_X", "pt_desc_sign", "pt_level", "pt_normal", "pt_min_dist", "pt_max_dist"):
        m[k][p] = m[k][q]
    m["pt_valid"][p] = True
    m["pt_first_kf"][p] = kf
    m["kf_obs"][kf][m["kf_obs"][kf] == q] = p
    return jms.MapState(**m), p, q


@pytest.mark.parametrize("planted", [False, True])
def test_fuse_in_neighbors(run, planted):
    # Binds and merges are integer logic on the matcher's exact output:
    # every field equal. The planted duplicate forces a merge.
    kf, cam = run["kf"], run["cam"]
    jm = run["m2"]
    if planted:
        jm, p, q = plant_duplicate(jm, kf)
    jout, nj = jmu.fuse_in_neighbors(jm, kf, cam, W, H, n_neighbors=1)
    tout, nt = tmu.fuse_in_neighbors(torch_map(jm), kf, T(cam), W, H, n_neighbors=1)
    assert int(nt) == int(nj) > 0
    assert_map_equal(tout, jout)
    obs_before = np.asarray(jm.kf_obs)
    obs_after = tout.kf_obs.numpy()
    assert ((obs_before < 0) & (obs_after >= 0)).any()  # a bind
    if planted:
        assert not tout.pt_valid[p] and tout.pt_valid[q]  # the merge keeps q
        assert not (obs_after == p).any() and (obs_after[kf] == q).sum() == 1


def test_fuse_writes_only_merge_rows():
    # The remap of a merge. Losers are distinct across merge rows, but in
    # the JAX package every row writes its loser's remap entry: a non-merge
    # row rewrites its own entry to itself, and XLA leaves the order of two
    # writes to one entry open. The port writes the merge rows only.
    # Map: keyframe 0 binds point 0 at feature 0 and point 2 at feature 1;
    # keyframes 1-3 bind point 1, a duplicate of point 2, at feature 1.
    # Fusing point 1 into keyframe 0 merges 2 into 1 (1 has more
    # observers); row 2 (unmatched, already in keyframe 0) has loser 2 too.
    K, N, P = 4, 3, 4
    m = {k: np.array(v) for k, v in np_tree(jms.empty_map(K, N, P)).items()}
    cam = np.asarray([100, 100, 50, 50, 0, 0, 0, 0, 0], np.float32)
    sign = np.where(np.random.default_rng(0).random((2, 256)) < 0.5, 1, -1).astype(np.int8)
    m["kf_valid"][:] = True
    m["kf_feat_valid"][:, :2] = True
    m["kf_xy"][:, 0] = (20.0, 20.0)
    m["kf_xy"][:, 1] = (50.0, 50.0)
    m["kf_desc_sign"][:, 0] = sign[0]
    m["kf_desc_sign"][:, 1] = sign[1]
    m["kf_obs"][0, :2] = (0, 2)
    m["kf_obs"][1:, 1] = 1
    m["pt_valid"][:3] = True
    m["pt_X"][:3] = ((-1.5, -1.5, 5.0), (0.0, 0.0, 5.0), (0.0, 0.0, 5.0))
    m["pt_desc_sign"][:3] = (sign[0], sign[1], sign[1])
    tm, n = tmu._fuse_into_kf(
        tms.from_numpy(m, "cpu"), T(np.asarray([False, True, False, False])), 0,
        torch.tensor(True), T(cam), 100, 100, 3.0,
    )
    assert int(n) == 1
    assert tm.pt_valid.tolist() == [True, True, False, False]
    assert tm.kf_obs[0].tolist() == [0, 1, -1]  # redirected to the winner
    assert not (tm.kf_obs == 2).any()


def covis_tie_map(jm, kf):
    """``jm`` with a keyframe row copied into a free slot: the copy ties
    with its original in covisibility with every keyframe."""
    m = {k: np.array(v) for k, v in np_tree(jm).items()}
    src, dst = kf - 1, int(np.flatnonzero(~m["kf_valid"])[0])
    for k in ("kf_valid", "kf_R", "kf_t", "kf_xy", "kf_level", "kf_feat_valid", "kf_obs", "kf_desc_sign"):
        m[k][dst] = m[k][src]
    return jms.MapState(**m)


@pytest.mark.parametrize("ties", [False, True])
def test_select_covis_window(run, ties):
    # Integer scores with ties and dead entries (more window slots than
    # covisible keyframes): the stable top-k orders them as lax.top_k.
    kf, kw = run["kf"], run["kw"]
    jm = covis_tie_map(run["m3"], kf) if ties else run["m3"]
    jw = jlm.select_covis_window(jm, kf, kw["w_free"], kw["w_fixed"])
    tw = tlm.select_covis_window(torch_map(jm), kf, kw["w_free"], kw["w_fixed"])
    assert not np.asarray(jw[2]).all()  # dead entries present
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tw[0].dtype == torch.int32
    cov = tms.covisibility(torch_map(jm)).numpy()
    np.testing.assert_array_equal(cov, np.asarray(jms.covisibility(jm)))
    if ties:
        row = cov[kf][np.asarray(jm.kf_valid)]
        assert len(np.unique(row[row > 0])) < (row > 0).sum()


def test_build_local_ba(run):
    # A gather and an index compaction: every field equal, but inv_sigma2 =
    # 1 / 1.2^(2 level), where the two packages' pow differ by 1 ulp.
    tp, ts = tlm.build_local_ba(
        torch_map(run["m3"]), *(T(np.asarray(x)) for x in run["win"][:2]), T(run["cam"]),
        entry_valid=T(np.asarray(run["win"][2])),
    )
    np.testing.assert_array_equal(ts.numpy(), np.asarray(run["sel"]))
    assert ts.dtype == torch.int32
    for k, v in np_tree(run["prob"]).items():
        got = getattr(tp, k).numpy()
        assert got.dtype == v.dtype, k
        if k == "inv_sigma2":
            np.testing.assert_allclose(got, v, rtol=2e-7, atol=0)
        else:
            np.testing.assert_array_equal(got, v, err_msg=k)
    assert int(tp.edge_valid.sum()) > 100


def ran_iters(prob, k, res) -> bool:
    """Whether the JAX package's rel_tol loop, which gave ``res``, ran
    exactly ``k`` LM iterations: capped at k it gives ``res`` bit for bit,
    capped at k - 1 it does not (its last iteration was an accepted step,
    which moves the state)."""
    def same(cap):
        r = jba.bundle_adjust(prob, n_iters=cap, rel_tol=1e-3)
        return all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(r[:3], res[:3]))

    return same(k) and (k == 1 or not same(k - 1))


def check_ba(jprob, jres, n_iters):
    """The port's BA on the JAX problem: poses to 1e-4, points by
    ``assert_points_close``, the inlier mask equal, the same iterations
    under rel_tol."""
    tres = tba.bundle_adjust(torch_ba_problem(jprob), n_iters=n_iters, rel_tol=1e-3)
    for k in ("R", "t"):
        np.testing.assert_allclose(getattr(tres, k).numpy(), np.asarray(getattr(jres, k)), rtol=1e-4, atol=1e-4, err_msg=k)
    assert_points_close(tres.X.numpy(), np.asarray(jres.X))
    np.testing.assert_array_equal(tres.inlier.numpy(), np.asarray(jres.inlier))
    assert tres.n_inliers.dtype == torch.int32
    assert ran_iters(jprob, tres.iters, jres), tres.iters
    return tres


def test_bundle_adjust_local_window(run):
    # The real window problem: normal equations summed in another order.
    res = check_ba(run["prob"], run["res"], run["kw"]["n_iters"])
    assert res.iters >= 1


def test_bundle_adjust_perturbed(rng):
    # test_solvers' scene: 5 cameras (2 fixed), perturbed poses and points,
    # 20 gross outliers; fixed cameras stay bit-identical.
    X, Rs, ts, uvs = make_scene(rng, n_pts=120, n_cams=5, noise_px=0.3)
    uvs = uvs.copy()
    uvs[3, :20] += 50.0
    jprob = build_problem(rng, X, Rs, ts, uvs, K_cap=8, P_cap=128, E_cap=768,
                          perturb_scale=0.02, pt_noise=0.03)
    jres = jba.bundle_adjust(jprob, n_iters=12, rel_tol=1e-3)
    tres = check_ba(jprob, jres, 12)
    assert not tres.inlier.numpy()[3 * 120: 3 * 120 + 20].any()
    np.testing.assert_array_equal(tres.R.numpy()[:2], np.asarray(jprob.R)[:2])


def test_apply_and_drop_outliers(run):
    # Scatters of the JAX BA result into the map, dead entries dropped:
    # every field equal.
    wids, _, ev = run["win"]
    jm = jlm.drop_ba_outlier_obs(
        jlm.apply_local_ba(run["m3"], wids, run["sel"], run["res"], ev), wids, run["res"], ev
    )
    tres = tba.BAResult(*(T(np.asarray(x)) for x in run["res"]), iters=0)
    tw, tev = T(np.asarray(wids)), T(np.asarray(ev))
    tm = tlm.apply_local_ba(torch_map(run["m3"]), tw, T(np.asarray(run["sel"])), tres, tev)
    tm = tlm.drop_ba_outlier_obs(tm, tw, tres, tev)
    assert_map_equal(tm, jm, float_tol=0.0)
    assert (np.asarray(jm.kf_t) != np.asarray(run["m3"].kf_t)).any()


@pytest.fixture(scope="module")
def late_map(run):
    """The JAX package's map after the recorded keyframe step."""
    return run["out"][0]


@pytest.mark.parametrize("redundancy", [0.9, 0.5, 0.0])
def test_cull_points_and_keyframes(run, late_map, redundancy):
    n_kf = run["kf"] + 1
    jm = jmu.cull_points(late_map, n_kf)
    tm = tmu.cull_points(torch_map(late_map), n_kf)
    assert_map_equal(tm, jm, fields={"pt_valid"})
    jm2, nj = jmu.cull_keyframes(late_map, n_kf, redundancy=redundancy, dense=False)
    tm2, nt = tmu.cull_keyframes(torch_map(late_map), n_kf, redundancy=redundancy)
    assert int(nt) == int(nj)
    assert_map_equal(tm2, jm2, fields={"kf_valid", "kf_obs"})
    if redundancy == 0.0:
        assert int(nt) == 1
    np.testing.assert_array_equal(
        tms.point_obs_count(torch_map(late_map)).numpy(), np.asarray(jms.point_obs_count(late_map))
    )


@pytest.mark.parametrize("protect_last", [4, 2])
def test_evict_and_compact(run, late_map, protect_last):
    n_kf = run["kf"] + 1
    jm, nj = jmu.evict_one_keyframe(late_map, n_kf, protect_last=protect_last)
    tm, nt = tmu.evict_one_keyframe(torch_map(late_map), n_kf, protect_last=protect_last)
    assert int(nt) == int(nj) == (1 if protect_last == 2 else 0)
    assert_map_equal(tm, jm, fields={"kf_valid", "kf_obs"})
    jc, jn, jo = jmu.compact_keyframes(jm)
    tc, tn, to = tmu.compact_keyframes(tm)
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert to.dtype == torch.int32
    assert_map_equal(tc, jc, float_tol=0.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_dedup_obs_rows(seed):
    # Rows with repeated landmark ids, some rewritten by a remap.
    rng = np.random.default_rng(seed)
    K, N, P = 6, 40, 12
    obs = rng.integers(-1, P, (K, N)).astype(np.int32)
    changed = (rng.random((K, N)) < 0.4) & (obs >= 0)
    j = np.asarray(jmu.dedup_obs_rows(jnp.asarray(obs), jnp.asarray(changed), P))
    t = tmu.dedup_obs_rows(T(obs), T(changed), P).numpy()
    np.testing.assert_array_equal(t, j)
    for row in t:
        ids = row[row >= 0]
        assert len(ids) == len(np.unique(ids))


def test_keyframe_work(run, monkeypatch):
    # One whole keyframe step from the same map and tracking output. Integer
    # and bool fields equal; floats to 1e-5, but the local BA's output
    # (poses to 1e-4, landmark geometry by assert_points_close): its normal
    # equations are summed in another order. The new points enter as the
    # JAX package's triangulation, as every stage of this file gets the JAX
    # package's intermediate: the port solves the DLT by inverse iteration
    # (no host read), the JAX package by float32 eigh, up to 2.5e-3 apart at
    # low parallax, which test_triangulate_with_ref holds.
    jtri = ttrk.TriangulationResult(*(T(np.asarray(x)) for x in run["tri"]))
    monkeypatch.setattr(ttrk, "triangulate_with_ref", lambda *a, **k: jtri)
    args, kw, (jm, nj) = run["args"], run["kw"], run["out"]
    m0, kf, R, t, ts, feats, feat_pt, n_pts, room, cam, bf = args
    tm, nt, iters = tkf.keyframe_work(
        torch_map(m0), int(kf), T(np.asarray(R)), T(np.asarray(t)), float(ts),
        torch_features(feats), T(np.asarray(feat_pt)), int(n_pts), int(room), T(cam),
        w_free=kw["w_free"], w_fixed=kw["w_fixed"], n_iters=kw["n_iters"],
        n_levels=kw["n_levels"], fuse_neighbors=kw["fuse_neighbors"],
        do_fuse=kw["do_fuse"], do_stats=kw["do_stats"], do_cull=kw["do_cull"],
        width=kw["width"], height=kw["height"],
    )
    assert int(nt) == int(nj) and iters >= 1
    assert_map_equal(tm, jm, fields={"kf_R", "kf_t"}, float_tol=1e-4)
    assert_map_equal(tm, jm, fields=set(np_tree(jm)) - {"kf_R", "kf_t"}, solved=True)


def test_covisibility_random_map():
    # Random observations, invalid features and an invalid keyframe.
    rng = np.random.default_rng(3)
    K, N, P = 6, 30, 25
    m = {k: np.array(v) for k, v in np_tree(jms.empty_map(K, N, P)).items()}
    m["kf_valid"][:5] = True
    m["kf_R"] = np.asarray(jlie.so3_exp(rng.normal(0, 0.2, (K, 3)).astype(np.float32)))
    m["kf_feat_valid"] = rng.random((K, N)) < 0.9
    m["kf_obs"] = rng.integers(-1, P, (K, N)).astype(np.int32)
    jm = jms.MapState(**m)
    np.testing.assert_array_equal(
        tms.covisibility(tms.from_numpy(m, "cpu")).numpy(), np.asarray(jms.covisibility(jm))
    )
