"""The two-view front ends of the per-frame stereo, RGB-D and two-camera
systems (``models/front_end_program.py``) against the JAX package's: the
rig's ``FisheyeStereoSlam._frame_program`` (both extractions, the
cross-camera triangulation, the right view's pixels; and the virtual
``StereoMatch`` its ``process_frame`` derives), the stereo frame's jitted
``_extract`` + ``_match_stereo`` and the RGB-D frame's ``_extract`` +
``_depth_to_match``. Each is held twice: the whole front end on the same
images (feature sets compared as sets, where extraction near-ties can
differ), and the stage after the extraction on the JAX package's features
(exact where nothing is summed). Then the program itself: its run equals
the eager function, its outputs are copies that the next frame's run does
not overwrite, and each system runs its front end once a frame.

The images are the port's renderer's (``tests/test_torch_stereo.py`` holds
it to the JAX renderer's): a KB8 pair at 240x376 of ``make_room(seed=2)``
for the rig (``tests/test_torch_twocam.py``'s), a rectified pair with its
depth map of ``make_sequence(seed=3)`` for stereo and RGB-D. Tolerances are
stated where they are compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.models import fisheye_stereo as jfs
from orb_slam3_ros_tpu.models import stereo_system as jss
from orb_slam3_ros_tpu_torch.models import front_end_program as fep
from orb_slam3_ros_tpu_torch.models import stereo_system as tss
from orb_slam3_ros_tpu_torch.ops import orb as torb
from orb_slam3_ros_tpu_torch.utils import synth as tsynth
from torch_cases import T
from torch_parity import np_tree, torch_features

torch.set_num_threads(1)
H, W, N_FEATURES = 240, 376, 800
KB8 = np.asarray([150.0, 150.0, 187.5, 119.5, 0.02, 0.001, -0.002, 0.0002], np.float32)
RIG_BASELINE, ST_BASELINE = 0.11, 0.12
R_RL = np.eye(3, dtype=np.float32)
T_RL = np.asarray([-RIG_BASELINE, 0.0, 0.0], np.float32)  # X_r = X_l - b


@pytest.fixture(scope="module")
def rig():
    """The KB8 pair, the JAX rig's frame program on it, and the port's
    configuration of the same rig."""
    scene = tsynth.make_room(seed=2, device="cpu")
    il, _ = tsynth.render(scene, np.eye(3), np.zeros(3), KB8, height=H, width=W, cam_model="kb8")
    ir, _ = tsynth.render(scene, np.eye(3), np.asarray([RIG_BASELINE, 0.0, 0.0]), KB8, height=H,
                          width=W, cam_model="kb8")
    jslam = jfs.FisheyeStereoSlam(height=H, width=W, cam_params=KB8, n_features=N_FEATURES,
                                  R_rl=R_RL, t_rl=T_RL)
    fl, cross, uv_right = jslam._frame_program()(jnp.asarray(il.numpy()), jnp.asarray(ir.numpy()))
    # the JAX process_frame's virtual StereoMatch of the cross match
    z = cross.X_l[:, 2]
    cand = cross.ok & (z > 0.05) & (z < jslam.max_depth)
    sm = dict(u_right=jnp.where(cand, fl.xy[:, 0] - jslam.bf / jnp.maximum(z, 1e-3), -1.0),
              depth=jnp.where(cand, z, -1.0), valid=cand)
    cfg = fep.FrontEndConfig(
        kind="rig", config=torb.default_config(H, W, n_features=N_FEATURES), height=H, width=W,
        cam_params=T(KB8), cam_model="kb8", bf=jslam.bf, max_depth=jslam.max_depth,
        R_rl=T(R_RL), t_rl=T(T_RL))
    return dict(il=il, ir=ir, cfg=cfg, jfl=fl, jfr=jslam._extract(jnp.asarray(ir.numpy())),
                jax=dict(feats=np_tree(fl), cross=np_tree(cross), uv_right=np.asarray(uv_right),
                         sm={k: np.asarray(v) for k, v in sm.items()}))


@pytest.fixture(scope="module")
def pair():
    """A rectified pair with the left view's depth map, both JAX front ends
    on it and the port's configurations."""
    seq = tsynth.make_sequence(n_frames=1, height=H, width=W, dt=0.1, seed=3,
                               stereo_baseline=ST_BASELINE, with_depth=True, device="cpu")
    cam = seq.cam_params
    il, ir, dm = seq.images[0], seq.images_right[0], seq.depths[0].clone()
    dm[100:140, 150:250] = 0.0  # a hole in the sensor's depth
    jst = jss.StereoSlam(height=H, width=W, cam_params=cam, n_features=N_FEATURES,
                         baseline=ST_BASELINE)
    jl, jr = jnp.asarray(il.numpy()), jnp.asarray(ir.numpy())
    jfl, jfr = jst._extract(jl), jst._extract(jr)
    jsm = jst._match_stereo(jfl, jfr, jl, jr)
    jrgbd = jss.RgbdSlam(height=H, width=W, cam_params=cam, n_features=N_FEATURES)
    jdsm = jrgbd._depth_to_match(jfl, jnp.asarray(dm.numpy()))
    config = torb.default_config(H, W, n_features=N_FEATURES)
    return dict(
        il=il, ir=ir, dm=dm, jfl=jfl, jfr=jfr, bf_rgbd=jrgbd.bf,
        stereo=fep.FrontEndConfig(kind="stereo", config=config, height=H, width=W,
                                  cam_params=T(np.asarray(cam, np.float32)), cam_model="pinhole",
                                  fx=float(cam[0]), baseline=ST_BASELINE),
        rgbd=fep.FrontEndConfig(kind="rgbd", config=config, height=H, width=W,
                                cam_params=T(np.asarray(cam, np.float32)), cam_model="pinhole",
                                bf=jrgbd.bf),
        jax=dict(feats=np_tree(jfl), stereo={k: np.asarray(v) for k, v in jsm._asdict().items()},
                 rgbd={k: np.asarray(v) for k, v in jdsm._asdict().items()}),
    )


@pytest.fixture(scope="module")
def runs(rig, pair):
    """Each front end's program run once on its images (eagerly: the CPU)."""
    out = {}
    for kind, cfg, a, b in (("rig", rig["cfg"], rig["il"], rig["ir"]),
                            ("stereo", pair["stereo"], pair["il"], pair["ir"]),
                            ("rgbd", pair["rgbd"], pair["il"], pair["dm"])):
        prog = fep.FrontEndProgram(cfg, "cpu")
        out[kind] = (prog, prog.run(a, b))
    return out


def _keys(feats: dict) -> dict:
    """Valid features by (x, y, level), x and y to 1/64 px: index."""
    xy = np.round(np.asarray(feats["xy"]) * 64).astype(np.int64)
    lv = np.asarray(feats["level"])
    return {(x, y, int(l)): i for i, ((x, y), l, v) in
            enumerate(zip(xy, lv, np.asarray(feats["valid"]))) if v}


def _np(fe: fep.FrontEnd) -> dict:
    return dict(feats={k: v.numpy() for k, v in fe.feats._asdict().items()},
                sm={k: v.numpy() for k, v in fe.sm._asdict().items()})


# ---- the whole front end on the same images ----
# Feature sets as sets: >= 99% of each package's valid features in the
# other's, by position (1/64 px) and level; the descriptors of the common
# features >= 99% equal bit for bit (measured: the sets equal, 646-648
# features, and every descriptor).
@pytest.mark.parametrize("kind", ["rig", "stereo", "rgbd"])
def test_features_are_the_jax_packages(rig, pair, runs, kind):
    want = (rig if kind == "rig" else pair)["jax"]["feats"]
    got = _np(runs[kind][1])["feats"]
    kj, kt = _keys(want), _keys(got)
    common = kj.keys() & kt.keys()
    assert len(kj) > 300
    assert len(common) >= 0.99 * max(len(kj), len(kt))
    ij = [kj[k] for k in common]
    it = [kt[k] for k in common]
    same = np.all(want["desc_sign"][ij] == got["desc_sign"][it], axis=1)
    assert same.mean() >= 0.99


# The rig's cross match on the same images: on the common features, the
# cross-matched sets >= 97% alike (a match hangs on both views' features and
# a near-tie in either flips it), and where both matched the same right
# feature the point within 1e-3 relative and its right pixel equal.
def test_rig_cross_match_on_the_same_images(rig, runs):
    j, fe = rig["jax"], runs["rig"][1]
    kj, kt = _keys(j["feats"]), _keys(_np(fe)["feats"])
    common = sorted(kj.keys() & kt.keys())
    ij = np.asarray([kj[k] for k in common])
    it = np.asarray([kt[k] for k in common])
    ok_j, ok_t = j["cross"]["ok"][ij], fe.cross.ok.numpy()[it]
    assert ok_j.sum() > 60
    assert (ok_j == ok_t).mean() >= 0.97
    both = ok_j & ok_t & (j["uv_right"][ij] == fe.uv_right.numpy()[it]).all(axis=1)
    assert both.sum() >= 0.95 * ok_j.sum()
    Xj, Xt = j["cross"]["X_l"][ij][both], fe.cross.X_l.numpy()[it][both]
    assert (np.linalg.norm(Xj - Xt, axis=1) / np.linalg.norm(Xj, axis=1)).max() <= 1e-3


# The stereo match on the same images, on the common features: valid sets
# >= 99% alike, u_right within 1e-3 px and depth within 1e-4 relative where
# both are valid (test_torch_stereo.py's tolerances).
def test_stereo_match_on_the_same_images(pair, runs):
    j, t = pair["jax"], _np(runs["stereo"][1])
    kj, kt = _keys(j["feats"]), _keys(t["feats"])
    common = sorted(kj.keys() & kt.keys())
    ij = np.asarray([kj[k] for k in common])
    it = np.asarray([kt[k] for k in common])
    vj, vt = j["stereo"]["valid"][ij], t["sm"]["valid"][it]
    assert vj.sum() > 100 and (vj == vt).mean() >= 0.99
    both = vj & vt
    assert np.abs(j["stereo"]["u_right"][ij][both] - t["sm"]["u_right"][it][both]).max() <= 1e-3
    dj, dt = j["stereo"]["depth"][ij][both], t["sm"]["depth"][it][both]
    assert (np.abs(dj - dt) / dj).max() <= 1e-4


# RGB-D on the same images, on the common features: the sampled depth and
# its validity equal, u_r within 1e-4 px.
def test_rgbd_match_on_the_same_images(pair, runs):
    j, t = pair["jax"], _np(runs["rgbd"][1])
    kj, kt = _keys(j["feats"]), _keys(t["feats"])
    common = sorted(kj.keys() & kt.keys())
    ij = np.asarray([kj[k] for k in common])
    it = np.asarray([kt[k] for k in common])
    np.testing.assert_array_equal(t["sm"]["valid"][it], j["rgbd"]["valid"][ij])
    np.testing.assert_array_equal(t["sm"]["depth"][it], j["rgbd"]["depth"][ij])
    np.testing.assert_allclose(t["sm"]["u_right"][it], j["rgbd"]["u_right"][ij], atol=1e-4)
    assert (~t["sm"]["valid"][it] & j["feats"]["valid"][ij]).sum() > 10  # the hole took some


# ---- the stage after the extraction, on the JAX package's features ----
# The rig, at test_torch_twocam.py's tolerances for the cross match: the
# same right features (the dense Hamming search is exact), ok on 99.5% of
# the features alike and n_new within 1 (the reprojection gates compare
# float32 chi2s), the points both keep within 1e-3 of their depth and their
# right pixels equal; the virtual StereoMatch valid where the same gates
# pass, its depth to the points' tolerance and u_r within 1e-2 px.
def test_rig_views_on_jax_features(rig):
    fe = fep.rig_views(torch_features(rig["jfl"]), torch_features(rig["jfr"]), rig["cfg"])
    j = rig["jax"]
    ok_j, ok_t = j["cross"]["ok"], fe.cross.ok.numpy()
    assert ok_j.sum() >= 80 and (ok_j == ok_t).mean() >= 0.995
    assert abs(int(fe.cross.n_new) - int(j["cross"]["n_new"])) <= 1
    np.testing.assert_array_equal(fe.cross.right_feat.numpy(), j["cross"]["right_feat"])
    np.testing.assert_array_equal(fe.uv_right.numpy(), j["uv_right"])
    both = ok_j & ok_t
    Xj, Xt = j["cross"]["X_l"][both], fe.cross.X_l.numpy()[both]
    assert np.all(np.abs(Xt - Xj).max(-1) <= 1e-3 * np.maximum(1.0, Xj[:, 2]))
    vj, vt = j["sm"]["valid"], fe.sm.valid.numpy()
    assert (vj == vt).mean() >= 0.995 and vj.sum() >= 80
    v = vj & vt
    np.testing.assert_allclose(fe.sm.depth.numpy()[v], j["sm"]["depth"][v], rtol=1e-3)
    np.testing.assert_allclose(fe.sm.u_right.numpy()[v], j["sm"]["u_right"][v], atol=1e-2)
    assert np.all(fe.sm.u_right.numpy()[~vt] == -1) and np.all(fe.sm.depth.numpy()[~vt] == -1)


# RGB-D: ``depth_to_match`` on the JAX features equals the JAX package's
# ``_depth_to_match``: validity and depth equal, u_r within 1e-4 px.
def test_depth_to_match_on_jax_features(pair):
    t = fep.depth_to_match(torch_features(pair["jfl"]), pair["dm"], pair["bf_rgbd"])
    j = pair["jax"]["rgbd"]
    np.testing.assert_array_equal(t.valid.numpy(), j["valid"])
    np.testing.assert_array_equal(t.depth.numpy(), j["depth"])
    np.testing.assert_allclose(t.u_right.numpy(), j["u_right"], atol=1e-4)


# ---- the program ----
# The program's run equals its eager function on the same images, exactly.
@pytest.mark.parametrize("kind", ["rig", "stereo", "rgbd"])
def test_program_equals_the_eager_front_end(rig, pair, runs, kind):
    a, b = ((rig["il"], rig["ir"]) if kind == "rig" else
            (pair["il"], pair["dm"] if kind == "rgbd" else pair["ir"]))
    prog, got = runs[kind]
    want = fep.FRONT_ENDS[kind](a, b, prog.cfg)
    for k, v in fep._outputs(want).items():
        assert torch.equal(fep._outputs(got)[k], v), k
    assert prog.runs == {"front": 1}


# A run's outputs are copies: the next frame's run overwrites the buffers,
# not what the previous run returned.
def test_outputs_outlive_the_next_run(pair):
    prog = fep.FrontEndProgram(pair["rgbd"], "cpu")
    first = prog.run(pair["il"], pair["dm"])
    kept = {k: v.clone() for k, v in fep._outputs(first).items()}
    second = prog.run(pair["ir"], pair["dm"] * 2.0)
    assert not torch.equal(second.sm.depth, first.sm.depth)
    for k, v in fep._outputs(first).items():
        assert torch.equal(v, kept[k]), k


def test_unknown_front_end_raises(pair):
    with pytest.raises(ValueError, match="unknown front end"):
        fep.FrontEndProgram(pair["rgbd"]._replace(kind="mono"), "cpu")


# Each system runs its front end once a frame, under the stage timer's
# names, with the depth map or the right view in the program's second
# buffer.
def test_rgbd_system_runs_its_front_end_once_a_frame(pair):
    slam = tss.RgbdSlam(height=H, width=W, cam_params=pair["stereo"].cam_params.numpy(),
                        n_features=N_FEATURES, max_keyframes=8, max_points=2048, device="cpu")
    for i in range(2):
        slam.process_frame(pair["il"], pair["dm"], 0.1 * i)
    prog = slam._front_prog
    assert prog.cfg.kind == "rgbd" and prog.runs == {"front": 2}
    assert torch.equal(prog.buf["img2"], pair["dm"])
    assert "extract+depth" in slam.timing_summary()
