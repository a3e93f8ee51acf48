"""The synchronous frames' tracking programs: ``MonoSlam(pipelined=False)``'s
frame through the frame program (``models/frame_program.py``, the JAX
package's ``_fused_track``) and the stereo, RGB-D and two-camera frames'
tracking and refinement through ``models/track_program.py`` (the JAX
package's ``track_against_map`` followed by ``_stereo_refine``,
``_twocam_refine`` or, once the IMU is initialized, the preintegration and
``_vi_refine``), run eagerly on the CPU.

Against the plain path: a frame through ``process_frame`` equals, to the
bit, the same frame on a deep copy of the system through the eager path the
systems ran before the programs, composed here from the plain functions
(``orb.extract``, ``_predict_motion``, ``_track_res``, the refinements,
``_track_post`` / ``_vi_post``): the pose returned, the host state, the
tracked features' landmarks, the map's visibility counters, and with an
IMU the velocity, biases, anchor and prior. Under "vi" the IMU prediction
runs on the device inside the program, as the JAX package makes it, where
the eager path read it to the host and made the motion model in numpy:
the plain path here makes it on the device too, and one case holds the
two forms to float32 rounding. The cases cover both schedules,
``track_window``, ``track_cap``, the anchor from the host and from the
device, and a RECENTLY_LOST frame.

Against the JAX package: on the same numpy inputs the program's body
(``track_program.eager_track``) is held to the JAX functions at the stated
tolerances: inliers within 1, pose within 2e-4, under "vi" the velocity
within 2e-3 and the biases within 1e-4 (``test_torch_vi_lag.py``'s). Each
JAX function compiles once, in the module's fixture.

The two-view frames' maps and features are made with numpy from a seed: a
camera that moves a few centimetres and turns a little from the previous
frame, landmarks drawn in its view, each frame feature a landmark's
projection with pixel noise and a few descriptor bits flipped, the right
view's x (stereo) or the right camera's pixels through ``R_rl``, ``t_rl``
(the rig) from the true depth, and for the inertial systems the IMU samples
of that motion. The monocular frame is rendered (``synth``), its map seeded
from the rendered depth.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.models import fisheye_stereo as jfs
from orb_slam3_ros_tpu.models import inertial_system as jis
from orb_slam3_ros_tpu.models import map_state as jms
from orb_slam3_ros_tpu.models import stereo_system as jss
from orb_slam3_ros_tpu.models import tracking as jtrk
from orb_slam3_ros_tpu.ops import imu as jimu
from orb_slam3_ros_tpu.ops import orb as jorb
from orb_slam3_ros_tpu_torch.models import fisheye_stereo as tfs
from orb_slam3_ros_tpu_torch.models import inertial_system as tis
from orb_slam3_ros_tpu_torch.models import map_state as tms
from orb_slam3_ros_tpu_torch.models import stereo_system as tss
from orb_slam3_ros_tpu_torch.models import system as tsys
from orb_slam3_ros_tpu_torch.models import track_program as tp
from orb_slam3_ros_tpu_torch.models import tracking as ttrk
from orb_slam3_ros_tpu_torch.models.front_end_program import FrontEnd
from orb_slam3_ros_tpu_torch.ops import cameras as tcam
from orb_slam3_ros_tpu_torch.ops import imu as timu
from orb_slam3_ros_tpu_torch.ops import orb as torb
from orb_slam3_ros_tpu_torch.ops import stereo as tst
from orb_slam3_ros_tpu_torch.ops import twocam as ttc
from orb_slam3_ros_tpu_torch.ops import viba as tviba
from orb_slam3_ros_tpu_torch.utils import synth
from vi_sim import make_calib

torch.set_num_threads(1)
H, W = 240, 376
N_FEATURES = 100  # 128 feature slots
K_CAP, P_CAP, N_PTS, N_KF = 8, 512, 400, 6
BASELINE = 0.12
PIN = np.asarray([220, 220, 187.5, 119.5, 0, 0, 0, 0, 0], np.float32)
KB8 = np.asarray([150.0, 150.0, 187.5, 119.5, 0.02, 0.001, -0.002, 0.0002], np.float32)
R_RL = np.eye(3, dtype=np.float32)
T_RL = np.asarray([-BASELINE, 0, 0], np.float32)
DT, N_IMU = 0.1, 10  # seconds between frames, IMU samples a frame
GRAVITY = np.asarray([0, 0, -9.81])
TS0 = 5.0  # the compared frame's timestamp
LEAN = tuple(tuple(p) for p in ttrk.SCHEDULE_LEAN)


def _so3_exp(w):
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w)
    K = np.asarray([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + K
    return np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th**2 * K @ K


def _so3_log(R):
    th = np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))
    w = np.asarray([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2
    return w if th < 1e-9 else w * th / np.sin(th)


# Frame poses (Tcw): the previous frame's, then two frames on.
POSES = [(_so3_exp([0.01 * i, 0.02 * i, 0.003 * i]), np.asarray([0.03, 0.005, 0.02]) * i)
         for i in range(3)]  # (R_wc, centre)


def _tcw(i):
    R_wc, c = POSES[i]
    return R_wc.T.astype(np.float32), (-R_wc.T @ c).astype(np.float32)


_SCENES = {}


def _scene(cam_model: str) -> dict:
    """The numpy map (``N_PTS`` landmarks seen from frame 1, keyframes 0..N_KF-1
    made at frame 0's pose) and frames 1 and 2's features under
    ``cam_model``; made once a camera."""
    if cam_model in _SCENES:
        return _SCENES[cam_model]
    cam = KB8 if cam_model == "kb8" else PIN
    rng = np.random.default_rng(1 if cam_model == "kb8" else 0)
    R1, t1 = _tcw(1)
    uv = rng.uniform([20, 20], [W - 20, H - 20], (N_PTS, 2)).astype(np.float32)
    ray = tcam.unproject_model(torch.as_tensor(cam), torch.as_tensor(uv), cam_model).numpy()
    Xc = ray / ray[:, 2:3] * rng.uniform(1.5, 4.0, (N_PTS, 1))
    X = ((Xc - t1) @ R1).astype(np.float32)
    desc = rng.choice(np.asarray([-1, 1], np.int8), size=(N_PTS, 256))
    level = rng.choice(3, size=N_PTS, p=[0.6, 0.3, 0.1]).astype(np.int32)
    m = {k: np.array(v) for k, v in tms.to_numpy(tms.empty_map(K_CAP, 128, P_CAP, device="cpu")).items()}
    R0, t0 = _tcw(0)
    m["kf_valid"][:N_KF] = True
    m["kf_R"][:N_KF], m["kf_t"][:N_KF] = R0, t0
    m["kf_ts"][:N_KF] = TS0 - DT * (N_KF - np.arange(N_KF))
    m["pt_valid"][:N_PTS] = True
    m["pt_X"][:N_PTS], m["pt_desc_sign"][:N_PTS], m["pt_level"][:N_PTS] = X, desc, level
    m["pt_first_kf"][:N_PTS] = rng.integers(0, N_KF, N_PTS)
    po = X - POSES[0][1]
    dist = np.linalg.norm(po, axis=1)
    m["pt_normal"][:N_PTS] = po / dist[:, None]
    m["pt_min_dist"][:N_PTS], m["pt_max_dist"][:N_PTS] = 0.5 * dist, 2.0 * dist
    frames = [_frame(rng, cam, cam_model, X, desc, level, *_tcw(i)) for i in (1, 2)]
    _SCENES[cam_model] = dict(cam=cam, map=m, frames=frames)
    return _SCENES[cam_model]


def _frame(rng, cam, cam_model, X, desc, level, R, t) -> dict:
    """A frame's features at pose (R, t): the landmarks it sees (at most
    the slots but 8), with noise, and their stereo and cross-camera
    correspondences, as numpy."""
    camt = torch.as_tensor(cam)
    N = torb.default_config(H, W, n_features=N_FEATURES).total_cap
    Xc = X @ R.T + t
    uv = tcam.project_model(camt, torch.as_tensor(Xc), cam_model).numpy()
    vis = np.flatnonzero((Xc[:, 2] > 0.3) & (uv[:, 0] > 8) & (uv[:, 0] < W - 8)
                         & (uv[:, 1] > 8) & (uv[:, 1] < H - 8))
    pts = rng.permutation(vis)[: N - 8]
    n = len(pts)
    d = desc[pts].copy()
    flip = rng.integers(0, 256, (n, 6))
    np.put_along_axis(d, flip, -np.take_along_axis(d, flip, 1), 1)
    f = dict(xy=np.zeros((N, 2), np.float32), level=np.zeros(N, np.int32),
             angle=np.zeros(N, np.float32), response=np.ones(N, np.float32),
             desc_packed=np.zeros((N, 8), np.int32), desc_sign=np.zeros((N, 256), np.int8),
             valid=np.zeros(N, bool))
    f["xy"][:n] = uv[pts] + rng.normal(0, 0.3, (n, 2))
    f["level"][:n], f["desc_sign"][:n], f["valid"][:n] = level[pts], d, True
    z = np.full(N, -1.0, np.float32)
    z[:n] = Xc[pts, 2]
    # stereo: a depth (and so a right view's x) for 80% of the features
    sm_valid = f["valid"] & (rng.uniform(size=N) < 0.8)
    # the rig: the right camera's pixels of each feature's landmark
    X_r = Xc[pts] @ R_RL.T + T_RL
    uv_r = np.zeros((N, 2), np.float32)
    uv_r[:n] = tcam.project_model(camt, torch.as_tensor(X_r.astype(np.float32)),
                                  cam_model).numpy() + rng.normal(0, 0.3, (n, 2))
    cross_ok = f["valid"] & (rng.uniform(size=N) < 0.7)
    cross_ok[:n] &= (uv_r[:n, 0] > 0) & (uv_r[:n, 0] < W) & (X_r[:, 2] > 0.3)
    X_l = np.zeros((N, 3), np.float32)
    X_l[:n] = Xc[pts]
    return dict(feats=f, depth=np.where(sm_valid, z, -1.0).astype(np.float32),
                sm_valid=sm_valid, uv_right=uv_r, cross_ok=cross_ok, X_l=X_l)


def _u_right(fr: dict, bf: float) -> np.ndarray:
    """The right view's x of each feature with a depth (-1 elsewhere) at
    ``bf`` = fx * baseline."""
    ok = fr["sm_valid"]
    return np.where(ok, fr["feats"]["xy"][:, 0] - bf / np.maximum(fr["depth"], 1e-3),
                    -1.0).astype(np.float32)


def _front_end(fr: dict, bf: float) -> FrontEnd:
    """A frame's ``FrontEnd`` as the front-end program makes it."""
    T = torch.as_tensor
    feats = torb.features_from_numpy(fr["feats"], "cpu")
    sm = tst.StereoMatch(u_right=T(_u_right(fr, bf)), depth=T(fr["depth"]),
                         valid=T(fr["sm_valid"]))
    cross = ttc.CrossCamTriangulation(
        X_l=T(fr["X_l"]), right_feat=torch.arange(len(fr["cross_ok"]), dtype=torch.int32),
        ok=T(fr["cross_ok"]), n_new=T(np.int32(fr["cross_ok"].sum())))
    return FrontEnd(feats=feats, sm=sm, cross=cross, uv_right=T(fr["uv_right"]))


class _Front:
    """Stands for a system's front-end program: ``run`` returns the next
    prepared ``FrontEnd``."""

    def __init__(self, fes):
        self.fes = list(fes)

    def run(self, *_):
        return self.fes.pop(0)


def _imu(i: int):
    """The IMU samples of frame i-1 -> i (body = camera, no bias): the
    body turning at a constant rate, the world velocity constant."""
    (Ra, ca), (Rb, cb) = POSES[i - 1], POSES[i]
    w = _so3_log(Ra.T @ Rb) / DT
    ts = (np.arange(N_IMU) + 0.5) * DT / N_IMU
    acc = np.stack([(Ra @ _so3_exp(w * s)).T @ -GRAVITY for s in ts]).astype(np.float32)
    gyro = np.tile(w, (N_IMU, 1)).astype(np.float32)
    return acc, gyro, np.full(N_IMU, DT / N_IMU, np.float32), ((cb - ca) / DT).astype(np.float32)


CLASSES = {
    "stereo": (tss.StereoSlam, "pinhole", dict(baseline=BASELINE)),
    "rgbd": (tss.RgbdSlam, "pinhole", dict()),
    "rig_kb8": (tfs.FisheyeStereoSlam, "kb8", dict(R_rl=R_RL, t_rl=T_RL)),
    "rig_pinhole": (tfs.FisheyeStereoSlam, "pinhole", dict(R_rl=R_RL, t_rl=T_RL,
                                                           cam_model="pinhole")),
    "stereo_inertial": (tss.StereoInertialSlam, "pinhole", dict(baseline=BASELINE)),
    "rgbd_inertial": (tss.RgbdInertialSlam, "pinhole", dict()),
    "rig_inertial": (tfs.FisheyeStereoInertialSlam, "kb8", dict(R_rl=R_RL, t_rl=T_RL)),
}


def _system(name: str, lean: bool, **extra):
    """System ``name`` tracking at frame 1 against the numpy map, from
    frame 0's pose with the true velocity: with an IMU, initialized, at
    rest in its biases."""
    cls, cam_model, kw = CLASSES[name]
    sc = _scene(cam_model)
    kw = dict(kw, height=H, width=W, cam_params=sc["cam"], n_features=N_FEATURES,
              max_keyframes=K_CAP, max_points=P_CAP, kf_every=50, device="cpu", **extra)
    if "inertial" in name:
        kw["calib"] = timu.ImuCalib(*(np.asarray(x) for x in make_calib(freq=100.0)))
    slam = cls(**kw)
    slam.lean_after_kf = 0 if lean else 100
    slam.set_map(tms.from_numpy(sc["map"], "cpu"), N_KF, N_PTS, *_tcw(0))
    slam._set_ref_cache(N_KF - 1, *_tcw(0))
    (R0, c0), (R1, c1) = POSES[0], POSES[1]
    R_cw0, t_cw0 = _tcw(0)
    R_cw1, t_cw1 = _tcw(1)
    slam.vel_R = (R_cw1 @ R_cw0.T).astype(np.float32)
    slam.vel_t = (t_cw1 - slam.vel_R @ t_cw0).astype(np.float32)
    if "inertial" in name:
        slam.imu_initialized, slam.imu_stage = True, 1
        slam.v_cur = ((c1 - c0) / DT).astype(np.float32)
    slam._front_prog = _Front(_front_end(fr, slam.bf) for fr in sc["frames"])
    return slam


def _feed(slam, i: int, ts: float):
    """Frame i (1 or 2) through ``process_frame`` (the front end stood in
    for)."""
    blank = np.zeros((H, W), np.float32)
    kw = {}
    if isinstance(slam, tis.InertialSlam):
        acc, gyro, dts, _ = _imu(i)
        kw = dict(acc=acc, gyro=gyro, dts=dts)
    return slam.process_frame(blank, blank, ts, **kw)


# ---- the eager path before the programs, from the plain functions ------------
def _plain_two_view(slam, fe, ts):
    """The stereo / rig frame's OK branch before the tracking program."""
    if not isinstance(slam, tss.RgbdSlam):
        slam._predict_motion(ts)
    res = slam._track_res(fe.feats)
    if isinstance(slam, tfs.FisheyeStereoSlam):
        r2 = tfs._twocam_refine(slam.map, fe.feats, res.feat_pt, fe.cross.ok, fe.uv_right,
                                res.R, res.t, slam.R_rl, slam.t_rl, slam.cam_params,
                                slam.cam_model)
    else:
        ur = torch.where(fe.sm.valid, fe.sm.u_right, -1.0)
        r2 = tss._stereo_refine(slam.map, fe.feats, res.feat_pt, ur, res.R, res.t,
                                slam.cam_params, slam.bf)
    res = res._replace(R=r2.R, t=r2.t, n_inliers=r2.n_inliers)
    return slam._track_post(fe.feats, res, ts)


def _device_prediction(slam):
    """``_predict_motion``'s IMU prediction with its motion-model arithmetic
    on the device, as the JAX package keeps it: (R_pred, t_pred, v), the
    host's motion model and velocity left as ``_predict_motion`` leaves
    them."""
    R_wb, p_wb, v, bg, ba = slam._body_state_from_host()
    b = torch.cat([bg, ba])
    pre = slam._preint_block(slam._frame_block(), b)
    R2, p2, v2 = timu.predict_state(R_wb, p_wb, v, b, pre)
    R_cw, t_cw = tviba.cam_from_body(R2, p2, slam.calib.R_bc, slam.calib.t_bc)
    R_cur, t_cur = torch.as_tensor(slam.R_cur), torch.as_tensor(slam.t_cur)
    vel_R = R_cw @ R_cur.T
    vel_t = t_cw - vel_R @ t_cur
    Rn, tn = R_cw.numpy(), t_cw.numpy()
    slam.vel_R = Rn @ slam.R_cur.T
    slam.vel_t = tn - slam.vel_R @ slam.t_cur
    return vel_R @ R_cur, vel_R @ t_cur + vel_t, v2


def _plain_vi(slam, fe, ts):
    """The inertial two-view frame's OK branch once the IMU is initialized,
    from the plain functions: the IMU prediction (stereo, rig), the
    tracking, then the refinement ``InertialSlam._track_post`` ran, anchored
    at the previous frame's state or at the host's before the prediction."""
    host_anchor = slam._body_state_from_host()  # where the prediction starts
    v0 = torch.as_tensor(slam.v_cur)
    if isinstance(slam, tss.RgbdSlam):
        R_pred, t_pred = (torch.as_tensor(a) for a in slam._host_prediction())
    else:
        R_pred, t_pred, v0 = _device_prediction(slam)
        slam.v_cur = v0.numpy().copy()
    pt_mask = None
    if slam.track_window is not None:
        pt_mask = slam.map.pt_first_kf >= (slam.n_kf - slam.track_window)
    res = ttrk.track_against_map(slam.map, fe.feats, R_pred, t_pred, slam.cam_params, W, H,
                                 pt_mask=pt_mask, schedule=slam._current_schedule(),
                                 track_cap=slam.track_cap, cam_model=slam.cam_model)
    R_anc, p_anc, v_anc, bg_anc, ba_anc = slam._vi_anchor or host_anchor
    Sigma = slam._vi_prior if slam._vi_prior is not None else torch.zeros((15, 15))
    pre = slam._preint_block(slam._frame_block(), torch.cat([bg_anc, ba_anc]))
    vires, R_cw, t_cw = tis._vi_refine(
        slam.map, fe.feats, res.feat_pt, res.R, res.t, v0, bg_anc,
        ba_anc, R_anc, p_anc, v_anc, bg_anc, ba_anc, pre, Sigma, slam.cam_params,
        slam.calib.R_bc, slam.calib.t_bc, slam.cam_model)
    buf = torch.cat([vires.n_inliers.reshape(1).to(torch.float32), R_cw.reshape(9), t_cw,
                     vires.v_w, vires.bg, vires.ba]).numpy()
    return slam._vi_post(fe.feats, res, vires, ts, buf)


def _plain_feed(slam, i: int, ts: float):
    """Frame i through ``process_frame``'s steps with the OK branch on the
    eager path."""
    fe = slam._front_prog.run()
    kw = {}
    if isinstance(slam, tis.InertialSlam):
        acc, gyro, dts, _ = _imu(i)
        kw = dict(acc=acc, gyro=gyro, dts=dts)
        slam._record_frame_imu(ts, **kw)
    slam._check_ts_jump(ts)
    slam._last_depth = fe.sm
    if isinstance(slam, tfs.FisheyeStereoSlam):
        slam._last_cross = fe.cross
    vi = isinstance(slam, tis.InertialSlam) and slam.imu_initialized
    out = (_plain_vi if vi else _plain_two_view)(slam, fe, ts)
    slam.frame_id += 1
    return out


def _recording(slam, name: str, store: list):
    fn = getattr(slam, name)

    def wrapped(feats, res, *a, **kw):
        store.append(res)
        return fn(feats, res, *a, **kw)

    setattr(slam, name, wrapped)


def _state(slam) -> dict:
    keys = ["R_cur", "t_cur", "vel_R", "vel_t", "state", "n_kf", "frame_id"]
    if isinstance(slam, tis.InertialSlam):
        keys += ["v_cur", "bg_cur", "ba_cur"]
    out = {k: np.asarray(getattr(slam, k)) for k in keys}
    out.update(pt_found=slam.map.pt_found.numpy(), pt_visible=slam.map.pt_visible.numpy())
    if getattr(slam, "_vi_anchor", None) is not None:
        out.update({f"anchor{j}": x.numpy() for j, x in enumerate(slam._vi_anchor)})
    if getattr(slam, "_vi_prior", None) is not None:
        out["prior"] = slam._vi_prior.numpy()
    return out


def _assert_same_frame(slam, ref, i: int, ts: float) -> int:
    """Frame i through ``process_frame`` on ``slam`` and through the plain
    path on ``ref`` (a deep copy): equal to the bit. Returns the tracked
    landmarks."""
    got_res, want_res = [], []
    post = "_vi_post" if isinstance(slam, tis.InertialSlam) and slam.imu_initialized else "_track_post"
    _recording(slam, post, got_res)
    _recording(ref, post, want_res)
    got, want = _feed(slam, i, ts), _plain_feed(ref, i, ts)
    for s in (slam, ref):
        delattr(s, post)
    np.testing.assert_array_equal(got, want)
    a, b = _state(slam), _state(ref)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    (g,), (w,) = got_res, want_res
    for f in ("feat_pt", "visible_mask", "found_mask"):
        assert torch.equal(getattr(g, f), getattr(w, f)), f
    if post == "_track_post":
        assert torch.equal(g.R, w.R) and torch.equal(g.t, w.t)
        assert int(g.n_inliers) == int(w.n_inliers)
    return int((g.feat_pt >= 0).sum())


CASES = {
    "stereo-dense": ("stereo", False, {}),
    "stereo-lean-window": ("stereo", True, dict(track_window=3)),
    "rgbd-lean-cap": ("rgbd", True, dict(track_cap=256)),
    "rig_kb8-dense": ("rig_kb8", False, {}),
    "rig_pinhole-lean": ("rig_pinhole", True, {}),
    "stereo_inertial-lean": ("stereo_inertial", True, {}),
    "rgbd_inertial-dense-window": ("rgbd_inertial", False, dict(track_window=3)),
    "rig_inertial-lean": ("rig_inertial", True, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_two_view_frames_equal_the_plain_path(case):
    """Two frames: the first from the host's state (under "vi" the anchor
    from the host, no prior), the second from the first's (the anchor and
    prior on the device); both against the plain path, to the bit, and
    tracked (the landmarks found by both)."""
    name, lean, extra = CASES[case]
    slam = _system(name, lean, **extra)
    for i in (1, 2):
        ref = copy.deepcopy(slam)
        n = _assert_same_frame(slam, ref, i, TS0 + DT * (i - 1))
        assert n >= 40, (i, n)
        assert slam.state == tsys.OK
    prog = slam._track_prog
    kind = "vi" if "inertial" in name else CLASSES[name][0].TRACK_KIND
    assert sum(prog.runs.values()) == 2 and all(k[1] == kind for k in prog.runs)
    sched = slam._sched_lean if lean else slam._sched_dense
    assert all(k[2] == sched for k in prog.runs)
    if kind == "vi":
        assert prog.anchors == {"host": 1, "device": 1, "zero_prior": 1}
        assert all(k[3] == (name != "rgbd_inertial") for k in prog.runs)


def test_recently_lost_vi_frame_equals_the_plain_path():
    """A RECENTLY_LOST stereo-inertial frame (dead reckoning since a frame
    with too few inliers) takes the "vi" kind and recovers, as the plain
    path does."""
    slam = _system("stereo_inertial", True)
    slam.state, slam._lost_since_ts = tsys.RECENTLY_LOST, TS0 - DT
    ref = copy.deepcopy(slam)
    _assert_same_frame(slam, ref, 1, TS0)
    assert slam.state == ref.state == tsys.OK


def test_visual_frame_of_an_inertial_rig_before_the_imu_initializes():
    """Before the IMU initializes an inertial rig's frame takes its visual
    kind (the stereo refinement), with the IMU samples recorded."""
    slam = _system("stereo_inertial", True)
    slam.imu_initialized = False
    ref = copy.deepcopy(slam)
    _assert_same_frame(slam, ref, 1, TS0)
    assert [k[1] for k in slam._track_prog.runs] == ["stereo"]


def test_vi_prediction_on_the_device_against_the_host_read():
    """The "vi" kind's IMU prediction (``track_program.imu_prediction``: the
    motion model's arithmetic on the device, as the JAX package keeps it)
    against ``_predict_motion``'s, which read the predicted pose to the host
    and made the motion model there in numpy: the velocity equal, the
    predicted pose within float32 rounding (1e-6)."""
    slam = _system("stereo_inertial", True)
    acc, gyro, dts, _ = _imu(1)
    slam._record_frame_imu(TS0, acc, gyro, dts)
    prog = slam._track_program()
    host = np.concatenate([slam.R_cur.reshape(-1), slam.t_cur, slam.v_cur, slam.bg_cur,
                           slam.ba_cur])
    x = tp.pack_x(prog.cfg, *slam._host_prediction(), slam.n_kf, host=host,
                  imu=slam._imu_block(slam._frame_imu))
    R_dev, t_dev, _, v_dev = tp.imu_prediction(torch.as_tensor(x), prog.cfg)
    slam._predict_motion(TS0)
    R_host, t_host = slam._host_prediction()
    np.testing.assert_array_equal(v_dev.numpy(), slam.v_cur)
    np.testing.assert_allclose(R_dev.numpy(), R_host, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_dev.numpy(), t_host, rtol=0, atol=1e-6)


# ---- the synchronous mono frame --------------------------------------------
@pytest.fixture(scope="module")
def mono_seq():
    return synth.make_sequence(n_frames=5, height=H, width=W, dt=0.1, seed=3, with_depth=True,
                               device="cpu")


def _mono(seq, **extra):
    """A ``MonoSlam(pipelined=False)`` tracking at frame 3 against a map
    seeded from frames 0 and 2's rendered depth, from frame 2's pose with
    the true velocity."""
    slam = tsys.MonoSlam(height=H, width=W, cam_params=seq.cam_params, n_features=300,
                         max_keyframes=K_CAP, max_points=1024, pipelined=False, device="cpu",
                         **extra)
    m, n_kf, n_pts = synth.seed_map_from_depth(seq, 2, slam)
    pose = [(seq.R_wc[i].T, -seq.R_wc[i].T @ seq.t_wc[i]) for i in range(5)]
    slam.set_map(m, n_kf, n_pts, *pose[2])
    slam.vel_R = (pose[3][0] @ pose[2][0].T).astype(np.float32)
    slam.vel_t = (pose[3][1] - slam.vel_R @ pose[2][1]).astype(np.float32)
    return slam


MONO_CASES = {"dense": dict(lean_after_kf=100), "lean-window": dict(track_window=1),
              "uint8-cap": dict(transfer_uint8=True, track_cap=256)}


@pytest.mark.parametrize("case", list(MONO_CASES))
def test_synchronous_mono_frame_equals_the_plain_path(mono_seq, case):
    """Frames 3 and 4 through ``process_frame`` (the frame program, one
    packed read) against extraction, ``_track_res`` and ``_track_post`` on a
    deep copy: the pose, the host state, the counters and the tracked
    features, to the bit; the frame program's graphs (on the card)
    warmed up at initialization whatever ``pipelined``."""
    slam = _mono(mono_seq, **MONO_CASES[case])
    for i in (3, 4):
        ts = float(mono_seq.timestamps[i])
        img = mono_seq.images[i].numpy()
        ref = copy.deepcopy(slam)
        got_res, want_res = [], []
        _recording(slam, "_track_post", got_res)
        got = slam.process_frame(img, ts)
        delattr(slam, "_track_post")
        feats = torb.extract(torch.as_tensor(img, dtype=torch.float32), ref.config)
        ref._predict_motion(ts)
        res = ref._track_res(feats)
        want = ref._track_post(feats, res, ts)
        ref.frame_id += 1
        np.testing.assert_array_equal(got, want)
        a, b = _state(slam), _state(ref)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        (g,) = got_res
        for f in ("feat_pt", "visible_mask", "found_mask", "R", "t", "n_inliers"):
            assert torch.equal(getattr(g, f), getattr(res, f)), f
        assert int(res.n_inliers) >= 60
    prog = slam._frame_prog
    assert prog.buf["img"].dtype == torch.float32  # a synchronous frame takes the float image
    assert sum(prog.runs.values()) == 2 and slam.pipe_counts["dispatches"] == 0


def test_initialization_warms_the_frame_program(mono_seq, monkeypatch):
    """A synchronous system's two-view initialization readies the frame
    program's schedules (the JAX package's ``_warm_schedules`` runs
    whatever ``pipelined``); the reconstruction is stood in for."""
    slam = _mono(mono_seq)
    calls = []
    slam._frame_program().warm = lambda *a: calls.append(a)
    slam.state = tsys.NOT_INITIALIZED
    slam._create_initial_map = lambda *a: None
    monkeypatch.setattr(tsys.ransac, "two_view_init",
                        lambda *a: type("Res", (), dict(ok=True, n_good=100))())
    slam.init_feats = torb.extract(mono_seq.images[0].float(), slam.config)
    slam._try_initialize(torb.extract(mono_seq.images[2].float(), slam.config), 0.2)
    assert slam.state == tsys.OK and len(calls) == 1
    assert calls[0][0] == (slam._sched_dense, slam._sched_lean)


# ---- against the JAX package -------------------------------------------------
def _jax_map(m: dict):
    return jms.MapState(**{k: jnp.asarray(v) for k, v in m.items()})


def _jax_feats(f: dict):
    return jorb.Features(**{k: jnp.asarray(v) for k, v in f.items()})


def _program_inputs(kind: str, cam_model: str, with_imu: bool):
    """The program's inputs (buffers by name), its config and map, for
    frame 1 of the numpy scene from frame 0's prediction (no IMU
    prediction)."""
    sc = _scene(cam_model)
    fr = sc["frames"][0]
    calib = None
    if with_imu:
        calib = timu.ImuCalib(*(torch.as_tensor(np.asarray(x), dtype=torch.float32)
                                for x in make_calib(freq=100.0)))
    cfg = tp.TrackConfig(
        config=torb.default_config(H, W, n_features=N_FEATURES), cam_params=torch.as_tensor(sc["cam"]),
        width=W, height=H, track_window=None, track_cap=None, cam_model=cam_model, K=K_CAP, N=128,
        P=P_CAP, visual="rig" if kind == "rig" else "stereo", bf=float(sc["cam"][0]) * BASELINE,
        R_rl=torch.as_tensor(R_RL), t_rl=torch.as_tensor(T_RL), calib=calib,
        imu_cap_frame=N_IMU if with_imu else 0)
    R_cw1, t_cw1 = _tcw(1)
    rng = np.random.default_rng(7)
    R_pred = (_so3_exp(rng.normal(0, 0.01, 3)) @ R_cw1).astype(np.float32)
    t_pred = (t_cw1 + rng.normal(0, 0.02, 3)).astype(np.float32)
    host = imu = None
    if with_imu:
        acc, gyro, dts, v = _imu(1)
        R0, t0 = _tcw(0)
        host = np.concatenate([R0.reshape(-1), t0, v, np.zeros(6, np.float32)])
        imu = np.concatenate([acc, gyro, dts[:, None]], axis=1)
    d = {f"f_{k}": torch.as_tensor(v) for k, v in fr["feats"].items()}
    d.update(x=torch.as_tensor(tp.pack_x(cfg, R_pred, t_pred, N_KF, host=host, imu=imu)),
             sm_u_right=torch.as_tensor(_u_right(fr, cfg.bf)), sm_valid=torch.as_tensor(fr["sm_valid"]),
             cross_ok=torch.as_tensor(fr["cross_ok"]), uv_right=torch.as_tensor(fr["uv_right"]))
    if with_imu:
        R_wb, p_wb = R0.T, -R0.T @ t0  # body = camera
        d.update(anc_R=torch.as_tensor(R_wb), anc_p=torch.as_tensor(p_wb), anc_v=torch.as_tensor(v),
                 anc_bg=torch.zeros(3), anc_ba=torch.zeros(3), anc_Sigma=torch.zeros((15, 15)))
    return d, cfg, sc["map"], (R_pred, t_pred, imu, v if with_imu else None)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX functions on the numpy scene's frame 1, each compiled once:
    ``track_against_map`` (lean schedule) then ``_stereo_refine``,
    ``_twocam_refine`` under KB8, or the preintegration and ``_vi_refine``
    (pinhole: the JAX package's refinement projects through it)."""
    out = {}
    for kind, cam_model in (("stereo", "pinhole"), ("rig", "kb8"), ("vi", "pinhole")):
        d, cfg, m, (R_pred, t_pred, imu, v) = _program_inputs(kind, cam_model, kind == "vi")
        sc = _scene(cam_model)
        fr = sc["frames"][0]
        jm, jf = _jax_map(m), _jax_feats(fr["feats"])
        cam = jnp.asarray(sc["cam"])
        res = jtrk.track_against_map(jm, jf, jnp.asarray(R_pred), jnp.asarray(t_pred), cam, W, H,
                                     schedule=LEAN, cam_model=cam_model)
        if kind == "stereo":
            r2 = jss._stereo_refine(jm, jf, res.feat_pt, jnp.asarray(d["sm_u_right"].numpy()),
                                    res.R, res.t, cam, cfg.bf)
            out[kind] = dict(n=int(r2.n_inliers), R=np.asarray(r2.R), t=np.asarray(r2.t))
        elif kind == "rig":
            N = fr["cross_ok"].shape[0]
            r2 = jfs._twocam_refine(jm, jf, res.feat_pt, jnp.asarray(fr["cross_ok"]),
                                    jnp.arange(N, dtype=jnp.int32), jnp.asarray(fr["uv_right"]),
                                    res.R, res.t, jnp.asarray(R_RL), jnp.asarray(T_RL), cam,
                                    "kb8")
            out[kind] = dict(n=int(r2.n_inliers), R=np.asarray(r2.R), t=np.asarray(r2.t))
        else:
            calib = make_calib(freq=100.0)
            z = jnp.zeros(3)
            pre = jimu.preintegrate(jnp.asarray(imu[:, 0:3]), jnp.asarray(imu[:, 3:6]),
                                    jnp.asarray(imu[:, 6]), jnp.zeros(6), calib)
            anc = [jnp.asarray(d[k].numpy()) for k in tp.ANCHOR]
            vires, R_cw, t_cw = jis._vi_refine(jm, jf, res.feat_pt, res.R, res.t,
                                               jnp.asarray(v), z, z, *anc, pre,
                                               jnp.zeros((15, 15)), cam, calib.R_bc, calib.t_bc)
            out[kind] = dict(n=int(vires.n_inliers), R=np.asarray(R_cw), t=np.asarray(t_cw),
                             v=np.asarray(vires.v_w), bg=np.asarray(vires.bg),
                             ba=np.asarray(vires.ba))
        out[kind]["track_n"] = int(res.n_inliers)
    return out


@pytest.mark.parametrize("kind", ["stereo", "rig", "vi"])
def test_program_body_against_jax(jax_runs, kind):
    cam_model = "kb8" if kind == "rig" else "pinhole"
    d, cfg, m, _ = _program_inputs(kind, cam_model, kind == "vi")
    got = tp.eager_track(d, tms.from_numpy(m, "cpu"), cfg, kind, LEAN)
    want = jax_runs[kind]
    packed = got["packed"].numpy()
    assert abs(int(got["n_inl"]) - want["track_n"]) <= 1
    assert abs(int(packed[0]) - want["n"]) <= 1 and want["n"] >= 40
    np.testing.assert_allclose(packed[1:10].reshape(3, 3), want["R"], atol=2e-4)
    np.testing.assert_allclose(packed[10:13], want["t"], atol=2e-4)
    if kind == "vi":
        np.testing.assert_allclose(packed[13:16], want["v"], atol=2e-3)
        np.testing.assert_allclose(packed[16:19], want["bg"], atol=1e-4)
        np.testing.assert_allclose(packed[19:22], want["ba"], atol=1e-4)


def test_program_runs_equal_the_plain_function():
    """``TrackProgram.run`` on its buffers (the region run eagerly off the
    card) against ``eager_track`` on the same inputs: every output equal,
    for each kind and with the IMU prediction."""
    for kind, cam_model, predict in (("stereo", "pinhole", False), ("rig", "kb8", False),
                                     ("vi", "pinhole", True)):
        d, cfg, m, _ = _program_inputs(kind, cam_model, kind == "vi")
        want = tp.eager_track({k: v.clone() for k, v in d.items()}, tms.from_numpy(m, "cpu"), cfg,
                              kind, LEAN, predict)
        prog = tp.TrackProgram(cfg, "cpu")
        fe = _front_end(_scene(cam_model)["frames"][0], cfg.bf)
        anchor = tuple(d[k] for k in tp.ANCHOR) if kind == "vi" else None
        out = prog.run(kind, tms.from_numpy(m, "cpu"), fe, d["x"].numpy(), LEAN, anchor=anchor,
                       predict=predict)
        np.testing.assert_array_equal(out.host.get(), want["packed"].numpy())
        assert torch.equal(out.res.feat_pt, want["feat_pt"])
        assert torch.equal(out.res.found_mask, want["found"])
        if kind == "vi":
            assert torch.equal(out.vires.Sigma, want["vi_Sigma"])
            assert torch.equal(out.res.R.reshape(9), want["trk"][:9])
