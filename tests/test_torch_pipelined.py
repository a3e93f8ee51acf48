"""``MonoSlam``'s default per-frame mode, the pipelined one-frame lag,
against the JAX package's (``_process_frame_pipelined``, ``_drain_pending``,
the deferred keyframe work and closure attempt): the protocol of
``test_e2e_mono.py`` through both packages at their default, the pieces
of the speculative frame one by one (the prediction on the device, the
frame program, the keyframe work with the device-form local BA), the
protocols of ``test_loop_closing.py`` and ``test_atlas.py``'s blackout on
the port's pipelined system, the two-device split, and what each
subclass does with ``pipelined``. The two packages draw other RANSAC
hypotheses, so their trajectories fork: they are compared by ATE, not pose
by pose."""

import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.models import fisheye_stereo as jfs
from orb_slam3_ros_tpu.models import inertial_system as jis
from orb_slam3_ros_tpu.models import stereo_system as jss
from orb_slam3_ros_tpu.models.system import MonoSlam as JaxSlam
from orb_slam3_ros_tpu.utils import synth as jsynth
from orb_slam3_ros_tpu.utils.evaluate_ate import ate_rmse
from orb_slam3_ros_tpu_torch.models import fisheye_stereo as tfs
from orb_slam3_ros_tpu_torch.models import inertial_system as tis
from orb_slam3_ros_tpu_torch.models import kf_work
from orb_slam3_ros_tpu_torch.models import stereo_system as tss
from orb_slam3_ros_tpu_torch.models import system as tsys
from orb_slam3_ros_tpu_torch.models.frame_program import FRAME_MAP_FIELDS
from orb_slam3_ros_tpu_torch.ops import imu as timu
from orb_slam3_ros_tpu_torch.ops import orb
from vi_sim import make_calib

# The port's runs here are ~200 frames at 240x376 (1 s a frame on one
# thread): six threads keep the file near its time.
torch.set_num_threads(6)

H, W, NF, N_FRAMES = 240, 376, 1200, 40
SLAM_KW = dict(height=H, width=W, n_features=NF, max_keyframes=32, max_points=4096)


@pytest.fixture(scope="module")
def seq():
    return jsynth.make_sequence(n_frames=N_FRAMES, height=H, width=W, dt=0.1, seed=3)


def lagged_run(slam, seq, n=N_FRAMES, on_call=None) -> dict:
    """Feed frames 0..n-1, then flush. Returns each call's return, the
    flush's, the trajectory before the flush and after it (recomposed), and
    the Sim(3) ATE of the recomposed one. ``on_call(i)`` runs after call i."""
    outs = []
    for i in range(n):
        outs.append(slam.process_frame(seq.images[i], float(seq.timestamps[i])))
        if on_call is not None:
            on_call(i)
    live = list(slam.trajectory)
    flushed = slam.flush()
    traj = slam.get_trajectory()
    ts = np.asarray([t for t, _ in traj])
    pos = np.stack([T[:3, 3] for _, T in traj])
    rmse, n_m, _ = ate_rmse(ts, pos, np.asarray(seq.timestamps[:n], np.float64), seq.t_wc[:n],
                            with_scale=True)
    assert n_m == len(traj)
    return dict(outs=outs, flushed=flushed, live=live, after=list(slam.trajectory), traj=traj,
                ate=rmse, slam=slam)


@pytest.fixture(scope="module")
def jax_run(seq):
    slam = JaxSlam(cam_params=seq.cam_params, **SLAM_KW)  # pipelined: its default
    slam._warm_schedules = lambda: None  # ahead-of-time compiles only
    return lagged_run(slam, seq)


@pytest.fixture(scope="module")
def port_run(seq):
    slam = tsys.MonoSlam(cam_params=seq.cam_params, device="cpu", **SLAM_KW)
    preds = []

    def record(i):
        # after call i: frame i was dispatched speculatively (predicted on
        # the device from frames i-1 and i-2) and frame i-1 drained, so the
        # host's motion model now predicts frame i as the device did
        prog = slam._frame_prog
        if slam._pending is None or prog is None or float(prog.buf["x"][0]) != 0.0:
            return
        R_host = slam.vel_R @ slam.R_cur
        t_host = slam.vel_R @ slam.t_cur + slam.vel_t
        dev = prog.buf["pred"].numpy()
        preds.append(max(np.abs(dev[:9] - R_host.reshape(-1)).max(),
                         np.abs(dev[9:] - t_host).max()))

    run = lagged_run(slam, seq, on_call=record)
    run["pred_err"] = preds
    return run


def check_lag(run) -> None:
    """Call i returns frame i-1's trajectory entry, except the frame that
    initializes (its own) and the first frame after it (None: nothing was in
    flight); the flush returns the last frame's, which ``get_trajectory``
    then holds."""
    by_ts = {ts: T for ts, T in run["after"]}
    init = next(i for i, o in enumerate(run["outs"]) if o is not None)
    np.testing.assert_array_equal(run["outs"][init], run["live"][0][1])
    assert run["outs"][init + 1] is None
    lagged = 0
    for i in range(init + 2, len(run["outs"])):
        out = run["outs"][i]
        if out is not None:
            np.testing.assert_array_equal(out, by_ts[run["after"][i - 1 - init][0]])
            assert run["after"][i - 1 - init][0] == pytest.approx(0.1 * (i - 1))
            lagged += 1
    assert lagged >= N_FRAMES - init - 4
    last_ts, last_T = run["after"][-1]
    assert last_ts == pytest.approx(0.1 * (N_FRAMES - 1))
    np.testing.assert_array_equal(run["flushed"], last_T)
    assert run["live"][-1][0] == pytest.approx(0.1 * (N_FRAMES - 2))
    assert run["traj"][-1][0] == pytest.approx(0.1 * (N_FRAMES - 1))


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_process_frame_returns_the_previous_frame(package, jax_run, port_run):
    check_lag(jax_run if package == "jax" else port_run)


def test_end_to_end_poses_and_ate(jax_run, port_run):
    # The port must give poses for >= 36 of the 40 frames (the calls' and
    # the flush's) and reach ATE <= min(0.10 m, the JAX package's + 0.01 m).
    assert jax_run["ate"] < 0.10
    slam = port_run["slam"]
    assert slam.state == tsys.OK
    n_posed = sum(o is not None for o in port_run["outs"]) + (port_run["flushed"] is not None)
    assert n_posed >= 36 and len(port_run["traj"]) >= 36, n_posed
    assert port_run["ate"] <= min(0.10, jax_run["ate"] + 0.01), (port_run["ate"], jax_run["ate"])


def test_stage_names_equal_jax(jax_run, port_run):
    assert set(port_run["slam"].timing) == set(jax_run["slam"].timing) == {
        "extract", "dispatch", "frame"}


def test_keyframes_deferred_and_absorbed(port_run):
    """Every keyframe after the initial two was queued with its result
    deferred, and all of them are absorbed once flushed: the point count
    settled, one BA iteration count each, every bound observation on a live
    point slot below ``n_pts`` (``test_e2e_mono.py``'s map check)."""
    slam = port_run["slam"]
    counts = slam.pipe_counts
    assert slam._kf_async is None and slam._pending is None
    assert counts["kf_deferred"] >= 4 and len(slam.ba_iters) == 1 + counts["kf_deferred"]
    assert all(1 <= it <= slam.local_ba_iters for it in slam.ba_iters[1:])
    assert counts["drains"] == counts["ready"] >= N_FRAMES - 4  # off the card a copy lands at once
    m = slam.map
    obs, kfv = m.kf_obs.numpy(), m.kf_valid.numpy()
    bound = obs[kfv][obs[kfv] >= 0]
    assert slam.n_pts > 100 and (bound < slam.n_pts).all()


def test_device_prediction_equals_host_prediction(port_run):
    err = port_run["pred_err"]
    assert len(err) >= N_FRAMES - 6 and max(err) <= 1e-6, (len(err), max(err))


def _set_host_pose(slam, R, t):
    """Make the host's motion model predict (R, t) exactly (identity
    velocity)."""
    slam.R_cur, slam.t_cur = np.asarray(R, np.float32), np.asarray(t, np.float32)
    slam.vel_R, slam.vel_t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)


@pytest.mark.parametrize("mode,window", [("host", None), ("speculative", None),
                                         ("speculative", 4)])
def test_frame_program_equals_track_res(seq, port_run, mode, window):
    """One frame through the frame program (its prediction on the host's
    motion model, or on the device from the frames before it, with or
    without ``track_window``'s mask) equals extraction and ``_track_res``
    from the same prediction, exactly."""
    slam = port_run["slam"]
    saved = (slam.R_cur, slam.t_cur, slam.vel_R, slam.vel_t, slam.track_window, slam._frame_prog)
    try:
        slam.track_window, slam._frame_prog = window, None
        prog = slam._frame_program()
        img = seq.images[N_FRAMES - 1]
        sched = slam._current_schedule()
        R0, t0 = slam.R_cur, slam.t_cur
        first = prog.dispatch(seq.images[N_FRAMES - 2], slam.map, slam.n_kf, sched,
                              host=(R0, t0, R0, t0))
        if mode == "host":
            R_pred, t_pred = slam.vel_R @ R0, slam.vel_R @ t0 + slam.vel_t
            out = prog.dispatch(img, slam.map, slam.n_kf, sched, host=(R_pred, t_pred, R0, t0))
        else:
            out = prog.dispatch(img, slam.map, slam.n_kf, sched, prev=first)
        pred = prog.buf["pred"].numpy()
        _set_host_pose(slam, pred[:9].reshape(3, 3), pred[9:])
        feats = orb.extract(torch.as_tensor(img, dtype=torch.float32), slam.config)
        res = slam._track_res(feats)
    finally:
        (slam.R_cur, slam.t_cur, slam.vel_R, slam.vel_t, slam.track_window,
         slam._frame_prog) = saved
    for f in orb.Features._fields:
        assert torch.equal(getattr(out.feats, f), getattr(feats, f)), f
    for f in res._fields:
        assert torch.equal(getattr(out.res, f), getattr(res, f)), f
    assert int(out.res.n_inliers) >= 50
    host = out.host.get()
    assert host[0] == float(res.n_inliers) and np.array_equal(host[1:10], res.R.numpy().reshape(-1))


def test_map_copied_only_when_changed(seq, port_run):
    slam = port_run["slam"]
    prog = slam._frame_program()
    sched, R, t = slam._current_schedule(), slam.R_cur, slam.t_cur
    m = tsys.map_state.MapState(*(x.clone() for x in slam.map))

    def dispatch():
        before = prog.map_copies
        prog.dispatch(seq.images[N_FRAMES - 1], m, slam.n_kf, sched, host=(R, t, R, t))
        return prog.map_copies - before

    assert dispatch() == 1  # another map
    assert dispatch() == 0  # the same tensors, unwritten
    m.pt_visible.add_(1)  # a counter tracking does not read
    assert dispatch() == 0
    m.pt_X[0] += 0.0  # an in-place write to a field it reads
    assert dispatch() == 1
    prog.forget_map()  # writes torch does not see (a chunk's graph replays)
    assert dispatch() == 1
    for f in FRAME_MAP_FIELDS:
        assert torch.equal(prog.buf[f], getattr(m, f)), f


def test_keyframe_work_device_form_equals_host_form(seq, port_run):
    """The deferred keyframe's work (the local BA in its device form, no
    host read) leaves the same map, admitted points and BA iterations as
    the synchronous one, to the bit, from the same inputs."""
    slam = port_run["slam"]
    prog = slam._frame_program()
    R, t = slam.R_cur, slam.t_cur
    out = prog.dispatch(seq.images[N_FRAMES - 1], slam.map, slam.n_kf, slam._current_schedule(),
                        host=(slam.vel_R @ R, slam.vel_R @ t + slam.vel_t, R, t))
    kf_id = slam.n_kf
    assert kf_id < slam.K_cap
    got = {}
    for on_device in (False, True):
        m = tsys.map_state.MapState(*(x.clone() for x in slam.map))
        got[on_device] = kf_work.keyframe_work(
            m, kf_id, out.res.R, out.res.t, float(seq.timestamps[-1]), out.feats,
            out.res.feat_pt, slam.n_pts, slam.P_cap - slam.n_pts, slam.cam_params,
            w_free=slam.ba_window, w_fixed=slam.ba_fixed, n_iters=slam.local_ba_iters,
            n_levels=slam.config.n_levels, fuse_neighbors=1, do_fuse=True, do_stats=True,
            do_cull=True, width=W, height=H, on_device=on_device)
    (m0, n0, it0), (m1, n1, it1) = got[False], got[True]
    for f in m0._fields:
        assert torch.equal(getattr(m0, f), getattr(m1, f)), f
    assert torch.equal(n0, n1) and isinstance(it1, torch.Tensor) and int(it1) == it0 >= 1


# ---- the JAX package's protocols on the port's pipelined system ------------
def test_loop_closing_protocol():
    """``test_loop_closing.py``'s closed circle (70 frames, loop closing on,
    full-map tracking) through the port at its default: its assertions, and
    every keyframe's closure attempt deferred to the absorption of its
    result, once each, in order."""
    n = 70
    seq = jsynth.make_sequence(n_frames=n, height=H, width=W, dt=0.1, seed=5, trajectory="loop")
    slam = tsys.MonoSlam(height=H, width=W, cam_params=seq.cam_params, n_features=NF,
                         max_keyframes=48, max_points=6144, kf_every=3, enable_loop_closing=True,
                         device="cpu")
    checked, try_close = [], slam.loop_closer.try_close

    def counted(s, kf, *a, **kw):
        assert s._kf_async is None  # absorbed before its check
        checked.append((kf, s.n_kf))
        return try_close(s, kf, *a, **kw)

    slam.loop_closer.try_close = counted
    for i in range(n):
        slam.process_frame(seq.images[i], float(seq.timestamps[i]))
    assert slam.state == tsys.OK
    ts = np.asarray([t for t, _ in slam.trajectory])
    est = np.stack([T[:3, 3] for _, T in slam.trajectory])
    rmse, n_m, _ = ate_rmse(ts, est, seq.timestamps.astype(np.float64), seq.t_wc)
    assert n_m >= 60
    assert rmse < 0.12, f"ATE {rmse:.3f}"
    slam.flush()
    kfs = [kf for kf, _ in checked]
    assert kfs == list(range(2, 2 + slam.pipe_counts["kf_deferred"])) and len(kfs) >= 10
    # a keyframe's attempt runs at a later frame than its insertion: by
    # then the keyframe after it may already be queued (n_kf past it)
    assert all(n_kf >= kf + 1 for kf, n_kf in checked)


def test_atlas_blackout_protocol(seq):
    """``test_atlas.py``'s blackout (22 frames, 8 blank ones, the rest of
    the scene) through the port at its default: its assertions. With an
    Atlas the keyframe work stays synchronous; the frames still lag."""
    slam = tsys.MonoSlam(height=H, width=W, cam_params=seq.cam_params, n_features=NF,
                         max_keyframes=64, max_points=8192, kf_every=3, enable_atlas=True,
                         lost_patience=3, device="cpu")
    blank = np.zeros((H, W), np.float32)
    for i in range(22):
        slam.process_frame(seq.images[i], float(seq.timestamps[i]))
    kf_before = slam.n_kf
    t = 0.0
    for k in range(8):
        t = float(seq.timestamps[21]) + 0.1 * (k + 1)
        slam.process_frame(blank, t)
    state_mid = slam.state
    n_maps_mid = len(slam.atlas.maps)
    for i in range(22, 40):
        slam.process_frame(seq.images[i], t + 0.1 * (i - 21))
    assert kf_before >= 5
    assert n_maps_mid >= 1 or state_mid in (tsys.NOT_INITIALIZED, tsys.LOST)
    assert slam.state == tsys.OK, f"did not recover (state {slam.state})"
    assert slam.n_kf >= 2 and slam.n_pts > 50
    assert slam.pipe_counts["kf_deferred"] == 0 and slam.pipe_counts["dispatches"] > 20
    traj = slam.get_trajectory()
    assert len(traj) >= 20
    for _, T in traj:
        assert np.isfinite(T).all()


def test_split_over_two_devices(seq, port_run):
    """The speculative frame on the track device against the replica, on
    the first 14 frames: a refresh a deferred keyframe, no frame more than
    one keyframe behind, and the one-device run's returns, exactly (the
    replica's refresh after frame i-1's keyframe lands before frame i+1's
    dispatch, where the one-device run's keyframe work is queued too)."""
    n = 14
    slam = tsys.MonoSlam(cam_params=seq.cam_params, devices=("cpu", "cpu"), **SLAM_KW)
    outs = [slam.process_frame(seq.images[i], float(seq.timestamps[i])) for i in range(n)]
    for i, (a, b) in enumerate(zip(outs, port_run["outs"][:n])):
        assert (a is None) == (b is None), i
        if a is not None:
            np.testing.assert_array_equal(a, b)
    rep = slam._replica.counts
    assert slam._frame_prog.device == slam.track_device
    assert slam._tmap() is not slam.map
    assert rep["copies"] == slam.pipe_counts["kf_deferred"] >= 2 and rep["max_stale"] <= 1


# ---- the subclasses --------------------------------------------------------
CAM = np.asarray([150.0, 150.0, 187.5, 119.5, 0, 0, 0, 0, 0], np.float32)
KB8 = np.asarray([150.0, 150.0, 187.5, 119.5, 0.02, 0.001, -0.002, 0.0002], np.float32)


def _systems(package, **extra):
    """Each system class of a package, built at the small test size."""
    calib = make_calib()
    if package == "torch":
        calib = timu.ImuCalib(*(np.asarray(x) for x in calib))
        mods, dev = (tsys, tss, tfs, tis), dict(device="cpu")
    else:
        from orb_slam3_ros_tpu.models import system as jsys

        mods, dev = (jsys, jss, jfs, jis), {}
    sysm, ssm, fsm, ism = mods
    kw = dict(height=H, width=W, cam_params=CAM, n_features=300, max_keyframes=8, max_points=256,
              **dev, **extra)
    return {
        "MonoSlam": lambda: sysm.MonoSlam(**kw),
        "StereoSlam": lambda: ssm.StereoSlam(**kw),
        "RgbdSlam": lambda: ssm.RgbdSlam(**kw),
        "FisheyeStereoSlam": lambda: fsm.FisheyeStereoSlam(**{**kw, "cam_params": KB8}),
        "InertialSlam": lambda: ism.InertialSlam(calib=calib, **kw),
        "StereoInertialSlam": lambda: ssm.StereoInertialSlam(calib=calib, **kw),
        "RgbdInertialSlam": lambda: ssm.RgbdInertialSlam(calib=calib, **kw),
        "FisheyeStereoInertialSlam": lambda: fsm.FisheyeStereoInertialSlam(
            calib=calib, **{**kw, "cam_params": KB8}),
    }


@pytest.mark.parametrize("name", list(_systems("torch")))
def test_subclass_pipelined_follows_jax(name):
    """Each class's default is the JAX class's (the mono system pipelined,
    every other False). An explicit True: the mono and the mono-inertial
    systems take their visual frames one frame behind through
    ``MonoSlam``'s pipelined frame (the inertial one's VI frames lag on
    their own path either way); the stereo, RGB-D and two-camera systems
    and their inertial variants keep their own synchronous frame and
    keyframe (the flag changes nothing, as in the JAX package). One blank
    frame shows each class's route."""
    j = _systems("jax")[name]()
    t = _systems("torch")[name]()
    assert t.pipelined == j.pipelined == (name == "MonoSlam")
    assert _systems("jax", pipelined=True)[name]().pipelined
    t_true = _systems("torch", pipelined=True)[name]()
    assert t_true.pipelined
    routed = []
    t_true._process_frame_pipelined = lambda img, ts: routed.append(ts)
    blank = np.zeros((H, W), np.float32)
    imu = {}
    if "Inertial" in name:
        imu = dict(acc=np.zeros((10, 3), np.float32), gyro=np.zeros((10, 3), np.float32),
                   dts=np.full(10, 0.01, np.float32))
    mono = name in ("MonoSlam", "InertialSlam")
    t_true.process_frame(*((blank,) if mono else (blank, blank)), 0.1, **imu)
    assert routed == ([0.1] if mono else [])
    if not mono:
        own = type(t_true).process_frame
        assert own is not tsys.MonoSlam.process_frame
        assert type(t_true)._insert_keyframe is not tsys.MonoSlam._insert_keyframe
