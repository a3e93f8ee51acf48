"""``InertialSlam``'s per-frame VI frame, one frame behind (the JAX
package's ``_process_frame_vi`` / ``_drain_vi_pending``): the VI frame
program (``models/vi_frame_program.py``) against the JAX package's
``_vi_fused_program`` and against the eager composition it replaces, the
anchors it starts from, ``InertialSlam(pipelined=True)`` with its handoff
from the pipelined visual frames to the VI frames, and the two-device split
under the lag. The default path's lag is held against the JAX package's
run in ``test_torch_inertial_e2e.py``.

Known fault of the reference cited here: the JAX package's
``InertialSlam(pipelined=True)`` raises a ``TypeError`` at its first
pipelined drain (frame 4 of ``test_torch_inertial_e2e.py``'s sequence, one
pose logged): ``MonoSlam._drain_pending`` (system.py:1005) passes
``fetched=`` to ``InertialSlam._track_post`` (inertial_system.py:886),
which takes none; and its VI branch never drains the visual frame in flight
at the IMU's initialization, which ``flush`` would post last, after later
frames. So its pipelined run is compared with the JAX package's default
run's record (``JAX_RESULT``), by end-to-end results.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.models.inertial_system import InertialSlam as JaxInertialSlam
from orb_slam3_ros_tpu.ops import viba as jviba
from orb_slam3_ros_tpu.utils import synth as jsynth
from orb_slam3_ros_tpu_torch.models import inertial_system as tis
from orb_slam3_ros_tpu_torch.models import system as tsys
from orb_slam3_ros_tpu_torch.models import tracking as ttrk
from orb_slam3_ros_tpu_torch.models.vi_frame_program import VIFrameConfig, VIFrameProgram
from orb_slam3_ros_tpu_torch.ops import imu as timu
from orb_slam3_ros_tpu_torch.ops import orb as torb
from orb_slam3_ros_tpu_torch.ops import viba as tviba
from orb_slam3_ros_tpu_torch.utils import synth as tsynth
from orb_slam3_ros_tpu_torch.utils.evaluate_ate import ate_rmse
from test_torch_inertial_e2e import JAX_RESULT, N_FRAMES, N_SKIP, SEQ_KW, SLAM_KW, record_posts
from torch_cases import T
from torch_parity import jax_seed_map, torch_calib, torch_map
from vi_sim import make_calib

torch.set_num_threads(2)

H, W, M = 240, 376, 32  # M: imu_cap_frame
K_FRAME = 12  # the frame the program tracks, against a map seeded at frames 0, 3, 6, 9


@pytest.fixture(scope="module")
def frame():
    """One VI frame's inputs: the JAX package's map seeded from rendered
    depth at ground-truth poses, frame 12's image and IMU block, the anchor
    at frame 11's true body state and biases, an anchor covariance."""
    seq, imu = jsynth.make_vi_sequence(**{**SEQ_KW, "n_frames": K_FRAME + 1}, with_depth=True)
    jslam = JaxInertialSlam(cam_params=seq.cam_params, calib=make_calib(freq=100.0), **SLAM_KW)
    prefix = seq._replace(images=seq.images[:K_FRAME], depths=seq.depths[:K_FRAME])
    m, n_kf, n_pts = jax_seed_map(prefix, 3, jslam)
    k = K_FRAME
    R_cw = seq.R_wc[k - 1].T
    t_cw = -R_cw @ seq.t_wc[k - 1]
    blk = np.zeros((M, 7), np.float32)
    n = len(imu["dts"][k])
    blk[:n, 0:3], blk[:n, 3:6], blk[:n, 6] = imu["acc"][k], imu["gyro"][k], imu["dts"][k]
    A = np.random.default_rng(0).normal(size=(15, 15)).astype(np.float32) * 1e-3
    host = np.concatenate([R_cw.reshape(-1), t_cw, imu["vel"][k - 1], imu["bg"], imu["ba"]])
    return dict(seq=seq, jslam=jslam, m=m, n_kf=n_kf, img=seq.images[k], blk=blk,
                host=host.astype(np.float32), Sigma=(A @ A.T + 1e-6 * np.eye(15)).astype(np.float32))


def _program(f):
    jslam, m = f["jslam"], f["m"]
    return VIFrameProgram(VIFrameConfig(
        config=torb.default_config(H, W, n_features=SLAM_KW["n_features"]),
        cam_params=T(jslam.cam_params), calib=torch_calib(make_calib(freq=100.0)), width=W,
        height=H, track_cap=None, cam_model="pinhole", uint8=False, K=m.K, N=m.N, P=m.P,
        imu_cap_frame=M,
    ), "cpu")


def _anchor(f, calib):
    h = T(f["host"])
    R_wb, p_wb = tviba.body_from_cam(h[0:9].reshape(3, 3), h[9:12], calib.R_bc, calib.t_bc)
    return R_wb, p_wb, h[12:15], h[15:18], h[18:21]


def test_program_matches_jax_vi_fused_program(frame):
    """The same map, image, IMU block, anchor and anchor covariance through
    the JAX package's one-dispatch VI program and the port's program (eager
    off the card). The extractors agree but for descriptor bits on rounding
    boundaries (``test_torch_features.py``), so tracking may bind a landmark
    more or fewer: inliers within 1, the refined pose within 2e-4 (rad and
    m; the frame moves ~0.03 m), velocity within 2e-3 m/s and biases within
    1e-4 of each other; the covariance within 1e-3 relative to its
    largest entry."""
    f = frame
    jslam = f["jslam"]
    h = f["host"]
    R_wb, p_wb = jviba.body_from_cam(jnp.asarray(h[0:9].reshape(3, 3)), jnp.asarray(h[9:12]),
                                     jslam.calib.R_bc, jslam.calib.t_bc)
    anchor = (R_wb, p_wb, jnp.asarray(h[12:15]), jnp.asarray(h[15:18]), jnp.asarray(h[18:21]))
    blk = f["blk"]
    _, jres, jv, jR, jt, _ = jslam._vi_fused_program()(
        jnp.asarray(f["img"]), f["m"], anchor, jnp.asarray(f["Sigma"]), jnp.asarray(blk[:, 0:3]),
        jnp.asarray(blk[:, 3:6]), jnp.asarray(blk[:, 6]), schedule=jslam._sched_dense)
    assert jslam._sched_dense == ttrk.SCHEDULE_DENSE
    prog = _program(f)
    out = prog.dispatch(f["img"], blk, torch_map(f["m"]), ttrk.SCHEDULE_DENSE,
                        anchor=_anchor(f, prog.cfg.calib), Sigma=T(f["Sigma"]))
    got = out.host.get()
    n_j = int(jv.n_inliers)
    assert n_j >= 100 and abs(int(got[0]) - n_j) <= 1, (int(got[0]), n_j)
    np.testing.assert_allclose(got[1:10], np.asarray(jR).reshape(-1), atol=2e-4)
    np.testing.assert_allclose(got[10:13], np.asarray(jt), atol=2e-4)
    np.testing.assert_allclose(got[13:16], np.asarray(jv.v_w), atol=2e-3)
    np.testing.assert_allclose(got[16:22], np.concatenate([jv.bg, jv.ba]), atol=1e-4)
    S_j = np.asarray(jv.Sigma)
    np.testing.assert_allclose(out.vires.Sigma.numpy(), S_j, atol=1e-3 * np.abs(S_j).max())
    assert abs(int(out.res.n_inliers) - int(jres.n_inliers)) <= 2


def test_program_equals_its_parts(frame):
    """The program against the eager composition it replaces (the port's
    per-frame VI path before the lag): preintegration at the anchor's bias,
    the IMU prediction, extraction, tracking from it, the 15-dof
    refinement. Integers and bools exact, floats within 1e-5 of the
    field's largest magnitude (at least 1: the information matrix reaches
    1e7, and its small entries are differences of large sums); the host
    copy is the packed (inliers, R_cw, t_cw, v, bg, ba)."""
    f = frame
    prog = _program(f)
    cfg, m = prog.cfg, torch_map(f["m"])
    R_wb, p_wb, v, bg, ba = anchor = _anchor(f, cfg.calib)
    S, blk = T(f["Sigma"]), T(f["blk"])
    b = torch.cat([bg, ba])
    pre = timu.preintegrate(blk[:, 0:3], blk[:, 3:6], blk[:, 6], b, cfg.calib)
    R2, p2, _ = timu.predict_state(R_wb, p_wb, v, b, pre)
    R_pred, t_pred = tviba.cam_from_body(R2, p2, cfg.calib.R_bc, cfg.calib.t_bc)
    feats = torb.extract(T(f["img"]), cfg.config)
    res = ttrk.track_against_map(m, feats, R_pred, t_pred, cfg.cam_params, W, H,
                                 schedule=ttrk.SCHEDULE_DENSE)
    vires, R_cw, t_cw = tis._vi_refine(m, feats, res.feat_pt, res.R, res.t, v, bg, ba, R_wb, p_wb,
                                       v, bg, ba, pre, S, cfg.cam_params, cfg.calib.R_bc,
                                       cfg.calib.t_bc)
    out = prog.dispatch(f["img"], f["blk"], m, ttrk.SCHEDULE_DENSE, anchor=anchor, Sigma=S)

    def same(got, want, what):
        if want.dtype.is_floating_point:
            scale = max(1.0, float(want.abs().max()))
            torch.testing.assert_close(got, want, rtol=0.0, atol=1e-5 * scale, msg=what)
        else:
            assert torch.equal(got, want), what

    for k in torb.Features._fields:
        same(getattr(out.feats, k), getattr(feats, k), k)
    for k in ttrk.TrackResult._fields:
        same(getattr(out.res, k), getattr(res, k), k)
    for k in tviba.PoseInertialResult._fields:
        same(getattr(out.vires, k), getattr(vires, k), k)
    packed = torch.cat([vires.n_inliers.reshape(1).float(), R_cw.reshape(9), t_cw, vires.v_w,
                        vires.bg, vires.ba])
    same(T(out.host.get()), packed, "packed")
    assert int(vires.n_inliers) >= 100


def test_host_and_device_anchors_agree(frame):
    """The anchor from the host's (R_cw, t_cw, v, bg, ba) (after a keyframe)
    and the same state handed over on the device give the same frame,
    exactly; a covariance of None zeroes the buffer in place, the same as
    an exact zero covariance handed over."""
    f = frame
    prog = _program(f)
    m, img, blk, sched = torch_map(f["m"]), f["img"], f["blk"], ttrk.SCHEDULE_DENSE
    runs = [prog.dispatch(img, blk, m, sched, anchor=_anchor(f, prog.cfg.calib), Sigma=T(f["Sigma"])),
            prog.dispatch(img, blk, m, sched, host=f["host"], Sigma=T(f["Sigma"])),
            prog.dispatch(img, blk, m, sched, host=f["host"]),
            prog.dispatch(img, blk, m, sched, anchor=_anchor(f, prog.cfg.calib),
                          Sigma=torch.zeros(15, 15))]
    assert dict(prog.anchors) == {"device": 2, "host": 2, "zero_prior": 1}
    assert prog.map_copies == 1  # the same map tensors, unwritten
    host = [r.host.get() for r in runs]
    np.testing.assert_array_equal(host[0], host[1])
    np.testing.assert_array_equal(host[2], host[3])
    assert not np.array_equal(host[0], host[2])  # the prior moves the solve


# ---- InertialSlam(pipelined=True): the handoff, and the anchors of a run ----
def _piped_run(devices=None, n=N_FRAMES, **kw):
    seq, imu = tsynth.make_vi_sequence(**SEQ_KW, device="cpu")
    dev = dict(devices=devices) if devices else dict(device="cpu")
    slam = tis.InertialSlam(cam_params=seq.cam_params, calib=torch_calib(make_calib(freq=100.0)),
                            pipelined=True, **{**SLAM_KW, **kw}, **dev)
    posted, vi = [], []
    posts = record_posts(slam)
    log_pose, dispatch_vi = slam._log_pose, slam._dispatch_vi

    def logged(ts):
        posted.append(ts)
        log_pose(ts)

    def dispatched(img, ts, imu_, idx):
        # (whether the anchor comes from the host, whether the covariance is
        # zero, keyframes at this dispatch)
        vi.append((slam._vi_anchor is None, slam._vi_prior is None, slam.n_kf))
        return dispatch_vi(img, ts, imu_, idx)

    slam._log_pose, slam._dispatch_vi = logged, dispatched
    outs = [slam.process_frame(seq.images[i], float(seq.timestamps[i]), acc=imu["acc"][i],
                               gyro=imu["gyro"][i], dts=imu["dts"][i]) for i in range(n)]
    after_calls = list(slam.trajectory)
    flushed = slam.flush()
    traj = slam.get_trajectory()
    ts = np.asarray([t for t, _ in traj])
    gt_ts = seq.timestamps.astype(np.float64)[:n]
    est = np.stack([T_[:3, 3] for _, T_ in traj])
    _, n_m, scale = ate_rmse(ts[N_SKIP:], est[N_SKIP:], gt_ts, seq.t_wc[:n], with_scale=True)
    metric, _, _ = ate_rmse(ts[N_SKIP:], est[N_SKIP:], gt_ts, seq.t_wc[:n], with_scale=False)
    return dict(slam=slam, outs=outs, flushed=flushed, posts=posts, after_calls=after_calls,
                traj_ts=ts, gt_ts=gt_ts, posted=posted, vi=vi, metric=metric, scale=scale, n=n_m)


@pytest.fixture(scope="module")
def piped():
    return _piped_run()


def test_pipelined_posts_every_frame_once_in_order(piped):
    """The port's rule: every dispatched frame is posted exactly once, in
    frame order, before any later frame; the trajectory holds one pose a
    frame from initialization on."""
    first = next(i for i, o in enumerate(piped["outs"]) if o is not None)
    assert piped["posted"] == sorted(set(piped["posted"]))
    np.testing.assert_allclose(piped["posted"], piped["gt_ts"][first:])
    np.testing.assert_allclose(piped["traj_ts"], piped["gt_ts"][first:])


def test_pipelined_returns_the_previous_frame(piped):
    """The frame that initializes returns its own pose, the next call None
    (the visual frames' lag), the first VI frame None (it posts the frame
    handed off, whose call returned nothing), and every other call the pose
    of the frame before it (as its post returned it: the pose after its
    keyframe work); ``flush`` the last frame's."""
    outs, posts, ts = piped["outs"], piped["posts"], piped["gt_ts"]
    slam = piped["slam"]
    first = next(i for i, o in enumerate(outs) if o is not None)
    nones = [i for i in range(first, N_FRAMES) if outs[i] is None]
    assert len(nones) == 2 and nones[0] == first + 1
    v = nones[1]
    # the handoff: the visual frames stop at v - 1, dispatched before the IMU
    # initialized and tracked again by the VI program at call v
    assert slam.pipe_counts["vi_dispatches"] == N_FRAMES - v + 1 == slam.pipe_counts["vi_drains"]
    assert slam.pipe_counts["dispatches"] == slam.pipe_counts["drains"] + 1 == v - first - 1
    np.testing.assert_array_equal(outs[first], posts[float(ts[first])])
    for i in range(first + 2, N_FRAMES):
        if i != v:
            np.testing.assert_array_equal(outs[i], posts[float(ts[i - 1])])
    np.testing.assert_array_equal(piped["flushed"], posts[float(ts[-1])])
    assert float(ts[-1]) not in dict(piped["after_calls"])


def test_pipelined_run_against_the_jax_record(piped):
    """End to end against the JAX package's run of the same sequence (its
    default mode; its pipelined class raises, module docstring):
    ``test_torch_inertial_e2e.py``'s bounds, the keyframes within 2, every
    pre-initialization keyframe's work deferred and absorbed."""
    slam = piped["slam"]
    assert slam.state == tsys.OK and slam.imu_stage == 3 and slam.bad_imu_resets == 0
    assert piped["n"] >= 20 and abs(piped["scale"] - 1.0) < 0.05
    assert piped["metric"] <= min(0.10, JAX_RESULT["metric"] + 0.02), piped["metric"]
    assert abs(slam.n_kf - JAX_RESULT["n_kf"]) <= 2
    assert slam.pipe_counts["kf_deferred"] >= 3 and slam._kf_async is None
    assert slam._pending is None and slam._vi_pending is None


def test_anchors_of_the_vi_frames(piped):
    """A VI frame starts from the host's state after a keyframe (whose BA
    moved the keyframe it would start from) and at the first VI frame, from
    the previous frame's refined state on the device otherwise, with a zero
    covariance whenever the system holds none."""
    vi, prog = piped["vi"], piped["slam"]._vi_prog
    assert vi[0][0]  # the first VI frame: the host's state after the initialization
    for (_, _, kf0), (host, _, kf1) in zip(vi, vi[1:]):
        assert host == (kf1 != kf0)
    assert sum(h for h, _, _ in vi) >= 5 and sum(not h for h, _, _ in vi) >= 10
    assert prog.anchors["host"] == sum(h for h, _, _ in vi)
    assert prog.anchors["device"] == sum(not h for h, _, _ in vi)
    assert prog.anchors["zero_prior"] == sum(z for _, z, _ in vi) >= prog.anchors["host"]


def test_split_under_the_lag():
    """``devices=("cpu", "cpu")`` with ``pipelined=True`` to the IMU's
    second stage: the visual and the VI frame programs on the track device,
    the VI frames' map copied from the replica, no frame more than one
    keyframe behind, one pose a frame in order."""
    run = _piped_run(devices=("cpu", "cpu"), n=22, init_after_kf=4)
    slam = run["slam"]
    assert slam.imu_initialized and slam.imu_stage >= 2 and slam.state == tsys.OK
    assert slam._frame_prog.device == slam._vi_prog.device == slam.track_device
    src = slam._vi_prog._map_src["pt_X"][0]
    assert any(src is b.pt_X for b in slam._replica._bufs) and src is not slam.map.pt_X
    assert slam._replica.counts["max_stale"] <= 1 and slam.pipe_counts["vi_drains"] >= 5
    first = next(i for i, o in enumerate(run["outs"]) if o is not None)
    np.testing.assert_allclose(run["traj_ts"], run["gt_ts"][first:])
