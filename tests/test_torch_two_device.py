"""The two-device split of the port's ``MonoSlam`` (``devices=(track_device,
map_device)``, ``models/replica.py``) on the CPU, against the same system on
one device and against the JAX package's split.

The split run is ``tests/test_two_chip.py``'s sequence (seed 3, 240x376, 30
frames) held to that test's bounds. Both port runs here see the same frames,
so they share one extraction per frame (the same function of the same image
on the same device; the split is not in it).

Known fault of the reference pinned here: the JAX package's per-frame path
adopts a finished replica copy only at the next keyframe's copy
(``system.py:417-439``; only its pipelined path polls, ``:992``), so
tracking reads the map one whole keyframe old; the port adopts a landed
copy at the top of the next frame.
"""

import copy
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.models import system as jsys
from orb_slam3_ros_tpu_torch.models import fisheye_stereo as tfe
from orb_slam3_ros_tpu_torch.models import stereo_system as tst
from orb_slam3_ros_tpu_torch.models import system as tsys
from orb_slam3_ros_tpu_torch.models import tracking
from orb_slam3_ros_tpu_torch.models.atlas import Atlas
from orb_slam3_ros_tpu_torch.ops import orb
from orb_slam3_ros_tpu_torch.utils import synth
from orb_slam3_ros_tpu_torch.utils.evaluate_ate import ate_rmse

torch.set_num_threads(1)
N_FRAMES = 30
SLAM_KW = dict(height=240, width=376, n_features=1200, max_keyframes=32, max_points=4096,
               track_cap=768)
SPLIT = ("cpu", "cpu")
TRACK = tracking.track_against_map


class SharedExtraction:
    """``orb.extract`` memoized by frame: a second run over the same frames
    reuses the first run's features (clones: nothing may alias them). A
    frame is known by its pixels, not its storage: a frame program extracts
    every frame from one image buffer."""

    def __init__(self):
        self.orig, self.memo = orb.extract, {}

    def __call__(self, img, config):
        key = (tuple(img.shape), img.device.type, hashlib.sha1(img.cpu().numpy().tobytes()).digest())
        if key not in self.memo:
            self.memo[key] = self.orig(img, config)
        f = self.memo[key]
        return type(f)(*(x.clone() if isinstance(x, torch.Tensor) else x for x in f))


def tracked_maps(slam, log: list):
    """Wrap ``tracking.track_against_map`` to log, per call, whether it read
    the replica's buffer and whether that equals the canonical map. A frame
    tracks the frame program's copy of the map: it stands for the map the
    copy was made from."""

    def probe(m, *a, **kw):
        rep = slam._replica
        prog = slam._frame_prog
        if prog is not None and m.pt_X is prog.buf["pt_X"]:
            src = prog._map_src["pt_X"][0]
            m = next(b for b in ([] if rep is None else rep._bufs) + [slam.map] if b.pt_X is src)
        on_replica = rep is not None and any(m is b for b in rep._bufs) and m is not slam.map
        same = all(torch.equal(getattr(m, f), getattr(slam.map, f))
                   for f in ("kf_valid", "kf_R", "kf_t", "pt_valid", "pt_X", "kf_obs"))
        log.append((on_replica, same, int(slam.map.kf_valid.sum()), int(m.kf_valid.sum())))
        return TRACK(m, *a, **kw)

    return probe


def run(seq, devices, monkeypatch_ctx):
    kw = dict(devices=devices) if devices else dict(device="cpu")
    slam = tsys.MonoSlam(cam_params=seq.cam_params, pipelined=False, **SLAM_KW, **kw)
    log = []
    monkeypatch_ctx.setattr(tracking, "track_against_map", tracked_maps(slam, log))
    for i in range(N_FRAMES):
        slam.process_frame(seq.images[i], float(seq.timestamps[i]))
    slam.flush()
    traj = slam.get_trajectory()
    ts = np.asarray([t for t, _ in traj])
    est = np.stack([T[:3, 3] for _, T in traj])
    rmse, n, _ = ate_rmse(ts, est, seq.timestamps.astype(np.float64), seq.t_wc)
    return dict(slam=slam, rmse=rmse, n=n, log=log)


@pytest.fixture(scope="module")
def runs():
    seq = synth.make_sequence(n_frames=N_FRAMES, height=240, width=376, dt=0.1, seed=3,
                              device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(orb, "extract", SharedExtraction())
        split = run(seq, SPLIT, mp)
        single = run(seq, None, mp)
    return dict(split=split, single=single, seq=seq)


def test_split_meets_the_two_chip_bounds(runs):
    split, single = runs["split"], runs["single"]
    assert split["slam"].state == tsys.OK and single["slam"].state == tsys.OK
    assert split["n"] >= 25
    assert split["rmse"] < 0.12, split["rmse"]
    assert split["rmse"] < max(2.0 * single["rmse"], 0.08), (split["rmse"], single["rmse"])
    # On the CPU a refresh lands at once and is adopted at the next frame, so
    # the split tracks exactly what the single-device system tracks.
    assert split["rmse"] == single["rmse"]


def test_canonical_map_and_replica_are_distinct_storage(runs):
    slam = runs["split"]["slam"]
    assert slam.device == torch.device("cpu") and slam.track_device == torch.device("cpu")
    ptrs = {x.data_ptr() for x in slam.map}
    for buf in slam._replica._bufs:
        assert not ptrs & {x.data_ptr() for x in buf}
    assert slam._tmap() is slam._replica.current and slam._tmap() is not slam.map
    assert runs["single"]["slam"]._tmap() is runs["single"]["slam"].map


def test_tracking_reads_the_replica(runs):
    log = runs["split"]["log"]
    assert len(log) >= 25 and all(on_replica for on_replica, *_ in log)
    assert not any(on_replica for on_replica, *_ in runs["single"]["log"])


def test_replica_adopted_at_the_next_frame_after_a_keyframe(runs):
    # Every tracking call read a replica equal to the canonical map (in
    # keyframes, poses, points and observations): a keyframe's refresh was
    # adopted at the top of the next frame. No frame tracked a stale replica.
    slam, log = runs["split"]["slam"], runs["split"]["log"]
    assert all(same for _, same, *_ in log)
    c = slam._replica.counts
    n_kf_inserted = slam.n_kf - 2  # after the two-view initialization's two
    assert c["copies"] == n_kf_inserted and c["adopted"] == c["copies"]
    assert c["forced"] == 0 and c["stale_frames"] == 0 and c["max_stale"] == 0
    assert c["syncs"] == 1  # the initialization


def test_jax_per_frame_replica_stays_one_keyframe_behind():
    """The same moment in both packages: a keyframe's map change, its replica
    copy started, then the next frame. The JAX package's per-frame path tracks
    the map as it stood before the keyframe; the port tracks the new one."""
    devs = jax.devices()
    assert len(devs) >= 2
    cam = np.asarray([200, 200, 187.5, 119.5, 0, 0, 0, 0, 0], np.float32)
    img = np.zeros((240, 376), np.float32)
    seen = {}

    class Stop(Exception):
        pass

    jslam = jsys.MonoSlam(cam_params=cam, devices=(devs[0], devs[1]), **{
        k: v for k, v in SLAM_KW.items() if k != "track_cap"})

    def jax_track(img, m, *a, **kw):
        seen["jax"] = int(jnp.sum(m.kf_valid))
        raise Stop

    jslam._fused_track = jax_track
    jslam.state = jsys.OK
    jslam.map = jslam.map._replace(kf_valid=jslam.map.kf_valid.at[0].set(True))  # "a keyframe"
    jslam._start_replica_copy()
    jax.block_until_ready(jslam._replica_copy)  # it has landed
    with pytest.raises(Stop):
        jslam.process_frame(img, 0.0)
    assert seen["jax"] == 0 and int(jnp.sum(jslam.map.kf_valid)) == 1
    # only the next keyframe's copy adopts it
    jslam._start_replica_copy()
    assert int(jnp.sum(jslam._tmap().kf_valid)) == 1

    tslam = tsys.MonoSlam(cam_params=cam, devices=SPLIT, pipelined=False, **SLAM_KW)

    def port_track(img, ts, schedule):
        seen["port"] = int(tslam._tmap().kf_valid.sum())
        raise Stop

    tslam._track_frame = port_track
    tslam.state = tsys.OK
    tslam.map.kf_valid[0] = True
    tslam._start_replica_copy()
    with pytest.raises(Stop):
        tslam.process_frame(img, 0.0)
    assert seen["port"] == 1
    assert tslam._replica.counts["adopted"] == 1 and tslam._replica.counts["forced"] == 0


def _equal_maps(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_replica_refreshed_at_each_sync_site(runs):
    slam = copy.deepcopy(runs["split"]["slam"])
    rep = slam._replica
    syncs = rep.counts["syncs"]

    def synced(what):
        nonlocal syncs
        assert rep.counts["syncs"] == syncs + 1, what
        assert _equal_maps(slam._tmap(), slam.map), what
        syncs += 1

    slam._start_async_gba(2, n_cg=5)  # a global-BA fold-in
    slam.flush()
    synced("global BA")
    slam.map.kf_valid[1] = False  # a culled slot, then compaction
    slam._compact_kf_slots()
    synced("compaction")
    slam.set_map(slam.map, slam.n_kf, slam.n_pts, slam.R_cur, slam.t_cur)
    synced("set_map")
    Atlas().archive_current(slam)
    synced("Atlas archive")
    assert int(slam._tmap().kf_valid.sum()) == 0


@pytest.mark.parametrize("inertial", [False, True], ids=["mono", "inertial"])
def test_loop_closure_syncs_the_replica(inertial, monkeypatch):
    """A keyframe that closes a loop (``test_torch_loop_closing.py``'s
    revisit map, the closure taken at once) rewrites the map and the
    tracker's pose: the replica tracking reads right after that keyframe,
    and at the next frame, is the corrected map, not the keyframe's
    refresh still in flight. The keyframe's own mapping work is stubbed:
    the map it leaves is the revisit map."""
    from orb_slam3_ros_tpu_torch.models import inertial_system as tis
    from test_torch_loop_closing import CLOSER_KW, REVISIT, make_revisit_map
    from test_torch_loop_closing import SLAM_KW as LC_KW
    from torch_parity import torch_calib, torch_map
    from vi_sim import make_calib

    m = torch_map(make_revisit_map(s_d=1.0 if inertial else 1.08)[0])
    kf = REVISIT[0]
    if inertial:
        slam = tis.InertialSlam(enable_loop_closing=True, calib=torch_calib(make_calib()),
                                devices=SPLIT, **LC_KW)
        slam.imu_initialized = True
        from orb_slam3_ros_tpu_torch.models.vi_kf_program import VIKeyframeProgram

        # the keyframe program leaves the map as it is and reads the
        # keyframe's state back with no point admitted
        monkeypatch.setattr(VIKeyframeProgram, "run", lambda self, mp, inp: (mp, np.concatenate(
            [[0.0], tis._pack_kf_state(mp, inp.kf_id).cpu().numpy()])))
    else:
        slam = tsys.MonoSlam(enable_loop_closing=True, devices=SPLIT, pipelined=False, **LC_KW)
        from orb_slam3_ros_tpu_torch.models.kf_program import KeyframeProgram

        # the keyframe program leaves the map as it is and reads the
        # keyframe's pose back with no point admitted and no BA iteration
        monkeypatch.setattr(KeyframeProgram, "run", lambda self, mp, inp, defer=False: (
            mp, np.concatenate([[0.0], mp.kf_R[inp.kf_id].reshape(9).cpu().numpy(),
                                mp.kf_t[inp.kf_id].cpu().numpy(), [0.0]])))
    for k, v in dict(CLOSER_KW, required_consistency=1).items():
        setattr(slam.loop_closer, k, v)
    slam.set_map(m, kf, int(m.pt_valid.sum()), m.kf_R[kf - 1].numpy(), m.kf_t[kf - 1].numpy())
    rep = slam._replica
    syncs, before = rep.counts["syncs"], m.kf_t.clone()
    no_track = type("TrackRes", (), {"feat_pt": None})()
    if inertial:
        slam._insert_keyframe_vi(None, float(kf), no_track, kf)
    else:
        slam._insert_keyframe(None, float(kf), no_track)
    assert slam.loop_closer.closures and slam.loop_closer.closures[0][0] == kf
    assert not torch.equal(slam.map.kf_t, before)  # the closure moved the keyframes
    assert rep.counts["syncs"] == syncs + 1 and rep.counts["copies"] == 1
    assert _equal_maps(slam._tmap(), slam.map)
    if inertial:
        return
    seen = {}

    class Stop(Exception):
        pass

    def track(img, ts, schedule):
        seen["same"] = _equal_maps(slam._tmap(), slam.map)
        raise Stop

    slam._track_frame = track
    with pytest.raises(Stop):
        slam.process_frame(np.zeros((LC_KW["height"], LC_KW["width"]), np.float32), kf + 1.0)
    assert seen["same"] and rep.counts["max_stale"] == 0


def test_no_chunk_while_split(runs):
    split = copy.deepcopy(runs["split"]["slam"])
    single = copy.deepcopy(runs["single"]["slam"])
    for s in (split, single):
        s.lean_after_kf = 0  # a mature map by the gate's count
    assert single._chunkable() and not split._chunkable()


def test_devices_must_name_one_device_type():
    cam = np.asarray([200, 200, 187.5, 119.5, 0, 0, 0, 0, 0], np.float32)
    with pytest.raises(ValueError):
        tsys.MonoSlam(cam_params=cam, devices=("cpu", "meta"), **SLAM_KW)
    with pytest.raises(ValueError):
        tsys.MonoSlam(cam_params=cam, devices=SPLIT, device="meta", **SLAM_KW)


@pytest.mark.parametrize("cls", [tst.StereoSlam, tst.RgbdSlam, tst.StereoInertialSlam,
                                 tst.RgbdInertialSlam, tfe.FisheyeStereoSlam,
                                 tfe.FisheyeStereoInertialSlam])
def test_stereo_and_rig_systems_refuse_the_split(cls):
    cam = np.asarray([200, 200, 187.5, 119.5, 0, 0, 0, 0, 0], np.float32)
    kw = dict(SLAM_KW)
    if issubclass(cls, tsys.MonoSlam) and "Inertial" in cls.__name__:
        from vi_sim import make_calib
        from torch_parity import torch_calib

        kw["calib"] = torch_calib(make_calib(freq=100.0))
    with pytest.raises(ValueError, match="incompatible devices"):
        cls(cam_params=cam, devices=SPLIT, **kw)


@pytest.mark.slow  # the JAX package's stereo system compiles its programs: ~30 s
def test_jax_stereo_raises_under_devices():
    from orb_slam3_ros_tpu.models.stereo_system import StereoSlam as JaxStereo
    from orb_slam3_ros_tpu.utils import synth as jsynth

    devs = jax.devices()
    seq = jsynth.make_sequence(n_frames=3, height=240, width=376, dt=0.1, seed=3,
                               stereo_baseline=0.1)
    slam = JaxStereo(height=240, width=376, cam_params=seq.cam_params, n_features=800,
                     max_keyframes=32, max_points=4096, baseline=0.1, devices=(devs[0], devs[1]))
    slam.process_frame(seq.images[0], seq.images_right[0], float(seq.timestamps[0]))
    assert slam.state == jsys.OK  # the stereo initialization runs
    with pytest.raises(ValueError, match="incompatible devices"):
        slam.process_frame(seq.images[1], seq.images_right[1], float(seq.timestamps[1]))
