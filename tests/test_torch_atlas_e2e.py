"""The Atlas end to end on the port and the JAX package, in
``tests/test_atlas.py``'s blackout scenario (240x376, 40 frames of
``make_sequence(seed=3)``, 1200 features, ``kf_every`` 3, ``lost_patience``
3: 22 frames mapped, 8 blank frames, then back to the scene with the clock
running on), frame by frame, each system built once in the module fixture.

The JAX ``MonoSlam`` runs the whole scenario. The JAX system's session is
carried into the port twice, through the JAX package's ``save_atlas`` and
the port's ``load_atlas`` (plus the tracker's motion model and trajectory
logs): at the end of the mapping, after which the port runs the blackout
itself (it loses track and archives the map), and at step ``CARRY`` (the
young map initialized, its weld not yet tried), after which it runs the
rest of the return. (The port's own mapping of these frames is held
against the JAX package's in ``test_torch_mono_e2e.py``.) Both take their RANSAC hypotheses from one
stream: the n-th two-view initialization of either draws the JAX package's
samples for key 1000 + n, the n-th Sim(3) RANSAC of a weld those for key
2000 + n (the port through ``two_view_init_from_samples`` /
``solve_sim3_from_samples``). Two-view initialization and the weld each
succeed on some draws and maps and not on others: with independent draws,
or with each package re-initializing on its own, the frame of either is a
matter of luck (two independent runs here re-initialize 5 frames apart).

Then a chunked continuation of the port alone: a copy of its system at the
carry runs on in chunks of 5 (``lean_after_kf`` 4, so that the chunk gate
opens on the young map) over the same return, and welds at a chunk
boundary; the chunk after the weld loads the welded map.

Held against the JAX run: the maps archived at the blackout, the recovery
route (a switch into the archived map, or a weld), the step at which the
archived map came back (within 2 of the JAX package's), each step's state
(equal) and keyframe count (within 1) after the carry, a finite trajectory,
and the Sim(3) ATE after the return within ``ATE_MARGIN`` of the JAX
package's (measured here: 0.00402 m for the JAX package, 0.00419 m for the
port, over the same 7 poses).
"""

import copy

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
H, W, N_FRAMES, MAPPED, BLANK = 240, 376, 40, 22, 8
CARRY = 35  # the step after which the JAX session is carried into the port the second time
SLAM_KW = dict(height=H, width=W, n_features=1200, max_keyframes=64, max_points=8192, kf_every=3,
               enable_atlas=True, lost_patience=3)
ATE_MARGIN = 0.001  # m: ~6x the gap measured between the packages, a quarter of their ATE
CHUNK = 5


def _timeline():
    """(step timestamps, the sequence frame of each step or None for a blank)."""
    frames = list(range(MAPPED)) + [None] * BLANK + list(range(MAPPED, N_FRAMES))
    return 0.1 * np.arange(len(frames)), frames


_DRAWS = {"init": 0, "sim3": 0}


def _jax_samples(kind, valid, shape):
    import jax
    import jax.numpy as jnp

    key = jax.random.PRNGKey({"init": 1000, "sim3": 2000}[kind] + _DRAWS[kind])
    logits = jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)
    return key, np.asarray(jax.random.categorical(key, logits[None, :], shape=shape))


def _shared_draws(monkeypatch):
    """Both packages' two-view and Sim(3) RANSAC draw from one stream of
    keys, counted in ``_DRAWS``."""
    from orb_slam3_ros_tpu.ops import ransac as jransac
    from orb_slam3_ros_tpu.ops import sim3solver as jsim3
    from orb_slam3_ros_tpu_torch.ops import ransac as transac
    from orb_slam3_ros_tpu_torch.ops import sim3solver as tsim3

    j_init, j_sim3 = jransac.two_view_init, jsim3.solve_sim3

    def counted(kind, fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            _DRAWS[kind] += 1
            return out
        return wrapped

    def jax_init(xy1, xy2, valid, cam, key, n_hyp=256, sigma=1.0):
        key, _ = _jax_samples("init", valid, (n_hyp, 8))
        return j_init(xy1, xy2, valid, cam, key, n_hyp=n_hyp, sigma=sigma)

    def jax_sim3(X1, X2, ok, cam, key, **kw):
        key, _ = _jax_samples("sim3", ok, (jsim3_n_hyp(), 3))
        return j_sim3(X1, X2, ok, cam, key, **kw)

    def torch_init(xy1, xy2, valid, cam, generator, n_hyp=256, sigma=1.0):
        _, idx = _jax_samples("init", valid.numpy(), (n_hyp, 8))
        return transac.two_view_init_from_samples(xy1, xy2, valid, cam, torch.from_numpy(idx), sigma)

    def torch_sim3(X1, X2, ok, cam, generator, **kw):
        _, idx = _jax_samples("sim3", ok.numpy(), (tsim3.N_HYP, 3))
        return tsim3.solve_sim3_from_samples(X1, X2, ok, cam, torch.from_numpy(idx), **kw)

    def jsim3_n_hyp():
        return tsim3.N_HYP  # the JAX solve_sim3's default n_hyp, the same 128

    monkeypatch.setattr(jransac, "two_view_init", counted("init", jax_init))
    monkeypatch.setattr(jsim3, "solve_sim3", counted("sim3", jax_sim3))
    monkeypatch.setattr(transac, "two_view_init", counted("init", torch_init))
    monkeypatch.setattr(tsim3, "solve_sim3", counted("sim3", torch_sim3))


def _drive(slam, images, blank, events, start=0, stop=None, on_step=None):
    """Per frame over steps [start, stop); returns the log of (step, state,
    maps archived, n_kf) and notes the step the archived map came back.
    ``on_step(s)`` runs after each step."""
    ts, frames = _timeline()
    _DRAWS.update(events.setdefault("draws", {"init": 0, "sim3": 0}))
    log = []
    for s in range(start, len(frames) if stop is None else stop):
        maps0 = len(slam.atlas.maps)
        img = blank if frames[s] is None else images[frames[s]]
        slam.process_frame(img, float(ts[s]))
        log.append((s, int(slam.state), len(slam.atlas.maps), int(slam.n_kf)))
        if maps0 and not slam.atlas.maps and "back" not in events:
            events["back"] = s
        if on_step is not None:
            on_step(s)
    events["draws"] = dict(_DRAWS)
    return log


HOST = ("vel_R", "vel_t", "last_kf_frame", "_ref_kf_inl", "_last_frame_ts", "lost_count",
        "_init_fail_count", "trajectory", "rel_traj", "frozen_traj")


def _instrument(slam, events):
    """Count switches and welds on ``slam``'s Atlas."""
    atlas = slam.atlas
    for name in ("try_relocalize_in_archived", "merge_current_into"):
        atlas.__dict__.pop(name, None)  # a copied system's wrappers call the original's
    reloc, merge = atlas.try_relocalize_in_archived, atlas.merge_current_into

    def switch(*a, **k):
        ok = reloc(*a, **k)
        events["switch"] = events.get("switch", 0) + bool(ok)
        return ok

    def weld(*a, **k):
        ok = merge(*a, **k)
        events["weld"] = events.get("weld", 0) + bool(ok)
        return ok

    atlas.try_relocalize_in_archived, atlas.merge_current_into = switch, weld


def _ate_after(slam, ts0):
    from orb_slam3_ros_tpu_torch.utils.evaluate_ate import ate_rmse

    seq = _seq_np()
    ts, frames = _timeline()
    shown = [s for s, f in enumerate(frames) if f is not None]
    gt_ts, gt_pos = ts[shown], seq["t_wc"][[frames[s] for s in shown]]
    traj = [(t, T) for t, T in slam.get_trajectory() if t >= ts0 - 1e-6]
    est = np.stack([T[:3, 3] for _, T in traj])
    rmse, n, _ = ate_rmse(np.asarray([t for t, _ in traj]), est, gt_ts, gt_pos, with_scale=True)
    return rmse, n


_SEQ = {}


def _seq_np():
    if not _SEQ:
        from orb_slam3_ros_tpu_torch.utils import synth

        seq = synth.make_sequence(n_frames=N_FRAMES, height=H, width=W, dt=0.1, seed=3,
                                  device="cpu")
        _SEQ.update(images=seq.images.numpy(), t_wc=np.asarray(seq.t_wc), cam=seq.cam_params)
    return _SEQ


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    _shared_draws(mp)
    try:
        return _runs(str(tmp_path_factory.mktemp("carry") / "session"))
    finally:
        mp.undo()


def _runs(path):
    from orb_slam3_ros_tpu.models.system import MonoSlam as JaxSlam
    from orb_slam3_ros_tpu.utils import checkpoint as jck
    from orb_slam3_ros_tpu_torch.models import device_loop
    from orb_slam3_ros_tpu_torch.models.system import MonoSlam
    from orb_slam3_ros_tpu_torch.utils import checkpoint as tck

    seq = _seq_np()
    blank = np.zeros((H, W), np.float32)
    out = {}
    js = JaxSlam(cam_params=seq["cam"], pipelined=False, **SLAM_KW)
    jev, carried = {}, {}
    _instrument(js, jev)

    def capture(s):
        if s == MAPPED - 1:  # the end of the mapping
            assert js.state == 1 and js.n_kf >= 8 and not js.atlas.maps
        elif s == CARRY:  # the young map initialized, its first weld not yet tried
            assert js.state == 1 and js.atlas.maps and 2 <= js.n_kf < 4
        else:
            return
        jck.save_atlas(f"{path}{s}", js)
        carried[s] = dict(draws=dict(_DRAWS), host={f: copy.deepcopy(getattr(js, f)) for f in HOST})

    jlog = _drive(js, seq["images"], blank, jev, on_step=capture)
    out["jax"] = dict(slam=js, log=jlog, events=jev)

    ts_ = MonoSlam(cam_params=seq["cam"], device="cpu", pipelined=False, **SLAM_KW)
    tev = {}
    _instrument(ts_, tev)

    def carry(s):
        tck.load_atlas(f"{path}{s}", ts_)
        for f, v in carried[s]["host"].items():
            if f in ("trajectory", "frozen_traj"):
                v = [(t, np.asarray(T)) for t, T in v]
            elif f == "rel_traj":
                v = [(t, int(r), np.asarray(R), np.asarray(tt)) for t, r, R, tt in v]
            elif f in ("vel_R", "vel_t"):
                v = np.asarray(v, np.float32)
            setattr(ts_, f, v)
        tev["draws"] = dict(carried[s]["draws"])

    carry(MAPPED - 1)
    tlog = jlog[:MAPPED]  # the carried steps are the JAX run's
    tlog += _drive(ts_, seq["images"], blank, tev, start=MAPPED, stop=MAPPED + BLANK)
    carry(CARRY)
    tlog += jlog[MAPPED + BLANK : CARRY + 1]
    gen, ts_.generator = ts_.generator, None
    snap = copy.deepcopy(ts_)  # the carried session, for the chunked continuation
    ts_.generator, snap.generator = gen, torch.Generator()
    snap.generator.set_state(gen.get_state())
    tlog += _drive(ts_, seq["images"], blank, tev, start=CARRY + 1)
    out["torch"] = dict(slam=ts_, log=tlog, events=tev)

    # the chunked continuation of the port's copy
    cs = snap
    cs.lean_after_kf = 4
    cev = {}
    _instrument(cs, cev)
    loads = []
    load = device_loop.MonoChunkRunner.load

    def logged(self, m, *a):
        loads.append((int(m.kf_valid.sum()), int(a[1])))
        return load(self, m, *a)

    ts, frames = _timeline()
    stack = torch.from_numpy(np.stack([blank if f is None else seq["images"][f] for f in frames]))
    s = CARRY + 1
    chunks = []
    _DRAWS.update(carried[CARRY]["draws"])
    device_loop.MonoChunkRunner.load = logged
    try:
        while s < len(frames):
            if cs.state == 1 and cs._chunkable() and s + CHUNK <= len(frames):
                w0, n0 = cev.get("weld", 0), len(loads)
                cs.process_frames((stack, s), ts[s : s + CHUNK])
                chunks.append((s, w0, cev.get("weld", 0), int(cs.n_kf), int(cs.map.kf_valid.sum()),
                               len(loads) == n0 + 1))
                s += CHUNK
            else:
                w0 = cev.get("weld", 0)
                cs.process_frame(stack[s], float(ts[s]))
                if cev.get("weld", 0) > w0:
                    cev["per_frame_weld"] = s
                s += 1
    finally:
        device_loop.MonoChunkRunner.load = load
    out["chunked"] = dict(slam=cs, events=cev, chunks=chunks, loads=loads)
    return out


def _route(ev):
    return "switch" if ev.get("switch") else ("weld" if ev.get("weld") else None)


@pytest.mark.parametrize("step", range(MAPPED, MAPPED + BLANK))
def test_the_blackout_loses_track_and_archives_as_jax(runs, step):
    """LOST on the first blank frames, the map archived at the
    ``lost_patience``-th failed relocalization, then NOT_INITIALIZED."""
    j, t = runs["jax"]["log"][step], runs["torch"]["log"][step]
    assert t == j, (t, j)
    if step == MAPPED + BLANK - 1:
        assert t[1:] == (0, 1, 0)  # NOT_INITIALIZED, one map archived, an empty map


def test_recovery_takes_the_jax_route_at_the_same_frame(runs):
    jev, tev = runs["jax"]["events"], runs["torch"]["events"]
    assert _route(tev) == _route(jev) is not None
    assert abs(tev["back"] - jev["back"]) <= 2, (tev, jev)
    assert not runs["torch"]["slam"].atlas.maps


def test_state_ok_and_trajectory_finite(runs):
    for k in ("jax", "torch", "chunked"):
        slam = runs[k]["slam"]
        assert slam.state == 1, k
        traj = slam.get_trajectory()
        assert len(traj) >= 20 and all(np.isfinite(T).all() for _, T in traj), k


def test_ate_after_the_return_is_within_the_margin_of_jax(runs):
    ts, _ = _timeline()
    res = {}
    for k in ("jax", "torch"):
        back = runs[k]["events"]["back"]
        res[k] = _ate_after(runs[k]["slam"], ts[back + 1])
    assert res["torch"][1] >= res["jax"][1] - 2, res
    assert res["torch"][0] <= res["jax"][0] + ATE_MARGIN, res


def test_chunked_continuation_welds_at_a_chunk_boundary(runs):
    c = runs["chunked"]
    assert "per_frame_weld" not in c["events"] and c["events"].get("weld") == 1, c
    welded = [ch for ch in c["chunks"] if ch[2] > ch[1]]
    assert len(welded) == 1 and not c["slam"].atlas.maps


def test_the_chunk_after_the_weld_runs_on_the_welded_map(runs):
    """Each chunk loads the system's map into the runner's buffers: the
    first chunk after the weld loads the welded map (its keyframes the
    archived map's and the young one's), and goes on inserting there."""
    c = runs["chunked"]
    assert all(ch[5] for ch in c["chunks"])  # one load a chunk
    i = [k for k, ch in enumerate(c["chunks"]) if ch[2] > ch[1]][0]
    assert i + 1 < len(c["chunks"]), "no chunk ran after the weld"
    _, _, _, n_kf_weld, n_valid_weld, _ = c["chunks"][i]
    assert c["loads"][i + 1] == (n_valid_weld, n_kf_weld)
    kf_before = runs["jax"]["log"][MAPPED - 1][3]  # the archived map is the carried one
    assert n_kf_weld >= kf_before + 4 and c["chunks"][i + 1][3] >= n_kf_weld


@pytest.mark.parametrize("step", range(CARRY + 1, MAPPED + BLANK + N_FRAMES - MAPPED))
def test_each_step_after_the_carry_matches_jax(runs, step):
    """The same state at every frame after the carry, and the keyframe
    count within 1 (a keyframe decision on an inlier count at its bar may
    fall either way)."""
    j, t = runs["jax"]["log"][step], runs["torch"]["log"][step]
    assert t[0] == j[0] == step
    assert t[1] == j[1] and abs(t[3] - j[3]) <= 1, (t, j)
