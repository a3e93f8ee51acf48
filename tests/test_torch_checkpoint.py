"""Whole-session checkpoints (``utils/checkpoint.py``: ``save_atlas`` /
``load_atlas``, ``save_system`` / ``load_system``) carried between the JAX
package and the port, both ways: a session with an active map (monocular
or inertial, with its IMU blocks and flags), two archived maps (one with
IMU blocks, one without), loop edges and a trained-size vocabulary, all
filled from a numpy seed on small systems that map nothing. Every array
must arrive equal (exact: the files hold the same bytes' worth of
numbers), the counters too; an md5 or a capacity that does not match
raises.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.models import atlas as jatlas
from orb_slam3_ros_tpu.models import map_state as jms
from orb_slam3_ros_tpu.models.inertial_system import InertialSlam as JaxVI
from orb_slam3_ros_tpu.models.system import MonoSlam as JaxSlam
from orb_slam3_ros_tpu.utils import checkpoint as jck
from orb_slam3_ros_tpu_torch.models import atlas as tatlas
from orb_slam3_ros_tpu_torch.models import map_state as tms
from orb_slam3_ros_tpu_torch.models.inertial_system import InertialSlam
from orb_slam3_ros_tpu_torch.models.system import MonoSlam
from orb_slam3_ros_tpu_torch.utils import checkpoint as tck
from torch_parity import torch_calib
from vi_sim import make_calib

torch.set_num_threads(1)
KW = dict(height=120, width=160, cam_params=np.asarray([150.0, 150.0, 80.0, 60.0, 0, 0, 0, 0, 0],
                                                         np.float32),
          n_features=100, max_keyframes=8, max_points=256, enable_atlas=True,
          enable_loop_closing=True)


def _random_map_np(rng, K, N, P) -> dict:
    out = {}
    for f, a in tms.to_numpy(tms.empty_map(K, N, P, device="cpu")).items():
        if a.dtype == bool:
            out[f] = rng.random(a.shape) < 0.6
        elif a.dtype == np.int8:
            out[f] = rng.choice(np.array([-1, 1], np.int8), a.shape)
        elif a.dtype.kind == "i":
            out[f] = rng.integers(-1, 50, a.shape).astype(a.dtype)
        else:
            out[f] = rng.normal(size=a.shape).astype(a.dtype)
    return out


def _imu(rng, K, S):
    return dict(acc=rng.normal(size=(K, S, 3)).astype(np.float32),
                gyro=rng.normal(size=(K, S, 3)).astype(np.float32),
                dts=rng.random((K, S)).astype(np.float32))


def _make(package, inertial):
    if package == "jax":
        return JaxVI(calib=make_calib(), **KW) if inertial else JaxSlam(pipelined=False, **KW)
    kw = dict(KW, device="cpu")
    return InertialSlam(calib=torch_calib(make_calib()), **kw) if inertial else MonoSlam(pipelined=False, **kw)


def _fill(slam, package, inertial, seed=0):
    """A session on ``slam`` from seed: its active map and counters, two
    archived maps, loop edges, a vocabulary. Returns the numpy truth."""
    rng = np.random.default_rng(seed)
    K, N, P, S = slam.K_cap, slam.N, slam.P_cap, 256
    conv = ((lambda d: jms.MapState(**{k: jnp.asarray(v) for k, v in d.items()})) if package == "jax"
            else (lambda d: tms.from_numpy(d, "cpu")))
    active = _random_map_np(rng, K, N, P)
    slam.map, slam.n_kf, slam.n_pts, slam.frame_id, slam.state = conv(active), 6, 200, 77, 1
    slam.R_cur = rng.normal(size=(3, 3)).astype(np.float32)
    slam.t_cur = rng.normal(size=3).astype(np.float32)
    truth = dict(active=active, arch=[])
    if inertial:
        imu = _imu(rng, K, slam.imu_cap_kf)
        slam.kf_imu_acc, slam.kf_imu_gyro, slam.kf_imu_dts = imu["acc"], imu["gyro"], imu["dts"]
        slam.imu_initialized, slam.imu_stage, slam.chain_breaks = True, 2, {3, 5}
        slam.v_cur, slam.bg_cur, slam.ba_cur = (rng.normal(size=3).astype(np.float32) for _ in range(3))
        truth["imu"] = imu
    Arch = jatlas.ArchivedMap if package == "jax" else tatlas.ArchivedMap
    slam.atlas.maps = []
    for i, with_imu in enumerate((False, True)):
        m = _random_map_np(rng, K, N, P)
        sigs = rng.random((K, 64)).astype(np.float32)
        imu = None
        if with_imu:
            imu = dict(_imu(rng, K, S), initialized=True, stage=3, chain_breaks={2})
        slam.atlas.maps.append(Arch(
            m=conv(m), n_kf=5 + i, n_pts=100 + i,
            sigs=jnp.asarray(sigs) if package == "jax" else torch.from_numpy(sigs), imu=imu,
        ))
        truth["arch"].append((m, sigs, imu))
    lc = slam.loop_closer
    for j in range(3):
        lc._record_loop_edge(j + 3, j, rng.normal(size=(3, 3)).astype(np.float32),
                             rng.normal(size=3).astype(np.float32), float(1 + j))
    lc.last_closed_kf = 5
    vocab = rng.choice(np.array([-1, 1], np.int8), (64, 256))
    slam.set_vocabulary(vocab)
    truth["vocab"] = vocab
    return truth


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check_session(slam, truth, src, inertial):
    for f, a in truth["active"].items():
        np.testing.assert_array_equal(_np(getattr(slam.map, f)), a, err_msg=f)
    assert (slam.n_kf, slam.n_pts, slam.frame_id, slam.state) == (6, 200, 77, 1)
    np.testing.assert_array_equal(slam.R_cur, src.R_cur)
    np.testing.assert_array_equal(slam.t_cur, src.t_cur)
    if inertial:
        for f in ("acc", "gyro", "dts"):
            np.testing.assert_array_equal(getattr(slam, f"kf_imu_{f}"), truth["imu"][f])
        assert (slam.imu_initialized, slam.imu_stage, slam.chain_breaks) == (True, 2, {3, 5})
        for f in ("v_cur", "bg_cur", "ba_cur"):
            np.testing.assert_array_equal(getattr(slam, f), getattr(src, f))
    assert len(slam.atlas.maps) == 2
    for i, (am, (m, sigs, imu)) in enumerate(zip(slam.atlas.maps, truth["arch"])):
        assert (am.n_kf, am.n_pts) == (5 + i, 100 + i)
        for f, a in m.items():
            np.testing.assert_array_equal(_np(getattr(am.m, f)), a, err_msg=f)
        np.testing.assert_array_equal(_np(am.sigs), sigs)
        if imu is None:
            assert am.imu is None
        else:
            for f in ("acc", "gyro", "dts"):
                np.testing.assert_array_equal(am.imu[f], imu[f])
            assert (am.imu["initialized"], am.imu["stage"], am.imu["chain_breaks"]) == (True, 3, {2})
    for f in ("_edge_i", "_edge_j", "_edge_R", "_edge_t", "_edge_s"):
        np.testing.assert_array_equal(getattr(slam.loop_closer, f), getattr(src.loop_closer, f))
    assert (slam.loop_closer._n_edges, slam.loop_closer.last_closed_kf) == (3, 5)
    np.testing.assert_array_equal(_np(slam.vocab), truth["vocab"])
    np.testing.assert_array_equal(_np(slam.atlas.vocab), truth["vocab"])


SAVE = {"jax": jck.save_atlas, "torch": tck.save_atlas}
LOAD = {"jax": jck.load_atlas, "torch": tck.load_atlas}


@pytest.mark.parametrize("inertial", [False, True])
@pytest.mark.parametrize("src,dst", [("jax", "torch"), ("torch", "jax"), ("torch", "torch")])
def test_session_carries_across_packages(tmp_path, src, dst, inertial):
    a = _make(src, inertial)
    truth = _fill(a, src, inertial)
    path = str(tmp_path / "session")
    digest = SAVE[src](path, a)
    with open(path + ".json") as f:
        manifest = json.load(f)
    assert manifest["magic"] == jck.ATLAS_MAGIC == tck.ATLAS_MAGIC and manifest["md5"] == digest
    assert [e["imu"] is None for e in manifest["archived"]] == [True, False]
    b = _make(dst, inertial)
    LOAD[dst](path, b)
    _check_session(b, truth, a, inertial)
    if dst == "torch":
        assert b.map.kf_R.device.type == "cpu" and b.atlas.maps[1].sigs.device.type == "cpu"


def test_npz_keys_are_the_jax_packages(tmp_path):
    """The same section-prefixed keys, dtypes and shapes in both files."""
    keys = {}
    for pkg in ("jax", "torch"):
        s = _make(pkg, True)
        _fill(s, pkg, True)
        SAVE[pkg](str(tmp_path / pkg), s)
        with np.load(str(tmp_path / pkg) + ".npz") as d:
            keys[pkg] = {k: (d[k].dtype.str, d[k].shape) for k in d.files}
    assert keys["torch"] == keys["jax"]
    assert {"vocab", "loop.edge_i", "active.imu_acc", "arch1.imu_dts", "arch0.sigs"} <= set(keys["jax"])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_corrupted_checkpoint_raises_on_verify(tmp_path, writer):
    s = _make(writer, False)
    _fill(s, writer, False)
    path = str(tmp_path / "s")
    SAVE[writer](path, s)
    raw = bytearray(open(path + ".npz", "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path + ".npz", "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="checksum"):
        tck.load_atlas(path, _make("torch", False))
    with pytest.raises(ValueError, match="checksum"):
        jck.load_atlas(path, _make("jax", False))


@pytest.mark.parametrize("what", ["keyframes", "points"])
def test_capacity_mismatch_raises(tmp_path, what):
    s = _make("jax", False)
    _fill(s, "jax", False)
    path = str(tmp_path / "s")
    jck.save_atlas(path, s)
    kw = dict(KW, device="cpu", **({"max_keyframes": 16} if what == "keyframes" else {"max_points": 512}))
    with pytest.raises(ValueError, match="capacities"):
        tck.load_atlas(path, MonoSlam(**kw))


def test_wrong_magic_raises(tmp_path):
    s = _make("torch", False)
    _fill(s, "torch", False)
    path = str(tmp_path / "s")
    tck.save_system(path, s)
    with pytest.raises(ValueError, match="not an atlas"):
        tck.load_atlas(path, _make("torch", False))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_save_system_load_system_round_trip(tmp_path, writer):
    """``save_system`` (the map and the tracker's counters) written by
    either package restores a port system; and the JAX package reads the
    port's."""
    s = _make(writer, False)
    truth = _fill(s, writer, False)
    path = str(tmp_path / "sys")
    (jck if writer == "jax" else tck).save_system(path, s)
    for reader in ("torch", "jax"):
        b = _make(reader, False)
        (jck if reader == "jax" else tck).load_system(path, b)
        for f, a in truth["active"].items():
            np.testing.assert_array_equal(_np(getattr(b.map, f)), a, err_msg=f)
        assert (b.n_kf, b.n_pts, b.frame_id, b.state) == (6, 200, 77, 1)
        np.testing.assert_array_equal(b.R_cur, s.R_cur)
    small = MonoSlam(**dict(KW, device="cpu", max_points=128))
    with pytest.raises(ValueError, match="capacities"):
        tck.load_system(path, small)
