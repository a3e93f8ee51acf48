"""The port's settings reader (``utils/config.py``), observation log
(``utils/obslog.py``) and quaternion maps (``ops/lie.py``) against the JAX
package's, on the same inputs.

Tolerances: settings fields equal (exact; the same parser on the same
text), the IMU calibration to rtol 1e-6 (float32 of the same float64
products); the event lines equal once ``wall`` is dropped; the quaternions
to 1e-6 up to sign and the matrices back to 1e-6.
"""

import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.ops import lie as jlie
from orb_slam3_ros_tpu.utils import config as jcfg
from orb_slam3_ros_tpu.utils import obslog as jlog
from orb_slam3_ros_tpu_torch.ops import lie as tlie
from orb_slam3_ros_tpu_torch.utils import config as tcfg
from orb_slam3_ros_tpu_torch.utils import obslog as tlog
from test_io import EUROC_YAML

# The TUM-VI stereo-inertial shape: two KB8 cameras, the stereo extrinsic,
# the IMU, an RGB-D factor and the Atlas paths.
KB8_YAML = """
%YAML:1.0
Camera.type: "KannalaBrandt8"
Camera1.fx: 190.978477
Camera1.fy: 190.973307
Camera1.cx: 254.931706
Camera1.cy: 256.897442
Camera1.k1: 0.003482389402
Camera1.k2: 0.000715034845
Camera1.k3: -0.002053236141
Camera1.k4: 0.000202936736
Camera.width: 512
Camera.height: 512
Camera.fps: 20
Camera.bf: 19.3079
Stereo.T_c1_c2: !!opencv-matrix
   rows: 4
   cols: 4
   dt: f
   data: [0.999997, 0.00231714, 0.000343393, 0.101166,
          -0.00231207, 0.999898, -0.0140907, 0.00198666,
          -0.000376008, 0.0140898, 0.999900, -0.00103304,
          0.0, 0.0, 0.0, 1.0]
IMU.NoiseGyro: 0.00016
IMU.NoiseAcc: 0.0028
IMU.GyroWalk: 0.000022
IMU.AccWalk: 0.00086
IMU.Frequency: 200.0
RGBD.DepthMapFactor: 5000.0
ORBextractor.nFeatures: 1500
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
System.SaveAtlasToFile: "session_out"
System.LoadAtlasFromFile: "session_in"
"""

FIELDS = ("camera_type", "width", "height", "fps", "cam_params", "kb8_params", "baseline",
          "T_lr", "has_imu", "imu_freq", "noise_gyro", "noise_acc", "walk_gyro", "walk_acc",
          "T_b_c1", "depth_map_factor", "n_features", "scale_factor", "n_levels",
          "ini_th_fast", "min_th_fast", "atlas_save_file", "atlas_load_file")


@pytest.mark.parametrize("text", [EUROC_YAML, KB8_YAML, "Camera.fx: 100.0\n"],
                         ids=["euroc", "tumvi_kb8", "minimal"])
def test_settings_equal_jax(text, tmp_path):
    want = jcfg.load_settings(text)
    got = tcfg.load_settings(text)
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f)
            assert np.asarray(a).dtype == np.asarray(b).dtype, f
        else:
            assert a == b and type(a) is type(b), f
    assert set(got.raw) == set(want.raw)
    # from a file path as from text
    p = tmp_path / "settings.yaml"
    p.write_text(text)
    np.testing.assert_array_equal(tcfg.load_settings(str(p)).cam_params, want.cam_params)


@pytest.mark.parametrize("text", [EUROC_YAML, KB8_YAML], ids=["euroc", "tumvi_kb8"])
def test_imu_calib_equal_jax(text):
    s = tcfg.load_settings(text)
    want = jcfg.imu_calib_from_settings(jcfg.load_settings(text))
    got = tcfg.imu_calib_from_settings(s, device="cpu")
    assert got._fields == want._fields
    for f in want._fields:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.dtype == torch.float32 and g.device.type == "cpu", f
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=0, err_msg=f)


def test_require_raises_alike():
    for mod in (jcfg, tcfg):
        s = mod.load_settings("Camera.fx: 100.0\n")
        assert s.require("Camera.fx") == 100.0
        with pytest.raises(KeyError, match="Camera.fy"):
            s.require("Camera.fy")


def _events(rng):
    return [
        dict(event="frame", ts=0.1, Twc=rng.normal(size=(4, 4)).astype(np.float32),
             n_inliers=np.int64(212), state=1, n_kf=np.int32(3)),
        dict(event="keyframe", ts=np.float64(0.2), kf_id=4),
        dict(event="map_points", ts=0.2, n=5, points=rng.normal(size=(5, 3)).astype(np.float32)),
        dict(event="kf_markers", ts=0.2, n=2, centers=np.zeros((2, 3), np.float32)),
        dict(event="tracked_points", ts=0.2, n=0, points=np.zeros((0, 3), np.float32)),
        dict(event="loop", new_kf=9, cand_kf=np.int32(1)),
    ]


def test_frame_streamer_lines_equal_jax(tmp_path):
    rng = np.random.default_rng(4)
    evs = _events(rng)
    paths = []
    for mod, name in ((jlog, "j"), (tlog, "t")):
        p = tmp_path / f"{name}.jsonl"
        with mod.FrameStreamer(str(p)) as fs:
            for ev in evs:
                fs(ev)
        paths.append(p)
    lines = [[json.loads(x) for x in p.read_text().splitlines()] for p in paths]
    assert len(lines[0]) == len(lines[1]) == len(evs)
    for a, b in zip(*lines):
        assert "wall" in a and "wall" in b
        a.pop("wall")
        b.pop("wall")
        assert a == b


def test_log_levels_equal_jax():
    outs = {}
    for mod in (jlog, tlog):
        sink, level = mod._sink, mod.get_level()
        buf = io.StringIO()
        mod._sink = buf
        try:
            for lv in (mod.QUIET, mod.NORMAL, mod.VERBOSE, mod.DEBUG):
                mod.set_level(lv)
                assert mod.get_level() == lv
                for msg_lv in (mod.NORMAL, mod.VERBOSE, mod.DEBUG):
                    mod.log(f"at {lv}: {msg_lv}", msg_lv)
        finally:
            mod._sink = sink
            mod.set_level(level)
        outs[mod] = buf.getvalue()
    assert outs[tlog] == outs[jlog] and outs[tlog].count("\n") == 6


def _rotations(rng, n):
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32) * 2.0)))
    # each branch of Shepperd's method: near the identity and near a half
    # turn about each axis
    special = [np.eye(3), np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]),
               np.diag([-1.0, -1.0, 1.0])]
    return np.concatenate([R, np.asarray(special, np.float32)])


def test_quaternions_equal_jax():
    R = _rotations(np.random.default_rng(7), 200)
    qj = np.asarray(jlie.quat_from_rotmat(jnp.asarray(R)))
    qt = tlie.quat_from_rotmat(torch.from_numpy(R)).numpy()
    sign = np.where(np.sum(qj * qt, -1, keepdims=True) < 0, -1.0, 1.0)
    np.testing.assert_allclose(qt, sign * qj, atol=1e-6)
    assert (qt[:, 0] >= 0).all()
    Rj = np.asarray(jlie.rotmat_from_quat(jnp.asarray(qj)))
    Rt = tlie.rotmat_from_quat(torch.from_numpy(qt)).numpy()
    np.testing.assert_allclose(Rt, Rj, atol=1e-6)
    np.testing.assert_allclose(Rt, R, atol=1e-5)
    # unnormalized input is normalized first, batched over leading dims
    q2 = torch.from_numpy(3.0 * qt).reshape(4, -1, 4)
    np.testing.assert_allclose(tlie.rotmat_from_quat(q2).reshape(-1, 3, 3).numpy(), Rt, atol=1e-6)
