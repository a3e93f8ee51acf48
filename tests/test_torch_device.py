"""The port's entry points run on the CUDA device unless the caller asks
for the CPU: without ``device`` they raise where there is no card, and
never fall back to the CPU by themselves."""

import numpy as np
import pytest
import torch

import orb_slam3_ros_tpu_torch as port
from orb_slam3_ros_tpu_torch.models import inertial_system, map_state, system
from orb_slam3_ros_tpu_torch.ops import imu
from orb_slam3_ros_tpu_torch.utils import checkpoint, synth

CAM = np.asarray([200, 200, 46.5, 29.5, 0, 0, 0, 0, 0], np.float32)
KW = dict(height=60, width=94, cam_params=CAM, n_features=100, max_keyframes=4, max_points=32)
CALIB = imu.ImuCalib(*(np.full(3, 1e-3, np.float32),) * 4, np.eye(3, dtype=np.float32),
                     np.zeros(3, np.float32))

ENTRY_POINTS = {
    "MonoSlam": lambda **d: system.MonoSlam(**KW, **d).device,
    "InertialSlam": lambda **d: inertial_system.InertialSlam(**KW, calib=CALIB, **d).device,
    "empty_map": lambda **d: map_state.empty_map(2, 4, 8, **d).kf_R.device,
    "make_sequence": lambda **d: synth.make_sequence(n_frames=1, height=12, width=16, **d).images.device,
    "make_vi_sequence": lambda **d: synth.make_vi_sequence(n_frames=2, height=12, width=16, **d)[0].images.device,
}


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_no_device_argument_means_the_card(no_card, name):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name]()
    assert ENTRY_POINTS[name](device="cpu").type == "cpu"


def test_load_map_and_make_room(no_card, tmp_path):
    path = str(tmp_path / "m")
    checkpoint.save_map(path, map_state.empty_map(2, 4, 8, device="cpu"), {"n_kf": 0})
    with pytest.raises(RuntimeError, match='device="cpu"'):
        checkpoint.load_map(path)
    m, counters = checkpoint.load_map(path, device="cpu")
    assert m.kf_R.device.type == "cpu" and counters == {"n_kf": 0}
    with pytest.raises(RuntimeError, match='device="cpu"'):
        synth.make_room()


def test_default_device_resolver(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        port.default_device()
    assert port.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert port.default_device() == torch.device("cuda")
    assert port.resolve_device(None) == torch.device("cuda")
