"""Typed YAML settings reader — port of ``orb_slam3_ros_tpu.utils.config``
(the reference's ``Settings``, orb_slam3/src/Settings.cc:127,
include/Settings.h:126-145 ``readParameter<T>``, reduced to the modern typed
schema).

The sections the reference parses: Camera1/Camera2 (PinHole | Rectified |
KannalaBrandt8), stereo (Tlr / baseline), IMU (noise / walk / frequency /
T_b_c1), RGB-D depth, the ORB extractor and the Atlas load / save paths.
Unknown keys are ignored; a missing *required* key raises ``KeyError``
(``Settings.require``; the reference exits, Settings.h:131).

The YAML subset of the reference's configs is parsed without a YAML
library: flat ``Section.key: value`` pairs and ``!!opencv-matrix`` blocks
(rows / cols / data). Everything is numpy but ``imu_calib_from_settings``,
which builds the port's ``ops.imu.ImuCalib`` on a torch device.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


def _parse_scalar(s: str):
    s = s.strip().strip('"')
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return s


def parse_flat_yaml(text: str) -> dict:
    """Parse the reference's settings YAML subset into a flat dict.

    Handles ``key: value`` lines, comments, the ``%YAML`` directive, and
    inline opencv-matrix blocks (rows/cols/dt/data)."""
    out: dict = {}
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        line = lines[i].split("#", 1)[0].rstrip()
        i += 1
        if not line or line.startswith("%") or line.startswith("---"):
            continue
        m = re.match(r"^([\w.]+):\s*(.*)$", line.strip())
        if not m:
            continue
        key, val = m.group(1), m.group(2)
        if val.startswith("!!opencv-matrix") or val == "":
            # matrix block: collect rows/cols/data until 'data' closes
            block = {}
            data_txt = ""
            collecting = False
            while i < len(lines):
                sub = lines[i].split("#", 1)[0].rstrip()
                if collecting:
                    data_txt += " " + sub
                    i += 1
                    if "]" in sub:
                        break
                    continue
                sm = re.match(r"^\s+(\w+):\s*(.*)$", sub)
                if not sm:
                    break
                i += 1
                k2, v2 = sm.group(1), sm.group(2)
                if k2 == "data":
                    data_txt = v2
                    if "]" not in v2:
                        collecting = True
                        continue
                    break
                block[k2] = _parse_scalar(v2)
            nums = [float(x) for x in re.findall(r"[-+0-9.eE]+", data_txt)]
            rows = int(block.get("rows", 1))
            cols = int(block.get("cols", len(nums)))
            out[key] = np.asarray(nums, np.float64).reshape(rows, cols)
        else:
            out[key] = _parse_scalar(val)
    return out


@dataclass
class Settings:
    """Typed view over the flat settings dict."""

    raw: dict
    camera_type: str = "PinHole"
    width: int = 0
    height: int = 0
    fps: float = 30.0
    cam_params: np.ndarray = field(default_factory=lambda: np.zeros(9, np.float32))
    kb8_params: Optional[np.ndarray] = None
    # stereo
    baseline: float = 0.0
    T_lr: Optional[np.ndarray] = None
    # IMU
    has_imu: bool = False
    imu_freq: float = 0.0
    noise_gyro: float = 0.0
    noise_acc: float = 0.0
    walk_gyro: float = 0.0
    walk_acc: float = 0.0
    T_b_c1: Optional[np.ndarray] = None
    # RGBD
    depth_map_factor: float = 1.0
    # ORB
    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0
    # Atlas
    atlas_save_file: str = ""
    atlas_load_file: str = ""

    def require(self, key):
        if key not in self.raw:
            raise KeyError(f"required settings key missing: {key}")
        return self.raw[key]


def load_settings(path_or_text: str) -> Settings:
    """Build Settings from a YAML file path or literal text."""
    try:
        with open(path_or_text) as f:
            text = f.read()
    except (OSError, ValueError):
        text = path_or_text
    raw = parse_flat_yaml(text)
    s = Settings(raw=raw)

    s.camera_type = raw.get("Camera.type", raw.get("Camera1.type", "PinHole"))
    pfx = "Camera1" if "Camera1.fx" in raw else "Camera"
    fx = raw.get(f"{pfx}.fx", 0.0)
    fy = raw.get(f"{pfx}.fy", 0.0)
    cx = raw.get(f"{pfx}.cx", 0.0)
    cy = raw.get(f"{pfx}.cy", 0.0)
    if s.camera_type == "KannalaBrandt8":
        s.kb8_params = np.asarray(
            [fx, fy, cx, cy]
            + [raw.get(f"{pfx}.k{i}", 0.0) for i in range(1, 5)],
            np.float32,
        )
        s.cam_params = np.asarray([fx, fy, cx, cy, 0, 0, 0, 0, 0], np.float32)
    else:
        s.cam_params = np.asarray(
            [
                fx, fy, cx, cy,
                raw.get(f"{pfx}.k1", 0.0), raw.get(f"{pfx}.k2", 0.0),
                raw.get(f"{pfx}.p1", 0.0), raw.get(f"{pfx}.p2", 0.0),
                raw.get(f"{pfx}.k3", 0.0),
            ],
            np.float32,
        )
    s.width = int(raw.get("Camera.width", raw.get("Camera1.width", 0)))
    s.height = int(raw.get("Camera.height", raw.get("Camera1.height", 0)))
    s.fps = float(raw.get("Camera.fps", 30.0))
    s.baseline = float(
        raw.get("Stereo.b", raw.get("Camera.bf", 0.0) / max(fx, 1e-9))
    )
    if "Stereo.T_c1_c2" in raw:
        s.T_lr = raw["Stereo.T_c1_c2"]

    if "IMU.Frequency" in raw:
        s.has_imu = True
        s.imu_freq = float(raw["IMU.Frequency"])
        s.noise_gyro = float(raw.get("IMU.NoiseGyro", 0.0))
        s.noise_acc = float(raw.get("IMU.NoiseAcc", 0.0))
        s.walk_gyro = float(raw.get("IMU.GyroWalk", 0.0))
        s.walk_acc = float(raw.get("IMU.AccWalk", 0.0))
        if "IMU.T_b_c1" in raw:
            s.T_b_c1 = raw["IMU.T_b_c1"]

    s.depth_map_factor = float(raw.get("RGBD.DepthMapFactor", 1.0))
    s.n_features = int(raw.get("ORBextractor.nFeatures", 1000))
    s.scale_factor = float(raw.get("ORBextractor.scaleFactor", 1.2))
    s.n_levels = int(raw.get("ORBextractor.nLevels", 8))
    s.ini_th_fast = float(raw.get("ORBextractor.iniThFAST", 20.0))
    s.min_th_fast = float(raw.get("ORBextractor.minThFAST", 7.0))
    s.atlas_save_file = str(raw.get("System.SaveAtlasToFile", ""))
    s.atlas_load_file = str(raw.get("System.LoadAtlasFromFile", ""))
    return s


def imu_calib_from_settings(s: Settings, device=None):
    """Discretized ``ImuCalib`` on ``device`` (None: the CUDA device), the
    reference's sqrt-frequency scaling (Tracking.cc:1386-1395): noise
    densities times sqrt(rate), random walks divided by it."""
    import torch

    from .. import resolve_device
    from ..ops.imu import ImuCalib

    dev = resolve_device(device)
    sf = np.sqrt(max(s.imu_freq, 1.0))
    if s.T_b_c1 is not None:
        R_bc = torch.as_tensor(np.asarray(s.T_b_c1[:3, :3], np.float32), device=dev)
        t_bc = torch.as_tensor(np.asarray(s.T_b_c1[:3, 3], np.float32), device=dev)
    else:
        R_bc = torch.eye(3, dtype=torch.float32, device=dev)
        t_bc = torch.zeros(3, dtype=torch.float32, device=dev)

    def full(v):
        return torch.full((3,), float(np.float32(v)), dtype=torch.float32, device=dev)

    return ImuCalib(
        sigma_g=full(s.noise_gyro * sf), sigma_a=full(s.noise_acc * sf),
        sigma_gw=full(s.walk_gyro / sf), sigma_aw=full(s.walk_acc / sf),
        R_bc=R_bc, t_bc=t_bc,
    )
