"""The visual-inertial frame program of ``InertialSlam``'s per-frame path —
port of the JAX package's ``InertialSlam._vi_fused_program``
(``models/inertial_system.py:378-414``).

One frame once the IMU is initialized: preintegration of the frame's IMU
block at the anchor's bias, the IMU prediction, extraction, tracking from
the prediction and the 15-dof refinement (``vi_device_loop.vi_frame``, the
first half of the VI chunk's frame step). ``VIFrameProgram`` runs it as one
region of ``frame_program.TrackingRegions``, the speculative frame
program's buffers and map copy: on the card one replay of a CUDA graph per
tracking schedule, both captured at the first VI frame (a failed capture
raises; nothing falls back to the eager path); off the card the same
function runs eagerly on the same buffers.

Its inputs are static buffers:

* ``img`` [H, W]: float32, or uint8 under ``transfer_uint8``;
* ``imu`` [imu_cap_frame, 7]: the frame's IMU block (acc | gyro | dt, zero
  rows as padding), uploaded from pinned memory;
* the anchor ``anc_R`` [3, 3], ``anc_p``, ``anc_v``, ``anc_bg``, ``anc_ba``
  and its covariance ``anc_Sigma`` [15, 15] (``VIAnchorRegions``): the
  previous frame's refined state copied device to device, or, when the
  system has none (after a keyframe, a global-BA fold-in, an
  initialization stage, a reset, a relocalization), the host's pose,
  velocity and biases uploaded from pinned memory into ``host_anc`` [21]
  and turned into the body state on the device; a covariance that is None
  zeroes the buffer in place;
* the map, copied in only when a field changed (``TrackingRegions._load_map``:
  the refinement reads no map field that tracking does not).

After each replay ``dispatch`` copies the outputs out on the device (the
next replay overwrites them before the frame is drained): the features,
the ``TrackResult`` (its pose is the tracking's, ``trk``), the refinement's
``PoseInertialResult`` (``vi_*``), and the packed [22] (n_inliers, R_cw,
t_cw, v, bg, ba) the drain reads, sent to pinned host memory behind a CUDA
event (``HostCopy``).
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import numpy as np
import torch

from ..ops import imu as imu_ops
from ..ops import orb, viba
from . import tracking
from .frame_program import (HostCopy, TrackingRegions, load_image, program_map, store_tracked,
                            upload)
from .vi_device_loop import vi_frame

PACKED_LEN = 22  # (n_inliers, R_cw, t_cw, v, bg, ba): the frame's one host read
ANCHOR = ("anc_R", "anc_p", "anc_v", "anc_bg", "anc_ba")


class VIFrameConfig(NamedTuple):
    """The static settings of one system's VI frame program
    (``frame_program.FrameConfig``'s, with the IMU's)."""

    config: orb.ExtractorConfig
    cam_params: torch.Tensor  # on the program's device
    calib: imu_ops.ImuCalib  # on the program's device
    width: int
    height: int
    track_cap: int | None
    cam_model: str
    uint8: bool
    K: int
    N: int
    P: int
    imu_cap_frame: int

    # ``chunk_runner.prep_frame``'s branch, not a field: the program's frame
    # is monocular
    stereo = False


class VIFrameOut(NamedTuple):
    """One dispatched VI frame: its features, tracking result and
    refinement on the device (copies of the program's outputs) and the host
    copy of the packed [22] in flight."""

    feats: orb.Features
    res: tracking.TrackResult
    vires: viba.PoseInertialResult
    host: HostCopy


def vi_outputs(res: tracking.TrackResult, vires: viba.PoseInertialResult) -> dict:
    """The tracking pose (``trk``) and the refinement (``vi_*``) by buffer
    name."""
    return dict(trk=torch.cat([res.R.reshape(9), res.t]),
                **{f"vi_{k}": getattr(vires, k) for k in viba.PoseInertialResult._fields})


def vi_frame_program(buf: dict, blank: dict, cfg: VIFrameConfig, schedule: tuple) -> None:
    """The VI frame on the program's buffers, each output copied into its
    buffer."""
    anchor = [buf[k] for k in ANCHOR]
    f = vi_frame(program_map(buf, blank), buf["img"], buf["imu"], *anchor, buf["anc_Sigma"],
                 cfg, schedule)
    store_tracked(buf, f.feats, f.res)
    for k, v in vi_outputs(f.res, f.vires).items():
        buf[k].copy_(v)
    v = f.vires
    buf["packed"].copy_(torch.cat([v.n_inliers.reshape(1).to(torch.float32), f.R_cw.reshape(9),
                                   f.t_cw, v.v_w, v.bg, v.ba]))


class VIAnchorRegions(TrackingRegions):
    """What the VI frame program and the tracking program's "vi" kind
    (``track_program.TrackProgram``) share: the anchor (``anc_*``) and its
    covariance as static buffers, the outputs of the refinement (``vi_*``)
    and the tracking pose (``trk``), the anchor loaded on the device, and
    those outputs cloned after a run. ``anchors`` counts the runs by where
    their anchor came from ("device", "host") and those whose covariance
    was zeroed ("zero_prior")."""

    def __init__(self, cfg, device):
        super().__init__(cfg, device)
        self.anchors = collections.Counter()

    def _vi_buffers(self) -> dict:
        dev = self.device
        f32 = dict(dtype=torch.float32, device=dev)
        vi = dict(R_wb=(3, 3), p_wb=(3,), v_w=(3,), bg=(3,), ba=(3,), H=(15, 15),
                  Sigma=(15, 15), cost=())
        return dict(
            anc_R=torch.eye(3, **f32), anc_p=torch.zeros((3,), **f32),
            anc_v=torch.zeros((3,), **f32), anc_bg=torch.zeros((3,), **f32),
            anc_ba=torch.zeros((3,), **f32), anc_Sigma=torch.zeros((15, 15), **f32),
            trk=torch.zeros((12,), **f32),
            **{f"vi_{k}": torch.zeros(s, **f32) for k, s in vi.items()},
            vi_inlier=torch.zeros((self.cfg.config.total_cap,), dtype=torch.bool, device=dev),
            vi_n_inliers=torch.zeros((), dtype=torch.int32, device=dev),
        )

    def _load_anchor(self, anchor, Sigma, host) -> None:
        """``anchor`` = (R_wb, p_wb, v, bg, ba) on the device copied in, or
        with None the host's state ``host`` [21] (R_cw, t_cw, v, bg, ba, on
        the device) turned into the body state here; the covariance
        ``Sigma``, zeroed where None."""
        b = self.buf
        self.anchors["host" if anchor is None else "device"] += 1
        if anchor is None:
            calib = self.cfg.calib
            R_wb, p_wb = viba.body_from_cam(host[0:9].reshape(3, 3), host[9:12], calib.R_bc,
                                            calib.t_bc)
            anchor = (R_wb, p_wb, host[12:15], host[15:18], host[18:21])
        for k, x in zip(ANCHOR, anchor):
            b[k].copy_(x)
        if Sigma is None:
            b["anc_Sigma"].zero_()
            self.anchors["zero_prior"] += 1
        else:
            b["anc_Sigma"].copy_(Sigma)

    def _vi_result(self) -> tuple[tracking.TrackResult, viba.PoseInertialResult]:
        """The tracking result (its pose the tracking's, ``trk``) and the
        refinement, cloned from the buffers."""
        b = self.buf
        trk = b["trk"].clone()
        res = tracking.TrackResult(
            R=trk[0:9].reshape(3, 3), t=trk[9:12], feat_pt=b["feat_pt"].clone(),
            n_inliers=b["n_inl"].clone(), visible_mask=b["visible"].clone(),
            found_mask=b["found"].clone(),
        )
        vires = viba.PoseInertialResult(**{k: b[f"vi_{k}"].clone()
                                           for k in viba.PoseInertialResult._fields})
        return res, vires


class VIFrameProgram(VIAnchorRegions):
    """The VI frame of one system (see the module docstring); ``dispatch``
    runs one frame."""

    def _own_buffers(self) -> dict:
        cfg, dev = self.cfg, self.device
        f32 = dict(dtype=torch.float32, device=dev)
        return dict(
            img=self._image_buffer(), imu=torch.zeros((cfg.imu_cap_frame, 7), **f32),
            host_anc=torch.zeros((21,), **f32), packed=torch.zeros((PACKED_LEN,), **f32),
            **self._vi_buffers(),
        )

    def region(self, name):
        schedule = name[1]

        def run(buf):
            vi_frame_program(buf, self._blank, self.cfg, schedule)

        return run

    def dispatch(self, img, imu: np.ndarray, m, schedule: tuple, anchor=None, Sigma=None,
                 host=None, warm: tuple = ()) -> VIFrameOut:
        """Run frame ``img`` with its IMU block ``imu`` [imu_cap_frame, 7]
        (numpy) against map ``m`` under ``schedule``, from ``anchor`` =
        (R_wb, p_wb, v, bg, ba) on the device with covariance ``Sigma``
        (None: exact), or, with ``anchor`` None, from ``host`` [21] (numpy
        R_cw, t_cw, v, bg, ba). On the card the graphs of the schedules in
        ``warm`` are captured first where they are not yet. No host read."""
        load_image(self.buf["img"], img)
        upload(self.buf["imu"], imu)
        self._load_map(m)
        if anchor is None:
            upload(self.buf["host_anc"], np.asarray(host, np.float32))
        self._load_anchor(anchor, Sigma, self.buf["host_anc"])
        self._capture_schedules(warm)
        self._run(("frame", schedule))
        b = self.buf
        feats = orb.Features(**{f: b[f"f_{f}"].clone() for f in orb.Features._fields})
        res, vires = self._vi_result()
        return VIFrameOut(feats=feats, res=res, vires=vires, host=HostCopy(b["packed"]))
