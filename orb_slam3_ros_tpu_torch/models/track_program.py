"""The tracking program of the stereo, RGB-D and two-camera systems'
synchronous frames — port of the JAX package's ``tracking.track_against_map``
jit (``models/tracking.py:125-131``) followed by the jit its ``_track_post``
runs on the same features: ``_stereo_refine`` (``models/stereo_system.py:25``),
``_twocam_refine`` (``models/fisheye_stereo.py:37``) or, once the IMU is
initialized, the frame's preintegration and ``_vi_refine``
(``models/inertial_system.py:117``).

A frame's front end (``front_end_program``) has made its features and its
stereo correspondence; ``TrackProgram`` tracks them against the map and
refines the pose as one region of ``frame_program.TrackingRegions``: on the
card one replay of a CUDA graph per (kind, tracking schedule), each kind's
graphs captured at its first frame (a failed capture raises; nothing falls
back to the eager path); off the card the same function runs eagerly on the
same buffers. The kinds:

* "stereo" (``StereoSlam``, ``RgbdSlam``): ``_stereo_refine`` over (u, v,
  u_r) rows, u_r = the front end's right-image x where it matched, else -1;
* "rig" (``FisheyeStereoSlam``): ``_twocam_refine`` over the left rows and
  the cross-matched right rows through the fixed ``R_rl``, ``t_rl``;
* "vi" (``StereoInertialSlam``, ``RgbdInertialSlam``,
  ``FisheyeStereoInertialSlam`` once the IMU is initialized, on a frame
  with IMU samples): the IMU prediction from the host's state (where the
  system predicts: the stereo and rig frames, ``InertialSlam._predict_motion``
  on the device, as the JAX package keeps it), tracking from it, the frame's
  IMU block preintegrated at the anchor's bias and the 15-dof ``_vi_refine``.

Its inputs are static buffers:

* the front end's features (``f_*``) and, by kind, its u_r and match flags
  (``sm_*``) or the cross match's flags and right pixels, copied on the
  device;
* ``x`` [X_LEN] f32, one pinned upload: the host's prediction (R, t),
  ``n_kf`` (the ``track_window`` mask is made from it inside), and with an
  IMU the host's (R_cw, t_cw, v, bg, ba) and the frame's IMU block
  [imu_cap_frame, 7] (acc | gyro | dt, zero rows as padding);
* "vi": the anchor (``anc_*``: the previous frame's refined body state,
  copied on the device, or when the system has none the host's state from
  ``x`` turned into the body state there) and its covariance ``anc_Sigma``
  (zeroed when None);
* the map's point fields tracking and the refinements read, copied in only
  when one changed (``TrackingRegions._load_map``).

Its outputs are written into buffers; ``run`` clones the ``TrackResult``
(and the refinement's ``PoseInertialResult``) on the device, since a
keyframe inserted from this frame reads them after the next replay, and
sends the packed row (``packed``: refined inliers, R, t; "vi": inliers,
R_cw, t_cw, v, bg, ba, then the IMU prediction's R_cw, t_cw, v) to pinned
host memory behind a CUDA event (``HostCopy``): the system waits on it at
once, the frame's one synchronizing call.

``eager_track`` is the region's body, and on a dict of tensors the plain
function the program is held to.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import imu as imu_ops
from ..ops import orb, viba
from . import tracking
from .frame_program import HostCopy, program_map, upload
from .vi_frame_program import ANCHOR, VIAnchorRegions, vi_outputs

KINDS = ("stereo", "rig", "vi")
# ``x``: [0:12] the host's prediction (R, t), [12] n_kf, [13:34] the host's
# (R_cw, t_cw, v, bg, ba), [34:] the frame's IMU block, row by row.
X_HOST, X_IMU = 13, 34
PACKED_LEN = 13  # refined (n_inliers, R, t)
VI_PACKED_LEN = 37  # (n_inliers, R_cw, t_cw, v, bg, ba) and the prediction's (R_cw, t_cw, v)


class TrackConfig(NamedTuple):
    """The static settings of one system's tracking program."""

    config: orb.ExtractorConfig
    cam_params: torch.Tensor  # on the program's device
    width: int
    height: int
    track_window: int | None
    track_cap: int | None
    cam_model: str
    K: int  # the map's capacities
    N: int
    P: int
    visual: str  # the system's visual kind: "stereo" or "rig"
    bf: float = 0.0  # stereo: fx * baseline
    R_rl: torch.Tensor | None = None  # rig: X_r = R_rl X_l + t_rl
    t_rl: torch.Tensor | None = None
    calib: imu_ops.ImuCalib | None = None  # with an IMU ("vi")
    imu_cap_frame: int = 0


class TrackOut(NamedTuple):
    """One tracked frame: its ``TrackResult`` on the device (copies of the
    program's outputs; R, t and n_inliers the refined ones but under "vi",
    where the refinement is ``vires``) and the host copy of the packed row."""

    res: tracking.TrackResult
    vires: viba.PoseInertialResult | None
    host: HostCopy


def x_len(cfg: TrackConfig) -> int:
    return X_IMU + 7 * cfg.imu_cap_frame


def pack_x(cfg: TrackConfig, R_pred, t_pred, n_kf: int, host=None, imu=None) -> np.ndarray:
    """``x`` from numpy: the host's prediction, ``n_kf``, and with an IMU
    ``host`` [21] (R_cw, t_cw, v, bg, ba) and ``imu`` [imu_cap_frame, 7]."""
    x = np.zeros((x_len(cfg),), np.float32)
    x[0:9], x[9:12], x[12] = np.asarray(R_pred).reshape(-1), np.asarray(t_pred).reshape(-1), n_kf
    if host is not None:
        x[X_HOST:X_IMU] = host
        x[X_IMU:] = np.asarray(imu).reshape(-1)
    return x


def imu_prediction(x: torch.Tensor, cfg: TrackConfig):
    """The IMU prediction of the frame from the host's state in ``x``
    (``InertialSlam._predict_motion``: preintegration at the host's bias,
    PredictStateIMU, the camera pose; then the motion model's velocity
    applied to the host pose, as the JAX package computes the prediction).
    Returns (R_pred, t_pred, the predicted (R_cw, t_cw), v)."""
    calib, h = cfg.calib, x[X_HOST:X_IMU]
    R_cur, t_cur = h[0:9].reshape(3, 3), h[9:12]
    R_wb, p_wb = viba.body_from_cam(R_cur, t_cur, calib.R_bc, calib.t_bc)
    b = h[15:21]
    imu = x[X_IMU:].reshape(-1, 7)
    pre = imu_ops.preintegrate(imu[:, 0:3], imu[:, 3:6], imu[:, 6], b, calib)
    R2, p2, v2 = imu_ops.predict_state(R_wb, p_wb, h[12:15], b, pre)
    R_cw, t_cw = viba.cam_from_body(R2, p2, calib.R_bc, calib.t_bc)
    vel_R = R_cw @ R_cur.T
    vel_t = t_cw - vel_R @ t_cur
    return vel_R @ R_cur, vel_R @ t_cur + vel_t, (R_cw, t_cw), v2


def eager_track(d: dict, m, cfg: TrackConfig, kind: str, schedule: tuple,
                predict: bool = False) -> dict:
    """The frame's tracking and refinement from inputs ``d`` (tensors by
    the buffers' names) against map ``m``: the program's region on its
    buffers, and run eagerly on a dict of copies the plain function it is
    held to. Returns the outputs by buffer name."""
    from . import fisheye_stereo, inertial_system, stereo_system

    x = d["x"]
    feats = orb.Features(**{f: d[f"f_{f}"] for f in orb.Features._fields})
    R_pred, t_pred = x[0:9].reshape(3, 3), x[9:12]
    if kind == "vi" and predict:
        R_pred, t_pred, pred_pose, v0 = imu_prediction(x, cfg)
    pt_mask = None
    if cfg.track_window is not None:
        pt_mask = m.pt_first_kf >= (x[12].to(torch.int32) - cfg.track_window)
    res = tracking.track_against_map(
        m, feats, R_pred, t_pred, cfg.cam_params, cfg.width, cfg.height, pt_mask=pt_mask,
        schedule=schedule, track_cap=cfg.track_cap, cam_model=cfg.cam_model,
    )
    out = dict(feat_pt=res.feat_pt, n_inl=res.n_inliers, visible=res.visible_mask,
               found=res.found_mask)
    if kind == "stereo":
        ur = torch.where(d["sm_valid"], d["sm_u_right"], -1.0)
        r2 = stereo_system._stereo_refine(m, feats, res.feat_pt, ur, res.R, res.t,
                                          cfg.cam_params, cfg.bf)
    elif kind == "rig":
        r2 = fisheye_stereo._twocam_refine(m, feats, res.feat_pt, d["cross_ok"], d["uv_right"],
                                           res.R, res.t, cfg.R_rl, cfg.t_rl, cfg.cam_params,
                                           cfg.cam_model)
    if kind != "vi":
        out["packed"] = torch.cat([r2.n_inliers.reshape(1).to(torch.float32), r2.R.reshape(9),
                                   r2.t])
        return out
    pred = torch.zeros((15,), dtype=x.dtype, device=x.device)
    if predict:
        pred = torch.cat([pred_pose[0].reshape(9), pred_pose[1], v0])
    else:
        v0 = x[X_HOST + 12 : X_HOST + 15]
    calib = cfg.calib
    R_anc, p_anc, v_anc, bg_anc, ba_anc = (d[k] for k in ANCHOR)
    imu = x[X_IMU:].reshape(-1, 7)
    pre = imu_ops.preintegrate(imu[:, 0:3], imu[:, 3:6], imu[:, 6], torch.cat([bg_anc, ba_anc]),
                               calib)
    vires, R_cw, t_cw = inertial_system._vi_refine(
        m, feats, res.feat_pt, res.R, res.t, v0, bg_anc, ba_anc, R_anc, p_anc, v_anc, bg_anc,
        ba_anc, pre, d["anc_Sigma"], cfg.cam_params, calib.R_bc, calib.t_bc, cfg.cam_model,
    )
    out.update(vi_outputs(res, vires))
    out["packed"] = torch.cat([
        vires.n_inliers.reshape(1).to(torch.float32), R_cw.reshape(9), t_cw, vires.v_w, vires.bg,
        vires.ba, pred,
    ])
    return out


class TrackProgram(VIAnchorRegions):
    """The tracking and refinement of one system's frames (see the module
    docstring); ``run`` tracks one frame. Regions are ``("track", kind,
    schedule, predict)``; ``anchors`` counts the "vi" runs' anchors."""

    def _own_buffers(self) -> dict:
        cfg, dev = self.cfg, self.device
        f32 = dict(dtype=torch.float32, device=dev)
        N = cfg.config.total_cap
        out = dict(x=torch.zeros((x_len(cfg),), **f32))
        if cfg.visual == "stereo":
            out.update(sm_u_right=torch.zeros((N,), **f32),
                       sm_valid=torch.zeros((N,), dtype=torch.bool, device=dev))
        else:
            out.update(cross_ok=torch.zeros((N,), dtype=torch.bool, device=dev),
                       uv_right=torch.zeros((N, 2), **f32))
        if cfg.calib is None:
            return dict(out, packed=torch.zeros((PACKED_LEN,), **f32))
        return dict(out, packed=torch.zeros((VI_PACKED_LEN,), **f32), **self._vi_buffers())

    def region(self, name):
        _, kind, schedule, predict = name

        def run(buf):
            out = eager_track(buf, program_map(buf, self._blank), self.cfg, kind, schedule, predict)
            packed = out.pop("packed")
            buf["packed"][: packed.shape[0]].copy_(packed)
            for k, v in out.items():
                buf[k].copy_(v)

        return run

    def run(self, kind: str, m, fe, x: np.ndarray, schedule: tuple, warm: tuple = (),
            anchor=None, Sigma=None, predict: bool = False) -> TrackOut:
        """Track the front end ``fe`` (``front_end_program.FrontEnd``)
        against map ``m`` under ``schedule``: ``x`` from ``pack_x``; "vi":
        from ``anchor`` with covariance ``Sigma``, or with ``anchor`` None
        from the host's state in ``x`` (``VIAnchorRegions._load_anchor``),
        with ``predict`` from the IMU prediction. On the card the graphs of
        the kind's schedules in ``warm`` are captured first where they are
        not yet. No host read."""
        if kind not in KINDS:
            raise ValueError(f"unknown tracking kind {kind!r}; expected one of {KINDS}")
        b = self.buf
        for f in orb.Features._fields:
            b[f"f_{f}"].copy_(getattr(fe.feats, f))
        if kind == "stereo":
            b["sm_u_right"].copy_(fe.sm.u_right)
            b["sm_valid"].copy_(fe.sm.valid)
        elif kind == "rig":
            b["cross_ok"].copy_(fe.cross.ok)
            b["uv_right"].copy_(fe.uv_right)
        upload(b["x"], x)
        self._load_map(m)
        if kind == "vi":
            self._load_anchor(anchor, Sigma, b["x"][X_HOST:X_IMU])
        if self.graphs:
            for s in dict.fromkeys(warm):
                name = ("track", kind, s, predict)
                if name not in self._graph:
                    self._graph[name] = self._capture(self.region(name))
        self._run(("track", kind, schedule, predict))
        return self._result(kind)

    def _result(self, kind: str) -> TrackOut:
        b = self.buf
        n = VI_PACKED_LEN if kind == "vi" else PACKED_LEN
        packed = b["packed"].clone()
        if kind == "vi":
            res, vires = self._vi_result()
            return TrackOut(res=res, vires=vires, host=HostCopy(packed[:n]))
        res = tracking.TrackResult(
            R=packed[1:10].reshape(3, 3), t=packed[10:13], feat_pt=b["feat_pt"].clone(),
            n_inliers=packed[0].to(torch.int32), visible_mask=b["visible"].clone(),
            found_mask=b["found"].clone(),
        )
        return TrackOut(res=res, vires=None, host=HostCopy(packed[:n]))
