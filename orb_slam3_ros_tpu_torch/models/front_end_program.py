"""The two-view front ends of the per-frame stereo, RGB-D and two-camera
systems — port of the JAX package's ``FisheyeStereoSlam._frame_program``
(``models/fisheye_stereo.py:105-124``: both extractions, the cross-camera
triangulation and the right view's pixels as one jit) and of the stereo and
RGB-D frames' jitted ``_extract`` / ``_match_stereo``
(``models/stereo_system.py:53-58``, ``:284-292``).

A front end does not depend on the tracking state: from a frame's images it
makes the left view's features and a ``StereoMatch`` (each feature's u_r
and depth, -1 where none) that tracking, initialization, relocalization and
the keyframes read:

* "rig" (``FisheyeStereoSlam``): both views extracted,
  ``twocam.triangulate_cross_camera``, the right view's pixels of each
  cross match, and the cross points' depths as a virtual u_r = u - bf / z
  (``virtual_match``);
* "stereo" (``StereoSlam``): both views extracted and
  ``stereo.match_stereo``;
* "rgbd" (``RgbdSlam``): the view extracted and its depth map sampled at
  the features (``depth_to_match``).

``FrontEndProgram`` runs one of them as one region of
``chunk_runner.GraphRegions``: on the card one replay of a CUDA graph a
frame, captured at the first frame (a failed capture raises; nothing falls
back to the eager path); off the card the same function runs eagerly on the
same buffers. The images (and the depth map) go into static float32
buffers, uploaded from pinned memory (``frame_program.load_image``); the
outputs stay on the card and are copied out there after each run, since the
next frame's run overwrites them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import orb, stereo, twocam
from .chunk_runner import GraphRegions
from .frame_program import load_image

KINDS = ("rig", "stereo", "rgbd")


class FrontEndConfig(NamedTuple):
    """The static settings of one system's front end."""

    kind: str  # one of ``KINDS``
    config: orb.ExtractorConfig
    height: int
    width: int
    cam_params: torch.Tensor  # on the program's device
    cam_model: str
    fx: float = 0.0  # stereo
    baseline: float = 0.0  # stereo
    bf: float = 0.0  # rig, RGB-D: the (virtual) fx * baseline
    max_depth: float = 0.0  # rig: the cross points' depth gate
    R_rl: torch.Tensor | None = None  # rig: X_r = R_rl X_l + t_rl
    t_rl: torch.Tensor | None = None


class FrontEnd(NamedTuple):
    """A frame's front end: the left view's features, each one's stereo
    correspondence, and on the rig the cross-camera triangulation with the
    right view's pixels of each match (None elsewhere)."""

    feats: orb.Features
    sm: stereo.StereoMatch
    cross: twocam.CrossCamTriangulation | None = None
    uv_right: torch.Tensor | None = None


def virtual_match(feats: orb.Features, cross: twocam.CrossCamTriangulation, bf: float,
                  max_depth: float) -> stereo.StereoMatch:
    """The cross points' depths as a ``StereoMatch`` with a virtual u_r =
    u - bf / z (the RGB-D mechanism, Frame.cc:984), for the points in front
    (z > 0.05) and under ``max_depth``."""
    z = cross.X_l[:, 2]
    cand = cross.ok & (z > 0.05) & (z < max_depth)
    u_r = torch.where(cand, feats.xy[:, 0] - bf / torch.clamp(z, min=1e-3), -1.0)
    return stereo.StereoMatch(u_right=u_r, depth=torch.where(cand, z, -1.0), valid=cand)


def depth_to_match(feats: orb.Features, dm: torch.Tensor, bf: float) -> stereo.StereoMatch:
    """Sample the depth map ``dm`` [H, W] at the features and derive the
    virtual right coordinate u_r = u - bf / d (Frame::ComputeStereoFromRGBD,
    Frame.cc:984), so that RGB-D observations feed the same (u, v, u_r)
    residuals as true stereo."""
    xi = torch.clamp(feats.xy[:, 0].to(torch.int32), 0, dm.shape[1] - 1).long()
    yi = torch.clamp(feats.xy[:, 1].to(torch.int32), 0, dm.shape[0] - 1).long()
    d = dm[yi, xi]
    valid = feats.valid & (d > 0.05)
    u_r = feats.xy[:, 0] - bf / torch.clamp(d, min=0.05)
    return stereo.StereoMatch(u_right=torch.where(valid, u_r, -1.0), depth=d, valid=valid)


def rig_views(fl: orb.Features, fr: orb.Features, cfg: FrontEndConfig) -> FrontEnd:
    """The rig's frame from both views' features: the cross-camera
    triangulation, the right view's pixels of each match and the virtual
    ``StereoMatch``."""
    cross = twocam.triangulate_cross_camera(fl, fr, cfg.R_rl, cfg.t_rl, cfg.cam_params,
                                            cfg.cam_params, cam_model=cfg.cam_model)
    return FrontEnd(feats=fl, sm=virtual_match(fl, cross, cfg.bf, cfg.max_depth), cross=cross,
                    uv_right=fr.xy[cross.right_feat.long()])


def rig_front_end(il: torch.Tensor, ir: torch.Tensor, cfg: FrontEndConfig) -> FrontEnd:
    """The two-camera rig's frame from its raw left and right views."""
    return rig_views(orb.extract(il, cfg.config), orb.extract(ir, cfg.config), cfg)


def stereo_front_end(il: torch.Tensor, ir: torch.Tensor, cfg: FrontEndConfig) -> FrontEnd:
    """A rectified pair's frame: both views extracted, ``stereo.match_stereo``."""
    fl = orb.extract(il, cfg.config)
    fr = orb.extract(ir, cfg.config)
    return FrontEnd(feats=fl, sm=stereo.match_stereo(fl, fr, il, ir, fx=cfg.fx,
                                                     baseline=cfg.baseline))


def rgbd_front_end(img: torch.Tensor, dm: torch.Tensor, cfg: FrontEndConfig) -> FrontEnd:
    """An RGB-D frame from its image and metric depth map."""
    feats = orb.extract(img, cfg.config)
    return FrontEnd(feats=feats, sm=depth_to_match(feats, dm, cfg.bf))


FRONT_ENDS = dict(rig=rig_front_end, stereo=stereo_front_end, rgbd=rgbd_front_end)


def _outputs(fe: FrontEnd) -> dict:
    """A front end's tensors by buffer name."""
    out = {f"f_{k}": v for k, v in fe.feats._asdict().items()}
    out.update({f"sm_{k}": v for k, v in fe.sm._asdict().items()})
    if fe.cross is not None:
        out.update({f"cross_{k}": v for k, v in fe.cross._asdict().items()}, uv_right=fe.uv_right)
    return out


def _front_end(d: dict) -> FrontEnd:
    """The ``FrontEnd`` of tensors named as ``_outputs`` names them."""
    cross = None
    if "uv_right" in d:
        cross = twocam.CrossCamTriangulation(
            **{k: d[f"cross_{k}"] for k in twocam.CrossCamTriangulation._fields})
    return FrontEnd(feats=orb.Features(**{k: d[f"f_{k}"] for k in orb.Features._fields}),
                    sm=stereo.StereoMatch(**{k: d[f"sm_{k}"] for k in stereo.StereoMatch._fields}),
                    cross=cross, uv_right=d.get("uv_right"))


class FrontEndProgram(GraphRegions):
    """One system's front end (see the module docstring): ``run`` does one
    frame. Its buffers: ``img`` and ``img2`` (the right view, or the depth
    map) [H, W] float32, then the outputs (``_outputs``' names). Its one
    region is ``"front"``."""

    REGION = "front"

    def __init__(self, cfg: FrontEndConfig, device):
        if cfg.kind not in KINDS:
            raise ValueError(f"unknown front end {cfg.kind!r}; expected one of {KINDS}")
        super().__init__(cfg, device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.buf = dict(img=torch.zeros((cfg.height, cfg.width), **f32),
                        img2=torch.zeros((cfg.height, cfg.width), **f32))
        # the outputs' shapes and dtypes from one eager run on the blank frame
        out = _outputs(FRONT_ENDS[cfg.kind](self.buf["img"], self.buf["img2"], cfg))
        self.buf.update({k: torch.zeros_like(v) for k, v in out.items()})

    def region(self, name):
        fn = FRONT_ENDS[self.cfg.kind]

        def run(buf):
            for k, v in _outputs(fn(buf["img"], buf["img2"], self.cfg)).items():
                buf[k].copy_(v)

        return run

    def run(self, img, img2) -> FrontEnd:
        """The front end of a frame: ``img`` the (left) view, ``img2`` the
        right view or the depth map (numpy or tensors). No host read.
        Returns copies of the outputs, on the program's device."""
        load_image(self.buf["img"], img)
        load_image(self.buf["img2"], img2)
        self._run(self.REGION)
        return _front_end({k: v.clone() for k, v in self.buf.items()
                           if k not in ("img", "img2")})
