"""The keyframe's mapping work under the KB8 camera, the contract the JAX
package breaks (ROADMAP "Known faults"): ORB-SLAM3 triangulates, fuses and
bundle-adjusts a keyframe through its own camera model. The JAX package's
fused keyframe program (``kf_work.py::keyframe_work_impl``) takes no camera
model, so its per-frame path maps raw KB8 frames through the pinhole model.

Two raw KB8 frames of the room 1.5 s apart on the orbit, at their true
poses (240x376, the repo's test KB8): keyframe 0 holds the first frame's
features, ``keyframe_work`` inserts the second as keyframe 1 and
triangulates against it (no BA iteration). The new points' depths in
camera 0 against the rendered depth: under ``cam_model="kb8"`` median
relative error <= 6% and >= 60% of points within 10% (measured 4.7% and
67%: two-view triangulation of noisy matches); through the pinhole model
with the KB8 vector read as radial-tangential coefficients, as the JAX
package's per-frame path does (its index 8 clamps to 7), median > 10% and
more than twice the KB8 median (measured 14.7%, 35% within 10%).
"""

import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu_torch.models import kf_work, map_state, map_updates
from orb_slam3_ros_tpu_torch.ops import cameras, orb
from orb_slam3_ros_tpu_torch.utils import synth

torch.set_num_threads(1)
KB8 = np.asarray([150.0, 150.0, 187.5, 119.5, 0.02, 0.001, -0.002, 0.0002], np.float32)
H, W, K, P, FAR = 240, 376, 8, 2048, 15


@pytest.fixture(scope="module")
def frames():
    scene = synth.make_room(seed=2, device="cpu")
    R_wc, t_wc, ts = synth.orbit_trajectory(FAR + 1, dt=0.1)
    out = []
    for i in (0, FAR):
        img, depth = synth.render(scene, R_wc[i], t_wc[i], KB8, height=H, width=W,
                                  cam_model="kb8")
        out.append((img, depth, R_wc[i].T, -R_wc[i].T @ t_wc[i], float(ts[i])))
    return out


def _triangulate(frames, cam_model):
    cfg = orb.default_config(H, W, n_features=800)
    # the JAX package reads params[8] of this 8-vector as params[7] (a
    # clamped index) when it projects it through the pinhole model
    cam = torch.as_tensor(KB8 if cam_model == "kb8" else np.concatenate([KB8, KB8[7:]]))
    (img0, _, R0, t0, ts0), (img1, _, R1, t1, ts1) = frames
    f0, f1 = orb.extract(img0, cfg), orb.extract(img1, cfg)
    m = map_state.empty_map(K, cfg.total_cap, P, device="cpu")
    m = map_updates.insert_keyframe(m, 0, torch.as_tensor(R0), torch.as_tensor(t0), ts0, f0,
                                    torch.full((cfg.total_cap,), -1, dtype=torch.int32))
    m, n_new, _ = kf_work.keyframe_work(
        m, 1, torch.as_tensor(R1), torch.as_tensor(t1), ts1, f1,
        torch.full((cfg.total_cap,), -1, dtype=torch.int32), 0, P, cam,
        w_free=2, w_fixed=1, n_iters=0, n_levels=cfg.n_levels, fuse_neighbors=0,
        do_fuse=False, do_stats=True, do_cull=False, width=W, height=H, cam_model=cam_model,
    )
    return m, int(n_new)


def _depth_error(frames, m, n_new):
    """Relative error of each new point's depth in camera 0 against the
    rendered depth at its KB8 projection there."""
    _, depth0, R0, t0, _ = frames[0]
    X = m.pt_X[:n_new]
    Xc = X @ torch.as_tensor(R0).T + torch.as_tensor(t0)
    uv = cameras.kb8_project(torch.as_tensor(KB8), Xc)
    ok = (Xc[:, 2] > 0.05) & cameras.in_image(uv, W, H)
    ui = torch.clamp(uv[:, 0].round().long(), 0, W - 1)
    vi = torch.clamp(uv[:, 1].round().long(), 0, H - 1)
    d = depth0[vi, ui]
    rel = (torch.abs(Xc[:, 2] - d) / d)[ok & (d > 0)]
    return rel.numpy()


@pytest.fixture(scope="module")
def errors(frames):
    out = {}
    for model in ("kb8", "pinhole"):
        m, n_new = _triangulate(frames, model)
        out[model] = (n_new, _depth_error(frames, m, n_new))
    return out


def test_kb8_keyframe_points_lie_on_the_rendered_depth(errors):
    n_new, rel = errors["kb8"]
    assert n_new >= 100 and len(rel) >= 0.9 * n_new
    assert np.median(rel) <= 0.06 and np.mean(rel < 0.10) >= 0.6, (np.median(rel), np.mean(rel < 0.1))


def test_the_pinhole_keyframe_work_on_kb8_frames_misplaces_them(errors):
    # what the JAX package's per-frame keyframe program does with KB8 frames
    n_new, rel = errors["pinhole"]
    kb8 = np.median(errors["kb8"][1])
    assert n_new > 0 and np.median(rel) > 0.10 and np.median(rel) > 2 * kb8, (np.median(rel), kb8)
