"""Shared helpers of the parity tests between the JAX package and its
PyTorch port (``tests/test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both packages as
numpy arrays; JAX runs on the CPU (tests/conftest.py), torch on the CPU
with one thread per test worker.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from orb_slam3_ros_tpu.models import kf_work as jkf
from orb_slam3_ros_tpu.models import map_state as jms
from orb_slam3_ros_tpu.models import map_updates as jmu
from orb_slam3_ros_tpu.models.system import MonoSlam as JaxSlam
from orb_slam3_ros_tpu.ops import stereo as jstereo
from orb_slam3_ros_tpu_torch.models import map_state as tms
from orb_slam3_ros_tpu_torch.ops import ba as tba
from orb_slam3_ros_tpu_torch.ops import imu as timu
from orb_slam3_ros_tpu_torch.ops import orb as torb
from orb_slam3_ros_tpu_torch.ops import twocam as ttwocam
from orb_slam3_ros_tpu_torch.ops import viba as tviba


def np_tree(x):
    """Numpy tree of a JAX NamedTuple (Features, MapState, VIBAProblem, ...):
    a dict by field name, nested NamedTuples as dicts of their own, None
    kept."""
    if x is None:
        return None
    if hasattr(x, "_fields"):
        return {k: np_tree(getattr(x, k)) for k in x._fields}
    return np.asarray(x)


def torch_features(jf) -> torb.Features:
    return torb.features_from_numpy(np_tree(jf), "cpu")


def torch_map(jm) -> tms.MapState:
    return tms.from_numpy(np_tree(jm), "cpu")


def torch_ba_problem(jp) -> tba.BAProblem:
    return tba.ba_problem_from_numpy(np_tree(jp), "cpu")


def torch_calib(jc) -> timu.ImuCalib:
    return timu.calib_from_numpy(np_tree(jc), "cpu")


def torch_preint(jp) -> timu.Preintegrated:
    return timu.preintegrated_from_numpy(np_tree(jp), "cpu")


def torch_vi_states(js) -> tviba.VIStates:
    return tviba.states_from_numpy(np_tree(js), "cpu")


def torch_vi_problem(jp) -> tviba.VIBAProblem:
    return tviba.problem_from_numpy(np_tree(jp), "cpu")


# The JAX package's keyframe work in its scatter formulation (row_n=None):
# the formulation the port carries, so a parity test compares like with like.
jax_keyframe_work = jax.jit(
    jkf.keyframe_work_impl,
    static_argnames=(
        "w_free", "w_fixed", "n_iters", "row_n", "n_levels",
        "fuse_neighbors", "do_fuse", "do_stats", "do_cull", "width", "height",
    ),
)


def jax_mapping_run(seq, n_frames: int, **slam_kw):
    """Run the JAX ``MonoSlam`` (``pipelined=False``) over the first
    ``n_frames`` frames with its keyframe work in the scatter formulation,
    recording each call. Its schedule warm-up is skipped (it only compiles
    programs ahead of time). Returns (slam, calls) with calls a list of
    (args, kwargs, (map_out, n_new)) in the JAX argument order."""
    slam = JaxSlam(cam_params=seq.cam_params, pipelined=False, **slam_kw)
    slam._warm_schedules = lambda: None
    calls = []
    original = jkf.keyframe_work

    def record(*args, **kw):
        kw = {**kw, "row_n": None}
        out = jax_keyframe_work(*args, **kw)
        calls.append((args, kw, out))
        return out

    jkf.keyframe_work = record
    try:
        for i in range(n_frames):
            slam.process_frame(seq.images[i], float(seq.timestamps[i]))
    finally:
        jkf.keyframe_work = original
    return slam, calls


def jax_seed_map(seq, kf_every, slam, max_depth: float = 8.0):
    """The JAX package's side of ``synth.seed_map_from_depth``: the same
    RGB-D point-creation calls in the same order, on a JAX ``MonoSlam``'s
    capacities, jitted extractor (``slam._extract``, as the JAX systems
    call it) and camera. ``seq`` is a JAX-package ``SynthSequence``.
    Returns (map, n_kf, n_pts)."""
    m = jms.empty_map(slam.K_cap, slam.N, slam.P_cap)
    n_kf = n_pts = 0
    h, w = seq.images.shape[1:]
    for i in range(0, len(seq.images), kf_every):
        if n_kf >= slam.K_cap:
            break
        feats = slam._extract(jnp.asarray(seq.images[i]))
        xi = jnp.clip(feats.xy[:, 0].astype(jnp.int32), 0, w - 1)
        yi = jnp.clip(feats.xy[:, 1].astype(jnp.int32), 0, h - 1)
        d = jnp.asarray(seq.depths[i])[yi, xi]
        cand = feats.valid & (d > 0.05) & (d < max_depth)
        R_cw = seq.R_wc[i].T
        t_cw = -R_cw @ seq.t_wc[i]
        m = jmu.insert_keyframe(
            m, jnp.asarray(n_kf), jnp.asarray(R_cw), jnp.asarray(t_cw),
            jnp.asarray(seq.timestamps[i], jnp.float32), feats,
            jnp.full((slam.N,), -1, jnp.int32),
        )
        X_c = jstereo.backproject(slam.cam_params, feats.xy, d)
        X_w = (X_c - jnp.asarray(t_cw)) @ jnp.asarray(R_cw)
        m, n_new = jmu.admit_depth_points(
            m, jnp.asarray(n_kf), X_w, cand, jnp.asarray(n_pts),
            jnp.asarray(slam.P_cap - n_pts),
        )
        n_pts += int(n_new)
        n_kf += 1
    m = jmu.refresh_point_stats(m, n_levels=slam.config.n_levels, dense=False)
    return m, n_kf, n_pts


def torch_cross(jc):
    """The port's ``CrossCamTriangulation`` from the JAX package's."""
    return ttwocam.CrossCamTriangulation(
        **{k: torch.from_numpy(np.array(v)) for k, v in np_tree(jc).items()}
    )
