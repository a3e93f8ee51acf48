"""PyTorch + CUDA port of the ``orb_slam3_ros_tpu`` SLAM engine.

The JAX package beside this one is the reference; every function here keeps
its counterpart's name, module and array layout so the two can be compared
on the same inputs (``tests/test_torch_*.py``). This package imports torch
and numpy only.

What is ported: ORB extraction (``ops/orb.py``), matching by projection
with the hand-written Hopper matcher kernel (``ops/project_match.py`` +
``csrc/project_match.cu``), motion-only pose optimization and
``models/tracking.py::track_against_map``; monocular SLAM from frame 0
(``models/system.py::MonoSlam``: two-view initialization, keyframes, fusion,
covisibility local BA, culling, slot recycling, localization against a
stored map); and monocular-inertial SLAM
(``models/inertial_system.py::InertialSlam``: IMU preintegration
``ops/imu.py``, the three-stage IMU initialization, the per-frame 15-dof
refinement and the temporal-window visual-inertial BA of ``ops/viba.py``);
the chunk loops of both as CUDA graphs (``models/chunk_runner.py``),
relocalization, loop closing with its asynchronous global BA
(``models/loop_closing.py``, ``ops/sim3solver.py``, ``ops/pgo.py``,
``ops/ba_pcg.py``), the Atlas of archived maps with its cross-map weld
(``models/atlas.py``), whole-session checkpoints in the JAX package's file
format (``utils/checkpoint.py``) and the ``run_synth`` / ``evaluate``
CLIs; stereo and RGB-D, alone and with an IMU
(``models/stereo_system.py``: ``StereoSlam``, ``RgbdSlam``,
``StereoInertialSlam``, ``RgbdInertialSlam``, with ``ops/stereo.py``'s
stereo matching and the stereo branch of both chunk loops); the fisheye
(KB8) camera, its two-camera rig and the rectified route
(``models/fisheye_stereo.py``, ``ops/rectify.py``, ``ops/twocam.py``); and
the system surface: settings files (``utils/config.py``), the event stream
and log (``utils/obslog.py``, every system's ``on_frame`` hook), the stage
timer, the C++ measurement sync (``native.py``), the control socket
(``utils/control.py``), the loop-closure problem dump and its offline
re-optimization (``utils/optdump.py``, ``reoptimize.py``), plane detection,
the AR overlay and map drawing (``ops/plane.py``, ``utils/ar.py``,
``utils/viz.py``); the scale-out solvers over ``torch.distributed``
(``parallel/``: the sharded BA, PCG BA, VI-BA and pose graph, the
multi-process runtime) and the two-device tracking / mapping split
(``MonoSlam(devices=...)``, ``models/replica.py``).

Entry points run on the CUDA device unless the caller passes ``device``:
``device=None`` resolves through :func:`default_device`, which raises where
there is no card and never falls back to the CPU by itself.
"""

__version__ = "0.1.0"

import torch as _torch

# Pose math is float32 3x3 / 6x6 linear algebra that breaks at TF32 (the
# counterpart of jax_default_matmul_precision="highest" in the JAX package).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
if _torch.backends.cuda.is_built():
    # torch picks MAGMA for some shapes (LU of batches of matrices wider
    # than 16), and MAGMA reads its status back to the host, which a
    # captured CUDA graph cannot hold; cuSOLVER / cuBLAS leave it on the
    # card. Pinned so that no shape switches a solver of the chunk to MAGMA.
    _torch.backends.cuda.preferred_linalg_library("cusolver")


def default_device() -> _torch.device:
    """The device an entry point uses when its caller names none: the CUDA
    device. Raises where there is none; the CPU is used only when a caller
    asks for it (``device="cpu"``)."""
    if not _torch.cuda.is_available():
        raise RuntimeError(
            "orb_slam3_ros_tpu_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is false; pass device=\"cpu\" to run on the CPU"
        )
    return _torch.device("cuda")


def resolve_device(device=None) -> _torch.device:
    """``device`` as a ``torch.device``; None means :func:`default_device`."""
    return default_device() if device is None else _torch.device(device)


def to_device(x, device):
    """``x`` on ``device``: a tensor, or tuples and NamedTuples of them,
    walked recursively; anything else (None, numbers) as it is."""
    if isinstance(x, _torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple):
        moved = [to_device(v, device) for v in x]
        return type(x)(*moved) if hasattr(x, "_fields") else tuple(moved)
    return x
