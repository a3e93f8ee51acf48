"""ctypes binding of the native measurement sync — port of
``orb_slam3_ros_tpu.native``.

The sensor-ingestion layer (the reference's ROS callback queues and
SyncWithImu thread, src/ros_mono_inertial.cc:97-184) is C++ in
``native/measurement_sync.cpp``: a lock-free single-producer /
single-consumer ring per stream, a synchronizing bundle pop, and the
uint8 -> float32 grayscale conversion. The library is built from that file
at first use with ``g++ -O3 -std=c++17 -fPIC -shared`` into the package's
``_build/`` (``utils.kernel_build.build_host_library``, keyed by a hash of
the source and flags). It never loads a prebuilt library and never writes
into ``native/``; a failed build raises with the compiler's output.

A producer thread pushes frames and IMU samples; the SLAM thread pops
bundles (numpy on the host) and uploads the frame in ``process_frame``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from .utils.kernel_build import build_host_library

SOURCE = Path(__file__).resolve().parent.parent / "native" / "measurement_sync.cpp"
IMU_CAP_LOG2 = 12  # the IMU ring holds 4096 samples
MAX_IMU_PER_FRAME = 64  # samples a bundle carries; later ones go with the next frame
_lib = None


def load_library() -> ctypes.CDLL:
    """Build (once, keyed by the source's hash) and load the library, with
    its C signatures declared."""
    global _lib
    if _lib is not None:
        return _lib
    if not SOURCE.is_file():
        raise FileNotFoundError(f"the measurement sync's source is missing: {SOURCE}")
    lib, _ = build_host_library("measurement_sync", [SOURCE])
    c_f, c_d, c_i = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double), ctypes.c_int
    lib.msync_create.restype = ctypes.c_void_p
    lib.msync_create.argtypes = [c_i, c_i]
    lib.msync_destroy.argtypes = [ctypes.c_void_p]
    lib.msync_push_frame_u8.restype = c_i
    lib.msync_push_frame_u8.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.POINTER(ctypes.c_uint8), c_i, c_i, c_i,
    ]
    lib.msync_push_imu.restype = c_i
    lib.msync_push_imu.argtypes = [ctypes.c_void_p, ctypes.c_double, c_f, c_f]
    lib.msync_pop_bundle.restype = c_i
    lib.msync_pop_bundle.argtypes = [
        ctypes.c_void_p, ctypes.c_double, c_f, c_i, c_d, c_f, c_f, c_d, c_i,
        ctypes.POINTER(c_i),
    ]
    lib.msync_n_frames.restype = c_i
    lib.msync_n_frames.argtypes = [ctypes.c_void_p]
    lib.msync_n_imu.restype = c_i
    lib.msync_n_imu.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class MeasurementSync:
    """Lock-free frame + IMU synchronizer (producer thread -> SLAM loop):
    the JAX package's class, with the same methods and returns. The frame
    ring holds ``frame_capacity`` = 2**``frame_cap_log2`` frames."""

    def __init__(self, height: int, width: int, frame_cap_log2: int = 5):
        self._lib = load_library()
        self._h = self._lib.msync_create(frame_cap_log2, IMU_CAP_LOG2)
        self.height, self.width = height, width
        self.frame_capacity = 1 << frame_cap_log2
        self._gray = np.empty(height * width, np.float32)
        self._acc = np.empty((MAX_IMU_PER_FRAME, 3), np.float32)
        self._gyro = np.empty((MAX_IMU_PER_FRAME, 3), np.float32)
        self._imu_ts = np.empty(MAX_IMU_PER_FRAME, np.float64)

    def close(self) -> None:
        """Free the rings (also done when the object is collected)."""
        if getattr(self, "_h", None):
            self._lib.msync_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()

    # producer ---------------------------------------------------------
    def push_frame(self, ts: float, img: np.ndarray) -> bool:
        """Push a [H, W] gray or [H, W, C] colour frame (uint8; other types
        are clipped to [0, 255] and cast). False when the ring is full."""
        img = np.ascontiguousarray(img)
        if img.dtype != np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        ch = 1 if img.ndim == 2 else img.shape[2]
        r = self._lib.msync_push_frame_u8(
            self._h, ts, img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self.height, self.width, ch,
        )
        return r == 0

    def push_imu(self, ts: float, acc, gyro) -> bool:
        """Push one IMU sample. False when the ring is full."""
        a = np.ascontiguousarray(acc, np.float32)
        g = np.ascontiguousarray(gyro, np.float32)
        r = self._lib.msync_push_imu(
            self._h, ts, a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            g.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return r == 0

    # consumer ---------------------------------------------------------
    def pop_bundle(self):
        """The oldest frame with every IMU sample at or before its stamp:
        (ts, gray [H, W] f32, acc [M, 3], gyro [M, 3], imu_ts [M]), numpy
        copies; None when no bundle is ready. The IMU stream may not lag
        the frame stream (no latency slack)."""
        ts = ctypes.c_double()
        n_imu = ctypes.c_int()
        r = self._lib.msync_pop_bundle(
            self._h, 0.0,
            self._gray.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._gray.size, ctypes.byref(ts),
            self._acc.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._gyro.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._imu_ts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            MAX_IMU_PER_FRAME, ctypes.byref(n_imu),
        )
        if r != 1:
            return None
        m = n_imu.value
        return (
            ts.value,
            self._gray.reshape(self.height, self.width).copy(),
            self._acc[:m].copy(),
            self._gyro[:m].copy(),
            self._imu_ts[:m].copy(),
        )

    @property
    def n_frames(self) -> int:
        return self._lib.msync_n_frames(self._h)

    @property
    def n_imu(self) -> int:
        return self._lib.msync_n_imu(self._h)
