"""Map checkpoints: ``save_map`` / ``load_map`` of
``orb_slam3_ros_tpu.utils.checkpoint`` in numpy + torch.

The file format is the JAX package's, byte for byte in layout: one
compressed npz of the ``MapState`` fields plus a ``<path>.json`` manifest
with the same magic string, md5 digest, counters and shapes. A map saved by
either package loads in the other.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np

from .. import resolve_device
from ..models import map_state
from ..models.map_state import MapState

MAGIC = "orb_slam3_ros_tpu-map-v1"


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_map(path: str, m: MapState, counters: dict) -> str:
    """Write ``<path>`` (npz) + ``<path>.json`` manifest. Returns the md5."""
    arrays = map_state.to_numpy(m)
    np.savez_compressed(path, **arrays)
    with open(_npz_path(path), "rb") as f:
        digest = hashlib.md5(f.read()).hexdigest()
    manifest = {
        "magic": MAGIC,
        "md5": digest,
        "counters": counters,
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
    }
    with open(path + ".json", "w") as f:
        json.dump(manifest, f, indent=1)
    return digest


def load_map(path: str, device=None) -> tuple[MapState, dict]:
    """Load a checkpoint onto ``device`` (None: the CUDA device); raises on a wrong magic string or
    an md5 mismatch. Returns (map, counters)."""
    with open(path + ".json") as f:
        manifest = json.load(f)
    if manifest.get("magic") != MAGIC:
        raise ValueError(f"not a map checkpoint: {path}")
    with open(_npz_path(path), "rb") as f:
        digest = hashlib.md5(f.read()).hexdigest()
    if digest != manifest["md5"]:
        raise ValueError(f"checkpoint checksum mismatch: {digest} != {manifest['md5']}")
    with np.load(_npz_path(path)) as data:
        m = map_state.from_numpy(data, resolve_device(device))
    return m, manifest["counters"]
