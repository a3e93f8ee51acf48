"""Map and session checkpoints — port of ``orb_slam3_ros_tpu.utils.checkpoint``
(the reference's ``System::SaveAtlas`` / ``LoadAtlas``, System.cc:1417-1533).

The file formats are the JAX package's, in layout and keys: ``save_map``
writes one compressed npz of the ``MapState`` fields plus a
``<path>.json`` manifest (magic string, md5 digest of the npz, counters,
shapes); ``save_atlas`` writes the whole session, the active map
(``active.<field>``, its IMU blocks ``active.imu_*``), every archived map of
the Atlas (``arch<i>.<field>``, ``arch<i>.sigs``, ``arch<i>.imu_*``), the
loop edges (``loop.*``) and the vocabulary (``vocab``), with the counters
and per-map entries in its manifest. A file saved by either package loads
in the other; a load onto a system of other capacities, or of a file whose
md5 does not match its manifest, raises.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np
import torch

from .. import resolve_device
from ..models import map_state
from ..models.map_state import MapState

MAGIC = "orb_slam3_ros_tpu-map-v1"
ATLAS_MAGIC = "orb_slam3_ros_tpu-atlas-v1"


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


def _read_manifest(path: str, magic: str, what: str) -> dict:
    """The manifest of checkpoint ``path``; raises on a wrong magic string
    or an md5 mismatch, as LoadAtlas compares the stored md5
    (System.cc:1471-1533)."""
    with open(path + ".json") as f:
        manifest = json.load(f)
    if manifest.get("magic") != magic:
        raise ValueError(f"not {what} checkpoint: {path}")
    with open(_npz_path(path), "rb") as f:
        digest = hashlib.md5(f.read()).hexdigest()
    if digest != manifest["md5"]:
        raise ValueError(f"checkpoint checksum mismatch: {digest} != {manifest['md5']}")
    return manifest


def load_map(path: str, device=None) -> tuple[MapState, dict]:
    """Load a checkpoint onto ``device`` (None: the CUDA device); raises on
    a wrong magic string or an md5 mismatch. Returns (map, counters)."""
    manifest = _read_manifest(path, MAGIC, "a map")
    with np.load(_npz_path(path)) as data:
        m = map_state.from_numpy(data, resolve_device(device))
    return m, manifest["counters"]


def _check_capacities(m: MapState, slam) -> None:
    if (m.K, m.P, m.N) != (slam.K_cap, slam.P_cap, slam.N):
        raise ValueError(
            f"checkpoint capacities (K={m.K}, P={m.P}, N={m.N}) do not match this system "
            f"(K={slam.K_cap}, P={slam.P_cap}, N={slam.N})"
        )


def _system_counters(slam) -> dict:
    c = {
        "n_kf": slam.n_kf,
        "n_pts": slam.n_pts,
        "frame_id": slam.frame_id,
        "state": slam.state,
        "R_cur": np.asarray(slam.R_cur).tolist(),
        "t_cur": np.asarray(slam.t_cur).tolist(),
    }
    if hasattr(slam, "kf_imu_acc"):
        c["imu"] = {
            "initialized": bool(slam.imu_initialized),
            "stage": int(slam.imu_stage),
            "chain_breaks": sorted(int(b) for b in slam.chain_breaks),
            "v_cur": np.asarray(slam.v_cur).tolist(),
            "bg_cur": np.asarray(slam.bg_cur).tolist(),
            "ba_cur": np.asarray(slam.ba_cur).tolist(),
        }
    return c


def save_atlas(path: str, slam) -> str:
    """Checkpoint the whole session: the active map, counters and IMU
    side-state, every archived map of the Atlas with its signatures and IMU
    blocks, the persistent loop edges and the vocabulary (a global BA in
    flight is folded in first). Returns the md5 of the npz."""
    slam.flush()
    arrays: dict[str, np.ndarray] = {}
    for f, a in map_state.to_numpy(slam.map).items():
        arrays[f"active.{f}"] = a
    if hasattr(slam, "kf_imu_acc"):
        arrays["active.imu_acc"] = np.asarray(slam.kf_imu_acc)
        arrays["active.imu_gyro"] = np.asarray(slam.kf_imu_gyro)
        arrays["active.imu_dts"] = np.asarray(slam.kf_imu_dts)
    manifest: dict = {"magic": ATLAS_MAGIC, "counters": _system_counters(slam), "archived": []}
    atlas = getattr(slam, "atlas", None)
    for i, am in enumerate(atlas.maps if atlas is not None else []):
        for f, a in map_state.to_numpy(am.m).items():
            arrays[f"arch{i}.{f}"] = a
        arrays[f"arch{i}.sigs"] = am.sigs.cpu().numpy()
        entry = {"n_kf": am.n_kf, "n_pts": am.n_pts, "imu": None}
        if am.imu is not None:
            arrays[f"arch{i}.imu_acc"] = np.asarray(am.imu["acc"])
            arrays[f"arch{i}.imu_gyro"] = np.asarray(am.imu["gyro"])
            arrays[f"arch{i}.imu_dts"] = np.asarray(am.imu["dts"])
            entry["imu"] = {
                "initialized": bool(am.imu["initialized"]),
                "stage": int(am.imu["stage"]),
                "chain_breaks": sorted(int(b) for b in am.imu["chain_breaks"]),
            }
        manifest["archived"].append(entry)
    lc = getattr(slam, "loop_closer", None)
    if lc is not None:
        arrays["loop.edge_i"] = lc._edge_i
        arrays["loop.edge_j"] = lc._edge_j
        arrays["loop.edge_R"] = lc._edge_R
        arrays["loop.edge_t"] = lc._edge_t
        arrays["loop.edge_s"] = lc._edge_s
        manifest["loop"] = {"n_edges": int(lc._n_edges), "last_closed_kf": int(lc.last_closed_kf)}
    vocab = getattr(slam, "vocab", None)
    if vocab is not None:
        arrays["vocab"] = vocab.cpu().numpy() if isinstance(vocab, torch.Tensor) else np.asarray(vocab)
    npz_path = _npz_path(path)
    np.savez_compressed(npz_path, **arrays)
    with open(npz_path, "rb") as f:
        manifest["md5"] = hashlib.md5(f.read()).hexdigest()
    with open(path + ".json", "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest["md5"]


def load_atlas(path: str, slam) -> None:
    """Restore a whole-session checkpoint into ``slam`` in place, onto its
    device (``System::LoadAtlas``). Its capacities must match the
    checkpoint's."""
    manifest = _read_manifest(path, ATLAS_MAGIC, "an atlas")
    dev = slam.device
    with np.load(_npz_path(path)) as npz:
        data = {k: npz[k] for k in npz.files}
    m = map_state.from_numpy({f: data[f"active.{f}"] for f in MapState._fields}, dev)
    _check_capacities(m, slam)
    c = manifest["counters"]
    slam.map = m
    slam._sync_replica()
    slam.n_kf = c["n_kf"]
    slam.n_pts = c["n_pts"]
    slam.frame_id = c["frame_id"]
    slam.state = c["state"]
    slam.R_cur = np.asarray(c["R_cur"], np.float32)
    slam.t_cur = np.asarray(c["t_cur"], np.float32)
    slam._ref_cache = None
    if "imu" in c and hasattr(slam, "kf_imu_acc"):
        slam.kf_imu_acc = data["active.imu_acc"].copy()
        slam.kf_imu_gyro = data["active.imu_gyro"].copy()
        slam.kf_imu_dts = data["active.imu_dts"].copy()
        slam.imu_initialized = c["imu"]["initialized"]
        slam.imu_stage = c["imu"]["stage"]
        slam.chain_breaks = set(c["imu"]["chain_breaks"])
        slam.v_cur = np.asarray(c["imu"]["v_cur"], np.float32)
        slam.bg_cur = np.asarray(c["imu"]["bg_cur"], np.float32)
        slam.ba_cur = np.asarray(c["imu"]["ba_cur"], np.float32)
        # the per-frame anchor and the chunk's inertial state are the host's now
        slam._vi_anchor = None
        slam._vi_prior = None
        slam._vi_dev_valid = False
    if "vocab" in data:
        slam.set_vocabulary(data["vocab"])
    atlas = getattr(slam, "atlas", None)
    if atlas is not None:
        from ..models.atlas import ArchivedMap

        atlas.maps = []
        for i, entry in enumerate(manifest["archived"]):
            am_m = map_state.from_numpy({f: data[f"arch{i}.{f}"] for f in MapState._fields}, dev)
            imu = None
            if entry["imu"] is not None:
                imu = dict(
                    acc=data[f"arch{i}.imu_acc"].copy(), gyro=data[f"arch{i}.imu_gyro"].copy(),
                    dts=data[f"arch{i}.imu_dts"].copy(), initialized=entry["imu"]["initialized"],
                    stage=entry["imu"]["stage"], chain_breaks=set(entry["imu"]["chain_breaks"]),
                )
            atlas.maps.append(ArchivedMap(
                m=am_m, n_kf=entry["n_kf"], n_pts=entry["n_pts"],
                sigs=torch.from_numpy(data[f"arch{i}.sigs"].copy()).to(dev), imu=imu,
            ))
    lc = getattr(slam, "loop_closer", None)
    if lc is not None and "loop" in manifest:
        lc._edge_i = data["loop.edge_i"].copy()
        lc._edge_j = data["loop.edge_j"].copy()
        lc._edge_R = data["loop.edge_R"].copy()
        lc._edge_t = data["loop.edge_t"].copy()
        lc._edge_s = data["loop.edge_s"].copy()
        # the edge store grows by doubling: adopt the checkpoint's capacity
        lc.max_loop_edges = int(lc._edge_i.shape[0])
        lc._n_edges = manifest["loop"]["n_edges"]
        lc.last_closed_kf = manifest["loop"]["last_closed_kf"]


def save_system(path: str, slam) -> str:
    """Checkpoint a running pipeline's map, counters and pose (``save_map``
    with the system's counters). Returns the md5."""
    counters = _system_counters(slam)
    counters.pop("imu", None)  # the map checkpoint holds no IMU side-state
    return save_map(path, slam.map, counters)


def load_system(path: str, slam) -> None:
    """Restore a pipeline saved by ``save_system`` in place, onto its
    device (the capacities must match)."""
    m, counters = load_map(path, device=slam.device)
    _check_capacities(m, slam)
    slam.map = m
    slam._sync_replica()
    slam.n_kf = counters["n_kf"]
    slam.n_pts = counters["n_pts"]
    slam.frame_id = counters["frame_id"]
    slam.state = counters["state"]
    slam.R_cur = np.asarray(counters["R_cur"], np.float32)
    slam.t_cur = np.asarray(counters["t_cur"], np.float32)
    slam._ref_cache = None
