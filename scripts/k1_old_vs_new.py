"""Paired timing of the projection matcher kernel (K1) on one CUDA card:
the package's kernel against an earlier source of it and against any other
source with its interface, in turns within one process.

    python3 scripts/k1_old_vs_new.py [--old OLD.cu] [--also NAME=SRC.cu] [--out DIR]

``--old``: a source with the three-launch interface the package had before
the single-launch redesign (``git show 57fb202:orb_slam3_ros_tpu_torch/csrc/
project_match.cu > OLD.cu``); without it only the current kernel and the
``--also`` / ``--ablate`` sources are timed. ``--also``: a copy of the
package's source with something changed (a constant, a design point), held
to the plain version like the kernel itself. ``--ablate``: a copy with a
part cut out, timed but not checked: the difference to the full kernel is
what the part costs.

Every contestant whose output is meant to be right is first held against
``project_match_reference`` (twice in a row, so a workspace left dirty
shows). Device time: CUDA events around 100 searches on preallocated
buffers, queued behind a spin kernel so that the host's enqueue rate does
not show, over 100. Wrapper time: the median over 100 calls of CUDA events
around one call with its Python wrapper, and the host's enqueue time of a
call without a sync (the three timers are ``chip_smoke.py``'s). Prints the
card's name and power limit, a table, and writes ``k1_old_vs_new.json``
under ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import cuda_ms, device_us, host_us  # noqa: E402
from orb_slam3_ros_tpu_torch.ops import project_match as pm  # noqa: E402
from orb_slam3_ros_tpu_torch.utils import kernel_build  # noqa: E402
from orb_slam3_ros_tpu_torch.utils.synth import make_search_case  # noqa: E402

W, H, N_FEAT = 752, 480, 1032
CASES = {
    # name: (P, radius_px, search settings)
    "track_r60": (768, 60.0, dict(level_slack=1, max_dist=100, ratio=0.9)),
    "track_r4": (768, 4.0, dict(level_slack=1, max_dist=100, ratio=0.9)),
    "fuse_r3": (4096, 3.0, dict(level_slack=1, max_dist=35, ratio=1.0)),
}
COL_INIT = 999 << 20
PTR, INT, FLT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def nvcc_build(src: Path, out: Path) -> ctypes.CDLL:
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [kernel_build.find_nvcc(), *kernel_build.NVCC_FLAGS, "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            print(f"  {src.name}: {line.strip()}")
    return ctypes.CDLL(str(out))


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def old_wrapper(lib, tensors, P, N, kw):
    """The wrapper the three-launch kernel had: per-tensor checks, a fresh
    workspace and output each call."""
    dev = tensors[0].device
    for t, (name, dtype, tail, per_row) in zip(tensors, pm._SPEC):
        if (t.device != dev or t.dtype != dtype or not t.is_contiguous()
                or tuple(t.shape) != ((P if per_row else N), *tail)):
            raise ValueError(f"{name} is not what the kernel takes")
    for i in (3, 8):
        if tensors[i].data_ptr() % 4:
            raise ValueError("sign rows must be 4-byte aligned")
    ws = torch.empty((3 * P + N,), dtype=torch.int32, device=dev)
    out = torch.empty((2, P), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.project_match(
            *(t.data_ptr() for t in tensors), P, N, kw["level_slack"], kw["max_dist"],
            kw["ratio"], ws.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), stream)
    if err:
        raise RuntimeError(f"cudaError {err}")
    return out[0], out[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, default=None)
    ap.add_argument("--also", action="append", default=[], metavar="NAME=SRC.cu",
                    help="a further source with the package's interface, timed alongside")
    ap.add_argument("--ablate", action="append", default=[], metavar="NAME=SRC.cu",
                    help="like --also, but timed only, not checked: a source with a part "
                    "cut out to see what that part costs")
    ap.add_argument("--out", type=Path, default=None, help="directory for k1_old_vs_new.json")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    print(card)
    stream = torch.cuda.current_stream().cuda_stream
    build_dir = kernel_build.BUILD_ROOT / "k1_old_vs_new"

    new = pm.build()
    for log in sorted(kernel_build.BUILD_ROOT.glob("project_match-*/build.log")):
        for line in log.read_text().splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in line):
                print(f"  project_match.cu: {line.strip()}")
    sig = [PTR] * 9 + [INT] * 4 + [FLT] + [PTR] * 4
    old = None
    if args.old is not None:
        old = nvcc_build(args.old, build_dir / "libold.so")
        old.project_match.argtypes, old.project_match.restype = sig, INT
    also = {}
    unchecked = {spec.split("=", 1)[0] for spec in args.ablate}
    for spec in args.also + args.ablate:
        name, src = spec.split("=", 1)
        lib = nvcc_build(Path(src), build_dir / f"lib{name}.so")
        lib.project_match.argtypes, lib.project_match.restype = sig, INT
        lib.project_match_workspace_ints.argtypes = [INT, INT]
        also[name] = lib
    result = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda, "cases": {}}
    empty = [device_us(lambda: new.project_match_empty_launch(stream)) for _ in range(3)]
    result["empty_launch_device_us"] = empty
    print(f"empty launch, device time back to back: {empty} us")

    for case, (P, radius_px, kw) in CASES.items():
        d = make_search_case(2, P, N_FEAT, W=W, H=H)
        radius = (radius_px * 1.2 ** d["proj_level"].astype(np.float32)).astype(np.float32)
        arrays = (d["proj_uv"], d["proj_valid"], d["proj_level"], d["proj_sign"], radius,
                  d["feat_xy"], d["feat_level"], d["feat_valid"], d["feat_sign"])
        tensors = [torch.from_numpy(a).to(dev) for a in arrays]
        ptrs = [t.data_ptr() for t in tensors]
        ref = pm.project_match_reference(*tensors, **kw)
        scalars = (P, N_FEAT, kw["level_slack"], kw["max_dist"], kw["ratio"])
        contestants = {}  # name -> (launch, checked, output and workspace kept alive)

        def add(name, fn, ws, checked):
            out = torch.empty((2, P), dtype=torch.int32, device=dev)
            tail = (ws.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), stream)
            contestants[name] = (lambda: fn(*ptrs, *scalars, *tail), checked, out, ws)

        if old is not None:
            add("old", old.project_match,
                torch.empty((3 * P + N_FEAT,), dtype=torch.int32, device=dev), True)
        for name, lib in {"new": new, **also}.items():
            ws = torch.full((lib.project_match_workspace_ints(P, N_FEAT),), COL_INIT,
                            dtype=torch.int32, device=dev)
            ws[:4] = 0
            if hasattr(lib, "project_match_init_workspace"):
                lib.project_match_init_workspace.argtypes = [PTR, INT, INT, PTR]
                lib.project_match_init_workspace(ws.data_ptr(), P, N_FEAT, stream)
            add(name, lib.project_match, ws, name not in unchecked)

        for name, (launch, checked, out, _) in contestants.items():
            if not checked:
                continue
            for rep in range(2):
                out.fill_(-7)
                err = launch()
                torch.cuda.synchronize()
                if err or not (torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])):
                    raise RuntimeError(f"{case}: {name} disagrees with the plain version "
                                       f"(call {rep}, cudaError {err})")
        print(f"{case}: P={P} N={N_FEAT} radius {radius_px}, {int((ref[0] >= 0).sum())} matches; "
              f"all {sum(c[1] for c in contestants.values())} checked contestants exact")

        order = list(contestants)
        order = order + order[::-1]  # old, new, others ..., others, new, old
        times = {name: [] for name in contestants}
        for _ in range(args.rounds):
            for name in order:
                times[name].append(device_us(contestants[name][0]))
        wrappers = {}
        new_call = lambda: pm.project_match(*tensors, **kw)  # noqa: E731
        plain_call = lambda: pm.project_match_reference(*tensors, **kw)  # noqa: E731
        turns = [("new", new_call)]
        if old is not None:
            old_call = lambda: old_wrapper(old, tensors, P, N_FEAT, kw)  # noqa: E731
            turns = [("old", old_call), ("new", new_call), ("new", new_call), ("old", old_call)]
        for name, fn in turns + [("plain", plain_call)]:
            w = wrappers.setdefault(name, {"call_us": [], "host_us": []})
            w["call_us"].append(cuda_ms(fn, 100) * 1e3)
            w["host_us"].append(host_us(fn))
        for i, o in zip(pm.project_match(*tensors, **kw), ref):
            assert torch.equal(i, o)
        result["cases"][case] = {
            "P": P, "N": N_FEAT, "radius_px": radius_px, **kw,
            "device_us": times, "wrapper": wrappers,
        }
        for name in contestants:
            t = times[name]
            print(f"  {name:28s} device us: median {np.median(t):8.2f}  min {min(t):8.2f}  all "
                  + " ".join(f"{x:.2f}" for x in t))
        for name, w in wrappers.items():
            print(f"  wrapper {name:6s} call us {['%.1f' % x for x in w['call_us']]} "
                  f"host enqueue us {['%.1f' % x for x in w['host_us']]}")

    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "k1_old_vs_new.json").write_text(json.dumps(result, indent=1))
    print(json.dumps({"ok": True, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
