"""Parent vs change on phases 7 and 20 of ``chip_smoke.py`` on one card, in
turns, each run a fresh process in its own tree; prints each run's phase 7
frames/s, latency and keyframe work ms, phase 20 frames/s and latency, and
(in a tree with the mono keyframe program) the seconds of each
``ProgramWatch.report``; writes ``chiprun_out/ab7.json``.

Three arms: "parent" (the tree in ``chip_scratch/parent``), "change" (this
tree) and "eager" (this tree with every keyframe on the eager
``keyframe_work``, phase 7 only: its checks that the program ran are kept
from stopping the run, so its frames are this tree's with the parent's
keyframe path). ``--order`` gives the turns (default ``P C E E C P``).

The parent tree goes in ``chip_scratch/parent`` (listed in .gitignore):

    mkdir -p chip_scratch/parent
    git archive PARENT orb_slam3_ros_tpu_torch chip_smoke.py | tar -x -C chip_scratch/parent
    python3 scripts/phase7_ab.py  # from the repo root, on a machine with a CUDA card
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.abspath(".")
ONE = r'''
import json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from orb_slam3_ros_tpu_torch.ops import project_match
project_match.build()
eager = sys.argv[1] == "eager"
rep = {}
if hasattr(cs.ProgramWatch, "_kf_compare"):
    orig = cs.ProgramWatch.report
    def timed(self, *a, **k):
        t = time.perf_counter()
        if eager:  # no keyframe ran the program: stand-ins for what phase 7 reads
            out = dict(fusing_keyframes=0, mkf_call_ms=[float("nan")],
                       warmup_launches=dict.fromkeys(project_match.LAUNCHES, 0))
        else:
            out = orig(self, *a, **k)
        rep.setdefault("report_s", []).append(time.perf_counter() - t)
        return out
    cs.ProgramWatch.report = timed
if eager:
    from orb_slam3_ros_tpu_torch.models import system
    system.MonoSlam._fused_keyframe = lambda self, kf_id: False
    failed = []
    cs.check = lambda cond, msg: cond or failed.append(msg[:120])
t0 = time.perf_counter()
mp, seq = cs.phase_mapping(torch, project_match)
t7 = time.perf_counter() - t0
out = dict(t7=t7, fps7=mp["frames_per_s"], lat7=[mp["frame_ms_p50"], mp["frame_ms_p80"]],
           kf7=[mp["kf_work_ms_p50"], mp["kf_work_ms_max"]], ate7=mp["ate_sim3_m"], **rep)
if eager:
    out["checks_not_held"] = failed
else:
    t0 = time.perf_counter()
    pp = cs.phase_pipelined(torch, project_match, mp, {"frames_per_s": float("nan")}, seq, "x")
    out.update(t20=time.perf_counter() - t0, fps20=pp["frames_per_s"],
               lat20=[pp["call_ms_p50"], pp["call_ms_p80"]], report_s=rep.get("report_s"))
print("AB " + json.dumps(out))
'''
ARMS = {"P": "parent", "C": "change", "E": "eager"}

ap = argparse.ArgumentParser()
ap.add_argument("--order", default="PCEECP", help="the turns: P parent, C change, E eager")
args = ap.parse_args()
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
print(card)
out = []
for arm in (ARMS[c] for c in args.order):
    cwd = os.path.join(ROOT, "chip_scratch", "parent") if arm == "parent" else ROOT
    r = subprocess.run([sys.executable, "-c", ONE, arm], cwd=cwd, capture_output=True, text=True,
                       timeout=400)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("AB ")]
    if r.returncode or not line:
        print(arm, "FAILED", r.returncode, r.stdout[-3000:], r.stderr[-3000:])
        sys.exit(1)
    d = json.loads(line[0][3:])
    d["tree"] = arm
    print(json.dumps(d))
    out.append(d)
os.makedirs("chiprun_out", exist_ok=True)
json.dump(dict(card=card, runs=out), open("chiprun_out/ab7.json", "w"), indent=1)
