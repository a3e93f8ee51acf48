"""The port's entry points ``python -m orb_slam3_ros_tpu_torch.run_synth`` and
``...evaluate`` and its ``utils/trajectory.py``, against the JAX package's:
the CLI on the CPU at a small size writes a TUM trajectory and a session
checkpoint that both packages load; both ``evaluate`` CLIs print the same
line on the same files; the trajectory writers write the same numbers
(to 1e-6, float32 quaternions from two libraries); the native-feed, stream
and verbose flags run.
"""

import json

import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu import evaluate as jeval
from orb_slam3_ros_tpu.models.system import MonoSlam as JaxSlam
from orb_slam3_ros_tpu.ops import lie as jlie
from orb_slam3_ros_tpu.utils import checkpoint as jck
from orb_slam3_ros_tpu.utils import trajectory as jtraj
from orb_slam3_ros_tpu_torch import evaluate as teval
from orb_slam3_ros_tpu_torch import run_synth
from orb_slam3_ros_tpu_torch.models.system import MonoSlam
from orb_slam3_ros_tpu_torch.utils import checkpoint as tck
from orb_slam3_ros_tpu_torch.utils import synth
from orb_slam3_ros_tpu_torch.utils import trajectory as ttraj

torch.set_num_threads(1)
ARGS = dict(frames=10, height=240, width=376, features=1200, chunk=5)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    traj, sess = str(d / "traj.txt"), str(d / "session")
    argv = ["--device", "cpu", "--save-traj", traj, "--save-map", sess, "--json"]
    for k, v in ARGS.items():
        argv += [f"--{k}", str(v)]
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run_synth.main(argv)
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    seq = synth.make_sequence(n_frames=ARGS["frames"], height=ARGS["height"], width=ARGS["width"],
                              dt=0.1, seed=3, device="cpu")
    gt = str(d / "gt.txt")
    Tw = np.tile(np.eye(4, dtype=np.float32), (ARGS["frames"], 1, 1))
    Tw[:, :3, :3], Tw[:, :3, 3] = seq.R_wc, seq.t_wc
    jtraj.save_tum(gt, list(zip(seq.timestamps.tolist(), Tw)))
    return dict(rc=rc, summary=summary, traj=traj, session=sess, gt=gt, cam=seq.cam_params)


def test_cli_tracks_and_writes_trajectory_and_session(cli_run):
    s = cli_run["summary"]
    assert set(s) == {"frames", "tracked", "state_ok", "n_keyframes", "n_points", "ate_rmse_m",
                      "ate_scale", "fps", "wall_s", "per_stage_ms", "loop_closures"}
    assert s["frames"] == ARGS["frames"] and s["state_ok"] and s["tracked"] >= 6 and s["n_keyframes"] >= 2
    assert cli_run["rc"] == (0 if s["ate_rmse_m"] < 0.2 else 1)
    ts, pos, q = ttraj.load_tum(cli_run["traj"])
    assert len(ts) == s["tracked"] and np.isfinite(pos).all()
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-6)


def test_cli_session_loads_in_both_packages(cli_run):
    kw = dict(height=ARGS["height"], width=ARGS["width"], cam_params=cli_run["cam"],
              n_features=ARGS["features"], max_keyframes=64, max_points=8192)
    t = MonoSlam(device="cpu", **kw)
    tck.load_atlas(cli_run["session"], t)
    j = JaxSlam(pipelined=False, **kw)
    jck.load_atlas(cli_run["session"], j)
    assert t.n_kf == j.n_kf == cli_run["summary"]["n_keyframes"]
    np.testing.assert_array_equal(t.map.pt_X.numpy(), np.asarray(j.map.pt_X))


@pytest.mark.parametrize("extra", [[], ["--no-scale"], ["--max-dt", "0.001"]])
def test_evaluate_prints_what_the_jax_cli_prints(cli_run, capsys, extra):
    argv = [cli_run["traj"], cli_run["gt"], *extra]
    assert jeval.main(argv) == 0
    want = capsys.readouterr().out
    assert teval.main(argv) == 0
    got = capsys.readouterr().out
    assert got == want and json.loads(got)["pairs"] >= 3


@pytest.mark.parametrize("fmt", ["tum", "euroc", "kitti"])
def test_trajectory_writers_match_jax(tmp_path, fmt):
    rng = np.random.default_rng(2)
    traj = []
    for i in range(25):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.asarray(jlie.so3_exp(rng.normal(size=3).astype(np.float32) * 2.0))
        T[:3, 3] = rng.normal(size=3)
        traj.append((0.1 * i + 1e-3, T))
    want, got = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    getattr(jtraj, f"save_{fmt}")(want, traj)
    getattr(ttraj, f"save_{fmt}")(got, traj)
    np.testing.assert_allclose(np.loadtxt(got), np.loadtxt(want), atol=1e-6, rtol=0)
    if fmt == "tum":
        for a, b in zip(ttraj.load_tum(got), jtraj.load_tum(want)):
            np.testing.assert_allclose(a, b, atol=1e-6)


@pytest.mark.parametrize("flag", [["--native-feed"], ["--stream", "x.jsonl"], ["--verbose", "1"]])
def test_unported_flags_raise(flag, tmp_path, monkeypatch, capsys):
    # Each flag runs and does what it says. (The name is kept from when the
    # port refused these flags; the native feed, the event stream and the
    # log level are ported: tests/test_torch_native.py, test_torch_events.py.)
    from orb_slam3_ros_tpu_torch.utils import obslog

    monkeypatch.chdir(tmp_path)
    level = obslog.get_level()
    try:
        rc = run_synth.main(["--device", "cpu", "--frames", "3", "--json", *flag])
    finally:
        obslog.set_level(level)
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc in (0, 1) and summary["frames"] == 3
    assert ("native_feed" in summary) == (flag[0] == "--native-feed")
    if flag[0] == "--stream":
        assert (tmp_path / "x.jsonl").exists()
