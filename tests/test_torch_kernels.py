"""The projection matcher's wrapper and, on a CUDA card, its hand-written
kernel against the plain torch version. Imports no JAX: run the card tests
with ``python -m pytest --noconftest tests/test_torch_kernels.py -m cuda``
on a machine with a card."""

import pytest
import torch

from orb_slam3_ros_tpu_torch.ops import project_match as tpm
from orb_slam3_ros_tpu_torch.utils.synth import make_search_case
from torch_cases import T

torch.set_num_threads(1)


def require_cuda() -> torch.device:
    """Skip the calling test unless a CUDA card is present (decided at run
    time, never at collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _kernel_args(d, device, radius=60.0):
    r = radius * 1.2 ** T(d["proj_level"]).float()
    return (
        T(d["proj_uv"], device), T(d["proj_valid"], device), T(d["proj_level"], device),
        T(d["proj_sign"], device), r.to(device), T(d["feat_xy"], device),
        T(d["feat_level"], device), T(d["feat_valid"], device), T(d["feat_sign"], device),
    )


def _assert_exact(args, min_matches=0, **kw):
    ik, dk = tpm.project_match(*args, **kw)
    ir, dr = tpm.project_match_reference(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ik, ir) and torch.equal(dk, dr)
    assert (ir >= 0).sum() >= min_matches
    return ir


def test_wrapper_checks_inputs():
    # The kernel wrapper refuses what the kernel does not take, and never
    # falls back to the plain version for a tensor that is not on CUDA.
    d = make_search_case(0, P=16, N=24)
    args = list(_kernel_args(d, "cpu"))
    names = [spec[0] for spec in tpm._SPEC]
    cpu = torch.device("cpu")

    def with_(**changed):
        return [changed.get(n, a) for n, a in zip(names, args)]

    tpm._check(args, 16, 24, cpu)
    with pytest.raises(TypeError):
        tpm._check(with_(proj_level=args[2].long()), 16, 24, cpu)
    with pytest.raises(ValueError):
        tpm._check(with_(feat_sign=args[8][:, :128].contiguous()), 16, 24, cpu)
    with pytest.raises(ValueError):
        tpm._check(with_(proj_uv=torch.zeros(16, 4)[:, :2]), 16, 24, cpu)
    # Sign rows are read in 8-byte words from a 16-byte aligned base: a
    # contiguous view that starts 8 bytes into its storage is refused.
    shifted = torch.zeros(16 * 256 + 8, dtype=torch.int8)[8:].view(16, 256)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="16-byte"):
        tpm._check(with_(proj_sign=shifted), 16, 24, cpu)
    # A search without a landmark row would launch nothing: refused, so that
    # no launch is counted that never happened.
    with pytest.raises(ValueError, match="at least one"):
        tpm._check([a[:0] if spec[3] else a for a, spec in zip(args, tpm._SPEC)], 0, 24, cpu)
    with pytest.raises(ValueError):
        tpm.project_match_cuda(*args)
    # CPU tensors take the plain version through the public entry point.
    for a, b in zip(tpm.project_match(*args), tpm.project_match_reference(*args)):
        assert torch.equal(a, b)


class _FakeLib:
    """Stands in for the kernel library where only the workspace cache is
    under test: counts the fills, fails them on request."""

    def __init__(self):
        self.fills, self.fail = 0, False

    def project_match_workspace_ints(self, P, N):
        return 4 + N + 2 * P

    def project_match_init_workspace(self, ptr, P, N, stream):
        self.fills += 1
        return 1 if self.fail else 0


@pytest.mark.parametrize(
    "seed,P,N,valid",
    [(0, 96, 130, "some"), (1, 37, 64, "some"), (2, 48, 80, "none"), (3, 40, 72, "all")],
)
def test_cpu_search_on_valid_rows_equals_dense(seed, P, N, valid):
    # The CPU's search runs the plain version on the valid rows only: equal
    # to the dense plain call, ties across rows and columns included.
    d = make_search_case(seed, P=P, N=N, tie_columns=(N // 2,))
    if valid != "some":
        d["proj_valid"][:] = valid == "all"
    args = _kernel_args(d, torch.device("cpu"))
    assert {"some": 0 < int(args[1].sum()) < P, "none": not args[1].any(),
            "all": bool(args[1].all())}[valid]
    for kw in ({}, dict(level_slack=0, max_dist=35, ratio=1.0)):
        ic, dc = tpm.project_match(*args, **kw)
        ir, dr = tpm.project_match_reference(*args, **kw)
        assert torch.equal(ic, ir) and torch.equal(dc, dr)
        assert valid == "none" or (ir >= 0).sum() > 0


def test_workspace_cache_lifetime(monkeypatch):
    # One workspace a key, filled once; a failed fill is not kept; the cache
    # holds the newest _MAX_WORKSPACES; drop_workspaces() forgets them all.
    monkeypatch.setattr(tpm, "_WORKSPACES", {})
    lib, cpu = _FakeLib(), torch.device("cpu")
    first = tpm._workspace(lib, (None, 0, 16, 24), cpu)
    assert tpm._workspace(lib, (None, 0, 16, 24), cpu) == first and lib.fills == 1
    lib.fail = True
    with pytest.raises(RuntimeError, match="workspace init"):
        tpm._workspace(lib, (None, 7, 16, 24), cpu)
    assert list(tpm._WORKSPACES) == [(None, 0, 16, 24)]
    lib.fail = False
    for stream in range(1, tpm._MAX_WORKSPACES + 1):
        tpm._workspace(lib, (None, stream, 16, 24), cpu)
    assert len(tpm._WORKSPACES) == tpm._MAX_WORKSPACES
    assert (None, 0, 16, 24) not in tpm._WORKSPACES  # the oldest went
    fills = lib.fills
    tpm._workspace(lib, (None, 0, 16, 24), cpu)
    assert lib.fills == fills + 1  # and is built anew when asked for again
    tpm.drop_workspaces()
    assert not tpm._WORKSPACES


@pytest.mark.cuda
@pytest.mark.parametrize("seed,P,N", [(0, 768, 1032), (1, 768, 1032), (2, 37, 130)])
def test_kernel_matches_plain_on_card(seed, P, N):
    # The kernel is exact integer logic with the d2 test rounded like the
    # torch ops: equality, ties included.
    dev = require_cuda()
    d = make_search_case(seed, P=P, N=N)
    args = _kernel_args(d, dev)
    n0 = dict(tpm.LAUNCHES)
    ik, dk = tpm.project_match(*args)
    ir, dr = tpm.project_match_reference(*args)
    torch.cuda.synchronize()
    assert tpm.LAUNCHES == {**n0, "track": n0["track"] + 1}
    assert torch.equal(ik, ir) and torch.equal(dk, dr)
    assert (ir >= 0).sum() > 10


@pytest.mark.cuda
@pytest.mark.parametrize(
    "P,N,radius",
    [(771, 1000, 4.0), (1, 1032, 60.0), (13, 17, 60.0), (4099, 1031, 3.0), (770, 33, 60.0)],
)
def test_kernel_odd_shapes_and_split_ties_on_card(P, N, radius):
    # Rows that do not fill a block, columns that do not fill a split or a
    # 32-wide group, fewer columns than one group; ties planted across every
    # split boundary; at both search settings. Exact.
    dev = require_cuda()
    cols = tpm.build().project_match_split_cols(P, N)
    d = make_search_case(3, P=P, N=N, tie_columns=tuple(range(cols, N, cols)))
    args = _kernel_args(d, dev, radius)
    _assert_exact(args)
    _assert_exact(args, max_dist=35, ratio=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [60.0, 4.0])
def test_kernel_at_the_kitti_shape_on_card(radius):
    # The stereo chunk's tracking search: 768 rows x the 2040 feature slots
    # of 2000 features in a 1242x376 image, both radii of the lean schedule,
    # ties planted across every split boundary. Exact.
    dev = require_cuda()
    P, N = 768, 2040
    cols = tpm.build().project_match_split_cols(P, N)
    d = make_search_case(4, P=P, N=N, W=1242, H=376, tie_columns=tuple(range(cols, N, cols)))
    _assert_exact(_kernel_args(d, dev, radius), min_matches=50)


@pytest.mark.cuda
def test_kernel_all_rows_invalid_on_card():
    dev = require_cuda()
    d = make_search_case(4, P=768, N=1032)
    d["proj_valid"][:] = False
    ir = _assert_exact(_kernel_args(d, dev))
    assert (ir == -1).all()


@pytest.mark.cuda
def test_kernel_back_to_back_alternating_shapes_on_card():
    # Every call must leave its workspace as it found it: 768 rows, 4096,
    # 768 again, each twice, without a sync in between the launches.
    dev = require_cuda()
    cases = []
    for seed, P, radius, kw in (
        (5, 768, 60.0, {}), (6, 4096, 3.0, dict(max_dist=35, ratio=1.0)), (7, 768, 4.0, {}),
    ):
        args = _kernel_args(make_search_case(seed, P=P, N=1032), dev, radius)
        cases.append((args, kw, tpm.project_match_reference(*args, **kw)))
    outs = [tpm.project_match(*args, **kw) for _ in range(2) for args, kw, _ in cases]
    torch.cuda.synchronize()
    for (ik, dk), (_, _, (ir, dr)) in zip(outs, cases * 2):
        assert torch.equal(ik, ir) and torch.equal(dk, dr)
        assert (ir >= 0).sum() > 10


@pytest.mark.cuda
def test_kernel_second_stream_gets_its_own_workspace_on_card():
    dev = require_cuda()
    args = _kernel_args(make_search_case(8, P=768, N=1032), dev)
    ref = _assert_exact(args, min_matches=10)
    n_ws = len(tpm._WORKSPACES)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ik, _ = tpm.project_match(*args)
    side.synchronize()
    assert torch.equal(ik, ref)
    assert len(tpm._WORKSPACES) == n_ws + 1
    assert any(key[1] == side.cuda_stream for key in tpm._WORKSPACES)


@pytest.mark.cuda
def test_kernel_workspace_dropped_after_failed_launch_and_rebuilt_on_card(monkeypatch):
    # A launch that reports an error must not leave its workspace behind: the
    # next search builds a clean one. The failing library scribbles over the
    # workspace as an aborted kernel would, then reports cudaErrorInvalidValue.
    dev = require_cuda()
    args = _kernel_args(make_search_case(9, P=768, N=1032), dev)
    ref = _assert_exact(args, min_matches=10)
    stream = torch.cuda.current_stream().cuda_stream
    key = (dev.index if dev.index is not None else torch.cuda.current_device(), stream, 768, 1032)
    assert key in tpm._WORKSPACES
    real = tpm.build()

    class Failing:
        def __getattr__(self, name):
            return getattr(real, name)

        def project_match(self, *a):
            tpm._WORKSPACES[key].fill_(12345)
            return 1

    n0 = dict(tpm.LAUNCHES)
    monkeypatch.setattr(tpm, "_LIB", Failing())
    with pytest.raises(RuntimeError, match="launch failed"):
        tpm.project_match(*args)
    assert key not in tpm._WORKSPACES and tpm.LAUNCHES == n0
    monkeypatch.setattr(tpm, "_LIB", real)
    assert torch.equal(_assert_exact(args), ref)


@pytest.mark.cuda
def test_search_queues_one_kernel_on_card():
    # The library counts every launch it makes: a search on a warm
    # workspace queues one kernel, as does the empty launch.
    dev = require_cuda()
    args = _kernel_args(make_search_case(10, P=768, N=1032), dev)
    lib = tpm.build()
    tpm.project_match(*args)
    n0 = lib.project_match_launches_queued()
    tpm.project_match(*args)
    assert lib.project_match_launches_queued() == n0 + 1
    assert lib.project_match_empty_launch(torch.cuda.current_stream().cuda_stream) == 0
    assert lib.project_match_launches_queued() == n0 + 2
    torch.cuda.synchronize()
