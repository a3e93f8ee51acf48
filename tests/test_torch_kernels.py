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


def test_wrapper_checks_inputs():
    # The kernel wrapper refuses what the kernel does not take, and never
    # falls back to the plain version for a tensor that is not on CUDA.
    d = make_search_case(0, P=16, N=24)
    args = list(_kernel_args(d, "cpu"))
    names = [n for n, _, _ in tpm._SPEC]
    tpm._check(dict(zip(names, args)), 16, 24, torch.device("cpu"))
    bad_dtype = dict(zip(names, args), proj_level=args[2].long())
    with pytest.raises(TypeError):
        tpm._check(bad_dtype, 16, 24, torch.device("cpu"))
    bad_shape = dict(zip(names, args), feat_sign=args[8][:, :128].contiguous())
    with pytest.raises(ValueError):
        tpm._check(bad_shape, 16, 24, torch.device("cpu"))
    strided = dict(zip(names, args), proj_uv=torch.zeros(16, 4)[:, :2])
    with pytest.raises(ValueError):
        tpm._check(strided, 16, 24, torch.device("cpu"))
    with pytest.raises(ValueError):
        tpm.project_match_cuda(*args)
    # CPU tensors take the plain version through the public entry point.
    for a, b in zip(tpm.project_match(*args), tpm.project_match_reference(*args)):
        assert torch.equal(a, b)


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
