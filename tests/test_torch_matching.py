"""Parity of the port's Hamming matcher and projection search with the JAX
package's default (dense XLA) path: exact, ties included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_ros_tpu.ops import hamming as jham
from orb_slam3_ros_tpu.ops import matching as jmatch
from orb_slam3_ros_tpu.ops import orb as jorb
from orb_slam3_ros_tpu_torch.ops import hamming as tham
from orb_slam3_ros_tpu_torch.ops import matching as tmatch
from orb_slam3_ros_tpu_torch.ops import orb as torb
from orb_slam3_ros_tpu_torch.ops import project_match as tpm
from orb_slam3_ros_tpu_torch.utils.synth import make_search_case
from torch_cases import T

torch.set_num_threads(1)


def _feats(d, lib):
    n = d["feat_xy"].shape[0]
    f = dict(
        xy=d["feat_xy"], level=d["feat_level"], angle=np.zeros(n, np.float32),
        response=np.zeros(n, np.float32), desc_packed=np.zeros((n, 8), np.uint32),
        desc_sign=d["feat_sign"], valid=d["feat_valid"],
    )
    if lib == "jax":
        return jorb.Features(**{k: jnp.asarray(v) for k, v in f.items()})
    return torb.features_from_numpy(f, "cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hamming_best2_mutual_exact(seed):
    rng = np.random.default_rng(seed)
    a = (1 - 2 * (rng.random((60, 256)) < 0.5)).astype(np.int8)
    b = np.concatenate([a[:20], (1 - 2 * (rng.random((70, 256)) < 0.5)).astype(np.int8)])
    b[5] = 0  # invalid row: distance 128
    dj = np.asarray(jham.hamming_matrix(a, b))
    dt = tham.hamming_matrix(T(a), T(b))
    assert dt.dtype == torch.int32
    np.testing.assert_array_equal(dt.numpy(), dj)
    mask = rng.random(dj.shape) < 0.6
    for fj, ft in zip(jham.masked_best2(dj, mask), tham.masked_best2(dt, T(mask))):
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    for md, ratio in ((jham.TH_LOW, 1.0), (jham.TH_HIGH, 0.9)):
        for fj, ft in zip(jham.mutual_nn(dj, mask, md, ratio), tham.mutual_nn(dt, T(mask), md, ratio)):
            np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))


@pytest.mark.parametrize(
    "seed,radius", [(0, 60.0), (1, 12.0), (2, 4.0), (3, 60.0), (4, 4.0), (5, 4.0)]
)
def test_search_by_projection_exact(seed, radius):
    d = make_search_case(seed, P=300, N=400)
    ij, dj = jmatch.search_by_projection(
        jnp.asarray(d["proj_uv"]), jnp.asarray(d["proj_valid"]),
        jnp.asarray(d["proj_level"]), jnp.asarray(d["proj_sign"]),
        _feats(d, "jax"), radius=radius, max_dist=jham.TH_HIGH, ratio=0.9,
    )
    it, dt = tmatch.search_by_projection(
        T(d["proj_uv"]), T(d["proj_valid"]), T(d["proj_level"]), T(d["proj_sign"]),
        _feats(d, "torch"), radius=radius, max_dist=tham.TH_HIGH, ratio=0.9,
    )
    assert it.dtype == torch.int32 and dt.dtype == torch.int32
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert (it.numpy() >= 0).sum() > 20  # the case is not vacuous


# Column boundaries of the 300 x 400 case for every split count below
# (range widths 416, 224, 160, 96, 64 and 32), plus columns inside a range.
_TIE_COLUMNS = (17, 32, 64, 96, 150, 160, 192, 224, 288, 320, 384, 399)
_SETTINGS = {
    "track": dict(max_dist=tham.TH_HIGH, ratio=0.9),
    "fuse": dict(max_dist=35, ratio=1.0),
}


def _matcher_args(d, radius):
    r = radius * 1.2 ** T(d["proj_level"]).float()
    return (
        T(d["proj_uv"]), T(d["proj_valid"]), T(d["proj_level"]), T(d["proj_sign"]), r,
        T(d["feat_xy"]), T(d["feat_level"]), T(d["feat_valid"]), T(d["feat_sign"]),
    )


def test_split_ranges_cover_the_columns():
    # Equal widths that are multiples of 32, in order, the last one short;
    # a split count above the number of 32-wide groups gives one range a group.
    assert tpm.split_ranges(400, 1) == [(0, 400)]
    assert tpm.split_ranges(400, 5) == [(0, 96), (96, 192), (192, 288), (288, 384), (384, 400)]
    assert tpm.split_ranges(400, 6) == tpm.split_ranges(400, 5)  # 13 groups: 3 a range
    assert tpm.split_ranges(17, 4) == [(0, 17)]
    assert len(tpm.split_ranges(1032, 100)) == 33
    for n, s in ((1032, 5), (1031, 2), (33, 2)):
        ranges = tpm.split_ranges(n, s)
        assert ranges[0][0] == 0 and ranges[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert all((c1 - c0) % 32 == 0 for c0, c1 in ranges[:-1])


@pytest.mark.parametrize("settings", ["track", "fuse"])
@pytest.mark.parametrize("splits", [1, 2, 3, 5, 7, 13])
@pytest.mark.parametrize("seed,radius", [(0, 60.0), (1, 3.0)])
def test_split_reference_equals_reference(seed, radius, splits, settings):
    # The kernel's merge across column splits and its finish, modelled in
    # plain torch, against the dense reference: exact, with ties planted
    # inside a range and across range boundaries (7 splits leave a short
    # last range of 16 columns, 13 splits one group a range).
    d = make_search_case(seed, P=300, N=400, tie_columns=_TIE_COLUMNS)
    args = _matcher_args(d, radius)
    kw = _SETTINGS[settings]
    ir, dr = tpm.project_match_reference(*args, **kw)
    i_s, d_s = tpm.project_match_reference_split(*args, **kw, splits=splits)
    assert i_s.dtype == torch.int32 and d_s.dtype == torch.int32
    assert torch.equal(i_s, ir) and torch.equal(d_s, dr)
    assert (ir >= 0).sum() > 20  # the case is not vacuous
    # The planted rows: each boundary's pair of identical landmarks sees two
    # identical features at distance 5. At ratio 0.9 the tie fails the ratio
    # test; at ratio 1.0 the lower column (or a still lower copy of the same
    # descriptor that the case happens to hold) goes to the lower row.
    rows = torch.arange(0, 2 * len(_TIE_COLUMNS), 2)
    cols = torch.tensor(_TIE_COLUMNS, dtype=torch.int32) - 1
    if settings == "fuse":
        assert ((ir[rows] >= 0) & (ir[rows] <= cols)).all() and (dr[rows] == 5).all()
        assert (ir[rows] == cols).sum() >= len(cols) - 2
    else:
        assert (ir[rows] == -1).all()
    assert (ir[rows + 1] == -1).all()


def test_split_reference_without_candidates():
    # No valid row: every range reports nothing, every row ends unmatched.
    d = make_search_case(2, P=64, N=100)
    d["proj_valid"][:] = False
    args = _matcher_args(d, 60.0)
    for splits in (1, 3):
        i_s, d_s = tpm.project_match_reference_split(*args, splits=splits)
        assert (i_s == -1).all() and (d_s == tham.INVALID_DIST).all()
