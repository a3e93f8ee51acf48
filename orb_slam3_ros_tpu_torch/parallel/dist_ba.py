"""Distributed bundle adjustment over a process mesh — port of
``orb_slam3_ros_tpu.parallel.dist_ba``.

The JAX package annotates shardings and lets GSPMD partition the unchanged
solver bodies. PyTorch has no such pass, so here each solver takes a
communicator (``comm``, a ``Comm``) and sums its partial accumulations where
they must be combined; everything else in the solve is the single-process
code.

The world of ``torch.distributed`` is factored into a 2-D mesh (obs, pt)
as the JAX ``make_mesh`` factors its devices: pt = 2 when the world is even,
else 1, and rank r sits at (r // pt, r % pt). The placement follows JAX
``shard_problem``:

* point rows over 'pt': column j holds a contiguous block of the points;
* edge rows over 'obs': each edge goes to the column of its point, and the
  edges of a column are split over that column's obs ranks, so every edge
  lives on exactly one rank;
* cameras, keyframe states and the inertial chain replicated.

Per LM step the camera blocks, the Schur products, the right-hand side and
the cost are summed over all ranks; the point blocks (Hpp, gp and the
camera-point blocks Wcp of the column's points only) over the ranks of the
column ("obs"); each rank adds the Schur products of its own part of its
column's points (``Comm.pt_rows``), so no rank builds the full [K P, 6, 3]
Wcp. Every rank then solves the same reduced camera system, back-substitutes
its column's points, and only the final points and per-edge outputs are
assembled. The collectives are ``all_reduce`` sums, which the gloo backend
also runs on CUDA tensors.

SPMD: every rank calls a ``distributed_*`` function with the same full host
problem, takes its own shard and returns the same full result.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..ops import ba, ba_pcg, pgo, viba


@dataclass
class Mesh:
    """This rank's place in the (obs, pt) mesh of the process world and the
    process groups of its two axes."""

    shape: tuple  # (obs, pt)
    rank: int
    device: torch.device
    groups: dict  # axis -> process group of this rank along it ("world": the default group)
    # the solvers' sums through this mesh's communicators: all_reduce calls and bytes
    stats: dict = field(default_factory=lambda: {"calls": 0, "bytes": 0})

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def obs(self) -> int:
        """This rank's coordinate along 'obs' (its share of a column's edges)."""
        return self.rank // self.shape[1]

    @property
    def pt(self) -> int:
        """This rank's coordinate along 'pt' (its column of points)."""
        return self.rank % self.shape[1]

    def axis_size(self, over: str) -> int:
        return {"world": self.size, "obs": self.shape[0], "pt": self.shape[1]}[over]

    def sum(self, over: str, *xs: torch.Tensor) -> int:
        """Sum ``xs`` in place over the ranks along ``over`` ("world",
        "obs": the ranks holding the same points, "pt": the ranks with the
        same obs coordinate), packed into one ``all_reduce`` per dtype.
        Returns the ``all_reduce`` calls made."""
        if self.axis_size(over) == 1:
            return 0
        group = self.groups[over]
        by_dtype: dict = {}
        for x in xs:
            by_dtype.setdefault(x.dtype, []).append(x)
        for same in by_dtype.values():
            if len(same) == 1 and same[0].is_contiguous():
                flat = same[0]
            else:
                flat = torch.cat([x.reshape(-1) for x in same])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
            if flat is not same[0]:
                o = 0
                for x in same:
                    x.copy_(flat[o : o + x.numel()].view_as(x))
                    o += x.numel()
        return len(by_dtype)

    def comm(self, pt_rows: slice = slice(None)) -> "Comm":
        return Comm(self, pt_rows)


class Comm:
    """What a solver sees of the mesh: ``sum(over, *xs)`` and the slice of
    its points whose Schur products this rank adds (``pt_rows``)."""

    def __init__(self, mesh: Mesh, pt_rows: slice):
        self.mesh = mesh
        self.pt_rows = pt_rows

    def sum(self, over: str, *xs: torch.Tensor) -> None:
        calls = self.mesh.sum(over, *xs)
        if calls:
            self.mesh.stats["calls"] += calls
            self.mesh.stats["bytes"] += sum(x.numel() * x.element_size() for x in xs)


def mesh_shape(n: int) -> tuple:
    """(obs, pt) of a world of ``n``: (n // b, b) with b = 2 when n is even
    (the JAX ``make_mesh``'s factoring)."""
    b = 2 if n % 2 == 0 and n >= 2 else 1
    return n // b, b


def make_mesh(device=None) -> Mesh:
    """2-D mesh (obs, pt) over the whole ``torch.distributed`` world, one
    device a process, factored by ``mesh_shape``. ``device``: this process's
    device (None: the CUDA device). Every rank must call it, in the same
    order (it creates the axes' process groups)."""
    n = dist.get_world_size()
    a, b = mesh_shape(n)
    rank = dist.get_rank()
    groups = {"world": dist.group.WORLD}
    # Every rank creates every group, in one order (torch.distributed's rule);
    # an axis of one rank needs none.
    if a > 1:
        for j in range(b):
            g = dist.new_group([i * b + j for i in range(a)])
            if rank % b == j:
                groups["obs"] = g
    if b > 1:
        for i in range(a):
            g = dist.new_group([i * b + j for j in range(b)])
            if rank // b == i:
                groups["pt"] = g
    return Mesh(shape=(a, b), rank=rank, device=resolve_device(device), groups=groups)


def _bounds(n: int, k: int) -> np.ndarray:
    """Boundaries of ``n`` rows split into ``k`` contiguous parts, the first
    ``n % k`` one row longer (``np.array_split``)."""
    sizes = np.full(k, n // k, np.int64)
    sizes[: n % k] += 1
    return np.concatenate([[0], np.cumsum(sizes)])


class Shard(NamedTuple):
    """This rank's share of a problem: ``prob`` (the problem's own type, on
    the mesh's device, its edges' point ids local to ``pts``), the global ids
    of its edges, its column's point rows [lo, hi) and the part of them whose
    Schur products it adds."""

    prob: tuple
    edges: torch.Tensor  # [E_local] int64 global edge ids
    pts: tuple  # (lo, hi)
    pt_rows: slice


def _edge_split(pt_idx: np.ndarray, P: int, mesh: Mesh):
    """Global edge ids of this rank, its column's point bounds and Schur rows."""
    a, b = mesh.shape
    pb = _bounds(P, b)
    lo, hi = int(pb[mesh.pt]), int(pb[mesh.pt + 1])
    mine = np.nonzero((pt_idx >= lo) & (pt_idx < hi))[0]
    eb = _bounds(len(mine), a)
    rb = _bounds(hi - lo, a)
    edges = mine[eb[mesh.obs] : eb[mesh.obs + 1]]
    return edges, (lo, hi), slice(int(rb[mesh.obs]), int(rb[mesh.obs + 1]))


def _take(x: torch.Tensor, idx: torch.Tensor, device) -> torch.Tensor:
    return x.index_select(0, idx.to(x.device)).to(device)


def shard_problem(prob: ba.BAProblem, mesh: Mesh) -> Shard:
    """This rank's shard of a ``ba.BAProblem`` (tensors on any device):
    edge rows over 'obs', point rows over 'pt', cameras replicated."""
    P = prob.X.shape[0]
    edges, (lo, hi), rows = _edge_split(prob.pt_idx.cpu().numpy(), P, mesh)
    e = torch.from_numpy(edges)
    dev = mesh.device
    local = ba.BAProblem(
        R=prob.R.to(dev), t=prob.t.to(dev), cam_fixed=prob.cam_fixed.to(dev),
        cam_valid=prob.cam_valid.to(dev), X=prob.X[lo:hi].to(dev),
        pt_valid=prob.pt_valid[lo:hi].to(dev), cam_idx=_take(prob.cam_idx, e, dev),
        pt_idx=(_take(prob.pt_idx, e, dev) - lo).to(prob.pt_idx.dtype),
        uv=_take(prob.uv, e, dev), inv_sigma2=_take(prob.inv_sigma2, e, dev),
        edge_valid=_take(prob.edge_valid, e, dev), cam_params=prob.cam_params.to(dev),
        ur=_take(prob.ur, e, dev), bf=prob.bf.to(dev),
    )
    return Shard(local, e.to(dev), (lo, hi), rows)


def _gather_points(X_local: torch.Tensor, sh: Shard, mesh: Mesh, P: int) -> torch.Tensor:
    """The full [P, ...] point array from each column's rows (a sum over the
    'pt' axis of zero-padded columns: exact)."""
    if mesh.shape[1] == 1:
        return X_local
    X = torch.zeros((P,) + X_local.shape[1:], dtype=X_local.dtype, device=X_local.device)
    X[sh.pts[0] : sh.pts[1]] = X_local
    mesh.sum("pt", X)
    return X


def _gather_edges(v: torch.Tensor, sh: Shard, mesh: Mesh, E: int) -> torch.Tensor:
    """The full [E] per-edge array from every rank's edges (a sum over the
    world of zero-padded rows: exact). Booleans travel as 0 / 1."""
    dtype = v.dtype
    full = torch.zeros((E,), dtype=torch.float32 if dtype == torch.bool else dtype,
                       device=v.device)
    full[sh.edges] = v.to(full.dtype)
    mesh.sum("world", full)
    return full > 0.5 if dtype == torch.bool else full


def distributed_bundle_adjust(prob: ba.BAProblem, mesh: Mesh, n_iters: int = 5, **kw) -> ba.BAResult:
    """One sharded Schur-LM BA solve (``ba.bundle_adjust``'s contract and
    keywords); every rank returns the full result."""
    sh = shard_problem(prob, mesh)
    res = ba.bundle_adjust(sh.prob, n_iters=n_iters, comm=mesh.comm(sh.pt_rows), **kw)
    return _assemble_ba(res, sh, mesh, prob)


def distributed_bundle_adjust_pcg(prob: ba.BAProblem, mesh: Mesh, n_iters: int = 5,
                                  **kw) -> ba.BAResult:
    """Sharded matrix-free Schur-PCG BA — the global-BA scale-out path: each
    CG product is edge-local work and two sums (points over 'obs', cameras
    over the world); nothing K^2-sized is built."""
    sh = shard_problem(prob, mesh)
    res = ba_pcg.bundle_adjust_pcg(sh.prob, n_iters=n_iters, comm=mesh.comm(sh.pt_rows), **kw)
    return _assemble_ba(res, sh, mesh, prob)


def _assemble_ba(res: ba.BAResult, sh: Shard, mesh: Mesh, prob: ba.BAProblem) -> ba.BAResult:
    E = prob.uv.shape[0]
    return res._replace(
        X=_gather_points(res.X, sh, mesh, prob.X.shape[0]),
        chi2=_gather_edges(res.chi2, sh, mesh, E),
        inlier=_gather_edges(res.inlier, sh, mesh, E),
    )


# ---------------------------------------------------------------------------
# The inertial solvers (the JAX package's round-5 scale-out of FullInertialBA
# and the essential-graph PGO): the visual edges and landmarks shard like
# the BA's; keyframe states and the inertial chain are small and replicated.


def shard_vi_problem(prob: viba.VIBAProblem, mesh: Mesh) -> Shard:
    """This rank's shard of a ``viba.VIBAProblem``: visual edge rows over
    'obs', landmark rows over 'pt', states and the inertial chain
    replicated."""
    P = prob.X.shape[0]
    edges, (lo, hi), rows = _edge_split(prob.pt_idx.cpu().numpy(), P, mesh)
    e = torch.from_numpy(edges)
    dev = mesh.device

    def rep(x):
        return type(x)(*(f.to(dev) for f in x))

    bf = prob.bf.to(dev) if isinstance(prob.bf, torch.Tensor) else prob.bf
    local = viba.VIBAProblem(
        states=rep(prob.states), kf_fixed=prob.kf_fixed.to(dev), kf_valid=prob.kf_valid.to(dev),
        X=prob.X[lo:hi].to(dev), pt_valid=prob.pt_valid[lo:hi].to(dev),
        cam_idx=_take(prob.cam_idx, e, dev),
        pt_idx=(_take(prob.pt_idx, e, dev) - lo).to(prob.pt_idx.dtype),
        uv=_take(prob.uv, e, dev), inv_sigma2=_take(prob.inv_sigma2, e, dev),
        edge_valid=_take(prob.edge_valid, e, dev), ie_i=prob.ie_i.to(dev),
        ie_j=prob.ie_j.to(dev), ie_preint=rep(prob.ie_preint), ie_valid=prob.ie_valid.to(dev),
        cam_params=prob.cam_params.to(dev), R_bc=prob.R_bc.to(dev), t_bc=prob.t_bc.to(dev),
        ur=None if prob.ur is None else _take(prob.ur, e, dev), bf=bf,
    )
    return Shard(local, e.to(dev), (lo, hi), rows)


def distributed_vi_bundle_adjust(prob: viba.VIBAProblem, mesh: Mesh, n_iters: int = 8,
                                 **kw) -> viba.VIBAResult:
    """Sharded FullInertialBA / LocalInertialBA (``viba.vi_bundle_adjust``'s
    contract and keywords); every rank returns the full result."""
    sh = shard_vi_problem(prob, mesh)
    res = viba.vi_bundle_adjust(sh.prob, n_iters=n_iters, comm=mesh.comm(sh.pt_rows), **kw)
    E = prob.uv.shape[0]
    return res._replace(
        X=_gather_points(res.X, sh, mesh, prob.X.shape[0]),
        chi2_visual=_gather_edges(res.chi2_visual, sh, mesh, E),
        inlier=_gather_edges(res.inlier, sh, mesh, E),
    )


def shard_pgo_problem(prob: pgo.PGOProblem, mesh: Mesh) -> pgo.PGOProblem:
    """This rank's shard of a ``pgo.PGOProblem``: the edge tables split over
    every rank of the world (the PGO has no points, so the 'pt' axis
    shares them too, where the JAX package replicates them over it), the
    [K] vertex state replicated; the dense [7K, 7K] system is small at
    K <= 256 and every rank solves it."""
    E = prob.e_i.shape[0]
    eb = _bounds(E, mesh.size)
    lo, hi = int(eb[mesh.rank]), int(eb[mesh.rank + 1])
    dev = mesh.device
    vert = ("R", "t", "s", "kf_fixed", "kf_valid")
    return pgo.PGOProblem(**{
        k: (getattr(prob, k) if k in vert else getattr(prob, k)[lo:hi]).to(dev)
        for k in pgo.PGOProblem._fields
    })


def distributed_pose_graph(prob: pgo.PGOProblem, mesh: Mesh, n_iters: int = 20,
                           **kw) -> pgo.PGOResult:
    """Sharded essential-graph Sim(3) PGO (``pgo.optimize_pose_graph``'s
    contract): the edge accumulation partitions over the world, J^T J and
    J^T r are summed, the dense solve is replicated."""
    return pgo.optimize_pose_graph(shard_pgo_problem(prob, mesh), n_iters=n_iters,
                                   comm=mesh.comm(), **kw)
