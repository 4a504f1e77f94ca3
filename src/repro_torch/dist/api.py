"""Mesh context and the tensor-parallel collectives (port of
`repro.dist.api`).

A `Mesh` is a layout of ranks over named axes, ('data', 'model') or
('pod', 'data', 'model'), row-major as `jax.make_mesh` lays devices out:
global rank = ((pod * data) + data_index) * model + model_index. The model
and data layers speak the same two logical axes as JAX's:

  'dp'     the data-parallel direction: ('pod', 'data') on a 3-axis mesh,
           ('data',) otherwise;
  'model'  the tensor-parallel direction.

A mesh bound to a `torch.distributed` world (`launch.mesh.init_world`)
holds one process group per direction: the ranks that share every other
coordinate. A mesh that is a layout alone (the dry run's (16, 16) and
(2, 16, 16)) has no groups and no rank; its collectives run in cost mode
only.

`use_mesh`/`current_mesh` keep the active mesh on a ContextVar, as JAX's
do; without an active mesh every helper below is the identity, so the
same model code runs on one device and sharded.

Where GSPMD inserts collectives from sharding annotations, the port
places them by hand, in Megatron's layout (the rule table's 'col', 'row'
and 'embed' kinds; `dist.sharding`). The collectives are autograd
Functions:

  copy_to_model      f: identity forward, all-reduce backward (the input
                     of a column-parallel projection);
  reduce_from_model  g: all-reduce forward, identity backward (the output
                     of a row-parallel projection). Not
                     `torch.distributed.nn.functional.all_reduce`, whose
                     backward all-reduces again: a replicated downstream
                     gradient would come out `model` times too large;
  gather_from_model  all-gather forward, the rank's slice backward (a
                     vocab-parallel head's logits, `vlm_proj`'s output);
  split_to_model     the rank's slice forward, all-gather backward (a
                     replicated leaf read inside a sharded region, such as
                     an `attn_concat` adapter's rows).

Each counts its calls and bytes by kind in `COLLECTIVES`, a
`repro_torch.obs.MetricsRegistry` (`dist_collectives_total{kind}`,
`dist_collective_bytes_total{kind}`; the bytes one rank contributes).
Inside `common.costmode.cost_mode_ctx` they count and move nothing: an
all-reduce returns its input, an all-gather the input repeated.

JAX's `constrain` is GSPMD's layout hint inside a traced program; eager
PyTorch has no counterpart (every collective above is explicit), so it is
not ported. `named_sharding` is not either: the port slices a rank's
leaves itself (`dist.sharding.shard_leaf`).

Gloo handles a CUDA tensor's all-reduce by staging it through the host,
but has no all-gather for one; under gloo an all-gather of a CUDA tensor
goes through the host explicitly. NCCL takes both on the card.
"""
from __future__ import annotations

import contextlib
import math
from contextvars import ContextVar
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.common.costmode import cost_mode
from repro_torch.obs.metrics import MetricsRegistry

_ACTIVE_MESH: ContextVar = ContextVar("repro_torch_active_mesh",
                                      default=None)

COLL_KINDS = ("all-reduce", "all-gather")
COLLECTIVES = MetricsRegistry()


def _axes_for(ndim: int) -> Tuple[str, ...]:
    if ndim == 2:
        return ("data", "model")
    if ndim == 3:
        return ("pod", "data", "model")
    raise ValueError(f"a mesh has 2 axes (data, model) or 3 (pod, data, "
                     f"model), got shape of {ndim}")


class Mesh:
    """Ranks laid out over named axes. shape: (data, model) or (pod, data,
    model); rank: this process's global rank, or None for a layout alone.
    `bind_groups` makes the process groups of a live world."""

    def __init__(self, shape: Sequence[int],
                 axis_names: Optional[Sequence[str]] = None,
                 rank: Optional[int] = None):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names or _axes_for(len(self.shape)))
        if len(self.axis_names) != len(self.shape) or any(
                s < 1 for s in self.shape):
            raise ValueError(f"mesh shape {self.shape} over axes "
                             f"{self.axis_names}")
        self.size = math.prod(self.shape)
        if rank is not None and not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.groups: Dict[str, object] = {}
        self.backend: Optional[str] = None
        self.device: Optional[torch.device] = None  # this rank's, when live

    def __repr__(self) -> str:
        dims = "x".join(str(s) for s in self.shape)
        return f"Mesh({dims} {self.axis_names}, rank={self.rank})"

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """{axis: index} of `rank` (this process's by default; 0 on every
        axis for a layout without one)."""
        r = self.rank if rank is None else rank
        if r is None:
            return {a: 0 for a in self.axis_names}
        out = {}
        for name, size in reversed(tuple(zip(self.axis_names, self.shape))):
            out[name] = r % size
            r //= size
        return {a: out[a] for a in self.axis_names}

    def rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for name, size in zip(self.axis_names, self.shape):
            r = r * size + coords.get(name, 0)
        return r

    def direction(self, which: str) -> Tuple[str, ...]:
        """The mesh axes of 'model' or 'dp'."""
        return ("model",) if which == "model" else dp_axes(self)

    def degree(self, which: str) -> int:
        sizes = self.sizes
        return math.prod(sizes.get(a, 1) for a in self.direction(which))

    def index(self, which: str, rank: Optional[int] = None) -> int:
        """`rank`'s index along 'model' or 'dp' (pod-major; this
        process's by default)."""
        c, sizes, i = self.coords(rank), self.sizes, 0
        for a in self.direction(which):
            i = i * sizes.get(a, 1) + c.get(a, 0)
        return i

    def members(self, which: str, rank: Optional[int] = None):
        """The global ranks of `rank`'s group along 'model' or 'dp', in
        index order."""
        base = self.coords(rank)
        axes = self.direction(which)
        out = [dict(base)]
        for a in axes:
            out = [dict(c, **{a: i}) for c in out
                   for i in range(self.sizes.get(a, 1))]
        return sorted((self.rank_of(c) for c in out),
                      key=lambda r: self.index(which, r))

    def bind_groups(self, backend: str) -> "Mesh":
        """Make every 'model' and 'dp' process group of the live world (all
        ranks take part in each `new_group`, in one order) and keep the
        two this rank belongs to. A direction of degree 1 gets none."""
        import torch.distributed as dist

        self.backend = backend
        for which in ("model", "dp"):
            if self.degree(which) == 1:
                continue
            seen = set()
            for r in range(self.size):
                ranks = tuple(self.members(which, r))
                if ranks in seen:
                    continue
                seen.add(ranks)
                group = dist.new_group(list(ranks), backend=backend)
                if self.rank in ranks:
                    self.groups[which] = group
        return self


def current_mesh() -> Optional[Mesh]:
    """The mesh activated by the innermost `use_mesh`, or None."""
    return _ACTIVE_MESH.get()


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Activate `mesh` for the dynamic extent of the block (None: no
    mesh). The serving engine captures the mesh it is built under and
    activates it again around every model call, as JAX's does."""
    token = _ACTIVE_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.reset(token)


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis_name: size} of a port `Mesh` or of anything shaped like a JAX
    mesh (`axis_names` and `devices.shape`)."""
    shape = (mesh.shape if isinstance(mesh, Mesh)
             else tuple(mesh.devices.shape))
    return dict(zip(tuple(mesh.axis_names), tuple(shape)))


def dp_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes forming the data-parallel direction."""
    return ("pod", "data") if "pod" in tuple(mesh.axis_names) else ("data",)


def _axis_size(entry, sizes: Dict[str, int]) -> int:
    names = entry if isinstance(entry, tuple) else (entry,)
    n = 1
    for a in names:
        n *= sizes.get(a, 1)
    return n


def model_degree(mesh: Optional[Mesh] = None) -> int:
    mesh = current_mesh() if mesh is None else mesh
    return 1 if mesh is None else mesh.degree("model")


def model_index(mesh: Optional[Mesh] = None) -> int:
    """This rank's index along 'model' (0 without a mesh)."""
    mesh = current_mesh() if mesh is None else mesh
    return 0 if mesh is None else mesh.index("model")


def dp_degree(mesh: Optional[Mesh] = None) -> int:
    mesh = current_mesh() if mesh is None else mesh
    return 1 if mesh is None else mesh.degree("dp")


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------


def _count(kind: str, t: torch.Tensor) -> None:
    COLLECTIVES.counter("dist_collectives_total", kind=kind).inc()
    COLLECTIVES.counter("dist_collective_bytes_total", kind=kind).inc(
        t.numel() * t.element_size())


def collective_counts() -> Dict[str, Dict[str, int]]:
    """{kind: {"count", "bytes"}} since the last `reset_collectives`."""
    return {k: {"count": int(COLLECTIVES.counter(
                    "dist_collectives_total", kind=k).value),
                "bytes": int(COLLECTIVES.counter(
                    "dist_collective_bytes_total", kind=k).value)}
            for k in COLL_KINDS}


def reset_collectives() -> None:
    COLLECTIVES.reset()


# ---------------------------------------------------------------------------
# raw collectives over one direction of the active mesh
# ---------------------------------------------------------------------------


def _group(mesh: Mesh, which: str):
    group = mesh.groups.get(which)
    if group is None:
        raise RuntimeError(
            f"{mesh} has no {which!r} process group: build it with "
            "launch.mesh.init_world (a layout alone runs collectives in "
            "cost mode only)")
    return group


def all_reduce(t: torch.Tensor, which: str, mesh: Optional[Mesh] = None,
               op: str = "sum") -> torch.Tensor:
    """Sum (or mean) of `t` over the mesh direction `which`, out of place.
    The identity where that direction has one rank."""
    mesh = current_mesh() if mesh is None else mesh
    n = 1 if mesh is None else mesh.degree(which)
    if n == 1:
        return t
    _count("all-reduce", t)
    if cost_mode() or t.device.type == "meta":
        return t
    import torch.distributed as dist

    out = t.contiguous().clone()
    dist.all_reduce(out, group=_group(mesh, which))
    if op == "mean":
        out = out / n
    return out


def all_gather(t: torch.Tensor, dim: int, which: str = "model",
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Every rank's `t` of the direction `which`, concatenated along `dim`
    in index order."""
    mesh = current_mesh() if mesh is None else mesh
    n = 1 if mesh is None else mesh.degree(which)
    if n == 1:
        return t
    _count("all-gather", t)
    if cost_mode() or t.device.type == "meta":
        return torch.cat([t] * n, dim=dim)
    import torch.distributed as dist

    src = t.contiguous()
    staged = mesh.backend == "gloo" and src.device.type != "cpu"
    if staged:  # gloo gathers host tensors only
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=_group(mesh, which))
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if staged else out


def rank_slice(t: torch.Tensor, dim: int, which: str = "model",
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """This rank's contiguous 1/n of `t` along `dim`."""
    mesh = current_mesh() if mesh is None else mesh
    n = 1 if mesh is None else mesh.degree(which)
    if n == 1:
        return t
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"{n} ways")
    step = size // n
    return t.narrow(dim, mesh.index(which) * step, step)


# ---------------------------------------------------------------------------
# Megatron's conjugate pairs, as autograd Functions
# ---------------------------------------------------------------------------


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, "model", ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x, "model", mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return all_gather(x, dim, "model", mesh)

    @staticmethod
    def backward(ctx, g):
        return rank_slice(g, ctx.dim, "model", ctx.mesh), None, None


class _SplitToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return rank_slice(x, dim, "model", mesh)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, "model", ctx.mesh), None, None


class _DpMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x, "dp", mesh, op="mean")

    @staticmethod
    def backward(ctx, g):
        return g, None


def dp_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of `x` over the dp ranks (a global statistic of the batch,
    such as MoE's expert shares). Its backward is the identity: every
    rank's loss holds the same global term, and the trainer averages the
    ranks' gradients, which gives that term's true gradient."""
    mesh = current_mesh()
    if mesh is None or mesh.degree("dp") == 1:
        return x
    return _DpMean.apply(x, mesh)


def _tp_mesh() -> Optional[Mesh]:
    mesh = current_mesh()
    return mesh if mesh is not None and mesh.degree("model") > 1 else None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """f: the input of a column-parallel region. Only a backward does
    anything, so without autograd this is `x` itself."""
    mesh = _tp_mesh()
    if mesh is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """g: the partial sums of a row-parallel projection, summed."""
    mesh = _tp_mesh()
    return x if mesh is None else _ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    mesh = _tp_mesh()
    if mesh is None:
        return x
    return _GatherFromModel.apply(x, dim % x.dim(), mesh)


def split_to_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    mesh = _tp_mesh()
    if mesh is None:
        return x
    return _SplitToModel.apply(x, dim % x.dim(), mesh)
