"""Meshes of named axes, and every collective of the port.

Port of ``repro/launch/mesh.py``. The reference's mesh is a ``jax`` device
mesh, and GSPMD puts the collectives in. Eager PyTorch has no such
compiler: each rank holds its local shard as a plain tensor, and the
collectives below go where the sharding specs put the boundaries.

A ``Mesh`` has named axes, ``("data", "model")`` or ``("pod", "data",
"model")``, and one of two forms:

  real      over the default process group (``torch.distributed``), built
            with ``init_device_mesh`` on the tensors' device type ("cuda"
            on the card, "cpu" in the tests); a rank's coordinates follow
            its rank in row-major order
  abstract  sizes only, for spec computation and the dry run: its
            collectives communicate nothing, return tensors of the shape
            the real ones would, and are recorded like the real ones

Logical axes (the reference's):
  pod   : inter-pod data parallelism (gradient all-reduce over the slow link)
  data  : intra-pod data parallelism + FSDP parameter sharding
  model : tensor/expert parallelism (heads, ffn hidden, experts, vocab)

Collectives (``all_reduce`` with op "sum", "max" or "mean",
``all_gather``, ``reduce_scatter``, ``all_to_all``) take one axis name or
a tuple of them. Over a tuple they run axis after axis: an all-reduce is
then hierarchical, and gathers and scatters keep the tuple's row-major
rank order. An axis of size 1 costs nothing and is not recorded. The
autograd forms the model uses (``copy_to``, ``reduce_from``,
``gather_from``, ``fsdp_gather``, ``mean_from``) are built on them, and
so is ``softmax_merge``, which joins the partial softmaxes of ranks that
each attended a shard of a sequence (sequence-sharded serving).
``record()`` collects each collective a rank issues, with its result's
bytes and its group's size (``analysis.profile.collective_bytes``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels.counting import uncounted

Axes = Union[str, Sequence[str]]


class Mesh:
    """Named axes over ranks, real or abstract (see the module's doc)."""

    def __init__(self, shape: Tuple[int, ...], axes: Tuple[str, ...], *,
                 device_type: Optional[str] = None,
                 coords: Optional[Tuple[int, ...]] = None):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes}")
        self.axis_names = tuple(axes)
        self.devices_shape = tuple(int(s) for s in shape)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              self.devices_shape))
        self.abstract = device_type is None
        self.device_type = device_type
        self._groups: Dict[str, object] = {}
        if self.abstract:
            self.coords = tuple(coords or (0,) * len(shape))
            return
        import torch.distributed as dist
        size = math.prod(self.devices_shape)
        if size == 1 and not dist.is_initialized():
            self.coords = (0,) * len(shape)
            return
        if dist.get_world_size() != size:
            raise ValueError(f"mesh {self.devices_shape} over a world of "
                             f"{dist.get_world_size()} ranks")
        from torch.distributed.device_mesh import init_device_mesh
        dm = init_device_mesh(device_type, self.devices_shape,
                              mesh_dim_names=self.axis_names)
        self._groups = {a: dm.get_group(a) for a in self.axis_names}
        self.coords = tuple(int(c) for c in dm.get_coordinate())

    def __repr__(self) -> str:
        kind = "abstract" if self.abstract else self.device_type
        return f"Mesh({self.devices_shape}, {self.axis_names}, {kind})"

    def coord(self, name: str) -> int:
        """This rank's index along axis ``name`` (0 if the mesh lacks it)."""
        if name not in self.shape:
            return 0
        return self.coords[self.axis_names.index(name)]

    def index(self, axes: Axes) -> int:
        """This rank's row-major index over the tuple of ``axes``."""
        i = 0
        for a in _axes(axes):
            i = i * axis_size(self, a) + self.coord(a)
        return i


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production topologies, abstract: (16, 16) or
    (2, 16, 16)."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: str = "cuda") -> Mesh:
    """A real mesh over the default process group (the world must have
    prod(shape) ranks; a mesh of one rank needs no process group)."""
    return Mesh(shape, axes, device_type=device_type)


def make_host_mesh(data: int = 1, model: int = 1,
                   device_type: str = "cpu") -> Mesh:
    """A small real (data, model) mesh (the CPU tests)."""
    return make_mesh((data, model), ("data", "model"), device_type)


def abstract_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
                  coords: Optional[Tuple[int, ...]] = None) -> Mesh:
    """Sizes only; ``coords`` says which rank it stands for (rank 0)."""
    return Mesh(shape, axes, coords=coords)


def dp_axes(mesh) -> Tuple[str, ...]:
    """The axes batch is sharded over."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def axis_size(mesh, name: str) -> int:
    if name not in mesh.axis_names:
        return 1
    return mesh.shape[name]


def _axes(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


# ---------------------------------------------------------------------------
# Recording (analysis.profile.collective_bytes)
# ---------------------------------------------------------------------------

_RECORDERS: List[list] = []


@contextlib.contextmanager
def record():
    """Yield a list that collects each collective issued here as a dict:
    ``kind`` ("all-reduce", "all-gather", "reduce-scatter", "all-to-all"),
    ``axis``, ``group`` (its size), ``result_bytes`` (the gathered result
    of an all-gather, the scattered one of a reduce-scatter)."""
    out: list = []
    _RECORDERS.append(out)
    try:
        yield out
    finally:
        _RECORDERS.remove(out)


def _note(kind: str, axis: str, group: int, result: torch.Tensor) -> None:
    if _RECORDERS:
        ev = {"kind": kind, "axis": axis, "group": group,
              "result_bytes": result.numel() * result.element_size()}
        for r in _RECORDERS:
            r.append(ev)


# ---------------------------------------------------------------------------
# Collectives over one axis, then over tuples of axes
# ---------------------------------------------------------------------------

def _dist():
    import torch.distributed as dist
    return dist


def _reduce_op(op: str):
    dist = _dist()
    return {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
            "mean": dist.ReduceOp.SUM}[op]


def _all_reduce1(mesh: Mesh, x: torch.Tensor, axis: str, op: str
                 ) -> torch.Tensor:
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    with uncounted():     # communication, not compute (profile)
        out = x.clone()
        _note("all-reduce", axis, n, out)
        if not mesh.abstract:
            _dist().all_reduce(out, op=_reduce_op(op), group=mesh._groups[axis])
        if op == "mean":
            out = out / n
        return out


def _all_gather1(mesh: Mesh, x: torch.Tensor, axis: str, dim: int
                 ) -> torch.Tensor:
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    with uncounted():     # communication, not compute (profile)
        dim = dim % x.ndim
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
        _note("all-gather", axis, n, out)
        if mesh.abstract:
            out.copy_(src.repeat((n,) + (1,) * (src.ndim - 1)))
        else:
            _dist().all_gather_into_tensor(out, src, group=mesh._groups[axis])
        return out.movedim(0, dim)


def _reduce_scatter1(mesh: Mesh, x: torch.Tensor, axis: str, dim: int
                     ) -> torch.Tensor:
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    with uncounted():     # communication, not compute (profile)
        dim = dim % x.ndim
        if x.shape[dim] % n:
            raise ValueError(f"reduce_scatter of dim {x.shape[dim]} over "
                             f"{axis} of {n}")
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
        _note("reduce-scatter", axis, n, out)
        if mesh.abstract:
            out.copy_(src.narrow(0, mesh.coord(axis) * out.shape[0],
                                 out.shape[0]))
        else:
            _dist().reduce_scatter_tensor(out, src, group=mesh._groups[axis])
        return out.movedim(0, dim)


def _all_to_all1(mesh: Mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    with uncounted():     # communication, not compute (profile)
        if x.shape[0] % n:
            raise ValueError(f"all_to_all of dim {x.shape[0]} over {axis} of {n}")
        src = x.contiguous()
        out = torch.empty_like(src)
        _note("all-to-all", axis, n, out)
        if mesh.abstract:
            out.copy_(src)
        else:
            _dist().all_to_all_single(out, src, group=mesh._groups[axis])
        return out


def all_reduce(mesh: Mesh, x: torch.Tensor, axes: Axes, op: str = "sum"
               ) -> torch.Tensor:
    """The sum, max or mean of ``x`` over the ranks of ``axes`` (a new
    tensor; over a tuple, axis after axis)."""
    if op not in ("sum", "max", "mean"):
        raise ValueError(f"all_reduce op {op!r}")
    for a in _axes(axes):
        x = _all_reduce1(mesh, x, a, op)
    return x


def all_gather(mesh: Mesh, x: torch.Tensor, axes: Axes, dim: int = 0
               ) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in row-major rank order
    over ``axes``."""
    for a in reversed(_axes(axes)):
        x = _all_gather1(mesh, x, a, dim)
    return x


def reduce_scatter(mesh: Mesh, x: torch.Tensor, axes: Axes, dim: int = 0
                   ) -> torch.Tensor:
    """This rank's chunk along ``dim`` (row-major over ``axes``) of the
    sum of the ranks' ``x``."""
    for a in _axes(axes):
        x = _reduce_scatter1(mesh, x, a, dim)
    return x


def all_to_all(mesh: Mesh, x: torch.Tensor, axes: Axes) -> torch.Tensor:
    """Chunk j of dim 0 goes to rank j (row-major over ``axes``); the
    result holds the chunks this rank received, in source-rank order."""
    ax = [a for a in _axes(axes) if axis_size(mesh, a) > 1]
    if len(ax) <= 1:
        return _all_to_all1(mesh, x, ax[0]) if ax else x
    sizes = [axis_size(mesh, a) for a in ax]
    n = math.prod(sizes)
    rest = tuple(x.shape[1:])
    # exchange along the last axis, then the earlier ones: each step moves
    # the destination index of its axis to the front and back again
    t = x.reshape(tuple(sizes) + (x.shape[0] // n,) + rest)
    for i in reversed(range(len(ax))):
        t = _all_to_all1(mesh, t.movedim(i, 0).contiguous(), ax[i])
        t = t.movedim(0, i)
    return t.reshape(x.shape)


def softmax_merge(mesh: Mesh, out: torch.Tensor, lse: torch.Tensor,
                  axes: Axes) -> torch.Tensor:
    """The attention over a whole sequence from each rank's over its
    shard: ``out`` (..., D) f32, the rank's softmax-weighted values, and
    ``lse`` (...) f32, the log of its softmax's sum (-inf for a rank whose
    shard held no attended position). The max of lse is all-reduced over
    ``axes``, each rank weighted by w = exp(lse - max), and w * out and w
    summed over ``axes`` in one all-reduce; the result, (..., D) f32, is
    the same on every rank of the group. A row no rank attended (lse -inf
    everywhere) comes back 0."""
    if _trivial(mesh, axes):
        return out
    top = all_reduce(mesh, lse, axes, "max")
    top = torch.where(torch.isinf(top), torch.zeros_like(top), top)
    w = torch.exp(lse - top)[..., None]
    both = all_reduce(mesh, torch.cat([w * out, w], dim=-1), axes, "sum")
    return both[..., :-1] / both[..., -1:].clamp(min=1e-30)


# ---------------------------------------------------------------------------
# Autograd forms (the TP/FSDP forward)
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    """Identity forward, all-reduce (sum) backward: in front of a region
    whose ranks each compute a part of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(ctx.mesh, g, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce forward (sum, or mean), identity backward: the partial
    sums of a row-parallel product, or a loss term each rank owns."""

    @staticmethod
    def forward(ctx, x, mesh, axes, op):
        return all_reduce(mesh, x, axes, op)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _GatherFrom(torch.autograd.Function):
    """All-gather forward, this rank's chunk backward: a shard that every
    rank then uses in the same replicated computation."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim, ctx.n = mesh, axes, dim, x.shape[dim]
        return all_gather(mesh, x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.index(ctx.axes)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n), None, None, None


class _FsdpGather(torch.autograd.Function):
    """All-gather forward, reduce-scatter backward: an FSDP leaf, which
    each data rank uses on its own batch."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(mesh, x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter(ctx.mesh, g, ctx.axes, ctx.dim), None, None,
                None)


def _trivial(mesh, axes) -> bool:
    return mesh is None or all(axis_size(mesh, a) == 1 for a in _axes(axes))


def copy_to(mesh: Mesh, x: torch.Tensor, axes: Axes) -> torch.Tensor:
    return x if _trivial(mesh, axes) else _CopyTo.apply(x, mesh, axes)


def reduce_from(mesh: Mesh, x: torch.Tensor, axes: Axes) -> torch.Tensor:
    return x if _trivial(mesh, axes) else _ReduceFrom.apply(x, mesh, axes,
                                                            "sum")


def mean_from(mesh: Mesh, x: torch.Tensor, axes: Axes) -> torch.Tensor:
    return x if _trivial(mesh, axes) else _ReduceFrom.apply(x, mesh, axes,
                                                            "mean")


def gather_from(mesh: Mesh, x: torch.Tensor, axes: Axes, dim: int
                ) -> torch.Tensor:
    return x if _trivial(mesh, axes) else _GatherFrom.apply(x, mesh, axes,
                                                            dim)


def fsdp_gather(mesh: Mesh, x: torch.Tensor, axes: Axes, dim: int
                ) -> torch.Tensor:
    return x if _trivial(mesh, axes) else _FsdpGather.apply(x, mesh, axes,
                                                            dim)
