"""Program cost of eager PyTorch: FLOPs, bytes and memory of what a function
dispatches.

The port's counterpart of ``repro/analysis/hlo.py``. The reference reads
XLA's optimized HLO text; the port runs eager torch, which has no HLO, so
this module counts the ops the function dispatches, once each, under a
``TorchDispatchMode`` (below autograd: a backward's ops count too):

  * matmuls (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``addbmm``, ``mv``,
    ``addmv``, ``dot``: what ``linear``, ``matmul`` and ``einsum`` lower
    to) give 2·M·N·K, to ``flops`` and ``dot_flops``;
  * any other op counts one flop per output element (``hlo.py``'s rule for
    fusions and elementwise ops); views and allocations count nothing;
  * bytes are each op's distinct input and output regions (a broadcast
    input at the bytes it spans); an in-place op counts the region it
    touches (read and written; a ``copy_`` or fill written only); gathers
    twice their output plus the indices, index scatters twice their
    values plus the indices (``hlo.py``'s touched-region model);
  * a call of a ported kernel counts exactly its wrapper's ``cost()``
    (``kernels.counting``), on either device, and none of the ops its
    wrapper runs within: on the CPU that is the plain version. So a
    function's count on the CPU is its count on the card.

Ops it could not cost (a sparse or nested operand) are counted in
``ops_without_cost``, in place of the reference's
``loops_without_trip_count``.

  program_cost(fn, *args, **kw)   the count above
  cost_summary(fn, *args, **kw)   the library's own count:
                                  ``torch.utils.flop_counter``'s total
  memory_summary(fn, *args, **kw) argument, output and temporary bytes
                                  (the CUDA allocator's peak on the card,
                                  the high-water mark of live op outputs
                                  on the CPU)

  collective_bytes(fn, *args, **kw)   the collectives ``fn`` issues
                                  through ``launch.mesh``, per rank, at the
                                  reference's ring model (``hlo.py``'s
                                  ``_ring_bytes``), on a real mesh or an
                                  abstract one (the dry run)

A collective is not compute: ``program_cost`` counts the ops it runs on
an abstract mesh as nothing (``launch.mesh`` issues them under
``counting.uncounted``), and a real one's communication is not a
dispatched op.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Any, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import counting

aten = torch.ops.aten

_MATMULS = {aten.mm.default, aten.bmm.default, aten.addmm.default,
            aten.baddbmm.default, aten.addbmm.default, aten.mv.default,
            aten.addmv.default, aten.dot.default}
_GATHERS = {aten.embedding.default, aten.index_select.default,
            aten.gather.default, aten.index.Tensor}
_SCATTERS = {aten.index_put_.default, aten.index_add_.default,
             aten.index_copy_.default, aten.scatter_.src,
             aten.scatter_add_.default, aten.scatter_reduce_.two,
             aten._index_put_impl_.default}
_WRITES = {aten.copy_.default, aten.fill_.Scalar, aten.fill_.Tensor,
           aten.zero_.default}
_ALLOCS = {aten.empty.memory_format, aten.empty_strided.default,
           aten.empty_like.default, aten.new_empty.default,
           aten.new_empty_strided.default}
_VIEWS = {aten._unsafe_view.default, aten.lift_fresh.default}  # unannotated


def _tensors(tree):
    """The tensors of an op's arguments or result: nested tuples, lists
    and dicts walked directly (every dispatch goes through here; the
    generic pytree flatten took half of a dry-run cell's time), any other
    container through ``tree_flatten``."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    if tree is None or isinstance(tree, (int, float, bool, str,
                                         torch.dtype, torch.device)):
        return []
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _key(t: torch.Tensor):
    st = t.untyped_storage()
    # a "meta" storage (the dry run's) has no address: its handle tells
    # storages apart
    ptr = st._cdata if t.device.type == "meta" else st.data_ptr()
    return (ptr, t.storage_offset(), tuple(t.shape), tuple(t.stride()),
            t.dtype)


def _region(t: torch.Tensor) -> int:
    """Bytes a tensor spans: its elements, a broadcast (stride-0) dim
    counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _costable(t: torch.Tensor) -> bool:
    return t.layout == torch.strided and not t.is_nested


def _matmul_flops(func, args) -> float:
    """2·M·N·K of a matmul from its operand shapes."""
    if func in (aten.addmm.default, aten.baddbmm.default,
                aten.addbmm.default, aten.addmv.default):
        a, b = args[1], args[2]
    else:
        a, b = args[0], args[1]
    if func is aten.dot.default:
        return 2.0 * a.numel()
    if func in (aten.mv.default, aten.addmv.default):
        return 2.0 * a.shape[0] * a.shape[1]
    if func in (aten.bmm.default, aten.baddbmm.default, aten.addbmm.default):
        nb, m, k = a.shape
        return 2.0 * nb * m * k * b.shape[2]
    m, k = a.shape
    return 2.0 * m * k * b.shape[1]


class _Counter(TorchDispatchMode):
    """The dispatch mode behind ``program_cost`` and ``memory_summary``."""

    def __init__(self, track_live: bool = False):
        super().__init__()
        self.flops = self.dot_flops = self.bytes = 0.0
        self.without_cost = self.ops = 0
        self.kernel_calls: Dict[str, int] = {}
        self._paused = 0
        self.track_live = track_live
        self.live = self.peak_live = 0

    # --- kernels.counting's protocol --------------------------------------
    @property
    def paused(self) -> bool:
        return self._paused > 0

    def pause(self) -> None:
        self._paused += 1

    def resume(self) -> None:
        self._paused -= 1

    def add_kernel(self, name: str, cost: dict, dots: bool) -> None:
        ops = float(cost.get("flops", 0.0)) + float(cost.get("bf16_flops",
                                                             0.0))
        self.flops += ops
        if dots:
            self.dot_flops += ops
        self.bytes += float(cost.get("bytes_accessed", 0.0))
        self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1

    def __enter__(self):
        counting.push(self)
        return super().__enter__()

    def __exit__(self, *exc):
        counting.pop(self)
        return super().__exit__(*exc)

    # --- the ops ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        fresh = self._count(func, args, kwargs, out)
        if self.track_live:
            for t in fresh:
                self._hold(t)
        return out

    def _hold(self, t: torch.Tensor) -> None:
        n = t.untyped_storage().nbytes()
        self.live += n
        self.peak_live = max(self.peak_live, self.live)
        weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def _count(self, func, args, kwargs, out):
        """Count one op; returns its freshly allocated outputs."""
        rets = func._schema.returns
        aliased = func in _VIEWS or any(r.alias_info is not None
                                        for r in rets)
        outs = _tensors(out)
        fresh = [] if aliased else outs
        if self.paused:
            return fresh
        inputs = _tensors((args, kwargs))
        if not all(_costable(t) for t in inputs + outs):
            self.without_cost += 1
            return fresh
        writes = any(r.alias_info is not None and r.alias_info.is_write
                     for r in rets)
        if aliased and not writes:          # a view: no work
            return fresh
        if func in _ALLOCS:
            return fresh
        self.ops += 1
        if func in _MATMULS:
            f = _matmul_flops(func, args)
            self.flops += f
            self.dot_flops += f
        else:
            self.flops += float(sum(t.numel() for t in outs))
        self.bytes += self._bytes(func, args, inputs, outs, writes)
        return fresh

    def _bytes(self, func, args, inputs, outs, writes) -> float:
        if func in _GATHERS:
            idx = [t for t in inputs[1:] if not t.is_floating_point()]
            return float(2 * sum(_region(t) for t in outs)
                         + sum(_region(t) for t in idx))
        if func in _SCATTERS:               # self, indices..., values
            *idx, vals = inputs[1:]
            return float(2 * _region(vals) + sum(_region(t) for t in idx))
        seen = set()
        total = 0
        mutated = {_key(t) for t in outs} if writes else set()
        for t in inputs:
            k = _key(t)
            if k in seen:
                continue
            seen.add(k)
            if k in mutated and func in _WRITES:
                continue                    # written, not read
            total += _region(t)
        for t in outs:
            total += _region(t)
        return float(total)

    def result(self) -> Dict[str, Any]:
        return {"flops": self.flops, "dot_flops": self.dot_flops,
                "bytes_accessed": self.bytes,
                "ops_without_cost": float(self.without_cost),
                "ops": self.ops, "kernel_calls": dict(self.kernel_calls)}


def program_cost(fn, *args, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once and count its work: ``flops``,
    ``dot_flops``, ``bytes_accessed``, ``ops_without_cost``, and ``ops``
    (the ops counted) and ``kernel_calls`` (ported kernels by wrapper).
    The counts are exact for the op shapes this run dispatches; the
    kernels' are on this run's data (``cost()``)."""
    with _Counter() as c:
        fn(*args, **kwargs)
    return c.result()


def cost_summary(fn, *args, **kwargs) -> Dict[str, float]:
    """The library's own count of ``fn(*args, **kwargs)``:
    ``torch.utils.flop_counter.FlopCounterMode``'s total (matmuls,
    convolutions and attention only; the ported kernels' plain versions
    or launches as they run)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn(*args, **kwargs)
    return {"flops": float(fc.get_total_flops())}


def _storages(tree) -> Dict[Tuple[str, int], int]:
    """Distinct storages of the tensors in ``tree``: (device, ptr) ->
    bytes."""
    out = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        out[(str(t.device), st.data_ptr())] = st.nbytes()
    return out


def memory_summary(fn, *args, **kwargs) -> Dict[str, Any]:
    """Bytes of one run of ``fn(*args, **kwargs)``, under the reference's
    keys: ``argument_size_in_bytes`` and ``output_size_in_bytes`` (the
    distinct storages of the arguments and of the result),
    ``alias_size_in_bytes`` (result storages that are arguments'),
    ``temp_size_in_bytes`` (the peak above the arguments, less the result:
    from the CUDA allocator when an argument lies on the card, else the
    high-water mark of live op outputs under the dispatch mode), and
    ``temp_mb``, ``args_mb`` and ``peak_device_mb``."""
    arg_st = _storages((args, kwargs))
    cuda = any(dev.startswith("cuda") for dev, _ in arg_st)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
    else:
        with _Counter(track_live=True) as c:
            out = fn(*args, **kwargs)
        peak = c.peak_live
    out_st = _storages(out)
    args_b = sum(arg_st.values())
    out_b = sum(out_st.values())
    alias = sum(n for k, n in out_st.items() if k in arg_st)
    temp = max(peak - (out_b - alias), 0)
    return {"argument_size_in_bytes": int(args_b),
            "output_size_in_bytes": int(out_b),
            "alias_size_in_bytes": int(alias),
            "temp_size_in_bytes": int(temp),
            "temp_mb": round(temp / 1e6, 1),
            "args_mb": round(args_b / 1e6, 1),
            "peak_device_mb": round((args_b + temp + out_b - alias) / 1e6,
                                    1)}


# ---------------------------------------------------------------------------
# Collective bytes (``hlo.collective_bytes``)
# ---------------------------------------------------------------------------

def ring_bytes(kind: str, result_bytes: float, s: int) -> float:
    """Bytes a rank sends for one collective of group size ``s`` (the
    reference's ring model): all-reduce 2·R·(s-1)/s, all-gather R·(s-1)/s
    (R the gathered result), reduce-scatter R·(s-1) (R the scattered
    result), all-to-all R·(s-1)/s, collective-permute R."""
    frac = (s - 1) / s
    if kind == "all-reduce":
        return 2.0 * result_bytes * frac
    if kind == "all-gather":
        return result_bytes * frac
    if kind == "reduce-scatter":
        return result_bytes * (s - 1)
    if kind in ("all-to-all", "ragged-all-to-all", "collective-broadcast"):
        return result_bytes * frac
    return float(result_bytes)  # collective-permute


def collective_summary(events: List[dict]) -> Dict[str, Any]:
    """The reference's ``collective_bytes`` record of the collectives
    ``launch.mesh.record()`` collected: ``by_kind_bytes``,
    ``by_kind_count``, ``total_bytes``, ``total_gb``, and
    ``pod_axis_bytes`` (the traffic of collectives over the ``pod`` axis,
    the slow link between pods)."""
    by_bytes: Dict[str, float] = defaultdict(float)
    by_count: Dict[str, int] = defaultdict(int)
    pod = 0.0
    for ev in events:
        b = ring_bytes(ev["kind"], ev["result_bytes"], ev["group"])
        by_bytes[ev["kind"]] += b
        by_count[ev["kind"]] += 1
        if ev["axis"] == "pod":
            pod += b
    total = sum(by_bytes.values())
    return {"by_kind_bytes": {k: int(v) for k, v in by_bytes.items()},
            "by_kind_count": dict(by_count),
            "total_bytes": int(total), "total_gb": total / 1e9,
            "pod_axis_bytes": int(pod)}


def collective_bytes(fn, *args, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once and count, for this rank, the
    collectives it issues through ``launch.mesh`` (``collective_summary``).
    An all-reduce over a tuple of axes runs axis after axis and counts as
    one a non-trivial axis."""
    from repro_torch.launch import mesh as M
    with M.record() as events:
        fn(*args, **kwargs)
    return collective_summary(events)
