"""The kernel wrappers' report to an active program-cost counter.

``analysis.profile.program_cost`` counts the work of the ops a function
dispatches. A call of a ported kernel counts as its wrapper's ``cost()``
(the work the kernel does: ``{"flops", "bf16_flops", "bytes_accessed"}``)
and none of the ops the wrapper runs within: its plain version on CPU
tensors, its operand preparation on CUDA tensors. So a function's count
is the same on either device.

``counted(cost)`` wraps a wrapper so; ``uncounted()`` hides operand
preparation that a caller does for the kernel calls that follow (the
sidedelta backward's grouping). With no counter active both cost one list
check. ``on_meta()`` lets the dry run's "meta" tensors through the
wrappers (``plain_device``).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, List

_ACTIVE: List = []      # counters, innermost last (analysis.profile)
_ON_META = [0]          # depth of on_meta() contexts


def push(counter) -> None:
    _ACTIVE.append(counter)


def pop(counter) -> None:
    _ACTIVE.remove(counter)


def active():
    """The innermost active counter, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def counted(cost: Callable[..., dict], name: str, dots: bool = False):
    """Decorate a kernel wrapper: under an active counter, a call adds
    ``cost(*args, **kwargs)`` as one call of kernel ``name`` (its
    operations to the counter's dot products too when ``dots``:
    attention's q . k and p . v) and counts none of the ops the call
    runs. A call inside another counted call or ``uncounted()`` adds
    nothing."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            c = active()
            if c is None or c.paused:
                return fn(*args, **kwargs)
            c.pause()
            try:
                c.add_kernel(name, cost(*args, **kwargs), dots)
                return fn(*args, **kwargs)
            finally:
                c.resume()
        return call
    return wrap


@contextlib.contextmanager
def uncounted():
    """Ops run here belong to the kernel calls that follow."""
    c = active()
    if c is None:
        yield
        return
    c.pause()
    try:
        yield
    finally:
        c.resume()


@contextlib.contextmanager
def on_meta():
    """Let the kernel wrappers take "meta" tensors (the dry run, which
    runs a step on shapes only): there they compute their plain version,
    which on meta tensors only carries the shapes through. Outside it a
    meta tensor raises, as any device but the CPU and CUDA does."""
    _ON_META[0] += 1
    try:
        yield
    finally:
        _ON_META[0] -= 1


def plain_device(device) -> bool:
    """Whether a wrapper computes its plain version on ``device``: the
    CPU, or "meta" inside ``on_meta()``."""
    return device.type == "cpu" or (device.type == "meta"
                                    and _ON_META[0] > 0)
