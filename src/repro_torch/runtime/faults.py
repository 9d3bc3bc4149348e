"""The serving failure taxonomy: typed errors a request can observe.

The port's own copy of the error classes of ``repro/runtime/faults.py``.
The hub engines and the adapter store raise them, and a failed request's
``ServeFuture.result()`` raises its typed error. Seeded fault injection,
the engine watchdog and the retry / quarantine / fallback ladder wait
(ROADMAP A8).
"""
from __future__ import annotations

from typing import Optional


class ServingError(RuntimeError):
    """Base of every typed serving failure a request can observe."""


class StoreError(ServingError):
    """An adapter pack failed to load (I/O, corruption, worker death)."""

    def __init__(self, msg: str, name: Optional[str] = None):
        super().__init__(msg)
        self.name = name


class AdapterUnavailable(ServingError):
    """The adapter is quarantined (or otherwise unservable) right now."""

    def __init__(self, msg: str, name: Optional[str] = None):
        super().__init__(msg)
        self.name = name


class RequestShed(ServingError):
    """Admission control rejected or expired the request (never silent)."""

    def __init__(self, msg: str, rid: Optional[int] = None,
                 reason: str = ""):
        super().__init__(msg)
        self.rid = rid
        self.reason = reason


class SlotPoisoned(ServingError):
    """Non-finite logits on this request's slot; the slot was quarantined."""

    def __init__(self, msg: str, rid: Optional[int] = None,
                 step: Optional[int] = None):
        super().__init__(msg)
        self.rid = rid
        self.step = step


class TableBuildError(ServingError):
    """Device table build failed; retried next step."""
