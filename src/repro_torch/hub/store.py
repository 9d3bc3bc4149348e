"""AdapterStore: the adapter registry the serving engines load through.

Port of the synchronous tiers of ``repro/hub/store.py``. A store maps
adapter ids to ``.shpk`` pack files on disk (``hub.packio``) and keeps a
bounded working set resident in host memory; engines ask it by name and
get back an immutable ``AdapterPack``:

  store = AdapterStore(root, budget_bytes=64 << 20)
  store.add(pack, values="int8")        # serialize + register
  store.register_file("a0.shpk")        # register an existing file (lazy)
  engine.register(store.get("a0"))      # or engine.register("a0")

Tiers: the registered files on disk (never dropped), and the resident
forms in host memory under ``budget_bytes``, least recently used first
out. The resident form is what the file stores: f32 packs stay f32, int8
packs stay in their ~2-byte-a-nonzero ``QuantPack`` form (``get``
dequantizes, ``get_raw`` does not). Packs added with ``pin=True``, or kept
in memory by a store with no root, are never evicted.

Not ported, each raising ``NotImplementedError`` with its ROADMAP item:
the staging tier and async ``prefetch`` (A5), ``publish`` and versioned
ids (A7; an id resolves to itself), quarantine and the load-retry ladder
(A8).
"""
from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, List, Optional, Union

from repro_torch.core.adapters import AdapterPack
from repro_torch.hub.packio import (QuantPack, load_pack, peek_pack,
                                    quantize_pack, save_pack)


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"AdapterStore {what} is not ported "
                              f"(ROADMAP {item})")


class AdapterStore:
    def __init__(self, root: Optional[str] = None,
                 budget_bytes: Optional[int] = None,
                 staging_bytes: Optional[int] = None):
        if staging_bytes is not None:
            _not_ported("staging tier", "A5")
        self.root = root
        if root is not None:
            os.makedirs(root, exist_ok=True)
        self.budget_bytes = budget_bytes
        self._paths: Dict[str, Optional[str]] = {}    # id -> file (None = mem)
        self._pinned: set = set()
        # id -> resident AdapterPack | QuantPack, LRU order (oldest first)
        self._resident: "OrderedDict[str, Union[AdapterPack, QuantPack]]" \
            = OrderedDict()
        self.loads = 0                                # disk loads (cache miss)
        self.evictions = 0

    # ------------------------------------------------------------------
    # Registration
    # ------------------------------------------------------------------

    def add(self, pack: AdapterPack, values: str = "f32",
            pin: bool = False) -> str:
        """Serialize ``pack`` into the store's root (or keep it in memory if
        the store has no root) and register it. Returns the adapter id."""
        if self.root is None:
            if values == "bf16":
                raise ValueError("bf16 pack storage needs a file-backed "
                                 "store (root=None holds f32 or int8)")
            form = quantize_pack(pack) if values == "int8" else pack
            self._paths[pack.name] = None
            self._pinned.add(pack.name)               # nothing to reload from
            self._admit(pack.name, form)
            return pack.name
        path = os.path.join(self.root, f"{pack.name}.shpk")
        save_pack(pack, path, values=values)
        self._paths[pack.name] = path
        if pin:
            self._pinned.add(pack.name)
        self._resident.pop(pack.name, None)           # re-add replaces
        return pack.name

    def register_file(self, path: str, name: Optional[str] = None,
                      pin: bool = False) -> str:
        """Register an existing pack file without reading its payload."""
        name = name or peek_pack(path)["name"]
        self._paths[name] = path
        if pin:
            self._pinned.add(name)
        self._resident.pop(name, None)
        return name

    def resolve(self, name: str) -> str:
        """Id resolution: every id resolves to itself (versioned ids and
        newest-wins resolution wait with ``publish``, ROADMAP A7)."""
        return name

    def publish(self, pack: AdapterPack, values: str = "f32",
                pin: bool = False) -> str:
        _not_ported("publish / versioned ids", "A7")

    def prefetch(self, name: str, dequantize: bool = False):
        _not_ported("async prefetch", "A5")

    def quarantine(self, name: str, reason: str = "manual") -> None:
        _not_ported("quarantine", "A8")

    # ------------------------------------------------------------------
    # Lookup
    # ------------------------------------------------------------------

    def names(self) -> List[str]:
        return sorted(self._paths)

    def __contains__(self, name: str) -> bool:
        return name in self._paths

    def is_resident(self, name: str) -> bool:
        """Host-memory tier hit test, without an LRU touch."""
        return name in self._resident

    def get(self, name: str) -> AdapterPack:
        """Immutable f32 pack; loads from disk (evicting LRU residents past
        the byte budget) on a miss. Quantized packs dequantize here."""
        form = self.get_raw(name)
        return form.dequantize() if isinstance(form, QuantPack) else form

    def get_raw(self, name: str) -> Union[AdapterPack, QuantPack]:
        """The resident form as stored: an int8 pack comes back as its
        ``QuantPack`` (what ``MultiTenantEngine(table_dtype="int8")``
        builds its tables from), f32 and bf16 packs as ``AdapterPack``."""
        if name not in self._paths:
            raise KeyError(f"unknown adapter {name!r}; registered: "
                           f"{self.names()}")
        form = self._resident.get(name)
        if form is not None:
            self._resident.move_to_end(name)
            return form
        form = load_pack(self._paths[name], dequantize=False)
        self.loads += 1
        self._admit(name, form)
        return form

    # ------------------------------------------------------------------
    # Residency accounting
    # ------------------------------------------------------------------

    def resident_bytes(self) -> int:
        return sum(f.nbytes() for f in self._resident.values())

    def resident_names(self) -> List[str]:
        """LRU order, oldest first."""
        return list(self._resident)

    def _admit(self, name: str, form) -> None:
        self._resident[name] = form
        self._resident.move_to_end(name)
        if self.budget_bytes is None:
            return
        while self.resident_bytes() > self.budget_bytes:
            # never evict the newcomer or pinned packs
            victim = next((n for n in self._resident
                           if n != name and n not in self._pinned), None)
            if victim is None:
                break
            del self._resident[victim]
            self.evictions += 1

    def evict(self, name: str) -> bool:
        """Drop a resident form explicitly (the file stays registered)."""
        if name in self._resident and self._paths.get(name) is not None:
            del self._resident[name]
            self.evictions += 1
            return True
        return False
