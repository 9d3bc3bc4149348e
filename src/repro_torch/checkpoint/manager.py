"""Checkpointing: atomic, keep-K, device-independent, adapter-aware.

Port of ``repro/checkpoint/manager.py``, in its on-disk format, so that a
checkpoint written by either package restores in the other
(``tests/test_torch_checkpoint.py``). A tree's leaves are tensors, and
the trainers' step, a Python int. The tree is flattened to path ->
ndarray, keyed as the reference's ``path_str`` keys each leaf: its dict
keys and list indices joined by "/" (``core.masks.iter_leaves``, the
port's copy of that rule), and stored as one ``.npz`` plus a JSON
manifest. bf16 leaves are stored as their ``uint16`` view, since ``.npz``
has no bf16; the step as a 0-d int32, as the JAX state holds it. Writes
go to a temp directory, then ``os.replace``; a step's directory becomes
visible with its ``COMMITTED`` marker, written last, beside
``meta.json``.

``restore`` takes template trees (for structure, shapes and dtypes) and a
``device``, which takes the place of the reference's shardings: each leaf
lands on ``device``, or on its template's device when none is given, so a
checkpoint written from the card restores on the CPU and back (the port's
counterpart of the reference's restore onto another mesh). Device layout
is never written.

Adapter packs are first-class checkpoint artifacts (``save_adapter``,
``restore_adapter``): ``.shpk`` v2 files in the step's directory, through
``repro_torch.hub.packio``.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.masks import iter_leaves, map_leaves


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:   # npz has no bf16: its uint16 view
            return t.view(torch.int16).cpu().numpy().view(np.uint16)
        return t.cpu().numpy()
    return np.asarray(leaf, np.int32)   # the step, as the JAX state holds it


def flatten(tree) -> Dict[str, np.ndarray]:
    """path -> host ndarray of every leaf: the device-to-host copy of a
    save."""
    return {p: _to_numpy(x) for p, x in iter_leaves(tree)}


def save_tree(tree, directory: str, name: str = "state") -> str:
    os.makedirs(directory, exist_ok=True)
    flat = flatten(tree)
    tmp = tempfile.mkdtemp(dir=directory)
    try:
        np.savez(os.path.join(tmp, name + ".npz"), **flat)
        manifest = {
            "keys": sorted(flat.keys()),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": {k: str(v.dtype) for k, v in flat.items()},
            "time": time.time(),
        }
        with open(os.path.join(tmp, name + ".json"), "w") as f:
            json.dump(manifest, f)
        final_npz = os.path.join(directory, name + ".npz")
        final_json = os.path.join(directory, name + ".json")
        os.replace(os.path.join(tmp, name + ".npz"), final_npz)
        os.replace(os.path.join(tmp, name + ".json"), final_json)
        return final_npz
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _leaf_from(arr: np.ndarray, tpl, key: str, device):
    shape = tuple(tpl.shape) if hasattr(tpl, "shape") else ()
    if tuple(arr.shape) != shape:
        raise ValueError(
            f"{key}: checkpoint shape {arr.shape} != template {shape}")
    if isinstance(tpl, torch.Tensor):
        if tpl.dtype == torch.bfloat16 and arr.dtype == np.uint16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        return t.to(device if device is not None else tpl.device,
                    tpl.dtype)
    return int(arr)                     # the step


def restore_tree(template, directory: str, name: str = "state",
                 device=None):
    """The checkpoint's leaves in the template's structure, shapes and
    dtypes, on ``device`` (default: each template leaf's own). A missing
    leaf raises ``KeyError``, a shape that differs ``ValueError``."""
    with np.load(os.path.join(directory, name + ".npz")) as data:
        def leaf(key, tpl):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key}")
            return _leaf_from(data[key], tpl, key, device)
        return map_leaves(leaf, template)


class CheckpointManager:
    """Step-numbered checkpoints with atomic writes and keep-K GC."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.root, d, "COMMITTED")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def save(self, step: int, trees: Dict[str, Any],
             meta: Optional[dict] = None) -> str:
        d = self._step_dir(step)
        os.makedirs(d, exist_ok=True)
        for name, tree in trees.items():
            save_tree(tree, d, name)
        with open(os.path.join(d, "meta.json"), "w") as f:
            json.dump({"step": step, **(meta or {})}, f)
        # the commit marker makes partially written checkpoints invisible
        with open(os.path.join(d, "COMMITTED"), "w") as f:
            f.write(str(time.time()))
        self._gc()
        return d

    def restore(self, templates: Dict[str, Any], step: Optional[int] = None,
                device=None) -> Dict[str, Any]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {self.root}")
        d = self._step_dir(step)
        out = {"step": step}
        for name, tpl in templates.items():
            out[name] = restore_tree(tpl, d, name, device)
        return out

    # -- adapter packs: first-class checkpoint artifacts (.shpk v2) --------

    def save_adapter(self, step: int, pack, values: str = "f32") -> str:
        """Write an adapter pack into the step's directory. It becomes
        visible with the step's COMMITTED marker (written by ``save``), so
        adapter and optimizer state stay consistent."""
        from repro_torch.hub.packio import save_pack
        d = self._step_dir(step)
        os.makedirs(d, exist_ok=True)
        return save_pack(pack, os.path.join(d, f"adapter_{pack.name}.shpk"),
                         values=values)

    def adapters(self, step: int) -> List[str]:
        d = self._step_dir(step)
        if not os.path.isdir(d):
            return []
        return sorted(f[len("adapter_"):-len(".shpk")]
                      for f in os.listdir(d)
                      if f.startswith("adapter_") and f.endswith(".shpk"))

    def restore_adapter(self, name: str, step: Optional[int] = None,
                        dequantize: bool = True):
        from repro_torch.hub.packio import load_pack
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {self.root}")
        return load_pack(
            os.path.join(self._step_dir(step), f"adapter_{name}.shpk"),
            dequantize=dequantize)

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        # Uncommitted step directories older than the oldest kept
        # checkpoint are orphans: a save_adapter whose committing save
        # never ran (a preemption between the two). Newer ones stay: they
        # may be a save in progress.
        kept = steps[-self.keep:]
        floor = kept[0] if kept else None
        for d in os.listdir(self.root):
            if not d.startswith("step_"):
                continue
            try:
                s = int(d.split("_")[1])
            except ValueError:
                continue
            committed = os.path.exists(os.path.join(self.root, d, "COMMITTED"))
            if not committed and floor is not None and s < floor:
                shutil.rmtree(os.path.join(self.root, d), ignore_errors=True)
