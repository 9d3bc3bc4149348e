"""Pack format v2: versioned on-disk serialization for ``AdapterPack``.

Port of ``repro/hub/packio.py``, byte for byte: a pack saved here equals
the reference's file for the same entries, and either package reads the
other's files. The format is numpy and JSON, so this is the reference's
code with torch tensors at its edges: packs come in with tensors on any
device and load as CPU tensors (the engines move what they serve). bf16
values round to nearest even through torch's ``bfloat16``, as
``ml_dtypes`` does in the reference. Fault injection may corrupt a
payload as it is read (``runtime.faults.corrupt_payload``).

Layout of a ``.shpk`` file:

  magic "SHPKv2\\n\\0" (8 bytes)
  u64 little-endian header length
  header JSON  — name, alpha, value dtype, per-path array descriptors
                 (offsets into the payload), payload crc32
  payload      — the per-path idx/val blobs, back to back

Value storage modes (``values=``):

  f32   raw float32 values + raw int32 indices — byte-exact round trip.
  bf16  values rounded to bfloat16 (stored as u16), raw int32 indices.
  int8  values quantized symmetrically per path (q = round(v / scale),
        scale = max|v| / 127) and indices delta-compressed: each row of
        packed indices is sorted (values permuted with it — scatter-adds
        commute, so the adapter is unchanged), then the gaps are emitted as
        a uint8 stream where 255 means "add 255 and keep going". At SHiRA
        sparsities the mean gap is ~1/(1-sparsity), so almost every gap is
        one byte: ~2 bytes/entry against 8 for f32 (>= 3x smaller), which
        is what lets thousands of tenants stay disk- and HBM-resident.

Loading an int8 file with ``dequantize=False`` returns a :class:`QuantPack`
— the compressed resident form the ``AdapterStore`` budgets against —
whose ``dequantize()`` materializes a float32 ``AdapterPack`` for serving.

Writes are atomic (tmp file + ``os.replace``), same discipline as
the reference's checkpoints: a preempted save never corrupts a published
pack.
"""
from __future__ import annotations

import json
import os
import struct
import tempfile
import zlib
from dataclasses import dataclass
from typing import Dict, List, Tuple, Union

import numpy as np
import torch

from repro_torch.core.adapters import AdapterPack
from repro_torch.runtime import faults

MAGIC = b"SHPKv2\n\0"
VERSION = 2
VALUE_MODES = ("f32", "bf16", "int8")


class PackFormatError(ValueError):
    """Raised for bad magic, unsupported versions, or checksum mismatch."""


# ---------------------------------------------------------------------------
# Delta coding of sorted packed indices (int8 mode)
# ---------------------------------------------------------------------------

def _delta_encode_row(ix: np.ndarray) -> np.ndarray:
    """Sorted (k,) int64 flat indices -> uint8 gap stream (255 = +255)."""
    gaps = np.diff(ix, prepend=0)
    counts = gaps // 255
    total = int(counts.sum()) + ix.shape[0]
    out = np.full((total,), 255, np.uint8)
    out[np.cumsum(counts + 1) - 1] = (gaps % 255).astype(np.uint8)
    return out


def _delta_decode_row(buf: np.ndarray, k: int) -> np.ndarray:
    """uint8 gap stream -> (k,) int64 sorted flat indices."""
    b = buf.astype(np.int64)
    csum = np.cumsum(np.where(b == 255, 255, b))
    idx = csum[b != 255]
    if idx.shape[0] != k:
        raise PackFormatError(
            f"index stream decodes to {idx.shape[0]} entries, expected {k}")
    return idx


# ---------------------------------------------------------------------------
# Quantized resident form
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class QuantEntry:
    lead: Tuple[int, ...]       # leading (layer-stack) dims of the idx/val
    k: int                      # entries per matrix
    idx_stream: np.ndarray      # uint8, all rows' gap streams back to back
    row_lens: Tuple[int, ...]   # byte length of each row's stream
    vals_q: np.ndarray          # int8 (nl, k), sorted-index order
    scale: float                # per-path dequant scale


@dataclass(frozen=True)
class QuantPack:
    """An int8-quantized adapter as stored on disk: ~2 bytes per nonzero.

    Immutable. ``dequantize()`` materializes the float32 ``AdapterPack``
    view for the engines; the store keeps THIS form resident and budgets
    against ``nbytes()``."""

    name: str
    entries: Dict[str, QuantEntry]
    alpha: float = 1.0

    def num_params(self) -> int:
        return int(sum(e.vals_q.size for e in self.entries.values()))

    def nbytes(self) -> int:
        return int(sum(e.idx_stream.size + e.vals_q.size + 4
                       for e in self.entries.values()))

    def int8_tables(self) -> Dict[str, Tuple[np.ndarray, np.ndarray, float]]:
        """Decode per-path (idx (nl, k) int64, vals_q (nl, k) int8, scale)
        WITHOUT dequantizing values to f32 — the form
        ``MultiTenantEngine(table_dtype="int8")`` builds its device tables
        from, so a store-int8 adapter reaches VMEM with its original
        quantization (one rounding, at pack time)."""
        out = {}
        for path, e in self.entries.items():
            nl = max(int(np.prod(e.lead)), 1) if e.lead else 1
            idx = np.empty((nl, e.k), np.int64)
            off = 0
            for r, ln in enumerate(e.row_lens):
                idx[r] = _delta_decode_row(e.idx_stream[off:off + ln], e.k)
                off += ln
            out[path] = (idx, e.vals_q, e.scale)
        return out

    def dequantize(self) -> AdapterPack:
        entries = {}
        for path, (idx, vq, scale) in self.int8_tables().items():
            e = self.entries[path]
            vals = vq.astype(np.float32) * scale
            entries[path] = (
                torch.from_numpy(idx.astype(np.int32).reshape(e.lead
                                                              + (e.k,))),
                torch.from_numpy(vals.reshape(e.lead + (e.k,))))
        return AdapterPack(name=self.name, entries=entries, alpha=self.alpha)


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------

def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _as_2d(a, dtype) -> Tuple[np.ndarray, Tuple[int, ...], int]:
    a = _numpy(a)
    *lead, k = a.shape
    nl = max(int(np.prod(lead)), 1) if lead else 1
    return a.reshape(nl, k).astype(dtype), tuple(lead), k


def quantize_pack(pack: AdapterPack) -> QuantPack:
    """int8-quantize a pack in memory (the same transform ``save_pack``
    applies for ``values="int8"``): per-path symmetric scale, (idx, val)
    pairs sorted by index, gaps delta-coded to a uint8 stream."""
    entries = {}
    for path_key in sorted(pack.entries):
        idx, val = pack.entries[path_key]
        idx2, lead, k = _as_2d(idx, np.int64)
        val2 = _numpy(val).reshape(idx2.shape).astype(np.float32)
        order = np.argsort(idx2, axis=-1, kind="stable")
        idx_sorted = np.take_along_axis(idx2, order, axis=-1)
        val_sorted = np.take_along_axis(val2, order, axis=-1)
        amax = float(np.max(np.abs(val_sorted))) if val_sorted.size else 0.0
        scale = amax / 127.0 if amax > 0 else 1.0
        vq = np.clip(np.rint(val_sorted / scale), -127, 127).astype(np.int8)
        rows = [_delta_encode_row(idx_sorted[r])
                for r in range(idx_sorted.shape[0])]
        stream = np.concatenate(rows) if rows else np.zeros((0,), np.uint8)
        entries[path_key] = QuantEntry(
            lead=lead, k=k, idx_stream=stream,
            row_lens=tuple(int(r.size) for r in rows), vals_q=vq,
            scale=scale)
    return QuantPack(name=pack.name, entries=entries, alpha=pack.alpha)


def save_pack(pack: AdapterPack, path: str, values: str = "f32") -> str:
    """Serialize ``pack`` to ``path`` in format v2. Returns ``path``."""
    if values not in VALUE_MODES:
        raise ValueError(f"values must be one of {VALUE_MODES}, got {values!r}")
    blobs: List[bytes] = []
    off = 0
    entries = {}
    qpack = quantize_pack(pack) if values == "int8" else None
    for path_key in sorted(pack.entries):
        idx, val = pack.entries[path_key]
        idx2, lead, k = _as_2d(idx, np.int64)
        val2 = _numpy(val).reshape(idx2.shape).astype(np.float32)
        ent: Dict[str, object] = {"lead": list(lead), "k": k}

        if values == "int8":
            e = qpack.entries[path_key]
            ent["idx"] = {"enc": "d8", "off": off,
                          "len": int(e.idx_stream.size),
                          "row_lens": list(e.row_lens)}
            blobs.append(e.idx_stream.tobytes())
            off += e.idx_stream.size
            vb = e.vals_q.tobytes()
            ent["val"] = {"dtype": "int8", "off": off, "len": len(vb),
                          "scale": e.scale}
            blobs.append(vb)
            off += len(vb)
        else:
            ib = idx2.astype(np.int32).tobytes()
            ent["idx"] = {"enc": "i32", "off": off, "len": len(ib)}
            blobs.append(ib)
            off += len(ib)
            if values == "bf16":
                vb = torch.from_numpy(val2).to(torch.bfloat16).view(
                    torch.int16).numpy().tobytes()
                ent["val"] = {"dtype": "bfloat16", "off": off, "len": len(vb)}
            else:
                vb = val2.tobytes()
                ent["val"] = {"dtype": "float32", "off": off, "len": len(vb)}
            blobs.append(vb)
            off += len(vb)
        entries[path_key] = ent

    payload = b"".join(blobs)
    header = {
        "version": VERSION,
        "name": pack.name,
        "alpha": float(pack.alpha),
        "values": values,
        "payload_len": len(payload),
        "payload_crc32": zlib.crc32(payload) & 0xFFFFFFFF,
        "entries": entries,
    }
    hb = json.dumps(header).encode("utf-8")
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".shpk.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(MAGIC)
            f.write(struct.pack("<Q", len(hb)))
            f.write(hb)
            f.write(payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------

def _read_header(f) -> dict:
    magic = f.read(len(MAGIC))
    if magic != MAGIC:
        raise PackFormatError(f"bad magic {magic!r}: not a v2 adapter pack")
    raw = f.read(8)
    if len(raw) != 8:
        raise PackFormatError("truncated pack: header length missing")
    (hlen,) = struct.unpack("<Q", raw)
    hb = f.read(hlen)
    if len(hb) != hlen:
        raise PackFormatError(f"truncated pack header: {len(hb)}/{hlen} "
                              "bytes")
    try:
        header = json.loads(hb.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise PackFormatError(f"unreadable pack header: {e}") from e
    if header.get("version") != VERSION:
        raise PackFormatError(f"unsupported pack version "
                              f"{header.get('version')!r}")
    return header


def peek_pack(path: str) -> dict:
    """Header metadata only (name/alpha/values/entries) — no payload read.
    This is what lets the AdapterStore register thousands of packs lazily."""
    with open(path, "rb") as f:
        return _read_header(f)


def load_pack(path: str, dequantize: bool = True
              ) -> Union[AdapterPack, QuantPack]:
    """Read a v2 pack file. f32 round trips bit-exactly; int8 files return
    the compressed ``QuantPack`` when ``dequantize=False``."""
    with open(path, "rb") as f:
        header = _read_header(f)
        payload = f.read()
    # fault injection flips a payload byte here, so that the real crc32
    # check below is what rejects it
    payload = faults.corrupt_payload(path, payload)
    if len(payload) != header["payload_len"]:
        raise PackFormatError(
            f"payload truncated: {len(payload)} bytes, header says "
            f"{header['payload_len']}")
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    if crc != header["payload_crc32"]:
        raise PackFormatError(
            f"payload checksum mismatch: {crc:#x} != "
            f"{header['payload_crc32']:#x} (corrupted pack)")

    mode = header["values"]
    if mode == "int8":
        qentries = {}
        for path_key, ent in header["entries"].items():
            lead, k = tuple(ent["lead"]), ent["k"]
            nl = max(int(np.prod(lead)), 1) if lead else 1
            io = ent["idx"]
            stream = np.frombuffer(
                payload[io["off"]:io["off"] + io["len"]], np.uint8)
            vo = ent["val"]
            vq = np.frombuffer(
                payload[vo["off"]:vo["off"] + vo["len"]],
                np.int8).reshape(nl, k)
            qentries[path_key] = QuantEntry(
                lead=lead, k=k, idx_stream=stream,
                row_lens=tuple(io["row_lens"]), vals_q=vq,
                scale=vo["scale"])
        qp = QuantPack(name=header["name"], entries=qentries,
                       alpha=header["alpha"])
        return qp.dequantize() if dequantize else qp

    entries = {}
    for path_key, ent in header["entries"].items():
        lead, k = tuple(ent["lead"]), ent["k"]
        nl = max(int(np.prod(lead)), 1) if lead else 1
        io, vo = ent["idx"], ent["val"]
        idx = np.frombuffer(payload[io["off"]:io["off"] + io["len"]],
                            np.int32).reshape(nl, k)
        raw = payload[vo["off"]:vo["off"] + vo["len"]]
        if vo["dtype"] == "bfloat16":
            val = torch.from_numpy(np.frombuffer(raw, np.int16).copy()).view(
                torch.bfloat16).float().numpy().reshape(nl, k)
        else:
            val = np.frombuffer(raw, np.float32).reshape(nl, k)
        entries[path_key] = (torch.from_numpy(idx.reshape(lead + (k,)).copy()),
                             torch.from_numpy(val.reshape(lead + (k,)).copy()))
    return AdapterPack(name=header["name"], entries=entries,
                       alpha=header["alpha"])
