"""repro_torch.hub.packio and AdapterStore against repro.hub.

The ``.shpk`` v2 contract is byte identity in both directions: the port's
``save_pack`` writes the very bytes the JAX package writes for the same
entries (f32, bf16, int8), and each package loads the other's files. bf16
rounds to nearest even in both (torch's ``bfloat16`` here, ``ml_dtypes``
there), including at ties. The store's byte-budgeted LRU follows the JAX
store's order on the same sequence of gets.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.core.adapters import AdapterPack as JPack
from repro.hub import load_pack as j_load
from repro.hub import save_pack as j_save
from repro.models import lm as JLM
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core.adapters import AdapterPack
from repro_torch.hub import (AdapterStore, PackFormatError, QuantPack,
                             load_pack, peek_pack, quantize_pack, save_pack)
from repro_torch.launch import serve as t_serve
from repro_torch.models import lm as TLM

from test_torch_switching import _np_packs

MODES = ["f32", "bf16", "int8"]


def _synth(name="t0", seed=0, k=40, lead=(3,), nm=(64, 48)):
    """(path -> (idx, val)) numpy entries with stacked lead dims; values
    include exact bf16 ties (1 + 2^-8 lies halfway between two bf16s)."""
    rng = np.random.default_rng(seed)
    n, m = nm
    nl = int(np.prod(lead))
    idx = np.stack([rng.choice(n * m, k, replace=False)
                    for _ in range(nl)]).astype(np.int32)
    val = (0.05 * rng.standard_normal((nl, k))).astype(np.float32)
    val[0, :4] = [1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 2 ** -9]
    return {"stages/0/attn/wq": (idx.reshape(lead + (k,)),
                                 val.reshape(lead + (k,))),
            "embed/emb": (idx[0], val[0])}


def _packs(entries, name="t0", alpha=0.75):
    j = JPack(name=name, entries={p: (jnp.asarray(i), jnp.asarray(v))
                                  for p, (i, v) in entries.items()},
              alpha=alpha)
    return j, bridge.pack_from_numpy(name, entries, alpha, device="cpu")


def _same_pack(t: AdapterPack, j: JPack):
    assert t.name == j.name and t.alpha == j.alpha
    assert sorted(t.entries) == sorted(j.entries)
    for p, (ji, jv) in j.entries.items():
        ti, tv = t.entries[p]
        assert ti.dtype == torch.int32 and tv.dtype == torch.float32
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy().view(np.uint32),
                                      np.asarray(jv).view(np.uint32))


@pytest.mark.parametrize("values", MODES)
def test_save_pack_bytes_equal_jax(tmp_path, values):
    jp, tp = _packs(_synth())
    jf = j_save(jp, str(tmp_path / "j.shpk"), values=values)
    tf = save_pack(tp, str(tmp_path / "t.shpk"), values=values)
    assert open(tf, "rb").read() == open(jf, "rb").read()


@pytest.mark.parametrize("values", MODES)
def test_packs_load_across(tmp_path, values):
    """Each package loads the other's file into the same pack."""
    jp, tp = _packs(_synth(seed=1))
    jf = j_save(jp, str(tmp_path / "j.shpk"), values=values)
    tf = save_pack(tp, str(tmp_path / "t.shpk"), values=values)
    _same_pack(load_pack(jf), j_load(jf))
    _same_pack(load_pack(tf), j_load(jf))
    _same_pack(load_pack(jf), j_load(tf))


def test_model_pack_paths_and_bytes(tmp_path):
    """A real adapter of the smoke model: the port's own pack paths are the
    JAX ones, and a JAX pack crossed over saves to the same bytes."""
    cfg = j_smoke("starcoder2-7b")
    jparams = JLM.init_params(cfg, jax.random.PRNGKey(0))
    jpack = _np_packs(jparams, 1)[0]
    tparams = TLM.init_params(t_smoke("starcoder2-7b"), seed=0, device="cpu")
    own = t_serve.make_adapters(t_smoke("starcoder2-7b"), tparams, 1)[0]
    assert sorted(own.entries) == sorted(jpack.entries)
    tpack = bridge.pack_from_numpy(
        jpack.name, {p: (np.asarray(i), np.asarray(v))
                     for p, (i, v) in jpack.entries.items()}, jpack.alpha,
        device="cpu")
    for values in MODES:
        jf = j_save(jpack, str(tmp_path / f"j{values}.shpk"), values=values)
        tf = save_pack(tpack, str(tmp_path / f"t{values}.shpk"),
                       values=values)
        assert open(tf, "rb").read() == open(jf, "rb").read(), values


def test_int8_quantpack_matches_jax(tmp_path):
    jp, tp = _packs(_synth(k=120))
    jq = j_load(j_save(jp, str(tmp_path / "j.shpk"), values="int8"),
                dequantize=False)
    tq = load_pack(save_pack(tp, str(tmp_path / "t.shpk"), values="int8"),
                   dequantize=False)
    assert isinstance(tq, QuantPack) and tq.nbytes() == jq.nbytes()
    assert tp.nbytes() / tq.nbytes() >= 3.0
    for p, (ji, jvq, js) in jq.int8_tables().items():
        ti, tvq, ts = tq.int8_tables()[p]
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tvq, jvq)
        assert ts == js
    _same_pack(tq.dequantize(), jq.dequantize())
    mem = quantize_pack(tp)
    assert mem.nbytes() == tq.nbytes()


def test_int8_handles_duplicate_padding_indices(tmp_path):
    entries = {"embed/emb": (np.array([[0, 0, 0, 5, 900]], np.int32),
                             np.array([[0.0, 0.0, 0.1, -0.2, 0.3]],
                                      np.float32))}
    jp, tp = _packs(entries, name="dup", alpha=1.0)
    tf = save_pack(tp, str(tmp_path / "t.shpk"), values="int8")
    assert open(tf, "rb").read() == open(j_save(
        jp, str(tmp_path / "j.shpk"), values="int8"), "rb").read()
    _same_pack(load_pack(tf), j_load(tf))


def test_corrupted_pack_rejected(tmp_path):
    _, tp = _packs(_synth())
    f = save_pack(tp, str(tmp_path / "t0.shpk"), values="int8")
    raw = bytearray(open(f, "rb").read())
    raw[-1] ^= 0xFF
    (tmp_path / "bad.shpk").write_bytes(bytes(raw))
    with pytest.raises(PackFormatError, match="checksum"):
        load_pack(str(tmp_path / "bad.shpk"))
    (tmp_path / "trunc.shpk").write_bytes(bytes(raw[:-10]))
    with pytest.raises(PackFormatError, match="truncated"):
        load_pack(str(tmp_path / "trunc.shpk"))
    (tmp_path / "junk.shpk").write_bytes(b"not a pack at all......")
    with pytest.raises(PackFormatError, match="magic"):
        load_pack(str(tmp_path / "junk.shpk"))
    good = bytes(open(f, "rb").read())
    for cut in (10, 30):
        (tmp_path / "hdr.shpk").write_bytes(good[:cut])
        with pytest.raises(PackFormatError):
            load_pack(str(tmp_path / "hdr.shpk"))


def test_peek_reads_header_only(tmp_path):
    _, tp = _packs(_synth(), name="peeked")
    f = save_pack(tp, str(tmp_path / "p.shpk"), values="int8")
    h = peek_pack(f)
    assert h["name"] == "peeked" and h["values"] == "int8"
    assert sorted(h["entries"]) == sorted(tp.entries)


# ---------------------------------------------------------------------------
# AdapterStore
# ---------------------------------------------------------------------------

def test_store_lru_evicts_under_byte_budget(tmp_path):
    """The JAX store's eviction sequence, on the port's store."""
    packs = [_packs(_synth(name=f"a{i}", seed=i), name=f"a{i}")[1]
             for i in range(4)]
    one = quantize_pack(packs[0]).nbytes()
    store = AdapterStore(str(tmp_path / "store"), budget_bytes=2 * one
                         + one // 2)
    for p in packs:
        store.add(p, values="int8")
    assert store.names() == ["a0", "a1", "a2", "a3"]
    assert store.resident_bytes() == 0          # add() does not load
    store.get("a0")
    store.get("a1")
    assert store.loads == 2 and store.resident_names() == ["a0", "a1"]
    assert store.is_resident("a0") and not store.is_resident("a2")
    store.get("a2")                              # evicts the LRU, a0
    assert store.resident_names() == ["a1", "a2"] and store.evictions == 1
    assert store.resident_bytes() <= store.budget_bytes
    store.get("a1")
    store.get("a3")                              # evicts a2, not a1
    assert store.resident_names() == ["a1", "a3"]
    assert store.get("a0").name == "a0" and store.loads == 5
    assert isinstance(store.get_raw("a0"), QuantPack)
    assert store.evict("a0") and not store.is_resident("a0")


def test_store_get_and_register_file(tmp_path):
    jp, tp = _packs(_synth(name="exact"), name="exact")
    store = AdapterStore(str(tmp_path / "root"))
    store.add(tp, values="f32")
    _same_pack(store.get("exact"), jp)
    # a file the JAX package wrote registers lazily and loads the same
    f = j_save(jp, str(tmp_path / "elsewhere.shpk"), values="f32")
    other = AdapterStore(str(tmp_path / "root2"))
    assert other.register_file(f, name="reg") == "reg"
    assert other.resident_bytes() == 0 and "reg" in other
    assert other.get("reg").num_params() == tp.num_params()
    with pytest.raises(KeyError, match="nope"):
        other.get("nope")


def test_store_memory_only(tmp_path):
    _, tp = _packs(_synth(name="mem", k=120), name="mem")
    store = AdapterStore(root=None)
    store.add(tp)
    assert store.get("mem") is tp              # memory-only: same handle
    q = AdapterStore(root=None)
    q.add(tp, values="int8")
    assert q.resident_bytes() <= tp.nbytes() / 3
    with pytest.raises(ValueError, match="bf16"):
        q.add(tp, values="bf16")


def test_store_unported_tiers_raise(tmp_path):
    """Every tier of the store is ported now: quarantine fails a pack fast
    until it is cleared (the retry ladder is held to the JAX store in
    tests/test_torch_faults.py); publish, prefetch and the staging tier
    (tests/test_torch_prefetch.py and tests/test_torch_personalization.py
    hold them to the JAX store)."""
    from repro_torch.runtime.faults import AdapterUnavailable
    store = AdapterStore(str(tmp_path), staging_bytes=1 << 20)
    store.quarantine("a0")
    assert store.quarantined() == ["a0"]
    assert store.clear_quarantine("a0") and store.quarantined() == []
    assert store.resolve("a0") == "a0"
    _, tp = _packs(_synth(name="a0"), name="a0")
    assert store.publish(tp) == "a0@1" and store.resolve("a0") == "a0@1"
    assert store.prefetch("a0", dequantize=True).result().name == "a0@1"
    assert store.staged_names() == ["a0@1"]
    store.quarantine("a0")                     # the newest version
    with pytest.raises(AdapterUnavailable, match="quarantined"):
        store.get("a0@1")
    store.shutdown()
