"""repro_torch.hub: the adapter lifecycle from pack file to request.

Port of ``repro/hub``: the ``.shpk`` v2 pack format (``packio``: f32
bit-exact, bf16, int8 with delta-coded indices, byte for byte the
reference's files), the ``AdapterStore`` that keeps byte-budgeted LRU
tiers of resident and staged packs over those files, publishes versioned
ids and prefetches on a worker pool (``PrefetchHandle``), and the
continuous-batching engines that serve requests through it
(``ServingEngine`` over lanes, ``PagedServingEngine`` over a page pool;
versioned hot swap, async prefetch, ``slot_pad``), with the typed errors a
request can fail with (``runtime.faults``).
"""
from repro_torch.hub.packio import (PackFormatError, QuantPack,  # noqa: F401
                                    load_pack, peek_pack, quantize_pack,
                                    save_pack)
from repro_torch.hub.serving import (PagedServingEngine,  # noqa: F401
                                     ServeFuture, ServingEngine)
from repro_torch.hub.store import AdapterStore, PrefetchHandle  # noqa: F401
from repro_torch.runtime.faults import (AdapterUnavailable,  # noqa: F401
                                        RequestShed, ServingError,
                                        SlotPoisoned, StoreError,
                                        TableBuildError)
