"""repro_torch.hub: the adapter lifecycle from pack file to request.

Port of ``repro/hub``'s synchronous path: the ``.shpk`` v2 pack format
(``packio``: f32 bit-exact, bf16, int8 with delta-coded indices, byte for
byte the reference's files), the ``AdapterStore`` that keeps a byte-budgeted
LRU of resident packs over those files, and the continuous-batching
engines that serve requests through it (``ServingEngine`` over lanes,
``PagedServingEngine`` over a page pool), with the typed errors a request
can fail with.
"""
from repro_torch.hub.packio import (PackFormatError, QuantPack,  # noqa: F401
                                    load_pack, peek_pack, quantize_pack,
                                    save_pack)
from repro_torch.hub.serving import (PagedServingEngine,  # noqa: F401
                                     ServeFuture, ServingEngine)
from repro_torch.hub.store import AdapterStore  # noqa: F401
from repro_torch.runtime.faults import (AdapterUnavailable,  # noqa: F401
                                        RequestShed, ServingError,
                                        SlotPoisoned, StoreError,
                                        TableBuildError)
