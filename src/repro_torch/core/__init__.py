# SHiRA core: packed masks, adapter packs, rapid switching and fusion.
from repro_torch.core.adapters import (AdapterPack, apply_pack,  # noqa: F401
                                       init_adapter, materialize,
                                       pack_from_shira)
from repro_torch.core.fusion import fuse_packs, index_overlap  # noqa: F401
from repro_torch.core.masks import (gather_packed,  # noqa: F401
                                    make_packed_indices, scatter_packed_add)
from repro_torch.core.switching import (FusedLRU, SwitchEngine,  # noqa: F401
                                        SwitchStats, normalize_tenant,
                                        tenant_key, tenant_members)
