# Adapter core: SHiRA masks (packed and dense), adapter packs, rapid
# switching and fusion; LoRA, DoRA and SHiRA-DoRA, and the LoRA fuse.
from repro_torch.core.adapters import (AdapterPack, apply_pack,  # noqa: F401
                                       init_adapter, materialize,
                                       pack_from_delta, pack_from_shira)
from repro_torch.core.fusion import fuse_packs, index_overlap  # noqa: F401
from repro_torch.core.masks import (dense_mask_from_indices,  # noqa: F401
                                    gather_packed, make_dense_masks,
                                    make_packed_indices, map_targets,
                                    mask_grads, mask_sparsity,
                                    scatter_packed_add, scatter_packed_set,
                                    target_paths)
from repro_torch.core.switching import (FusedLRU, LoraEngine,  # noqa: F401
                                        SwitchEngine, SwitchStats,
                                        changed_fraction,
                                        normalize_tenant, tenant_key,
                                        tenant_members)
