from repro_torch.serving.kvcache import (PagePool, QuantKV,  # noqa: F401
                                         cache_bytes, copy_page,
                                         dequantize_kv, paged_gather,
                                         paged_write, pages_for, pool_zeros,
                                         quant_cache_zeros, quantize_kv,
                                         update_quant_cache)
from repro_torch.serving.loadgen import (GenRequest, LoadGen,  # noqa: F401
                                         LoadReport, Phase)
from repro_torch.serving.multitenant import MultiTenantEngine  # noqa: F401
