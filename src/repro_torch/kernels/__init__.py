"""The port's kernels (sidedelta and its gradient, scatter_apply,
sparse_adamw, flash_decode, flash_prefill, masked_update), their plain
versions, and their build."""
