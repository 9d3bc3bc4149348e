"""The serving path's kernels (sidedelta, scatter_apply), their plain
versions, and their build."""
