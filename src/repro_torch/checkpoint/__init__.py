# Checkpoints: atomic, keep-K, device-independent, adapter-aware; the
# reference's on-disk format.
from repro_torch.checkpoint.manager import (CheckpointManager,  # noqa: F401
                                            flatten, restore_tree, save_tree)
