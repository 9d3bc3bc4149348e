from repro_torch.optim.adamw import (AdamWState,  # noqa: F401
                                     adamw_direction_, adamw_init,
                                     adamw_update, batched_global_norm,
                                     global_norm, lr_schedule)
