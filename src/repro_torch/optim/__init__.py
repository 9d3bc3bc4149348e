from repro_torch.optim.adamw import (AdamWState, adamw_init,  # noqa: F401
                                     adamw_update, batched_global_norm,
                                     global_norm, lr_schedule)
