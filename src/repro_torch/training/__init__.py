# Multi-adapter training: concurrent packed-SHiRA finetunes and their
# quantized optimizer state.
from repro_torch.training import qstate  # noqa: F401
from repro_torch.training.multi import (MultiAdapterTrainer,  # noqa: F401
                                        multi_batch_iterator)
