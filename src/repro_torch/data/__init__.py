from repro_torch.data.pipeline import (TaskSpec, batch_iterator,  # noqa: F401
                                       make_batch)
