from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: F401
