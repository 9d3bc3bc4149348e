from repro_torch.configs.base import (AdapterConfig, MLAConfig,  # noqa: F401
                                      ModelConfig, MoEConfig, RunConfig,
                                      ShapeSpec, SSMConfig, TrainConfig)
from repro_torch.configs.registry import (ARCH_IDS, get_config,  # noqa: F401
                                          get_smoke_config)
