from repro_torch.configs.base import (AdapterConfig, MLAConfig,  # noqa: F401
                                      ModelConfig, MoEConfig, RunConfig,
                                      SHAPES, ShapeSpec, SSMConfig,
                                      TrainConfig)
from repro_torch.configs.registry import (ARCH_IDS, all_cells,  # noqa: F401
                                          applicable_shapes, get_config,
                                          get_smoke_config)
