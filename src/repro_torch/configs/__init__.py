from repro_torch.configs.base import (ARCHS, SHAPES, ModelConfig,
                                      ShapeConfig, get_config,
                                      get_smoke_config)

__all__ = ["ARCHS", "ModelConfig", "ShapeConfig", "SHAPES", "get_config",
           "get_smoke_config"]
