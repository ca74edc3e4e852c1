from .base import (INPUT_SHAPES, PORTED_ARCH_IDS, InputShape, ModelConfig,
                   MoEConfig, SSMConfig, get_config, get_smoke_config)
