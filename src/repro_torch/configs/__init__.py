from repro_torch.configs.base import (LONG_CONTEXT_ARCHS, SHAPES, EncoderConfig,
                                MLAConfig, ModelConfig, MoEConfig, ShapeCell,
                                SSMConfig)
from repro_torch.configs.registry import ARCH_IDS, all_configs, get_config, reduced
