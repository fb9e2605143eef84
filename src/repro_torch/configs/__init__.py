"""Model configurations: the reference's schema and its ten
architectures."""
from .base import (ARCH_ALIASES, ARCH_IDS, MLACfg, ModelConfig,
                   MoECfg, SSMCfg, XLSTMCfg, get_config)

__all__ = ["ARCH_ALIASES", "ARCH_IDS", "MLACfg", "ModelConfig",
           "MoECfg", "SSMCfg", "XLSTMCfg", "get_config"]
