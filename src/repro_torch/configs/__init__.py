"""Model configurations: the reference's schema, and the ported
architectures."""
from .base import (ARCH_ALIASES, ARCH_IDS, PORTED, MLACfg, ModelConfig,
                   MoECfg, SSMCfg, XLSTMCfg, get_config)

__all__ = ["ARCH_ALIASES", "ARCH_IDS", "PORTED", "MLACfg", "ModelConfig",
           "MoECfg", "SSMCfg", "XLSTMCfg", "get_config"]
