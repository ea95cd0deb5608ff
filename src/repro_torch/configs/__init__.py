"""Model configurations of the port."""

from repro_torch.configs.base import (INPUT_SHAPES, ArchConfig, InputShape,
                                      get_config, list_archs, register)

__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "register",
           "get_config", "list_archs"]
