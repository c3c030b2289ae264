from .base import (ARCH_IDS, SHAPES, ArchConfig, InputShape, all_configs,
                   cell_supported, get_config)
