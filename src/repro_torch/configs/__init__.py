from .base import ARCH_IDS, ArchConfig, InputShape, all_configs, get_config
