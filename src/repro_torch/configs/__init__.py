from repro_torch.configs.base import ArchConfig, ShapeSpec, SHAPES, get_config, list_archs
