from .base import (  # noqa: F401
    ArchConfig, MLASpec, MoESpec, SSMSpec, SHAPE_CELLS, ShapeCell,
    arch_from_dict, arch_to_dict, cell_supported, input_specs, reduced_config,
)
from .registry import ARCHS, get_arch  # noqa: F401
