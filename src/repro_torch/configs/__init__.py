from .base import (  # noqa: F401
    ArchConfig, MLASpec, MoESpec, SSMSpec, arch_from_dict, arch_to_dict,
    reduced_config,
)
from .registry import ARCHS, get_arch  # noqa: F401
