from repro_torch.configs.registry import (  # noqa: F401
    ARCH_IDS, get_config, get_smoke, expert_parallel_ok,
)
from repro_torch.configs.shapes import (  # noqa: F401
    SHAPES, ShapeConfig, applicable_shapes,
)
