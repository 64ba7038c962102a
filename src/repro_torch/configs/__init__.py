from repro_torch.configs.registry import (  # noqa: F401
    ARCH_IDS, get_config, get_smoke, expert_parallel_ok,
)
