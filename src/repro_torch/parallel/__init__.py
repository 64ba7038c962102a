from repro_torch.parallel.sharding import (  # noqa: F401
    ShardingRules, make_shard_fn, param_specs, batch_spec,
)
