from repro_torch.parallel.sharding import (
    MeshEnv,
    current_env,
    logical_to_spec,
    null_env,
    param_shardings,
    resolve_spec,
    shard,
    use_env,
)

__all__ = [
    "MeshEnv",
    "current_env",
    "logical_to_spec",
    "null_env",
    "param_shardings",
    "resolve_spec",
    "shard",
    "use_env",
]
