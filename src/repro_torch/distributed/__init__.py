"""Logical-axis sharding of the port (``sharding.py``)."""
from repro_torch.distributed.sharding import (  # noqa: F401
    ParamDef,
    ShardingRules,
    default_rules,
    init_params,
    logical_to_spec,
    param_shardings,
    param_specs,
    tree_size_bytes,
)
