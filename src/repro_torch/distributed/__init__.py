from repro_torch.distributed.partitioner import (  # noqa: F401
    AxisRules, Partitioner, current_partitioner, logical_constraint,
    make_rules, set_partitioner,
)
