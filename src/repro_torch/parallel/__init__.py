from repro_torch.parallel.sharding import (  # noqa: F401
    axis_rules_for_mesh,
    constrain,
    current_mesh,
    param_sharding,
    physical_spec,
    place,
    placements,
    use_mesh,
)
