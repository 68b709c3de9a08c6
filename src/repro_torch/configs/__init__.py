"""Architecture registry + input shapes (the assigned 10 x 4 grid)."""

from repro_torch.configs.registry import (  # noqa: F401
    ARCH_IDS, SHAPES, Shape, applicable_shapes, get_config, get_smoke,
    input_specs, modality_inputs, smoke_batch, train_config,
)
