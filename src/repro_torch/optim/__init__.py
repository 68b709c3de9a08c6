from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adafactor, adamw, apply_updates, clip_by_global_norm,
    global_norm, make_optimizer,
)
