from .optimizers import (  # noqa: F401
    Optimizer,
    adamw,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    sgdm,
)
from .schedules import constant, cosine, step_decay  # noqa: F401
