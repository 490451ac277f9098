"""Optimizers of the port (functional, over parameter trees) and the
A2Q+ projection, the copy of ``repro.optim``."""

from repro_torch.optim.a2q import (  # noqa: F401
    a2q_l1_ratio,
    a2q_project_tree,
    with_a2q_projection,
)
from repro_torch.optim.optim import (  # noqa: F401
    OptState,
    Optimizer,
    adamw,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    linear_warmup,
    sgd_momentum,
)
