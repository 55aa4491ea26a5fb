from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adam,
    adamw,
    sgd,
    global_norm,
    clip_by_global_norm,
)
from repro_torch.optim.schedules import (  # noqa: F401
    constant,
    cosine_decay,
    linear_warmup_cosine,
)
