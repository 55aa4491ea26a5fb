from repro_torch.models.model import (  # noqa: F401
    cache_specs,
    decode_step,
    forward,
    init,
    init_cache,
    loss_fn,
    n_active_params,
    n_params,
    param_specs,
    prefill,
)
from repro_torch.models.spec import (  # noqa: F401
    TensorSpec,
    abstract_params,
    count_params,
    init_params,
)
