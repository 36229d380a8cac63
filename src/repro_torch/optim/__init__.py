from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adamw,
    lr_at,
    make_optimizer,
    sgd_momentum,
)
