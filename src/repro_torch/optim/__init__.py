from repro_torch.optim.optimizers import Optimizer, adamw, sgd  # noqa: F401
from repro_torch.optim.schedules import (  # noqa: F401
    constant,
    cosine,
    exponential_decay,
    warmup_cosine,
)
