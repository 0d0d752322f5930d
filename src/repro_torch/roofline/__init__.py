from repro_torch.roofline.analysis import (  # noqa: F401
    collective_bytes,
    model_flops,
    roofline_terms,
)
from repro_torch.roofline import hw  # noqa: F401
