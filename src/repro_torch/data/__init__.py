from repro_torch.data.partition import (  # noqa: F401
    label_histograms,
    partition_dirichlet,
    partition_iid,
)
from repro_torch.data.synthetic import (  # noqa: F401
    DATASET_SPECS,
    ImageDataset,
    load_dataset,
    make_image_dataset,
    make_token_stream,
)
