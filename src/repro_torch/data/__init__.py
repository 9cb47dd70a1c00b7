from repro_torch.data.pipeline import (  # noqa: F401
    SyntheticLMData, batch_for_shape, make_prefetcher)
