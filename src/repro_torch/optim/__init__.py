"""Optimizer substrate (no ``torch.optim``; port of ``repro.optim``):
AdamW, schedules, clipping, and int8 gradient compression with error
feedback, on nested dicts of tensors."""

from repro_torch.optim.adamw import (  # noqa: F401
    OptState, adamw_init, adamw_update, clip_by_global_norm,
    clip_by_global_norm_, global_norm)
from repro_torch.optim.schedule import cosine_warmup  # noqa: F401
from repro_torch.optim.compression import (  # noqa: F401
    compress_state_init, compress_decompress)
