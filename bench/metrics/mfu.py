"""The model's useful operations in the traced window over the window times
the card's peak at the configuration's precision (%): int8 operations of
every image through the whole network; or LM FLOPs, the layers at every
token, causal attention at each position's context, the head where a token
is produced."""

from bench.readers import mfu as read  # noqa: F401
