"""Live images over bucket slots of the batches the engine dispatched in the window (deltas of stats()['bucket_fill'])."""

from gpubench.layers import batch_fill_pct as read  # noqa: F401
