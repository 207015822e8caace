"""Async, restart-exact checkpointing on the reference's layout."""
from repro_torch.checkpoint.manager import CheckpointManager  # noqa
