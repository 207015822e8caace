"""Optimizer substrate: AdamW + schedules + int8 gradient compression."""
from repro_torch.optim import adamw, compression  # noqa
