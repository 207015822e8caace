"""Deterministic shard-aware data pipeline (restart-exact)."""
from repro_torch.data.pipeline import DataConfig, SyntheticLM, make_batch  # noqa
