"""Deterministic, seekable, shard-aware synthetic LM data pipeline (a copy
of ``repro.data.pipeline``: numpy only, byte-identical batches).

Restart-exactness is the fault-tolerance contract: ``batch_at(step)`` is a
pure function of (seed, step), so a job restored from a step-N checkpoint
replays byte-identical batches with no data-loader state to save.  Each host
materializes only its shard (``host_batch_at``); the port trains on one
device, so its training loop builds the global batch.

The generator mimics real tokenized text: Zipf-distributed token ids over
the vocab, document boundaries (EOS + padding-free packing), and labels =
inputs shifted by one with boundary masking.  Frontend stubs: llava's
patch embeddings (``patches``) and hubert's frame embeddings and frame
labels (``frames``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models.config import ModelConfig

EOS = 2
MASK_LABEL = -1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 17
    mean_doc_len: int = 512
    zipf_a: float = 1.2


class SyntheticLM:
    """Packed LM batches.  All methods are pure in (config, step)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def _rng(self, step: int, row: int) -> np.random.Generator:
        # counter-based: independent stream per (step, row)
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, row]))

    def _row(self, step: int, row: int) -> tuple[np.ndarray, np.ndarray]:
        c = self.cfg
        rng = self._rng(step, row)
        toks = np.empty(c.seq_len + 1, np.int32)
        i = 0
        while i < c.seq_len + 1:
            dl = max(8, int(rng.exponential(c.mean_doc_len)))
            dl = min(dl, c.seq_len + 1 - i)
            # Zipf over [3, vocab): 0/1/2 reserved (pad/bos/eos)
            z = rng.zipf(c.zipf_a, size=dl).astype(np.int64)
            toks[i:i + dl] = 3 + (z % (c.vocab - 3))
            i += dl
            if i < c.seq_len + 1:
                toks[i - 1] = EOS
        inputs = toks[:-1]
        labels = toks[1:].astype(np.int32)
        labels = np.where(inputs == EOS, MASK_LABEL, labels)
        return inputs, labels

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        c = self.cfg
        rows = [self._row(step, r) for r in range(c.global_batch)]
        return {"tokens": np.stack([r[0] for r in rows]),
                "labels": np.stack([r[1] for r in rows])}

    def host_batch_at(self, step: int, host_id: int, n_hosts: int
                      ) -> dict[str, np.ndarray]:
        """Only this host's rows (row-contiguous sharding)."""
        c = self.cfg
        assert c.global_batch % n_hosts == 0, (c.global_batch, n_hosts)
        per = c.global_batch // n_hosts
        rows = [self._row(step, host_id * per + r) for r in range(per)]
        return {"tokens": np.stack([r[0] for r in rows]),
                "labels": np.stack([r[1] for r in rows])}


def make_batch(cfg: ModelConfig, data: DataConfig, step: int,
               rng_frontend: np.random.Generator | None = None
               ) -> dict[str, np.ndarray]:
    """Arch-aware batch (adds stub frontend tensors where required)."""
    ds = SyntheticLM(data)
    rng = rng_frontend or np.random.default_rng(
        np.random.SeedSequence([data.seed, step, 1 << 20]))
    if cfg.frontend == "frames":
        frames = rng.standard_normal(
            (data.global_batch, data.seq_len, cfg.d_model)).astype(np.float32)
        labels = rng.integers(0, cfg.vocab,
                              (data.global_batch, data.seq_len)).astype(np.int32)
        return {"frames": frames, "labels": labels}
    b = ds.batch_at(step)
    if cfg.frontend == "patches":
        P = cfg.frontend_prefix_len
        s_text = data.seq_len - P
        patches = rng.standard_normal(
            (data.global_batch, P, cfg.d_model)).astype(np.float32) * 0.02
        return {"tokens": b["tokens"][:, :s_text],
                "patches": patches,
                "labels": b["labels"][:, :s_text]}
    return b
