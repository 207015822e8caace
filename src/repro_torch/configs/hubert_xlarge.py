"""hubert-xlarge [arXiv:2106.07447; unverified]: encoder-only (bidirectional,
non-causal) transformer over precomputed frame embeddings (the CNN feature
extractor is the STUB frontend); frame-level classification head over 504
cluster targets.  No decode shapes (no autoregressive step): the port
trains it (``launch.train``) and its serving engines refuse it."""
from repro_torch.models.config import BlockKind, ModelConfig, RopeMode

CONFIG = ModelConfig(
    name="hubert-xlarge",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab=504,
    pattern=(BlockKind.ATTN,),
    causal=False, rope_mode=RopeMode.NONE,
    frontend="frames", act="gelu",
)
