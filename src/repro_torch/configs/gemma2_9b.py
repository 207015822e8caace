"""gemma2-9b [arXiv:2408.00118; hf]: alternating local(4096)/global
attention, logit softcaps, GeGLU, sandwich norms, head_dim 256,
scaled embeddings, tied head."""
from repro_torch.models.config import BlockKind, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8,
    head_dim=256, d_ff=14336, vocab=256000,
    pattern=(BlockKind.ATTN_LOCAL, BlockKind.ATTN),
    local_window=4096,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    post_norms=True, act="gelu",
    tie_embeddings=True, scale_embeddings=True,
)
