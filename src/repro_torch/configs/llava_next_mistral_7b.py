"""llava-next-mistral-7b [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]:
Mistral-7B text backbone (GQA kv=8, SWA 4096 interleaved as in Mistral
v0.1 — modeled as local attention on all layers per Mistral) with an anyres
vision frontend STUB: `input_specs()` supplies precomputed patch embeddings
(projected by a learned adapter); 576 base + anyres grid tokens prefix the
text sequence."""
from repro_torch.models.config import BlockKind, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000,
    pattern=(BlockKind.ATTN_LOCAL,),
    local_window=4096,
    frontend="patches", frontend_prefix_len=1152,  # 576 base + 576 anyres
)
