"""qwen2-0.5b [arXiv:2407.10671; hf]: GQA kv=2, QKV bias, tied embeddings."""
from repro_torch.models.config import BlockKind, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab=151936,
    pattern=(BlockKind.ATTN,),
    qkv_bias=True, tie_embeddings=True,
    rope_theta=1e6,
)
