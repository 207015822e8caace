"""chatglm3-6b [arXiv:2406.12793; hf]: 2d RoPE (rotary over half the head
dims), GQA kv=2."""
from repro_torch.models.config import BlockKind, ModelConfig, RopeMode

CONFIG = ModelConfig(
    name="chatglm3-6b",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab=65024,
    pattern=(BlockKind.ATTN,),
    rope_mode=RopeMode.HALF,
    qkv_bias=True,  # chatglm: bias on qkv only
)
