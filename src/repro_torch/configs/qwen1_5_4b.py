"""qwen1.5-4b [hf:Qwen/Qwen1.5-4B; hf]: dense, QKV bias, effectively MHA
(kv == heads per the assignment)."""
from repro_torch.models.config import BlockKind, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20,
    d_ff=6912, vocab=151936,
    pattern=(BlockKind.ATTN,),
    qkv_bias=True,
    rope_theta=1e6,  # qwen1.5 long-rope base
)
