"""deepseek-v2-236b [arXiv:2405.04434; hf]: MLA (kv_lora 512, rope dim 64,
q_lora 1536) + MoE with 2 shared + 160 routed experts top-6
(d_ff_expert 1536); first layer dense (d_ff 12288)."""
from repro_torch.models.config import (BlockKind, MLAConfig, ModelConfig,
                                       MoEConfig)

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    head_dim=128, d_ff=1536, vocab=102400,
    pattern=(BlockKind.ATTN,),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536,
                  n_shared_experts=2, d_ff_shared=3072),
    first_layer_dense_ff=12288,
)
