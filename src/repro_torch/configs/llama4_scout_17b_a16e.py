"""llama4-scout-17b-16e [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]:
MoE 16 routed experts top-1 + shared expert on every layer; GQA kv=8,
head_dim 128.  iRoPE/chunked-attention and early-fusion vision are
approximated as standard RoPE + text-only, as in the reference."""
from repro_torch.models.config import BlockKind, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-16e",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    head_dim=128, d_ff=8192, vocab=202048,
    pattern=(BlockKind.ATTN,),
    moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192,
                  n_shared_experts=1, d_ff_shared=8192),
    rope_theta=5e5,
)
