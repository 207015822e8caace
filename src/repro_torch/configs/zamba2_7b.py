"""zamba2-7b [arXiv:2411.15242; unverified]: Mamba2 backbone with shared
attention blocks.  Modeled as 13 repeats of [5x mamba2 + shared-attn] plus a
3-layer mamba2 tail = 81 layers; the shared attention alternates between 2
weight sets (the paper's 'two alternating shared blocks')."""
from repro_torch.models.config import BlockKind, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000, head_dim=112,
    pattern=(BlockKind.MAMBA2,) * 5 + (BlockKind.SHARED_ATTN,),
    tail=(BlockKind.MAMBA2,) * 3,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1),
    n_shared_attn_sets=2,
)
