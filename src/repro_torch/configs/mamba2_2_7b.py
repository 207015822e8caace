"""mamba2-2.7b [arXiv:2405.21060; unverified]: attention-free SSD stack
(d_ff=0 — no MLP blocks; each layer is one Mamba2 block with expand=2,
d_state=128, head_dim 64)."""
from repro_torch.models.config import BlockKind, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=50280,
    pattern=(BlockKind.MAMBA2,),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1),
)
