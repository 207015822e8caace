"""Model configuration schema (copy of ``repro.models.config``).

The port keeps its own copy so that it imports nothing of the JAX
package.  Field names, defaults and ``scaled_down`` are identical, so a
config built here describes the same network as the reference's.
"""

from __future__ import annotations

import dataclasses
import enum


class BlockKind(enum.Enum):
    ATTN = "attn"              # attention + MLP (dense or MoE by config)
    ATTN_LOCAL = "attn_local"  # sliding-window attention + MLP
    MAMBA2 = "mamba2"          # SSD block (attention-free)
    SHARED_ATTN = "shared_attn"  # zamba2-style shared-weight attention block


class RopeMode(enum.Enum):
    FULL = "full"          # rotary over the whole head dim
    HALF = "half"          # chatglm-style 2d rope: first half of head dims
    NONE = "none"          # no positional rotation (e.g. hubert encoder)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    pattern: tuple[BlockKind, ...] = (BlockKind.ATTN,)
    tail: tuple[BlockKind, ...] = ()
    qkv_bias: bool = False
    rope_mode: RopeMode = RopeMode.FULL
    rope_theta: float = 10_000.0
    local_window: int = 4096
    attn_logit_softcap: float | None = None
    final_logit_softcap: float | None = None
    causal: bool = True
    post_norms: bool = False
    moe: MoEConfig | None = None
    moe_every: int = 1
    first_layer_dense_ff: int | None = None
    ssm: SSMConfig | None = None
    mla: MLAConfig | None = None
    n_shared_attn_sets: int = 2
    tie_embeddings: bool = False
    scale_embeddings: bool = False
    frontend: str = "none"
    frontend_prefix_len: int = 0
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    act: str = "silu"
    attn_block_q: int = 1024
    attn_block_kv: int = 1024
    remat: bool = True
    use_pallas: bool = False
    quant_serving: bool = False
    #: "xla": projections are plain ``torch.matmul`` (the reference leaves
    #: them to XLA); "scheduled": every projection and the LM head run
    #: through the hand-written mpgemm kernels, with the paper-§5
    #: schedule cache picking dataflow and fold per shape.
    gemm_backend: str = "xla"

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_groups_scan(self) -> int:
        pat = max(1, len(self.pattern))
        return (self.n_layers - len(self.tail)) // pat

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def attention_free(self) -> bool:
        return set(self.pattern) | set(self.tail) <= {BlockKind.MAMBA2}

    @property
    def has_recurrent_state(self) -> bool:
        return BlockKind.MAMBA2 in set(self.pattern) | set(self.tail)

    @property
    def quant_kv(self) -> bool:
        """Int8 paged KV blocks with per-position scale sidecars: follows
        ``quant_serving`` for the plain GQA pool only (an MLA latent cache
        is already compressed; attention-free stacks have no KV pool)."""
        return self.quant_serving and self.mla is None \
            and not self.attention_free

    def validate(self) -> ModelConfig:
        pat = max(1, len(self.pattern))
        if (self.n_layers - len(self.tail)) % pat:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} minus tail "
                f"{len(self.tail)} not divisible by pattern {pat}")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: heads {self.n_heads} not a "
                             f"multiple of kv heads {self.n_kv_heads}")
        return self

    def scaled_down(self, **overrides) -> ModelConfig:
        """A reduced same-family config for CPU smoke tests (the same
        reduction as the reference's ``scaled_down``)."""
        small = dict(
            n_layers=len(self.pattern) * 2 + len(self.tail),
            d_model=128,
            n_heads=4,
            n_kv_heads=max(1, min(4, self.n_kv_heads)),
            head_dim=32,
            d_ff=256,
            vocab=512,
            attn_block_q=64, attn_block_kv=64,
            param_dtype="float32", compute_dtype="float32",
            remat=False,
        )
        if self.moe is not None:
            small["moe"] = dataclasses.replace(
                self.moe, n_experts=min(8, self.moe.n_experts),
                top_k=min(2, self.moe.top_k), d_ff_expert=128,
                d_ff_shared=128 if self.moe.n_shared_experts else 0,
                capacity_factor=4.0)
        if self.ssm is not None:
            small["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk=32)
        if self.mla is not None:
            small["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=64,
                                     qk_nope_head_dim=32, qk_rope_head_dim=16,
                                     v_head_dim=32)
        if self.first_layer_dense_ff:
            small["first_layer_dense_ff"] = 256
        if self.frontend_prefix_len:
            small["frontend_prefix_len"] = 8
        small.update(overrides)
        return dataclasses.replace(self, **small).validate()
