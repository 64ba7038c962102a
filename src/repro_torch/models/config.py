"""Model configuration shared by all assigned architectures (a copy of
``repro.models.config``: data only, no jax)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int              # query heads (0 for attention-free archs)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_group: int = 1024              # tokens per routing group
    moe_capacity_factor: float = 1.25
    # --- hybrid (Griffin / RecurrentGemma) ----------------------------------
    block_pattern: tuple[str, ...] = ()   # cycle of "rec" | "attn"
    local_window: int = 0
    d_rnn: int = 0
    conv_width: int = 4
    # --- RWKV ----------------------------------------------------------------
    rwkv_head_dim: int = 64
    # --- modality frontend stubs ---------------------------------------------
    frontend: str = "none"             # none | patch (VLM) | frame (audio)
    frontend_dim: int = 0              # raw patch/frame embedding width
    frontend_len: int = 0              # prefix length supplied by the stub
    mrope_sections: tuple[int, int, int] | None = None
    # --- distribution ---------------------------------------------------------
    sharding_profile: str = "2d"       # "2d" (FSDP x TP + SP) | "fsdp"
    # --- numerics --------------------------------------------------------------
    dtype: str = "bfloat16"            # activation/compute dtype
    param_dtype: str = "float32"

    # --- derived -----------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Embedding/logit table rows padded to a multiple of 256 so the
        vocab dim shards evenly over any mesh axis <= 256 (padded logit
        columns are masked out in the loss and in sampling)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def d_rnn_(self) -> int:
        return self.d_rnn or self.d_model

    @property
    def num_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        """Per-layer block kind; dense unless a block_pattern cycle is set."""
        if not self.block_pattern:
            return ("attn",) * self.num_layers
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    def param_count(self) -> int:
        """Parameter count (embeddings + blocks) matching init_params; used
        for the roofline's MODEL_FLOPS = 6*N*D."""
        d, f = self.d_model, self.d_ff
        hd = self.head_dim_
        n = 2 * self.padded_vocab * d                    # emb + head (untied)
        for kind in self.layer_kinds:
            if kind == "rec":                            # Griffin RG-LRU block
                dr = self.d_rnn_
                n += 3 * d * dr + 2 * dr * dr            # in/out + gates
                n += self.conv_width * dr + 5 * dr       # conv + vectors
                n += 3 * d * f + 2 * d                   # MLP + norms
                continue
            if self.family == "ssm":                     # rwkv6 block
                n += 6 * d * d                           # w_r/k/v/g/o + wr2
                n += 2 * d * f                           # wk2, wv2
                n += 2 * 64 * d + 13 * d                 # decay lora + vectors
                continue
            n += d * (self.num_heads * hd)               # wq
            n += 2 * d * (self.num_kv_heads * hd)        # wk, wv
            n += (self.num_heads * hd) * d               # wo
            n += 2 * d
            if self.qkv_bias:
                n += (self.num_heads + 2 * self.num_kv_heads) * hd
            if self.num_experts:
                n += d * self.num_experts
                n += self.num_experts * 3 * d * f
            else:
                n += 3 * d * f
        n += d                                           # final norm
        if self.frontend == "patch":
            n += self.frontend_dim * d
        return n

    def active_param_count(self) -> int:
        """Active (per-token) parameters — MoE counts top-k experts only."""
        if not self.num_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_n = self.param_count() - len(self.layer_kinds) * (
            self.num_experts * 3 * d * f)
        return dense_n + len(self.layer_kinds) * (
            self.experts_per_token * 3 * d * f)
