"""llama4-scout-17b-a16e [moe]: 16 experts top-1 (early-fusion multimodal in
the real model; the text backbone is what the pool assigns).  16 experts
divide the model axis -> true expert parallelism."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe", num_layers=48, d_model=5120,
    num_heads=40, num_kv_heads=8, d_ff=8192, vocab_size=202048,
    head_dim=128, num_experts=16, experts_per_token=1, rope_theta=5e5)

SMOKE = ModelConfig(
    name="llama4-scout-smoke", family="moe", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=256, head_dim=16,
    num_experts=4, experts_per_token=1, moe_group=64, dtype="float32")
