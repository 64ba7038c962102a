"""granite-moe-3b-a800m [moe]: 40 experts top-8, d_ff=512 per expert
(hf:ibm-granite family).  40 % 16 != 0 so expert weights run FSDP x TP
(every chip computes all experts for its tokens) instead of EP."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe", num_layers=32, d_model=1536,
    num_heads=24, num_kv_heads=8, d_ff=512, vocab_size=49155,
    head_dim=64, num_experts=40, experts_per_token=8)

SMOKE = ModelConfig(
    name="granite-moe-3b-smoke", family="moe", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=32, vocab_size=256, head_dim=16,
    num_experts=8, experts_per_token=2, moe_group=64, dtype="float32")
