"""rwkv6-7b [ssm]: Finch — attention-free, data-dependent decay
(arXiv:2404.05892).  64 heads of 64 channels; O(1) decode state."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm", num_layers=32, d_model=4096,
    num_heads=0, num_kv_heads=0, d_ff=14336, vocab_size=65536,
    rwkv_head_dim=64)

SMOKE = ModelConfig(
    name="rwkv6-7b-smoke", family="ssm", num_layers=2, d_model=64,
    num_heads=0, num_kv_heads=0, d_ff=128, vocab_size=256,
    rwkv_head_dim=16, dtype="float32")
