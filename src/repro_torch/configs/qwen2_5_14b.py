"""qwen2.5-14b [dense]: GQA + QKV bias (Qwen2 family; hf:Qwen/Qwen2.5-14B)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense", num_layers=48, d_model=5120,
    num_heads=40, num_kv_heads=8, d_ff=13824, vocab_size=152064,
    head_dim=128, qkv_bias=True, rope_theta=1e6)

SMOKE = ModelConfig(
    name="qwen2.5-14b-smoke", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=160, vocab_size=256,
    head_dim=16, qkv_bias=True, dtype="float32")
