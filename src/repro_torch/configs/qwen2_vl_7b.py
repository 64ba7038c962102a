"""qwen2-vl-7b [vlm]: M-RoPE + dynamic-resolution ViT frontend
(arXiv:2409.12191).  The ViT is a STUB per the assignment: input_specs
supplies precomputed patch embeddings (frontend_dim=1176 = 14x14 patch x 3ch
x 2 temporal); the backbone fuses them as a prefix."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm", num_layers=28, d_model=3584,
    num_heads=28, num_kv_heads=4, d_ff=18944, vocab_size=152064,
    head_dim=128, qkv_bias=True, rope_theta=1e6,
    frontend="patch", frontend_dim=1176, frontend_len=256,
    mrope_sections=(16, 24, 24))

SMOKE = ModelConfig(
    name="qwen2-vl-smoke", family="vlm", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
    qkv_bias=True, frontend="patch", frontend_dim=24, frontend_len=16,
    mrope_sections=(2, 3, 3), dtype="float32")
