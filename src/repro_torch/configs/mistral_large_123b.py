"""mistral-large-123b [dense] (hf:mistralai/Mistral-Large-Instruct-2407)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense", num_layers=88, d_model=12288,
    num_heads=96, num_kv_heads=8, d_ff=28672, vocab_size=32768,
    head_dim=128, rope_theta=1e6)

SMOKE = ModelConfig(
    name="mistral-large-123b-smoke", family="dense", num_layers=3, d_model=96,
    num_heads=6, num_kv_heads=2, d_ff=224, vocab_size=256,
    head_dim=16, dtype="float32")
