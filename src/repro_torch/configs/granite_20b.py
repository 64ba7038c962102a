"""granite-20b [dense]: llama-arch code model with MQA (arXiv:2405.04324)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense", num_layers=52, d_model=6144,
    num_heads=48, num_kv_heads=1, d_ff=24576, vocab_size=49152,
    head_dim=128)

SMOKE = ModelConfig(
    name="granite-20b-smoke", family="dense", num_layers=2, d_model=48,
    num_heads=4, num_kv_heads=1, d_ff=128, vocab_size=256,
    head_dim=12, dtype="float32")
