"""minitron-4b [dense]: width/depth-pruned Nemotron (arXiv:2407.14679)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense", num_layers=32, d_model=3072,
    num_heads=24, num_kv_heads=8, d_ff=9216, vocab_size=256000,
    head_dim=128)

SMOKE = ModelConfig(
    name="minitron-4b-smoke", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=512,
    head_dim=16, dtype="float32")
