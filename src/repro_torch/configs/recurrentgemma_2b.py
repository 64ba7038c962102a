"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 2:1 rec:attn
(Griffin, arXiv:2402.19427)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid", num_layers=26, d_model=2560,
    num_heads=10, num_kv_heads=1, d_ff=7680, vocab_size=256000,
    head_dim=256, block_pattern=("rec", "rec", "attn"), local_window=2048,
    d_rnn=2560, conv_width=4)

SMOKE = ModelConfig(
    name="recurrentgemma-2b-smoke", family="hybrid", num_layers=3, d_model=64,
    num_heads=2, num_kv_heads=1, d_ff=192, vocab_size=512, head_dim=32,
    block_pattern=("rec", "rec", "attn"), local_window=16, d_rnn=64,
    conv_width=4, dtype="float32")
