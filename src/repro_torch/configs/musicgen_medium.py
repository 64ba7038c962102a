"""musicgen-medium [audio]: decoder-only LM over EnCodec tokens
(arXiv:2306.05284).  MHA (kv == heads).  The EnCodec tokenizer/frontend is a
STUB per the assignment: the LM consumes precomputed acoustic token ids
(vocab 2048); text conditioning is out of scope for the backbone."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio", num_layers=48, d_model=1536,
    num_heads=24, num_kv_heads=24, d_ff=6144, vocab_size=2048)

SMOKE = ModelConfig(
    name="musicgen-medium-smoke", family="audio", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=128,
    head_dim=16, dtype="float32")
