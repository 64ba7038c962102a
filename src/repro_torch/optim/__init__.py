from repro_torch.optim.adamw import AdamW, cosine_schedule  # noqa: F401
from repro_torch.optim.compress import (  # noqa: F401
    int8_quantize, int8_dequantize, ef_compress_mean,
)
