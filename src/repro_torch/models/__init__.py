"""The LM substrate's serving path (dense and ssm families): configs,
layers, the transformer and RWKV-6 models, and the registry."""
from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.model import (  # noqa: F401
    Model, get_model, load_reference_params, make_decode_step,
    make_prefill_step,
)
