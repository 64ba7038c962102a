from repro_torch.checkpoint.checkpointing import (  # noqa: F401
    save_checkpoint, restore_checkpoint, latest_step, Checkpointer,
)
