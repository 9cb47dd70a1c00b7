from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager, save_checkpoint, restore_checkpoint, latest_step)
