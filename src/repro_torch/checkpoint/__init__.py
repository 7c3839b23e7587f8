from repro_torch.checkpoint.store import (CheckpointManager, latest_step,
                                          load_checkpoint, save_checkpoint)

__all__ = ["CheckpointManager", "latest_step", "load_checkpoint",
           "save_checkpoint"]
