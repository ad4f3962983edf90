"""Session checkpoints of the port, in the reference's npz + manifest format."""

from repro_torch.checkpoint.ckpt import (
    CheckpointError,
    latest_step,
    load_checkpoint,
    read_manifest,
    save_checkpoint,
)

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step", "read_manifest",
           "CheckpointError"]
