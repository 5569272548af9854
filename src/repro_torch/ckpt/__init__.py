"""Checkpoints in the reference's layout (numpy only)."""

from repro_torch.ckpt.store import (CheckpointStore, PruneProgressStore,
                                    load_pytree, save_pytree)

__all__ = ["CheckpointStore", "PruneProgressStore", "load_pytree",
           "save_pytree"]
