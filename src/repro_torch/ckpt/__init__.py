"""Checkpoints in the reference's layout (numpy only)."""

from repro_torch.ckpt.store import PruneProgressStore, load_pytree, save_pytree

__all__ = ["PruneProgressStore", "load_pytree", "save_pytree"]
