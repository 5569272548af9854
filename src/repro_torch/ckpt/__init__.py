"""Checkpoints in the reference's layout (numpy only)."""

from repro_torch.ckpt.store import load_pytree, save_pytree

__all__ = ["load_pytree", "save_pytree"]
