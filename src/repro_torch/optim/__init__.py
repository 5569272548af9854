"""AdamW and its learning-rate schedules (the reference's ``repro.optim``;
its int8 gradient compression goes with distribution, ROADMAP.md)."""

from repro_torch.optim.adamw import AdamW, OptState, tree_leaves, tree_map
from repro_torch.optim.schedules import warmup_cosine, warmup_linear

__all__ = ["AdamW", "OptState", "tree_leaves", "tree_map", "warmup_cosine",
           "warmup_linear"]
