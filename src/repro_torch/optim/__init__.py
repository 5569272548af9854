"""AdamW, its learning-rate schedules and int8 error-feedback gradient
compression (the reference's ``repro.optim``)."""

from repro_torch.optim.adamw import AdamW, OptState, tree_leaves, tree_map
from repro_torch.optim.compression import (compressed_psum,
                                           dequantize_int8, ef_init,
                                           ef_quantize, quantize_int8)
from repro_torch.optim.schedules import warmup_cosine, warmup_linear

__all__ = ["AdamW", "OptState", "tree_leaves", "tree_map", "warmup_cosine",
           "warmup_linear", "compressed_psum", "dequantize_int8", "ef_init",
           "ef_quantize", "quantize_int8"]
