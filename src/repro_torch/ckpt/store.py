"""Read the reference's checkpoints with numpy alone.

Layout (``repro/ckpt/store.py``):

  <dir>/step_000042/  or any directory ``save_pytree`` wrote
    arrays.npz        every pytree leaf, path-keyed ("layers/s0/attn/wq")
    manifest.json     {keys, shapes, dtypes, sha256, extra}

The sha256 of ``arrays.npz`` is checked against the manifest, so a torn
or corrupted file is refused.  npz keeps bf16 leaves as raw 2-byte void
arrays; ``LM.params_from_jax`` reads those bits as bf16.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
from typing import Dict, Tuple

import numpy as np


def load_pytree(path: str, verify: bool = True
                ) -> Tuple[Dict[str, np.ndarray], dict]:
    """Load (path-keyed flat dict of numpy arrays, extra) from a
    directory written by the reference's ``save_pytree``."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(path, "arrays.npz"), "rb") as f:
        data = f.read()
    if verify and hashlib.sha256(data).hexdigest() != manifest["sha256"]:
        raise IOError(f"checkpoint {path}: sha256 mismatch (corrupt)")
    arrs = dict(np.load(io.BytesIO(data)))
    return arrs, manifest.get("extra", {})
