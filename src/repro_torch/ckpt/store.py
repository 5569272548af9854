"""Read and write the reference's checkpoints with numpy alone.

Layout (``repro/ckpt/store.py``):

  <dir>/step_000042/  or any directory ``save_pytree`` wrote
    arrays.npz        every pytree leaf, path-keyed ("layers/s0/attn/wq")
    manifest.json     {keys, shapes, dtypes, sha256, extra}

The sha256 of ``arrays.npz`` is checked against the manifest, so a torn
or corrupted file is refused.  npz keeps bf16 leaves as raw 2-byte void
arrays; ``LM.params_from_jax`` reads those bits as bf16, and
``LM.params_to_flat`` hands them back that way for :func:`save_pytree`.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
from typing import Dict, Optional, Tuple

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


def save_pytree(path: str, flat: Dict[str, np.ndarray],
                extra: Optional[dict] = None) -> None:
    """Atomically write path-keyed leaves (``LM.params_to_flat``) into
    directory ``path`` in the reference's layout, so that its
    ``load_pytree`` — and :func:`load_pytree` here — read them back."""
    tmp = f"{path}.tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    data = buf.getvalue()
    with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    manifest = {
        "keys": sorted(flat),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": {k: "bfloat16" if v.dtype == np.dtype("V2") else
                   str(v.dtype) for k, v in flat.items()},
        "sha256": hashlib.sha256(data).hexdigest(),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
