"""Read and write the reference's checkpoints with numpy alone.

Layout (``repro/ckpt/store.py``):

  <dir>/step_000042/  or any directory ``save_pytree`` wrote
    arrays.npz        every pytree leaf, path-keyed ("layers/s0/attn/wq")
    manifest.json     {keys, shapes, dtypes, sha256, extra}

The pruning launcher's ``--out`` holds ``pruned_params/`` and, while a
run is in flight, ``prune_progress/`` (:class:`PruneProgressStore`).

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


# ----------------------------------------------------------------------
class PruneProgressStore:
    """Per-segment pruning progress (the engine's resume point): the
    reference's ``PruneProgressStore`` layout, ``<root>/prune_progress``
    holding the path-keyed params (``LM.params_to_flat``) with
    ``{"next_segment": i}`` as its extra.  ``finalize`` removes it when a
    run completes.

    ``fingerprint`` (a JSON-able dict: what decides the pruned params —
    the launcher's ``run_fingerprint``) is saved beside ``next_segment``;
    ``load`` raises on a progress whose fingerprint differs, so a run
    never resumes from another configuration's params."""

    def __init__(self, root: str, fingerprint: Optional[dict] = None):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.path = os.path.join(root, "prune_progress")
        # the JSON round trip makes it compare equal to a loaded one
        self.fingerprint = json.loads(json.dumps(fingerprint))

    def save(self, next_segment: int, flat: Dict[str, np.ndarray]) -> None:
        extra = {"next_segment": next_segment}
        if self.fingerprint is not None:
            extra["fingerprint"] = self.fingerprint
        save_pytree(self.path, flat, extra=extra)

    def load(self) -> Optional[Tuple[int, Dict[str, np.ndarray]]]:
        """(next segment, path-keyed params), or None with no progress."""
        if not os.path.isdir(self.path):
            return None
        flat, extra = load_pytree(self.path)
        found = extra.get("fingerprint")
        if found != self.fingerprint:
            raise ValueError(
                f"{self.path} holds the progress of another run "
                f"({found} != {self.fingerprint}): remove it to start over, "
                "or write this run elsewhere")
        return extra["next_segment"], flat

    def finalize(self) -> None:
        if os.path.isdir(self.path):
            shutil.rmtree(self.path)
