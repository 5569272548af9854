"""Read and write the reference's checkpoints with numpy alone.

Layout (``repro/ckpt/store.py``):

  <dir>/step_000042/  or any directory ``save_pytree`` wrote
    arrays.npz        every pytree leaf, path-keyed ("layers/s0/attn/wq")
    manifest.json     {keys, shapes, dtypes, sha256, extra}

The trainer's ``--out`` is a :class:`CheckpointStore`: ``step_*``
directories, ``LATEST`` naming the newest complete one, the oldest
pruned past ``keep``.  Its leaves carry the reference's paths for
``{"params", "opt": OptState, "ef"}`` — ``params/layers/s0/attn/wq``
(layers stacked), ``opt/.step``, ``opt/.mu/...``, ``opt/.nu/...``,
``ef`` — so each package restores the other's checkpoints.  The pruning
launcher's ``--out`` holds ``pruned_params/`` and, while a run is in
flight, ``prune_progress/`` (:class:`PruneProgressStore`).

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
from typing import Callable, Dict, List, Optional, Tuple

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
class CheckpointStore:
    """Step-indexed checkpoint directory with retention and a LATEST
    pointer (the reference's ``CheckpointStore``), over path-keyed flat
    dicts of numpy leaves."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def save(self, step: int, flat: Dict[str, np.ndarray],
             extra: Optional[dict] = None) -> str:
        """Write step ``step`` atomically, then point LATEST at it (the
        pointer last), then drop the oldest past ``keep``."""
        path = self._step_dir(step)
        save_pytree(path, flat, extra={"step": step, **(extra or {})})
        latest_tmp = os.path.join(self.root, f".LATEST.tmp-{os.getpid()}")
        with open(latest_tmp, "w") as f:
            f.write(os.path.basename(path))
            f.flush()
            os.fsync(f.fileno())
        os.replace(latest_tmp, os.path.join(self.root, "LATEST"))
        for s in self.list_steps()[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        return path

    def list_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.root):
            if name.startswith("step_"):
                try:
                    steps.append(int(name[len("step_"):]))
                except ValueError:        # a temporary: step_X.tmp-<pid>
                    pass
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        latest = os.path.join(self.root, "LATEST")
        if os.path.exists(latest):
            with open(latest) as f:
                name = f.read().strip()
            if os.path.isdir(os.path.join(self.root, name)):
                try:
                    return int(name[len("step_"):])
                except ValueError:
                    pass
        steps = self.list_steps()        # LATEST torn: scan instead
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None,
                convert: Optional[Callable] = None
                ) -> Optional[Tuple[int, object, dict]]:
        """(step, leaves, extra) of the newest *valid* checkpoint ≤
        ``step`` (or the newest), or None.  Walks back past checkpoints
        that fail to load — torn or corrupted writes — and past those
        ``convert`` (flat dict → the caller's tree) refuses, as the
        reference walks past those its template refuses."""
        steps = [s for s in self.list_steps() if step is None or s <= step]
        for s in reversed(steps):
            try:
                flat, extra = load_pytree(self._step_dir(s))
                return s, (convert(flat) if convert else flat), extra
            except Exception:   # corrupt or foreign — keep walking back
                continue
        return None


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
