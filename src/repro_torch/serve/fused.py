"""The decode burst: K greedy decode steps with the scheduler state kept
on the device, and the prefill-chunk burst that runs one prompt chunk in
front of them.

The reference runs the burst as a jitted ``lax.while_loop``; here it is a
plain Python loop over ``LM.decode_step`` whose per-step bookkeeping
(sample, record into the output ring, EOS / length done-detection,
position advance) is tensor ops on the device, so the host never waits
inside a burst.  The state goes up as one int32 blob and comes back as
one blob: one host readback per burst, as in the reference.  CUDA graphs
are a later step.

The reference's loop exits early once every slot is idle; here the K
steps always run, but a step taken with every slot idle changes nothing
(its writes go to the scrap page) and does not count against
``steps_left`` — so the state read back is the reference's.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

FIELDS = ("tok", "pos", "uid", "n_tok", "max_new", "done", "n_out",
          "steps_left")


def sample_rows(logits: torch.Tensor) -> torch.Tensor:
    """Greedy draw per row: argmax, the first maximum winning (as
    ``jnp.argmax``).  Sampled decoding is not ported (ROADMAP.md)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def init_burst_state(max_batch: int, ring: int) -> Dict[str, np.ndarray]:
    """Host template of the burst state.  All slots start idle (``pos``
    -1); the engine fills the running slots before each burst.  ``out``
    is the token output ring, ``ring`` ≥ burst length + 1 (the +1 is the
    token 0 of a slot that a prefill burst activates)."""
    return {
        "tok": np.zeros((max_batch,), np.int32),
        "pos": np.full((max_batch,), -1, np.int32),     # -1 = idle slot
        "uid": np.zeros((max_batch,), np.int32),
        "n_tok": np.zeros((max_batch,), np.int32),      # len(seq.tokens)
        "max_new": np.zeros((max_batch,), np.int32),
        "done": np.zeros((max_batch,), bool),           # finished in-burst
        "out": np.zeros((max_batch, ring), np.int32),   # emitted tokens
        "n_out": np.zeros((max_batch,), np.int32),
        "steps_left": np.asarray(0, np.int32),          # burst length
    }


def upload(state: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """One host→device copy of the packed state; the returned fields are
    views into the device blob, updated in place by the burst."""
    b = state["tok"].shape[0]
    nf = len(FIELDS)
    blob = np.zeros((b, nf + state["out"].shape[1]), np.int32)
    for i, f in enumerate(FIELDS):
        blob[:, i] = state[f]
    blob[:, nf:] = state["out"]
    dev = torch.from_numpy(blob).to(device)
    st = {f: dev[:, i] for i, f in enumerate(FIELDS)}
    st["out"] = dev[:, nf:]
    st["blob"] = dev
    return st


def read_back(st: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The one device→host copy of a burst (the host sync)."""
    blob = st["blob"].cpu().numpy()
    nf = len(FIELDS)
    out = {f: blob[:, i] for i, f in enumerate(FIELDS)}
    out["done"] = out["done"].astype(bool)
    out["steps_left"] = int(blob[0, nf - 1])
    out["out"] = blob[:, nf:]
    return out


def decode_loop(model, params, kv, tables: torch.Tensor,
                st: Dict[str, torch.Tensor], *, steps: int, page_size: int,
                eos: int) -> None:
    """Run ``steps`` fused decode steps on the state in place.  Per step:
    ``decode_step`` writes this token's KV and yields logits, the greedy
    token is recorded into the output ring, EOS / ``max_new`` mark the
    slot done (``pos`` frozen to -1) and live slots advance ``pos``."""
    b = st["tok"].shape[0]
    ring = st["out"].shape[1]
    rows = torch.arange(b, device=tables.device)
    for _ in range(steps):
        pos = st["pos"]
        active = pos >= 0
        alive = active.any()
        logits = model.decode_step(params, st["tok"], kv, pos, tables,
                                   page_size=page_size)
        sampled = sample_rows(logits)
        ai = active.to(torch.int32)
        col = torch.clamp(st["n_out"], max=ring - 1).long()
        cell = st["out"][rows, col]
        st["out"][rows, col] = torch.where(active, sampled, cell)
        n_tok = st["n_tok"] + ai
        newly_done = active & ((sampled == eos) | (n_tok >= st["max_new"]))
        st["tok"].copy_(torch.where(active, sampled, st["tok"]))
        st["pos"].copy_(torch.where(newly_done, -1,
                                    torch.where(active, pos + 1, pos)))
        st["n_tok"].copy_(n_tok)
        st["done"].copy_(st["done"] | newly_done.to(torch.int32))
        st["n_out"].add_(ai)
        st["steps_left"].sub_(alive.to(torch.int32))


def prefill_burst(model, params, kv, tables: torch.Tensor,
                  st: Dict[str, torch.Tensor], p: Dict, *, steps: int,
                  page_size: int, chunk_size: int, eos: int) -> None:
    """One chunk of one request's prompt, then the decode loop.

    ``p`` carries the chunk: ``tokens`` (1, C) on the device, host ints
    ``start`` / ``length`` / ``slot`` / ``uid`` / ``max_new`` and
    ``pos0`` — the activation write position (the prompt length), or -1
    when the host could not map a page for the slot's first decode write
    (the slot then activates frozen: token 0 is recorded and decoding
    waits for the next sync).  On the final chunk the slot is activated
    in the state: token 0 is the greedy draw from the chunk's last
    logits, recorded into the ring; EOS or ``max_new <= 1`` finish it at
    once."""
    slot = p["slot"]
    logits = model.prefill_chunk(params, p["tokens"], kv, p["start"],
                                 p["length"], tables[slot:slot + 1],
                                 page_size=page_size)
    if p["start"] + chunk_size >= p["length"]:
        tok0 = sample_rows(logits)[0]
        done0 = (tok0 == eos) | (p["max_new"] <= 1)
        st["tok"][slot] = tok0
        st["pos"][slot] = torch.where(done0, -1, p["pos0"])
        st["uid"][slot] = p["uid"]
        st["n_tok"][slot] = 1
        st["max_new"][slot] = p["max_new"]
        st["done"][slot] = done0.to(torch.int32)
        st["out"][slot, 0] = tok0
        st["n_out"][slot] = 1
    decode_loop(model, params, kv, tables, st, steps=steps,
                page_size=page_size, eos=eos)

