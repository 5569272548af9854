"""The decode burst: K decode steps with the scheduler state kept on the
device, the prefill-chunk burst that runs one prompt chunk in front of
them, the sampling they share, and static mode's bucket loop (the only one a
MoE model takes: every decode step routes the bucket's B tokens at once,
so expert capacity follows the bucket, as in the reference).

The reference runs the bursts as jitted ``lax.while_loop`` /
``fori_loop`` bodies; here they are plain Python loops over
``LM.decode_step`` (which leaves idle and prefilling slots' recurrent
state rows as they are) whose per-step bookkeeping (sample, record into the
output ring, EOS / length done-detection, position advance) is tensor
ops on the device, so the host never waits inside a burst.  The state
goes up as one int32 blob and comes back as one blob: one host readback
per burst, as in the reference.  CUDA graphs are a later step.

The reference's loops exit early once every slot is idle (every request
of a static bucket done); here the K steps always run, but a step taken
with nothing live changes nothing that is read back (its writes go to
the scrap page, or past every emitted token) and does not count against
``steps_left`` / ``steps_run`` — so the state read back is the
reference's.

Sampling is the reference's: greedy argmax at temperature 0; otherwise
the temperature-scaled logits filtered by top-k / top-p, then
``random.categorical``.  Continuous mode keys every row's draw by
``fold_in(fold_in(base_key, uid), step)`` (:func:`sample_rows`) — so a
stream depends on neither the batch, nor ``steps_per_sync``, nor
preemption; static mode draws one batch-keyed sample a step under the
bucket key's ``split`` sequence (:func:`sample_batch`) — a data rank
holding its rows of a bucket draws the whole bucket's noise and takes
its rows, so its tokens are those of the bucket on one device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import random as rnd

FIELDS = ("tok", "pos", "uid", "n_tok", "max_new", "done", "n_out",
          "steps_left")


# ----------------------------------------------------------------------
# sampling (shared by the bursts and the static loop)
# ----------------------------------------------------------------------
def filter_logits(rows: torch.Tensor, top_k: Optional[int],
                  top_p: Optional[float]) -> torch.Tensor:
    """Top-k / top-p (nucleus) filtering of temperature-scaled logit
    rows (..., V): filtered-out entries go to -inf.  Row by row the
    reference's ops: top-k keeps every entry tied with the k-th value;
    top-p keeps the smallest descending prefix whose mass reaches p (the
    exclusive cumsum below p, so the first entry always survives)."""
    v = rows.shape[-1]
    ninf = torch.tensor(float("-inf"), dtype=rows.dtype, device=rows.device)
    if top_k is not None and 0 < top_k < v:
        kth = torch.topk(rows, top_k, dim=-1).values[..., -1:]
        rows = torch.where(rows < kth, ninf, rows)
    if top_p is not None and 0.0 < top_p < 1.0:
        srt = torch.sort(rows, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
        inf = torch.tensor(float("inf"), dtype=rows.dtype, device=rows.device)
        thr = torch.where(keep, srt, inf).amin(dim=-1, keepdim=True)
        rows = torch.where(rows < thr, ninf, rows)
    return rows


def sample_rows(logits: torch.Tensor, uids: torch.Tensor,
                steps: torch.Tensor, base_key: torch.Tensor, *,
                temperature: float, top_k: Optional[int],
                top_p: Optional[float]) -> torch.Tensor:
    """Per-(uid, step)-keyed draw of every row — the continuous-mode
    sample.  Row ``i`` uses ``fold_in(fold_in(base_key, uids[i]),
    steps[i])``; idle rows draw values that are never recorded.  At
    temperature 0 the argmax (the first maximum, as ``jnp.argmax``)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    keys = rnd.fold_in(rnd.fold_in(base_key, uids), steps)
    rows = filter_logits(logits / temperature, top_k, top_p)
    return rnd.categorical(keys, rows).to(torch.int32)


def sample_batch(logits: torch.Tensor, key: torch.Tensor, *,
                 temperature: float, top_k: Optional[int],
                 top_p: Optional[float],
                 rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Static-mode sampling: one batch-keyed draw per step.  ``rows`` =
    (offset, bucket size): ``logits`` are those rows of the bucket, and
    the draw is the bucket's at them (``random.categorical``'s noise over
    the whole bucket, cut to the rows)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    filt = filter_logits(logits / temperature, top_k, top_p)
    if rows is None:
        return rnd.categorical(key, filt).to(torch.int32)
    off, total = rows
    noise = rnd.gumbel(key, (total, filt.shape[-1]))[off:off + filt.shape[0]]
    return torch.argmax(noise + filt, dim=-1).to(torch.int32)


# ----------------------------------------------------------------------
# continuous mode: the bursts
# ----------------------------------------------------------------------
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
                st: Dict[str, torch.Tensor], base_key: torch.Tensor, *,
                steps: int, page_size: int, eos: int, **sampling) -> None:
    """Run ``steps`` fused decode steps on the state in place.  Per step:
    ``decode_step`` writes this token's KV and yields logits,
    :func:`sample_rows` draws the next token under the per-(uid, step)
    key (``sampling``: temperature, top_k, top_p), the token is recorded
    into the output ring, EOS / ``max_new`` mark the slot done (``pos``
    frozen to -1) and live slots advance ``pos``."""
    b = st["tok"].shape[0]
    ring = st["out"].shape[1]
    rows = torch.arange(b, device=tables.device)
    for _ in range(steps):
        pos = st["pos"]
        active = pos >= 0
        alive = active.any()
        logits = model.decode_step(params, st["tok"], kv, pos, tables,
                                   page_size=page_size)
        sampled = sample_rows(logits, st["uid"], st["n_tok"], base_key,
                              **sampling)
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
                  st: Dict[str, torch.Tensor], base_key: torch.Tensor,
                  p: Dict, *, steps: int, page_size: int, chunk_size: int,
                  eos: int, **sampling) -> None:
    """One chunk of one request's prompt, then the decode loop.

    ``p`` carries the chunk: ``tokens`` (1, C) on the device, host ints
    ``start`` / ``length`` / ``slot`` / ``uid`` / ``max_new`` and
    ``pos0`` — the activation write position (the prompt length), or -1
    when the host could not map a page for the slot's first decode write
    (the slot then activates frozen: token 0 is recorded and decoding
    waits for the next sync).  On the final chunk the slot is activated
    in the state: token 0 is drawn from the chunk's last logits under
    the per-(uid, 0) key, recorded into the ring; EOS or ``max_new <= 1``
    finish it at once."""
    slot = p["slot"]
    logits = model.prefill_chunk(params, p["tokens"], kv, p["start"],
                                 p["length"], tables[slot:slot + 1],
                                 page_size=page_size, slot=slot)
    if p["start"] + chunk_size >= p["length"]:
        uid = torch.full((1,), p["uid"], dtype=torch.int32,
                         device=logits.device)
        tok0 = sample_rows(logits, uid, torch.zeros_like(uid), base_key,
                           **sampling)[0]
        done0 = (tok0 == eos) | (p["max_new"] <= 1)
        st["tok"][slot] = tok0
        st["pos"][slot] = torch.where(done0, -1, p["pos0"])
        st["uid"][slot] = p["uid"]
        st["n_tok"][slot] = 1
        st["max_new"][slot] = p["max_new"]
        st["done"][slot] = done0.to(torch.int32)
        st["out"][slot, 0] = tok0
        st["n_out"][slot] = 1
    decode_loop(model, params, kv, tables, st, base_key, steps=steps,
                page_size=page_size, eos=eos, **sampling)



# ----------------------------------------------------------------------
# static mode: the bucket loop
# ----------------------------------------------------------------------
def static_burst(model, params, cache, logits: torch.Tensor,
                 key: torch.Tensor, max_new: np.ndarray, pos0: int,
                 width: int, *, early_exit: bool, eos: int,
                 rows: Optional[Tuple[int, int]] = None, **sampling
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A static bucket's whole sample / record / advance loop on the
    device (``make_static_burst``): ``(out (B, width), n_emitted (B,),
    steps_run ())`` as device tensors, read back by the caller in one
    sync.

    Each step splits the bucket key — ``key, sk = split(key)`` — draws
    the batch under ``sk`` (:func:`sample_batch`), records it and feeds it
    to the dense-cache ``decode_step`` at position ``pos0 + step``.
    ``rows`` (offset, bucket size): the rows are a data rank's block of
    the bucket (:func:`sample_batch`).
    ``early_exit=False`` is the reference's ``fori`` variant (EOS off and
    one ``max_new_tokens`` in the bucket: every step emits for every
    row, no done bookkeeping); otherwise the ``while`` variant's
    bookkeeping: a row emits while it is not done and ``step <
    max_new``, and is done after EOS or at ``max_new``; steps taken once
    every row is done emit nothing and are not counted in
    ``steps_run``."""
    b, dev = logits.shape[0], logits.device
    out = torch.zeros((b, width), dtype=torch.int32, device=dev)
    if not early_exit:
        for i in range(width):
            key, sk = rnd.split(key).unbind(0)
            tok = sample_batch(logits, sk, rows=rows, **sampling)
            out[:, i] = tok
            logits = model.decode_step(params, tok, cache, pos0 + i)
        full = torch.full((b,), width, dtype=torch.int32, device=dev)
        return out, full, torch.tensor(width, dtype=torch.int32, device=dev)
    max_new_t = torch.as_tensor(max_new, dtype=torch.int32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    n_emitted = torch.zeros((b,), dtype=torch.int32, device=dev)
    steps_run = torch.zeros((), dtype=torch.int32, device=dev)
    for step in range(width):
        steps_run += (~done.all()).to(torch.int32)
        key, sk = rnd.split(key).unbind(0)
        tok = sample_batch(logits, sk, rows=rows, **sampling)
        emit = ~done & (step < max_new_t)
        out[:, step] = torch.where(emit, tok, out[:, step])
        done = done | (emit & (tok == eos)) | (step >= max_new_t)
        n_emitted += emit.to(torch.int32)
        logits = model.decode_step(params, tok, cache, pos0 + step)
    return out, n_emitted, steps_run
