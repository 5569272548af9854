#!/usr/bin/env python3
"""Chip smoke for the PyTorch port: build the CUDA kernels, hold each
against its plain PyTorch version on the card, then serve a 2:4-pruned
Qwen1.5-0.5B at full width through ``ServeEngine.generate``.

    python3 chip_smoke.py            # one CUDA card; exits non-zero on any failure

Phases (any failure exits non-zero; no exception is swallowed):

  0. the card's name and power limit, and the kernels' build time;
  1. every kernel against its plain version at the main path's shapes —
     the seven Qwen linears at M = 8 (decode) and M = 32 (prefill chunk)
     through nm_spmm_decode, the same seven at M = 256 through nm_spmm,
     paged_attn at B = 8 with ragged lengths, an idle slot, a window and
     int8 pages.  Errors are taken on f32 inputs; times are device times
     in the main path's bf16 (CUDA events around back-to-back calls while
     a spin kernel holds the card), weights rotated through more than
     the 50 MB L2 so that every launch streams them from device memory
     as a decode step does;
  2. end to end in f32 at reduced depth (Qwen width, 2 layers): the same
     requests served with the kernels and with the plain override; the
     per-step logits must agree within LOGIT_TOL and the greedy streams
     must be equal, except at a step whose plain top-two logit gap is
     below LOGIT_TOL (a near tie, printed);
  3. the main path: Qwen1.5-0.5B, 24 layers, bf16, random init from a
     seeded torch.Generator, magnitude 2:4 on the seven linears of every
     layer, packed by the engine — 8 greedy requests (64-token prompts,
     32 new tokens), one 512-token prompt at prefill_chunk 256 (the
     tiled nm_spmm), and the 8 requests again with int8 KV pages.  Every
     launch counter is zeroed just before and read just after; each must
     be > 0;
  4. a profiler trace of one main-path run: device busy and idle share,
     device time by kernel.

Then a ``{"kernels": [...]}`` line (every ported kernel, its check — a
failed check has ended the run before — and its numbers), the nvidia-smi
line, and last the ``{"ok": true, "device": {...}}`` line.  Longer tables go to
``chiprun_out/chip_smoke.txt``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12            # H100 SXM (NVIDIA data sheet)
PEAK_FLOPS = {"float32": 67e12,      # f32 outside the tensor cores
              "bfloat16": 989e12}    # dense bf16 tensor cores
KERNEL_TOL_REL = 2e-5                # |kernel - plain| / max(1, |plain|) in f32
LOGIT_TOL = 1e-3                     # phase 2, f32 logits (and near-tie gap)
L2_BYTES = 50 * 2**20
SPIN_HZ = 2.0e9                      # spin-kernel cycles per second (≥ SM clock)
QWEN_LINEARS = (                     # (name, K, N, bias, activation)
    ("attn.wq", 1024, 1024, True, None),
    ("attn.wk", 1024, 1024, True, None),
    ("attn.wv", 1024, 1024, True, None),
    ("attn.wo", 1024, 1024, False, None),
    ("mlp.wi", 1024, 2816, False, None),
    ("mlp.wg", 1024, 2816, False, "silu"),
    ("mlp.wo", 2816, 1024, False, None),
)
LOG = []


def say(*parts) -> None:
    line = " ".join(str(p) for p in parts)
    print(line, flush=True)
    LOG.append(line)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


# ----------------------------------------------------------------------
# timing
# ----------------------------------------------------------------------
def _device_us(prof) -> list:
    """Per-kernel device durations (µs, name) from a profiler run."""
    import torch

    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.time_range.elapsed_us(), e.name))
    return out


def device_ms(fn, arg_sets, n: int = 30, reps: int = 5) -> float:
    """Device time of one call of ``fn`` in ms: the median over ``reps``
    of the mean of ``n`` back-to-back calls, cycling through
    ``arg_sets`` (rotated so that the weights stream from device memory).
    A spin kernel (``torch.cuda._sleep``) holds the card while the host
    enqueues the n calls, so that the CUDA events around them time the
    device alone, not the host's launch gaps."""
    import torch

    for a in arg_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fn(*arg_sets[i % len(arg_sets)])
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    times = []
    spin_s = 2 * host_s + 1e-3
    while len(times) < reps:
        torch.cuda._sleep(int(spin_s * SPIN_HZ))
        e0.record()
        t0 = time.perf_counter()
        for i in range(n):
            fn(*arg_sets[(len(times) * n + i) % len(arg_sets)])
        e1.record()
        enq = time.perf_counter() - t0
        torch.cuda.synchronize()
        if enq < spin_s:
            times.append(e0.elapsed_time(e1) / n)
        elif spin_s > 1.0:
            fail("device_ms: the host cannot enqueue the calls ahead of "
                 "the card")
        else:                    # the host fell behind: spin longer, redo
            spin_s *= 2
    return statistics.median(times)


def bound(n_bytes: float, flops: float, dtype: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ----------------------------------------------------------------------
def _sparse_weight(gen, k, n, dtype):
    import torch

    from repro_torch.core.pruner import prune_matrix
    from repro_torch.kernels import ops

    w = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
    w = prune_matrix(w.T, "2:4")[0].T.contiguous().to(dtype)
    vals, idx = ops.compress_24(w)
    return w, vals, idx


def check_nm_spmm(gen, rows):
    import torch

    from repro_torch.kernels import nm_spmm as K

    per_kernel = {"nm_spmm_decode": [], "nm_spmm": []}
    for m in (8, 32, 256):
        kname = "nm_spmm_decode" if m <= K.DECODE_MAX_M else "nm_spmm"
        kern = getattr(K, kname)
        plain = getattr(K, kname + "_plain")
        for name, k, n, has_bias, act in QWEN_LINEARS:
            act = act if m <= K.DECODE_MAX_M else None
            has_bias = has_bias and m <= K.DECODE_MAX_M
            # correctness, f32
            _, vals, idx = _sparse_weight(gen, k, n, torch.float32)
            x = torch.randn(m, k, generator=gen, device="cuda")
            bias = (0.1 * torch.randn(n, generator=gen, device="cuda")
                    if has_bias else None)
            extra = (bias, act) if kname == "nm_spmm_decode" else ()
            got = kern(x, vals, idx, *extra)
            want = plain(x, vals, idx, *extra)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tol = KERNEL_TOL_REL * max(1.0, want.abs().max().item())
            # speed, bf16, weights rotated past L2
            w, vals, idx = _sparse_weight(gen, k, n, torch.bfloat16)
            wbytes = vals.numel() * 3
            reps = max(2, -(-2 * L2_BYTES // wbytes))
            xb = torch.randn(m, k, generator=gen, device="cuda").to(
                torch.bfloat16)
            bb = bias.to(torch.bfloat16) if bias is not None else None
            sets, lib_sets = [], []
            for _ in range(reps):
                v2, i2 = vals.clone(), idx.clone()
                sets.append((xb, v2, i2, *((bb, act) if extra else ())))
                lib_sets.append((xb, w.clone()))
            ms = device_ms(kern, sets)
            plain_ms = device_ms(plain, sets)
            lib_ms = device_ms(torch.matmul, lib_sets)
            n_bytes = (m * k * 2 + vals.numel() * 2 + idx.numel()
                       + (n * 2 if bb is not None else 0) + m * n * 4)
            b_ms, b_by = bound(n_bytes, 2.0 * m * n * (k // 2), "bfloat16")
            ok = err <= tol
            row = dict(kernel=kname, shape=f"{name} M={m} K={k} N={n}",
                       max_abs_err=err, tol=tol, ok=ok, ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                       bound_by=b_by)
            rows.append(row)
            say(f"  {kname:15s} {row['shape']:30s} err {err:.3e} tol "
                f"{tol:.3e} {'ok' if ok else 'FAIL'}  ms {ms:.5f} plain "
                f"{plain_ms:.5f} lib {lib_ms:.5f} bound {b_ms:.5f}")
            if m in (8, 256):
                per_kernel[kname].append(row)
            del sets, lib_sets
    return per_kernel


def _paged_case(gen, b, kvh, g, hd, ps, p_max, lengths, dtype, int8):
    import torch

    n_pages = b * p_max + 1
    q = torch.randn(b, kvh, g, hd, generator=gen, device="cuda").to(dtype)
    if int8:
        kp = torch.randint(-127, 128, (n_pages, ps, kvh, hd), generator=gen,
                           device="cuda").to(torch.int8)
        vp = torch.randint(-127, 128, (n_pages, ps, kvh, hd), generator=gen,
                           device="cuda").to(torch.int8)
        ks = torch.rand(n_pages, ps, kvh, generator=gen, device="cuda") / 64
        vs = torch.rand(n_pages, ps, kvh, generator=gen, device="cuda") / 64
    else:
        kp = torch.randn(n_pages, ps, kvh, hd, generator=gen,
                         device="cuda").to(dtype)
        vp = torch.randn(n_pages, ps, kvh, hd, generator=gen,
                         device="cuda").to(dtype)
        ks = vs = None
    bt = np.zeros((b, p_max), np.int32)
    pid = 1
    for i, ln in enumerate(lengths):
        for j in range(-(-ln // ps)):
            bt[i, j] = pid
            pid += 1
    bt = torch.from_numpy(bt).cuda()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, bt, lens, ks, vs


def check_paged(gen, rows):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attn import paged_attn, paged_attn_plain

    lengths = [96, 70, 65, 0, 33, 128, 17, 81]       # slot 3 idle
    cases = [("B=8 KV=16 G=1 hd=64 ps=16", 8, 16, 1, 64, 16, 8, lengths,
              None, False),
             ("B=8 window=32", 8, 16, 1, 64, 16, 8, lengths, 32, False),
             ("B=8 int8 pages", 8, 16, 1, 64, 16, 8, lengths, None, True),
             ("B=4 KV=4 G=4 (GQA)", 4, 4, 4, 64, 16, 4, [50, 0, 64, 9],
              None, False)]
    main = None
    for label, b, kvh, g, hd, ps, p_max, lens, win, int8 in cases:
        q, kp, vp, bt, ln, ks, vs = _paged_case(
            gen, b, kvh, g, hd, ps, p_max, lens, torch.float32, int8)
        got = paged_attn(q, kp, vp, bt, ln, win, ks, vs)
        want = paged_attn_plain(q, kp, vp, bt, ln, win, ks, vs)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        idle_zero = bool((got[ln == 0] == 0).all())
        tol = KERNEL_TOL_REL * max(1.0, want.abs().max().item())
        # speed in the main path's dtype (bf16 q; bf16 or int8 pages)
        q, kp, vp, bt, ln, ks, vs = _paged_case(
            gen, b, kvh, g, hd, ps, p_max, lens, torch.bfloat16, int8)
        args = [(q, kp, vp, bt, ln, win, ks, vs)]
        ms = device_ms(paged_attn, args)
        plain_ms = device_ms(paged_attn_plain, args)
        # library yardstick: SDPA over the gathered (dequantized) pages
        s_len = p_max * ps
        kg = kp[bt.long()].reshape(b, s_len, kvh, hd)
        vg = vp[bt.long()].reshape(b, s_len, kvh, hd)
        if int8:
            kg = (kg.float() * ks[bt.long()].reshape(b, s_len, kvh, 1))
            vg = (vg.float() * vs[bt.long()].reshape(b, s_len, kvh, 1))
        kg = kg.to(torch.bfloat16).permute(0, 2, 1, 3).contiguous()
        vg = vg.to(torch.bfloat16).permute(0, 2, 1, 3).contiguous()
        kpos = torch.arange(s_len, device="cuda")
        mask = (kpos[None] < ln[:, None])
        if win is not None:
            mask &= kpos[None] >= ln[:, None] - win
        mask = mask[:, None, None, :]
        ql = q.reshape(b, kvh, g, hd)
        if g > 1:                   # SDPA's plain layout: repeat KV heads
            kg = kg.repeat_interleave(g, dim=1)
            vg = vg.repeat_interleave(g, dim=1)
            ql = ql.reshape(b, kvh * g, 1, hd)
        lib_ms = device_ms(F.scaled_dot_product_attention,
                           [(ql, kg, vg, mask)])
        live = sum(min(n_, win or n_) for n_ in lens)
        row_b = 1 if int8 else 2
        n_bytes = (q.numel() * 2 + 2 * live * kvh * hd * row_b
                   + (2 * live * kvh * 4 if int8 else 0)
                   + sum(-(-n_ // ps) for n_ in lens) * 4 + b * 4
                   + b * kvh * g * hd * 4)
        b_ms, b_by = bound(n_bytes, 4.0 * live * kvh * g * hd, "bfloat16")
        ok = err <= tol and idle_zero
        row = dict(kernel="paged_attn", shape=label, max_abs_err=err,
                   tol=tol, ok=ok, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        rows.append(row)
        say(f"  paged_attn      {label:30s} err {err:.3e} tol {tol:.3e} "
            f"idle-zero {idle_zero} {'ok' if ok else 'FAIL'}  ms {ms:.5f} "
            f"plain {plain_ms:.5f} lib {lib_ms:.5f} bound {b_ms:.5f}")
        if main is None:
            main = row
    return main


# ----------------------------------------------------------------------
# phase 2: end to end, f32, reduced depth
# ----------------------------------------------------------------------
class Recorder:
    """Passes through to the LM and keeps every call's logits."""

    def __init__(self, model):
        self.model = model
        self.calls = []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def decode_step(self, *a, **kw):
        out = self.model.decode_step(*a, **kw)
        self.calls.append(out.cpu())
        return out

    def prefill_chunk(self, *a, **kw):
        out = self.model.prefill_chunk(*a, **kw)
        self.calls.append(out.cpu())
        return out


def e2e_f32():
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.pruner import prune_linears
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"), num_layers=2,
                              dtype="float32")
    model = LM(cfg, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    params = prune_linears(model.init(gen), "2:4")
    rng = np.random.default_rng(1)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               size=(40, 23, 70, 9)[i % 4],
                                               dtype=np.int32),
                    max_new_tokens=12) for i in range(8)]
    runs = {}
    for label in ("kernels", "plain"):
        rec = Recorder(model)
        eng = ServeEngine(rec, params, max_batch=8, max_len=96,
                          page_size=16, prefill_chunk=32)
        if label == "plain":
            with ops.override_dispatch(plain=True):
                res = eng.generate(reqs)
        else:
            res = eng.generate(reqs)
        runs[label] = (res, rec.calls)
    (rk, ck), (rp, cp) = runs["kernels"], runs["plain"]
    if len(ck) != len(cp):
        fail("e2e: kernel and plain runs made different numbers of steps")
    max_diff, n_cmp = 0.0, 0
    for a, b in zip(ck, cp):
        max_diff = max(max_diff, (a - b).abs().max().item())
        n_cmp += 1
        if not torch.equal(a.argmax(-1), b.argmax(-1)):
            break                   # streams part here: later inputs differ
    say(f"  per-step logits: max |kernel - plain| {max_diff:.3e} over "
        f"{n_cmp} steps (tol {LOGIT_TOL:g})")
    if max_diff > LOGIT_TOL:
        fail(f"e2e logits differ by {max_diff:.3e} > {LOGIT_TOL:g}")
    n_tok = 0
    for a, b in zip(rk, rp):
        n_tok += len(b.tokens)
        diff = np.nonzero(a.tokens != b.tokens)[0]
        if len(diff) == 0:
            continue
        j = int(diff[0])
        ctx = np.concatenate([reqs[a.uid].prompt, b.tokens[:j]])
        with ops.override_dispatch(plain=True):
            lg = model.forward(params, torch.from_numpy(ctx)[None].cuda())
        top2 = torch.topk(lg[0, -1], 2).values
        gap = (top2[0] - top2[1]).item()
        say(f"  request {a.uid}: streams part at token {j}; plain top-two "
            f"gap there {gap:.3e}")
        if gap >= LOGIT_TOL:
            fail(f"e2e stream of request {a.uid} differs at token {j} with "
                 f"a top-two gap {gap:.3e} >= {LOGIT_TOL:g}")
    say(f"  greedy streams: {n_tok} tokens, kernels == plain except near "
        "ties printed above")


# ----------------------------------------------------------------------
# phase 3: the main path
# ----------------------------------------------------------------------
def main_path():
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.pruner import prune_linears
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_config("qwen1.5-0.5b")
    model = LM(cfg, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = prune_linears(model.init(gen), "2:4")
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=64,
                                               dtype=np.int32),
                    max_new_tokens=32) for i in range(8)]
    long_req = [Request(uid=100, prompt=rng.integers(
        0, cfg.vocab_size, size=512, dtype=np.int32), max_new_tokens=32)]
    runs = [("8 requests, bf16 KV",
             dict(max_batch=8, max_len=128, page_size=16, prefill_chunk=32),
             reqs),
            ("512-token prompt, chunk 256",
             dict(max_batch=8, max_len=576, page_size=16,
                  prefill_chunk=256), long_req),
            ("8 requests, int8 KV",
             dict(max_batch=8, max_len=128, page_size=16, prefill_chunk=32,
                  kv_dtype="int8"), reqs)]
    engines = [ServeEngine(model, params, **runs[0][1])]
    del params                                      # the engine packed them
    engines += [ServeEngine(model, engines[0].params, **kw)
                for _, kw, _ in runs[1:]]
    packed = engines[0].n_sparse_leaves
    say(f"  packed {packed} linears (24 layers x 7)")
    if packed != cfg.num_layers * 7:
        fail(f"expected {cfg.num_layers * 7} packed linears, got {packed}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()                       # the main path starts
    outs = {}
    for (label, kw, rq), eng in zip(runs, engines):
        t0 = time.monotonic()
        res = eng.generate(rq)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        toks = sum(len(r.tokens) for r in res)
        st = eng.stats
        say(f"  {label}: {toks} tokens in {dt:.3f} s = {toks / dt:.1f} "
            f"tok/s; host syncs/token {st['host_syncs'] / toks:.3f}; "
            f"device steps/sync {st['device_steps'] / st['host_syncs']:.2f}"
            f"; prefill chunks {st['prefill_chunks']}; preemptions "
            f"{st['preemptions']}")
        for r in res:
            if len(r.tokens) != r_max(rq, r.uid) or (
                    r.tokens.min() < 0 or r.tokens.max() >= cfg.vocab_size):
                fail(f"{label}: request {r.uid} emitted a bad stream "
                     f"{r.tokens.tolist()}")
        outs[label] = (res, toks / dt, st["host_syncs"] / toks)
    counts = ops.launch_counts()                    # ... and ends
    hbm = torch.cuda.max_memory_allocated()
    say(f"  launch counters over the main path: {counts}")
    say(f"  HBM held (max_memory_allocated): {hbm / 2**30:.3f} GiB")
    for name, c in counts.items():
        if c <= 0:
            fail(f"kernel {name} was not launched on the main path")
    a = outs["8 requests, bf16 KV"][0]
    b = outs["8 requests, int8 KV"][0]
    same = sum(int(np.sum(x.tokens == y.tokens)) for x, y in zip(a, b))
    say(f"  int8 vs bf16 KV: {same}/{sum(len(x.tokens) for x in a)} tokens "
        "equal position by position (random init: no gate)")
    return counts, outs, hbm, engines[0], reqs


def r_max(reqs, uid):
    return next(r.max_new_tokens for r in reqs if r.uid == uid)


def profile_main(eng, reqs):
    """Device busy / idle share and device time by kernel for one
    main-path generate (8 requests)."""
    import torch

    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        res = eng.generate(reqs)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    evs = _device_us(prof)
    busy = sum(d for d, _ in evs) / 1e6
    by = {}
    for d, name in evs:
        key = ("nm_spmm kernels" if "nm_spmm_kernel" in name
               else "paged_attn kernel" if "paged_attn_kernel" in name
               else name[:60])
        by[key] = by.get(key, 0.0) + d / 1e6
    toks = sum(len(r.tokens) for r in res)
    say(f"  profiled run: wall {wall:.3f} s, device busy {busy:.3f} s, "
        f"idle share {1 - busy / wall:.3f}, {len(evs)} kernels, "
        f"{len(evs) / max(1, eng.stats['device_steps'] + eng.stats['prefill_chunks']):.0f} per step")
    for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:10]:
        say(f"    {k:60s} {v * 1e3:9.3f} ms  ({v / wall:.3f} of wall)")
    return dict(wall_s=wall, busy_s=busy, tokens=toks)


# ----------------------------------------------------------------------
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    say(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    from repro_torch.kernels import build, ops

    t0 = time.monotonic()
    build.library()
    say(f"phase 0: kernels built and loaded in {time.monotonic() - t0:.1f} s"
        f" (nvcc ran: {build.build_seconds is not None})")
    for line in build.ptxas_report().splitlines():
        LOG.append("  " + line)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    say("phase 1: kernels against their plain versions")
    per_kernel = check_nm_spmm(gen, rows)
    paged_main = check_paged(gen, rows)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"{len(bad)} kernel checks out of tolerance: "
             f"{[(r['kernel'], r['shape']) for r in bad]}")

    say("phase 2: end to end, f32, Qwen width, 2 layers")
    e2e_f32()

    say("phase 3: main path, Qwen1.5-0.5B, 24 layers, bf16, 2:4-packed")
    counts, outs, hbm, eng, reqs = main_path()

    say("phase 4: profile of one main-path run (8 requests)")
    prof = profile_main(eng, reqs)

    sources = {"nm_spmm": ("nm_spmm.cu", "nm_spmm.py:68"),
               "nm_spmm_decode": ("nm_spmm.cu", "nm_spmm.py:130"),
               "paged_attn": ("paged_attn.cu", "paged_attn.py:97")}

    def agg(name, rs, at):
        cu, tpu = sources[name]
        return {"name": name, "route": "cuda", "check": "pass",
                "source": f"src/repro_torch/kernels/csrc/{cu}",
                "replaces": f"src/repro/kernels/{tpu}",
                "launches": counts[name],
                "max_abs_err": max(r["max_abs_err"] for r in rows
                                   if r["kernel"] == name),
                "ms": sum(r["ms"] for r in rs),
                "plain_ms": sum(r["plain_ms"] for r in rs),
                "bound_ms": sum(r["bound_ms"] for r in rs),
                "bound_by": rs[0]["bound_by"],
                "library_ms": sum(r["library_ms"] for r in rs),
                "at": at}

    kernels = [
        agg("nm_spmm_decode", per_kernel["nm_spmm_decode"],
            "sum over the 7 linears of one layer, M=8, bf16"),
        agg("nm_spmm", per_kernel["nm_spmm"],
            "sum over the 7 linears of one layer, M=256, bf16"),
        agg("paged_attn", [paged_main],
            "B=8 KV=16 G=1 hd=64 ps=16, bf16 pages"),
    ]
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with open(ROOT / "chiprun_out" / "chip_smoke.txt", "w") as f:
        f.write("\n".join(LOG) + "\n")
        f.write(json.dumps({"rows": rows, "profile": prof}) + "\n")
    say(f"all phases passed in {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
