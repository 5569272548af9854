#!/usr/bin/env python3
"""Time the port's nm_spmm, nm_spmm_decode, flash_attn, hessian_accum,
paged_attn and nm_select of two source trees on one card, in turns (A, B,
B, A), at the main paths' shapes.

    python3 scripts/torch_kernel_ab.py --tree build/parent --tree .

Each ``--tree`` is a checkout of the repository; its ``src/repro_torch``
is imported in a fresh process (so that two versions of the package never
meet) and builds its own kernels under its own ``build/``.  Per tree and
turn it prints one JSON line: the device time (ms) of the seven Qwen1.5-0.5B
linears at M = 256 through ``nm_spmm`` and at M = 8 (a decode step) and 32
(a prefill chunk) through ``nm_spmm_decode`` with each linear's bias and
activation (bf16, weights rotated past the 50 MB L2, summed over the
layer), of ``flash_attn`` at (8 | 128, 2048, 16, 64) bf16 causal, and of
``hessian_accum`` on the pipelined engine's stacked capture (T = 262144
bf16 tokens, m = 1024 and 2816, α = 1/T, β = 0), of ``paged_attn`` on bf16
pages (KV 16, hd 64, page 16) at B = 8 with chip_smoke's lengths, at the
long-prompt serving run's B = 8 (one slot at 544 keys in a 36-page table)
and at B = 1 over 544 keys, and of ``nm_select`` on one 128-column bf16 block of a
1024- and a 2816-row weight (strided views of w and Hinv, as the MM loop
hands them over), each beside its PyTorch yardstick (``torch.matmul`` on
the dense weight, ``scaled_dot_product_attention`` — on the gathered pages
for paged_attn —, ``torch.addmm`` on the f32 copy of the capture; none
for nm_select) timed in the same process, and the time of an empty kernel
(one float add) between back-to-back launches; for a tree that plans its
decode launches, the cluster size each linear gets.  Device times come
from CUDA events around back-to-back calls while a spin kernel holds the
card, median of 5.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

LINEARS = ((1024, 1024),) * 4 + ((1024, 2816),) * 2 + ((2816, 1024),)
EPILOGUES = ((True, None),) * 3 + ((False, None),) * 2 + ((False, "silu"),
                                                         (False, None))
L2_BYTES = 50 * 2**20


def _device_ms(fn, arg_sets, n=30, reps=5):
    import torch

    for a in arg_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fn(*arg_sets[i % len(arg_sets)])
    spin_s = 2 * (time.perf_counter() - t0) + 1e-3
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    times = []
    while len(times) < reps:
        torch.cuda._sleep(int(spin_s * 2.0e9))
        e0.record()
        t0 = time.perf_counter()
        for i in range(n):
            fn(*arg_sets[(len(times) * n + i) % len(arg_sets)])
        e1.record()
        enq = time.perf_counter() - t0
        torch.cuda.synchronize()
        if enq < spin_s:
            times.append(e0.elapsed_time(e1) / n)
        else:
            spin_s *= 2
    return statistics.median(times)


def measure(tree: str) -> dict:
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    import torch.nn.functional as F

    from repro_torch.core.pruner import prune_linears
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.flash_attn import flash_attn
    from repro_torch.kernels.hessian_accum import hessian_accum
    from repro_torch.kernels import nm_spmm as K
    from repro_torch.kernels.nm_spmm import nm_spmm, nm_spmm_decode
    from repro_torch.kernels.nm_select import nm_select
    from repro_torch.kernels.paged_attn import paged_attn

    torch.backends.cuda.matmul.allow_tf32 = False
    build.library()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    tiny = torch.zeros(1, device="cuda")
    res = {"tree": tree, "empty_launch_ms": _device_ms(lambda a: a.add_(1),
                                                       [(tiny,)]),
           "nm_spmm_ms": 0.0, "matmul_ms": 0.0}
    for k, n in LINEARS:
        w = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
        w = prune_linears({"layers": [{"mlp": {"wo": w}}]},
                          "2:4")["layers"][0]["mlp"]["wo"].to(torch.bfloat16)
        vals, idx = ops.compress_24(w)
        x = torch.randn(256, k, generator=gen, device="cuda").to(
            torch.bfloat16)
        reps = max(2, -(-2 * L2_BYTES // (vals.numel() * 3)))
        sets = [(x, vals.clone(), idx.clone()) for _ in range(reps)]
        res["nm_spmm_ms"] += _device_ms(nm_spmm, sets)
        res["matmul_ms"] += _device_ms(torch.matmul,
                                       [(x, w.clone()) for _ in range(reps)])
        del sets
    for m in (8, 32):
        res[f"decode_m{m}_ms"] = res[f"decode_m{m}_matmul_ms"] = 0.0
        for (k, n), (has_bias, act) in zip(LINEARS, EPILOGUES):
            w = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
            w = prune_linears({"layers": [{"mlp": {"wo": w}}]}, "2:4")[
                "layers"][0]["mlp"]["wo"].to(torch.bfloat16)
            vals, idx = ops.compress_24(w)
            x = torch.randn(m, k, generator=gen, device="cuda").to(
                torch.bfloat16)
            bias = (torch.randn(n, generator=gen, device="cuda").to(
                torch.bfloat16) if has_bias else None)
            reps = max(2, -(-2 * L2_BYTES // (vals.numel() * 3)))
            sets = [(x, vals.clone(), idx.clone(), bias, act)
                    for _ in range(reps)]
            res[f"decode_m{m}_ms"] += _device_ms(nm_spmm_decode, sets)
            res[f"decode_m{m}_route"] = getattr(nm_spmm_decode,
                                                "last_kernel", None)
            plan = getattr(K, "_decode_plan", None)
            if plan is not None:       # blocks a cluster, per linear
                res.setdefault(f"decode_m{m}_clusters", []).append(plan(
                    torch.bfloat16, m, k, n, True,
                    torch.cuda.current_device()).cluster)
            res[f"decode_m{m}_matmul_ms"] += _device_ms(
                torch.matmul, [(x, w.clone()) for _ in range(reps)])
            del sets
    t = 128 * 2048
    for m in (1024, 2816):
        x = torch.randn(t, m, generator=gen, device="cuda").to(torch.bfloat16)
        h = torch.empty(m, m, device="cuda")
        res[f"hessian_m{m}_ms"] = _device_ms(
            hessian_accum, [(x, h, 1.0 / t, 0.0)], n=3, reps=3)
        res[f"hessian_m{m}_route"] = getattr(hessian_accum, "last_kernel",
                                             None)
        x32 = x.float()
        res[f"hessian_m{m}_addmm_ms"] = _device_ms(
            lambda a: torch.addmm(h, a.T, a, beta=0.0, alpha=2.0 / t),
            [(x32,)], n=3, reps=3)
        del x, x32, h
    for b in (8, 128):
        q, k, v = (torch.randn(b, 2048, 16, 64, generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        n, reps = (30, 5) if b == 8 else (5, 3)
        res[f"flash_b{b}_ms"] = _device_ms(flash_attn, [(q, k, v, True)],
                                           n=n, reps=reps)
        res[f"flash_b{b}_route"] = flash_attn.last_kernel
        res[f"sdpa_b{b}_ms"] = _device_ms(
            lambda a, b_, c: F.scaled_dot_product_attention(
                a, b_, c, is_causal=True),
            [(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))],
            n=n, reps=reps)
        del q, k, v
    for label, b, p_max, lens in (("b8", 8, 8, [96, 70, 65, 0, 33, 128, 17,
                                                 81]),
                                  ("b8long", 8, 36, [544] + [0] * 7),
                                  ("b1", 1, 34, [544])):
        q, kp, vp, bt, ln = _paged_inputs(gen, b, p_max, lens)
        res[f"paged_{label}_ms"] = _device_ms(paged_attn,
                                              [(q, kp, vp, bt, ln)])
        plan = getattr(paged_attn, "last_plan", None)
        if plan is not None:
            res[f"paged_{label}_plan"] = [plan.split, plan.pages]
        s_len = p_max * 16
        kg, vg = (t[bt.long()].reshape(b, s_len, 16, 64).transpose(1, 2)
                  .contiguous() for t in (kp, vp))
        mask = (torch.arange(s_len, device="cuda")[None]
                < ln[:, None])[:, None, None, :]
        res[f"paged_{label}_sdpa_ms"] = _device_ms(
            F.scaled_dot_product_attention, [(q, kg, vg, mask)])
    for r in (1024, 2816):
        a = torch.randn(1024, 1024, generator=gen, device="cuda")
        hinv = a @ a.T / 1024 + torch.eye(1024, device="cuda")
        w = torch.randn(r, 1024, generator=gen, device="cuda").to(
            torch.bfloat16)
        res[f"nm_select_r{r}_ms"] = _device_ms(
            nm_select, [(w[:, 128:256], hinv[128:256, 128:256])])
        res[f"nm_select_r{r}_route"] = getattr(nm_select, "last_kernel",
                                               None)
    return res


def _paged_inputs(gen, b, p_max, lengths):
    """bf16 q (B, 16, 1, 64) and pages (B·p_max + 1, 16, 16, 64), each
    request's pages in order from page 1 on."""
    import numpy as np
    import torch

    q = torch.randn(b, 16, 1, 64, generator=gen,
                    device="cuda").to(torch.bfloat16)
    kp, vp = (torch.randn(b * p_max + 1, 16, 16, 64, generator=gen,
                          device="cuda").to(torch.bfloat16)
              for _ in range(2))
    bt = np.zeros((b, p_max), np.int32)
    pid = 1
    for i, n in enumerate(lengths):
        for j in range(-(-n // 16)):
            bt[i, j] = pid
            pid += 1
    return (q, kp, vp, torch.from_numpy(bt).cuda(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="a checkout to time (give two: A then B)")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        import torch

        if not torch.cuda.is_available():
            print("torch_kernel_ab: CUDA is not available", file=sys.stderr)
            return 2
        print(json.dumps(measure(args.measure)), flush=True)
        return 0
    if len(args.tree) != 2:
        ap.error("give exactly two --tree")
    a, b = args.tree
    for tree in (a, b, b, a):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--measure", tree], capture_output=True,
                              text=True)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
