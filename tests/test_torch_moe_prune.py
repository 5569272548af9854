"""Pruning a Mixture-of-Experts model in the port, on the CPU against the
JAX package.

* the weighted Hessian (``HessianAccumulator.update_weighted``) against
  the reference's ``_accum_update_weighted``: bool (routing validity) and
  float (gate) weights, an expert whose tokens all weigh 0, and the
  weighted merge of calibration shards, with the count on the device;
* ``CalibrationSet`` over one MoE segment's captures — ``(x, valid)``
  per expert, the router's input — against the reference's: the same
  names, Hessians within W_TOL;
* masks at a fixed (w, H) for expert linears, the empty expert's H = 0
  included, and the serial and pipelined engines on phi3.5's and kimi's
  SMOKE with SM 0.5 and MM 2:4 against the reference's engine, with the
  bounds of ``tests/test_torch_prune_e2e.py``;
* the prune CLI on phi3.5-moe's SMOKE.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.store import _flatten
from repro.configs import get_smoke as j_get_smoke
from repro.core.calibration import CalibrationSet as JCalib
from repro.core.engine import PruningEngine as JEngine
from repro.core.hessian import HessianAccumulator as JAcc
from repro.core.pruner import prune_matrix as j_prune_matrix
from repro.data import DataPipeline as JPipe
from repro.data import calibration_batches
from repro.models import LM as JLM
from repro_torch import configs
from repro_torch.core.calibration import CalibrationSet
from repro_torch.core.engine import PruningEngine
from repro_torch.core.hessian import HessianAccumulator
from repro_torch.core.masks import validate_nm
from repro_torch.core.pruner import prune_matrix
from repro_torch.kernels import hessian_accum
from repro_torch.launch import prune as launch_prune
from repro_torch.models.transformer import LM

ARCHS = ("phi3_5_moe_42b_a6_6b", "kimi_k2_1t_a32b")
W_TOL = 2e-6


@pytest.fixture(autouse=True)
def partitionable():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with jax.threefry_partitionable(True):
            yield
    finally:
        torch.set_num_threads(threads)


# ----------------------------------------------------------------------
# the weighted Hessian
# ----------------------------------------------------------------------
def _weights(kind, rng, n):
    if kind == "bool":
        return rng.random(n) > 0.4
    if kind == "float":
        return rng.random(n).astype(np.float32)
    return np.zeros(n, bool)                       # an empty expert


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["bool", "float", "empty"])
def test_update_weighted_matches_reference(kind, dtype):
    """Three batches into one accumulator, then a merge of two shards: H
    within W_TOL, the count equal, kept on the device as a 0-dim f32
    tensor; an empty expert keeps H = 0 and count 0."""
    rng = np.random.default_rng(0)
    shards = []
    for shard in range(2):
        j, t = JAcc(24), HessianAccumulator(24, weighted=True)
        for _ in range(3):
            x = rng.standard_normal((13, 24)).astype(np.float32)
            w = _weights(kind, rng, 13)
            xj = jnp.asarray(x).astype(dtype)
            j.update_weighted(xj.T, jnp.asarray(w))
            t.update_weighted_tokens(
                torch.from_numpy(x).to(getattr(torch, dtype)),
                torch.from_numpy(w))
        assert isinstance(t.count, torch.Tensor) and t.count.shape == ()
        np.testing.assert_allclose(t.h.numpy(), np.asarray(j.h), rtol=0,
                                   atol=W_TOL * max(1.0, np.abs(j.h).max()))
        assert float(t.count) == pytest.approx(float(j.count), rel=1e-6)
        shards.append((j, t))
    jm = JAcc.merge_many([j for j, _ in shards])
    tm = HessianAccumulator.merge_many([t for _, t in shards])
    np.testing.assert_allclose(tm.h.numpy(), np.asarray(jm.h), rtol=0,
                               atol=W_TOL * max(1.0, np.abs(jm.h).max()))
    assert float(tm.count) == pytest.approx(float(jm.count), rel=1e-6)
    if kind == "empty":
        assert float(tm.count) == 0.0 and not tm.h.any()
    pair = shards[0][1].merge(shards[1][1])
    np.testing.assert_allclose(pair.h.numpy(), tm.h.numpy(), rtol=0,
                               atol=W_TOL * max(1.0, float(tm.h.abs().max())))


@pytest.mark.parametrize("weights,route", [
    ("none", "tensor cores"), ("bool", "tensor cores"),
    ("float", "f32 FMA")])
def test_weighted_plan_routes(weights, route):
    """The route of a weighted launch at phi3.5's expert shapes: bool
    weights (0/1 scale bf16 rows exactly) keep the tensor cores, float
    weights take the f32 FMA; the split is the unweighted one."""
    for m in (4096, 6400):
        p = hessian_accum.plan(torch.bfloat16, 40960, m, True, 132,
                               weights=weights)
        assert p.route == route
        assert p.split == hessian_accum.plan(
            torch.bfloat16 if route == "tensor cores" else torch.float32,
            40960, m, True, 132).split
    assert hessian_accum.plan(torch.bfloat16, 40960, 130, True, 132,
                              weights="bool").route == "f32 FMA"
    with pytest.raises(ValueError):
        hessian_accum.plan(torch.bfloat16, 8, 64, True, 132, weights="x")


def test_weighted_and_plain_accumulators_do_not_mix():
    acc = HessianAccumulator(4, weighted=True)
    with pytest.raises(ValueError, match="update_weighted"):
        acc.update_tokens(torch.ones(3, 4))
    plain = HessianAccumulator(4)
    plain.update_tokens(torch.ones(3, 4))
    with pytest.raises(ValueError, match="update_tokens"):
        plain.update_weighted_tokens(torch.ones(3, 4), torch.ones(3))


# ----------------------------------------------------------------------
# one MoE segment
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _setup(arch):
    with jax.threefry_partitionable(True):
        jm = JLM(j_get_smoke(arch))
        jp = jax.jit(jm.init)(jax.random.key(0))
    tm = LM(configs.get_smoke(arch), device="cpu")
    calib = calibration_batches(jm.cfg, n_samples=8, seq_len=32, batch=4)
    evals = [JPipe(jm.cfg, 8, 32, seed=0).eval_batch(i) for i in range(2)]
    seg = jm.prunable_segments()[0]
    _, caps = jax.jit(functools.partial(seg.apply, capture=True))(
        seg.get_params(jp), jm.calib_init(jp, calib[0]))
    return jm, jp, tm, calib, evals, caps


def _tb(b):
    return {k: torch.from_numpy(np.array(b[k])) for k in ("tokens", "labels")}


@pytest.mark.parametrize("arch", ARCHS)
def test_calibration_set_matches_reference(arch):
    """The port's capture of segment 0 through ``CalibrationSet``: the
    reference's names (the router's included, which no linear reads),
    weighted Hessians for the experts, plain ones elsewhere."""
    jm, jp, tm, calib, _, caps = _setup(arch)
    tp = tm.params_from_jax(_flatten(jp))
    seg = tm.prunable_segments()[0]
    _, tcaps = seg.apply(seg.get_params(tp), tm.calib_init(tp, _tb(calib[0])),
                         capture=True)
    jset, tset = JCalib.from_captures(caps), CalibrationSet.from_captures(tcaps)
    assert sorted(tset.names()) == sorted(jset.names())
    assert "s0.moe.router" in tset.names()
    for name in jset.names():
        want = np.asarray(jset.hessian(name))
        np.testing.assert_allclose(
            tset.hessian(name).numpy(), want, rtol=0,
            atol=W_TOL * max(1.0, np.abs(want).max()), err_msg=name)
        assert tset.accs[name].weighted == (".moe.w" in name)
        assert float(tset.accs[name].count) == pytest.approx(
            float(jset.accs[name].count), rel=1e-6)


@pytest.mark.parametrize("method,spec", [("MM", "2:4"), ("SM", "0.5")])
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_masks_at_fixed_w_and_h_match_reference(arch, method, spec):
    """Every expert's wi and wo of segment 0 with the reference's weighted
    Hessian — and one expert with H = 0 (no routed token): the 1e-8
    dampening floor alone."""
    jm, jp, _, _, _, caps = _setup(arch)
    jset = JCalib.from_captures(caps)
    e_all = jm.cfg.moe.num_experts
    cases = [(f"s0.moe.{key}.{e}", key, e, np.array(
        jset.hessian(f"s0.moe.{key}.{e}"))) for key in ("wi", "wo")
        for e in range(e_all)]
    cases.append(("empty", "wi", 0, np.zeros_like(cases[0][3])))
    for name, key, e, hmat in cases:
        w = np.asarray(jp["layers"]["s0"]["moe"][key][0, e]).T  # (out, in)
        jr = j_prune_matrix(jnp.asarray(w), jnp.asarray(hmat), spec,
                            method=method, blocksize=32)
        tr = prune_matrix(torch.from_numpy(w.copy()), torch.from_numpy(hmat),
                          spec, method=method, blocksize=32)
        np.testing.assert_array_equal(tr.mask.numpy(), np.asarray(jr.mask),
                                      err_msg=name)
        want = np.asarray(jr.w)
        assert np.abs(tr.w.numpy() - want).max() <= (
            W_TOL * max(1.0, np.abs(want).max())), name
        if spec == "2:4":
            assert validate_nm(tr.mask, 2, 4)


def _ppl(loss_fn, params, batches):
    tot = cnt = 0.0
    for b in batches:
        _, m = loss_fn(params, b)
        tot += float(m["ce"]) * float(m["tokens"])
        cnt += float(m["tokens"])
    return float(np.exp(tot / cnt))


_JRUNS = {}


def _reference_run(arch, method, spec):
    if (arch, method) not in _JRUNS:
        jm, jp, _, calib, _, _ = _setup(arch)
        _JRUNS[arch, method] = JEngine(jm, spec, method=method, blocksize=32,
                                       pipeline="off").run(jp, calib)
    return _JRUNS[arch, method]


@pytest.mark.parametrize("pipeline", ["off", "on"])
@pytest.mark.parametrize("method,spec", [("MM", "2:4"), ("SM", "0.5")])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(arch, method, spec, pipeline):
    """Both SMOKE layers through the port's serial and pipelined engines
    (the pipelined one in two calibration shards: the weighted merge)
    against the reference's serial engine: the same linears in the same
    order, layer 0's masks equal, ≥ 98 % of layer 1's, each linear's
    reconstruction error within 1e-2 relative and the perplexity within
    1e-3."""
    jm, jp, tm, calib, evals, _ = _setup(arch)
    jpr, jrep = _reference_run(arch, method, spec)
    eng = PruningEngine(tm, spec, method=method, blocksize=32,
                        pipeline=pipeline,
                        calib_shard=2 if pipeline == "on" else "auto")
    tpr, trep = eng.run(tm.params_from_jax(_flatten(jp)),
                        [_tb(b) for b in calib])
    assert [r.name for r in trep] == [r.name for r in jrep]
    if pipeline == "on":
        assert eng.last_pipeline_stats.calib_shards == 2
    for tr, jr in zip(trep, jrep):
        assert tr.shape == jr.shape
        assert tr.sparsity == pytest.approx(jr.sparsity, abs=1e-6)
        assert tr.recon_error == pytest.approx(jr.recon_error, rel=1e-2,
                                               abs=1e-9), tr.name
    jl, tl = _flatten(jpr), tm.params_to_flat(tpr)
    for k in jl:
        if not k.startswith("layers/") or k.endswith(("scale", "router")):
            continue
        a, b = np.asarray(jl[k]) == 0, tl[k] == 0
        assert (a[0] == b[0]).all(), f"{k} layer 0"
        assert (a[1] == b[1]).mean() >= 0.98, f"{k} layer 1"
    pj = _ppl(jax.jit(jm.loss_fn), jpr, evals)
    pt = _ppl(tm.loss_fn, tpr, [_tb(b) for b in evals])
    assert np.isfinite(pt) and pt == pytest.approx(pj, rel=1e-3)


def test_prune_cli_on_phi_moe(tmp_path, capsys):
    launch_prune.main(["--arch", "phi3.5-moe-42b-a6.6b", "--smoke",
                       "--device", "cpu", "--method", "MM", "--sparsity",
                       "2:4", "--calib-samples", "8", "--out",
                       str(tmp_path)])
    out = capsys.readouterr().out
    e = configs.get_smoke("phi3_5_moe_42b_a6_6b").moe.num_experts
    assert f"pruned {2 * (4 + 3 * e)} linears, mean sparsity 0.500" in out
    assert "saved to" in out
