"""The port's pruning pass on the Mamba LM, on the CPU against the JAX
package: each method's mask and weights at a fixed (w, H) for the four
Mamba linears, and the whole engine — the port's default pipelined one
against the reference's serial one — for magnitude, wanda, SS, SM and
MM, with tests/test_torch_prune_e2e.py's bounds:

  * layer 0 (identical inputs up to the embedding) gives equal masks;
  * the free-running engines agree on ≥ 98 % of each mask, on each
    linear's reconstruction error within 1e-2 relative, and on the
    pruned perplexity within 1e-3 relative.

At a fixed (w, H) both packages run the same f32 operations: masks are
equal and weights agree to W_TOL of their scale (tests/test_torch_prune.py).
The model is the Mamba LM at smoke size with its keyed init carried
across; the calibration and evaluation tokens are the synthetic
corpus's.  The Mamba linears stay dense under 2:4 serving: the packing
patterns name ``mlp`` and ``attn`` only, as the reference's do.

A model with leading ``cfg.prefix`` blocks (tests/test_torch_mamba_serve's
``PREFIX_TWIN`` with a MoE in its Mamba prefix block) prunes its
``prefix{i}`` segments, then its periods: MS 2:4 through the port's
pipelined engine against the reference's pipelined one, with the same
bounds.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.store import _flatten
from repro.core.engine import PruningEngine as JEngine
from repro.core.pruner import prune_matrix as j_prune_matrix
from repro.data import DataPipeline as JPipe
from repro.data import calibration_batches
from repro.models import LM as JLM
from repro.models.base import ArchConfig as JArchConfig
from repro_torch.configs.paper_tiny_lm import MAMBA
from repro_torch.core.engine import PruningEngine
from repro_torch.core.masks import validate_nm
from repro_torch.core.pruner import prune_linears, prune_matrix
from repro_torch.models.base import ArchConfig
from repro_torch.models.transformer import LM
from repro_torch.serve.sparse import compressed_param_tree, count_packed

W_TOL = 2e-6
MAMBA_SMOKE = dict(dataclasses.asdict(MAMBA), name="paper-tiny-mamba-smoke",
                   num_layers=2, d_model=64, vocab_size=256)
METHODS = [("magnitude", "0.5"), ("wanda", "0.5"), ("SS", "0.5"),
           ("SM", "0.5"), ("MM", "2:4")]
BLOCK = 32
LINEARS = ("in_proj", "x_proj", "dt_proj", "out_proj")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs several workers on the machine's
    cores, and torch's default pool of a thread a core in each of them
    oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    with jax.threefry_partitionable(True):
        jm = JLM(JArchConfig(**MAMBA_SMOKE))
        jp = jax.jit(jm.init)(jax.random.key(0))
    tm = LM(ArchConfig(**MAMBA_SMOKE), device="cpu")
    calib = calibration_batches(jm.cfg, n_samples=8, seq_len=32, batch=4)
    evals = [JPipe(jm.cfg, 8, 32, seed=0).eval_batch(i) for i in range(2)]
    # layer 0's captured linear inputs, for the fixed-(w, H) cases
    seg = jm.prunable_segments()[0]
    _, caps = jax.jit(functools.partial(seg.apply, capture=True))(
        seg.get_params(jp), jm.calib_init(jp, calib[0]))
    return jm, jp, tm, tm.params_from_jax(_flatten(jp)), calib, evals, caps


def _tb(b):
    return {k: torch.from_numpy(np.array(b[k])) for k in ("tokens", "labels")}


def _ppl(loss_fn, params, batches):
    """Perplexity over ``batches`` (the reference's ``loss_fn`` jitted by
    the caller)."""
    tot = cnt = 0.0
    for b in batches:
        _, m = loss_fn(params, b)
        tot += float(m["ce"]) * float(m["tokens"])
        cnt += float(m["tokens"])
    return float(np.exp(tot / cnt))


@pytest.mark.parametrize("method,spec", METHODS)
def test_masks_at_fixed_w_and_h_match_reference(setup, method, spec):
    """Layer 0's ``in_proj`` (m = 64, the widest output) and ``dt_proj``
    (m = 4, a single 2:4 group a row and a block narrower than the
    blocksize) with the Hessian of their own captured inputs; x_proj and
    out_proj (m = 128) are held through the engine case below."""
    jm, jp, _, _, _, _, caps = setup
    for name in ("in_proj", "dt_proj"):
        x = np.asarray(caps[f"s0.mamba.{name}"], np.float32)
        x = x.reshape(-1, x.shape[-1])
        hmat = (2.0 * x.T @ x / x.shape[0]).astype(np.float32)
        w = np.asarray(jp["layers"]["s0"]["mamba"][name][0]).T  # (out, in)
        bs = min(BLOCK, w.shape[1])
        jr = j_prune_matrix(jnp.asarray(w), jnp.asarray(hmat), spec,
                            method=method, blocksize=bs)
        tr = prune_matrix(torch.from_numpy(w.copy()), torch.from_numpy(hmat),
                          spec, method=method, blocksize=bs)
        np.testing.assert_array_equal(tr.mask.numpy(), np.asarray(jr.mask),
                                      err_msg=name)
        want = np.asarray(jr.w)
        assert np.abs(tr.w.numpy() - want).max() <= (
            W_TOL * max(1.0, np.abs(want).max())), name
        if spec == "2:4":
            assert validate_nm(tr.mask, 2, 4)


@pytest.mark.parametrize("method,spec", METHODS)
def test_engine_matches_reference_on_mamba(setup, method, spec):
    jm, jp, tm, tp, calib, evals, _ = setup
    jpr, jrep = JEngine(jm, spec, method=method, blocksize=BLOCK,
                        pipeline="off").run(jp, calib)
    tpr, trep = PruningEngine(tm, spec, method=method, blocksize=BLOCK).run(
        tp, [_tb(b) for b in calib])
    assert [r.name for r in trep] == [r.name for r in jrep]
    assert len(trep) == 2 * len(LINEARS)
    for tr, jr in zip(trep, jrep):
        assert tr.shape == jr.shape
        assert tr.sparsity == pytest.approx(jr.sparsity, abs=1e-6)
        assert tr.recon_error == pytest.approx(jr.recon_error, rel=1e-2,
                                               abs=1e-9)
    jl = _flatten(jpr)
    tl = tm.params_to_flat(tpr)
    for name in LINEARS:
        k = f"layers/s0/mamba/{name}"
        a, b = np.asarray(jl[k]) == 0, tl[k] == 0
        assert (a[0] == b[0]).all(), f"{k} layer 0"
        assert (a == b).mean() >= 0.98, k
    pj = _ppl(jax.jit(jm.loss_fn), jpr, evals)
    pt = _ppl(tm.loss_fn, tpr, [_tb(b) for b in evals])
    assert np.isfinite(pt) and pt == pytest.approx(pj, rel=1e-3)


def test_prefix_blocks_prune_matches_reference():
    from repro.models.base import MoEConfig as JMoEConfig
    from repro_torch.models.base import MoEConfig
    from test_torch_mamba_serve import PREFIX_MOE, PREFIX_TWIN

    fields = dict(PREFIX_TWIN, moe_prefix_slots=(1,))
    with jax.threefry_partitionable(True):
        jm = JLM(JArchConfig(**fields, moe=JMoEConfig(**PREFIX_MOE)))
        jp = jax.jit(jm.init)(jax.random.key(0))
    tm = LM(ArchConfig(**fields, moe=MoEConfig(**PREFIX_MOE)), device="cpu")
    tp = tm.params_from_jax(_flatten(jp))
    calib = calibration_batches(jm.cfg, n_samples=8, seq_len=32, batch=4)
    jpr, jrep = JEngine(jm, "2:4", method="MS", blocksize=BLOCK).run(
        jp, calib)
    tpr, trep = PruningEngine(tm, "2:4", method="MS", blocksize=BLOCK).run(
        tp, [_tb(b) for b in calib])
    assert [s.name for s in tm.prunable_segments()] == [
        "prefix0", "prefix1", "period0", "period1"]
    assert [r.name for r in trep] == [r.name for r in jrep]
    assert trep[0].name == "prefix0.attn.wq"
    assert "prefix1.moe.wi.3" in [r.name for r in trep]
    for tr, jr in zip(trep, jrep):
        assert tr.shape == jr.shape
        assert tr.sparsity == pytest.approx(jr.sparsity, abs=1e-6)
        assert tr.recon_error == pytest.approx(jr.recon_error, rel=1e-2,
                                               abs=1e-9)
    jl = _flatten(jpr)
    tl = tm.params_to_flat(tpr)
    for k in ("prefix/0/attn/wq", "prefix/0/mlp/wo", "prefix/1/mamba/in_proj",
              "layers/s0/attn/wo"):
        a, b = np.asarray(jl[k]) == 0, tl[k] == 0
        if k.startswith("prefix/0"):                  # layer 0: equal
            assert (a == b).all(), k
        assert (a == b).mean() >= 0.98, k


def test_serving_prune_leaves_mamba_dense():
    """``prune_linears`` (magnitude 2:4 for serving) and the engine's
    packing touch the ``mlp`` and ``attn`` linears only."""
    cfg = ArchConfig(name="hyb", family="hybrid", num_layers=2, d_model=64,
                     num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                     vocab_size=256, period=("mamba", "attn"),
                     mlp_kind="swiglu", ssm_mlp=True, ssm_state=4,
                     dtype="float32")
    tm = LM(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = prune_linears(tm.init(gen))
    assert all(bool((params["layers"][0]["mamba"][k] != 0).all())
               for k in LINEARS)
    packed = compressed_param_tree(params)
    assert count_packed(packed) == 2 * 3 + 4
    assert not any(isinstance(v, dict) and "vals" in v
                   for v in packed["layers"][0]["mamba"].values())
