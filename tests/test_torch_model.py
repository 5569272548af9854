"""The port's configs, dense LM, pruning masks and checkpoint reader on
CPU against the JAX package, with the weights carried across.

Tolerance 1e-4 on f32 logits: both sides run the same f32 op sequence,
but CPU BLAS (PyTorch's vs XLA's) sums in different orders, and the
differences grow through a few layers to ~1e-6 relative of logits of
order 1; 1e-4 leaves room without hiding a real fault (a wrong
mask, position or scale moves logits by 1e-2 or more).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.store import _flatten, save_pytree
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.core.pruner import prune_matrix as j_prune_matrix
from repro.core.sparsity import SparsitySpec as JSpec
from repro.models import LM as JLM
from repro.models.base import ArchConfig as JArchConfig
from repro.serve.sparse import sparsify_params
from repro_torch import configs
from repro_torch.ckpt import load_pytree
from repro_torch.core.pruner import prune_linears, prune_matrix
from repro_torch.core.sparsity import SparsitySpec
from repro_torch.models.base import ArchConfig
from repro_torch.models.transformer import LM
from repro_torch.serve.sparse import compressed_param_tree, count_packed

TOL = 1e-4
ARCHS = ("paper_tiny_lm", "qwen1_5_0_5b")
LINEARS = (("attn", ("wq", "wk", "wv", "wo")), ("mlp", ("wi", "wg", "wo")))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs several workers on the machine's
    cores, and torch's default pool of a thread a core in each of them
    oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("arch", (*ARCHS, "paligemma_3b",
                                  "seamless_m4t_large_v2"))
def test_arch_config_matches_reference(arch):
    assert ([f.name for f in dataclasses.fields(ArchConfig)]
            == [f.name for f in dataclasses.fields(JArchConfig)])
    for port, ref in ((configs.get_config(arch), j_get_config(arch)),
                      (configs.get_smoke(arch), j_get_smoke(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.hd == ref.hd and port.n_periods == ref.n_periods
    assert configs.canonical("qwen1.5-0.5b") == "qwen1_5_0_5b"
    assert configs.canonical("paligemma-3b") == "paligemma_3b"
    with pytest.raises(KeyError):
        configs.canonical("paligemma-4b")


def test_sparsity_spec_matches_reference():
    for text in ("2:4", "1:4", "0.5", "0.25"):
        a, b = SparsitySpec.parse(text), JSpec.parse(text)
        assert (a.rate, a.n, a.m, a.fraction) == (b.rate, b.n, b.m, b.fraction)
    with pytest.raises(ValueError):
        SparsitySpec.parse("4:4")


def _models(arch, seed=0):
    jm = JLM(j_get_smoke(arch))
    jp = jm.init(jax.random.key(seed))
    tm = LM(configs.get_smoke(arch), device="cpu")
    return jm, jp, tm


def _j_magnitude_24(jp):
    """Magnitude 2:4 on the JAX side, as pruner.prune_matrix does it:
    paper orientation wᵀ (out, in), layer by layer."""
    layers = jp["layers"]["s0"]
    for sub, names in LINEARS:
        for name in names:
            w = layers[sub][name]
            layers[sub][name] = jnp.stack([
                j_prune_matrix(w[i].T, jnp.eye(w.shape[1]), "2:4",
                               method="magnitude").w.T
                for i in range(w.shape[0])])
    return jp


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch):
    jm, jp, tm = _models(arch)
    tp = tm.params_from_jax(_flatten(jp))
    toks = np.random.default_rng(0).integers(0, 256, size=(2, 13)).astype(
        np.int32)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got = tm.forward(tp, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (2, 13, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("variant", ["dense", "packed_int8"])
def test_prefill_chunks_and_decode_match_reference(arch, variant):
    """Two requests prefilled in 4-token chunks (crossing page and chunk
    boundaries), then decode steps with a third, idle slot; packed 2:4
    weights and int8 pages in the second variant."""
    jm, jp, tm = _models(arch, seed=1)
    int8 = variant == "packed_int8"
    if int8:
        jp = sparsify_params(_j_magnitude_24(jp))
    tp = tm.params_from_jax(_flatten(jp))
    assert count_packed(tp) == (14 if int8 else 0)
    ps, n_pages, chunk = 4, 16, 4
    jcache = jm.init_paged_cache(n_pages, ps, jnp.int8 if int8 else None)
    tcache = tm.init_paged_cache(n_pages, ps, torch.int8 if int8 else None)
    prefill = jax.jit(jm.prefill_chunk, static_argnames=("page_size",))
    decode = jax.jit(jm.decode_step, static_argnames=("page_size",))
    bt = np.zeros((3, 5), np.int32)
    bt[0, :4] = [3, 1, 7, 2]
    bt[1, :3] = [4, 9, 5]
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, size=11), rng.integers(0, 256, size=6)]
    for slot, prompt in enumerate(prompts):
        for start in range(0, len(prompt), chunk):
            c = np.zeros((1, chunk), np.int32)
            piece = prompt[start:start + chunk]
            c[0, :len(piece)] = piece
            want, jcache = prefill(
                jp, {"tokens": jnp.asarray(c)}, jcache, jnp.int32(start),
                jnp.int32(len(prompt)), jnp.int32(slot),
                jnp.asarray(bt[slot:slot + 1]), page_size=ps)
            got = tm.prefill_chunk(tp, torch.from_numpy(c), tcache, start,
                                   len(prompt),
                                   torch.from_numpy(bt[slot:slot + 1]),
                                   page_size=ps)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=TOL, atol=TOL)
    tok = np.asarray([5, 17, 0], np.int32)
    pos = np.asarray([11, 6, -1], np.int32)
    live = pos >= 0
    for _ in range(4):
        want, jcache = decode(
            jp, jnp.asarray(tok), jcache, jnp.asarray(pos),
            paged={"block_tables": jnp.asarray(bt)}, page_size=ps)
        got = tm.decode_step(tp, torch.from_numpy(tok), tcache,
                             torch.from_numpy(pos), torch.from_numpy(bt),
                             page_size=ps)
        np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                                   rtol=TOL, atol=TOL)
        tok = np.where(live, np.asarray(want).argmax(-1), 0).astype(np.int32)
        pos = np.where(live, pos + 1, -1).astype(np.int32)
    # the pool the port wrote in place holds the reference's K/V rows (an
    # int8 row may round one step apart where the two BLAS differ in the
    # last bit of a value that sits on a rounding boundary)
    for i in range(tm.cfg.num_layers):
        for key in tcache[i]:
            step = 1.0 if tcache[i][key].dtype == torch.int8 else 0.0
            np.testing.assert_allclose(
                tcache[i][key].float().numpy()[1:],
                np.asarray(jcache["layers"]["s0"][key][i],
                           np.float32)[1:], rtol=TOL, atol=TOL + step)


def test_params_from_jax_unstacks_layers_and_keeps_packed_leaves():
    jm, jp, tm = _models("qwen1_5_0_5b")
    jpp = sparsify_params(_j_magnitude_24(jp))
    tp = tm.params_from_jax(_flatten(jpp))
    assert len(tp["layers"]) == 2
    wq = tp["layers"][1]["attn"]["wq"]
    assert set(wq) == {"vals", "idx"} and wq["idx"].dtype == torch.int8
    np.testing.assert_array_equal(
        wq["vals"].numpy(), np.asarray(jpp["layers"]["s0"]["attn"]["wq"]
                                       ["vals"][1]))
    np.testing.assert_array_equal(
        tp["layers"][0]["attn"]["bq"].numpy(),
        np.asarray(jp["layers"]["s0"]["attn"]["bq"][0]))
    assert "head" not in tp["unembed"]                       # tied head


def test_magnitude_24_masks_match_reference():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((24, 32)).astype(np.float32)
    w[0, :4] = [0.5, -0.5, 0.5, 2.0]                # ties in |w|
    w[1, :4] = 0.0
    for spec in ("2:4", "0.5"):
        jr = j_prune_matrix(jnp.asarray(w), jnp.eye(32), spec,
                            method="magnitude")
        tr = prune_matrix(torch.from_numpy(w), torch.eye(32), spec,
                          method="magnitude")
        np.testing.assert_array_equal(tr.mask.numpy(), np.asarray(jr.mask))
        np.testing.assert_array_equal(tr.w.numpy(), np.asarray(jr.w))
    with pytest.raises(ValueError, match="N:M"):
        prune_linears({"layers": []}, "0.5")


def test_prune_linears_packs_every_linear():
    tm = LM(configs.get_smoke("qwen1_5_0_5b"), device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = prune_linears(tm.init(gen), "2:4")
    packed = compressed_param_tree(params)
    assert count_packed(packed) == 7 * 2
    assert not isinstance(packed["layers"][0]["attn"]["bq"], dict)
    toks = torch.arange(10)[None] % 256
    torch.testing.assert_close(tm.forward(packed, toks),
                               tm.forward(params, toks), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_pytree_reads_reference_checkpoint(tmp_path, dtype):
    jm, jp, tm = _models("paper_tiny_lm")
    jp = jax.tree.map(lambda a: a.astype(dtype), jp)
    path = str(tmp_path / "ckpt")
    save_pytree(path, jp, extra={"step": 3})
    flat, extra = load_pytree(path)
    assert extra == {"step": 3}
    tp = tm.params_from_jax(flat)
    got = tp["layers"][1]["mlp"]["wg"]
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(
        got.float().numpy(),
        np.asarray(jp["layers"]["s0"]["mlp"]["wg"][1], np.float32))
    with open(os.path.join(path, "arrays.npz"), "r+b") as f:
        f.seek(100)
        f.write(b"\x00\x01corrupt")
    with pytest.raises(IOError, match="sha256"):
        load_pytree(path)


def test_lm_refuses_unported_families():
    """Block kinds outside ``PORTED_KINDS`` are refused, in the prefix
    and in the period; leading ``cfg.prefix`` blocks of ported kinds
    build (their parity: tests/test_torch_mamba_serve.py)."""
    cls = configs.get_smoke("qwen1_5_0_5b").__class__
    base = dict(name="prefixed", family="dense", num_layers=2, d_model=32,
                num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=64)
    for layout in (dict(prefix=("conv",), period=("attn",)),
                   dict(prefix=(), period=("conv",))):
        with pytest.raises(ValueError, match="not ported"):
            LM(cls(**{**base, **layout}), device="cpu")
    model = LM(cls(**base, prefix=("attn",), period=("attn",)), device="cpu")
    assert model.kinds == ["attn", "attn"]
