"""The port's xLSTM (mLSTM and sLSTM blocks, xlstm-350m) on the CPU against
the JAX package: the config, the chunkwise mLSTM, the four paths of
``mlstm_apply`` and ``slstm_apply``, the threefry init, the checkpoint
leaves, the logits in f32 and bf16, the loss and its gradients (the
trainer's differentiable route; tests/test_torch_xlstm_serve.py runs the
trainer's CLI) and the pruning segments.

Tolerances:

* the chunkwise form (``CHUNK_ATOL``): the reference's own bound in
  tests/test_mlstm_chunkwise.py;
* the blocks' paths (``APPLY_REL``, of the largest magnitude of each
  output and state leaf): the same f32 operations, in the port's (B, NH,
  T, S) layout and CPU BLAS in another order;
* the init (``INIT_ATOL``): the normals come through XLA's ``erf_inv``
  polynomial against torch's (tests/test_torch_mamba.py's bound);
* logits (``TOL`` 1e-4, tests/test_torch_model.py), bf16 logits within
  ``BF16_REL`` of their norm (the two frameworks round bf16 apart:
  tests/test_torch_moe.py), gradients ``GRAD_REL`` by norm.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.store import _flatten
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.data import DataPipeline as JPipe
from repro.models import LM as JLM
from repro.models import ssm as j_ssm
from repro.models.base import ArchConfig as JArchConfig
from repro_torch import configs
from repro_torch import random as rnd
from repro_torch.models import ssm
from repro_torch.models.base import ArchConfig
from repro_torch.models.transformer import LM

CHUNK_ATOL = 5e-5
APPLY_REL = 1e-5
INIT_ATOL = 2e-6
TOL = 1e-4
BF16_REL = 1.5e-2
GRAD_REL = 1e-4
LOSS_ABS = 1e-4

SMOKE = dataclasses.asdict(j_get_smoke("xlstm_350m"))
# one mLSTM and one sLSTM block: the whole-model cases that need no
# full period
PAIR = dict(SMOKE, name="xlstm-pair", num_layers=2,
            period=("mlstm", "slstm"))
KINDS = {"mlstm": (j_ssm.mlstm_init, j_ssm.mlstm_apply,
                   j_ssm.mlstm_cache_init, ssm.mlstm_apply,
                   ssm.mlstm_cache_init),
         "slstm": (j_ssm.slstm_init, j_ssm.slstm_apply,
                   j_ssm.slstm_cache_init, ssm.slstm_apply,
                   ssm.slstm_cache_init)}


@pytest.fixture(autouse=True)
def partitionable():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with jax.threefry_partitionable(True):
            yield
    finally:
        torch.set_num_threads(threads)


def _np(t):
    """A float32 numpy copy (never a view of the tensor's storage)."""
    return t.detach().float().numpy().copy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= APPLY_REL * max(1.0, np.abs(want).max()), (what, err)


# ----------------------------------------------------------------------
# the config
# ----------------------------------------------------------------------
def test_configs_match_reference():
    for arch in ("xlstm_350m", "xlstm-350m"):
        assert configs.canonical(arch) == "xlstm_350m"
        for port, ref in ((configs.get_config(arch), j_get_config(arch)),
                          (configs.get_smoke(arch), j_get_smoke(arch))):
            assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    tm = LM(configs.get_config("xlstm-350m"), device="meta")    # full width
    assert tm.kinds.count("mlstm") == 21 and tm.kinds.count("slstm") == 3
    segs = tm.prunable_segments()
    assert len(segs) == 3
    names = [lin.name for lin in segs[0].linears]
    assert names[:4] == ["s0.mlstm.wq", "s0.mlstm.wk", "s0.mlstm.wv",
                         "s0.mlstm.wo"]
    assert names[12:17] == ["s3.slstm.wz", "s3.slstm.wi", "s3.slstm.wf",
                            "s3.slstm.wo_gate", "s3.slstm.wo"]
    assert sum(len(s.linears) for s in segs) == 21 * 4 + 3 * 5


# ----------------------------------------------------------------------
# the chunkwise mLSTM
# ----------------------------------------------------------------------
def _mlstm_inputs(seed, b=2, t=64, nh=4, hd=8):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, t, nh, hd)) / np.sqrt(hd)
    k = rng.normal(size=(b, t, nh, hd))
    v = rng.normal(size=(b, t, nh, hd))
    logi = rng.normal(size=(b, t, nh)) * 0.5
    logf = -np.log1p(np.exp(-(rng.normal(size=(b, t, nh)) + 2.0)))
    return [x.astype(np.float32) for x in (q, k, v, logi, logf)]


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("chunk", [8, 16, 32, 64])
def test_chunkwise_matches_reference(chunk, with_init):
    xs = _mlstm_inputs(chunk)
    init = None
    if with_init:
        rng = np.random.default_rng(1)
        init = (rng.normal(size=(2, 4, 8, 8)).astype(np.float32),
                rng.normal(size=(2, 4, 8)).astype(np.float32),
                rng.normal(size=(2, 4)).astype(np.float32))
    jy, jst = j_ssm._mlstm_chunkwise(
        *map(jnp.asarray, xs), chunk,
        init=None if init is None else tuple(map(jnp.asarray, init)))
    ty, tst = ssm._mlstm_chunkwise(
        *map(torch.from_numpy, xs), chunk,
        init=None if init is None else tuple(map(torch.from_numpy, init)))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=0,
                               atol=CHUNK_ATOL)
    for got, want in zip(tst, jst):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=CHUNK_ATOL * max(
                                       1.0, np.abs(np.asarray(want)).max()))


# ----------------------------------------------------------------------
# the blocks' four paths
# ----------------------------------------------------------------------
_JITS = {}


def j_apply(kind, p, h, cfg, **kw):
    """The reference's block, jitted per kind and config."""
    key = (kind, id(cfg))
    if key not in _JITS:
        fn = KINDS[kind][1]
        _JITS[key] = (cfg, jax.jit(lambda p, h, **kw: fn(p, h, cfg, **kw)))
    return _JITS[key][1](p, h, **kw)


def _to_t(tree):
    return {k: _to_t(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.fixture(scope="module")
def blocks():
    """Each block of the smoke config from its keyed init, both sides,
    and a (3, 13, D) input."""
    cfg = JArchConfig(**SMOKE)
    out = {}
    with jax.threefry_partitionable(True):
        for i, kind in enumerate(KINDS):
            init = KINDS[kind][0]
            jp = jax.jit(lambda k: init(k, cfg, jnp.float32))(
                jax.random.key(3 + i))
            out[kind] = (jp, _to_t(jp))
    h = np.random.default_rng(1).normal(size=(3, 13, cfg.d_model)).astype(
        np.float32)
    return cfg, ArchConfig(**SMOKE), out, h


def _cache_pair(kind, jcfg, tcfg, batch, rng=None):
    """The init cache (or random rows, from ``rng``) on both sides."""
    jc = KINDS[kind][2](jcfg, batch, jnp.float32)
    if rng is not None:
        jc = {k: jnp.asarray(rng.normal(size=v.shape), jnp.float32)
              if k != "m" else jnp.asarray(rng.normal(size=v.shape) - 1.0,
                                           jnp.float32)
              for k, v in jc.items()}
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    return jc, tc


@pytest.mark.parametrize("kind", list(KINDS))
def test_apply_full_and_prefill(blocks, kind):
    jcfg, tcfg, ps, h = blocks
    jp, tp = ps[kind]
    apply = KINDS[kind][3]
    jo, _ = j_apply(kind, jp, jnp.asarray(h), jcfg)
    _close(apply(tp, torch.from_numpy(h), tcfg), jo, "full")
    jc, tc = _cache_pair(kind, jcfg, tcfg, 3)
    assert tc["m"].min() == tc["m"].max() == -1e30
    jo, jc = j_apply(kind, jp, jnp.asarray(h), jcfg, cache=jc)
    _close(apply(tp, torch.from_numpy(h), tcfg, cache=tc), jo, "prefill")
    for k in jc:
        _close(tc[k], jc[k], k)


def test_mlstm_long_form_matches_reference(blocks, monkeypatch):
    """The chunkwise branch of ``mlstm_apply`` (T > the threshold and a
    multiple of the chunk), its prefill taking the chunkwise final state:
    the threshold and chunk scaled down on both sides (the reference reads
    its module constants when it traces)."""
    jcfg, tcfg, ps, _ = blocks
    jp, tp = ps["mlstm"]
    for mod in (j_ssm, ssm):
        monkeypatch.setattr(mod, "MLSTM_CHUNK_THRESHOLD", 16)
        monkeypatch.setattr(mod, "MLSTM_CHUNK", 8)
    h = np.random.default_rng(2).normal(size=(2, 24, jcfg.d_model)).astype(
        np.float32)
    ref = jax.jit(lambda p, h, **kw: j_ssm.mlstm_apply(p, h, jcfg, **kw))
    jo, _ = ref(jp, jnp.asarray(h))
    _close(ssm.mlstm_apply(tp, torch.from_numpy(h), tcfg), jo, "full")
    jc, tc = _cache_pair("mlstm", jcfg, tcfg, 2)
    jo, jc = ref(jp, jnp.asarray(h), cache=jc)
    _close(ssm.mlstm_apply(tp, torch.from_numpy(h), tcfg, cache=tc), jo,
           "prefill")
    for k in jc:
        _close(tc[k], jc[k], k)
    # the chunkwise state continues as the quadratic form's prefill does
    monkeypatch.setattr(ssm, "MLSTM_CHUNK_THRESHOLD", 1 << 30)
    _, tq = _cache_pair("mlstm", jcfg, tcfg, 2)
    ssm.mlstm_apply(tp, torch.from_numpy(h), tcfg, cache=tq)
    for k in tq:
        np.testing.assert_allclose(_np(tc[k]), _np(tq[k]), rtol=0,
                                   atol=CHUNK_ATOL * max(
                                       1.0, np.abs(_np(tq[k])).max()))


@pytest.mark.parametrize("kind", list(KINDS))
def test_apply_chunks_and_paged_decode(blocks, kind):
    """A 13-token prompt in chunks of 8 into slot 1 of a 3-slot pool whose
    rows are stale — the second chunk carries the state in and ends past
    the prompt (a padded tail) — then one paged decode step with slots 0
    and 2 idle; every output and state row against the reference."""
    jcfg, tcfg, ps, h = blocks
    jp, tp = ps[kind]
    apply = KINDS[kind][3]
    length, c = 13, 8
    hp = np.zeros((1, 16, h.shape[-1]), np.float32)
    hp[0, :length] = h[0]
    jc, tc = _cache_pair(kind, jcfg, tcfg, 3, np.random.default_rng(4))
    init = KINDS[kind][2](jcfg, 1, jnp.float32)
    for k in jc:                            # admission: slot 1 reset
        jc[k] = jc[k].at[1].set(init[k][0])
        tc[k][1] = torch.from_numpy(np.array(init[k][0]))
    for start in (0, c):
        piece = hp[:, start:start + c]
        jo, jc = j_apply(kind, jp, jnp.asarray(piece), jcfg, cache=jc,
                         paged={"slot": 1, "start": jnp.int32(start),
                                "lengths": jnp.asarray([length], jnp.int32)})
        to = apply(tp, torch.from_numpy(piece), tcfg, cache=tc,
                   paged={"slot": 1, "start": start, "length": length})
        valid = min(length - start, c)
        _close(to[:, :valid], np.asarray(jo)[:, :valid], f"chunk {start}")
        assert np.isfinite(_np(to)).all()
        for k in jc:
            _close(tc[k], jc[k], k)
    # the chunked state equals a dense prefill of the prompt
    jd = KINDS[kind][2](jcfg, 1, jnp.float32)
    _, jd = j_apply(kind, jp, jnp.asarray(h[:1, :length]), jcfg, cache=jd)
    for k in jd:
        _close(tc[k][1:2], jd[k], f"{k} against a dense prefill")
    # paged decode: slot 1 live, 0 and 2 idle (their rows untouched)
    pos = np.asarray([-1, length, -1], np.int32)
    before = {k: _np(v) for k, v in tc.items()}
    jo, jc = j_apply(kind, jp, jnp.asarray(h[:, :1]), jcfg, cache=jc,
                     pos=jnp.asarray(pos), paged={"block_tables": None})
    to = apply(tp, torch.from_numpy(h[:, :1]), tcfg, cache=tc,
               pos=torch.from_numpy(pos), paged={})
    _close(to[1], np.asarray(jo)[1], "decode")
    for k in jc:
        _close(tc[k], jc[k], k)
        np.testing.assert_array_equal(_np(tc[k])[[0, 2]], before[k][[0, 2]])
        assert not np.array_equal(_np(tc[k])[1], before[k][1])


@pytest.mark.parametrize("kind", list(KINDS))
def test_apply_dense_decode(blocks, kind):
    """One decode step from random state rows, and one from the init
    state (m = -1e30: a fresh row comes out finite)."""
    jcfg, tcfg, ps, h = blocks
    jp, tp = ps[kind]
    for rng in (np.random.default_rng(2), None):
        jc, tc = _cache_pair(kind, jcfg, tcfg, 3, rng)
        jo, jc = j_apply(kind, jp, jnp.asarray(h[:, :1]), jcfg, cache=jc,
                         pos=jnp.int32(5))
        to = KINDS[kind][3](tp, torch.from_numpy(h[:, :1]), tcfg, cache=tc,
                            pos=5)
        assert np.isfinite(_np(to)).all()
        _close(to, jo, "decode")
        for k in jc:
            _close(tc[k], jc[k], k)


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------
def _keyed(fields):
    """The JAX model, the port's threefry init (the reference's keyed init
    up to the last ulp: test_threefry_init_matches_reference) carried to
    it as the reference's tree — bf16 leaves bit for bit —, and the port's
    model.  The reference's own init would cost a compile."""
    tm = LM(ArchConfig(**fields), device="cpu")
    jp = {}
    for path, arr in tm.params_to_flat(tm.init(rnd.key(0))).items():
        node = jp
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = jnp.asarray(arr.view(jnp.bfloat16) if arr.dtype.kind
                                 == "V" else arr)
    return JLM(JArchConfig(**fields)), jp, tm


@pytest.fixture(scope="module")
def pair():
    """The (mlstm, slstm) model's keyed init on both sides."""
    return _keyed(PAIR)


def test_threefry_init_matches_reference(smoke):
    jm, jp, _, tm = smoke
    want = {k: np.asarray(v) for k, v in _flatten(jp).items()}
    got = tm.params_to_flat(tm.init(rnd.key(0)))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=INIT_ATOL,
                                   err_msg=k)
    assert {k for k in want if k.endswith(("/bi", "/bf"))} == {
        *(f"layers/s{j}/mlstm/{b}" for j in (0, 1, 2, 4, 5, 6, 7)
          for b in ("bi", "bf")), "layers/s3/slstm/bf"}


def test_bf16_leaves_round_trip_with_their_dtypes():
    cfg = ArchConfig(**{**PAIR, "dtype": "bfloat16"})
    tm = LM(cfg, device="cpu")
    flat = tm.params_to_flat(tm.init(rnd.key(1)))
    for k in ("wq", "wo"):
        assert flat[f"layers/s0/mlstm/{k}"].dtype.kind == "V"
    for k in ("r_z", "r_i", "r_f", "r_o", "wo_gate"):
        assert flat[f"layers/s1/slstm/{k}"].dtype.kind == "V"
    for k in ("mlstm/wi", "mlstm/wf", "mlstm/bi", "mlstm/bf"):
        assert flat[f"layers/s0/{k}"].dtype == np.float32, k
    assert flat["layers/s1/slstm/bf"].dtype == np.float32
    back = tm.params_to_flat(tm.params_from_jax(flat))
    assert back.keys() == flat.keys()
    for k in flat:
        assert back[k].dtype == flat[k].dtype
        np.testing.assert_array_equal(back[k].view(np.uint8),
                                      flat[k].view(np.uint8))


def _tokens(b=2, t=24):
    return np.random.default_rng(5).integers(0, 256, (b, t)).astype(np.int32)


@pytest.fixture(scope="module")
def smoke():
    """The smoke model (one period: 7 mLSTM, 1 sLSTM) in f32: the JAX
    model, its keyed init, its jitted forward, and the port's model."""
    with jax.threefry_partitionable(True):
        jm = JLM(JArchConfig(**SMOKE))
        jp = jax.jit(jm.init)(jax.random.key(0))
    return jm, jp, jax.jit(jm.forward), LM(ArchConfig(**SMOKE), device="cpu")


def _logits(fwd, params, toks):
    return np.asarray(fwd(params, {"tokens": jnp.asarray(toks)})[0],
                      np.float32)


def _rel_gap(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_forward_logits_match_reference(smoke):
    """f32: the smoke model within TOL; bf16: the (mlstm, slstm) pair
    within BF16_REL of the norm (measured 2.8e-3) — the whole smoke
    model is held below."""
    jm, jp, fwd, tm = smoke
    toks = _tokens()
    tl = tm.forward(tm.params_from_jax(_flatten(jp)),
                    torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(tl, _logits(fwd, jp, toks), rtol=TOL,
                               atol=TOL)
    jm, jp, tm = _keyed(dict(PAIR, dtype="bfloat16"))
    tl = tm.forward(tm.params_from_jax(_flatten(jp)),
                    torch.from_numpy(toks)).numpy()
    assert np.isfinite(tl).all()
    assert _rel_gap(tl, _logits(jax.jit(jm.forward), jp, toks)) <= BF16_REL


def test_bf16_rounds_no_worse_than_reference(smoke):
    """The smoke model in bf16: the two bf16 forwards part by more than
    BF16_REL (3.5e-2 of the norm, ROADMAP.md Queue 3: XLA keeps f32
    precision across bf16 converts that torch rounds, and the mLSTM's
    normaliser carries an ulp of one layer into the next).  Each is a
    rounding of the same f32 computation — the f32 model on the bf16
    leaves — and the port's is no further from it than the reference's
    (4.4e-2 against 4.6e-2)."""
    _, _, fwd, _ = smoke
    toks = _tokens()
    jm, jp, tm = _keyed(dict(SMOKE, dtype="bfloat16"))
    tl = tm.forward(tm.params_from_jax(_flatten(jp)),
                    torch.from_numpy(toks)).numpy()
    assert np.isfinite(tl).all()
    fl = _logits(fwd, jax.tree.map(lambda x: x.astype(jnp.float32), jp),
                 toks)
    assert _rel_gap(tl, fl) <= _rel_gap(
        _logits(jax.jit(jm.forward), jp, toks), fl)


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _stack_grads(tm, grads):
    """{"layers/1/slstm/wz": g, ...} → the reference's stacked
    ``layers/s{j}/...`` leaves."""
    period = len(tm.cfg.period)
    out, stacks = {}, {}
    for path, g in grads.items():
        parts = path.split("/")
        if parts[0] != "layers":
            out[path] = g.numpy()
            continue
        i = int(parts[1])
        key = f"layers/s{i % period}/" + "/".join(parts[2:])
        stacks.setdefault(key, {})[i // period] = g.numpy()
    for key, byp in stacks.items():
        out[key] = np.stack([byp[p] for p in sorted(byp)])
    return out


def test_loss_and_grads_match_reference(pair):
    """The differentiable route (torch ops through both cells) against
    ``jax.value_and_grad`` of the reference's loss."""
    jm, jp, tm = pair
    tp = tm.params_from_jax(_flatten(jp))
    batch = JPipe(jm.cfg, 4, 24, seed=0).batch_at(0)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, batch)
    tb = {k: torch.from_numpy(np.array(batch[k])) for k in ("tokens",
                                                            "labels")}
    leaves = {k: v.requires_grad_(True) for k, v in _walk(tp)}
    tl, tmet = tm.loss_fn(tp, tb, differentiable=True)
    grads = torch.autograd.grad(tl, list(leaves.values()))
    assert float(tl.detach()) == pytest.approx(float(jl), abs=LOSS_ABS)
    assert float(tmet["ce"].detach()) == pytest.approx(float(jmet["ce"]),
                                                       abs=LOSS_ABS)
    want = {k: np.asarray(v) for k, v in _flatten(jg).items()}
    got = _stack_grads(tm, dict(zip(leaves, grads)))
    assert got.keys() == want.keys()
    for k in want:
        err = np.linalg.norm(got[k] - want[k])
        assert err <= GRAD_REL * max(np.linalg.norm(want[k]), 1e-6), k


def test_prunable_segments_match_reference(pair):
    jm, jp, tm = pair
    tp = tm.params_from_jax(_flatten(jp))
    js, ts = jm.prunable_segments(), tm.prunable_segments()
    assert [s.name for s in ts] == [s.name for s in js]
    assert ([[lin.name for lin in s.linears] for s in ts]
            == [[lin.name for lin in s.linears] for s in js])
    h = np.random.default_rng(0).normal(size=(2, 11, 64)).astype(np.float32)
    jh, jcaps = jax.jit(functools.partial(js[0].apply, capture=True))(
        js[0].get_params(jp), jnp.asarray(h))
    th, tcaps = ts[0].apply(ts[0].get_params(tp), torch.from_numpy(h),
                            capture=True)
    _close(th, jh, "segment")
    assert tcaps.keys() == jcaps.keys()
    for k in jcaps:
        _close(tcaps[k], jcaps[k], k)
    # the (out, in) views the engine prunes, and set writes them back
    lin = ts[0].linears[1]                           # s0.mlstm.wk
    sp = ts[0].get_params(tp)
    assert lin.get(sp).shape == (128, 64)
    new = lin.set(sp, torch.zeros(128, 64))
    assert bool((new["s0"]["mlstm"]["wk"] == 0).all())
    assert new["s0"]["mlstm"]["wi"] is sp["s0"]["mlstm"]["wi"]
