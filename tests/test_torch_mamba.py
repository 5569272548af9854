"""The port's Mamba block and the Mamba/attention hybrid on the CPU
against the JAX package: the selective scan, the four ``mamba_apply``
paths, the threefry init, the forward, loss and gradients, five trainer
steps, the pruning segments, the checkpoint leaves and the configs.

Tolerances:

* the scan (``SCAN_REL``, relative to the output's scale): the port's
  Hillis–Steele rounds multiply the pairs in another order than XLA's
  ``associative_scan``; measured ≤ 3e-7 at T = 37;
* the block's paths (``APPLY_TOL``, absolute on outputs of order 1 and on
  the state rows): the same f32 ops, CPU BLAS in another order;
* the init (``INIT_ATOL``): the normals come through XLA's ``erf_inv``
  polynomial against torch's ``log1p`` (tests/test_torch_train.py's
  2e-6), and ``dt_bias`` / ``a_log`` through ``exp``, ``expm1`` and
  ``log``, an ulp apart;
* logits (``TOL`` 1e-4, as tests/test_torch_model.py) and gradients
  (``GRAD_REL`` by norm);
* the trainer: tests/test_torch_train.py's bounds.
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
from repro.configs.paper_tiny_lm import MAMBA as J_MAMBA
from repro.data import DataPipeline as JPipe
from repro.models import LM as JLM
from repro.models import ssm as j_ssm
from repro.models.base import ArchConfig as JArchConfig
from repro.optim import AdamW as JAdamW
from repro.optim.schedules import warmup_cosine as j_cosine
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro_torch import configs
from repro_torch import random as rnd
from repro_torch.configs.paper_tiny_lm import MAMBA
from repro_torch.data import DataPipeline
from repro_torch.models import ssm
from repro_torch.models.base import ArchConfig
from repro_torch.models.transformer import LM
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import reference_ndim
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train import TrainConfig, Trainer

SCAN_REL = 2e-6
APPLY_TOL = 2e-5
INIT_ATOL = 2e-6
TOL = 1e-4
GRAD_REL = 1e-4
LOSS_ABS = 1e-4
TRAIN_REL = 5e-5
TRAIN_ENTRY_ABS = 1e-5
TRAIN_OUTLIERS = 0.001

# the tiny Mamba LM at smoke size, and the jamba-shaped hybrid of the
# reference's serve tests (tests/test_serve_paged.py, HYBRID)
MAMBA_SMOKE = dict(dataclasses.asdict(MAMBA), name="paper-tiny-mamba-smoke",
                   num_layers=2, d_model=64, vocab_size=256)
HYBRID = dict(name="hybrid-serve-test", family="hybrid", num_layers=4,
              d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
              vocab_size=256, period=("mamba", "attn"), mlp_kind="swiglu",
              ssm_mlp=True, ssm_state=4, ssm_conv=4, dtype="float32")
CFGS = {"mamba": MAMBA_SMOKE, "hybrid": HYBRID}


_JITS = {}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs several workers on the machine's
    cores, and torch's default pool of a thread a core in each of them
    oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def j_mamba_apply(p, h, cfg, **kw):
    """The reference's block, jitted per config (its eager op-by-op
    dispatch is slow; the config holds a dict, so it is closed over
    rather than passed as a static argument)."""
    if id(cfg) not in _JITS:
        _JITS[id(cfg)] = (cfg, jax.jit(
            lambda p, h, **kw: j_ssm.mamba_apply(p, h, cfg, **kw)))
    return _JITS[id(cfg)][1](p, h, **kw)


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


@pytest.fixture(scope="module")
def pairs():
    """{name: (JAX model, its keyed init, port model, the same leaves)}."""
    out = {}
    with jax.threefry_partitionable(True):
        for name, fields in CFGS.items():
            jm = JLM(JArchConfig(**fields))
            jp = jax.jit(jm.init)(jax.random.key(0))
            tm = LM(ArchConfig(**fields), device="cpu")
            out[name] = (jm, jp, tm, tm.params_from_jax(_flatten(jp)))
    return out


def _np(t):
    """A float32 numpy copy (never a view of the tensor's storage)."""
    return t.detach().float().numpy().copy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


# ----------------------------------------------------------------------
# the scan and the block
# ----------------------------------------------------------------------
@pytest.mark.parametrize("with_init", [False, True])
def test_ssm_scan_matches_reference(with_init):
    rng = np.random.default_rng(0)
    b, t, di, n = 2, 37, 32, 4
    dt = np.log1p(np.exp(rng.normal(size=(b, t, di)))).astype(np.float32)
    x = rng.normal(size=(b, t, di)).astype(np.float32)
    bb = rng.normal(size=(b, t, n)).astype(np.float32)
    cc = rng.normal(size=(b, t, n)).astype(np.float32)
    a = -np.exp(rng.normal(size=(di, n))).astype(np.float32)
    init = rng.normal(size=(b, di, n)).astype(np.float32) if with_init \
        else None
    jy, js = j_ssm._mamba_ssm_scan(
        *map(jnp.asarray, (dt, x, bb, cc, a)),
        init=None if init is None else jnp.asarray(init))
    ty, ts = ssm._mamba_ssm_scan(
        *map(torch.from_numpy, (dt, x, bb, cc, a)),
        init=None if init is None else torch.from_numpy(init))
    for got, want in ((ty, jy), (ts, js)):
        want = np.asarray(want)
        assert np.abs(_np(got) - want).max() <= SCAN_REL * np.abs(want).max()


@pytest.fixture(scope="module")
def block():
    """One Mamba block of the smoke LM, both sides, and its input."""
    cfg = JArchConfig(**MAMBA_SMOKE)
    with jax.threefry_partitionable(True):
        jp = j_ssm.mamba_init(jax.random.key(3), cfg, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) if not isinstance(v, dict)
          else {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
          for k, v in jp.items()}
    h = np.random.default_rng(1).normal(size=(3, 13, cfg.d_model)).astype(
        np.float32)
    return cfg, ArchConfig(**MAMBA_SMOKE), jp, tp, h


def _state(cache):
    return {k: _np(v) for k, v in cache.items()}


def test_mamba_apply_full_and_prefill(block):
    jcfg, tcfg, jp, tp, h = block
    jo, _ = j_mamba_apply(jp, jnp.asarray(h), jcfg)
    to = ssm.mamba_apply(tp, torch.from_numpy(h), tcfg)
    np.testing.assert_allclose(_np(to), np.asarray(jo), rtol=0,
                               atol=APPLY_TOL)
    jc0 = j_ssm.mamba_cache_init(jcfg, 3, jnp.float32)
    jo, jc = j_mamba_apply(jp, jnp.asarray(h), jcfg, cache=jc0)
    tc = ssm.mamba_cache_init(tcfg, 3, torch.float32, "cpu")
    to = ssm.mamba_apply(tp, torch.from_numpy(h), tcfg, cache=tc)
    np.testing.assert_allclose(_np(to), np.asarray(jo), rtol=0,
                               atol=APPLY_TOL)
    for k, v in _state(tc).items():
        np.testing.assert_allclose(v, np.asarray(jc[k]), rtol=0,
                                   atol=APPLY_TOL)


def test_mamba_apply_chunks_and_paged_decode(block):
    """A 13-token prompt in chunks of 8 into slot 1 of a 3-slot pool —
    the second chunk carries the state in and ends past the prompt (the
    carry-out window ``vc``) — then one paged decode step with slots 0
    and 2 idle; every output and state row against the reference."""
    jcfg, tcfg, jp, tp, h = block
    length, c = 13, 8
    hp = np.zeros((1, 16, h.shape[-1]), np.float32)
    hp[0, :length] = h[0]
    jc = j_ssm.mamba_cache_init(jcfg, 3, jnp.float32)
    jc = {k: v + 0.5 for k, v in jc.items()}          # stale rows
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    for start in (0, c):
        piece = hp[:, start:start + c]
        paged = {"slot": 1, "start": jnp.int32(start),
                 "lengths": jnp.asarray([length], jnp.int32)}
        j_in = dict(jc)
        j_in["conv"] = j_in["conv"].at[1].set(0.0) if start == 0 \
            else j_in["conv"]
        j_in["ssm"] = j_in["ssm"].at[1].set(0.0) if start == 0 \
            else j_in["ssm"]
        if start == 0:
            tc["conv"][1] = 0.0
            tc["ssm"][1] = 0.0
        jo, jc = j_mamba_apply(jp, jnp.asarray(piece), jcfg, cache=j_in,
                                   paged=paged)
        to = ssm.mamba_apply(tp, torch.from_numpy(piece), tcfg, cache=tc,
                             paged={"slot": 1, "start": start,
                                    "length": length})
        valid = min(length - start, c)
        np.testing.assert_allclose(_np(to)[:, :valid],
                                   np.asarray(jo)[:, :valid], rtol=0,
                                   atol=APPLY_TOL)
        for k, v in _state(tc).items():
            np.testing.assert_allclose(v, np.asarray(jc[k]), rtol=0,
                                       atol=APPLY_TOL)
    # the chunked state equals a dense prefill of the prompt
    jd = j_ssm.mamba_cache_init(jcfg, 1, jnp.float32)
    _, jd = j_mamba_apply(jp, jnp.asarray(h[:1, :length]), jcfg,
                              cache=jd)
    for k, v in _state(tc).items():
        np.testing.assert_allclose(v[1], np.asarray(jd[k])[0], rtol=0,
                                   atol=APPLY_TOL)
    # paged decode: slot 1 live, 0 and 2 idle (their rows untouched)
    x1 = h[:, :1]
    pos = np.asarray([-1, length, -1], np.int32)
    before = _state(tc)
    jo, jc = j_mamba_apply(jp, jnp.asarray(x1), jcfg, cache=jc,
                               pos=jnp.asarray(pos),
                               paged={"block_tables": None})
    to = ssm.mamba_apply(tp, torch.from_numpy(x1), tcfg, cache=tc,
                         pos=torch.from_numpy(pos), paged={})
    np.testing.assert_allclose(_np(to), np.asarray(jo), rtol=0,
                               atol=APPLY_TOL)
    for k, v in _state(tc).items():
        np.testing.assert_allclose(v, np.asarray(jc[k]), rtol=0,
                                   atol=APPLY_TOL)
        np.testing.assert_array_equal(v[[0, 2]], before[k][[0, 2]])
        assert not np.array_equal(v[1], before[k][1])


def test_mamba_apply_dense_decode(block):
    jcfg, tcfg, jp, tp, h = block
    rng = np.random.default_rng(2)
    jc = {"conv": jnp.asarray(rng.normal(size=(3, 3, jcfg.d_inner)),
                              jnp.float32),
          "ssm": jnp.asarray(rng.normal(size=(3, jcfg.d_inner,
                                              jcfg.ssm_state)), jnp.float32)}
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    jo, jc = j_mamba_apply(jp, jnp.asarray(h[:, :1]), jcfg, cache=jc,
                               pos=jnp.int32(5))
    to = ssm.mamba_apply(tp, torch.from_numpy(h[:, :1]), tcfg, cache=tc,
                         pos=5)
    np.testing.assert_allclose(_np(to), np.asarray(jo), rtol=0,
                               atol=APPLY_TOL)
    for k, v in _state(tc).items():
        np.testing.assert_allclose(v, np.asarray(jc[k]), rtol=0,
                                   atol=APPLY_TOL)


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["mamba", "hybrid"])
def test_threefry_init_matches_reference(pairs, name):
    jm, jp, tm, _ = pairs[name]
    want = {k: np.asarray(v) for k, v in _flatten(jp).items()}
    got = tm.params_to_flat(tm.init(rnd.key(0)))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=INIT_ATOL,
                                   err_msg=k)


def test_forward_loss_and_grads_match_reference(pairs):
    """The hybrid (Mamba blocks with MLPs beside attention); the pure
    Mamba LM's gradients are held through the trainer's five steps."""
    jm, jp, tm, tp = pairs["hybrid"]
    tp = tm.params_from_jax(_flatten(jp))        # leaves of its own
    pipe = JPipe(jm.cfg, 4, 24, seed=0)
    batch = pipe.batch_at(0)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, batch)
    tb = {k: torch.from_numpy(np.array(batch[k])) for k in ("tokens",
                                                            "labels")}
    jlog, _ = jax.jit(jm.forward)(jp, batch)
    np.testing.assert_allclose(_np(tm.forward(tp, tb["tokens"])),
                               np.asarray(jlog), rtol=0, atol=TOL)
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
    """{"layers/3/mamba/in_proj": g, ...} → the reference's stacked
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


def test_trainer_steps_match_reference(tmp_path):
    """Five steps of the Mamba LM from the keyed init on the corpus,
    each side its own init and batches."""
    steps = 5
    jcfg, tcfg = JArchConfig(**MAMBA_SMOKE), ArchConfig(**MAMBA_SMOKE)
    jt = JTrainer(JLM(jcfg), JAdamW(lr=j_cosine(1e-3, 2, steps)),
                  JPipe(jcfg, 8, 32, seed=0),
                  JTrainConfig(total_steps=steps, global_batch=8, seq_len=32,
                               ckpt_every=steps, out_dir=str(tmp_path / "j"),
                               log_every=1))
    tt = Trainer(LM(tcfg, device="cpu"),
                 AdamW(lr=warmup_cosine(1e-3, 2, steps)),
                 DataPipeline(tcfg, 8, 32, seed=0),
                 TrainConfig(total_steps=steps, global_batch=8, seq_len=32,
                             ckpt_every=steps, out_dir=str(tmp_path / "t"),
                             log_every=1))
    jparams, _, _ = jt.run()
    tparams, _, info = tt.run()
    assert info["steps"] == steps and info["skipped_steps"] == 0
    want = _flatten(jparams)
    got = tt.model.params_to_flat(tparams)
    for path in want:
        w, g = np.asarray(want[path], np.float32), got[path].astype(
            np.float32)
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= TRAIN_REL, (path, err)
        assert np.sum(np.abs(g - w) > TRAIN_ENTRY_ABS) <= (
            TRAIN_OUTLIERS * w.size), path
    # the decay rule counts the reference's stacked ranks: every Mamba
    # leaf is (L, ...) there, so each one decays, in both packages
    ndim = reference_ndim(tparams)
    for k in ("conv_w", "conv_b", "a_log", "d", "dt_bias"):
        assert ndim["layers"][0]["mamba"][k] == want[
            f"layers/s0/mamba/{k}"].ndim >= 2, k


def test_prunable_segments_match_reference(pairs):
    jm, jp, tm, tp = pairs["hybrid"]
    js, ts = jm.prunable_segments(), tm.prunable_segments()
    assert [s.name for s in ts] == [s.name for s in js]
    assert ([[lin.name for lin in s.linears] for s in ts]
            == [[lin.name for lin in s.linears] for s in js])
    assert ts[0].linears[0].name == "s0.mamba.in_proj"
    # a segment's capture and output against the reference's
    h = np.random.default_rng(0).normal(size=(2, 11, 64)).astype(np.float32)
    jh, jcaps = jax.jit(functools.partial(js[1].apply, capture=True))(
        js[1].get_params(jp), jnp.asarray(h))
    th, tcaps = ts[1].apply(ts[1].get_params(tp), torch.from_numpy(h),
                            capture=True)
    np.testing.assert_allclose(_np(th), np.asarray(jh), rtol=0,
                               atol=APPLY_TOL)
    assert tcaps.keys() == jcaps.keys()
    for k in jcaps:
        np.testing.assert_allclose(_np(tcaps[k]), np.asarray(jcaps[k]),
                                   rtol=0, atol=APPLY_TOL)
    # set_params writes a segment's slots back into their layers
    new = ts[1].set_params(tp, ts[1].get_params(tp))
    assert new["layers"][2] is tp["layers"][2]
    assert new["layers"][3] is tp["layers"][3]


def test_bf16_leaves_round_trip_with_their_dtypes():
    cfg = ArchConfig(**{**HYBRID, "dtype": "bfloat16"})
    tm = LM(cfg, device="cpu")
    flat = tm.params_to_flat(tm.init(rnd.key(1)))
    assert flat["layers/s0/mamba/in_proj"].dtype.kind == "V"
    for k in ("a_log", "d", "dt_bias"):
        assert flat[f"layers/s0/mamba/{k}"].dtype == np.float32
    back = tm.params_to_flat(tm.params_from_jax(flat))
    assert back.keys() == flat.keys()
    for k in flat:
        assert back[k].dtype == flat[k].dtype
        np.testing.assert_array_equal(back[k].view(np.uint8),
                                      flat[k].view(np.uint8))


def test_configs_match_reference_and_moe_is_refused():
    """The name is historical: Jamba's experts are ported now, and both
    configs are accepted with them (tests/test_torch_moe.py holds the
    MoE against the reference)."""
    assert dataclasses.asdict(MAMBA) == dataclasses.asdict(J_MAMBA)
    for arch in ("jamba_1_5_large_398b", "jamba-1.5-large-398b"):
        for port, ref in ((configs.get_config(arch), j_get_config(arch)),
                          (configs.get_smoke(arch), j_get_smoke(arch))):
            assert dataclasses.asdict(port) == dataclasses.asdict(ref)
            tm = LM(port, device="meta")
            assert tm.moe_slots == [j in port.moe_slots for j in range(8)]
            seg = tm.prunable_segments()[0]
            assert len(seg.linears) == (
                7 * 4 + 4 + 4 * 3 + 4 * 3 * port.moe.num_experts)
    # Jamba's blocks without the experts: one period, every slot with its
    # dense SwiGLU FFN (no allocation at this width)
    cfg = dataclasses.replace(configs.get_config("jamba_1_5_large_398b"),
                              moe=None, moe_slots=(), num_layers=8)
    tm = LM(cfg, device="meta")
    assert tm.kinds.count("mamba") == 7 and tm.kinds[3] == "attn"
    segs = tm.prunable_segments()
    assert len(segs) == 1 and len(segs[0].linears) == 7 * 7 + 4 + 3
