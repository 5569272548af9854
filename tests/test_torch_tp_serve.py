"""Tensor-parallel serving in the port, on the CPU: ``gloo`` groups of 2
ranks (mesh 1x2) and 4 ranks (2x2), spawned once for the module
(``tests/torch_dist_worker.py``'s ``_tp_cases``), held against the JAX
package on one device — the reference's own mesh tests fail on this jax
(ROADMAP.md, Standing notes), and GSPMD keeps the one-device numbers.

* streams: qwen3-14b SMOKE (4 query / 2 KV heads: whole KV heads a rank),
  gemma-2b SMOKE (4 / 1: the KV head kept whole), ``paper_tiny_lm`` and
  a 6 / 3 twin of it whose ranks' heads straddle KV groups, f32,
  magnitude-2:4-pruned and packed, with a sharpened head (×8, as
  ``tests/test_torch_serve.py``) — continuous with the prefix cache, on
  a starved pool that swaps, with int8 pages, static (two rows a bucket:
  split over the 2x2 mesh's data axis) and sampled (temperature 0.8,
  top-k 40, top-p 0.9; continuous and static) — token for token against
  the JAX ``ServeEngine``'s, with the same knobs and requests; every
  rank's streams bit-equal;
* logits of a dense prefill and decode step and of a paged chunk and
  decode step against the JAX model's: LOGIT_TOL × max(1, max |ref|);
  every rank's logits bit-equal, and every rank's all-reduce and
  all-gather results;
* the rules: ``dist.sharding.param_split`` against the reference's
  ``param_specs`` on every leaf of eleven SMOKE trees — the four dense
  decoders', ``paper-tiny-mamba``, Jamba, the xLSTM, phi3.5-moe,
  kimi-k2, the prefix-LM (paligemma-3b: ``frontend_proj``) and the
  encoder-decoder (seamless-m4t-large-v2: the encoder's layers, the
  port's ``enc/layers/{i}`` held against the reference's stacked
  ``enc/layers``, and ``xattn``) — dense and packed (the recurrent
  blocks' and the encoder's linears too), at tp 2 and 4, and seamless
  also at 8, where ``xattn``'s row-parallel head guard keeps ``wo``
  whole (``head_dim=cfg.hd``), every leaf equal but the rank-local ones
  (``dist.sharding.RANK_LOCAL``), each asserted at the port's dim, and
  two twins whose recurrent blocks stay whole (every leaf of such a
  block whole);
  the cache rules (``kv_head_split``, ``state_split``) against
  ``paged_kv_block_specs`` / ``decode_cache_block_specs`` (a decoder
  block's cross ``xk`` / ``xv`` too) / ``paged_state_block_specs``, the
  recurrent dense cache taking the paged rule (whole heads);
* a rank's params at tp 2 (Qwen1.5-0.5B SMOKE, packed): under
  BYTES_RATIO of the whole tree's, every split leaf fresh and contiguous;
* the schedule: a hard deadline is rank 0's to call, and ranks whose
  burst plans differ raise;
* the CLI's ``--mesh 1x2`` prints one device's streams (qwen3-14b and
  xlstm-350m SMOKE; continuous mode goes through the router and its
  lockstep followers).

The recurrent and expert families' serving is
tests/test_torch_tp_serve_families.py; the prefix-LM's and the
encoder-decoder's tests/test_torch_tp_serve_frontend.py; the router, its
replicas and the HTTP server under a mesh tests/test_torch_tp_server.py.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dist_worker as W
from repro.ckpt.store import _flatten
from repro.configs import get_smoke as j_get_smoke
from repro.configs.paper_tiny_lm import MAMBA as J_MAMBA
from repro.dist.sharding import (decode_cache_block_specs,
                                 paged_kv_block_specs,
                                 paged_state_block_specs, param_specs)
from repro.models import LM as JLM
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import configs
from repro_torch.configs import paper_tiny_lm
from repro_torch.core.pruner import LINEARS, prune_linears
from repro_torch.dist import use_mesh
from repro_torch.dist.sharding import (RANK_LOCAL, block_splits,
                                       kv_head_split, state_split)
from repro_torch.dist.sharding import param_specs as t_param_specs
from repro_torch.models.transformer import LM
from repro_torch.serve.sparse import (DEFAULT_SPARSE_PATTERNS,
                                      compressed_param_tree, linear_patterns)

LOGIT_TOL = 1e-5
BYTES_RATIO = 0.6
WORLDS = (2, 4)
RULE_ARCHS = ("qwen3-14b", "gemma-2b", "qwen1.5-0.5b", "paper_tiny_lm",
              "paper-tiny-mamba", "jamba-1.5-large-398b", "xlstm-350m",
              "phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b", "paligemma_3b",
              "seamless_m4t_large_v2")
# (arch, tp) cases beyond tp 2 and 4: seamless SMOKE at 8, where a rank's
# 8 of xattn.wo's 64 input rows would cut a head of 16 (the reference's
# row-parallel head guard keeps it whole)
RULE_EXTRA_TP = (("seamless_m4t_large_v2", 8),)
# twins whose recurrent blocks stay whole at tp 2 and 4 (the families'
# test serves them): rule id → tests/torch_dist_worker.py's FAM_MODELS
WHOLE_TWINS = {"jamba-whole": "jamba_whole", "xlstm-whole": "xlstm_whole"}
# the linears packed in the rules' trees (the reference's names)
PACKED = {"attn": ("wq", "wk", "wv", "wo"), "mlp": ("wi", "wg", "wo"),
          "xattn": ("wq", "wk", "wv", "wo"),
          "shared": ("wi", "wg", "wo"),
          "mamba": ("in_proj", "x_proj", "dt_proj", "out_proj"),
          "mlstm": ("wq", "wk", "wv", "wo"),
          "slstm": ("wz", "wi", "wf", "wo_gate", "wo")}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _magnitude_24(w):
    """Keep the two largest |w| of every 4 consecutive inputs of stacked
    (L, in, out) leaves."""
    w = np.asarray(w)
    g = np.abs(w).reshape(w.shape[0], -1, 4, w.shape[2])
    drop = np.argsort(g, axis=2, kind="stable")[:, :, :2]
    keep = np.ones(g.shape, bool)
    np.put_along_axis(keep, drop, False, axis=2)
    return jnp.asarray(w * keep.reshape(w.shape))


def _jax_model(name):
    arch, over = W.TP_MODELS[name]
    jm = JLM(dataclasses.replace(j_get_smoke(arch), **over))
    jp = jax.jit(jm.init)(jax.random.key(0))
    jp = jax.tree.map(lambda x: x, jp)
    jp["embed"]["tok"] = jp["embed"]["tok"] * 8.0       # sharpened head
    for slot in jp["layers"].values():
        for sub, names in (("attn", ("wq", "wk", "wv", "wo")),
                           ("mlp", ("wi", "wg", "wo"))):
            for key in names:
                if key in slot[sub]:
                    slot[sub][key] = _magnitude_24(slot[sub][key])
    return jm, jp


def _reference_logits(jm, jp):
    toks = jnp.asarray(W.logit_prompts())
    pre, cache = jm.prefill(jp, {"tokens": toks}, jm.init_cache(2, 32))
    dec, _ = jm.decode_step(jp, jnp.asarray(W.DECODE_TOKENS, jnp.int32),
                            cache, W.LOGIT_TOKENS)
    return np.asarray(pre), np.asarray(dec)


@pytest.fixture(scope="module")
def tp():
    """The JAX side (each model's reference streams and logits) computed
    while the 2- and 4-rank groups serve the same leaves."""
    with jax.threefry_partitionable(True):
        models = {name: _jax_model(name) for name in W.TP_MODELS}
        flats = {name: {k: np.asarray(v) for k, v in _flatten(jp).items()}
                 for name, (_, jp) in models.items()}
        ranks: dict = {}

        def spawn():
            try:
                ranks.update(W.run_groups(WORLDS, flats, None,
                                          timeout=900.0, cases="tp"))
            except BaseException as e:       # raised below, in the fixture
                ranks["error"] = e

        spawned = threading.Thread(target=spawn)
        spawned.start()
        reqs = [JRequest(uid=u, prompt=p, max_new_tokens=m)
                for u, p, m in W.tp_requests()]
        streams, logits = {}, {}
        for name, (jm, jp) in models.items():
            refs = {W.TP_MODES[mode][1] for mode in W.tp_modes(name)}
            for ref in sorted(refs):
                res = JServeEngine(jm, jp, **{**W.TP_BASE, **W.TP_REFS[ref]}
                                   ).generate(reqs, seed=7)
                streams[name, ref] = [np.asarray(r.tokens) for r in res]
            logits[name] = _reference_logits(jm, jp)
        spawned.join()
    if "error" in ranks:
        raise ranks["error"]
    return dict(ranks=ranks, streams=streams, logits=logits)


_STREAM_CASES = [(name, mode) for name in W.TP_MODELS
                 for mode in W.tp_modes(name)]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", _STREAM_CASES, ids="-".join)
def test_streams_match_jax_engine(tp, world, case):
    name, mode = case
    want = tp["streams"][name, W.TP_MODES[mode][1]]
    for r in tp["ranks"][world]:
        got = r["streams"][name, mode]
        for w, g, (_, _, m) in zip(want, got, W.tp_requests()):
            assert len(g) == m
            np.testing.assert_array_equal(g, w)
        stats = r["stats"][name, mode]
        if mode == "continuous":
            assert stats["prefix_hit_tokens"] > 0
        if mode == "starved":
            assert stats["preempt_swap"] > 0
    first = tp["ranks"][world][0]["streams"][name, mode]
    assert all(r["streams"][name, mode] == first for r in tp["ranks"][world])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(W.TP_MODELS))
def test_logits_match_jax_model(tp, world, name):
    pre, dec = tp["logits"][name]
    want = {"prefill": pre, "decode": dec, "prefill_paged": pre[:1],
            "decode_paged": dec[:1]}
    ranks = tp["ranks"][world]
    for r in ranks:
        for key, w in want.items():
            got = r["logits"][name][key]
            scale = LOGIT_TOL * max(1.0, float(np.abs(w).max()))
            assert np.abs(got - w).max() <= scale, (key, np.abs(got - w).max())
            np.testing.assert_array_equal(got, ranks[0]["logits"][name][key])


@pytest.mark.parametrize("world", WORLDS)
def test_collectives_leave_every_rank_the_same_bits(tp, world):
    """The model groups: ranks (0, 1) on 1x2, (0, 1) and (2, 3) on 2x2."""
    ranks = tp["ranks"][world]
    for key in ("torch.float32", "torch.bfloat16", "gather"):
        for r in ranks:
            partner = ranks[r["rank"] ^ 1]
            np.testing.assert_array_equal(r["bits"][key],
                                          partner["bits"][key])
    if world == 4:                     # two groups, two sums
        assert not np.array_equal(ranks[0]["bits"]["torch.float32"],
                                  ranks[2]["bits"]["torch.float32"])


def test_rank_holds_its_blocks(tp):
    for r in tp["ranks"][2]:
        lay = r["layout"]
        assert lay["split"] > 0 and lay["fresh"]
        assert lay["rank_bytes"] < BYTES_RATIO * lay["whole_bytes"]
        cfg = configs.get_smoke("qwen1.5-0.5b")
        assert lay["wq"] == (cfg.d_model // 2, cfg.num_heads * cfg.hd // 2)
        assert lay["wo"] == (cfg.d_ff // 4, cfg.d_model)
        assert lay["tok"] == (cfg.vocab_size // 2, cfg.d_model)


def test_deadlines_are_rank_0s_and_parted_plans_raise(tp):
    """Rank 0's clock retires request 1 on both ranks (rank 1's own clock
    says a minute is left); ranks handed different prompts raise at the
    first burst instead of parting in a collective."""
    ranks = tp["ranks"][2]
    for r in ranks:
        sch = r["schedule"]
        assert sch["timeouts"] == 1 and sch["deadline"][1] == []
        assert sch["deadline"] == ranks[0]["schedule"]["deadline"]
        assert sch["parted"] is not None and "parted" in sch["parted"]


@pytest.mark.parametrize("arch", list(W.CLI_CASES))
def test_cli_mesh_1x2_prints_one_device_streams(tp, arch):
    def streams(text):      # one device names its router's replica
        return [line.split("  [")[0] for line in text.splitlines()
                if line.startswith("req ")]

    one, _ = W._cli(W.CLI_CASES[arch])
    assert len(streams(one)) == 3
    out, err = tp["ranks"][2][0]["cli"][arch]
    assert err is None
    assert streams(out) == streams(one)
    assert "mesh 1x2" in out and "model axis 2" in out
    assert tp["ranks"][2][1]["cli"][arch][0] == ""  # rank 1 prints nothing


# ----------------------------------------------------------------------
# the rules against the reference's
# ----------------------------------------------------------------------
class _FakeMesh:
    """What the reference's rules read of a Mesh: ``axis_names`` and
    ``shape``."""

    def __init__(self, tp):
        self.axis_names = ("data", "model")
        self.shape = {"data": 1, "model": tp}


class _FakeTorchMesh:
    """What a context over a DeviceMesh reads of it for the port's cache
    shapes (``use_mesh``, ``DistContext.tp``): its axis names and
    shape."""

    mesh_dim_names = ("data", "model")

    def __init__(self, tp):
        self.shape = (1, tp)


def _model_dim(spec, lead):
    entries = tuple(spec)
    for i, e in enumerate(entries):
        if e == "model" or (isinstance(e, tuple) and "model" in e):
            return i - lead
    return None


def _packed_shapes(tree, path=""):
    """The reference's param tree of shapes, its attention, MLP, shared
    expert and recurrent blocks' linears 2:4-packed as
    ``serve.sparse.pack_24`` packs them."""
    if isinstance(tree, dict):
        return {k: _packed_shapes(v, f"{path}/{k}") for k, v in tree.items()}
    parts = path.split("/")
    if parts[-1] in PACKED.get(parts[-2], ()):
        lead, k, n = tree.shape
        half = jax.ShapeDtypeStruct((lead, k // 2, n), tree.dtype)
        return {"vals": half,
                "idx": jax.ShapeDtypeStruct((lead, k // 2, n), jnp.int8)}
    return tree


def _flat_specs(specs):
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): spec
            for path, spec in leaves}


def _flat_port(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_port(v, f"{path}/{k}" if path else k))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_port(v, f"{path}/{i}"))
        return out
    return {path: tree}


def _rule_configs(arch):
    """(the reference's SMOKE config, the port's) of a RULE_ARCHS or
    WHOLE_TWINS id."""
    if arch == "paper-tiny-mamba":
        return J_MAMBA, paper_tiny_lm.MAMBA
    if arch in WHOLE_TWINS:
        base, over = W.FAM_MODELS[WHOLE_TWINS[arch]]
        return (dataclasses.replace(j_get_smoke(base), **over),
                W.fam_config(WHOLE_TWINS[arch]))
    return j_get_smoke(arch), configs.get_smoke(arch)


# (arch, packed, tp): the whole Mamba twin's d_model 63 does not pack
_RULE_CASES = [(arch, packed, tp) for arch in RULE_ARCHS + tuple(WHOLE_TWINS)
               for packed in (False, True) for tp in (2, 4)
               if not (packed and arch == "jamba-whole")]
_RULE_CASES += [(arch, packed, tp) for arch, tp in RULE_EXTRA_TP
                for packed in (False, True)]


@pytest.mark.parametrize(
    "arch,packed,tp_size", _RULE_CASES,
    ids=[f"{a}-{'packed' if p else 'dense'}-{t}" for a, p, t in _RULE_CASES])
def test_param_rule_matches_reference(arch, packed, tp_size):
    """Every leaf's split dim equals the reference's, but the rank-local
    leaves (RANK_LOCAL: Mamba's vectors, conv taps, ``a_log`` and its
    row-parallel ``x_proj``; the mLSTM's gate biases; the sLSTM's
    recurrences and forget bias), each at the port's dim, and the leaves
    of a recurrent block that does not split (``block_splits``), each
    whole where the reference may split it.  Mamba's ``in_proj`` splits
    the reference's dim, a rank's block of x and of z
    (``shard_params``)."""
    jcfg, tcfg = _rule_configs(arch)
    shapes = jax.eval_shape(JLM(jcfg).init, jax.random.key(0))
    if packed:
        shapes = _packed_shapes(shapes)
    want = _flat_specs(param_specs(shapes, _FakeMesh(tp_size),
                                   head_dim=jcfg.hd))
    model = LM(tcfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    if packed:
        linears = LINEARS + model.block_linears()
        if tcfg.encdec:                   # the encoder's layers too
            prune_linears({"layers": params["enc"]["layers"]}, "2:4")
        params = compressed_param_tree(
            prune_linears(params, "2:4", linears=linears),
            DEFAULT_SPARSE_PATTERNS + linear_patterns(linears))
    got = _flat_port(t_param_specs(params, tp_size, cfg=tcfg))
    period = len(jcfg.period)
    checked = diverged = 0
    for path, dim in got.items():
        parts = path.split("/")
        if parts[0] == "layers":
            ref = "/".join(["layers", f"s{int(parts[1]) % period}",
                            *parts[2:]])
            lead = 1
        elif parts[:2] == ["enc", "layers"]:    # the reference's stack
            ref, lead = "/".join(["enc", "layers", *parts[3:]]), 1
        else:
            ref, lead = path, 0
        leaf = [p for p in parts if p not in ("vals", "idx")]
        local = RANK_LOCAL.get(leaf[-2], {}).get(leaf[-1])
        if (leaf[-2] in RANK_LOCAL
                and not block_splits(leaf[-2], tcfg, tp_size)):
            assert dim is None, path                  # the block is whole
            diverged += _model_dim(want[ref], lead) is not None
        elif local is not None:
            assert dim == local, (path, dim)
            assert _model_dim(want[ref], lead) != dim, path
            diverged += 1
        else:
            assert _model_dim(want[ref], lead) == dim, (path, want[ref], dim)
        checked += 1
    assert checked == len(got) and any(d is not None for d in got.values())
    recurrent = set(tcfg.period) & set(RANK_LOCAL)
    if any(block_splits(k, tcfg, tp_size) for k in recurrent):
        assert diverged > 0
    elif not recurrent:
        assert diverged == 0
    if packed and arch not in WHOLE_TWINS:
        assert any(p.endswith(("wo/vals", "out_proj/vals")) and d == 0
                   for p, d in got.items())
    if tcfg.moe is not None:
        assert any(p.endswith("moe/wi") and d == 0 for p, d in got.items())
    if tcfg.frontend is not None:
        assert got["embed/frontend_proj"] == 1       # column-parallel
    if tcfg.encdec:
        wo = got["layers/0/xattn/wo/vals" if packed else "layers/0/xattn/wo"]
        k = (tcfg.num_heads * tcfg.hd) // tp_size
        assert wo == (None if k % tcfg.hd else 0), wo     # the head guard
        assert got["enc/ln/scale"] is None
        assert any(p.startswith("enc/layers/1/") and d is not None
                   for p, d in got.items())


_CACHE_CASES = [(arch, tp) for arch in RULE_ARCHS + tuple(WHOLE_TWINS)
                for tp in (2, 4)] + list(RULE_EXTRA_TP)


@pytest.mark.parametrize("arch,tp_size", _CACHE_CASES,
                         ids=[f"{a}-{t}" for a, t in _CACHE_CASES])
def test_cache_rules_match_reference(arch, tp_size):
    """The KV rules — a decoder block's cross ``xk`` / ``xv`` with its
    self-attention's K / V — and each recurrent kind's state rule against
    ``paged_state_block_specs`` and the recurrent kinds of
    ``decode_cache_block_specs``: the dense cache takes the paged rule,
    whole heads, where the reference's splits inside an mLSTM head or
    an sLSTM d_model without the head condition."""
    cfg, tcfg = _rule_configs(arch)
    mesh = _FakeMesh(tp_size)
    dims = {"num_kv_heads": cfg.num_kv_heads, "hd": cfg.hd,
            "d_inner": cfg.d_inner, "d_model": cfg.d_model,
            "num_heads": cfg.num_heads,
            "mlstm_hd": cfg.mlstm_proj * cfg.d_model // cfg.num_heads}
    paged = paged_kv_block_specs(dims, mesh, quantized=True)
    split = kv_head_split(cfg.num_kv_heads, tp_size)
    assert _model_dim(paged["k"], 0) == split
    assert _model_dim(paged["k_scale"], 0) == split
    dense = _model_dim(decode_cache_block_specs("attn", dims, mesh)["k"], 0)
    # the reference's hd fallback (dim 3) is a whole cache in the port
    assert split == (dense if dense == 2 else None)
    if "dec_attn" in cfg.period:
        cross = decode_cache_block_specs("dec_attn", dims, mesh)
        assert sorted(cross) == ["k", "v", "xk", "xv"]
        for key in ("xk", "xv"):
            d = _model_dim(cross[key], 0)
            assert split == (d if d == 2 else None), key
        # the port's cache: xk / xv at the rank's KV heads, as k / v
        with use_mesh(_FakeTorchMesh(tp_size)):
            cache = LM(tcfg, device="meta").init_cache(2, 8)
        kvh = cfg.num_kv_heads // (tp_size if split else 1)
        layer = cache[tcfg.num_layers - 1]
        assert layer["xk"].shape == (2, cfg.frontend_len, kvh, cfg.hd)
        assert layer["xv"].shape == layer["xk"].shape
        assert layer["k"].shape[2] == kvh
    for kind in set(cfg.period) & {"mamba", "mlstm", "slstm"}:
        got = state_split(kind, tcfg, tp_size)
        want = paged_state_block_specs(kind, dims, mesh)
        dense = decode_cache_block_specs(kind, dims, mesh)
        assert sorted(got) == sorted(want) == sorted(dense)
        for key, dim in got.items():
            assert _model_dim(want[key], 0) == dim, (kind, key)
            d = _model_dim(dense[key], 0)
            if kind == "mlstm":       # the reference's: hd, not heads
                assert d == (None if key == "m" or dims["mlstm_hd"]
                             % tp_size else 2), key
            elif kind == "slstm":     # the reference's: d_model alone
                assert d == (None if cfg.d_model % tp_size else 1), key
            else:
                assert d == dim, (kind, key)
