"""The port's serve stack on CPU: greedy token streams equal to the JAX
ServeEngine's (continuous mode; with the prefix cache and host swap off,
and with the reference's defaults — both on) on magnitude-2:4 params
packed by both sides; the page pool, the scheduler, the config's
defaults and validation, the CLI, and the rule that the port imports
neither jax nor the JAX package.  tests/test_torch_prefix_cache.py holds
the prefix index and the swap tier.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.store import _flatten, save_pytree
from repro.configs import get_smoke as j_get_smoke
from repro.core.pruner import prune_matrix as j_prune_matrix
from repro.models import LM as JLM
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve.config import ServeConfig as JServeConfig
from repro_torch import configs
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.kvpool import PagedKVPool
from repro_torch.serve.scheduler import QueueFull, Scheduler, SeqState
from repro_torch.models.transformer import LM

ROOT = os.path.join(os.path.dirname(__file__), "..")
PORT = os.path.join(ROOT, "src", "repro_torch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs several workers on the machine's
    cores, and torch's default pool of a thread a core in each of them
    oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pruned_pair(arch):
    """JAX params with a sharpened head (greedy gaps wide enough that
    CPU BLAS reduction order cannot flip an argmax, as the reference's
    serve tests do) and magnitude 2:4 on every linear; the port gets the
    same dense leaves, and each engine packs them itself."""
    jm = JLM(j_get_smoke(arch))
    jp = jm.init(jax.random.key(0))
    if jm.cfg.tie_embeddings:
        jp["embed"]["tok"] = jp["embed"]["tok"] * 8.0
    else:
        jp["unembed"]["head"] = jp["unembed"]["head"] * 8.0
    layers = jp["layers"]["s0"]
    for sub, names in (("attn", ("wq", "wk", "wv", "wo")),
                       ("mlp", ("wi", "wg", "wo"))):
        for name in names:
            w = layers[sub][name]
            layers[sub][name] = jnp.stack([
                j_prune_matrix(w[i].T, jnp.eye(w.shape[1]), "2:4",
                               method="magnitude").w.T
                for i in range(w.shape[0])])
    tm = LM(configs.get_smoke(arch), device="cpu")
    return jm, jp, tm, tm.params_from_jax(_flatten(jp))


@pytest.fixture(scope="module")
def pairs():
    return {arch: _pruned_pair(arch)
            for arch in ("paper_tiny_lm", "qwen1_5_0_5b")}


def _requests(n=8, shared=False):
    """``shared``: from the fifth request on, each prompt starts with the
    whole prompt of the request four before it (the first wave, whose
    pages the prefix index holds by then), and request 5 repeats request
    2's prompt."""
    rng = np.random.default_rng(0)
    reqs = [(i, rng.integers(0, 256, size=(4, 13, 20)[i % 3]).astype(
        np.int32), (2, 5, 9, 14)[i % 4]) for i in range(n)]
    if shared:
        for u in range(4, n):
            prev = reqs[u - 4][1] if u != 5 else reqs[2][1]
            p = prev if u == 5 else np.concatenate([prev, reqs[u][1]])[:24]
            reqs[u] = (u, p, reqs[u][2])
    return reqs

# the reference's serve defaults: the prefix cache and a pool-sized arena
DEFAULTS = dict(prefix_cache=True, host_swap_pages=None, shared=True)


@pytest.mark.parametrize("arch,knobs", [
    ("paper_tiny_lm", dict(steps_per_sync=1)),
    ("paper_tiny_lm", dict(steps_per_sync=8)),
    ("paper_tiny_lm", dict(num_pages=6)),            # forces preemption
    ("paper_tiny_lm", dict(kv_dtype="int8")),
    ("qwen1_5_0_5b", dict(steps_per_sync=8)),
    ("qwen1_5_0_5b", dict(num_pages=6, kv_dtype="int8")),
    ("paper_tiny_lm", dict(DEFAULTS, steps_per_sync=8)),
    ("paper_tiny_lm", dict(DEFAULTS, num_pages=6)),  # preempts by swap
    ("paper_tiny_lm", dict(DEFAULTS, steps_per_sync=1, kv_dtype="int8")),
    ("qwen1_5_0_5b", dict(DEFAULTS, num_pages=6, kv_dtype="int8")),
])
def test_greedy_streams_match_reference(pairs, arch, knobs):
    """Prompts of 4/13/20 tokens (24 with a shared prefix) in 8-token
    chunks cross chunk and page boundaries; 8 requests over 4 slots keep
    admission busy.  Both engines run with the prefix cache and the
    swap arena off, or with the reference's defaults (both on)."""
    jm, jp, tm, tp = pairs[arch]
    knobs = dict(knobs)
    reqs = _requests(shared=knobs.pop("shared", False))
    base = dict(dict(max_batch=4, max_len=48, page_size=8,
                     prefill_chunk=8, prefix_cache=False,
                     host_swap_pages=0), **knobs)
    jeng = JServeEngine(jm, jp, **base)
    want = jeng.generate([JRequest(uid=u, prompt=p, max_new_tokens=m)
                          for u, p, m in reqs])
    eng = ServeEngine(tm, tp, **base)
    got = eng.generate([Request(uid=u, prompt=p, max_new_tokens=m)
                        for u, p, m in reqs])
    assert eng.n_sparse_leaves == 7 * tm.cfg.num_layers
    for a, b in zip(want, got):
        assert a.uid == b.uid
        np.testing.assert_array_equal(b.tokens, a.tokens)
        assert b.preemptions == a.preemptions
    if knobs.get("num_pages") == 6:
        assert sum(r.preemptions for r in got) > 0
    for key in ("host_syncs", "preempt_swap", "preempt_recompute",
                "prefix_hit_tokens", "prefill_tok", "cow_copies",
                "swap_out_pages", "swap_in_pages"):
        assert eng.stats[key] == jeng.stats[key], key
    if "prefix_cache" in knobs:
        assert eng.stats["prefix_hit_tokens"] > 0
        if knobs.get("num_pages") == 6:
            assert eng.stats["preempt_swap"] > 0
    assert eng.stats["tokens"] == sum(len(r.tokens) for r in got)
    assert eng.stats["preemptions"] == sum(r.preemptions for r in got)


# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny():
    return LM(configs.get_smoke("paper_tiny_lm"), device="cpu")


def test_pool_refcounts_and_invariants(tiny):
    pool = PagedKVPool(tiny, num_pages=9, page_size=8, max_slots=4,
                       max_len=32)
    assert pool.capacity == 8 and pool.free_pages == 8
    a = pool.alloc(3)
    assert len(a) == 3 and 0 not in a              # page 0 is scrap
    b = pool.alloc(5)
    assert pool.alloc(1) is None                   # all-or-nothing
    assert pool.alloc(0) == [] and pool.free_pages == 0
    pool.retain(a[0])
    assert pool.refcount(a[0]) == 2
    pool.release(a)
    assert pool.refcount(a[0]) == 1 and pool.free_pages == 2
    pool.check_invariants()
    pool.assign(0, [a[0]])
    pool.assign(1, b[:2])
    assert pool.slot_pages(1) == b[:2]
    pool.clear_slot(1)
    assert (pool.block_tables[1] == 0).all() and pool.free_pages == 4
    pool.check_invariants()
    with pytest.raises(AssertionError):
        pool.release([a[1]])                        # already free
    pool.reset()
    assert pool.free_pages == 8
    pool.check_invariants()


def test_pool_tables_device_and_copy_on_write(tiny):
    pool = PagedKVPool(tiny, num_pages=9, page_size=4, max_slots=2,
                       max_len=16)
    p = pool.alloc(2)
    pool.assign(0, p)
    tables = pool.tables_device()
    assert tables[0, :2].tolist() == p
    pool.kv[0]["k"][p[1]] = 1.0
    pool.retain(p[1])                               # now shared
    assert pool.ensure_writable(0, 5)               # write lands in p[1]
    fresh = int(pool.block_tables[0, 1])
    assert fresh != p[1] and pool.refcount(p[1]) == 1
    assert (pool.kv[0]["k"][fresh] == 1.0).all()
    assert pool.tables_device()[0, 1].item() == fresh   # row re-uploaded
    pool.check_invariants()


def test_scheduler_preempts_youngest_and_requeues_first(tiny):
    pool = PagedKVPool(tiny, num_pages=5, page_size=8, max_slots=2,
                       max_len=64)
    sched = Scheduler(pool, 2)
    r0 = Request(uid=0, prompt=np.zeros(16, np.int32), max_new_tokens=8)
    r1 = Request(uid=1, prompt=np.zeros(16, np.int32), max_new_tokens=8)
    sched.submit(r0)
    sched.submit(r1)
    s0, s1 = sched.admit()
    assert pool.free_pages == 0
    for s in (s0, s1):
        s.state = SeqState.RUNNING
        s.n_written = 16
        s.tokens = [1]
    sched.ensure_decode_capacity()                  # s0 needs a third page
    assert s1.state is SeqState.WAITING and s1.preemptions == 1
    assert s1.tokens == [] and sched.stats["preemptions"] == 1
    assert pool.slot_page_count(s0.slot) == 3
    sched.submit(Request(uid=2, prompt=np.zeros(4, np.int32)))
    assert [s.req.uid for s in sched.waiting] == [1, 2]
    pool.check_invariants()


def test_scheduler_queue_cap_and_priority(tiny):
    pool = PagedKVPool(tiny, num_pages=9, page_size=8, max_slots=1,
                       max_len=32)
    sched = Scheduler(pool, 1, max_waiting=2)
    sched.submit(Request(uid=0, prompt=np.zeros(4, np.int32)))
    sched.submit(Request(uid=1, prompt=np.zeros(4, np.int32), priority=1))
    with pytest.raises(QueueFull):
        sched.submit(Request(uid=2, prompt=np.zeros(4, np.int32)))
    assert [s.req.uid for s in sched.admit()] == [1]


def _bad_plan(plan_cls, spec_cls):
    plan = plan_cls([spec_cls("engine_step")])
    plan.specs.append(spec_cls("nonsense"))       # past the constructor
    return plan


@pytest.mark.parametrize("knob", [
    dict(replicas=2), dict(faults=2), dict(trace=True)])
def test_config_refuses_unported_knobs(knob):
    """The front end's knobs, refused until the front end was ported,
    now validate in the port as in the reference, and both refuse the
    same bad values."""
    from repro.serve.faults import FaultPlan as JFaultPlan
    from repro.serve.faults import FaultSpec as JFaultSpec
    from repro_torch.serve.faults import FaultPlan, FaultSpec

    good, bad = {
        "replicas": (lambda P, S: dict(replicas=2),
                     lambda P, S: dict(replicas=0)),
        "faults": (lambda P, S: dict(faults=P.parse(
                       ["engine_step:after=2,replica=r0"])),
                   lambda P, S: dict(faults=_bad_plan(P, S))),
        "trace": (lambda P, S: dict(trace=True, metrics=False),
                  lambda P, S: dict(trace=True, queue_depth=0)),
    }[next(iter(knob))]
    for cfg_cls, P, S in ((ServeConfig, FaultPlan, FaultSpec),
                          (JServeConfig, JFaultPlan, JFaultSpec)):
        cfg_cls(**good(P, S)).validate()
        with pytest.raises(ValueError):
            cfg_cls(**bad(P, S)).validate()


@pytest.mark.parametrize("knob", [
    dict(temperature=0.7), dict(top_k=5), dict(top_p=0.9),
    dict(mode="static"), dict(mode="static", temperature=0.8, top_k=40)])
def test_config_accepts_sampling_and_static_mode(knob):
    """Sampled decoding and static mode are ported: the knobs validate
    in the port as in the reference."""
    ServeConfig(**knob).validate()
    JServeConfig(**knob).validate()


@pytest.mark.parametrize("knob,swap_pages", [
    (dict(prefix_cache=True), 8 * 16 + 1),
    (dict(prefix_cache=False), 8 * 16 + 1),
    (dict(host_swap_pages=4), 4),
    (dict(host_swap_pages=None, num_pages=40), 40),
    (dict(host_swap_pages=0), 0),
    (dict(host_swap_pages=None, kv_dtype="int8"), 8 * 32 + 1)])
def test_config_accepts_prefix_and_swap_knobs(knob, swap_pages):
    """The ported knobs validate, and the arena is pool-sized unless set
    (the reference's ``resolved_swap_pages``)."""
    cfg = ServeConfig(**knob).validate()
    assert cfg.resolved_swap_pages() == swap_pages
    ref = JServeConfig(**knob).validate()
    assert ref.resolved_swap_pages() == swap_pages


def test_config_defaults_match_reference():
    assert ServeConfig().prefix_cache is JServeConfig().prefix_cache is True
    assert ServeConfig().host_swap_pages is None
    assert JServeConfig().host_swap_pages is None
    with pytest.raises(ValueError, match="host_swap_pages"):
        ServeConfig(host_swap_pages=-1).validate()


def test_config_validates_like_reference():
    assert ServeConfig().validate().resolved_num_pages() == 8 * 16 + 1
    assert ServeConfig(kv_dtype="int8").resolved_num_pages() == 8 * 32 + 1
    for bad in (dict(max_batch=0), dict(num_pages=1), dict(kv_dtype="fp8"),
                dict(sparse_weights="on"), dict(mode="other")):
        with pytest.raises(ValueError):
            ServeConfig(**bad).validate()


def test_zero_max_new_and_stats(tiny):
    gen = torch.Generator()
    gen.manual_seed(0)
    eng = ServeEngine(tiny, tiny.init(gen), max_batch=2, max_len=32,
                      page_size=8)
    res = eng.generate([Request(uid=0, prompt=np.arange(5, dtype=np.int32),
                                max_new_tokens=0),
                        Request(uid=1, prompt=np.arange(9, dtype=np.int32),
                                max_new_tokens=6)])
    assert len(res[0].tokens) == 0 and len(res[1].tokens) == 6
    assert eng.n_sparse_leaves == 0                 # dense random init
    assert eng.stats["tokens"] == 6 and eng.stats["requests"] == 2
    assert 0 < res[1].utilization <= 1.0


# ----------------------------------------------------------------------
def test_launch_serve_cli_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
                "--magnitude-24", "--sparse", "--requests", "3",
                "--max-new", "4", "--max-batch", "2"])
    out = capsys.readouterr().out
    assert "packed 14 2:4-sparse weights" in out
    assert "12 tokens in" in out


def test_launch_serve_reads_reference_checkpoint(pairs, tmp_path, capsys):
    """``--params`` serves a checkpoint the JAX side wrote (its 2:4 leaves
    pack at ``--sparse``)."""
    from repro_torch.launch import serve

    path = str(tmp_path / "pruned_params")
    save_pytree(path, pairs["paper_tiny_lm"][1], extra={"method": "mag"})
    serve.main(["--arch", "paper-tiny-lm", "--smoke", "--device", "cpu",
                "--params", path, "--sparse", "--requests", "2",
                "--max-new", "3"])
    out = capsys.readouterr().out
    assert "loaded params ({'method': 'mag'})" in out
    assert "packed 14 2:4-sparse weights" in out and "6 tokens in" in out


def test_launch_serve_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--smoke"])


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)|"
    r"from\s+repro\b(?!_))", re.M)


def test_port_sources_never_import_jax_or_repro():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs
             if f.endswith(".py")]
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 20
    bad = [(f, m.group(0).strip()) for f in files
           for m in _FORBIDDEN.finditer(open(f).read())]
    assert not bad, bad


def test_port_import_leaves_jax_unloaded():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules "
        "if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
