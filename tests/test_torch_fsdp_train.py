"""FSDP in the port's trainer, on the CPU: ``gloo`` groups of 2 ranks
(mesh 2x1) and 4 ranks (2x2), spawned once for the module
(``tests/torch_train_worker.py``'s ``fsdp_cases``), held against the JAX
package's single-device trainer — the reference's own sharded trainer
tests fail on this jax (ROADMAP.md, Standing notes), and sharding does
not change the mathematics.

* the rule: the port's ``param_rule`` with FSDP over ``data`` against
  the reference's ``param_specs(shapes, mesh, fsdp_axes=("data",),
  head_dim=cfg.hd)``, leaf by leaf, for every config of the JAX package
  on 2x1, 2x2 and 4x1; the divergences the port must have: the model
  dims of ``RANK_LOCAL`` (as tests/test_torch_tp_serve.py lists them),
  the leaves of a recurrent block that stays whole over ``model``, and
  a leaf whose port model dim is the reference's FSDP dim, which stays
  whole over ``data``;
* ``shard_params`` then ``gather_params`` is the identity (a dense
  decoder, and the tiny Mamba LM's x | z ``in_proj`` on 2x2);
* paper_tiny_lm SMOKE's FSDP trainer on 2x1 and 2x2, plain, with
  ``grad_compression`` and with ``microbatches=2``, and with
  ``fsdp_axes=()`` (replicated), 3 steps of 8 × 32 with bf16 moments,
  against the JAX single-device trainer with the same knobs: every
  step's loss within LOSS_ABS, ``grad_norm`` within NORM_REL, every
  leaf within TRAIN_REL by norm with at most TRAIN_OUTLIERS of its
  entries past TRAIN_ENTRY_ABS (the bounds of tests/test_torch_dist.py);
  every rank's losses bit-equal; a rank's params and moments at most
  BYTES_RATIO of one device's under FSDP and fewer than the replicated
  run's, which holds one device's on 2x1 (on 2x2 its model blocks);
* a checkpoint's gather holds one whole leaf at a time on every rank;
* phi3.5-moe SMOKE's FSDP trainer on 2x1 (the expert stacks' ``d`` dim
  split over data) against the reference's (loss, aux) a step, within
  MOE_ABS (tests/test_torch_dist.py's).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dist_worker as W
import torch_train_worker as T
from repro.configs import ARCH_IDS
from repro.configs import get_smoke as j_get_smoke
from repro.dist.sharding import param_specs
from repro.models import LM as JLM
from repro_torch import configs
from repro_torch.dist.sharding import (RANK_LOCAL, block_splits,
                                       param_rules)
from repro_torch.models.transformer import LM

LOSS_ABS = 1e-4
TRAIN_REL = 5e-5
TRAIN_ENTRY_ABS = 1e-5
TRAIN_OUTLIERS = 0.001
NORM_REL = 5e-5
MOE_ABS = 2e-5
BYTES_RATIO = 0.6          # paper_tiny_lm SMOKE: its vectors stay whole
MESHES = ((2, 1), (2, 2), (4, 1))
WORLDS = (2, 4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fsdp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    ranks = W.run_groups(WORLDS, None, None, timeout=600.0,
                         cases="torch_train_worker:fsdp_cases")
    refs = {}
    for name, kw in T.FSDP_RUNS.items():
        kw = {k: v for k, v in kw.items() if k != "fsdp_axes"}
        refs[name] = T.jax_trainer_run(tmp / name, **kw)
    return dict(ranks=ranks, refs=refs, moe=T.jax_trainer_run(tmp / "moe", T.MOE_ARCH))


def _f32(a):
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def _close_by_norm(got, want, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= TRAIN_REL, (what, err)
    far = int(np.sum(np.abs(got - want) > TRAIN_ENTRY_ABS))
    assert far <= TRAIN_OUTLIERS * got.size, (what, far)


# ----------------------------------------------------------------------
# the rule against the reference's
# ----------------------------------------------------------------------
class _FakeMesh:
    """What the reference's rules read of a Mesh: ``axis_names`` and
    ``shape``."""

    def __init__(self, dp, tp):
        self.axis_names = ("data", "model")
        self.shape = {"data": dp, "model": tp}


def _dim_of(spec, axis, lead):
    for i, e in enumerate(tuple(spec)):
        if e == axis or (isinstance(e, tuple) and axis in e):
            return i - lead
    return None


def _flat_specs(specs):
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): spec
            for path, spec in leaves}


def _flat_port(tree, path=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(_flat_port(v, f"{path}/{k}" if path else str(k)))
    return out


def _ref_path(path, period):
    """The reference's path of a port leaf and its stacked lead dims."""
    parts = path.split("/")
    if parts[0] == "layers":
        return "/".join(["layers", f"s{int(parts[1]) % period}",
                         *parts[2:]]), 1
    if parts[:2] == ["enc", "layers"]:
        return "/".join(["enc", "layers", *parts[3:]]), 1
    return path, 0


@pytest.mark.parametrize("dp,tp", MESHES, ids=[f"{d}x{t}" for d, t in MESHES])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fsdp_rule_matches_reference(arch, dp, tp):
    """Every leaf's FSDP dim equals the reference's, and its model dim
    too, but the listed divergences."""
    jcfg, tcfg = j_get_smoke(arch), configs.get_smoke(arch)
    shapes = jax.eval_shape(JLM(jcfg).init, jax.random.key(0))
    want = _flat_specs(param_specs(shapes, _FakeMesh(dp, tp),
                                   fsdp_axes=("data",), head_dim=jcfg.hd))
    params = LM(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
    got = _flat_port(param_rules(params, tcfg, tp, dp))
    split = 0
    for path, rule in got.items():
        ref, lead = _ref_path(path, len(jcfg.period))
        # a model axis of 1 splits nothing (the reference names it)
        want_tp = _dim_of(want[ref], "model", lead) if tp > 1 else None
        want_fsdp = _dim_of(want[ref], "data", lead)
        block, key = path.split("/")[-2:]
        if block in RANK_LOCAL and not block_splits(block, tcfg, tp):
            assert rule.tp is None, path          # the block stays whole
        elif key in RANK_LOCAL.get(block, {}):
            assert rule.tp == RANK_LOCAL[block][key], path
        else:
            assert rule.tp == want_tp, (path, rule, want[ref])
        if rule.tp is not None and rule.tp == want_fsdp:
            assert rule.fsdp is None, path        # whole over data
        else:
            assert rule.fsdp == want_fsdp, (path, rule, want[ref])
        split += rule.fsdp is not None
    assert split > 0 and len(got) == len(_flat_port(params))


@pytest.mark.parametrize("world", WORLDS)
def test_shard_then_gather_is_identity(fsdp, world):
    for r in fsdp["ranks"][world]:
        for arch, (same, split) in r["identity"].items():
            assert same, (world, arch)
            assert split > 0, (world, arch)


# ----------------------------------------------------------------------
# the trainer
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", list(T.FSDP_RUNS))
@pytest.mark.parametrize("world", WORLDS)
def test_fsdp_trainer_matches_reference_single_device(fsdp, world, name):
    want, records = fsdp["refs"][name]
    ranks = fsdp["ranks"][world]
    losses = [r["loss"] for r in records]
    for r in ranks:
        run = r[name]
        assert run["losses"] == ranks[0][name]["losses"]       # bit-equal
        np.testing.assert_allclose(run["losses"], losses, rtol=0,
                                   atol=LOSS_ABS)
        for path in want:
            _close_by_norm(run["flat"][path], want[path], f"{name}/{path}")
    got = ranks[0][name]["records"]
    np.testing.assert_allclose([g["grad_norm"] for g in got],
                               [w["grad_norm"] for w in records],
                               rtol=NORM_REL)
    one = T.state_bytes(configs.get_smoke("paper_tiny_lm"))
    held = [r[name]["bytes"] for r in ranks]
    if name == "replicated" and world == 2:
        assert held == [one] * len(ranks)
    else:             # on 2x2 the replicated run holds its model blocks
        assert max(held) <= BYTES_RATIO * one, (held, one)
    if name != "replicated":
        assert max(held) < min(r["replicated"]["bytes"] for r in ranks)


def test_fsdp_moe_trainer_matches_reference(fsdp):
    """phi3.5-moe SMOKE on 2x1 with FSDP: the global batch routed across
    the ranks as on one device, (loss, aux) a step within MOE_ABS of the
    reference's; its expert stacks split over data."""
    _, records = fsdp["moe"]
    want = [(r["loss"], r["aux"]) for r in records]
    ranks = fsdp["ranks"][2]
    np.testing.assert_allclose(ranks[0]["moe"]["records"], want, rtol=0,
                               atol=MOE_ABS)
    assert ranks[1]["moe"]["losses"] == ranks[0]["moe"]["losses"]
    one = T.state_bytes(configs.get_smoke(T.MOE_ARCH))
    assert max(r["moe"]["bytes"] for r in ranks) <= BYTES_RATIO * one


@pytest.mark.parametrize("world", WORLDS)
def test_checkpoint_gathers_a_leaf_at_a_time(fsdp, world):
    """While the FSDP trainer writes a checkpoint, no rank holds more
    gathered bytes than the largest whole leaf (each leaf goes to rank
    0's host, or is dropped, before the next is gathered); the
    whole-tree ``gather_state`` holds more, so the count can see it."""
    for r in fsdp["ranks"][world]:
        alive = r["save_alive"]
        assert alive["saving"] <= alive["leaf"] < alive["gathering"], alive


@pytest.mark.parametrize("world", WORLDS)
def test_fsdp_axes_resolve_to_the_batch_axes(fsdp, world):
    """Under a mesh ``fsdp_axes`` None is the batch axes and ``()`` turns
    FSDP off (the ``replicated`` runs above hold one device's bytes)."""
    for r in fsdp["ranks"][world]:
        assert r["resolve"] == (("data",), ())
