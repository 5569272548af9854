"""AdamW with a configurable moment dtype and global-norm clipping (the
reference's ``repro.optim.adamw``).

The update math is f32; params keep their storage dtype and the moments
``moment_dtype`` ("bfloat16" halves the optimizer's memory).  Weight
decay applies to matrices only (``p.ndim >= 2``) — counted, as in the
reference, on the reference's leaves, where the layers are stacked
(L, ...): a layer's norm scale is a (L, d) leaf there, so it decays too.
The params are the port's trees — nested dicts, the layers a list under
``"layers"`` — and the state is the reference's ``OptState(step, mu,
nu)`` with ``mu``/``nu`` shaped like them.

Under a mesh the trainer hands :meth:`AdamW.update` a rank's shards
(``dist.sharding``: model blocks, FSDP blocks) with ``counted``, which
names the leaves whose squares this rank adds to the global norm: one
rank of every set that holds the same block, so that a leaf split over
the data group is summed over it, a leaf split over the model group
over that, and a leaf held whole on every rank counts once.  One
all-reduce over the world makes the norm, and so the clip scale, one
device's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional, Tuple, Union

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts / lists / tuples (the
    structure of ``tree``; ``rest`` share it), in :func:`tree_leaves`
    order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The leaves, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def reference_ndim(params: Any) -> Any:
    """Each leaf's rank in the reference's tree: one more under
    ``params["layers"]`` (stacked there)."""
    ndim = tree_map(lambda p: p.dim(), params)
    if isinstance(params, dict) and isinstance(params.get("layers"), list):
        ndim["layers"] = tree_map(lambda n: n + 1, ndim["layers"])
    return ndim


class OptState(NamedTuple):
    step: torch.Tensor    # () int32
    mu: Any               # first moments (a tree like the params)
    nu: Any               # second moments


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: Optional[float] = 1.0
    moment_dtype: str = "float32"         # "float32" | "bfloat16"

    def init(self, params: Any) -> OptState:
        mdt = DTYPES[self.moment_dtype]
        leaf = tree_leaves(params)[0]

        def zeros(p):
            return torch.zeros(p.shape, dtype=mdt, device=p.device)

        return OptState(
            step=torch.zeros((), dtype=torch.int32, device=leaf.device),
            mu=tree_map(zeros, params), nu=tree_map(zeros, params))

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=torch.float32, device=step.device)

    @torch.no_grad()
    def update(self, grads: Any, state: OptState, params: Any,
               counted: Any = None, group=None
               ) -> Tuple[Any, OptState, dict]:
        """Returns (new_params, new_state, {"grad_norm", "lr"}).
        ``counted`` (a tree of bools like ``grads``) and ``group``: the
        arguments are one rank's shards, and the squares of the leaves
        it counts are summed over ``group`` (the module docstring)."""
        step = state.step + 1
        g32 = tree_map(lambda g: g.float(), grads)
        gnorm = torch.sqrt(global_sq(g32, counted, group))
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
            g32 = tree_map(lambda g: g * scale, g32)
        sf = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(torch.tensor(self.b1, device=sf.device), sf)
        bc2 = 1.0 - torch.pow(torch.tensor(self.b2, device=sf.device), sf)
        lr = self._lr(step)
        mdt = DTYPES[self.moment_dtype]
        b1, b2 = self.b1, self.b2

        def upd(p, g, mu, nu, ndim):
            mu32 = mu.float() * b1 + g * (1 - b1)
            nu32 = nu.float() * b2 + (g * g) * (1 - b2)
            delta = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + self.eps)
            if self.weight_decay and ndim >= 2:      # decay matrices only
                delta = delta + self.weight_decay * p.float()
            newp = p.float() - lr * delta
            return newp.to(p.dtype), mu32.to(mdt), nu32.to(mdt)

        out = tree_map(upd, params, g32, state.mu, state.nu,
                       reference_ndim(params))
        return _pick(out, 0), OptState(step, _pick(out, 1), _pick(out, 2)), {
            "grad_norm": gnorm, "lr": lr}


def global_sq(g32: Any, counted: Any = None, group=None) -> torch.Tensor:
    """The sum of the squares of every gradient entry: of the leaves of
    ``g32`` on one device, or of the leaves that this rank ``counted``,
    summed over ``group``."""
    if counted is None:
        return sum(torch.sum(g * g) for g in tree_leaves(g32))
    from repro_torch.dist import comm

    leaves = tree_leaves(g32)
    total = torch.zeros((1,), dtype=torch.float32, device=leaves[0].device)
    for g, mine in zip(leaves, tree_leaves(counted)):
        if mine:
            total = total + torch.sum(g * g)
    return comm.all_reduce_(total, group)[0]


def _pick(tree: Any, i: int) -> Any:
    """Element ``i`` of the (param, mu, nu) tuples at the leaves."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]
