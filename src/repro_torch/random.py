"""JAX's threefry2x32 random numbers in torch ops, bit for bit.

The reference draws every random number through ``jax.random`` with the
threefry2x32 generator: the sampled decode steps (per-(uid, step) keys
through ``fold_in``, then ``categorical``), the static buckets' key
``split`` sequence, the synthetic corpus and the keyed param init.  This
module computes the same functions, so that a run of the port sees the
reference's numbers:

  ``key(seed)``                   the raw (2,) key: (0, seed mod 2³²)
  ``fold_in(key, data)``          threefry2x32(key, (0, data))
  ``split(key, num)``             the partitionable scheme: counts are a
                                  64-bit iota over ``num``
  ``random_bits(key, shape)``     32-bit bits: bits1 ^ bits2 of the hash
                                  of a 64-bit iota over ``shape``
  ``uniform``, ``randint``, ``normal``, ``gumbel``, ``categorical``

It implements ``jax_threefry_partitionable=True`` (jax's default since
0.5): ``split`` and ``random_bits`` give other bits under the older
scheme.

Keys are int64 tensors of shape (..., 2) holding uint32 values; leading
dimensions batch the key (the reference's ``vmap`` over keys): a function
called with keys (K..., 2) returns (K..., *shape).  The bit path is
integer ops only — int64 masked to 32 bits after every add and shift —
and runs the same on the CPU and on CUDA, so the card's bits equal the
CPU's.  The float parts (``uniform``'s bit trick is exact; ``log`` in
``gumbel``, ``log1p`` in ``normal``'s inverse error function) are
torch's, which may round an ulp away from XLA's.

Every function takes its keys explicitly: there is no global state.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
F32_TINY = float(torch.finfo(torch.float32).tiny)

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def key(seed: int, device=None) -> torch.Tensor:
    """The raw threefry key of an integer seed, as ``jax.random.key``
    makes it without 64-bit mode: (0, seed mod 2³²)."""
    seed = int(seed)
    if not -2**31 <= seed < 2**31:
        raise OverflowError(f"seed {seed} does not fit in int32")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of count pairs (x1, x2) under
    the key (k1, k2); all int64 holding uint32 values, broadcast
    together."""
    k3 = k1 ^ k2 ^ _PARITY
    ks = (k1, k2, k3)
    a = (x1 + k1) & MASK
    b = (x2 + k2) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK
    return a, b


def _split_key(k: torch.Tensor, extra_dims: int):
    """(k1, k2) of keys (K..., 2), shaped (K..., 1 × extra_dims) to
    broadcast over a trailing count shape."""
    k1, k2 = k[..., 0], k[..., 1]
    view = k1.shape + (1,) * extra_dims
    return k1.reshape(view), k2.reshape(view)


def _iota_2x32(shape: Tuple[int, ...], device, offset: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of a 64-bit iota from ``offset``, reshaped
    to ``shape``."""
    n = math.prod(shape)
    flat = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    return (flat >> 32).reshape(shape), (flat & MASK).reshape(shape)


def _hash_iota(k: torch.Tensor, shape: Tuple[int, ...], offset: int = 0):
    hi, lo = _iota_2x32(shape, k.device, offset)
    k1, k2 = _split_key(k, len(shape))
    return threefry2x32(k1, k2, hi, lo)


def split(k: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """New keys (K..., *num, 2) from keys (K..., 2): the partitionable
    scheme's fold-like split (``_threefry_split_foldlike``)."""
    b1, b2 = _hash_iota(k, _shape(num))
    return torch.stack([b1, b2], dim=-1)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: keys (K..., 2) and data broadcastable to
    K... (taken mod 2³², as the reference's uint32 cast)."""
    data = torch.as_tensor(data, device=k.device).to(torch.int64) & MASK
    k1, k2 = k[..., 0], k[..., 1]
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def random_bits(k: torch.Tensor, shape: Shape,
                offset: int = 0) -> torch.Tensor:
    """32-bit random bits (K..., *shape) as int64 in [0, 2³²):
    ``bits1 ^ bits2`` of the hash of a 64-bit iota over ``shape``.  Each
    element's bits depend on the key and its flat index alone, so
    ``offset`` draws the elements ``offset ..`` of a larger draw: a big
    array comes out bit for bit in pieces."""
    b1, b2 = _hash_iota(k, _shape(shape), offset)
    return b1 ^ b2


def uniform(k: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0, offset: int = 0) -> torch.Tensor:
    """f32 uniforms in [minval, maxval): the 23 high bits under the
    exponent of 1.0, minus 1, scaled — ``jax.random.uniform``
    (``offset``: as :func:`random_bits`)."""
    bits = random_bits(k, shape, offset)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo = torch.tensor(minval, dtype=torch.float32, device=k.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=k.device)
    return torch.maximum(lo, (floats - 1.0) * (hi - lo) + lo)


def randint(k: torch.Tensor, shape: Shape, minval: int,
            maxval: int) -> torch.Tensor:
    """int32 in [minval, maxval): two 32-bit draws combined modulo the
    span in wrapping uint32 arithmetic — ``jax.random.randint`` for int32
    and host-int bounds."""
    if not -2**31 <= minval < 2**31 or not -2**31 <= maxval < 2**31:
        raise ValueError("randint: bounds must fit in int32")
    k1, k2 = split(k).unbind(-2)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = 1 if maxval <= minval else (maxval - minval) & MASK
    m = 2**16 % span
    multiplier = ((m * m) & MASK) % span        # uint32 product wraps
    off = ((higher % span) * multiplier + lower % span) & MASK
    return (minval + off % span).to(torch.int32)


def _erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's single-precision inverse error function (Giles' polynomial
    approximation, ``ErfInv32``): the f32 ops in the order XLA runs
    them."""
    lt5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
           0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
           1.50140941)
    ge5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
           0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
           2.83297682)
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(small, torch.tensor(lt5[i], dtype=x.dtype,
                                               device=x.device),
                           torch.tensor(ge5[i], dtype=x.dtype,
                                        device=x.device))

    p = coef(0)
    for i in range(1, 9):
        p = coef(i) + p * w
    big = torch.finfo(torch.float32).max
    return torch.where(x.abs() == 1.0, x * big, p * x)


def normal(k: torch.Tensor, shape: Shape = (),
           offset: int = 0) -> torch.Tensor:
    """f32 standard normals: √2·erf⁻¹(u), u uniform in (-1, 1) —
    ``jax.random.normal`` (``offset``: as :func:`random_bits`)."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(k, shape, lo, 1.0, offset)
    return torch.tensor(math.sqrt(2), dtype=torch.float32) * _erf_inv_f32(u)


def gumbel(k: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """f32 standard Gumbel noise, ``mode="low"``: -log(-log(u)), u
    uniform in [tiny, 1)."""
    return -torch.log(-torch.log(uniform(k, shape, F32_TINY, 1.0)))


def categorical(k: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Draws over the last axis by the Gumbel-max trick:
    argmax(gumbel + logits), the first maximum winning.  Keys (K..., 2)
    batch the leading dims of ``logits`` (K..., *rest, V): each key
    draws noise over its own (*rest, V) block — one key for a whole
    batch (K = ()) or one key a row."""
    kdims = k.dim() - 1
    noise = gumbel(k, logits.shape[kdims:])
    return torch.argmax(noise + logits, dim=-1)
