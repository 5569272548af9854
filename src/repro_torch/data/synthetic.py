"""Synthetic token corpus with learnable structure (the reference's
offline C4 stand-in, ``repro.data.synthetic``).

A per-seed first-order Markov chain over the vocabulary: transition
logits = Zipf unigram bias + a few strongly preferred successors per
token + Gaussian noise.  Every batch is a pure function of (seed,
stream, step) through threefry keys (``repro_torch.random``), so a
resumed run regenerates the same tokens, and the tokens are the
reference's: the keys, the successors and the uniforms are bit-equal;
``log`` (the Zipf bias, the Gumbel noise) and the inverse error function
(the noise) may round an ulp away from XLA's, which flips a draw only at
a near tie — and a flip then runs on along its sequence
(tests/test_torch_train.py measures how many sequences it touches).

The transition table is (V, V) f32: 1 MiB at the tiny LM's V = 512,
10.1 GB at xlstm-350m's 50,304 (built in place, its noise in row blocks,
so that the threefry temporaries stay small), 92 GB at Qwen's 151,936 —
the reference cannot build that one either.
"""

from __future__ import annotations

import torch

from repro_torch import random as rnd

# elements of the transition table's noise drawn at once: the threefry
# hash holds a few int64 temporaries of this size (≈ 0.5 GB each)
NOISE_BLOCK = 1 << 26

STREAM_TRAIN = 0
STREAM_CALIB = 1
STREAM_EVAL = 2


def zipf_logits(vocab: int, alpha: float = 1.2, device=None) -> torch.Tensor:
    ranks = torch.arange(1, vocab + 1, dtype=torch.float32, device=device)
    return -alpha * torch.log(ranks)


class MarkovCorpus:
    """First-order Markov token source with Zipf marginals, on
    ``device``."""

    def __init__(self, vocab: int, seed: int = 0, alpha: float = 1.2,
                 peak: float = 8.0, device="cpu"):
        self.vocab = vocab
        self.seed = seed
        self.device = torch.device(device)
        k1, k2 = rnd.split(rnd.key(seed, self.device)).unbind(0)
        base = zipf_logits(vocab, alpha, self.device)            # (V,)
        # each token gets a few strongly preferred successors (a repeated
        # successor adds its peak twice, as the reference's .at[].add):
        # base + boost, then + noise, in the reference's order, built in
        # place — no (V, V) boost or noise beside the table
        succ = rnd.randint(k1, (vocab, 3), 0, vocab).long()
        rows = torch.arange(vocab, device=self.device)[:, None].expand(-1, 3)
        times = (succ[:, :, None] == succ[:, None, :]).sum(-1)   # (V, 3)
        table = base.expand(vocab, vocab).clone()
        table[rows, succ] = base[succ] + peak * times
        # the noise row block by row block: each draw's bits depend on its
        # flat index only, so the pieces are the whole (V, V) draw's
        step = max(1, NOISE_BLOCK // vocab)
        for r in range(0, vocab, step):
            n = min(step, vocab - r)
            table[r:r + n] += 0.5 * rnd.normal(k2, (n, vocab),
                                               offset=r * vocab)
        self.trans_logits = table                                # (V, V)

    def sample(self, key: torch.Tensor, batch: int,
               length: int) -> torch.Tensor:
        """(batch, length) int32 tokens: token 0 from the Zipf marginal
        under ``split(key)[0]``, token t+1 from row ``tok_t`` of the
        transition table under ``split(split(key)[1], length - 1)[t]``.
        The Gumbel noise of every step is drawn in one batched call
        (the keys are known up front); the chain itself is a loop of
        argmaxes."""
        k0, kseq = rnd.split(key).unbind(0)
        zipf = zipf_logits(self.vocab, device=self.device)
        tok = rnd.categorical(k0, zipf.expand(batch, self.vocab))
        toks = [tok]
        if length > 1:
            noise = rnd.gumbel(rnd.split(kseq, length - 1),
                               (batch, self.vocab))       # (L-1, B, V)
            for t in range(length - 1):
                tok = torch.argmax(noise[t] + self.trans_logits[tok], dim=-1)
                toks.append(tok)
        return torch.stack(toks, dim=1).to(torch.int32)

    def batch_key(self, stream: int, step: int) -> torch.Tensor:
        key = rnd.key(self.seed, self.device)
        return rnd.fold_in(rnd.fold_in(key, stream), step)

    def batch_at(self, stream: int, step: int, batch: int,
                 length: int) -> torch.Tensor:
        return self.sample(self.batch_key(stream, step), batch, length)

