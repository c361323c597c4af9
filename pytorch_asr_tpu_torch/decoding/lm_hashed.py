"""Hashed backoff n-gram tables for large vocabularies (BPE pieces): the
port's counterpart of ``pytorch_asr_tpu.decoding.lm_hashed``.

The dense table of ``decoding.lm.tensorize`` is V^(n-1) x V floats: 3.69 MB
for the char 4-gram, 1.3 GB at the 135 pieces of the synthetic BPE vocab.
Here each n-gram order is an 8-way set-associative hash table instead, keyed
by two independent 32-bit FNV-1a folds of the id sequence; the unigram
log-probs and the single-token backoffs are dense (V,) rows, and where V^2
floats fit ``_BI_DENSE_BUDGET`` the bigram level is also a dense (V, V)
table (NaN where absent).  Each beam carries the last ``order - 1`` token
ids (a context WINDOW, 0 = no history) instead of a dense context id.

A bucket row is 32 float32 words, one 128-byte line:
``[k1 x 8 | k2 x 8 | val x 8 | pad x 8]``, the int32 keys bit-cast into the
float words.  The host half (``_hash_pair_np``, ``_build_table``,
``build_hashed_lm``) is numpy and builds the JAX package's arrays bit for
bit; ``HashedNgramLM`` holds them as tensors on one device.

Score recursion (bottom-up, equal to ``BackoffLM.score``'s top-down walk):

    s_1(c)   = uni[c]                      (absent unigrams = -20, as host)
    s_n(c)   = hit_n ? P_n(ctx_{n-1}, c) : bo(ctx_{n-1}) + s_{n-1}(c)
    score    = s_order(c)

where level n is skipped (bo = 0, no hit) unless the window's last n-1 ids
are all nonzero.  ``hashed_lm_logp_rows`` and ``hashed_lm_allmiss_rows`` are
that recursion in torch, the plain versions the search kernels
(``csrc/prefix_beam.cu``, their hashed source) are held to.  The 32-bit
folds are computed in int64 on values below 2^32, the multiply split into
16-bit halves so no product passes 2^63.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pytorch_asr_tpu_torch.decoding.lm import BackoffLM

# FNV-1a 32-bit, two independent streams (different basis/prime pairs); keys
# are the pair (h1, h2), so a false hit needs a 64-bit collision.
_BASIS1, _PRIME1 = 0x811C9DC5, 0x01000193
_BASIS2, _PRIME2 = 0x9747B28C, 0x85EBCA6B
_EMPTY = np.int32(-2147483648)     # empty-slot key (both halves)
_UNK_LOGP = -20.0                  # BackoffLM's missing-unigram score
BUCKET = 8                         # ways a bucket
_MASK32 = 0xFFFFFFFF

# A dense (V, V) bigram level costs V^2 floats; kept below this budget
# (64 MB: V <= 4096), as in the JAX package.
_BI_DENSE_BUDGET = 64 << 20


class HashTable(NamedTuple):
    """8-way set-associative table: bucket ``h1 & (n_buckets - 1)`` holds
    every way a key can take."""
    data: torch.Tensor    # (n_buckets, 32) f32: [k1 x8 | k2 x8 | val x8 | pad x8]


class HashedNgramLM(NamedTuple):
    """A backoff LM as tensors on one device.  probs[i] serves order i+2
    n-grams; backoffs[i] contexts of length i+2.  The unigram level is
    dense, and so is the bigram level (``bi_dense``, NaN where absent) when
    V^2 floats fit the budget."""
    uni: torch.Tensor                     # (V,) f32 log P(c)
    uni_backoff: torch.Tensor             # (V,) f32 backoff of length-1 contexts
    probs: tuple                          # tuple[HashTable], orders 2..N
    backoffs: tuple                       # tuple[HashTable], context lengths 2..N-1
    bi_dense: torch.Tensor | None = None  # (V, V) f32 log P(c | w), NaN = absent

    @property
    def order(self) -> int:
        return len(self.probs) + 1

    @property
    def vocab_size(self) -> int:
        return self.uni.shape[0]


# ------------------------------------------------------------------ host half
def _hash_pair_np(ids: tuple) -> tuple[np.uint32, np.uint32]:
    """The (h1, h2) FNV-1a folds of an id sequence, Python ints masked to
    32 bits."""
    h1, h2 = _BASIS1, _BASIS2
    for x in ids:
        x = int(x) & _MASK32
        h1 = ((h1 ^ x) * _PRIME1) & _MASK32
        h2 = ((h2 ^ x) * _PRIME2) & _MASK32
    return np.uint32(h1), np.uint32(h2)


def _build_table(entries: dict[tuple, float], device="cpu") -> HashTable:
    """The (n_buckets, 32) float32 bucket rows of ``entries`` on ``device``
    (insertion order decides the ways): n_buckets the least power of two at
    load factor <= 0.25, doubled and rebuilt while a bucket overflows its 8
    ways; a 64-bit key collision raises."""
    n = max(len(entries), 1)
    n_buckets = 1
    while n_buckets * BUCKET < 4 * n:
        n_buckets *= 2
    while True:
        mask = n_buckets - 1
        k1 = np.full((n_buckets, BUCKET), _EMPTY, np.int32)
        k2 = np.full((n_buckets, BUCKET), _EMPTY, np.int32)
        val = np.zeros((n_buckets, BUCKET), np.float32)
        fill = np.zeros((n_buckets,), np.int32)
        ok = True
        for ng, v in entries.items():
            h1, h2 = _hash_pair_np(ng)
            s1, s2 = h1.view(np.int32), h2.view(np.int32)
            b = int(h1) & mask
            ways = fill[b]
            if np.any((k1[b, :ways] == s1) & (k2[b, :ways] == s2)):
                raise ValueError(f"64-bit hash collision for ngram {ng}")
            if ways == BUCKET:               # bucket overflow: grow and rebuild
                ok = False
                break
            k1[b, ways], k2[b, ways], val[b, ways] = s1, s2, np.float32(v)
            fill[b] = ways + 1
        if ok:
            break
        n_buckets *= 2
    data = np.concatenate([k1.view(np.float32), k2.view(np.float32), val,
                           np.zeros((n_buckets, BUCKET), np.float32)], axis=1)
    return HashTable(torch.from_numpy(data).to(device))


def build_hashed_lm(lm: BackoffLM, vocab_size: int, device="cpu") -> HashedNgramLM:
    """A BackoffLM compiled into hash tables on ``device`` (on the host,
    once)."""
    uni = np.full((vocab_size,), _UNK_LOGP, np.float32)
    uni_bo = np.zeros((vocab_size,), np.float32)
    probs: list[dict] = [dict() for _ in range(max(lm.order - 1, 0))]
    backoffs: list[dict] = [dict() for _ in range(max(lm.order - 2, 0))]
    for ng, lp in lm.logprobs.items():
        if len(ng) == 1:
            if 0 <= ng[0] < vocab_size:
                uni[ng[0]] = lp
        elif len(ng) <= lm.order:
            probs[len(ng) - 2][ng] = lp
    for ctx, bo in lm.backoffs.items():
        if len(ctx) == 1:
            if 0 <= ctx[0] < vocab_size:
                uni_bo[ctx[0]] = bo
        elif len(ctx) <= lm.order - 1:
            backoffs[len(ctx) - 2][ctx] = bo
    bi_dense = None
    if probs and vocab_size * vocab_size * 4 <= _BI_DENSE_BUDGET:
        bi = np.full((vocab_size, vocab_size), np.nan, np.float32)
        for (w, c), lp in probs[0].items():
            if 0 <= w < vocab_size and 0 <= c < vocab_size:
                bi[w, c] = lp
        bi_dense = torch.from_numpy(bi).to(device)
    return HashedNgramLM(
        uni=torch.from_numpy(uni).to(device), uni_backoff=torch.from_numpy(uni_bo).to(device),
        probs=tuple(_build_table(p, device) for p in probs),
        backoffs=tuple(_build_table(b, device) for b in backoffs), bi_dense=bi_dense)


# ---------------------------------------------------------------- device half
def _mul32(h: torch.Tensor, p: int) -> torch.Tensor:
    """(h * p) mod 2^32 for int64 h in [0, 2^32): the product split into
    p's 16-bit halves, each partial product below 2^48."""
    lo = h * (p & 0xFFFF)
    hi = ((h * (p >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _fold(h1: torch.Tensor, h2: torch.Tensor, x: torch.Tensor):
    """One FNV-1a step of both streams: h1, h2 int64 in [0, 2^32), x any
    int tensor (taken mod 2^32, as a uint32 cast takes it)."""
    x = x.long() & _MASK32
    return _mul32(h1 ^ x, _PRIME1), _mul32(h2 ^ x, _PRIME2)


def _as_int32(h: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> the int32 of the same bits."""
    return torch.where(h >= 2 ** 31, h - 2 ** 32, h).to(torch.int32)


def _lookup(table: HashTable, h1: torch.Tensor, h2: torch.Tensor):
    """(found, value) for hash pairs of any shape: one bucket row each, the
    at most one matching way taken by a masked sum."""
    rows = table.data[h1 & (table.data.shape[0] - 1)]               # (..., 32)
    keys = rows[..., :2 * BUCKET].view(torch.int32)
    hit = ((keys[..., :BUCKET] == _as_int32(h1)[..., None])
           & (keys[..., BUCKET:] == _as_int32(h2)[..., None]))         # (..., 8)
    val = rows[..., 2 * BUCKET:3 * BUCKET]
    return hit.any(dim=-1), torch.where(hit, val, 0.0).sum(dim=-1)


def _context_level(lm: HashedNgramLM, ctx: torch.Tensor, n: int):
    """(valid, bo, h1, h2) for the order-n lookups of a (..., C) window:
    the context is its last n-1 ids, valid where all are nonzero; bo its
    backoff where valid and present, else 0."""
    C, V, m = ctx.shape[-1], lm.vocab_size, n - 1
    suffix = ctx[..., C - m:]
    valid = (suffix != 0).all(dim=-1)
    h1 = torch.full(ctx.shape[:-1], _BASIS1, dtype=torch.int64, device=ctx.device)
    h2 = torch.full(ctx.shape[:-1], _BASIS2, dtype=torch.int64, device=ctx.device)
    for j in range(m):
        h1, h2 = _fold(h1, h2, suffix[..., j])
    if m == 1:
        bo = lm.uni_backoff[suffix[..., 0].long().clamp(0, V - 1)]
        bo_found = torch.ones_like(valid)
    else:
        bo_found, bo = _lookup(lm.backoffs[m - 2], h1, h2)
    return valid, torch.where(valid & bo_found, bo, 0.0), h1, h2


def hashed_lm_logp_rows(lm: HashedNgramLM, ctx: torch.Tensor,
                        cands: torch.Tensor | None = None) -> torch.Tensor:
    """log P(c | ctx) for windows ``ctx`` (..., C) int (C = order - 1,
    oldest first, 0 = no history).  ``cands`` None: every token, (..., V);
    else an int (..., A) candidate subset, (..., A).  The bigram level reads
    ``bi_dense`` when scoring every token and it exists, else hash rows (the
    values are the same)."""
    V, N = lm.vocab_size, lm.order
    all_cands = cands is None
    if all_cands:
        cands = torch.arange(V, device=ctx.device).expand(ctx.shape[:-1] + (V,))
    cands = cands.long()
    score = lm.uni[cands.clamp(0, V - 1)]
    for n in range(2, N + 1):
        valid, bo, h1, h2 = _context_level(lm, ctx, n)
        if n == 2 and lm.bi_dense is not None and all_cands:
            rows = lm.bi_dense[ctx[..., -1].long().clamp(0, V - 1)]     # (..., V)
            found = ~torch.isnan(rows) & valid[..., None]
            val = torch.where(found, rows, 0.0)
        else:
            ch1, ch2 = _fold(h1[..., None], h2[..., None], cands)
            found, val = _lookup(lm.probs[n - 2], ch1, ch2)
            found = found & valid[..., None]
        score = torch.where(found, val, bo[..., None] + score)
    return score


def hashed_lm_allmiss_rows(lm: HashedNgramLM, ctx: torch.Tensor) -> torch.Tensor:
    """The every-level-miss rows (..., V): the unigram row plus the stacked
    context backoffs, added level by level as the recursion adds them.
    Exact for a candidate absent from every higher-order table; the search
    fills the rows outside a frame's top ``lm_top_k`` chars with it."""
    score = lm.uni.expand(ctx.shape[:-1] + (lm.vocab_size,))
    for n in range(2, lm.order + 1):
        _, bo, _, _ = _context_level(lm, ctx, n)
        score = bo[..., None] + score
    return score


def roll_context_window(ctx: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Appends c to (..., C) windows: shift left, drop the oldest."""
    return torch.cat([ctx[..., 1:], c[..., None].to(ctx.dtype)], dim=-1)
