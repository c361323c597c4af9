"""Char n-gram LM for shallow fusion: the port's copy of
``pytorch_asr_tpu.decoding.lm`` (numpy and plain Python, no JAX).

The backoff LM is *tensorized* once on the host into a dense conditional
table P(c | ctx) over all length-(n-1) char contexts, which the beam search
gathers from on the device.  For the char vocab (V = 31) a dense 4-gram table
is V^3 x V floats = 3.69 MB.  Context ids roll as ctx' = (ctx * V + c) mod
V^(n-1).

Also: a minimal ARPA reader and writer (the same text as the JAX package's,
so either package reads the other's files), and the add-k and modified
Kneser-Ney estimators that build LMs from text without external tools.
"""

from __future__ import annotations

import math
from collections import defaultdict

import numpy as np

from pytorch_asr_tpu_torch.data.tokenizer import CharTokenizer

LOG10 = math.log(10.0)


class BackoffLM:
    """Katz-style backoff char LM: logprobs[ngram] (natural log) + backoffs."""

    def __init__(self, order: int, logprobs: dict[tuple, float],
                 backoffs: dict[tuple, float]) -> None:
        self.order = order
        self.logprobs = logprobs
        self.backoffs = backoffs

    def score(self, ctx: tuple, c: int) -> float:
        """log P(c | ctx) with backoff; ctx is a tuple of token ids."""
        ctx = tuple(ctx[-(self.order - 1):]) if self.order > 1 else ()
        backoff = 0.0
        while True:
            ng = ctx + (c,)
            if ng in self.logprobs:
                return self.logprobs[ng] + backoff
            if not ctx:
                return backoff + self.logprobs.get((c,), -20.0)
            backoff += self.backoffs.get(ctx, 0.0)
            ctx = ctx[1:]


def _count_ngrams(texts: list[str], order: int, tok: CharTokenizer,
                  include_eos: bool = False) -> list[dict]:
    counts: list[dict] = [defaultdict(int) for _ in range(order + 1)]
    for text in texts:
        ids = [int(i) for i in tok.encode(text)]
        if include_eos:
            ids.append(tok.eos_id)
        for i in range(len(ids)):
            for n in range(1, order + 1):
                if i + n <= len(ids):
                    counts[n][tuple(ids[i : i + n])] += 1
    return counts


def train_char_ngram(texts: list[str], order: int = 3,
                     tokenizer: CharTokenizer | None = None) -> BackoffLM:
    """Tiny add-k interpolated char LM from raw text (for tests/synthetic runs)."""
    tok = tokenizer or CharTokenizer()
    counts = _count_ngrams(texts, order, tok)
    V = tok.vocab_size
    logprobs: dict[tuple, float] = {}
    backoffs: dict[tuple, float] = {}
    k = 0.1
    total_uni = sum(counts[1].values())
    for n in range(1, order + 1):
        for ng, c in counts[n].items():
            if n == 1:
                logprobs[ng] = math.log((c + k) / (total_uni + k * V))
            else:
                ctx_count = counts[n - 1].get(ng[:-1], 0)
                logprobs[ng] = math.log((c + k) / (ctx_count + k * V))
    # uniform backoff weights (adequate for fusion tests)
    for n in range(1, order):
        for ng in counts[n]:
            backoffs[ng] = math.log(0.4)
    return BackoffLM(order, logprobs, backoffs)


def train_char_ngram_kn(texts: list[str], order: int = 4,
                        tokenizer: CharTokenizer | None = None,
                        include_eos: bool = False) -> BackoffLM:
    """Interpolated modified Kneser-Ney char LM (Chen & Goodman 1998), the
    estimator KenLM implements.  Stored probabilities are the interpolated
    KN probabilities and backoff(ctx) = log gamma(ctx), so ``BackoffLM.score``,
    ``write_arpa`` and ``tensorize`` apply unchanged.  ``include_eos``
    appends the tokenizer's eos id to every sentence."""
    tok = tokenizer or CharTokenizer()
    V = tok.vocab_size
    counts = _count_ngrams(texts, order, tok, include_eos)

    # Continuation counts: lower orders count the distinct left-extensions
    # N1+(. ctx w), not raw frequency.
    cont: list[dict] = [defaultdict(int) for _ in range(order)]
    for n in range(2, order + 1):
        for ng in counts[n]:
            cont[n - 1][ng[1:]] += 1

    def eff_counts(n: int) -> dict:
        """Raw counts at the top order, continuation counts below."""
        return counts[n] if n == order else cont[n]

    def discounts(n: int) -> tuple[float, float, float]:
        cc = defaultdict(int)
        for _, c in eff_counts(n).items():
            if c <= 4:
                cc[c] += 1
        n1, n2, n3, n4 = (max(cc[i], 1) for i in (1, 2, 3, 4))
        y = n1 / (n1 + 2.0 * n2)
        d1 = max(1.0 - 2.0 * y * n2 / n1, 0.0)
        d2 = max(2.0 - 3.0 * y * n3 / n2, 0.0)
        d3 = max(3.0 - 4.0 * y * n4 / n3, 0.0)
        return d1, d2, d3

    def dfor(c: int, d: tuple) -> float:
        return d[0] if c == 1 else (d[1] if c == 2 else d[2])

    logprobs: dict[tuple, float] = {}
    backoffs: dict[tuple, float] = {}

    # unigram level: continuation probability interpolated with uniform
    uni = eff_counts(1)
    total1 = sum(uni.values()) or 1
    d1u, d2u, d3u = discounts(1)
    n_types = [0.0, 0.0, 0.0]
    for c in uni.values():
        n_types[min(c, 3) - 1] += 1
    gamma_uni = (d1u * n_types[0] + d2u * n_types[1] + d3u * n_types[2]) / total1
    p_uni = {w: 0.0 for w in range(V)}
    for (w,), c in uni.items():
        p_uni[w] = max(c - dfor(c, (d1u, d2u, d3u)), 0.0) / total1
    for w in range(V):
        p_uni[w] += gamma_uni / V
        # floor so every char keeps nonzero mass even with gamma ~ 0
        p_uni[w] = max(p_uni[w], 1e-10)
    z = sum(p_uni.values())
    p_interp_prev = {(w,): p / z for w, p in p_uni.items()}
    for ng, p in p_interp_prev.items():
        logprobs[ng] = math.log(p)

    # higher orders: absolute discounting + interpolation
    for n in range(2, order + 1):
        eff = eff_counts(n)
        d = discounts(n)
        ctx_total: dict[tuple, int] = defaultdict(int)
        ctx_types: dict[tuple, list] = defaultdict(lambda: [0, 0, 0])
        for ng, c in eff.items():
            ctx_total[ng[:-1]] += c
            ctx_types[ng[:-1]][min(c, 3) - 1] += 1
        p_interp: dict[tuple, float] = {}
        for ctx, tot in ctx_total.items():
            t1, t2, t3 = ctx_types[ctx]
            gamma = (d[0] * t1 + d[1] * t2 + d[2] * t3) / tot
            backoffs[ctx] = math.log(max(gamma, 1e-10))
        for ng, c in eff.items():
            ctx = ng[:-1]
            lower = p_interp_prev.get(ng[1:])
            if lower is None:
                lower = math.exp(logprobs.get((ng[-1],), math.log(1e-10)))
            p = (max(c - dfor(c, d), 0.0) / ctx_total[ctx]
                 + math.exp(backoffs[ctx]) * lower)
            p_interp[ng] = p
            logprobs[ng] = math.log(max(p, 1e-12))
        p_interp_prev = p_interp

    return BackoffLM(order, logprobs, backoffs)


def perplexity(lm: BackoffLM, texts: list[str],
               tokenizer: CharTokenizer | None = None) -> float:
    """Per-char perplexity of ``texts`` under ``lm``."""
    tok = tokenizer or CharTokenizer()
    total, n_tok = 0.0, 0
    for text in texts:
        ids = [int(i) for i in tok.encode(text)]
        for i, c in enumerate(ids):
            ctx = tuple(ids[max(0, i - (lm.order - 1)) : i])
            total += lm.score(ctx, c)
            n_tok += 1
    return math.exp(-total / max(n_tok, 1))


def read_arpa(path: str, tokenizer: CharTokenizer | None = None) -> BackoffLM:
    """Minimal ARPA reader for char-token LMs (tokens are single characters,
    '<space>' for space) and for a BPE tokenizer's LMs (tokens are whole
    pieces, id = index + 1); <s> and </s> map to sos and eos, <blank> to the
    CTC blank, <unk> and unknown symbols are skipped.  The file is read as
    UTF-8 whatever the locale (pieces carry the marker "▁")."""
    tok = tokenizer or CharTokenizer()
    specials = {"<s>": tok.sos_id, "</s>": tok.eos_id, "<blank>": tok.blank_id,
                "<unk>": None, "<UNK>": None}
    piece_map = getattr(tok, "_piece_to_id", None)

    def to_id(sym: str) -> int | None:
        if sym in specials:
            return specials[sym]
        if piece_map is not None:
            return piece_map.get(sym)
        ids = tok.encode(" " if sym == "<space>" else sym)
        return int(ids[0]) if len(ids) == 1 else None

    logprobs: dict[tuple, float] = {}
    backoffs: dict[tuple, float] = {}
    order = 1
    cur_n = 0
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("\\data\\") or line.startswith("ngram"):
                continue
            if line.startswith("\\") and "-grams:" in line:
                cur_n = int(line[1 : line.index("-")])
                order = max(order, cur_n)
                continue
            if line.startswith("\\end\\"):
                break
            parts = line.split("\t")
            if len(parts) < 2:
                parts = line.split()
                if len(parts) < cur_n + 1:
                    continue
                parts = [parts[0], " ".join(parts[1 : cur_n + 1])] + parts[cur_n + 1:]
            lp = float(parts[0]) * LOG10
            ids = [to_id(s) for s in parts[1].split()]
            if any(i is None for i in ids):
                continue
            ng = tuple(ids)
            logprobs[ng] = lp
            if len(parts) >= 3:
                try:
                    backoffs[ng] = float(parts[2]) * LOG10
                except ValueError:
                    pass
    return BackoffLM(order, logprobs, backoffs)


def write_arpa(lm: BackoffLM, path: str,
               tokenizer: CharTokenizer | None = None) -> None:
    """Serialize a BackoffLM to ARPA as UTF-8 (char symbols, ' ' written as
    <space>; a BPE tokenizer's ids as their pieces)."""
    tok = tokenizer or CharTokenizer()
    specials = {tok.sos_id: "<s>", tok.eos_id: "</s>", tok.blank_id: "<blank>"}
    pieces = getattr(tok, "pieces", None)

    def sym(i: int) -> str:
        if i in specials:
            return specials[i]
        if pieces is not None and 1 <= i <= len(pieces):
            return pieces[i - 1]
        ch = tok.decode([i])
        return "<space>" if ch == " " else ch

    by_order: dict[int, list] = {}
    for ng, lp in lm.logprobs.items():
        by_order.setdefault(len(ng), []).append((ng, lp))
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("\\data\\\n")
        for n in sorted(by_order):
            fh.write(f"ngram {n}={len(by_order[n])}\n")
        fh.write("\n")
        for n in sorted(by_order):
            fh.write(f"\\{n}-grams:\n")
            for ng, lp in sorted(by_order[n]):
                cols = [f"{lp / LOG10:.6f}", " ".join(sym(i) for i in ng)]
                if ng in lm.backoffs:
                    cols.append(f"{lm.backoffs[ng] / LOG10:.6f}")
                fh.write("\t".join(cols) + "\n")
            fh.write("\n")
        fh.write("\\end\\\n")


def _lookup(keys: np.ndarray, table_keys: np.ndarray, table_vals: np.ndarray):
    """(found, value) of each key in a sorted key table (value 0 where absent)."""
    if not len(table_keys):
        return np.zeros(keys.shape, bool), np.zeros(keys.shape)
    idx = np.minimum(np.searchsorted(table_keys, keys), len(table_keys) - 1)
    found = table_keys[idx] == keys
    return found, np.where(found, table_vals[idx], 0.0)


def _sorted_table(entries: dict[tuple, float], base: int):
    """n-gram dict -> (sorted int64 keys, values); a tuple (x_1..x_k) keys as
    the base-``base`` number with digits x_i + 1, unique across lengths."""
    keys = np.array([sum((x + 1) * base ** (len(ng) - 1 - j) for j, x in enumerate(ng))
                     for ng in entries], np.int64)
    vals = np.array(list(entries.values()), np.float64)
    order = np.argsort(keys)
    return keys[order], vals[order]


def tensorize(lm: BackoffLM, tokenizer: CharTokenizer | None = None,
              order: int | None = None, rows_per_chunk: int = 1 << 16) -> np.ndarray:
    """Dense (V^(n-1), V) table of log P(c | ctx) with backoff fully applied.

    Row index encodes the context as base-V digits, oldest char most
    significant; id 0 (blank, which never appears in a real prefix) means
    "no history" and is dropped from the context wherever it stands.

    This is ``BackoffLM.score`` for every (row, c) at once, in numpy: each
    row's backoffs are summed in the order ``score`` adds them and the hit's
    log-probability is added last, so the table equals the JAX package's
    pure-Python ``tensorize`` bit for bit.
    """
    tok = tokenizer or CharTokenizer()
    V = tok.vocab_size
    n = order or lm.order
    n_ctx = V ** (n - 1)
    base = V + 1
    m = min(n - 1, lm.order - 1) if lm.order > 1 else 0
    lp_keys, lp_vals = _sorted_table(lm.logprobs, base)
    bo_keys, bo_vals = _sorted_table(lm.backoffs, base)
    chars = np.arange(V, dtype=np.int64) + 1
    table = np.empty((n_ctx, V), np.float32)
    for start in range(0, n_ctx, rows_per_chunk):
        rows = np.arange(start, min(start + rows_per_chunk, n_ctx), dtype=np.int64)
        R = len(rows)
        digits = np.stack([(rows // V ** (n - 2 - p)) % V for p in range(n - 1)], 1) \
            if n > 1 else np.zeros((R, 0), np.int64)
        # Right-align each row's nonzero digits (a stable sort keeps their
        # order), then keep the newest m, as score cuts ctx to order - 1.
        packed = np.take_along_axis(digits, np.argsort(digits != 0, axis=1, kind="stable"), 1)
        packed = packed[:, packed.shape[1] - m:]
        ell = (packed != 0).sum(1)
        # suffix_key[:, s]: key of the row's newest s context chars
        suffix_key = np.zeros((R, m + 1), np.int64)
        for s in range(1, m + 1):
            suffix_key[:, s] = (packed[:, m - s] + 1) * base ** (s - 1) + suffix_key[:, s - 1]
        out = np.zeros((R, V))
        done = np.zeros((R, V), bool)
        acc = np.zeros(R)                      # backoffs summed so far
        for i in range(m + 1):
            s = ell - i
            live = s >= 0
            sk = suffix_key[np.arange(R), np.maximum(s, 0)]
            found, lp = _lookup(sk[:, None] * base + chars[None, :], lp_keys, lp_vals)
            hit = live[:, None] & ~done & found
            out = np.where(hit, lp + acc[:, None], out)
            done |= hit
            miss = (live & (s == 0))[:, None] & ~done
            out = np.where(miss, acc[:, None] + -20.0, out)
            done |= miss
            _, bo = _lookup(sk, bo_keys, bo_vals)
            acc = np.where(live & (s > 0), acc + bo, acc)
        table[rows] = out
    return table


def roll_context(ctx, c, vocab_size: int, order: int):
    """Context update: ctx' = (ctx*V + c) mod V^(n-1)."""
    return (ctx * vocab_size + c) % (vocab_size ** (order - 1))
