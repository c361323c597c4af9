"""CTC prefix beam search with dense n-gram shallow fusion: the port's
counterpart of ``pytorch_asr_tpu.decoding.prefix_beam``.

``prefix_beam_search`` is the entry point.  It log-softmaxes the logits (and,
for ``ext_top_a``, takes each frame's top-A chars) and hands them to
``ops/beam_cuda.py``, whose kernel (``csrc/prefix_beam.cu``) runs the whole
search on the card; on CPU tensors the wrapper runs ``beam_scan_plain``
below instead.  ``prefix_beam_search_plain`` is that plain search from the
logits, on either device; the tests and ``chip_smoke.py`` hold the kernel
against it.

The plain search is a PyTorch port of the JAX package's ``lax.scan`` for the
fusion sources ported so far (none, or a dense table): every frame forms K
stay candidates and K x C extension candidates (C = V - 1 non-blank chars,
or the frame's top-A chars), absorbs an extension whose prefix equals a live
stay (rolling-hash match), keeps the K best by fused score, and rebuilds the
token buffers.  Parity traps, each of which decides token equality with the
JAX package and with the kernel:

* hashes are int32 and wrap mod 2^32: computed in int64, masked to 32 bits
  and reinterpreted (``_wrap32``), so the cmat test ``1 <= h_k' - M h_k <= nb``
  sees JAX's wrapped values;
* the next LM context is a floored mod (``torch.remainder``, as JAX's ``%``);
* ties in the top-K and the top-A go to the lower index (``lax.top_k``);
  ``torch.topk`` promises no order on ties, so both select with a stable
  descending sort;
* the fusion term is ``lm_s + (alpha * row + beta)``, two roundings inside
  the bracket (the JAX kernels' order; the JAX restricted scan adds
  ``(lm_s + alpha * row) + beta``, one rounding apart);
* log-sum-exp is ``torch.logaddexp`` with the finite sentinel NEG_INF.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1.0e30
HASH_MULT = 1000003


class BeamState(NamedTuple):
    tokens: torch.Tensor   # (B, K, L) int32
    length: torch.Tensor   # (B, K) int32
    pb: torch.Tensor       # (B, K) f32 log P(prefix, ends blank)
    pnb: torch.Tensor      # (B, K) f32 log P(prefix, ends non-blank)
    lm_s: torch.Tensor     # (B, K) f32 accumulated fusion score
    hash: torch.Tensor     # (B, K) int32 rolling prefix hash
    ctx: torch.Tensor      # (B, K) int32 LM context id
    last: torch.Tensor     # (B, K) int32 last char (-1 for empty)


def _lse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(a, b)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound (JAX's int32 overflow)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def _init_state(B: int, K: int, L: int, device) -> BeamState:
    k = torch.arange(K, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return BeamState(
        tokens=torch.zeros((B, K, L), **i32),
        length=torch.zeros((B, K), **i32),
        pb=torch.where(k == 0, 0.0, NEG_INF).expand(B, K).contiguous(),
        pnb=torch.full((B, K), NEG_INF, device=device),
        lm_s=torch.zeros((B, K), device=device),
        hash=(-(k + 1)).to(torch.int32).expand(B, K).contiguous(),
        ctx=torch.zeros((B, K), **i32),
        last=torch.full((B, K), -1, **i32),
    )


def _stay_candidates(state: BeamState, logp_t: torch.Tensor, blank: int, K: int):
    """(total, stay dict): each beam continued without appending."""
    B = logp_t.shape[0]
    total = _lse(state.pb, state.pnb)                                  # (B, K)
    lp_last = torch.gather(logp_t, 1, state.last.clamp(min=0).long())  # (B, K)
    stay = {
        "pb": total + logp_t[:, blank, None],
        "pnb": torch.where(state.last >= 0, state.pnb + lp_last, NEG_INF),
        "lm": state.lm_s, "hash": state.hash, "ctx": state.ctx, "last": state.last,
        "parent": torch.arange(K, dtype=torch.int32, device=logp_t.device).expand(B, K),
        "append": torch.full((B, K), -1, dtype=torch.int32, device=logp_t.device),
    }
    return total, stay


def _ext_ctx(state: BeamState, chars_bc: torch.Tensor, vocab: int, lm_table):
    """Per-extension LM context: the dense roll ``(ctx * V + c) mod n_ctx``
    (floored, in wrapped int32) with a table, else carried unchanged."""
    if lm_table is None:
        return state.ctx[..., None].expand(chars_bc.shape)
    raw = _wrap32(state.ctx.long()[..., None] * vocab + chars_bc.long())
    return torch.remainder(raw, lm_table.shape[0]).to(torch.int32)


def _ext_fields(state: BeamState, chars, ext_pnb, lm_rows, vocab, lm_table, lm_alpha,
                lm_beta, K):
    if lm_table is not None:
        ext_lm = state.lm_s[..., None] + (lm_alpha * lm_rows + lm_beta)
    else:
        ext_lm = state.lm_s[..., None].expand(ext_pnb.shape)
    return {
        "pnb": ext_pnb, "lm": ext_lm,
        "hash": _wrap32(state.hash.long()[..., None] * HASH_MULT + chars.long()),
        "ctx": _ext_ctx(state, chars, vocab, lm_table), "last": chars, "chars": chars,
        "parent": torch.arange(K, dtype=torch.int32, device=chars.device)[None, :, None]
        .expand(chars.shape),
        "append": chars,
    }


def _build_candidates(state: BeamState, logp_t, *, blank, vocab, lm_table, lm_alpha,
                      lm_beta, K, L):
    """Stay (B, K) and extension (B, K, V-1) candidates: each beam extended by
    each non-blank char 1..V-1."""
    B = logp_t.shape[0]
    total, stay = _stay_candidates(state, logp_t, blank, K)
    chars = torch.arange(1, vocab, dtype=torch.int32, device=logp_t.device).expand(
        B, K, vocab - 1)
    is_repeat = chars == state.last[..., None]
    base = torch.where(is_repeat, state.pb[..., None], total[..., None])
    ext_pnb = base + logp_t[:, None, 1:]
    ext_pnb = torch.where((state.length >= L)[..., None], NEG_INF, ext_pnb)
    rows = lm_table[state.ctx.long()][..., 1:] if lm_table is not None else None
    return stay, _ext_fields(state, chars, ext_pnb, rows, vocab, lm_table, lm_alpha, lm_beta,
                             K)


def _build_candidates_topa(state: BeamState, logp_t, top_val_t, top_idx_t, *, blank,
                           vocab, lm_table, lm_alpha, lm_beta, K, L):
    """Extension candidates restricted to the frame's top-A chars (B, K, A);
    merge with ``_merge_topk(..., sparse=True)``."""
    B, A = top_idx_t.shape
    total, stay = _stay_candidates(state, logp_t, blank, K)
    chars = top_idx_t[:, None, :].expand(B, K, A)
    is_repeat = chars == state.last[..., None]
    base = torch.where(is_repeat, state.pb[..., None], total[..., None])
    ext_pnb = base + top_val_t[:, None, :]
    ext_pnb = torch.where((state.length >= L)[..., None], NEG_INF, ext_pnb)
    ext_pnb = torch.where(chars == blank, NEG_INF, ext_pnb)
    rows = None
    if lm_table is not None:
        rows = torch.gather(lm_table[state.ctx.long()], 2, chars.long())
    return stay, _ext_fields(state, chars, ext_pnb, rows, vocab, lm_table, lm_alpha, lm_beta,
                             K)


def _absorb_add(em: torch.Tensor, dims: tuple[int, ...]) -> torch.Tensor:
    """(B, Ks) log of the summed mass of the matched entries of ``em``
    (NEG_INF where unmatched), reduced over the middle ``dims``."""
    m = em.amax(dim=dims)
    floor = torch.clamp(m, min=NEG_INF).reshape(m.shape[0], *([1] * len(dims)), m.shape[1])
    s = torch.exp(em - floor).sum(dim=dims)
    return torch.where(m > NEG_INF / 2, m + torch.log(s), NEG_INF)


def _merge_topk(stay: dict, ext: dict, K: int, sparse: bool = False):
    """Absorb duplicate prefixes, keep the top K.  Returns (score, fields).

    Live beams have distinct hashes, so the only duplicates are an
    extension (k, c) whose prefix equals stay k' (h_k' == h_k * M + c).  The
    full-vocab path finds them through ``cmat = h_k' - M h_k`` (the char
    that would turn beam k into beam k'); the restricted path by direct hash
    equality against the stays.
    """
    B, Ks = stay["hash"].shape
    nb = ext["pnb"].shape[2]
    alive = _lse(stay["pb"], stay["pnb"]) > NEG_INF / 2                  # (B, Ks)
    if sparse:
        m4 = ((ext["hash"][..., None] == stay["hash"][:, None, None, :])
              & alive[:, None, None, :] & (ext["chars"][..., None] >= 1))  # (B, Kc, A, Ks)
        add = _absorb_add(torch.where(m4, ext["pnb"][..., None], NEG_INF), (1, 2))
        absorbed = m4.any(dim=3)                                         # (B, Kc, A)
    else:
        cmat = _wrap32(stay["hash"].long()[:, None, :]
                       - HASH_MULT * stay["hash"].long()[:, :, None])    # (B, Kc, Ks)
        match = (cmat >= 1) & (cmat <= nb) & alive[:, None, :]
        col = (cmat - 1).clamp(0, nb - 1).long()
        em = torch.where(match, torch.gather(ext["pnb"], 2, col), NEG_INF)
        add = _absorb_add(em, (1,))
        hit = match[..., None] & torch.nn.functional.one_hot(col, nb).bool()
        absorbed = hit.any(dim=2)                                        # (B, Kc, nb)
    stay_pnb = _lse(stay["pnb"], add)

    stay_score = _lse(stay["pb"], stay_pnb) + stay["lm"]
    ext_score = torch.where(absorbed, NEG_INF, ext["pnb"] + ext["lm"])

    def flat(s, e):
        return torch.cat([s, e.reshape(B, -1)], dim=1)

    score, order = torch.sort(flat(stay_score, ext_score), dim=1, descending=True,
                              stable=True)
    top_score, top_idx = score[:, :K], order[:, :K]

    def take(s, e):
        return torch.gather(flat(s, e), 1, top_idx)

    dead = top_score <= NEG_INF / 2
    sentinel = -(torch.arange(K, dtype=torch.int32, device=top_idx.device) + 1)
    fields = {
        # Dead fillers carry no mass: a dead filler may share a live beam's
        # hash, and keeping its fields would double-count that prefix.
        "pb": torch.where(dead, NEG_INF,
                          take(stay["pb"], torch.full_like(ext["pnb"], NEG_INF))),
        "pnb": torch.where(dead, NEG_INF, take(stay_pnb, ext["pnb"])),
        "lm": take(stay["lm"], ext["lm"]),
        "hash": torch.where(dead, sentinel, take(stay["hash"], ext["hash"])),
        "ctx": take(stay["ctx"], ext["ctx"]),
        "last": take(stay["last"], ext["last"]),
        "parent": take(stay["parent"], ext["parent"]),
        "append": take(stay["append"], ext["append"]),
    }
    return top_score, fields


def _apply_tokens(tokens, length, parent, append, L: int):
    """Rebuild token buffers and lengths after a merge step."""
    B, K = parent.shape
    parent_tokens = torch.gather(tokens, 1, parent.long()[..., None].expand(B, K, L))
    parent_len = torch.gather(length, 1, parent.long())
    pos = torch.arange(L, device=tokens.device)[None, None, :] == parent_len[..., None]
    ext = append >= 0
    new_tokens = torch.where(pos & ext[..., None], append[..., None], parent_tokens)
    return new_tokens, parent_len + ext.to(torch.int32)


def _step(state: BeamState, logp_t, active, top_val_t=None, top_idx_t=None, *, blank,
          vocab, lm_table, lm_alpha, lm_beta, K, L) -> BeamState:
    kw = dict(blank=blank, vocab=vocab, lm_table=lm_table, lm_alpha=lm_alpha,
              lm_beta=lm_beta, K=K, L=L)
    if top_idx_t is not None:
        stay, ext = _build_candidates_topa(state, logp_t, top_val_t, top_idx_t, **kw)
        _, f = _merge_topk(stay, ext, K, sparse=True)
    else:
        stay, ext = _build_candidates(state, logp_t, **kw)
        _, f = _merge_topk(stay, ext, K)
    return _finish_step(state, f, active, L)


def _finish_step(state: BeamState, f: dict, active, L: int) -> BeamState:
    """Token rebuild and freeze of rows past their length."""
    tokens, length = _apply_tokens(state.tokens, state.length, f["parent"], f["append"], L)
    new = BeamState(tokens=tokens, length=length, pb=f["pb"], pnb=f["pnb"], lm_s=f["lm"],
                    hash=f["hash"], ctx=f["ctx"], last=f["last"])
    return BeamState(*(torch.where(active.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)
                       for n, o in zip(new, state)))


def top_a(logp: torch.Tensor, A: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each frame's A best chars (values f32, ids int32), ties to the lower id."""
    vals, ids = torch.sort(logp, dim=-1, descending=True, stable=True)
    return vals[..., :A].contiguous(), ids[..., :A].to(torch.int32).contiguous()


def beam_scan_plain(logp: torch.Tensor, logit_len: torch.Tensor, beam_size: int,
                    max_len: int, lm_table: torch.Tensor | None = None,
                    lm_alpha: float = 0.0, lm_beta: float = 0.0,
                    top_val: torch.Tensor | None = None, top_idx: torch.Tensor | None = None,
                    blank: int = 0):
    """The plain search over log-probs ``logp`` (B, T, V) float32, frame by
    frame: the function the kernel computes.  ``top_val``/``top_idx``
    (B, T, A) restrict the extensions to each frame's top-A chars.  Returns
    (tokens (B, L) int32, lengths (B,) int32, scores (B,) f32) of the best
    beam of each row."""
    B, T, V = logp.shape
    K, L = beam_size, max_len
    state = _init_state(B, K, L, logp.device)
    kw = dict(blank=blank, vocab=V, lm_table=lm_table, lm_alpha=lm_alpha, lm_beta=lm_beta,
              K=K, L=L)
    for t in range(T):
        top = (top_val[:, t], top_idx[:, t]) if top_idx is not None else (None, None)
        state = _step(state, logp[:, t], t < logit_len, *top, **kw)
    final = _lse(state.pb, state.pnb) + state.lm_s
    best = torch.argmax(final, dim=1, keepdim=True)                     # first max
    tokens = torch.gather(state.tokens, 1, best[..., None].expand(B, 1, L))[:, 0]
    return (tokens, torch.gather(state.length, 1, best)[:, 0],
            torch.gather(final, 1, best)[:, 0])


def _check_sources(blank, hash_lm, rnn_lm, lm_top_k):
    if hash_lm is not None:
        raise NotImplementedError("hashed n-gram fusion (decoding/lm_hashed.py) is not "
                                  "ported yet: it waits for the LM-extras slice")
    if rnn_lm is not None:
        raise NotImplementedError("RNN-LM fusion (the K9 kernel) is not ported yet: it "
                                  "waits for the LM-extras slice")
    if lm_top_k:
        raise NotImplementedError("lm_top_k (acoustic-pruned hashed fusion) is not ported "
                                  "yet: it waits for the LM-extras slice")
    if blank != 0:
        raise ValueError("the search extends with chars 1..V-1 and treats id 0 as "
                         f"blank, as the JAX package's does; got blank={blank}")


def _prepare(logits, ext_top_a):
    logp = torch.log_softmax(logits.float(), dim=-1).contiguous()
    A = ext_top_a if 0 < ext_top_a < logp.shape[-1] else 0
    return logp, (top_a(logp, A) if A else (None, None))


def prefix_beam_search(logits: torch.Tensor, logit_len: torch.Tensor, beam_size: int = 16,
                       blank: int = 0, lm_table: torch.Tensor | None = None,
                       lm_alpha: float = 0.0, lm_beta: float = 0.0, max_len: int = 256,
                       ext_top_a: int = 0, hash_lm=None, rnn_lm=None, lm_top_k: int = 0):
    """(tokens (B, L), lengths (B,), scores (B,)) of the best beam of each row.

    On CUDA tensors the kernel runs the search: K7 over all chars, K8 over
    each frame's top-A chars when ``0 < ext_top_a < V`` (``ext_top_a >= V``
    is the unrestricted search); on CPU tensors the plain search does.
    ``lm_table`` (n_ctx, V) float32 adds dense n-gram shallow fusion.
    """
    _check_sources(blank, hash_lm, rnn_lm, lm_top_k)
    from pytorch_asr_tpu_torch.ops import beam_cuda

    logp, (top_val, top_idx) = _prepare(logits, ext_top_a)
    return beam_cuda.prefix_beam(logp, logit_len.to(torch.int32).contiguous(), beam_size,
                                 max_len, lm_table, lm_alpha, lm_beta, top_val, top_idx)


def prefix_beam_search_plain(logits: torch.Tensor, logit_len: torch.Tensor,
                             beam_size: int = 16, blank: int = 0,
                             lm_table: torch.Tensor | None = None, lm_alpha: float = 0.0,
                             lm_beta: float = 0.0, max_len: int = 256, ext_top_a: int = 0):
    """``prefix_beam_search`` through the plain search on any device."""
    _check_sources(blank, None, None, 0)
    logp, (top_val, top_idx) = _prepare(logits, ext_top_a)
    return beam_scan_plain(logp, logit_len, beam_size, max_len, lm_table, lm_alpha, lm_beta,
                           top_val, top_idx)
