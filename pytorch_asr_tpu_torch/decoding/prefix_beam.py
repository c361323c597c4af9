"""CTC prefix beam search with shallow fusion of a dense n-gram table, a
hashed n-gram LM or a char RNN LM: the port's counterpart of
``pytorch_asr_tpu.decoding.prefix_beam``.

``prefix_beam_search`` is the entry point.  It log-softmaxes the logits (and,
for ``ext_top_a``, takes each frame's top-A chars; for ``lm_top_k`` over a
hashed LM, each frame's top-k) and hands them to ``ops/beam_cuda.py``, whose
kernels (``csrc/prefix_beam.cu``: K7/K8 with no LM, a dense table or the
hashed tables, and K9 with the RNN LM) run the whole search on the card: K9 on
a co-resident grid where ``beam_cuda.rnn_grid_route`` finds its shapes fit,
else a block an utterance; a block's working set in shared memory where it
fits (``beam_cuda.fits``) and in a device scratch past it.  On CPU tensors the
wrappers run ``beam_scan_plain`` below instead.
``prefix_beam_search_plain`` is that plain search from the logits, on either
device; the tests and ``chip_smoke.py`` hold the kernels against it.

The plain search is a PyTorch port of the JAX package's ``lax.scan`` with
every fusion source (none, a dense table, the hashed tables of
``decoding/lm_hashed.py`` or the RNN LM): every frame forms K stay candidates
and K x C extension candidates (C = V - 1 non-blank chars, or the frame's
top-A chars), absorbs an extension whose prefix equals a live stay
(rolling-hash match), keeps the K best by fused score, and rebuilds the token
buffers.  With the RNN LM each beam carries the LM's state (``LMCarry``): its
log-prob row scores the extensions, and after the merge the state follows the
parent and steps once where the beam appended.  With the hashed LM each beam's
context is a window of its last order - 1 ids (``BeamState.ctx`` (B, K, order
- 1), 0 = no history), rolled where the beam appends; its rows are
``lm_hashed.hashed_lm_logp_rows`` of the window, exact over all chars, over
the frame's top-A, or with ``lm_top_k`` exact over the frame's top k chars and
``hashed_lm_allmiss_rows`` elsewhere.  Parity traps, each of which decides
token equality with the JAX package and with the kernels:

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
* log-sum-exp is ``torch.logaddexp`` with the finite sentinel NEG_INF;
* the RNN LM steps every beam with ``max(append, 0)`` but keeps the stepped
  state only where the beam appended, and rows past their length keep theirs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pytorch_asr_tpu_torch.decoding.lm_hashed import (
    HashedNgramLM,
    hashed_lm_allmiss_rows,
    hashed_lm_logp_rows,
)
from pytorch_asr_tpu_torch.models.lm_rnn import CharRNNLM, LMState, lm_step_logp

NEG_INF = -1.0e30
HASH_MULT = 1000003


class BeamState(NamedTuple):
    tokens: torch.Tensor   # (B, K, L) int32
    length: torch.Tensor   # (B, K) int32
    pb: torch.Tensor       # (B, K) f32 log P(prefix, ends blank)
    pnb: torch.Tensor      # (B, K) f32 log P(prefix, ends non-blank)
    lm_s: torch.Tensor     # (B, K) f32 accumulated fusion score
    hash: torch.Tensor     # (B, K) int32 rolling prefix hash
    ctx: torch.Tensor      # (B, K) int32 dense-table context id, or the hashed
                           # LM's window (B, K, order - 1) int32
    last: torch.Tensor     # (B, K) int32 last char (-1 for empty)


def _lse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(a, b)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound (JAX's int32 overflow)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def _init_state(B: int, K: int, L: int, device, ctx_width: int = 0) -> BeamState:
    """Beam 0 the empty prefix, the rest dead; ``ctx_width`` > 0: the hashed
    LM's context windows of that width (0 = no history)."""
    k = torch.arange(K, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return BeamState(
        tokens=torch.zeros((B, K, L), **i32),
        length=torch.zeros((B, K), **i32),
        pb=torch.where(k == 0, 0.0, NEG_INF).expand(B, K).contiguous(),
        pnb=torch.full((B, K), NEG_INF, device=device),
        lm_s=torch.zeros((B, K), device=device),
        hash=(-(k + 1)).to(torch.int32).expand(B, K).contiguous(),
        ctx=torch.zeros((B, K, ctx_width) if ctx_width else (B, K), **i32),
        last=torch.full((B, K), -1, **i32),
    )


def _stay_candidates(state: BeamState, logp_t: torch.Tensor, blank: int, K: int,
                     parent_offset: int = 0):
    """(total, stay dict): each beam continued without appending.  Beam k's
    parent id is ``parent_offset + k``: a beam shard's global ids."""
    B = logp_t.shape[0]
    total = _lse(state.pb, state.pnb)                                  # (B, K)
    lp_last = torch.gather(logp_t, 1, state.last.clamp(min=0).long())  # (B, K)
    stay = {
        "pb": total + logp_t[:, blank, None],
        "pnb": torch.where(state.last >= 0, state.pnb + lp_last, NEG_INF),
        "lm": state.lm_s, "hash": state.hash, "ctx": state.ctx, "last": state.last,
        "parent": (torch.arange(K, dtype=torch.int32, device=logp_t.device)
                   + parent_offset).expand(B, K),
        "append": torch.full((B, K), -1, dtype=torch.int32, device=logp_t.device),
    }
    return total, stay


def _ext_ctx(state: BeamState, chars_bc: torch.Tensor, vocab: int, lm_table):
    """Per-extension LM context: the hashed LM's window shifted by c ((B, K,
    N, C) from (B, K, C)), the dense roll ``(ctx * V + c) mod n_ctx``
    (floored, in wrapped int32) with a table, else carried unchanged."""
    if state.ctx.dim() == 3:
        B, K, N = chars_bc.shape
        base = state.ctx[:, :, None, 1:].expand(B, K, N, state.ctx.shape[-1] - 1)
        return torch.cat([base, chars_bc[..., None].to(torch.int32)], dim=-1)
    if lm_table is None:
        return state.ctx[..., None].expand(chars_bc.shape)
    raw = _wrap32(state.ctx.long()[..., None] * vocab + chars_bc.long())
    return torch.remainder(raw, lm_table.shape[0]).to(torch.int32)


def _ext_fields(state: BeamState, chars, ext_pnb, lm_rows, vocab, lm_table, lm_alpha,
                lm_beta, K, parent_offset: int = 0):
    if lm_rows is not None:
        ext_lm = state.lm_s[..., None] + (lm_alpha * lm_rows + lm_beta)
    else:
        ext_lm = state.lm_s[..., None].expand(ext_pnb.shape)
    return {
        "pnb": ext_pnb, "lm": ext_lm,
        "hash": _wrap32(state.hash.long()[..., None] * HASH_MULT + chars.long()),
        "ctx": _ext_ctx(state, chars, vocab, lm_table), "last": chars, "chars": chars,
        "parent": (torch.arange(K, dtype=torch.int32, device=chars.device)
                   + parent_offset)[None, :, None].expand(chars.shape),
        "append": chars,
    }


def _build_candidates(state: BeamState, logp_t, *, blank, vocab, lm_table, lm_rows, lm_alpha,
                      lm_beta, K, L, parent_offset: int = 0):
    """Stay (B, K) and extension (B, K, V-1) candidates: each beam extended by
    each non-blank char 1..V-1.  ``lm_rows`` (B, K, V) are the beams' LM
    log-prob rows (a dense table's rows or the RNN LM's carry), or None.
    ``parent_offset`` is the global id of beam 0 when ``state`` holds one
    beam shard's K beams."""
    B = logp_t.shape[0]
    total, stay = _stay_candidates(state, logp_t, blank, K, parent_offset)
    chars = torch.arange(1, vocab, dtype=torch.int32, device=logp_t.device).expand(
        B, K, vocab - 1)
    is_repeat = chars == state.last[..., None]
    base = torch.where(is_repeat, state.pb[..., None], total[..., None])
    ext_pnb = base + logp_t[:, None, 1:]
    ext_pnb = torch.where((state.length >= L)[..., None], NEG_INF, ext_pnb)
    rows = lm_rows[..., 1:] if lm_rows is not None else None
    return stay, _ext_fields(state, chars, ext_pnb, rows, vocab, lm_table, lm_alpha, lm_beta,
                             K, parent_offset)


def _build_candidates_topa(state: BeamState, logp_t, top_val_t, top_idx_t, *, blank,
                           vocab, lm_table, lm_rows, lm_alpha, lm_beta, K, L, hash_lm=None):
    """Extension candidates restricted to the frame's top-A chars (B, K, A);
    merge with ``_merge_topk(..., sparse=True)``.  With ``hash_lm`` each
    candidate's row entry is the hashed LM's exact score of its char."""
    B, A = top_idx_t.shape
    total, stay = _stay_candidates(state, logp_t, blank, K)
    chars = top_idx_t[:, None, :].expand(B, K, A)
    is_repeat = chars == state.last[..., None]
    base = torch.where(is_repeat, state.pb[..., None], total[..., None])
    ext_pnb = base + top_val_t[:, None, :]
    ext_pnb = torch.where((state.length >= L)[..., None], NEG_INF, ext_pnb)
    ext_pnb = torch.where(chars == blank, NEG_INF, ext_pnb)
    if hash_lm is not None:
        rows = hashed_lm_logp_rows(hash_lm, state.ctx, cands=chars)
    else:
        rows = torch.gather(lm_rows, 2, chars.long()) if lm_rows is not None else None
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
        if s.dim() == 3:      # the hashed LM's windows, (B, Ks, C) and (B, Kc, nb, C)
            cat = torch.cat([s, e.reshape(B, -1, s.shape[-1])], dim=1)
            return torch.gather(cat, 1, top_idx[..., None].expand(B, K, s.shape[-1]))
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


class LMCarry(NamedTuple):
    """Each beam's char RNN LM state, carried beside ``BeamState``."""
    h: torch.Tensor      # (layers, B, K, H) f32
    c: torch.Tensor      # (layers, B, K, H) f32
    logp: torch.Tensor   # (B, K, V) f32 log P(next char | prefix)


@torch.no_grad()
def primed_lm_state(rnn_lm: CharRNNLM, sos_id: int):
    """The LM state after ``<sos>`` from zeros, one row for all beams:
    (h0 (layers, H), c0 (layers, H), lmp0 (V,)) float32."""
    device = rnn_lm.embed.device
    logp, st = lm_step_logp(rnn_lm, torch.full((1,), sos_id, device=device),
                            rnn_lm.init_state(1))
    return st.h[:, 0].contiguous(), st.c[:, 0].contiguous(), logp[0].contiguous()


def rnn_lm_carry_init(rnn_lm: CharRNNLM, B: int, K: int, sos_id: int) -> LMCarry:
    """Every beam's carry primed with ``<sos>`` (the JAX package's
    ``rnn_lm_carry_init``)."""
    return _carry(*primed_lm_state(rnn_lm, sos_id), B, K)


def _carry(h0, c0, lmp0, B: int, K: int) -> LMCarry:
    nl, H = h0.shape
    return LMCarry(h=h0[:, None, None].expand(nl, B, K, H).contiguous(),
                   c=c0[:, None, None].expand(nl, B, K, H).contiguous(),
                   logp=lmp0.expand(B, K, lmp0.shape[0]).contiguous())


def _step_lm(rnn_lm: CharRNNLM, carry: LMCarry, parent, append) -> LMCarry:
    """The LM state of the new beams (B, Kn) whose ``parent`` ids index
    ``carry``'s beams: each takes its parent's state (an index gather: JAX's
    one-hot einsum is exact, so the two agree bit for bit), every beam steps
    with ``max(append, 0)``, and the stepped state is kept where the beam
    appended."""
    nl, B, _, H = carry.h.shape
    Kn = parent.shape[1]
    b, p = torch.arange(B, device=parent.device)[:, None], parent.long()
    g = LMCarry(h=carry.h[:, b, p], c=carry.c[:, b, p], logp=carry.logp[b, p])
    logp, st = lm_step_logp(rnn_lm, append.clamp(min=0).reshape(B * Kn),
                            LMState(g.h.reshape(nl, B * Kn, H), g.c.reshape(nl, B * Kn, H)))
    ext = append >= 0
    return LMCarry(h=torch.where(ext[None, ..., None], st.h.reshape(nl, B, Kn, H), g.h),
                   c=torch.where(ext[None, ..., None], st.c.reshape(nl, B, Kn, H), g.c),
                   logp=torch.where(ext[..., None], logp.reshape(B, Kn, -1), g.logp))


def _freeze_lm(new: LMCarry, carry: LMCarry, active) -> LMCarry:
    """``new`` on rows inside their length, ``carry`` on the rest."""
    act = active.reshape(-1, 1, 1)
    return LMCarry(h=torch.where(act[None], new.h, carry.h),
                   c=torch.where(act[None], new.c, carry.c),
                   logp=torch.where(act, new.logp, carry.logp))


def _advance_lm(rnn_lm: CharRNNLM, carry: LMCarry, parent, append, active) -> LMCarry:
    """Every beam's LM state after a merge (``_step_lm``); rows past their
    length keep theirs."""
    return _freeze_lm(_step_lm(rnn_lm, carry, parent, append), carry, active)


def hashed_rows(hash_lm, ctx: torch.Tensor, exact_t: torch.Tensor | None = None):
    """The hashed LM's rows (B, K, V) of the windows ``ctx`` (B, K, C): exact
    over every char, or with ``exact_t`` (B, k) a frame's top-k chars
    (``lm_top_k``) exact over those and the all-miss rows elsewhere."""
    if exact_t is None:
        return hashed_lm_logp_rows(hash_lm, ctx)
    B, K = ctx.shape[:2]
    cands = exact_t[:, None, :].expand(B, K, exact_t.shape[-1]).long()
    return torch.scatter(hashed_lm_allmiss_rows(hash_lm, ctx), 2, cands,
                         hashed_lm_logp_rows(hash_lm, ctx, cands=cands))


def _step(state: BeamState, logp_t, active, top_val_t=None, top_idx_t=None, *, blank,
          vocab, lm_table, lm_alpha, lm_beta, K, L, rnn_lm=None, carry=None, hash_lm=None,
          exact_t=None):
    """One frame: (new BeamState, new LMCarry or None).  ``exact_t`` (B, k):
    the frame's top-k chars of ``lm_top_k`` (full search with a hashed LM)."""
    if lm_table is not None:
        lm_rows = lm_table[state.ctx.long()]
    elif hash_lm is not None and top_idx_t is None:
        lm_rows = hashed_rows(hash_lm, state.ctx, exact_t)
    else:
        lm_rows = carry.logp if carry is not None else None
    kw = dict(blank=blank, vocab=vocab, lm_table=lm_table, lm_rows=lm_rows,
              lm_alpha=lm_alpha, lm_beta=lm_beta, K=K, L=L)
    if top_idx_t is not None:
        stay, ext = _build_candidates_topa(state, logp_t, top_val_t, top_idx_t,
                                           hash_lm=hash_lm, **kw)
        _, f = _merge_topk(stay, ext, K, sparse=True)
    else:
        stay, ext = _build_candidates(state, logp_t, **kw)
        _, f = _merge_topk(stay, ext, K)
    if carry is not None:
        carry = _advance_lm(rnn_lm, carry, f["parent"], f["append"], active)
    return _finish_step(state, f, active, L), carry


def _finish_step(state: BeamState, f: dict, active, L: int) -> BeamState:
    """Token rebuild and freeze of rows past their length."""
    tokens, length = _apply_tokens(state.tokens, state.length, f["parent"], f["append"], L)
    new = BeamState(tokens=tokens, length=length, pb=f["pb"], pnb=f["pnb"], lm_s=f["lm"],
                    hash=f["hash"], ctx=f["ctx"], last=f["last"])
    return BeamState(*(torch.where(active.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)
                       for n, o in zip(new, state)))


def stepwise_frame_plain(fields: dict, logp_t: torch.Tensor, active: torch.Tensor,
                         max_len: int) -> dict:
    """One frame of the search with no LM on the state ``fields``, (B, K)
    pb, pnb, hash, last and length: ``_step``'s candidates and merge and
    ``_finish_step``'s freeze, plus the frame's pointers parent and append
    (the identity and -1 on rows past their length).  One frame of K12
    (``ops/beam_cuda.py::prefix_beam_lanes_stepwise``)."""
    B, K = fields["pb"].shape
    zeros = torch.zeros((B, K), dtype=torch.int32, device=logp_t.device)
    state = BeamState(tokens=torch.zeros((B, K, max_len), dtype=torch.int32,
                                         device=logp_t.device),
                      length=fields["length"], pb=fields["pb"], pnb=fields["pnb"],
                      lm_s=torch.zeros_like(fields["pb"]), hash=fields["hash"], ctx=zeros,
                      last=fields["last"])
    stay, ext = _build_candidates(state, logp_t, blank=0, vocab=logp_t.shape[1], lm_table=None,
                                  lm_rows=None, lm_alpha=0.0, lm_beta=0.0, K=K, L=max_len)
    _, f = _merge_topk(stay, ext, K)
    new = _finish_step(state, f, active, max_len)
    keep = active[:, None]
    return {"pb": new.pb, "pnb": new.pnb, "hash": new.hash, "last": new.last,
            "length": new.length,
            "parent": torch.where(keep, f["parent"], torch.arange(K, dtype=torch.int32,
                                                                  device=logp_t.device)),
            "append": torch.where(keep, f["append"], -1)}


def prefix_beam_stepwise_plain(logp: torch.Tensor, lens: torch.Tensor, K: int,
                               L: int) -> dict:
    """``stepwise_frame_plain`` over every frame of ``logp`` (B, T, V) from
    the initial beams: the state after the last frame ((B, K) pb, pnb, hash,
    last, length) and each frame's pointers ((B, T, K) parent, append), what
    K12 leaves in its scratch."""
    B, T, _ = logp.shape
    k = torch.arange(K, device=logp.device)
    fields = {"pb": torch.where(k == 0, 0.0, NEG_INF).expand(B, K).contiguous(),
              "pnb": torch.full((B, K), NEG_INF, device=logp.device),
              "hash": (-(k + 1)).to(torch.int32).expand(B, K).contiguous(),
              "last": torch.full((B, K), -1, dtype=torch.int32, device=logp.device),
              "length": torch.zeros((B, K), dtype=torch.int32, device=logp.device)}
    parents, appends = [], []
    for t in range(T):
        fields = stepwise_frame_plain(fields, logp[:, t], t < lens, L)
        parents.append(fields.pop("parent"))
        appends.append(fields.pop("append"))
    empty = torch.empty((B, 0, K), dtype=torch.int32, device=logp.device)
    return {**fields, "parent": torch.stack(parents, 1) if T else empty,
            "append": torch.stack(appends, 1) if T else empty}


def top_a(logp: torch.Tensor, A: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each frame's A best chars (values f32, ids int32), ties to the lower id."""
    vals, ids = torch.sort(logp, dim=-1, descending=True, stable=True)
    return vals[..., :A].contiguous(), ids[..., :A].to(torch.int32).contiguous()


@torch.no_grad()
def beam_scan_plain(logp: torch.Tensor, logit_len: torch.Tensor, beam_size: int,
                    max_len: int, lm_table: torch.Tensor | None = None,
                    lm_alpha: float = 0.0, lm_beta: float = 0.0,
                    top_val: torch.Tensor | None = None, top_idx: torch.Tensor | None = None,
                    blank: int = 0, rnn_lm: CharRNNLM | None = None, lm_state=None,
                    hash_lm: HashedNgramLM | None = None,
                    exact_idx: torch.Tensor | None = None):
    """The plain search over log-probs ``logp`` (B, T, V) float32, frame by
    frame: the function the kernels compute.  ``top_val``/``top_idx``
    (B, T, A) restrict the extensions to each frame's top-A chars.  The
    fusion source is the dense table ``lm_table`` (n_ctx, V), the hashed LM
    ``hash_lm`` (with ``exact_idx`` (B, T, k) each frame's top-k chars of
    ``lm_top_k``), or ``rnn_lm`` started from ``lm_state`` =
    ``primed_lm_state(rnn_lm, sos_id)`` in every beam.  Returns (tokens (B,
    L) int32, lengths (B,) int32, scores (B,) f32) of the best beam of each
    row."""
    B, _, V = logp.shape
    carry = _carry(*lm_state, B, beam_size) if rnn_lm is not None else None
    width = hash_lm.order - 1 if hash_lm is not None else 0
    state, _ = continue_plain(_init_state(B, beam_size, max_len, logp.device, width), logp,
                              logit_len, lm_table, lm_alpha, lm_beta, top_val, top_idx, blank,
                              rnn_lm, carry, hash_lm, exact_idx)
    return beam_best(state)


@torch.no_grad()
def continue_plain(state: BeamState, logp: torch.Tensor, n_valid: torch.Tensor,
                   lm_table: torch.Tensor | None = None, lm_alpha: float = 0.0,
                   lm_beta: float = 0.0, top_val: torch.Tensor | None = None,
                   top_idx: torch.Tensor | None = None, blank: int = 0,
                   rnn_lm: CharRNNLM | None = None, lm_carry: LMCarry | None = None,
                   hash_lm: HashedNgramLM | None = None,
                   exact_idx: torch.Tensor | None = None):
    """The plain search from ``state`` (and, with ``rnn_lm``, each beam's LM
    state ``lm_carry``) over the frames of ``logp`` (B, T, V), row b's first
    ``n_valid[b]``: (BeamState, LMCarry or None) after them.  A chunk of a
    stream (the JAX package's ``prefix_beam_continue`` scan) and the
    function the kernels' carried forms compute; from ``_init_state`` the
    offline search.  With ``hash_lm`` the state's ctx is its (B, K, order -
    1) window."""
    _, T, V = logp.shape
    kw = dict(blank=blank, vocab=V, lm_table=lm_table, lm_alpha=lm_alpha, lm_beta=lm_beta,
              K=state.pb.shape[1], L=state.tokens.shape[2], rnn_lm=rnn_lm, hash_lm=hash_lm)
    for t in range(T):
        top = (top_val[:, t], top_idx[:, t]) if top_idx is not None else (None, None)
        exact = exact_idx[:, t] if exact_idx is not None else None
        state, lm_carry = _step(state, logp[:, t], t < n_valid, *top, carry=lm_carry,
                                exact_t=exact, **kw)
    return state, lm_carry


def beam_best(state: BeamState):
    """(tokens (B, L), lengths (B,), scores (B,)) of each row's best beam,
    the first of equal scores."""
    B, _, L = state.tokens.shape
    final = _lse(state.pb, state.pnb) + state.lm_s
    best = torch.argmax(final, dim=1, keepdim=True)                     # first max
    tokens = torch.gather(state.tokens, 1, best[..., None].expand(B, 1, L))[:, 0]
    return (tokens, torch.gather(state.length, 1, best)[:, 0],
            torch.gather(final, 1, best)[:, 0])


def _check_sources(blank, hash_lm, lm_table, rnn_lm):
    if sum(x is not None for x in (lm_table, hash_lm, rnn_lm)) > 1:
        raise ValueError("give one fusion source: lm_table, hash_lm or rnn_lm, not two")
    if hash_lm is not None and not isinstance(hash_lm, HashedNgramLM):
        raise TypeError("hash_lm must be a decoding.lm_hashed.HashedNgramLM (build_hashed_lm), "
                        f"got {type(hash_lm).__name__}")
    if blank != 0:
        raise ValueError("the search extends with chars 1..V-1 and treats id 0 as "
                         f"blank, as the JAX package's does; got blank={blank}")


def _prepare(logits, ext_top_a):
    logp = torch.log_softmax(logits.float(), dim=-1).contiguous()
    return logp, _tops(logp, ext_top_a)


def _tops(logp: torch.Tensor, ext_top_a: int):
    A = ext_top_a if 0 < ext_top_a < logp.shape[-1] else 0
    return top_a(logp, A) if A else (None, None)


def _exact_idx(logp: torch.Tensor, hash_lm, lm_top_k: int, top_idx) -> torch.Tensor | None:
    """Each frame's top ``lm_top_k`` chars (B, T, k) where they prune a
    hashed LM's lookups: a hashed LM, the search over all chars, and
    0 < lm_top_k < V; else None (``lm_top_k`` then changes nothing)."""
    if hash_lm is None or top_idx is not None or not 0 < lm_top_k < logp.shape[-1]:
        return None
    return top_a(logp, lm_top_k)[1]


def prefix_beam_search(logits: torch.Tensor, logit_len: torch.Tensor, beam_size: int = 16,
                       blank: int = 0, lm_table: torch.Tensor | None = None,
                       lm_alpha: float = 0.0, lm_beta: float = 0.0, max_len: int = 256,
                       ext_top_a: int = 0, hash_lm: HashedNgramLM | None = None,
                       rnn_lm: CharRNNLM | None = None, sos_id: int = 29, lm_top_k: int = 0):
    """(tokens (B, L), lengths (B,), scores (B,)) of the best beam of each row.

    On CUDA tensors a kernel runs the search, over all chars or, when
    ``0 < ext_top_a < V``, over each frame's top-A chars (``ext_top_a >= V``
    is the unrestricted search): K7/K8 without an LM, with the dense
    n-gram table ``lm_table`` (n_ctx, V) float32, or with the hashed n-gram
    LM ``hash_lm`` (``decoding.lm_hashed.HashedNgramLM`` on the card; its
    rows read in the kernel, counted under ``<name>_hashed``); K9 with the char RNN LM
    ``rnn_lm``, primed with ``sos_id`` once outside the kernel and advanced
    inside it, on a co-resident grid where ``ops.beam_cuda.rnn_grid_route``
    finds the shapes fit, else a block an utterance, counted under
    ``<name>_block``.  Where a kernel's block does not fit a block's shared
    memory (``ops.beam_cuda.fits``: beam 387 and up over the char vocab,
    K9's LM step at beam 64 with an LM of H 512, or more than 1024 beams),
    the same kernel runs with its working set in a device scratch, counted
    under ``<name>_wide``, as the wrappers choose from the shapes.  On CPU
    tensors the plain search runs.  ``lm_top_k`` prunes
    only a hashed LM's lookups over all chars, as in the JAX package: the
    frame's top k chars get the exact rows, the rest the all-miss rows
    (unigram plus stacked context backoffs); with ``ext_top_a``, a dense
    table, the RNN LM or no LM it changes nothing.
    """
    _check_sources(blank, hash_lm, lm_table, rnn_lm)
    from pytorch_asr_tpu_torch.ops import beam_cuda

    logp, (top_val, top_idx) = _prepare(logits, ext_top_a)
    lens = logit_len.to(torch.int32).contiguous()
    if rnn_lm is not None:
        return beam_cuda.prefix_beam_rnn(logp, lens, beam_size, max_len, rnn_lm,
                                         *primed_lm_state(rnn_lm, sos_id), lm_alpha, lm_beta,
                                         top_val, top_idx)
    return beam_cuda.prefix_beam(logp, lens, beam_size, max_len, lm_table, lm_alpha, lm_beta,
                                 top_val, top_idx, hash_lm=hash_lm,
                                 exact_idx=_exact_idx(logp, hash_lm, lm_top_k, top_idx))


def prefix_beam_search_plain(logits: torch.Tensor, logit_len: torch.Tensor,
                             beam_size: int = 16, blank: int = 0,
                             lm_table: torch.Tensor | None = None, lm_alpha: float = 0.0,
                             lm_beta: float = 0.0, max_len: int = 256, ext_top_a: int = 0,
                             rnn_lm: CharRNNLM | None = None, sos_id: int = 29,
                             hash_lm: HashedNgramLM | None = None, lm_top_k: int = 0):
    """``prefix_beam_search`` through the plain search on any device."""
    _check_sources(blank, hash_lm, lm_table, rnn_lm)
    logp, (top_val, top_idx) = _prepare(logits, ext_top_a)
    lm_state = primed_lm_state(rnn_lm, sos_id) if rnn_lm is not None else None
    return beam_scan_plain(logp, logit_len, beam_size, max_len, lm_table, lm_alpha, lm_beta,
                           top_val, top_idx, rnn_lm=rnn_lm, lm_state=lm_state, hash_lm=hash_lm,
                           exact_idx=_exact_idx(logp, hash_lm, lm_top_k, top_idx))


# ------------------------------------------------------------- streaming API
def prefix_beam_init(B: int, beam_size: int, max_len: int, device="cpu",
                     ctx_width: int = 0) -> BeamState:
    """Fresh beams for ``prefix_beam_continue``: beam 0 the empty prefix, the
    rest dead (the JAX package's ``prefix_beam_init``).  ``ctx_width``: the
    hashed LM's window width (its order - 1) when streaming with one, else
    0."""
    return _init_state(B, beam_size, max_len, device, ctx_width)


def prefix_beam_continue_best(state: BeamState, logp: torch.Tensor, n_valid: torch.Tensor, *,
                              blank: int = 0, lm_table: torch.Tensor | None = None,
                              lm_alpha: float = 0.0, lm_beta: float = 0.0, hash_lm=None,
                              rnn_lm: CharRNNLM | None = None, lm_carry: LMCarry | None = None,
                              lm_top_k: int = 0, ext_top_a: int = 0):
    """``prefix_beam_continue`` and the best beam after the chunk:
    (BeamState, LMCarry or None, (tokens (B, L), lengths (B,), scores (B,)),
    ``beam_best`` of the new state).  On CUDA tensors one launch of a
    kernel's carried form computes all of it (``ops/beam_cuda.py::
    prefix_beam_carry``, ``prefix_beam_rnn_carry``: K7, K8 over each
    frame's top-A chars where ``0 < ext_top_a < V``, either with the hashed
    LM ``hash_lm`` (the state's ctx its windows, ``prefix_beam_init(...,
    ctx_width=order - 1)``), K9 with ``rnn_lm``); on CPU tensors
    ``continue_plain`` and ``beam_best`` run."""
    _check_sources(blank, hash_lm, lm_table, rnn_lm)
    if (rnn_lm is None) != (lm_carry is None):
        raise ValueError("give rnn_lm and its lm_carry (rnn_lm_carry_init) together")
    width = hash_lm.order - 1 if hash_lm is not None else 0
    if (state.ctx.shape[2:] if state.ctx.dim() == 3 else (0,)) != (width,):
        raise ValueError(f"state.ctx {tuple(state.ctx.shape)}: a hashed LM of order n needs "
                         "(B, K, n - 1) windows (prefix_beam_init(..., ctx_width=n - 1)), "
                         "any other source (B, K)")
    from pytorch_asr_tpu_torch.ops import beam_cuda

    logp = logp.float().contiguous()
    top_val, top_idx = _tops(logp, ext_top_a)
    n_valid = n_valid.to(torch.int32).contiguous()
    if rnn_lm is not None:
        return beam_cuda.prefix_beam_rnn_carry(state, lm_carry, logp, n_valid, rnn_lm, lm_alpha,
                                               lm_beta, top_val, top_idx)
    state, best = beam_cuda.prefix_beam_carry(state, logp, n_valid, lm_table, lm_alpha, lm_beta,
                                              top_val, top_idx, hash_lm=hash_lm,
                                              exact_idx=_exact_idx(logp, hash_lm, lm_top_k,
                                                                   top_idx))
    return state, None, best


def prefix_beam_continue(state: BeamState, logp: torch.Tensor, n_valid: torch.Tensor, *,
                         blank: int = 0, lm_table: torch.Tensor | None = None,
                         lm_alpha: float = 0.0, lm_beta: float = 0.0, hash_lm=None,
                         rnn_lm: CharRNNLM | None = None, lm_carry: LMCarry | None = None,
                         lm_top_k: int = 0, ext_top_a: int = 0):
    """Advances the beams over one chunk of (B, Tc, V) log-softmax frames,
    row b's first ``n_valid[b]`` (later frames are frozen): (new BeamState,
    new LMCarry or None).  Fed an utterance chunk by chunk it gives the
    bits of the offline search over the concatenation, with every fusion
    source: the dense table's context rides ``state.ctx``, the RNN
    LM's (h, c) the ``lm_carry`` (start it with ``rnn_lm_carry_init`` and
    thread it through every chunk).  ``rnn_lm`` is the ``CharRNNLM`` module,
    which holds its weights.  The hashed LM's windows ride ``state.ctx``
    (start it with ``prefix_beam_init(..., ctx_width=order - 1)``);
    ``lm_top_k`` prunes only its lookups over all chars."""
    state, carry, _ = prefix_beam_continue_best(
        state, logp, n_valid, blank=blank, lm_table=lm_table, lm_alpha=lm_alpha, lm_beta=lm_beta,
        hash_lm=hash_lm, rnn_lm=rnn_lm, lm_carry=lm_carry, lm_top_k=lm_top_k,
        ext_top_a=ext_top_a)
    return state, carry
