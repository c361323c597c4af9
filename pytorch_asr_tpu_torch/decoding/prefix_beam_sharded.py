"""Beam-sharded CTC prefix beam search over the mesh's model ranks: the
port's counterpart of ``pytorch_asr_tpu.decoding.prefix_beam_sharded``.

Layout (``parallel/mesh.py``): utterances shard over 'data' (each rank is
handed its rows); each utterance's K beams shard over 'model', K / P beams a
rank.  Every frame each model rank builds the candidates of its own beams
(their dense-table rows, or their RNN-LM carry rows, are its share of the
work; with the hashed LM, its rows of their windows), one all-gather over
the model group assembles the stays (B, K) and extensions (B, K, V-1) of
all shards, and the merge and top-K run
replicated on every rank (K10, ``ops/beam_cuda.py::merge_topk``, on the
card).  Token buffers are replicated and rebuilt alike everywhere, so no
rank ever fetches another's parent state.  With the RNN LM each rank steps
only its K / P new beams, and a second all-gather reassembles the carry.

Parity traps:

* gather order: shard-major, stays [shard 0's K/P | shard 1's | ...] and
  extensions the same, with each candidate's parent id global
  (``parent_offset``).  That is exactly the unsharded order, so with no LM
  or a dense table the search equals ``prefix_beam_search`` bit for bit;
* the RNN LM steps B * K/P rows a frame instead of B * K, so its products
  may block differently: scores agree to rounding;
* the JAX driver passes neither ``ext_top_a`` nor ``lm_top_k`` to this
  search, so it runs over all chars whatever they say, as JAX's does;
* each frame's fields travel as one int32 buffer (floats as their bits),
  one all-gather a frame: under gloo every collective is a host round trip;
  the hashed LM's windows ride it as order - 1 columns a candidate, and K10
  (its window form) copies a pick's columns.
"""

from __future__ import annotations

import torch

from pytorch_asr_tpu_torch.decoding.lm_hashed import hashed_lm_logp_rows
from pytorch_asr_tpu_torch.decoding.prefix_beam import (
    BeamState,
    _build_candidates,
    _check_sources,
    _finish_step,
    _freeze_lm,
    _init_state,
    _step_lm,
    LMCarry,
    beam_best,
    prefix_beam_search,
    rnn_lm_carry_init,
)
from pytorch_asr_tpu_torch.models.lm_rnn import CharRNNLM
from pytorch_asr_tpu_torch.parallel.mesh import Mesh, model_all_gather, use_mesh

_STAY_F32, _STAY_I32 = ("pb", "pnb", "lm"), ("hash", "last", "parent", "append")
_EXT_F32, _EXT_I32 = ("pnb", "lm"), ("hash", "append", "parent")


def _local_slice(state: BeamState, p: int, kl: int) -> BeamState:
    """Model rank p's kl beams; the token buffers stay whole (the candidates
    never read them)."""
    sl = slice(p * kl, (p + 1) * kl)
    return BeamState(tokens=state.tokens, length=state.length[:, sl], pb=state.pb[:, sl],
                     pnb=state.pnb[:, sl], lm_s=state.lm_s[:, sl], hash=state.hash[:, sl],
                     ctx=state.ctx[:, sl], last=state.last[:, sl])


def _exchange(stay: dict, ext: dict, mesh: Mesh) -> tuple[dict, dict]:
    """All model ranks' candidates, shard-major, through one all-gather of
    one int32 buffer (B, kl, 7 + w + (5 + w) (V-1)) a frame, w the context's
    columns (1, or the hashed LM's window width)."""
    B, kl, nb = ext["pnb"].shape
    window = stay["ctx"].dim() == 3
    w = stay["ctx"].shape[-1] if window else 1
    bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x  # noqa: E731
    ns, ne = len(_STAY_F32 + _STAY_I32), len(_EXT_F32 + _EXT_I32)
    packed = torch.cat(
        [torch.stack([bits(stay[k]) for k in _STAY_F32 + _STAY_I32], dim=-1),
         stay["ctx"].reshape(B, kl, w),
         torch.cat([torch.stack([bits(ext[k]) for k in _EXT_F32 + _EXT_I32], dim=-1),
                    ext["ctx"].reshape(B, kl, nb, w)], dim=-1).reshape(B, kl, -1)],
        dim=-1)
    full = model_all_gather(packed, 1, mesh)              # (B, K, ns + w + (ne + w) nb)
    K = full.shape[1]
    s, e = full[..., :ns + w], full[..., ns + w:].reshape(B, K, nb, ne + w)
    out_s = {k: s[..., i].contiguous() for i, k in enumerate(_STAY_F32 + _STAY_I32)}
    out_e = {k: e[..., i].contiguous() for i, k in enumerate(_EXT_F32 + _EXT_I32)}
    out_s["ctx"] = s[..., ns:].contiguous() if window else s[..., ns].contiguous()
    out_e["ctx"] = e[..., ne:].contiguous() if window else e[..., ne].contiguous()
    for d, names in ((out_s, _STAY_F32), (out_e, _EXT_F32)):
        for k in names:
            d[k] = d[k].view(torch.float32)
    out_e["last"] = out_e["chars"] = out_e["append"]
    return out_s, out_e


def _exchange_lm(new: LMCarry, mesh: Mesh) -> LMCarry:
    """The model ranks' stepped LM states reassembled (one all-gather of
    (B, kl, 2 nl H + V) floats)."""
    nl, B, kl, H = new.h.shape
    packed = torch.cat([new.h.permute(1, 2, 0, 3).reshape(B, kl, nl * H),
                        new.c.permute(1, 2, 0, 3).reshape(B, kl, nl * H), new.logp], dim=-1)
    full = model_all_gather(packed, 1, mesh)
    K = full.shape[1]
    unpack = lambda x: x.reshape(B, K, nl, H).permute(2, 0, 1, 3).contiguous()  # noqa: E731
    return LMCarry(h=unpack(full[..., :nl * H]), c=unpack(full[..., nl * H:2 * nl * H]),
                   logp=full[..., 2 * nl * H:].contiguous())


@torch.no_grad()
def prefix_beam_search_sharded(logits: torch.Tensor, logit_len: torch.Tensor, mesh: Mesh,
                               beam_size: int = 16, blank: int = 0,
                               lm_table: torch.Tensor | None = None, lm_alpha: float = 0.0,
                               lm_beta: float = 0.0, max_len: int = 256,
                               rnn_lm: CharRNNLM | None = None, sos_id: int = 29,
                               hash_lm=None):
    """(tokens (B, L), lengths (B,), scores (B,)) of the best beam of each of
    this rank's rows, with the beams sharded over ``mesh``'s model ranks
    (every one of which calls it on the same rows).  The fusion source is
    none, the dense table ``lm_table``, the hashed tables ``hash_lm`` (each
    rank reads the rows of its own beams' windows) or the char RNN LM
    ``rnn_lm``.  One
    model rank: ``prefix_beam_search``.  ``beam_size`` must be a multiple
    of the model axis."""
    P = mesh.model
    if P == 1:
        with use_mesh(mesh):
            return prefix_beam_search(logits, logit_len, beam_size=beam_size, blank=blank,
                                      lm_table=lm_table, lm_alpha=lm_alpha, lm_beta=lm_beta,
                                      max_len=max_len, rnn_lm=rnn_lm, sos_id=sos_id,
                                      hash_lm=hash_lm)
    if beam_size % P != 0:
        raise ValueError(f"beam_size {beam_size} not divisible by model axis {P}")
    _check_sources(blank, hash_lm, lm_table, rnn_lm)
    from pytorch_asr_tpu_torch.ops import beam_cuda

    K, L, kl, p = beam_size, max_len, beam_size // P, mesh.model_index
    B, T, V = logits.shape
    logp = torch.log_softmax(logits.float(), dim=-1)
    state = _init_state(B, K, L, logits.device, hash_lm.order - 1 if hash_lm is not None else 0)
    carry = rnn_lm_carry_init(rnn_lm, B, K, sos_id) if rnn_lm is not None else None
    own = slice(p * kl, (p + 1) * kl)
    for t in range(T):
        local = _local_slice(state, p, kl)
        if lm_table is not None:
            lm_rows = lm_table[local.ctx.long()]
        elif hash_lm is not None:
            lm_rows = hashed_lm_logp_rows(hash_lm, local.ctx)
        else:
            lm_rows = carry.logp[:, own] if carry is not None else None
        stay_l, ext_l = _build_candidates(
            local, logp[:, t], blank=blank, vocab=V, lm_table=lm_table, lm_rows=lm_rows,
            lm_alpha=lm_alpha, lm_beta=lm_beta, K=kl, L=L, parent_offset=p * kl)
        stay, ext = _exchange(stay_l, ext_l, mesh)
        _, f = beam_cuda.merge_topk(stay, ext, K)
        active = t < logit_len
        if carry is not None:
            mine = _step_lm(rnn_lm, carry, f["parent"][:, own], f["append"][:, own])
            carry = _freeze_lm(_exchange_lm(mine, mesh), carry, active)
        state = _finish_step(state, f, active, L)
    return beam_best(state)
