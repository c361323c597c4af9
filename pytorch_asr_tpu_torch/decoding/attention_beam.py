"""Batched attention (LAS) beam search and joint CTC/attention decoding: the
port's counterpart of ``pytorch_asr_tpu.decoding.attention_beam`` (BASELINE
configs 4 and 5).

Hypotheses are tensors over (batch B, beam K), decoded in step:

  * the decoder state is flat over B*K rows for the single LAS step;
  * candidates (B, K, V) = beam score + (1-lam) logp_att [+ lam delta_ctc]
    [+ lm_alpha logp_lm]; blank and sos never; a finished beam carries its
    score only through its eos slot;
  * the K best of the K*V candidates per utterance; decoder, scorer and LM
    states follow their parent beam;
  * the final ranking is score / max(len, 1) ** length_norm, plus the
    coverage bonus.

Joint decoding (config 5) adds the CTC prefix scorer
(``decoding/ctc_prefix_scorer.py``).  The loop runs while a beam is
unfinished and fewer than ``max_len`` steps ran: one host check a step.
Parity traps with the JAX search:

* the sentinel ``NEG_INF = -1e30`` is finite, and stays so under the
  weights (``-1e30 + 0.3 * -1e30``);
* the selection is a stable descending sort of the flat K*V candidates, as
  ``lax.top_k`` puts the lower flat index first on ties (at step 0 every
  beam but beam 0 ties at the sentinel); ``torch.topk`` promises no order;
* the dense LM context advances only on emission, ``(ctx V + c) % n_ctx``,
  with no ``lm_beta``; so does the hashed LM's window (``lm_hashed.
  roll_context_window``), its rows ``hashed_lm_logp_rows`` of each beam's
  window; the RNN LM is primed with sos on B*K rows and steps
  only where a beam emitted;
* the beam reorders are index gathers: JAX contracts one-hot matrices there
  (an XLA workaround), which gives the same values;
* the best beam is the first maximum (``torch.argmax``, as ``jnp.argmax``).
"""

from __future__ import annotations

import torch

from pytorch_asr_tpu_torch.decoding import ctc_prefix_scorer as cps
from pytorch_asr_tpu_torch.decoding.lm_hashed import hashed_lm_logp_rows, roll_context_window
from pytorch_asr_tpu_torch.models.las_decoder import DecoderState
from pytorch_asr_tpu_torch.models.lm_rnn import CharRNNLM, LMState, lm_step_logp

NEG_INF = -1.0e30


def _gather(x: torch.Tensor, parent: torch.Tensor) -> torch.Tensor:
    """x (B, K, ...) reordered along K by parent (B, K)."""
    idx = parent.reshape(parent.shape + (1,) * (x.dim() - 2)).expand(parent.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


def attention_beam_search(model, enc: torch.Tensor, enc_len: torch.Tensor, sos_id: int,
                          eos_id: int, **kw):
    """``model`` is an ``ASRModel`` with a decoder (or anything with its
    ``decoder_begin`` and ``decoder_step``); enc (B, T, D), enc_len (B,); the
    keywords are ``final_beams``'.  Returns the best beam of each row:
    (tokens (B, max_len) int32, lengths (B,) int32, scores (B,) f32)."""
    tokens, length, final = final_beams(model, enc, enc_len, sos_id, eos_id, **kw)
    best = torch.argmax(final, dim=1)
    b_i = torch.arange(enc.shape[0], device=enc.device)
    return tokens[b_i, best], length[b_i, best], final[b_i, best]


def final_beams(model, enc: torch.Tensor, enc_len: torch.Tensor, sos_id: int, eos_id: int,
                beam_size: int = 8, max_len: int = 128, length_norm: float = 1.0,
                ctc_logits: torch.Tensor | None = None, ctc_weight: float = 0.0,
                lm_table: torch.Tensor | None = None, lm_alpha: float = 0.0,
                rnn_lm: CharRNNLM | None = None, coverage_beta: float = 0.0,
                coverage_tau: float = 0.5, hash_lm=None):
    """The search: every beam of every row at the end, (tokens (B, K,
    max_len) int32, lengths (B, K) int32, ranking scores (B, K) f32).  The
    LM (weight ``lm_alpha``) is the dense table ``lm_table``, the hashed
    tables ``hash_lm`` (``decoding.lm_hashed.HashedNgramLM``) or ``rnn_lm``.

    Coverage (Chorowski & Jaitly 2016) adds ``coverage_beta`` times the count
    of valid frames whose attention, summed over the emitting steps, exceeds
    ``coverage_tau``."""
    B, T, _ = enc.shape
    K, U = beam_size, max_len
    dev = enc.device
    enc_k = enc.float().repeat_interleave(K, dim=0)               # (B*K, T, D) f32, once
    enc_projed, enc_mask, dec = model.decoder_begin(enc_k, enc_len.repeat_interleave(K))
    base = (torch.arange(B, device=dev) * K)[:, None]             # flat row of beam 0
    kidx = torch.arange(K, device=dev)[None, :]

    tokens = torch.zeros((B, K, U), dtype=torch.int32, device=dev)
    length = torch.zeros((B, K), dtype=torch.int32, device=dev)
    score = torch.where(kidx == 0, 0.0, NEG_INF).expand(B, K).contiguous()
    finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
    last = torch.full((B, K), -1, dtype=torch.int32, device=dev)
    y_prev = torch.full((B, K), sos_id, dtype=torch.long, device=dev)

    use_ctc = ctc_logits is not None and ctc_weight > 0.0
    if use_ctc:
        ctc_logp = torch.log_softmax(ctc_logits.float(), dim=-1)
        ctc_state = cps.init_state(ctc_logp, enc_len, K)
    if lm_table is not None:
        lm_ctx = torch.zeros((B, K), dtype=torch.long, device=dev)
        n_ctx = lm_table.shape[0]
    elif hash_lm is not None:     # a window of the last order - 1 ids a beam
        lm_ctx = torch.zeros((B, K, hash_lm.order - 1), dtype=torch.int32, device=dev)
    if rnn_lm is not None:
        lm_logp, lm_st = lm_step_logp(rnn_lm, torch.full((B * K,), sos_id, device=dev),
                                      rnn_lm.init_state(B * K))
        lm_logp = lm_logp.reshape(B, K, -1)
    cum_att = torch.zeros((B, K, T), device=dev) if coverage_beta != 0.0 else None
    att_w = 1.0 - ctc_weight if use_ctc else 1.0

    step = 0
    while step < U and not bool(finished.all()):
        logits, new_dec = model.decoder_step(enc_k, enc_projed, enc_mask, y_prev.reshape(-1),
                                             dec)
        logp = torch.log_softmax(logits.float(), dim=-1)
        V = logp.shape[-1]
        cand = score[..., None] + att_w * logp.reshape(B, K, V)
        if use_ctc:
            delta, r_n_all, r_b_all = cps.score_extensions(ctc_state, ctc_logp, enc_len, last,
                                                           eos_id)
            cand = cand + ctc_weight * delta
        if lm_table is not None:
            cand = cand + lm_alpha * lm_table[lm_ctx]
        elif hash_lm is not None:
            cand = cand + lm_alpha * hashed_lm_logp_rows(hash_lm, lm_ctx)
        if rnn_lm is not None:
            cand = cand + lm_alpha * lm_logp
        cand[:, :, 0] = NEG_INF
        cand[:, :, sos_id] = NEG_INF
        frozen = torch.full_like(cand, NEG_INF)
        frozen[:, :, eos_id] = score
        cand = torch.where(finished[..., None], frozen, cand)

        top_score, top_idx = torch.sort(cand.reshape(B, K * V), dim=1, descending=True,
                                        stable=True)
        top_score, top_idx = top_score[:, :K], top_idx[:, :K]
        parent, char = top_idx // V, (top_idx % V).int()
        rows = (base + parent).reshape(-1)

        was_fin = _gather(finished, parent)
        now_eos = (char == eos_id) & ~was_fin
        emit = ~was_fin & ~now_eos
        g_len = _gather(length, parent)
        pos = torch.arange(U, device=dev)[None, None, :] == g_len[..., None].long()
        tokens = torch.where(pos & emit[..., None], char[..., None], _gather(tokens, parent))
        length = g_len + emit.int()
        score = top_score
        finished = was_fin | now_eos
        last = torch.where(emit, char, _gather(last, parent))
        y_prev = torch.where(finished, eos_id,
                             torch.where(emit, char.long(), _gather(y_prev, parent)))
        dec = DecoderState(h=new_dec.h.index_select(1, rows), c=new_dec.c.index_select(1, rows),
                           att=new_dec.att.index_select(0, rows),
                           ctx=new_dec.ctx.index_select(0, rows))

        if use_ctc:
            ctc_state = cps.select_extension(r_n_all, r_b_all, ctc_state, delta, parent, char,
                                             emit)
        if lm_table is not None:
            g_ctx = _gather(lm_ctx, parent)
            lm_ctx = torch.where(emit, torch.remainder(g_ctx * V + char, n_ctx), g_ctx)
        elif hash_lm is not None:
            g_ctx = _gather(lm_ctx, parent)
            lm_ctx = torch.where(emit[..., None], roll_context_window(g_ctx, char), g_ctx)
        if rnn_lm is not None:
            gh, gc = lm_st.h.index_select(1, rows), lm_st.c.index_select(1, rows)
            glogp = _gather(lm_logp, parent)
            s_logp, s_st = lm_step_logp(rnn_lm, torch.where(emit, char, 1).reshape(-1),
                                        LMState(gh, gc))
            e_flat = emit.reshape(1, -1, 1)
            lm_st = LMState(torch.where(e_flat, s_st.h, gh), torch.where(e_flat, s_st.c, gc))
            lm_logp = torch.where(emit[..., None], s_logp.reshape(B, K, -1), glogp)
        if cum_att is not None:
            cum_att = (_gather(cum_att, parent)
                       + torch.where(emit[..., None], dec.att.reshape(B, K, T), 0.0))
        step += 1

    # Unfinished beams keep their raw score; rank with length normalisation.
    final = score / torch.clamp(length.float(), min=1.0) ** length_norm
    if cum_att is not None:
        frame_valid = torch.arange(T, device=dev)[None, None, :] < enc_len[:, None, None]
        covered = ((cum_att > coverage_tau) & frame_valid).float().sum(dim=2)
        final = final + coverage_beta * covered
    return tokens, length, final
