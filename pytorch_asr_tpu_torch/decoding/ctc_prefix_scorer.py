"""Vectorised CTC prefix scorer for joint CTC/attention decoding: the port's
counterpart of ``pytorch_asr_tpu.decoding.ctc_prefix_scorer`` (BASELINE
config 5).

State per hypothesis g, batched over (batch B, beam K):
  r_n, r_b (B, K, T): log prob of the alignments up to frame t that collapse
    to g and end in a non-blank / a blank;
  psi (B, K): the prefix score log P(output starts with g).

Scoring every extension h = g.c is a loop over the frames of elementwise
(B, K, V) updates (JAX's ``lax.scan``):

    phi_t    = r_b(g)_t  (+)  [c != last(g)] r_n(g)_t
    r_n(h)_t = (r_n(h)_{t-1} (+) phi_{t-1}) + logp_t(c)
    r_b(h)_t = (r_b(h)_{t-1} (+) r_n(h)_{t-1}) + logp_t(blank)
    psi(h)   = (+)_t  phi_{t-1} + logp_t(c)

with the virtual phi_{-1} = 0 for the empty hypothesis and NEG_INF
otherwise.  (+) is ``torch.logaddexp`` with the finite sentinel NEG_INF,
and r_n, r_b are floored at NEG_INF each frame.  Frames past a row's length
leave its values as they are; the loop stops at the batch's longest row and
the frames after it repeat the last values, which is what the scan's masked
frames give.  Plain PyTorch on both devices: no TPU kernel does this work.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1.0e30


class CTCScorerState(NamedTuple):
    r_n: torch.Tensor    # (B, K, T)
    r_b: torch.Tensor    # (B, K, T)
    psi: torch.Tensor    # (B, K)


def init_state(ctc_logp: torch.Tensor, logit_len: torch.Tensor, K: int) -> CTCScorerState:
    """The empty hypothesis on every beam; ctc_logp (B, T, V) log-softmax."""
    B, T, _ = ctc_logp.shape
    t_mask = torch.arange(T, device=ctc_logp.device)[None, :] < logit_len[:, None]
    r_b = torch.cumsum(torch.where(t_mask, ctc_logp[:, :, 0], 0.0), dim=1)
    r_b = torch.where(t_mask, r_b, NEG_INF)
    return CTCScorerState(
        r_n=torch.full((B, K, T), NEG_INF, device=ctc_logp.device),
        r_b=r_b[:, None, :].expand(B, K, T).contiguous(),
        psi=torch.zeros((B, K), device=ctc_logp.device))


def score_extensions(state: CTCScorerState, ctc_logp: torch.Tensor, logit_len: torch.Tensor,
                     last: torch.Tensor, eos_id: int):
    """-> (delta (B, K, V), r_n_all (T, B, K, V), r_b_all (T, B, K, V)).

    delta[b, k, c] = psi(g.c) - psi(g); the eos slot holds the accept score
    r(g) at the row's last frame less psi(g), and the blank slot NEG_INF.
    ``last`` (B, K) is g's last char, -1 for the empty prefix."""
    B, K, T = state.r_n.shape
    V = ctc_logp.shape[-1]
    dev = ctc_logp.device
    not_repeat = torch.arange(V, device=dev)[None, None, :] != last[..., None]    # (B, K, V)
    phi = torch.where(not_repeat[None],
                      torch.logaddexp(state.r_b, state.r_n).permute(2, 0, 1)[..., None],
                      state.r_b.permute(2, 0, 1)[..., None])                      # (T, B, K, V)
    logp_t = ctc_logp.transpose(0, 1)                                             # (T, B, V)
    mask_t = torch.arange(T, device=dev)[:, None] < logit_len[None, :]            # (T, B)
    phi_prev = torch.where((last == -1)[..., None], 0.0, NEG_INF).expand(B, K, V)
    r_n = torch.full((B, K, V), NEG_INF, device=dev)
    r_b = torch.full((B, K, V), NEG_INF, device=dev)
    psi = torch.full((B, K, V), NEG_INF, device=dev)
    r_n_all = torch.empty((T, B, K, V), device=dev)
    r_b_all = torch.empty((T, B, K, V), device=dev)
    t_end = int(logit_len.max()) if B else 0
    for t in range(min(t_end, T)):
        lp_c = logp_t[t][:, None, :]                                              # (B, 1, V)
        lp_blank = logp_t[t][:, None, 0:1]
        r_n_new = torch.clamp(torch.logaddexp(r_n, phi_prev) + lp_c, min=NEG_INF)
        r_b_new = torch.clamp(torch.logaddexp(r_b, r_n) + lp_blank, min=NEG_INF)
        psi_new = torch.logaddexp(psi, phi_prev + lp_c)
        m = mask_t[t][:, None, None]
        r_n = torch.where(m, r_n_new, r_n, out=r_n_all[t])
        r_b = torch.where(m, r_b_new, r_b, out=r_b_all[t])
        psi = torch.where(m, psi_new, psi)
        phi_prev = torch.where(m, phi[t], phi_prev)
    if t_end < T:
        r_n_all[t_end:] = r_n
        r_b_all[t_end:] = r_b
    delta = psi - state.psi[..., None]
    # eos: accept g as it is -> its full CTC probability
    t_last = torch.clamp(logit_len.long() - 1, min=0)[:, None, None].expand(B, K, 1)
    r_last = torch.logaddexp(torch.gather(state.r_n, 2, t_last),
                             torch.gather(state.r_b, 2, t_last))[..., 0]
    delta[:, :, eos_id] = r_last - state.psi
    delta[:, :, 0] = NEG_INF
    return delta, r_n_all, r_b_all


def select_extension(r_n_all: torch.Tensor, r_b_all: torch.Tensor, state: CTCScorerState,
                     delta: torch.Tensor, parent: torch.Tensor, chosen: torch.Tensor,
                     emit: torch.Tensor) -> CTCScorerState:
    """Next state of each beam k, which extends beam ``parent`` (B, K) of
    ``state`` by the char ``chosen`` (B, K) where ``emit`` (B, K), and keeps
    that parent's state as it is elsewhere (a finished beam, or one that took
    eos).  r_n_all and r_b_all are time-leading (T, B, K, V), as
    ``score_extensions`` gives them.  The reorders are index gathers: JAX's
    search contracts one-hot matrices there (an XLA workaround), which gives
    the same values."""
    b_i = torch.arange(parent.shape[0], device=parent.device)[:, None]
    c = chosen.long()
    e = emit[..., None]
    g_psi = state.psi[b_i, parent]
    return CTCScorerState(
        r_n=torch.where(e, r_n_all[:, b_i, parent, c].permute(1, 2, 0), state.r_n[b_i, parent]),
        r_b=torch.where(e, r_b_all[:, b_i, parent, c].permute(1, 2, 0), state.r_b[b_i, parent]),
        psi=torch.where(emit, g_psi + delta[b_i, parent, c], g_psi))
