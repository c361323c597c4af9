"""Plain CTC loss: the port's counterpart of ``pytorch_asr_tpu.ops.ctc``.

The alpha-beta recursion over the blank-interleaved label lattice runs in
log space.  ``CTCLoss`` is a ``torch.autograd.Function`` whose backward is the
hand-derived beta recursion of the JAX package's ``_ctc_bwd``: it forms the
gradient from the state posteriors instead of differentiating through the
forward loop.  The two recursions are pluggable (``Recursions``): this module
gives their plain PyTorch versions, ``ops/ctc_cuda.py`` the CUDA kernel
(K4) for them.  Log-softmax, the lattice gather, ``beta_T``, the S -> V
scatter of the posteriors and the gradient assembly stay plain PyTorch for
both, as they stay in XLA around the Pallas kernels.

Shapes: logits (B, T, V) raw scores; labels (B, L) padded with 0 (= blank).
Lattice states s in [0, 2L+1): even s are blanks, odd s are labels.

Semantics kept from the reference: the ``NEG_INF = -1e30`` sentinel with a
clamp ``max(., NEG_INF)`` in every log-sum-exp, so the exp of a sentinel is
exactly 0; frames t >= logit_len carry alpha through unchanged; infeasible
rows and rows with ``logit_len == 0`` or ``label_len == 0`` give loss 0 and
gradient 0 (``zero_infinity=True`` in torch's terms); repeated labels block
the skip transition.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

NEG_INF = -1.0e30


def extended_labels(labels: torch.Tensor, blank: int) -> torch.Tensor:
    """(B, L) -> (B, 2L+1) blank-interleaved label sequence (int64)."""
    B, L = labels.shape
    ext = torch.full((B, 2 * L + 1), blank, dtype=torch.int64, device=labels.device)
    ext[:, 1::2] = labels
    return ext


def skip_allowed(labels: torch.Tensor, label_len: torch.Tensor) -> torch.Tensor:
    """(B, 2L+1) bool: alpha may jump s-2 -> s (odd s, distinct adjacent labels)."""
    B, L = labels.shape
    S = 2 * L + 1
    allowed = torch.zeros((B, S), dtype=torch.bool, device=labels.device)
    if L > 1:
        allowed[:, 3::2] = labels[:, 1:] != labels[:, :-1]
    pos = torch.arange(S, device=labels.device)[None, :]
    return allowed & (pos < 2 * label_len[:, None] + 1)


def shift_right(x: torch.Tensor, k: int, fill=NEG_INF) -> torch.Tensor:
    """x[:, s-k] along the last axis, ``fill`` where s < k."""
    return F.pad(x, (k, 0), value=fill)[..., : x.shape[-1]]


def shift_left(x: torch.Tensor, k: int, fill=NEG_INF) -> torch.Tensor:
    """x[:, s+k] along the last axis, ``fill`` where s + k >= S."""
    return F.pad(x, (0, k), value=fill)[..., k:]


def logsumexp3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """log(e^a + e^b + e^c) with the reference's sentinel clamps."""
    m = torch.clamp(torch.maximum(torch.maximum(a, b), c), min=NEG_INF)
    tot = m + torch.log(torch.exp(a - m) + torch.exp(b - m) + torch.exp(c - m))
    return torch.clamp(tot, min=NEG_INF)


def terminal_logz(alpha_last: torch.Tensor, label_len: torch.Tensor) -> torch.Tensor:
    """log P from the two terminal lattice states."""
    rows = torch.arange(alpha_last.shape[0], device=alpha_last.device)
    label_len = label_len.long()
    end_blank = alpha_last[rows, 2 * label_len]
    end_label = torch.where(label_len > 0,
                            alpha_last[rows, torch.clamp(2 * label_len - 1, min=0)],
                            torch.full_like(end_blank, NEG_INF))
    return torch.logaddexp(end_blank, end_label)


def prep(logits, labels, label_len, blank):
    """(logp (B, T, V), logp_tbs (T, B, S), ext (B, S), skip (B, S)).

    The lattice gather ``logp_tbs[t, b, s] = logp[b, t, ext[b, s]]`` is a
    plain ``torch.gather``.  The Pallas path builds it as a one-hot
    HIGHEST-precision einsum, which is a Mosaic workaround, not part of the
    function.  States beyond a row's lattice (s >= 2 label_len + 1) get
    ``NEG_INF``.
    """
    if logits.shape[1] == 0:
        raise ValueError("ctc_loss: logits need at least one frame")
    logp = torch.log_softmax(logits.float(), dim=-1)
    ext = extended_labels(labels, blank)
    skip = skip_allowed(labels, label_len)
    B, T, _ = logp.shape
    S = ext.shape[1]
    logp_tbs = torch.gather(logp, 2, ext[:, None, :].expand(B, T, S)).transpose(0, 1)
    valid_s = torch.arange(S, device=logits.device)[None, :] < 2 * label_len[:, None] + 1
    logp_tbs = torch.where(valid_s[None], logp_tbs, NEG_INF).contiguous()
    return logp, logp_tbs, ext, skip


def alphas_plain(logp_tbs: torch.Tensor, skip: torch.Tensor,
                 logit_len: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The alpha recursion.  logp_tbs (T, B, S) -> (alphas (T, B, S), final (B, S))."""
    T, B, S = logp_tbs.shape
    alpha = torch.full((B, S), NEG_INF, dtype=torch.float32, device=logp_tbs.device)
    alpha[:, :2] = logp_tbs[0, :, :2]
    alphas = [alpha]
    for t in range(1, T):
        s2 = torch.where(skip, shift_right(alpha, 2), NEG_INF)
        new = logsumexp3(alpha, shift_right(alpha, 1), s2) + logp_tbs[t]
        # Padded frames (t >= logit_len) carry alpha through unchanged.
        alpha = torch.where((t < logit_len)[:, None], new, alpha)
        alphas.append(alpha)
    return torch.stack(alphas), alpha


def logsumexp5(a, b, c, d, e) -> torch.Tensor:
    """log(e^a + ... + e^e) with the reference's sentinel clamps."""
    m = torch.clamp(torch.maximum(torch.maximum(torch.maximum(a, b), torch.maximum(c, d)), e),
                    min=NEG_INF)
    tot = m + torch.log(torch.exp(a - m) + torch.exp(b - m) + torch.exp(c - m)
                        + torch.exp(d - m) + torch.exp(e - m))
    return torch.clamp(tot, min=NEG_INF)


def alphas_paired_plain(logp_tbs: torch.Tensor, skip: torch.Tensor,
                        logit_len: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The alpha recursion two frames an iteration, the plain version of the
    paired kernel (``pytorch_asr_tpu/ops/ctc_pallas.py::_fwd_kernel_paired``).

    One step is A_t(x)[s] = lse(x[s], x[s-1], x[s-2] + K[s]) + P_t[s], K the
    additive skip mask (0 or NEG_INF).  Two composed,
    A_{t+1}(A_t(x))[s] = P_{t+1}[s] + lse_{m=0..4}(x[s-m] + W_m[s]) with the
    emission-only weights W_0 = P_t[s], W_1 = lse(P_t[s], P_t[s-1]),
    W_2 = lse(P_t[s] + K[s], P_t[s-1], P_t[s-2] + K[s]),
    W_3 = lse(P_t[s-1] + K[s-1], P_t[s-2] + K[s]), W_4 = P_t[s-2] + K[s] + K[s-2].
    Each pair also computes the single step a1 (stored at t; the output of
    rows whose length ends mid-pair), and the t = 0 pair applies the second
    step to alpha_0.  Every step is floored at NEG_INF, as in the JAX kernel.
    Same returns as ``alphas_plain``; the values agree with it to float32
    rounding (the composed sum rounds in another order).  An odd T is padded
    with one NEG_INF frame, as the JAX kernel pads T to its time chunk.
    """
    T, B, S = logp_tbs.shape
    lp = logp_tbs if T % 2 == 0 else torch.cat([logp_tbs, torch.full_like(logp_tbs[:1],
                                                                          NEG_INF)])
    lens = logit_len.to(lp.device)[:, None]
    k0 = torch.where(skip, 0.0, NEG_INF).to(torch.float32)
    k1, k2 = shift_right(k0, 1), shift_right(k0, 2)
    first = torch.arange(S, device=lp.device)[None, :] < 2
    alpha = torch.full((B, S), NEG_INF, dtype=torch.float32, device=lp.device)
    alphas = []
    for t in range(0, lp.shape[0], 2):
        p0, p1 = lp[t], lp[t + 1]
        p0s1, p0s2 = shift_right(p0, 1), shift_right(p0, 2)
        w0 = p0
        w1 = torch.logaddexp(p0, p0s1)
        w2 = logsumexp3(p0 + k0, p0s1, p0s2 + k0)
        w3 = torch.logaddexp(p0s1 + k1, p0s2 + k0)
        w4 = p0s2 + k0 + k2
        x1, x2 = shift_right(alpha, 1), shift_right(alpha, 2)
        a1n = torch.clamp(logsumexp3(alpha, x1, x2 + k0) + p0, min=NEG_INF)
        alpha0 = torch.where(first, p0, NEG_INF)
        a1 = alpha0 if t == 0 else torch.where(t < lens, a1n, alpha)
        a2 = torch.clamp(logsumexp5(alpha + w0, x1 + w1, x2 + w2, shift_right(alpha, 3) + w3,
                                    shift_right(alpha, 4) + w4) + p1, min=NEG_INF)
        t0_out = torch.clamp(logsumexp3(alpha0, shift_right(alpha0, 1),
                                        shift_right(alpha0, 2) + k0) + p1, min=NEG_INF)
        alpha = torch.where(t + 1 < lens, t0_out if t == 0 else a2, a1)
        alphas += [a1, alpha]
    return torch.stack(alphas[:T]), alphas[T - 1]


def posteriors_plain(logp_tbs, alphas, skip_from, beta_T, lens, logz) -> torch.Tensor:
    """The beta recursion -> state posteriors w (T, B, S) = exp(max(gamma, NEG_INF)).

    ``skip_from[b, s]``: the transition s -> s+2 is allowed.  ``beta_T`` is 0
    at the two end states, installed at t = lens-1.  ``lens`` are the frame
    counts with infeasible rows set to 0, so w is 0 there and at t >= lens.
    """
    T, B, S = logp_tbs.shape
    beta = torch.full((B, S), NEG_INF, dtype=torch.float32, device=logp_tbs.device)
    logp_next = torch.full_like(beta, NEG_INF)
    w = torch.empty_like(alphas)
    for t in range(T - 1, -1, -1):
        term = beta + logp_next
        s2 = torch.where(skip_from, shift_left(term, 2), NEG_INF)
        recursed = logsumexp3(term, shift_left(term, 1), s2)
        beta = torch.where((t == lens - 1)[:, None], beta_T,
                           torch.where((t < lens - 1)[:, None], recursed, beta))
        gamma = alphas[t] + beta - logz[:, None]
        w[t] = torch.where((t < lens)[:, None],
                           torch.exp(torch.clamp(gamma, min=NEG_INF)), 0.0)
        logp_next = logp_tbs[t]
    return w


class Recursions(NamedTuple):
    """The two serial recursions of the loss: plain PyTorch or the K4 kernels."""

    alphas: Callable      # (logp_tbs, skip, logit_len) -> (alphas, final)
    posteriors: Callable  # (logp_tbs, alphas, skip_from, beta_T, lens, logz) -> w


PLAIN = Recursions(alphas_plain, posteriors_plain)
PAIRED_PLAIN = Recursions(alphas_paired_plain, posteriors_plain)


def terminal_betas(label_len: torch.Tensor, S: int) -> torch.Tensor:
    """(B, S) beta at each row's last frame: 0 at s = 2L and, if L > 0, 2L-1."""
    pos = torch.arange(S, device=label_len.device)[None, :]
    L = label_len[:, None].long()
    end = (pos == 2 * L) | ((L > 0) & (pos == 2 * L - 1))
    return torch.where(end, 0.0, NEG_INF).float()


class CTCLoss(torch.autograd.Function):
    """Per-utterance CTC negative log-likelihood with the hand-derived backward."""

    @staticmethod
    def forward(ctx, logits, logit_len, labels, label_len, blank: int,
                recursions: Recursions):
        logit_len = logit_len.to(torch.int32).contiguous()
        label_len = label_len.to(torch.int32)
        logp, logp_tbs, ext, skip = prep(logits, labels.long(), label_len, blank)
        alphas, final = recursions.alphas(logp_tbs, skip, logit_len)
        logz = terminal_logz(final, label_len)
        feasible = (logz > NEG_INF / 2) & (logit_len > 0)
        loss = torch.where(feasible, -logz, 0.0)
        ctx.save_for_backward(logp, logp_tbs, alphas, logz, feasible, ext, skip,
                              logit_len, label_len)
        ctx.recursions = recursions
        ctx.logits_dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        (logp, logp_tbs, alphas, logz, feasible, ext, skip,
         logit_len, label_len) = ctx.saved_tensors
        B, T, V = logp.shape
        S = ext.shape[1]
        # The transition s -> s+2 is allowed iff arrivals at s+2 may skip.
        skip_from = shift_left(skip, 2, fill=False)
        lens = torch.where(feasible, logit_len, 0).to(torch.int32)
        logz_safe = torch.where(feasible, logz, 0.0)
        w = ctx.recursions.posteriors(logp_tbs, alphas, skip_from.contiguous(),
                                      terminal_betas(label_len, S), lens, logz_safe)
        grad = posterior_grad(w, ext, logp, logit_len) * g[:, None, None]
        return grad.to(ctx.logits_dtype), None, None, None, None, None


def posterior_grad(w, ext, logp, logit_len) -> torch.Tensor:
    """d loss / d logits = p * sum_v gamma_v - gamma_v at valid frames.

    The S -> V scatter is a one-hot batched product (exact: one-hot rows are
    0 or 1, and float32 products stay float32 here), deterministic on the card.
    """
    B, T, V = logp.shape
    onehot = F.one_hot(ext, V).to(w.dtype)                         # (B, S, V)
    gamma_v = torch.bmm(w.transpose(0, 1), onehot)                 # (B, T, V)
    t_valid = (torch.arange(T, device=logp.device)[None, :] < logit_len[:, None])[..., None]
    return torch.where(t_valid, torch.exp(logp) * gamma_v.sum(-1, keepdim=True) - gamma_v,
                       0.0)


def ctc_loss(logits, logit_len, labels, label_len, blank: int = 0) -> torch.Tensor:
    """(B,) per-utterance CTC loss, plain PyTorch recursions; 0 for
    infeasible or empty rows."""
    return CTCLoss.apply(logits, logit_len, labels, label_len, blank, PLAIN)


def ctc_loss_mean(logits, logit_len, labels, label_len, blank: int = 0) -> torch.Tensor:
    """Batch-mean CTC loss, normalised per label token, over rows with
    ``logit_len > 0`` (torch's 'mean' reduction)."""
    per_utt = ctc_loss(logits, logit_len, labels, label_len, blank)
    denom = torch.clamp(label_len.float(), min=1.0)
    valid = (logit_len > 0).float()
    return torch.sum(per_utt / denom * valid) / torch.clamp(valid.sum(), min=1.0)
