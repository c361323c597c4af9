"""CTC forced alignment: Viterbi over the blank-interleaved lattice
(counterpart of ``pytorch_asr_tpu.decoding.align``).

The same extended label lattice as the CTC loss (``ops/ctc.py``): a loop
over the frames keeps each state's best score and which of (stay, diag,
skip2) it came from, then a backtrace from each utterance's own last frame.
Plain torch on every device: no TPU kernel does this work (the JAX package
runs it as two ``lax.scan``), so no hand-written kernel is owed; on the card
it is a few small launches a frame.

Outputs per utterance: the lattice state and the emitted label at each
frame, each token's [start, end) frames, and the best path's log-prob.
"""

from __future__ import annotations

import torch

NEG_INF = -1.0e30     # finite, as JAX's: NEG_INF plus a log-prob stays finite


def _extend(tokens: torch.Tensor, blank: int) -> torch.Tensor:
    """(B, L) labels -> (B, 2L+1) blank-interleaved lattice labels, int64."""
    B, L = tokens.shape
    ext = torch.full((B, 2 * L + 1), blank, dtype=torch.long, device=tokens.device)
    ext[:, 1::2] = tokens
    return ext


def ctc_forced_align(logits: torch.Tensor, logit_len: torch.Tensor, tokens: torch.Tensor,
                     token_len: torch.Tensor, blank: int = 0) -> dict:
    """Most-likely CTC alignment of ``tokens`` (B, L), 0-padded past
    ``token_len``, to the frames of ``logits`` (B, T, V) valid below
    ``logit_len``.

    Returns a dict: frame_state (B, T) int32, the lattice state of each frame
    (-1 past logit_len); frame_label (B, T) int32, the label emitted there
    (blank between and within tokens; -1 past logit_len); starts, ends (B, L)
    int32, each token's [start, end) frames ((0, 0) past token_len; (T, 0)
    for a token the path never visits); score (B,) float32, the best path's
    log-prob.  As JAX's: each frame takes the first of (stay, diag, skip2)
    with the largest score; the path ends in the last state where it scores
    at least the one before; a row of no frames reads frame 0; an infeasible
    row (fewer frames than its tokens need) still gives the path and score
    that the finite NEG_INF leaves.
    """
    B, T, _ = logits.shape
    L = tokens.shape[1]
    S = 2 * L + 1
    dev = logits.device
    logp = torch.log_softmax(logits.float(), dim=-1)
    ext = _extend(tokens, blank)                                     # (B, S)
    s_len = 2 * token_len.long().to(dev) + 1
    logit_len = logit_len.long().to(dev)
    # skip s-2 -> s where ext[s] is a label that differs from ext[s-2]
    can_skip = torch.zeros((B, S), dtype=torch.bool, device=dev)
    can_skip[:, 2:] = (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])
    emit = logp.gather(2, ext[:, None, :].expand(B, T, S))           # (B, T, S)

    delta = torch.full((B, S), NEG_INF, device=dev)
    delta[:, 0] = emit[:, 0, 0]
    if S > 1:
        delta[:, 1] = torch.where(s_len > 1, emit[:, 0, 1], NEG_INF)
    t_last = torch.clamp(logit_len - 1, 0, T - 1)     # JAX's gather clamps past T
    d_last = delta.clone()                       # delta at t_last, each row
    choices = torch.zeros((T, B, S), dtype=torch.int8, device=dev)  # into frame t
    neg = torch.full((B, S), NEG_INF, device=dev)
    for t in range(1, T):
        diag = neg.clone()
        diag[:, 1:] = delta[:, :-1]
        skip2 = neg.clone()
        skip2[:, 2:] = delta[:, :-2]
        skip2 = torch.where(can_skip, skip2, NEG_INF)
        # The first of (stay, diag, skip2) with the largest score.
        best, choice = delta, torch.zeros((B, S), dtype=torch.int8, device=dev)
        for k, cand in ((1, diag), (2, skip2)):
            better = cand > best
            best = torch.where(better, cand, best)
            choice = torch.where(better, k, choice).to(torch.int8)
        delta = best + emit[:, t]
        choices[t] = choice
        d_last = torch.where((t_last == t)[:, None], delta, d_last)

    sN = s_len - 1
    sN1 = torch.clamp(s_len - 2, min=0)
    dN = d_last.gather(1, sN[:, None])[:, 0]
    dN1 = d_last.gather(1, sN1[:, None])[:, 0]
    s = torch.where(dN >= dN1, sN, sN1)
    score = torch.maximum(dN, dN1)

    # Backtrace t = T-1 .. 0; only frames below logit_len move the cursor.
    frame_state = torch.empty((B, T), dtype=torch.long, device=dev)
    for t in range(T - 1, -1, -1):
        inside = t < logit_len
        frame_state[:, t] = torch.where(inside, s, -1)
        if t > 0:
            ch = choices[t].gather(1, s[:, None])[:, 0].long()
            s = torch.where(inside, s - ch, s)

    valid = frame_state >= 0
    frame_label = torch.where(valid, ext.gather(1, torch.clamp(frame_state, min=0)), -1)
    # token i is lattice state 2i+1: its span is the frames in that state
    tok_state = 2 * torch.arange(L, device=dev) + 1
    on = frame_state[:, :, None] == tok_state[None, None, :]        # (B, T, L)
    t_idx = torch.arange(T, device=dev)[None, :, None]
    starts = torch.where(on, t_idx, T).amin(dim=1)
    ends = torch.where(on, t_idx + 1, 0).amax(dim=1)
    tok_valid = torch.arange(L, device=dev)[None, :] < token_len.to(dev)[:, None]
    return {"frame_state": frame_state.int(), "frame_label": frame_label.int(),
            "starts": torch.where(tok_valid, starts, 0).int(),
            "ends": torch.where(tok_valid, ends, 0).int(), "score": score}
