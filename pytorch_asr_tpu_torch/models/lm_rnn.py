"""Char LSTM language model for neural shallow fusion: the port's counterpart
of ``pytorch_asr_tpu.models.lm_rnn``.

The parameters carry the JAX names and layout, so an ``.npz`` saved by either
package loads in the other (``training/lm.py``): ``embed (V, E)``,
``lstm{l}_wx (in, 4H)``, ``lstm{l}_wh (H, 4H)``, ``lstm{l}_b (4H,)``,
``w_out (H, V)``, ``b_out (V,)``.  The cell is not ``nn.LSTM``: the gates
are i, f, g, o in that order, the forget gate is ``sigmoid(f + 1)`` and
there is one bias.  One pure ``step`` serves teacher-forced training and
the per-beam advance of the fused search (``decoding/prefix_beam.py``; on
the card the search kernel computes the same step itself).  Products are
``torch.matmul``, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch import nn


@dataclass(frozen=True)
class RNNLMConfig:
    embed_dim: int = 128
    hidden_dim: int = 256
    num_layers: int = 2
    dropout: float = 0.0


class LMState(NamedTuple):
    h: torch.Tensor   # (num_layers, B, H) f32
    c: torch.Tensor   # (num_layers, B, H) f32


class CharRNNLM(nn.Module):
    """Weights drawn from ``seed`` with flax's initializers (the numbers
    differ from JAX's): normal 0.02 for ``embed``, xavier-uniform for the
    input kernels and ``w_out``, orthogonal for ``wh``, zero biases."""

    def __init__(self, cfg: RNNLMConfig, vocab_size: int, seed: int = 0) -> None:
        super().__init__()
        self.cfg, self.vocab_size = cfg, vocab_size
        V, E, H = vocab_size, cfg.embed_dim, cfg.hidden_dim
        g = torch.Generator().manual_seed(seed)
        self.embed = nn.Parameter(torch.randn(V, E, generator=g) * 0.02)
        for l in range(cfg.num_layers):
            wx = nn.init.xavier_uniform_(torch.empty(E if l == 0 else H, 4 * H), generator=g)
            wh = nn.init.orthogonal_(torch.empty(H, 4 * H), generator=g)
            setattr(self, f"lstm{l}_wx", nn.Parameter(wx))
            setattr(self, f"lstm{l}_wh", nn.Parameter(wh))
            setattr(self, f"lstm{l}_b", nn.Parameter(torch.zeros(4 * H)))
        self.w_out = nn.Parameter(nn.init.xavier_uniform_(torch.empty(H, V), generator=g))
        self.b_out = nn.Parameter(torch.zeros(V))

    def layer(self, l: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(wx, wh, b) of LSTM layer ``l``."""
        return (getattr(self, f"lstm{l}_wx"), getattr(self, f"lstm{l}_wh"),
                getattr(self, f"lstm{l}_b"))

    def init_state(self, batch: int) -> LMState:
        shape = (self.cfg.num_layers, batch, self.cfg.hidden_dim)
        zeros = torch.zeros(shape, device=self.embed.device)
        return LMState(h=zeros, c=zeros.clone())

    def step(self, y_prev: torch.Tensor, state: LMState) -> tuple[torch.Tensor, LMState]:
        """One LM step: y_prev (B,) -> (logits (B, V), new state)."""
        x = self.embed[y_prev.long()]
        hs, cs = [], []
        for l in range(self.cfg.num_layers):
            wx, wh, b = self.layer(l)
            gates = x @ wx + state.h[l] @ wh + b
            i, f, g, o = torch.chunk(gates, 4, dim=-1)
            c_new = torch.sigmoid(f + 1.0) * state.c[l] + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            hs.append(h_new)
            cs.append(c_new)
            x = h_new
        logits = hs[-1] @ self.w_out + self.b_out
        return logits, LMState(torch.stack(hs), torch.stack(cs))

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        """Teacher-forced forward: inputs (B, U) -> logits (B, U, V)."""
        state = self.init_state(inputs.shape[0])
        outs = []
        for u in range(inputs.shape[1]):
            logits, state = self.step(inputs[:, u], state)
            outs.append(logits)
        return torch.stack(outs, dim=1)


def lm_step_logp(model: CharRNNLM, y_prev: torch.Tensor,
                 state: LMState) -> tuple[torch.Tensor, LMState]:
    """log P(. | prefix) (B, V) float32 and the new state, for fusion loops."""
    logits, new_state = model.step(y_prev, state)
    return torch.log_softmax(logits.float(), dim=-1), new_state


class HostRNNLM:
    """A ``.score(prefix, c)`` adapter with ``BackoffLM``'s interface over a
    ``CharRNNLM``, for the host oracle (``decoding/prefix_beam_ref.py``):
    the LM primed with ``sos_id``, then stepped along the prefix; each
    prefix's log-probs and state are cached."""

    def __init__(self, model: CharRNNLM, sos_id: int) -> None:
        self.model, self.sos_id = model, sos_id
        self._cache: dict[tuple, tuple] = {}

    @torch.no_grad()
    def _logp_state(self, prefix: tuple):
        # A walk from the longest cached ancestor (recursion would pass the
        # stack's depth on utterance-length prefixes).
        n = len(prefix)
        while n > 0 and prefix[:n] not in self._cache:
            n -= 1
        dev = self.model.embed.device
        if n == 0 and () not in self._cache:
            logp, state = lm_step_logp(self.model, torch.full((1,), self.sos_id, device=dev),
                                       self.model.init_state(1))
            self._cache[()] = (logp[0].cpu().numpy(), state)
        for i in range(n, len(prefix)):
            _, state = self._cache[prefix[:i]]
            logp, state = lm_step_logp(self.model, torch.full((1,), prefix[i], device=dev), state)
            self._cache[prefix[:i + 1]] = (logp[0].cpu().numpy(), state)
        return self._cache[prefix]

    def score(self, ctx, c: int) -> float:
        logp, _ = self._logp_state(tuple(int(x) for x in ctx))
        return float(logp[c])
