"""Streaming (online) recognition with a carried state (counterpart of
``pytorch_asr_tpu.decoding.streaming``): greedy mode, and beam mode with no
LM, a dense n-gram table, the hashed n-gram LM or the char RNN LM.

It runs the same weights as the offline model, provided the model was built
streaming-capable: ``model.encoder.bidirectional=false`` and
``model.encoder.causal_conv=true`` (output frame t reads input frames <= t
only), and ``frontend.normalize=false`` (per-utterance CMVN reads the whole
utterance).  Each step consumes one block of ``block_frames`` 10 ms frames
and carries, on the device, in a ``StreamState``:

  * each conv layer's last ``kt-1`` input frames: the frames its causal left
    padding covers, so a block's conv outputs are the offline ones;
  * each LSTM layer's (h, c);
  * greedy mode: the last valid frame's argmax (blank included), so the
    greedy collapse runs across blocks; beam mode: the prefix beam search's
    ``BeamState`` (every beam's tokens, (p_blank, p_nonblank), LM score,
    hash, dense-LM context or the hashed LM's window of its last order - 1
    ids, and last char) and, with the RNN LM, each beam's ``LMCarry``.

A step is K1 (``ops/stft_cuda.py``: a block's log-mel is the offline
frontend's over the same samples), the frame mask, the conv stack with its
re-mask (cuDNN, as offline), one ``lstm_cuda.lstm_seq_stream`` a layer (K2
from the carried (h, c), handing its state on), the CTC head, then the
cross-block greedy collapse, or in beam mode the log-softmax, each frame's
top-A chars where ``ext_top_a`` asks for them, and one launch of a search
kernel's carried form (``decoding/prefix_beam.py::
prefix_beam_continue_best``: K7, K8 (either with the hashed tables read in the
kernel) or K9 from the carried beams over the block's valid frames, handing
the beams on and giving the best one's tokens). On the CPU the wrappers take
their plain versions.  Raw samples wait in a numpy buffer on the host; a block
makes one host-to-device copy of its samples and one device-to-host copy of
its token ids, as in JAX.

Parity contract: feeding an utterance chunk by chunk gives the tokens of the
offline model and ``greedy_ctc`` over the whole waveform, or in beam mode
of the offline ``prefix_beam_search`` over the blocks' logits.  On the card
K1's frames, K2's steps and the search's frames do not depend on where
blocks start; the convs may (cuDNN can pick another algorithm for a block
than for the utterance), and so may the head's GEMM (a block's rows summed
in another order than the utterance's).  Beam mode emits each block's full
best prefix, which may revise earlier output.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_asr_tpu_torch.configs.base import BiLSTMEncoderConfig, ExperimentConfig
from pytorch_asr_tpu_torch.decoding import prefix_beam
from pytorch_asr_tpu_torch.models.asr_model import ASRModel
from pytorch_asr_tpu_torch.models.encoder_bilstm import conv_out_len_causal
from pytorch_asr_tpu_torch.models.lm_rnn import CharRNNLM
from pytorch_asr_tpu_torch.ops import stft_cuda

@dataclasses.dataclass
class StreamState:
    """The carried state of one batch of live streams, on the model's device."""

    conv_ctx: tuple[torch.Tensor, ...]   # per conv layer: (B, kt-1, F_l, C_l) float32
    lstm_h: tuple[torch.Tensor, ...]     # per LSTM layer: (B, H) float32
    lstm_c: tuple[torch.Tensor, ...]     # per LSTM layer: (B, H) float32
    prev_tok: torch.Tensor               # (B,) int64: the last valid frame's argmax, -1 first
    beam: prefix_beam.BeamState | None = None     # beam mode's carried search
    lm_carry: prefix_beam.LMCarry | None = None   # its RNN LM's state, each beam's


def _check_streamable(cfg: ExperimentConfig) -> BiLSTMEncoderConfig:
    enc = cfg.model.encoder
    if enc.kind != "bilstm":
        raise ValueError("streaming supports the conv+LSTM encoder only")
    if enc.bidirectional:
        raise ValueError("streaming needs encoder.bidirectional=false "
                         "(a backward LSTM reads the future)")
    if not enc.causal_conv:
        raise ValueError("streaming needs encoder.causal_conv=true "
                         "(symmetric conv padding reads the future)")
    if cfg.frontend.normalize:
        raise ValueError("streaming needs frontend.normalize=false "
                         "(per-utterance CMVN is non-causal)")
    return enc


def init_stream_state(cfg: ExperimentConfig, batch_size: int,
                      device: str | torch.device = "cpu", beam: bool = False,
                      rnn_lm: CharRNNLM | None = None, sos_id: int | None = None,
                      hash_lm=None) -> StreamState:
    """Zeros: the causal left padding and the zero initial LSTM state of the
    offline model.  ``beam``: the search's initial beams
    (``cfg.decode.beam_size`` beams of ``cfg.decode.max_decode_len``
    tokens; with ``hash_lm``, windows of its order - 1 ids, all 0) and, with
    ``rnn_lm``, every beam's LM state primed with ``sos_id``."""
    enc = _check_streamable(cfg)
    beam_state = lm_carry = None
    if beam:
        beam_state = prefix_beam.prefix_beam_init(
            batch_size, cfg.decode.beam_size, cfg.decode.max_decode_len, device,
            ctx_width=hash_lm.order - 1 if hash_lm is not None else 0)
        if rnn_lm is not None:
            if sos_id is None:
                raise ValueError("rnn_lm streaming fusion needs sos_id")
            lm_carry = prefix_beam.rnn_lm_carry_init(rnn_lm, batch_size, cfg.decode.beam_size,
                                                     sos_id)
    kt, kf = enc.conv_kernel
    sf = enc.conv_stride[1]
    pf = (kf - 1) // 2
    conv_ctx = []
    freq, chans = cfg.frontend.n_mels, 1
    for ch in enc.conv_channels:
        conv_ctx.append(torch.zeros((batch_size, kt - 1, freq, chans), device=device))
        freq = (freq + 2 * pf - kf) // sf + 1
        chans = ch
    zeros = lambda: torch.zeros((batch_size, enc.hidden_dim), device=device)  # noqa: E731
    return StreamState(conv_ctx=tuple(conv_ctx),
                       lstm_h=tuple(zeros() for _ in range(enc.num_layers)),
                       lstm_c=tuple(zeros() for _ in range(enc.num_layers)),
                       prev_tok=torch.full((batch_size,), -1, dtype=torch.long, device=device),
                       beam=beam_state, lm_carry=lm_carry)


def _conv_chunk(x: torch.Tensor, ctx: torch.Tensor, conv: torch.nn.Conv2d, pf: int):
    """Causal conv over [carried ctx | new frames] -> (y, new ctx).

    x (B, C, n, F) in the compute dtype, ctx (B, kt-1, F, C) float32.  Time
    is unpadded: the ctx is the left padding, so the outputs equal the
    offline left-padded conv's at the same positions.  The new ctx is the
    last kt-1 input frames."""
    dt = x.dtype
    inp = torch.cat([ctx.permute(0, 3, 1, 2).to(dt), x], dim=2)
    y = F.relu(F.conv2d(inp, conv.weight.to(dt), conv.bias.to(dt), stride=conv.stride,
                        padding=(0, pf)))
    kt = ctx.shape[1]
    return y, inp[:, :, inp.shape[2] - kt:].permute(0, 2, 3, 1).float()


def _stream_step(model: ASRModel, cfg: ExperimentConfig, state: StreamState,
                 samples: torch.Tensor, n_frames: int, fusion: dict | None = None):
    """One block: samples (B, (block_frames-1)*hop + win) float32 -> (new
    state, ids (B, T') left-packed, n_ids (B,)); ``n_frames`` of the block's
    frames are valid.  Beam mode (``state.beam`` set): ids are the best
    beam's tokens (B, L) and n_ids its lengths, ``fusion`` the search's
    keywords (its LM source, weights and ``ext_top_a``)."""
    enc = cfg.model.encoder
    kt, kf = enc.conv_kernel
    pf = (kf - 1) // 2
    B = samples.shape[0]
    dev = samples.device

    feats = stft_cuda.stft_log_mel(samples, cfg.frontend)             # (B, T, n_mels)
    lengths = torch.full((B,), n_frames, dtype=torch.int32, device=dev)
    fmask = torch.arange(feats.shape[1], device=dev)[None, :] < lengths[:, None]
    feats = torch.where(fmask[..., None], feats, 0.0)

    x = feats[:, None].to(model.compute_dtype)                       # (B, 1, T, F)
    new_ctx = []
    for conv, ctx in zip(model.encoder.conv.convs, state.conv_ctx):
        x, ctx = _conv_chunk(x, ctx, conv, pf)
        new_ctx.append(ctx)
        lengths = conv_out_len_causal(lengths, kt, enc.conv_stride[0])
        # Re-mask, as the offline ConvSubsampler: bias + relu make padded
        # frames nonzero.
        mask = torch.arange(x.shape[2], device=dev)[None, :] < lengths[:, None]
        x = torch.where(mask[:, None, :, None], x, 0.0)
    _, C, T, Fq = x.shape
    x = x.permute(0, 2, 3, 1).reshape(B, T, Fq * C)

    new_h, new_c = [], []
    for layer, h0, c0 in zip(model.encoder.layers, state.lstm_h, state.lstm_c):
        x, h, c = layer["fwd"].stream(x, lengths, h0, c0)
        new_h.append(h)
        new_c.append(c)
    logits = model.ctc_logits(x)                                     # (B, T, V) float32

    if state.beam is not None:
        # The carried prefix beam: one launch of a search's carried form.
        beam, lm_carry, (toks, n_ids, _) = prefix_beam.prefix_beam_continue_best(
            state.beam, torch.log_softmax(logits, dim=-1), lengths, lm_carry=state.lm_carry,
            **(fusion or {}))
        return (StreamState(tuple(new_ctx), tuple(new_h), tuple(new_c), state.prev_tok, beam,
                            lm_carry), toks, n_ids)

    # The greedy collapse across blocks, left-packed without a host sync.
    best = logits.argmax(dim=-1)
    t = torch.arange(T, device=dev)[None, :]
    vmask = t < lengths[:, None]
    prev = torch.cat([state.prev_tok[:, None], best[:, :-1]], dim=1)
    keep = (best != 0) & (best != prev) & vmask
    pos = torch.cumsum(keep, dim=1) - 1
    n_ids = pos[:, -1] + 1
    out = torch.zeros_like(best).scatter_reduce_(
        1, torch.where(keep, pos, T - 1), torch.where(keep, best, 0), "amax")
    out = torch.where(t < n_ids[:, None], out, 0)
    # The last valid frame's argmax, blank included; held over a block with
    # no valid frame.
    last = torch.clamp(lengths - 1, min=0).long()
    new_prev = torch.where(lengths > 0, best[torch.arange(B, device=dev), last], state.prev_tok)
    return (StreamState(tuple(new_ctx), tuple(new_h), tuple(new_c), new_prev), out, n_ids)


class StreamingRecognizer:
    """Batched online recognizer over a streaming-capable CTC model.

    Usage:
        rec = StreamingRecognizer(model, cfg, batch_size=B)
        for chunk in audio_chunks:          # (B, any_samples) float32
            new = rec.accept(chunk)         # list[B] of token-id lists
        new = rec.finish()                  # drain buffered frames

    It runs on the model's device (the card, unless the model is on the
    CPU).  ``block_frames`` frames of 10 ms make a step; it must be a
    multiple of the conv's time subsampling (default 16 frames = 160 ms).
    Greedy mode returns each stream's new ids.  ``mode="beam"`` runs the
    prefix beam search at ``cfg.decode``'s beam and max length across blocks,
    fused with the dense n-gram table ``lm_table`` (n_ctx, V), the hashed
    n-gram LM ``hash_lm`` (a ``decoding.lm_hashed.HashedNgramLM`` on the
    model's device; ``lm_top_k`` prunes its lookups over all chars) or the
    char RNN LM ``rnn_lm`` (a ``CharRNNLM`` on the model's device, primed
    with ``sos_id``), over all chars or each frame's top ``ext_top_a``; each
    block returns every stream's full best prefix so far, which may revise
    earlier output (``finish`` returns it again once finished).
    """

    def __init__(self, model: ASRModel, cfg: ExperimentConfig, batch_size: int,
                 block_frames: int = 16, mode: str = "greedy",
                 lm_table: torch.Tensor | None = None, rnn_lm: CharRNNLM | None = None,
                 lm_alpha: float = 0.0, lm_beta: float = 0.0, sos_id: int | None = None,
                 lm_top_k: int = 0, ext_top_a: int = 0, hash_lm=None):
        if mode not in ("greedy", "beam"):
            raise ValueError(f"unknown streaming mode {mode!r}")
        if mode != "beam" and (lm_table is not None or hash_lm is not None
                               or rnn_lm is not None):
            raise ValueError("LM fusion requires mode='beam'")
        prefix_beam._check_sources(0, hash_lm, lm_table, rnn_lm)
        enc = _check_streamable(cfg)
        total_stride = enc.conv_stride[0] ** len(enc.conv_channels)
        if block_frames % total_stride:
            raise ValueError(f"block_frames must be a multiple of the conv "
                             f"time subsampling ({total_stride})")
        self.model = model.eval()
        self.cfg = cfg
        self.mode = mode
        self.sos_id = sos_id
        self.fusion = dict(lm_table=lm_table, hash_lm=hash_lm, rnn_lm=rnn_lm,
                           lm_alpha=float(lm_alpha),
                           lm_beta=float(lm_beta), lm_top_k=int(lm_top_k),
                           ext_top_a=int(ext_top_a))
        self.device = model.ctc_head.weight.device
        self.block_frames = block_frames
        self.batch_size = batch_size
        fe = cfg.frontend
        self._need = (block_frames - 1) * fe.hop_length + fe.win_length
        self._advance = block_frames * fe.hop_length
        self.reset()

    def reset(self) -> None:
        self.state = init_stream_state(self.cfg, self.batch_size, device=self.device,
                                       beam=self.mode == "beam", rnn_lm=self.fusion["rnn_lm"],
                                       sos_id=self.sos_id, hash_lm=self.fusion["hash_lm"])
        self._buf = np.zeros((self.batch_size, 0), np.float32)
        self._finished = False
        self._best: list[list[int]] = [[] for _ in range(self.batch_size)]

    def _run_block(self, samples: np.ndarray, n_frames: int) -> list[list[int]]:
        with torch.inference_mode():
            self.state, ids, n = _stream_step(
                self.model, self.cfg, self.state,
                torch.from_numpy(np.ascontiguousarray(samples)).to(self.device), n_frames,
                self.fusion)
            got = torch.cat([ids, n[:, None].to(ids.dtype)], dim=1).cpu().numpy()
        return [got[b, :got[b, -1]].tolist() for b in range(self.batch_size)]

    def _empty(self) -> list[list[int]]:
        return [[] for _ in range(self.batch_size)] if self.mode == "greedy" else self._best

    def accept(self, chunk: np.ndarray) -> list[list[int]]:
        """Feed (B, S) new samples; returns the newly decoded ids per stream
        (beam mode: the full best prefix after the last block this call ran,
        or empty lists if it ran none)."""
        if self._finished:
            raise RuntimeError("stream finished; call reset()")
        chunk = np.asarray(chunk, np.float32)
        if chunk.ndim != 2 or chunk.shape[0] != self.batch_size:
            raise ValueError(f"expected ({self.batch_size}, S) chunk")
        self._buf = np.concatenate([self._buf, chunk], axis=1)
        out = [[] for _ in range(self.batch_size)]
        while self._buf.shape[1] >= self._need:
            got = self._run_block(self._buf[:, :self._need], self.block_frames)
            self._buf = self._buf[:, self._advance:]
            if self.mode == "beam":
                self._best = out = got
            else:
                for b in range(self.batch_size):
                    out[b].extend(got[b])
        return out

    def finish(self) -> list[list[int]]:
        """Drain the whole frames still in the buffer (the offline framing
        drops a tail shorter than one window, so this does too)."""
        if self._finished:
            return self._empty()
        self._finished = True
        fe = self.cfg.frontend
        n_samples = self._buf.shape[1]
        n_frames = max(0, (n_samples - fe.win_length) // fe.hop_length + 1)
        if n_frames == 0:
            return self._empty()
        samples = np.zeros((self.batch_size, self._need), np.float32)
        samples[:, :n_samples] = self._buf
        got = self._run_block(samples, n_frames)
        if self.mode == "beam":
            self._best = got
        return got
