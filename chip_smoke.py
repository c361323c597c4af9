"""Chip smoke test of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases, each of which must pass (any failure exits non-zero before the
result line):
  1. print the card (``nvidia-smi`` name and power limit) and the versions;
     build the CUDA kernels from ``pytorch_asr_tpu_torch/csrc`` (set-up);
  2. hold each kernel against its plain PyTorch version at the full shapes
     of the serving and training paths: the STFT log-mel (K1), the LSTM
     inference forward (K2), the LSTM training forward and backward (K3)
     and the CTC alpha and beta recursions (K4); time kernel, plain version
     and a PyTorch library yardstick with CUDA events (median of repeated
     runs of queued calls, after warm-up); K2 also at config 2's layer
     shape; print the co-resident grid of K2's and K3's forward recurrence
     and its µs a step (profiler), and sweep the grid's CTAs; K1 and K4 and
     their library calls are timed in turns, with K1's and K4's phase
     splits from their traces;
  3. run the model at float32 on one synthetic batch on the CPU and on the
     card with the same seeded weights; compare logits and greedy tokens;
     then one float32 train step, card vs CPU: loss, gradients, and the
     parameters after one AdamW step;
  4. drive the serving path, ``pytorch_asr_tpu_torch.decode.main``, and the
     training path, ``pytorch_asr_tpu_torch.train.main``, with
     ``ctc_bilstm_dev1h`` at full width in bf16 on 10-16 s utterances, each
     with the launch counters set to 0 just before and read just after;
  5. train the tiny config of the JAX package's end-to-end test to a low
     WER on the card, then beam-decode it with the LM: no worse than greedy;
  6. profile one decode batch and one train step: device time by kernel;
  7. config 2's serving path, ``ctc_bilstm_beam_lm``: build a 4-gram LM with
     the port's ``train_ngram`` (set-up); hold the prefix beam search kernels
     K7 and K8 against the plain search on the card at the path's shapes
     (planted and model log-probs, with and without the LM) and time them,
     printing block 0's frame split;
     drive ``decode.main`` with ``decode.lm_path`` at full width, once over
     all chars (K7) and once with ``decode.ext_top_a=8`` (K8), counting
     launches; profile one of its batches;
  8. config 2 with the char RNN LM: train the LM at its default widths
     (E 128, H 256, 2 layers) with the port's ``train_lm`` on the card
     (set-up); hold K9, the search fused with the LM, against the plain
     search on the card over all chars and the top 8 (config 2's model
     logits for 16 utterances of 10-16 s with each row's transcript
     planted, one row of no frames) on its co-resident grid and time it in
     turns with its block kernel, printing CTA 0's frame split and the LM
     steps a frame; drive ``decode.main`` with
     ``decode.lm_path=<lm.npz>`` at full width, once over all chars and once
     with ``decode.ext_top_a=8``, counting launches (the grid once a batch,
     the block kernel never); beam-decode the
     learned tiny model with the RNN LM; profile one of its batches;
  9. config 3, ``tcn_ctc_devclean``: hold the TCN block kernels, K5 and the
     K6 forward and backward (every product 3xTF32 on the tensor cores; two
     calls bit-equal), against their plain versions at B 16, T' 400 and a
     ragged 397, C 384, K 5, every dilation of the cycle, and K5 on bf16
     input, and time them beside a composite of torch calls (each with its
     3xTF32 and fp32 bounds); run the
     model and one train step at float32 on the CPU and on the card; drive
     ``decode.main`` (prefix beam K 16, no LM, its 14-bucket decode ladder)
     and ``train.main`` (batch 16, one bucket) at full width in bf16 with
     launch counts; profile one decode batch and one train step (no SIMT
     ``gemm_kernel`` in either);
  10. config 2's beam decode across ranks: hold K10, the beam-sharded
     search's per-frame merge and top-K, against the plain merge on the card
     bit for bit (candidates of 2 and 4 beam shards at config 2's shapes,
     with and without the 4-gram, early and late frames) and time it, with
     block 0's phase split; K9 past a block's shared memory (an LM of H 512
     x 2 layers, and beam 32);
     the wide routes, which no configuration reaches: config 1 at
     ``model.encoder.hidden_dim=1536`` (past the co-resident grid) through
     ``decode.main`` and one step of ``train.main`` on the per-utterance
     LSTM kernel, a beam-400 search and K9 at beam 64 (past a block), and
     K13 at beam 32 with max_len 1024 and K12 at beam 32 over 1024 chars
     (past a block: the study kernels' in-scratch form), K10 at beam 640
     (its in-scratch form), K9 with an LM of 10 layers, K4 past its
     registers (the CTC loss and its gradient at S 4097 and 20001, and the
     paired alpha at S 4097 with ``PAIRED_FWD``: the lattice rows in device
     memory) and K1's DFT form (``decode.main`` at ``frontend.n_fft`` 400
     and 2048), each with its own counts and held to the plain version on
     the card;
     then ``decode.main ... decode.shard_beams=true`` in ranks spawned on
     the one card over gloo, each with its launch counters set to 0 just
     before and read just after: 2 ranks at model axis 2 and 4 ranks at
     data 2 x model 2 with the 4-gram (hypotheses equal to the one-rank
     decode's), 4 ranks at model axis 4 with the RNN LM; and the sharded
     search with the RNN LM in 4 ranks against the plain search;
  11. the last four kernels, none of which a model path runs: K11, both
     directions of a BiLSTM layer in one launch (its forward on the dual
     grid, and its backward's dh recurrence on the dual backward grid), at
     config 1's layer shape (inference, and training forward and backward)
     and config 2's (inference), bit-equal to two K2 (K3) launches and to
     the per-utterance oracles, its gradients within K3's tolerances, timed
     beside them (the backward in turns), the oracles and cuDNN's
     bidirectional LSTM, with both dual grids' step splits and a sweep of
     32, 48 and 64 CTAs a direction, then driven through
     ``lstm_cuda.bilstm_seq`` with counts (no oracle launch, no plain
     version); the paired CTC
     alpha at K4's shape against its plain version and K4 and bit for bit
     against its wide form, timed in turns with K4's alpha and its library
     call, with its pair's phase split (its trace), then
     ``train.main`` with ``ops.ctc_cuda.PAIRED_FWD`` set, with counts; K13
     and K12, the search with its tokens in the block and the search as a
     launch a frame, bit for bit against the plain search at K7's shape and
     at the scripts' (K12's pointers and state too), timed in turns beside
     K7 at both shapes, with block 0's frame split (their traces) and K12's
     launch share of a frame (event time less device time); then
     the ported benchmark scripts
     ``bench_prefix_beam fused=1`` and ``bench_beam_compile stepwise=1`` at
     their default widths, with counts;
  12. configs 4 and 5, ``las_attention`` and ``joint_ctc_attention_960h``:
     at full width and float32 on a short batch, card vs CPU: the CTC and
     teacher-forced decoder logits, the attention search (and config 5's
     joint search), and one train step (loss, gradients, parameters after
     AdamW); ``decode.main`` at full width in bf16 (config 4: attention
     beam 8, 4 batches on its decode ladder; config 5: joint beam 16, 1
     batch of 32) and ``train.main`` (20 steps of 16 and of 32, config 5
     with waveform augmentation), each with launch counts (config 4's
     training launches no K4) and no plain STFT, LSTM or CTC call on the
     card; the tiny joint model of the JAX package's end-to-end test
     learning on the card, then decoded by both searches; K2 and K3 at
     both configs' layer shapes and K4 at config 5's, against their plain
     versions; at the end, a config-4 decode batch split between the
     encoder, the decoder steps and the rest (and profiled), the same split
     of a config-5 batch with its CTC prefix scorer, and a profiled config-5
     train step;
  13. slice 20, config 1's widths made streaming-capable (``CAUSAL``: a
     causal conv and a unidirectional stack of H 384 x 3): K2 from a carried
     state (``lstm_seq_stream``) at the streaming step's shapes against its
     plain version, its chunks bit-equal to one K2 launch, its wide form bit
     for bit, timed beside cuDNN's LSTM with ``hx``; the greedy streaming
     recognizer at full width, B 8 streams of 16 s in 1600-sample chunks,
     blocks of 16 and 48 frames, against the offline greedy decode on the
     card, with exact launches a block (one K1, three ``lstm_seq_stream``),
     no plain version on the card, and its latency a block and RTF at B 1
     and 8; ``decode.main`` and ``train.main`` of the causal model with
     exact counts; ``ctc_forced_align`` card vs CPU and ``align.main`` over
     config 1; the recognizer at H 1536 (the wide form);
  14. slice 21, streaming beam mode: the carried forms of K7, K8 and K9
     (a chunk of a stream from a ``BeamState``) at the stream's block shape
     (logp (8, 4, 31), K 16, L 256) against the plain carried search on
     planted log-probs over 12 blocks, timed beside it, and K7's
     in-scratch and K9's block forms once each; the beam recognizer on
     config 2's settings made causal (H 512 x 4, bf16), B 8 streams of 16
     s, blocks of 16 and 48 frames, with no LM, the 4-gram (all chars and
     the top 8) and the RNN LM (both), each block exactly one K1, four
     ``lstm_seq_stream`` and one carried search, no plain version, its
     beams and best equal to the same kernel's over the blocks' logits bit
     for bit, its latency a block and RTF at B 1 and 8, one profiled run;
     and the ported ``bench_streaming`` script briefly;
  15. slice 22, BPE and the hashed n-gram LM: the port's ``train_bpe`` vocab
     (V 135) and a KN 4-gram over its pieces (set-up); the hashed K7 and K8
     against the plain hashed search on the card, tokens, lengths and scores
     bit for bit, at config 2's BPE shape (16, 400, 135) and at the bench
     script's BPE scale (its synthetic 3-gram at V 1024: K7 in scratch, all
     chars and ``lm_top_k`` 128, K8 over the top 128), each timed with its
     bound (the distinct bucket rows the data needs); ``decode.main`` of
     config 2 with ``data.vocab=bpe:`` over all pieces and at
     ``ext_top_a=8``: exactly one hashed K7 (K8) a batch, no ``_wide`` form,
     no plain search; the decode across 2 ranks (K10's window form, held to
     the plain merge on every pick); the hashed carried forms against the
     plain carried search, and the beam recognizer with the hashed LM bit
     for bit against the kernel over its blocks' logits; the tiny BPE model
     of the JAX package's end-to-end test trained and hashed-beam-decoded
     (WER <= greedy + 0.3); one profiled BPE decode batch;
  16. slice 23, the file-backed data path: a LibriSpeech-layout FLAC tree
     (64 utterances of 10-16 s over train-clean-100/360 and train-other-500,
     16 in dev-clean; two LPC files, a 24-bit and a stereo one; transcripts
     upper case) written by the port's ``write_flac`` on a process pool;
     every file's native decode (``native.py``) bit for bit the numpy
     decoder's float32 of the encoded PCM, and the numpy decoder itself on
     one file of each kind, each route's host time per audio second;
     ``train.main`` of config 1 on ``train-960`` (20 steps, eval on
     dev-clean every 10, the TensorBoard mirror held to the JSONL records
     where tensorboard imports, else its refusal), every file on the native
     route, with exact counts, its audio s/s beside the synthetic run's and
     the stream's wait a step; the resume to step 30 from the step-20
     checkpoint (its first batch the 21st of a fresh stream, by digest);
     config 5's 4 steps on its own splits and header ladder; ``decode.main``
     and ``align.main`` reading dev-clean; ``train.remat_encoder`` at
     configs 1 and 3, on and off bit for bit (cuDNN deterministic), K3's
     (K6's) training forward launched twice as often, peak memory of each;
  17. check that no path launched the per-utterance oracle or took a wide
     route; print the kernels line, the card line, and ``{"ok": true, ...}``
     last.
Whether it passes or fails, the script ends every process it started (the
ranks, multiprocessing's resource tracker, and anything they left) before it
exits.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import json
import math
import multiprocessing
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from multiprocessing import resource_tracker

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_asr_tpu_torch import (align, decode, native, train, train_bpe, train_lm,
                                   train_ngram)
from pytorch_asr_tpu_torch.configs import get_config
from pytorch_asr_tpu_torch.configs.base import (
    BiLSTMEncoderConfig,
    DataConfig,
    DecodeConfig,
    FrontendConfig,
    LASDecoderConfig,
    MeshConfig,
    ModelConfig,
    OptimConfig,
    TrainConfig,
)
from pytorch_asr_tpu_torch.data import (BucketedDataset, bpe, build_dataset,
                                        build_eval_dataset, get_tokenizer)
from pytorch_asr_tpu_torch.data import flac as flac_mod
from pytorch_asr_tpu_torch.data import librispeech, synthetic
from pytorch_asr_tpu_torch.data import stream as stream_mod
from pytorch_asr_tpu_torch.data.synthetic import synthetic_corpus, synthetic_texts
from pytorch_asr_tpu_torch.decoding import (
    attention_beam, ctc_prefix_scorer, driver, lm_hashed, prefix_beam, prefix_beam_sharded,
    streaming)
from pytorch_asr_tpu_torch.decoding import lm as lm_mod
from pytorch_asr_tpu_torch.decoding import align as align_mod
from pytorch_asr_tpu_torch.decoding.greedy import greedy_ctc
from pytorch_asr_tpu_torch.evaluate import build_model, eval_step, model_outputs
from pytorch_asr_tpu_torch.frontend import features
from pytorch_asr_tpu_torch.models import asr_model, encoder_bilstm
from pytorch_asr_tpu_torch.models.encoder_bilstm import set_residual_dtype
from pytorch_asr_tpu_torch.models.lm_rnn import CharRNNLM, RNNLMConfig
from pytorch_asr_tpu_torch.ops import (
    beam_cuda, build, ctc, ctc_cuda, lstm_cuda, stft_cuda, tcn_cuda)
from pytorch_asr_tpu_torch.ops.ce import make_decoder_io
from pytorch_asr_tpu_torch.parallel import distributed, launch
from pytorch_asr_tpu_torch.parallel.mesh import make_mesh, shard_batch_global, use_mesh
from pytorch_asr_tpu_torch.runtime import resolve_device, set_fp32_math
from pytorch_asr_tpu_torch.scripts import (_timing, bench_beam_compile, bench_kernel_turns,
                                           bench_prefix_beam, bench_streaming)
from pytorch_asr_tpu_torch.training import state as train_state
from pytorch_asr_tpu_torch.training.checkpoint import CheckpointManager
from pytorch_asr_tpu_torch.training.metrics import MetricsLogger
from pytorch_asr_tpu_torch.training.trainer import Trainer

# H100 SXM published dense peaks (NVIDIA data sheet), at the 700 W limit.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12          # CUDA cores
PEAK_BF16_S = 989e12         # tensor cores
PEAK_TF32_S = 495e12         # tensor cores
B, AUDIO = 8, 256000         # 8 utterances of 16 s: the serving batch at its longest
T_LSTM, H = 400, 384         # conv output frames of 16 s; ctc_bilstm_dev1h width
# log-mel: the kernel's fp64 FFT against the plain version's fp32 cuFFT,
# whose own error near log_floor (a band's power a small remainder of large
# terms) is up to ~1e-3 in the log; against a float64 DFT the kernel is held
# to fp32 rounding of its power, mel sum and log (a few 1e-6).
STFT_TOL = 2e-3
STFT_EXACT_TOL = 2e-5
LSTM_TOL = 1e-2              # bf16 output: one bf16 step below 1 (2^-8) + fp32 order
SLICE_TOL = 1e-3             # float32 slice, card vs CPU: FFT, conv and dot orders
DECODE_BATCHES = 2           # cut from 4 to hold the script's clock
LAYERS = 3
LSTM_LENGTHS = [T_LSTM, 371, 352, 330, 310, 290, 260, 250]
# K3, relative to each tensor's largest entry.  float32 residuals and
# gradients: 400-step fp32 recurrences and sums over B*T rows taken in other
# orders.  bf16 outputs, residuals and dx / dwih: one bf16 step (2^-8
# relative) where the two sides' fp32 values straddle a rounding boundary.
K3_F32_TOL = 1e-3
K3_BF16_TOL = 1e-2
# K4: float32 log-space recursions, as the JAX package holds its Pallas CTC
# kernels to its scan; alphas are log values of up to ~T' log V.
CTC_RTOL, CTC_ALPHA_ATOL = 1e-5, 1e-4
CTC_GRAD_RTOL, CTC_GRAD_ATOL = 1e-4, 1e-5
V = 31                       # char vocabulary
# One float32 train step at full width, card vs CPU: the slice's FFT, conv
# and dot orders again, through the backward.  Gradients are held relative
# to each tensor's largest entry; after one AdamW step a coordinate moves by
# about lr * sign(g), and where |g| is at float32 noise the two devices may
# move it in opposite directions, so the parameters are held to 2 lr.
# The conv weights see the log-mel directly, and the card's K1 and the CPU's
# fp32 rfft differ by up to STFT_TOL in bands near log_floor: on the CPU a
# one-ulp change of the audio already moves the conv gradients by ~7e-4 of
# their largest entry (H 128, 3 layers), the LSTM ones by ~2e-6.
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_TOL = 1e-4
STEP_CONV_GRAD_TOL = 5e-3
TRAIN_STEPS = 20             # the training main path: steps of full batches of 8
TRAIN_UTTS = 64              # 8 full batches an epoch, and 8 full eval batches
EVAL_BATCHES = 8             # train.main evaluates 8 batches after each chunk
LEARN_STEPS = (10, 290)      # the JAX package's end-to-end test: 300 steps
CARD = torch.device("cuda")
# Config 2's serving path: ctc_bilstm_beam_lm, BiLSTM H 512 x 4 layers,
# batch 16, beam 16, max_len 256, LM alpha 0.5 / beta 1.0; K8 with A = 8.
CFG2, CFG2_LAYERS, BEAM_B, BEAM_K, BEAM_L, BEAM_A = "ctc_bilstm_beam_lm", 4, 16, 16, 256, 8
# The kernel repeats the plain search's float32 operations in their order
# (no FMA on the fusion line): tokens and lengths equal, scores to rounding.
BEAM_RTOL = 1e-5
# Config 2 with the char LSTM LM at RNNLMConfig's default widths (E 128,
# H 256, 2 layers), trained by train_lm on the synthetic texts: 300 steps
# (the CLI's default is 500) keep the run short.
LM_STEPS = 300
# K9's LM products are fp32 sums in another order than torch.matmul's, so
# its scores drift from the plain search's by a few ulps a frame: tokens and
# lengths exact on planted-path logits, scores held as the JAX package holds
# its own K9 on hardware (tests/test_tpu_parity.py).
RNN_RTOL, RNN_ATOL = 2e-3, 1e-3
# Config 3's paths: tcn_ctc_devclean, TCN C 384 x 10 blocks, K 5, dilations
# 1-16, batch 16, prefix beam K 16 without an LM.
CFG3, TCN_B, TCN_T, TCN_RAGGED_T, TCN_C, TCN_K = "tcn_ctc_devclean", 16, 400, 397, 384, 5
TCN_BLOCKS, TCN_DILATIONS = 10, (1, 2, 4, 8, 16)
# K5 and K6 against their plain versions, relative to each tensor's largest
# entry: 3xTF32 sums on the tensor cores against cuBLAS's fp32 blocked sums
# (1e-5-2e-5 at these shapes), held to the JAX package's 2e-4 for its own
# kernel.  K5's
# bf16 output: one bf16 step (2^-8) where the fp32 sums straddle a rounding
# boundary.
TCN_TOL = 2e-4
TCN_BF16_TOL = 1e-2
TCN_TRAIN_UTTS = 64          # 4 full batches of 16 an epoch, and 4 eval batches
# Configs 4 and 5: las_attention (BiLSTM H 512 x 4, the LAS decoder E 256 /
# H 512 / A 256 with 31 x 32 location filters, batch 16, attention beam 8)
# and joint_ctc_attention_960h (H 640 x 5, the same decoder, batch 32, joint
# beam 16 at CTC weight 0.3, waveform augmentation); both decode up to 256
# steps.  Config 4 serves 4 batches on its 14-bucket decode ladder, config 5
# 1 full batch of 32 (cut from 2 to hold the script's clock).
CFG4, CFG4_B, CFG5, CFG5_B = "las_attention", 16, "joint_ctc_attention_960h", 32
LAS_DECODE_BATCHES, JOINT_DECODE_BATCHES = 4, 1
# Card vs CPU at float32: full width, one batch of LAS_UTTS utterances of at
# most LAS_MAX_SEC s, the cut that keeps the CPU side's searches short.
LAS_UTTS, LAS_MAX_SEC = 4, "4"
# A search's rows whose best final score leads the runner-up by more than
# LAS_MARGIN give the same tokens on both devices; final scores within
# LAS_SCORE_RTOL (float32 products summed in other orders over 256 steps).
# The seeded output rows scaled by LAS_SHARPEN before the searches make rows
# decisive: at the initialiser's scale the attention searches' rows led by
# 2e-7 to 6e-5 on the H100 machine's CPU; at 96 by 1.2e-4 to 5e-3, with the
# card's scores within 9e-6 of the CPU's, relative.  Each search must have
# at least one decisive row.
LAS_MARGIN, LAS_SCORE_RTOL, LAS_SHARPEN = 1e-4, 1e-4, 96.0
LAS_TRAIN_UTTS = 64          # 4 full batches of 16 (config 4), 2 of 32 (config 5)
LEARN_JOINT_STEPS = (10, 240)  # the JAX package's joint end-to-end test: 250 steps
# The searches' decoder steps and CTC prefix scorer calls, counted and timed
# on the decode paths (``timed_calls``).
SEARCH_CALLS = ((asr_model.ASRModel, "decoder_step"), (ctc_prefix_scorer, "score_extensions"))
# The paired CTC alpha against K4: the JAX study's tolerances for its paired
# kernel (tests/test_ctc_pallas.py), the composed step summing in another
# order; its main path, train.main with PAIRED_FWD set: a few full steps.
PAIRED_LOSS_TOL, PAIRED_GRAD_TOL = 1e-4, 2e-3
PAIRED_STEPS, PAIRED_UTTS = 4, 32
# Config 2 across ranks: 1 decode batch a run (each rank decodes its rows of
# it; cut from 2 to hold the script's clock); K10 is checked at
# frames 0 and 1 (most beams dead) and 150.
SHARD_BATCHES, MERGE_FRAMES = 1, (0, 1, 150)
RANK_TIMEOUT = 300.0         # a spawned decode: ~8 s to the card, then its work
# A SIMT GEMM's kernel by its exact name (``lstm_seq.cu``'s projection
# GEMM, or the TCN forward's before it moved onto ``tc_gemm_kernel``), in
# the profiler's demangled names; ``tc_gemm_kernel`` does not match.
SIMT_GEMM = re.compile(r"(^|[^\w])gemm_kernel<")
# The wide routes: config 1 at H 1536, past the co-resident grid (the
# per-utterance LSTM kernel), and searches past a block's shared memory (the
# beam kernels' in-scratch form): K7 at beam 400, K9 at beam 64 with an LM
# of H 512 (WIDE_LM); and K9's block form, past its grid.  No main path
# takes any of them.
WIDE_H, WIDE_SEARCH_BEAM, WIDE_RNN_BEAM = 1536, 400, 64
# K13 at beam 32 with max_len 1024 (token buffers of 256 KB a block) and K12
# at beam 32 over 1024 chars (frame arrays of ~420 KB), on T_WIDE_STUDY
# frames: past a block's shared memory, so the study kernels' in-scratch form.
WIDE_STUDY_BEAM, WIDE_STUDY_L, WIDE_STUDY_V, T_WIDE_STUDY = 32, 1024, 1024, 200
WIDE_ROUTES = ("lstm_seq_wide", "lstm_seq_train_wide", "lstm_seq_bwd_wide", "bilstm_seq_wide",
               "bilstm_seq_train_wide", "bilstm_seq_bwd_wide", "lstm_seq_stream_wide",
               "merge_topk_wide",
               "prefix_beam_wide", "prefix_beam_topa_wide",
               "prefix_beam_rnn_wide", "prefix_beam_rnn_topa_wide", "prefix_beam_rnn_block",
               "prefix_beam_rnn_topa_block", "prefix_beam_carry_wide",
               "prefix_beam_topa_carry_wide", "prefix_beam_rnn_carry_block",
               "prefix_beam_rnn_topa_carry_block", "prefix_beam_rnn_carry_wide",
               "prefix_beam_rnn_topa_carry_wide", "prefix_beam_fused_wide",
               "prefix_beam_stepwise_wide",
               "ctc_alpha_wide", "ctc_beta_wide", "ctc_alpha_paired_wide", "stft_log_mel_dft")
# K9 past shared memory: an LM of H 512 x 2 layers (random weights from a
# seed) at beam 16, and the trained default LM at beam 32.
WIDE_LM, WIDE_BEAM = RNNLMConfig(embed_dim=128, hidden_dim=512, num_layers=2), 32
# K10 past a block's shared memory: beam 640 over the 30 lanes of config 2's
# chars (N 19,840 candidates, 262,912 bytes a block), from 2 shards at frame
# 9; and K9 with an LM of 10 layers (E 32, H 64), past the 8 it once held.
WIDE_MERGE_BEAM, WIDE_MERGE_FRAME = 640, 9
DEEP_LM = RNNLMConfig(embed_dim=32, hidden_dim=64, num_layers=10)
# K4 past its registers (S > 4096): 3 rows (a row of no frames, an infeasible
# row) of S 4097 and 20001 over 30 chars, in frames enough for row 0's
# labels and their repeats; K1's DFT form at two n_fft with no FFT plan.
WIDE_CTC_CASES = ((3, 2300, 30, 2048), (3, 12000, 30, 10000))
WIDE_N_FFT = (400, 2048)
# Slice 20: config 1's widths made streaming-capable, through the CLIs'
# overrides (JAX's _check_streamable asks for exactly these): a causal conv
# and a unidirectional stack of H 384 x 3.
CAUSAL = ("model.encoder.bidirectional=false", "model.encoder.causal_conv=true",
          "frontend.normalize=false")
# The greedy streaming recognizer: B 8 streams of 16 s (structured audio for
# the first 10-16 s, noise after), fed in 1600-sample chunks, in blocks of 16
# and 48 frames (4 and 12 steps of K2 a layer); also B 1 for the latency.
STREAM_B, STREAM_SEC, STREAM_CHUNK, STREAM_BLOCKS = 8, 16, 1600, (16, 48)
# lstm_seq_stream's chunks (of 4 and 12 steps) and its wide form at H 1536.
STREAM_KERNEL_CHUNKS, STREAM_KERNEL_D = 5, 640
# Slice 21: streaming beam mode on config 2's settings made streaming-capable
# (CAUSAL: conv (32, 32), H 512 x 4 in one direction, V 31, bf16; beam 16,
# max_len 256, alpha 0.5, beta 1.0): five arms {name: (fusion source,
# ext_top_a)} over the 4-gram table or the RNN LM, B 8 streams in blocks of
# 16 and 48 frames (4 and 12 search frames), and B 1 in blocks of 16 for
# the latency.
STREAM_BEAM_ARMS = {"none": (None, 0), "dense": ("dense", 0), "dense_topa": ("dense", BEAM_A),
                    "rnn": ("rnn", 0), "rnn_topa": ("rnn", BEAM_A)}
# The carried forms against the plain carried search: planted logits of 8
# rows (one of no frames) of CARRY_T frames, in blocks of CARRY_BLOCK (a
# block of 16 frames after the two stride-2 convs).
CARRY_T, CARRY_BLOCK = 48, 4
CARRY_LENS = [48, 48, 45, 40, 33, 48, 21, 0]
# Forced alignment on planted logits, card vs CPU: log-softmax and float32
# adds on both, so the paths are equal and the scores agree to rounding.
ALIGN_RTOL, ALIGN_BATCHES = 1e-6, 2


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def adopt_orphans() -> None:
    """Make this process the reaper of its descendants' orphans (Linux
    ``PR_SET_CHILD_SUBREAPER``), so that ``stop_descendants`` finds every
    process the run started, even one whose parent has ended."""
    libc = ctypes.CDLL(None, use_errno=True)
    check(libc.prctl(36, 1, 0, 0, 0) == 0, f"prctl(PR_SET_CHILD_SUBREAPER): {ctypes.get_errno()}")


def descendants() -> dict[int, str]:
    """{pid: command line} of every live process below this one."""
    children, cmd = {}, {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd[int(entry)] = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:
            continue
        fields = stat[stat.rfind(")") + 2:].split()
        if fields[0] != "Z":
            children.setdefault(int(fields[1]), []).append(int(entry))
    out, todo = {}, [os.getpid()]
    while todo:
        for pid in children.get(todo.pop(), []):
            out[pid] = cmd.get(pid, "?")
            todo.append(pid)
    return out


def stop_descendants() -> None:
    """End every process the run started, so that the script ends alone.

    The spawned ranks share multiprocessing's resource tracker, a child of
    this process that outlives them; it is closed through its own call, so
    that it releases what it tracks.  Anything else still running here (a
    rank that outlived its job, or a process one left behind) is named on
    stderr and sent SIGTERM, then SIGKILL; ended children are reaped."""
    tracker = resource_tracker._resource_tracker
    for sig in (signal.SIGTERM, signal.SIGKILL):
        stray = {p: c for p, c in descendants().items() if p != tracker._pid}
        if not stray:
            break
        print(f"chip_smoke: {sig.name} to processes still running: {stray}", file=sys.stderr)
        for pid in stray:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, sig)
        deadline = time.monotonic() + 5.0
        while set(descendants()) - {tracker._pid} and time.monotonic() < deadline:
            time.sleep(0.05)
            with contextlib.suppress(ChildProcessError):
                while os.waitpid(-1, os.WNOHANG)[0] > 0:
                    pass
    with contextlib.suppress(ChildProcessError):  # it may have been reaped above
        tracker._stop()
    with contextlib.suppress(ChildProcessError):
        while os.waitpid(-1, os.WNOHANG)[0] > 0:
            pass


def time_ms(fn, reps: int = 20, inner: int = 10, warmup: int = 3) -> float:
    """Median over ``reps`` of the device time of ``inner`` back-to-back calls
    of ``fn`` between two CUDA events, over ``inner``: the calls queue up, so
    the host's launch cost hides behind the device's work (L2 stays warm)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound(nbytes: float, ops_s: float) -> tuple[float, str]:
    """Least time in ms: the larger of bytes over memory rate and operation time."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lstm_bounds(b: int, T: int, D: int, Hd: int, valid: int, dirs: int = 1,
                rb: int = 2) -> dict[str, tuple[float, str]]:
    """``bound`` of K2 ("fwd"), K3's training forward ("train_fwd") and its
    backward ("bwd"), once a direction (``dirs`` 2: K11's), for x (b, T, D)
    bf16, hidden width Hd, ``valid`` valid steps in all and residuals of
    ``rb`` bytes.  Bytes: x, wih (bf16), whh, bias, lengths, out (bf16) and
    the residuals once.  The inference forward's products run at the valid
    steps; the training forward's projection over all b*T rows (the
    residuals hold every step's gates) and its recurrent product at the
    valid steps and once more for the held state; the backward's dh
    recurrence and dx, dwih, dwhh, db products at the valid rows, in
    float32 as the JAX package computes them."""
    G = 4 * Hd
    weights = dirs * (2 * D * G + 4 * Hd * G + 4 * G)
    res = dirs * rb * T * b * (G + Hd)
    fwd_bytes = 2 * b * T * D + weights + 4 * b + 2 * b * T * dirs * Hd
    bwd_bytes = (4 * b * T * dirs * Hd + 2 * b * T * D + dirs * (2 * D * G + 4 * Hd * G) + 4 * b
                 + res + 2 * b * T * D + weights)
    return {"fwd": bound(fwd_bytes, dirs * (2 * D * G * valid / PEAK_BF16_S
                                            + 2 * Hd * G * valid / PEAK_FP32_S)),
            "train_fwd": bound(fwd_bytes + res, dirs * (2 * D * G * b * T / PEAK_BF16_S
                                                        + 2 * Hd * G * (valid + b) / PEAK_FP32_S)),
            "bwd": bound(bwd_bytes, dirs * valid * (2 * G * Hd + 2 * G * D + 2 * G * D
                                                    + 2 * G * Hd + G) / PEAK_FP32_S)}


def search_bound(frames: int, K: int, C: int, V: int, A: int, B: int, L: int,
                 extra_bytes: int = 0, lm_ops: float = 0.0) -> tuple[float, str]:
    """``bound`` of a prefix beam search (K7/K8/K9) over ``frames`` valid
    frames at beam K over C lanes.  Bytes: logp of the valid frames, the
    top-A values and ids (K8), ``extra_bytes`` (the table, or the LM's
    weights and primed state), the backpointers written, the lengths and
    outputs.  Operations a valid frame: ~12 a candidate lane (log-sum-exp,
    the extension and the fusion), 3 per (beam, beam) absorb test, and a
    top-K over K + K*C candidates at log2(K) compares each; plus ``lm_ops``,
    the LM steps the data needs."""
    nbytes = (4 * V * frames + 8 * A * frames + extra_bytes + 8 * K * frames + 4 * B
              + 4 * B * L + 8 * B)
    ops = frames * (12 * K * C + 3 * K ** 2 + (K + K * C) * math.log2(max(K, 2))) + lm_ops
    return bound(nbytes, ops / PEAK_FP32_S)


def study_bound(frames: int, B: int, T: int, K: int, V: int, L: int,
                stepwise: bool) -> tuple[float, str]:
    """``bound`` of K13 or (``stepwise``) K12 over ``frames`` valid frames
    at beam K over V - 1 lanes.  Bytes: logp of the valid frames, the
    outputs and, for K12, its 5 state fields read and written a frame and
    the (B, T, K) pointers written (K13's token copy moves on-chip memory
    and is no operation).  Operations as ``search_bound``'s."""
    C = V - 1
    nbytes = 4 * V * frames + 4 * B * L + 8 * B
    if stepwise:
        nbytes += 40 * K * frames + 8 * B * T * K
    ops = frames * (12 * K * C + 3 * K ** 2 + (K + K * C) * math.log2(max(K, 2)))
    return bound(nbytes, ops / PEAK_FP32_S)


def lm_step_ops(lmc: RNNLMConfig, V: int) -> int:
    """One LM step: the gate products 2 * 4H * (in + H) a layer, ~10 a gate
    unit for the cell, the output product 2 H V and ~5 V for the
    log-softmax."""
    Hd, G4 = lmc.hidden_dim, 4 * lmc.hidden_dim
    return (sum(2 * G4 * ((lmc.embed_dim if l == 0 else Hd) + Hd) for l in range(lmc.num_layers))
            + 10 * G4 * lmc.num_layers + 2 * Hd * V + 5 * V)


def errors(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, that over max |want|)."""
    d = (got.float() - want.float()).abs().max().item()
    return d, d / max(want.float().abs().max().item(), 1e-30)


def exact_log_mel(audio: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """The log-mel function in float64: direct DFT of the windowed frames."""
    n_freq = cfg.n_fft // 2 + 1
    T = features.max_frames(audio.shape[1], cfg)
    frames = audio.double().unfold(-1, cfg.win_length, cfg.hop_length)[:, :T]
    n = torch.arange(cfg.win_length, dtype=torch.float64, device=audio.device)
    k = torch.arange(n_freq, dtype=torch.float64, device=audio.device)
    ang = 2 * torch.pi * torch.remainder(n[:, None] * k[None, :], cfg.n_fft) / cfg.n_fft
    win = torch.from_numpy(features.hann_window(cfg.win_length)).double().to(audio.device)
    frames = frames * win
    power = (frames @ torch.cos(ang)).square() + (frames @ torch.sin(ang)).square()
    mel = torch.from_numpy(features.mel_filterbank(cfg)).double().to(audio.device)
    return torch.log(torch.clamp(power @ mel, min=cfg.log_floor)).float()


def serving_audio(cfg: FrontendConfig) -> torch.Tensor:
    """(B, AUDIO) float32 on the card: 8 synthetic utterances of 16 s."""
    rng_audio = np.zeros((B, AUDIO), np.float32)
    for b, (a, _) in enumerate(synthetic_corpus(B, cfg.sample_rate, seed=1,
                                                min_sec=16.0, max_sec=17.0)):
        rng_audio[b, : min(len(a), AUDIO)] = a[:AUDIO]
    return torch.from_numpy(rng_audio).to(CARD)


def stft_phase() -> dict:
    cfg = FrontendConfig()
    audio = serving_audio(cfg)
    got = stft_cuda.stft_log_mel(audio, cfg)
    torch.cuda.synchronize()
    want = stft_cuda.stft_log_mel_plain(audio, cfg)
    err, rel = errors(got, want)
    check(got.shape == want.shape and bool(torch.isfinite(got).all()), "stft: bad output")
    check(err <= STFT_TOL, f"stft_log_mel disagrees with its plain version: {err}")
    exact = exact_log_mel(audio, cfg)
    exact_err, _ = errors(got, exact)
    check(exact_err <= STFT_EXACT_TOL, f"stft_log_mel vs a float64 DFT: {exact_err}")
    plain_exact_err, _ = errors(want, exact)

    # Yardstick: torch.stft, then the same mel product and log.
    library = stft_library(cfg, audio)
    lib_err, _ = errors(library(), want)
    check(lib_err <= STFT_TOL, f"stft yardstick computes another function: {lib_err}")
    split = stft_split(audio, cfg)
    T = features.max_frames(AUDIO, cfg)
    b_ms, b_by = stft_bound(cfg, B, AUDIO)
    # K1 and its library call in turns (kernel, library, library, kernel),
    # so that one run ranks them.
    kernel = lambda: stft_cuda.stft_log_mel(audio, cfg)  # noqa: E731
    turns = [time_ms(fn) for fn in (kernel, library, library, kernel)]
    ms, library_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    # Calls queued back to back can wait on the host's launches: the device
    # time of K1's kernel and of all the library call's kernels, per call.
    device_ms = device_ms_per_call(kernel, "stft_log_mel_kernel")
    library_device_ms = device_ms_per_call(library, "")
    rec = {"name": "stft_log_mel", "route": "cuda",
           "source": "pytorch_asr_tpu_torch/csrc/stft_log_mel.cu",
           "replaces": "pytorch_asr_tpu/ops/stft_pallas.py:189",
           "shape": f"audio ({B}, {AUDIO}) f32 -> ({B}, {T}, {cfg.n_mels}) f32",
           "max_abs_err": err, "max_rel_err": rel, "tol": STFT_TOL,
           "max_abs_err_vs_fp64": exact_err, "tol_vs_fp64": STFT_EXACT_TOL,
           "plain_max_abs_err_vs_fp64": plain_exact_err,
           "ms": ms, "plain_ms": time_ms(lambda: stft_cuda.stft_log_mel_plain(audio, cfg)),
           "library_ms": library_ms, "library": "torch.stft + mel matmul + log",
           "turns_ms": {"kernel, library, library, kernel": turns}, "phase_split": split,
           "device_ms": device_ms, "library_device_ms": library_device_ms,
           "library_ratio": ms / library_ms,
           "bound_ms": b_ms, "bound_by": b_by}
    print(f"stft_log_mel: {json.dumps(rec)}")
    return rec


def stft_bound(cfg: FrontendConfig, b: int, A: int) -> tuple[float, str]:
    """``bound`` of the log-mel of (b, A) audio.  What the function needs a
    frame: the window product, a real FFT of n_fft points (2.5 n log2 n),
    the power, the mel product over the bank's nonzeros (it is sparse:
    triangles), and the log; bytes: the audio, the output, the window and
    the bank."""
    n_freq, T = cfg.n_fft // 2 + 1, features.max_frames(A, cfg)
    nnz = int((features.mel_filterbank(cfg) != 0).sum())
    ops = b * T * (cfg.win_length + 2.5 * cfg.n_fft * np.log2(cfg.n_fft) + 3 * n_freq
                   + cfg.n_mels) + b * T * 2 * nnz
    nbytes = 4 * (b * A + b * T * cfg.n_mels + cfg.win_length + n_freq * cfg.n_mels)
    return bound(nbytes, ops / PEAK_FP32_S)


def stft_library(cfg: FrontendConfig, audio: torch.Tensor):
    """The log-mel as ``torch.stft`` (the window padded to n_fft on the
    right, the audio padded by n_fft - win, which frames exactly as
    center=False over win samples), then the mel product and log."""
    window = torch.zeros(cfg.n_fft, device=audio.device)
    window[: cfg.win_length] = torch.hann_window(cfg.win_length, device=audio.device)
    mel = torch.from_numpy(features.mel_filterbank(cfg)).to(audio.device)
    padded = torch.nn.functional.pad(audio, (0, cfg.n_fft - cfg.win_length))

    def library():
        spec = torch.stft(padded, cfg.n_fft, cfg.hop_length, cfg.n_fft, window,
                          center=False, return_complex=True)
        return torch.log(torch.clamp(spec.abs().square().transpose(1, 2) @ mel,
                                     min=cfg.log_floor))

    return library


def stft_split(audio: torch.Tensor, cfg: FrontendConfig) -> dict:
    """Where K1's time goes: the phase clocks of its traced rows
    (``stft_log_mel``'s trace), the median µs a row spends loading audio,
    packing, in the FFT, the split into power bins and the mel product and
    log, at the clock the trace saw."""
    trace = torch.zeros((features.max_frames(audio.shape[1], cfg), 8), dtype=torch.int64,
                        device=CARD)
    stft_cuda.stft_log_mel(audio, cfg, trace)
    tr = trace.cpu().numpy().astype(np.float64)
    tr = tr[tr[:, 0] != 0]
    check(len(tr) > 0 and (tr[:, 7] - tr[:, 0]).sum() > 0, "stft trace: no row written")
    ghz = (tr[:, 6] - tr[:, 1]).sum() / (tr[:, 7] - tr[:, 0]).sum()
    names = ("load", "pack", "fft", "split", "mel_log")
    return {"rows": len(tr), "trace_clock_ghz": ghz,
            "us_median": {n: float(np.median(tr[:, i + 2] - tr[:, i + 1])) / ghz / 1e3
                          for i, n in enumerate(names)},
            "us_total_median": float(np.median(tr[:, 6] - tr[:, 1])) / ghz / 1e3}


def frame_split(trace: torch.Tensor, names: tuple[str, ...]) -> dict:
    """The median µs a frame spends in each phase, from a beam kernel's
    (T, 2 + len(names)) trace (the global clock, then the clock at the
    frame's start and after each phase; rows of no frame are 0), at the
    clock the trace saw, and the median frame."""
    tr = trace.cpu().numpy().astype(np.float64)
    tr = tr[tr[:, 0] != 0]
    check(len(tr) > 1, "beam trace: fewer than two frames written")
    ghz = (tr[-1, 1] - tr[0, 1]) / (tr[-1, 0] - tr[0, 0])
    return {"frames": len(tr), "trace_clock_ghz": ghz,
            "frame_us_median": float(np.median(tr[1:, 1] - tr[:-1, 1])) / ghz / 1e3,
            "us_median": {n: float(np.median(tr[:, i + 2] - tr[:, i + 1])) / ghz / 1e3
                          for i, n in enumerate(names)}}


K7_PHASES = ("row", "extend", "absorb", "select", "picks")


def k9_phases(nl: int) -> tuple[str, ...]:
    """The phases of a frame of K9's grid: its trace's columns after the start."""
    layers = [f"{p}{l}" for l in range(nl) for p in ("stage", "cells", "barrier")]
    return ("search", "barrier", *layers, "logits")


def step_split(trace: torch.Tensor, steps: int) -> dict:
    """CTA 0's median µs a step from a grid kernel's (T, 5) trace: staging,
    chains, cells and the grid barrier, at the clock the trace saw."""
    tr = trace[:steps].cpu().numpy().astype(np.float64)
    ghz = (tr[-1, 1] - tr[0, 1]) / (tr[-1, 0] - tr[0, 0])
    cycles = {"stage": tr[:-1, 2] - tr[:-1, 1], "chains": tr[:-1, 3] - tr[:-1, 2],
              "cells": tr[:-1, 4] - tr[:-1, 3], "barrier": tr[1:, 1] - tr[:-1, 4]}
    return {"step_us_median": {k: float(np.median(v)) / ghz / 1e3 for k, v in cycles.items()},
            "trace_clock_ghz": ghz}


def bwd_grid_record(bargs: tuple, steps: int, dual: bool = False) -> dict:
    """K3's backward grid for ``bargs`` (with ``dual``, K11's grid of both
    directions), the device time of its recurrence (lstm_bwd_grid_kernel
    alone, from the profiler) and where a step goes (the trace of
    ``backward_on_route`` or ``bilstm_backward_on_route``, CTA (0, 0)'s):
    staging dgates and the cell inputs, the dh chains, the cells and the
    grid barrier."""
    x, whh = bargs[1], bargs[3]
    grid = lstm_cuda.backward_grid(whh.shape[-2], x.shape[0], build.sm_count(0),
                                   directions=2 if dual else 1)
    on_route = lstm_cuda.bilstm_backward_on_route if dual else lstm_cuda.backward_on_route
    rec = {"grid": grid._asdict(),
           "recurrence_ms": device_ms_per_call(lambda: on_route(grid, *bargs),
                                               "lstm_bwd_grid_kernel", 5)}
    rec["us_per_step"] = rec["recurrence_ms"] / steps * 1e3
    trace = torch.zeros((x.shape[1], 5), dtype=torch.int64, device=CARD)
    on_route(grid, *bargs, trace=trace)
    rec.update(step_split(trace, steps))
    return rec


def grid_record(args: tuple, b: int, steps: int, residual_dtype=None, dual: bool = False) -> dict:
    """K2's (K3's forward, with ``residual_dtype``) grid for ``args``, or with
    ``dual`` K11's grid of both directions, the device time a step of its
    recurrence (lstm_grid_kernel alone, from the profiler), and where a step
    goes: CTA 0's median cycles from staging h, through the dot chains and
    the cell updates, to the grid barrier (the trace of ``forward_on_grid``
    or ``bilstm_on_grid``), in µs at the clock the trace saw."""
    H = args[2].shape[-2]
    launch = lstm_cuda.bilstm_on_grid if dual else lstm_cuda.forward_on_grid
    rec = {"grid": lstm_cuda.recurrence_grid(H, b, build.sm_count(0),
                                             directions=2 if dual else 1)._asdict(),
           "recurrence_ms": device_ms_per_call(
               lambda: launch(None, *args, residual_dtype=residual_dtype),
               "lstm_grid_kernel", 5)}
    rec["us_per_step"] = rec["recurrence_ms"] / steps * 1e3
    trace = torch.zeros((args[0].shape[1], 5), dtype=torch.int64, device=CARD)
    launch(None, *args, residual_dtype=residual_dtype, trace=trace)
    rec.update(step_split(trace, steps))
    return rec


def lstm_phase() -> dict:
    """K2 at config 1's layer shapes (B 8, H 384; D 768 and 640) and config
    2's (B 16, D 1024, H 512), both directions, against its plain version and
    timed beside cuDNN's LSTM; its grid and µs a step of the recurrence are
    printed; then the sweep of the grid's CTAs."""
    g = torch.Generator().manual_seed(2)
    cases = []
    cfg2_lengths = np.linspace(T_LSTM, 250, BEAM_B).astype(int).tolist()
    for tag, b, D, Hd, lengths in (("config 1", B, 2 * H, H, LSTM_LENGTHS),
                                   ("config 1", B, 640, H, LSTM_LENGTHS),
                                   ("config 2", BEAM_B, 1024, 512, cfg2_lengths)):
        G = 4 * Hd
        x = (torch.randn(b, T_LSTM, D, generator=g) * 0.5).bfloat16().cuda()
        wih = (torch.randn(D, G, generator=g) / D ** 0.5).bfloat16().cuda()
        whh = (torch.randn(Hd, G, generator=g) / Hd ** 0.5).cuda()
        bias = (torch.randn(G, generator=g) * 0.1).cuda()
        lens = torch.tensor(lengths, dtype=torch.int32).cuda()
        for reverse in (False, True):
            args = (x, wih, whh, bias, lens, reverse, torch.bfloat16)
            got = lstm_cuda.lstm_seq(*args)
            torch.cuda.synchronize()
            want = lstm_cuda.lstm_seq_plain(*args)
            err, rel = errors(got, want)
            check(bool(torch.isfinite(got.float()).all()), "lstm_seq: non-finite output")
            check(err <= LSTM_TOL, f"lstm_seq {tag} D={D} reverse={reverse} disagrees: {err}")
            case = {"layer": tag, "x": [b, T_LSTM, D], "H": Hd, "reverse": reverse,
                    "max_abs_err": err, "max_rel_err": rel,
                    "ms": time_ms(lambda: lstm_cuda.lstm_seq(*args)),
                    "plain_ms": time_ms(lambda: lstm_cuda.lstm_seq_plain(*args), reps=5, inner=1,
                                        warmup=1)}
            # Yardstick: cuDNN's fp32 LSTM, same weights, every length = T.
            ref = cudnn_lstm(D, wih, whh, bias)
            xf = x.float()
            with torch.no_grad():
                case["library_ms"] = time_ms(lambda: ref(xf))
            if not reverse:
                case.update(grid_record(args, b, max(lengths)))
                print(f"lstm_seq grid, {tag} D {D}: {json.dumps(case['grid'])}, "
                      f"recurrence {case['recurrence_ms']:.4f} ms, "
                      f"{case['us_per_step']:.3f} us a step of {max(lengths)} "
                      f"{json.dumps(case['step_us_median'])}, "
                      f"call {case['ms']:.4f} ms, cuDNN {case['library_ms']:.4f} ms")
            case["bound_ms"], case["bound_by"] = lstm_bounds(
                b, T_LSTM, D, Hd, int(sum(lengths)))["fwd"]
            cases.append(case)
    sweep = lstm_grid_sweep()
    print("lstm_grid_sweep:", json.dumps(sweep))
    head = cases[0]
    return {"name": "lstm_seq", "route": "cuda",
            "source": "pytorch_asr_tpu_torch/csrc/lstm_seq.cu",
            "replaces": "pytorch_asr_tpu/ops/lstm_pallas.py:280",
            "shape": f"x ({B}, {T_LSTM}, {2 * H}) bf16, H {H}, lengths {LSTM_LENGTHS}; "
                     f"also D 640, and x ({BEAM_B}, {T_LSTM}, 1024), H 512",
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "max_rel_err": max(c["max_rel_err"] for c in cases), "tol": LSTM_TOL,
            "ms": head["ms"], "plain_ms": head["plain_ms"], "library_ms": head["library_ms"],
            "library": "torch.nn.LSTM (cuDNN, fp32, all lengths = T)",
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"], "cases": cases,
            "grid_sweep": sweep}


def lstm_grid_sweep() -> dict:
    """K2 at config 1's (B 8, D 768, H 384) and config 2's (B 16, D 1024,
    H 512) shapes on grids of fewer CTAs than the rule's (more units a CTA:
    shorter barriers, more chains a CTA), each held to the rule's output bit
    for bit and timed: {layer: {CTAs: ms}}, the rule's grid marked."""
    g = torch.Generator().manual_seed(9)
    out = {}
    for tag, b, D, Hd in (("config 1", B, 2 * H, H), ("config 2", BEAM_B, 1024, 512)):
        x = (torch.randn(b, T_LSTM, D, generator=g) * 0.5).bfloat16().cuda()
        wih = (torch.randn(D, 4 * Hd, generator=g) / D ** 0.5).bfloat16().cuda()
        whh = (torch.randn(Hd, 4 * Hd, generator=g) / Hd ** 0.5).cuda()
        bias = (torch.randn(4 * Hd, generator=g) * 0.1).cuda()
        lens = torch.full((b,), T_LSTM, dtype=torch.int32).cuda()
        args = (x, wih, whh, bias, lens, False, torch.bfloat16)
        rule = lstm_cuda.recurrence_grid(Hd, b)
        want = lstm_cuda.lstm_seq(*args)
        times = {}
        for units in (rule.units, rule.units + 1, 2 * rule.units, 4 * rule.units):
            grid = lstm_cuda.recurrence_grid(Hd, b, units=units)
            check(torch.equal(lstm_cuda.forward_on_grid(grid, *args), want),
                  f"lstm_seq on {grid}: differs from the rule's grid")
            times[grid.ctas] = time_ms(lambda: lstm_cuda.forward_on_grid(grid, *args), 5, 4, 1)
        out[tag] = {"rule_ctas": rule.ctas, "ms_by_ctas": times,
                    "fastest_ctas": min(times, key=times.get)}
    return out


def dual_grid_sweep(args: tuple, b: int, want: torch.Tensor) -> dict:
    """K11's forward on dual grids of 32, 48 and 64 CTAs a direction (the
    rule's is 64 at H 384 and 512), each held to ``want`` bit for bit and
    timed: {"ms_by_ctas": {CTAs a direction: ms}, "fastest_ctas": ...}."""
    H = args[2].shape[-2]
    times = {}
    for ctas in (32, 48, 64):
        grid = lstm_cuda.recurrence_grid(H, b, units=-(-H // ctas), directions=2)
        check(torch.equal(lstm_cuda.bilstm_on_grid(grid, *args), want),
              f"bilstm_seq on {grid}: differs from the rule's grid")
        times[grid.ctas] = time_ms(lambda: lstm_cuda.bilstm_on_grid(grid, *args), 5, 4, 1)
    return {"ms_by_ctas": times, "fastest_ctas": min(times, key=times.get)}


def cudnn_lstm(D: int, wih, whh, bias) -> torch.nn.LSTM:
    """cuDNN's fp32 LSTM with the same weights (the library yardstick); with
    weights stacked (2, ...) as [forward, reverse], the bidirectional one."""
    dual = wih.dim() == 3
    ref = torch.nn.LSTM(D, whh.shape[-2], batch_first=True, bidirectional=dual).cuda()
    with torch.no_grad():
        for d, sfx in enumerate(("", "_reverse") if dual else ("",)):
            w_ih, w_hh, b = (wih[d], whh[d], bias[d]) if dual else (wih, whh, bias)
            getattr(ref, f"weight_ih_l0{sfx}").copy_(w_ih.float().T)
            getattr(ref, f"weight_hh_l0{sfx}").copy_(w_hh.T)
            getattr(ref, f"bias_ih_l0{sfx}").copy_(b)
            getattr(ref, f"bias_hh_l0{sfx}").zero_()
    return ref


def lstm_train_phase() -> list[dict]:
    """K3 at the training path's shapes: the training forward's output and
    residuals, then the backward over those residuals for a fixed upstream
    gradient, each against its plain version; with float32 residuals and with
    bf16 residuals as on the path (the bf16 cases are also timed)."""
    g = torch.Generator().manual_seed(3)
    lengths = torch.tensor(LSTM_LENGTHS, dtype=torch.int32)
    valid = int(lengths.sum())
    G = 4 * H
    cases = []
    for D in (2 * H, 640):
        x = (torch.randn(B, T_LSTM, D, generator=g) * 0.5).bfloat16().cuda()
        wih = (torch.randn(D, G, generator=g) / D ** 0.5).bfloat16().cuda()
        whh = (torch.randn(H, G, generator=g) / H ** 0.5).cuda()
        bias = (torch.randn(G, generator=g) * 0.1).cuda()
        gy = torch.randn(B, T_LSTM, H, generator=g).cuda()
        lens = lengths.cuda()
        for reverse in (False, True):
            for res in (torch.float32, torch.bfloat16):
                args = (x, wih, whh, bias, lens, reverse, torch.bfloat16, res)
                got = lstm_cuda.lstm_seq_train_fwd(*args)
                torch.cuda.synchronize()
                want = lstm_cuda.lstm_seq_train_plain(*args)
                case = {"D": D, "reverse": reverse, "residuals": str(res).split(".")[1]}
                bargs = (gy, x, wih, whh, lens, got[1], got[2], reverse)
                dgot = lstm_cuda.lstm_seq_bwd(*bargs)
                torch.cuda.synchronize()
                dwant = lstm_cuda.lstm_seq_bwd_plain(*bargs)
                for name, a, b in zip(("out", "acts", "ct", "dx", "dwih", "dwhh", "db"),
                                      (*got, *dgot), (*want, *dwant)):
                    check(a.dtype == b.dtype and bool(torch.isfinite(a.float()).all()),
                          f"K3 {name}: non-finite or of type {a.dtype}, not {b.dtype}")
                    err, rel = errors(a, b)
                    tol = K3_BF16_TOL if a.dtype == torch.bfloat16 else K3_F32_TOL
                    check(rel <= tol, f"K3 {name} D={D} reverse={reverse} {res}: "
                                      f"{rel} > {tol} of its largest entry")
                    case[name] = {"max_abs_err": err, "max_rel_err": rel, "tol": tol}
                if res == torch.bfloat16:
                    ref = cudnn_lstm(D, wih, whh, bias)
                    xf = x.float().requires_grad_(True)
                    ref_out, _ = ref(xf)
                    ref_in = [xf, *ref.parameters()]
                    # K3's backward and cuDNN's in turns (kernel, library,
                    # library, kernel), so that one run ranks them.
                    kernel_bwd = lambda: lstm_cuda.lstm_seq_bwd(*bargs)  # noqa: E731
                    library_bwd = lambda: torch.autograd.grad(  # noqa: E731
                        ref_out, ref_in, gy, retain_graph=True)
                    turns = [time_ms(fn, 5, 4, 1)
                             for fn in (kernel_bwd, library_bwd, library_bwd, kernel_bwd)]
                    case.update(
                        fwd_ms=time_ms(lambda: lstm_cuda.lstm_seq_train_fwd(*args), 5, 4, 1),
                        bwd_ms=(turns[0] + turns[3]) / 2, bwd_turns_ms=turns,
                        plain_fwd_ms=time_ms(lambda: lstm_cuda.lstm_seq_train_plain(*args),
                                             3, 1, 1),
                        plain_bwd_ms=time_ms(lambda: lstm_cuda.lstm_seq_bwd_plain(*bargs),
                                             3, 1, 1),
                        library_fwd_ms=time_ms(lambda: ref(xf), 5, 4, 1),
                        library_bwd_ms=(turns[1] + turns[2]) / 2)
                    if not reverse:
                        rec = grid_record(args[:7], B, T_LSTM, res)
                        case.update({f"fwd_{k}": v for k, v in rec.items()})
                        print(f"lstm_seq_train_fwd grid, D {D}: {json.dumps(rec['grid'])}, "
                              f"recurrence {rec['recurrence_ms']:.4f} ms, "
                              f"{rec['us_per_step']:.3f} us a step of {T_LSTM} "
                              f"{json.dumps(rec['step_us_median'])}, call "
                              f"{case['fwd_ms']:.4f} ms, cuDNN {case['library_fwd_ms']:.4f} ms")
                        rec = bwd_grid_record(bargs, int(lengths.max()))
                        # The per-utterance kernel (the wide route, K3's
                        # backward before the grid) on the same inputs.
                        rec["per_utterance_ms"] = time_ms(
                            lambda: lstm_cuda.backward_on_route(None, *bargs), 5, 4, 1)
                        case.update({f"bwd_{k}": v for k, v in rec.items()})
                        print(f"lstm_seq_bwd grid, D {D}: {json.dumps(rec['grid'])}, "
                              f"recurrence {rec['recurrence_ms']:.4f} ms, "
                              f"{rec['us_per_step']:.3f} us a step of {int(lengths.max())} "
                              f"{json.dumps(rec['step_us_median'])}, call {case['bwd_ms']:.4f} "
                              f"ms, cuDNN {case['library_bwd_ms']:.4f} ms (turns "
                              f"{json.dumps(turns)}), per-utterance kernel "
                              f"{rec['per_utterance_ms']:.4f} ms")
                    bounds = lstm_bounds(B, T_LSTM, D, H, valid)
                    case["fwd_bound_ms"], case["fwd_bound_by"] = bounds["train_fwd"]
                    case["bwd_bound_ms"], case["bwd_bound_by"] = bounds["bwd"]
                cases.append(case)
    head = next(c for c in cases if "fwd_ms" in c)
    shape = (f"x ({B}, {T_LSTM}, {2 * H}) bf16, H {H}, lengths {LSTM_LENGTHS}, "
             f"bf16 residuals")
    out = []
    for name, outs, stem, line, what in (
            ("lstm_seq_train_fwd", ("out", "acts", "ct"), "fwd", 395, "forward"),
            ("lstm_seq_bwd", ("dx", "dwih", "dwhh", "db"), "bwd", 403,
             "backward (autograd.grad, graph kept)")):
        out.append({
            "name": name, "route": "cuda", "source": "pytorch_asr_tpu_torch/csrc/lstm_seq.cu",
            "replaces": f"pytorch_asr_tpu/ops/lstm_pallas.py:{line}", "shape": shape,
            "max_abs_err": max(c[o]["max_abs_err"] for c in cases for o in outs),
            "max_rel_err": max(c[o]["max_rel_err"] for c in cases for o in outs),
            "tol": {"float32": K3_F32_TOL, "bfloat16": K3_BF16_TOL},
            "ms": head[f"{stem}_ms"], "plain_ms": head[f"plain_{stem}_ms"],
            "library_ms": head[f"library_{stem}_ms"],
            "library": f"torch.nn.LSTM (cuDNN, fp32, all lengths = T) {what}",
            "bound_ms": head[f"{stem}_bound_ms"], "bound_by": head[f"{stem}_bound_by"],
            "cases": [{k: v for k, v in c.items() if k in ("D", "reverse", "residuals")
                       or k.startswith(stem) or k.startswith(f"plain_{stem}")
                       or k.startswith(f"library_{stem}") or k in outs} for c in cases]})
    return out


def ctc_close(name: str, got: torch.Tensor, want: torch.Tensor, rtol: float,
              atol: float, kernel: str = "K4") -> float:
    """Check ``got`` against ``want``; returns the largest absolute error over
    the entries above the NEG_INF sentinel."""
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{kernel} {name}: {m}")
    live = want > ctc.NEG_INF / 2
    return float((got - want).detach().abs()[live].max()) if bool(live.any()) else 0.0


def ctc_case():
    """K4's inputs at the training path's shapes
    (``bench_kernel_turns.train_ctc_case``): labels of a batch of 10-16 s
    synthetic utterances over T' = 400 frames, with one row of ``logit_len
    == 0`` and one infeasible row: (logits, labels, logit_len, label_len,
    T), on the card."""
    logits, logit_len, labels, label_len = bench_kernel_turns.train_ctc_case(CARD)
    return logits, labels, logit_len, label_len, logits.shape[1]


def ctc_phase() -> list[dict]:
    """K4 at the training path's shapes (``ctc_case``)."""
    logits, labels, logit_len, label_len, T = ctc_case()
    _, logp_tbs, _, skip = ctc.prep(logits, labels.long(), label_len, 0)
    S = logp_tbs.shape[2]
    alphas, final = ctc_cuda.ctc_alpha(logp_tbs, skip, logit_len)
    torch.cuda.synchronize()
    ref_alphas, ref_final = ctc.alphas_plain(logp_tbs, skip, logit_len)
    alpha_err = max(ctc_close("alphas", alphas, ref_alphas, CTC_RTOL, CTC_ALPHA_ATOL),
                    ctc_close("final alpha", final, ref_final, CTC_RTOL, CTC_ALPHA_ATOL))
    logz = ctc.terminal_logz(ref_final, label_len)
    feasible = (logz > ctc.NEG_INF / 2) & (logit_len > 0)
    check(feasible.tolist() == [True] * (B - 2) + [False, False],
          f"K4: feasible rows {feasible.tolist()}")
    bargs = (logp_tbs, ref_alphas, ctc.shift_left(skip, 2, fill=False).contiguous(),
             ctc.terminal_betas(label_len, S), torch.where(feasible, logit_len, 0).to(torch.int32),
             torch.where(feasible, logz, 0.0))
    w = ctc_cuda.ctc_beta(*bargs)
    torch.cuda.synchronize()
    beta_err = ctc_close("posteriors", w, ctc.posteriors_plain(*bargs), CTC_GRAD_RTOL,
                         CTC_GRAD_ATOL)

    a, b = logits.clone().requires_grad_(True), logits.clone().requires_grad_(True)
    loss, ref = ctc_cuda.ctc_loss(a, logit_len, labels, label_len), ctc.ctc_loss(
        b, logit_len, labels, label_len)
    loss.sum().backward()
    ref.sum().backward()
    loss_err = ctc_close("loss", loss, ref, CTC_RTOL, CTC_RTOL)
    grad_err = ctc_close("gradient", a.grad, b.grad, CTC_GRAD_RTOL, CTC_GRAD_ATOL)
    check(not loss[B - 2:].any() and not a.grad[B - 2:].any(),
          "K4: empty and infeasible rows must give loss 0 and gradient 0")

    # Yardstick: torch's CTC with zero_infinity, forward; its backward with
    # the graph kept (log-probabilities in, as F.ctc_loss takes them).
    lib, lib_backward = ctc_library(logits, labels, logit_len, label_len)
    frames = int(logit_len.sum())
    # Each kernel and its library call in turns (kernel, library, library,
    # kernel); block 0's frame split from each kernel's trace.
    fwd = in_turns({"kernel": lambda: ctc_cuda.ctc_alpha(logp_tbs, skip, logit_len),
                    "library": lib}, reps=10, inner=10)
    bwd = in_turns({"kernel": lambda: ctc_cuda.ctc_beta(*bargs), "library": lib_backward},
                   reps=10, inner=10)
    common = {"route": "cuda", "source": "pytorch_asr_tpu_torch/csrc/ctc_alpha_beta.cu",
              "shape": f"logp_tbs ({T}, {B}, {S}) f32, V {V}, "
                       f"label_len {label_len.tolist()}, logit_len {logit_len.tolist()}",
              "plan": list(ctc_cuda.lane_plan(S)),
              "loss_max_abs_err": loss_err, "grad_max_abs_err": grad_err}
    alpha = {"name": "ctc_alpha", **common, "replaces": "pytorch_asr_tpu/ops/ctc_pallas.py:279",
             "max_abs_err": alpha_err, "tol": {"rtol": CTC_RTOL, "atol": CTC_ALPHA_ATOL},
             "ms": statistics.mean(fwd["kernel"]),
             "plain_ms": time_ms(lambda: ctc.alphas_plain(logp_tbs, skip, logit_len), 3, 1, 1),
             "library_ms": statistics.mean(fwd["library"]),
             "library": "F.ctc_loss forward (zero_infinity)",
             "turns_ms": {"kernel, library, library, kernel": fwd},
             "frame_split_us": ctc_split(
                 lambda tr: ctc_cuda.ctc_alpha(logp_tbs, skip, logit_len, trace=tr), T)}
    alpha["bound_ms"], alpha["bound_by"] = ctc_bound("alpha", T, B, S, frames)
    beta = {"name": "ctc_beta", **common, "replaces": "pytorch_asr_tpu/ops/ctc_pallas.py:312",
            "max_abs_err": beta_err, "tol": {"rtol": CTC_GRAD_RTOL, "atol": CTC_GRAD_ATOL},
            "ms": statistics.mean(bwd["kernel"]),
            "plain_ms": time_ms(lambda: ctc.posteriors_plain(*bargs), 3, 1, 1),
            "library_ms": statistics.mean(bwd["library"]),
            "library": "F.ctc_loss backward (autograd.grad, graph kept)",
            "turns_ms": {"kernel, library, library, kernel": bwd},
            "frame_split_us": ctc_split(lambda tr: ctc_cuda.ctc_beta(*bargs, trace=tr), T)}
    beta["bound_ms"], beta["bound_by"] = ctc_bound("beta", T, B, S, frames)
    return [alpha, beta]


def ctc_bound(kind: str, T: int, b: int, S: int, frames: int) -> tuple[float, str]:
    """``bound`` of a K4 kernel over (T, b, S) with ``frames`` valid frames.
    Bytes: logp (and, for the beta, the alphas) read, the outputs written,
    the masks, lengths, beta_T and logz.  Operations a state and frame: the
    log-sum-exp of three terms, 3 exp, 1 log and ~8 adds and maxima ("alpha",
    12); the beta adds the posterior's add, subtract and exp (15); the
    paired alpha, a pair of frames: the single step, the five emission
    weights and the 5-term log-sum-exp (23)."""
    row = 4 * T * b * S
    if kind == "beta":
        return bound(3 * row + b * S + 4 * b * S + 8 * b, 15 * S * frames / PEAK_FP32_S)
    return bound(2 * row + b * S + 4 * b + 4 * b * S,
                 (12 if kind == "alpha" else 23) * S * frames / PEAK_FP32_S)


def ctc_library(logits, labels, logit_len, label_len):
    """``F.ctc_loss`` (zero_infinity) on the log-probabilities of
    ``logits``: (its forward, its backward with the graph kept)."""
    lp = torch.log_softmax(logits, -1).transpose(0, 1).detach().requires_grad_(True)
    lib = lambda: F.ctc_loss(lp, labels.long(), logit_len.long(), label_len.long(),  # noqa: E731
                             reduction="none", zero_infinity=True)
    lib_loss = lib()
    return lib, lambda: torch.autograd.grad(lib_loss.sum(), lp, retain_graph=True)


def ctc_split(call, T: int, phases: tuple[str, ...] = bench_kernel_turns.CTC_PHASES) -> dict:
    """Where a K4 frame's time goes (or, with ``PAIRED_PHASES``, a paired
    alpha's pair): ``bench_kernel_turns.ctc_split``, the trace of each frame
    (pair) recursed, written by ``call(trace)``."""
    split = bench_kernel_turns.ctc_split(call, T, CARD, phases)
    check(split["frames"] > 1, "ctc trace: fewer than two frames written")
    return split


def bilstm_phase() -> tuple[list[dict], dict]:
    """K11, both directions of a BiLSTM layer in one launch, at config 1's
    layer shape (x (8, 400, 768) bf16, H 384, lengths 400 down to 250) and
    config 2's (x (16, 400, 1024) bf16, H 512), forward; at config 1's also
    the training forward and backward with bf16 and float32 residuals.  The
    forwards (and the residuals) run on the dual grid and must equal two K2
    (K3) launches and the per-utterance oracle bit for bit, the gradients
    K3's pair within K3's tolerances (bit-equality is reported); everything
    is also held to the plain versions.  Timed beside two K2 (K3) launches
    back to back, the oracle and cuDNN's bidirectional LSTM; the dual
    grid's µs a step and its split (``grid_record``), and a sweep of 32, 48
    and 64 CTAs a direction.  Then the op's own path:
    ``lstm_cuda.bilstm_seq`` without gradients and under autograd, with the
    counters set to 0 before and read after: no oracle launch, no plain
    version."""
    g = torch.Generator().manual_seed(5)
    out, cases, path_launches = [], [], None
    shapes = (("config 1", B, T_LSTM, 2 * H, H, LSTM_LENGTHS),
              ("config 2", BEAM_B, T_LSTM, 1024, 512,
               np.linspace(T_LSTM, 250, BEAM_B).astype(int).tolist()))
    for tag, b, T, D, Hd, lengths in shapes:
        G = 4 * Hd
        x = (torch.randn(b, T, D, generator=g) * 0.5).bfloat16().cuda()
        wih = (torch.randn(2, D, G, generator=g) / D ** 0.5).bfloat16().cuda()
        whh = (torch.randn(2, Hd, G, generator=g) / Hd ** 0.5).cuda()
        bias = (torch.randn(2, G, generator=g) * 0.1).cuda()
        lens = torch.tensor(lengths, dtype=torch.int32).cuda()
        args = (x, wih, whh, bias, lens, torch.bfloat16)
        got = lstm_cuda.bilstm_seq_infer(*args)
        torch.cuda.synchronize()
        pair = [(x, wih[d], whh[d], bias[d], lens, bool(d), torch.bfloat16) for d in (0, 1)]
        two_k2 = torch.cat([lstm_cuda.lstm_seq_infer(*p) for p in pair], dim=-1)
        check(torch.equal(got, two_k2), f"K11 {tag}: forward differs from two K2 launches")
        check(torch.equal(got, lstm_cuda._bilstm_seq_per_utterance(*args)),
              f"K11 {tag}: forward differs from the per-utterance oracle")
        err, rel = errors(got, lstm_cuda.bilstm_seq_plain(*args))
        check(err <= LSTM_TOL, f"K11 {tag}: forward disagrees with its plain version: {err}")
        valid = int(sum(lengths))
        bounds = lstm_bounds(b, T, D, Hd, valid, dirs=2)
        case = {"layer": tag, "x": [b, T, D], "H": Hd, "bit_equal_two_k2": True,
                "bit_equal_oracle": True, "max_abs_err": err, "max_rel_err": rel,
                "ms": time_ms(lambda: lstm_cuda.bilstm_seq_infer(*args), 5, 4, 1),
                "two_k2_ms": time_ms(lambda: [lstm_cuda.lstm_seq_infer(*p) for p in pair],
                                     5, 4, 1),
                "one_k2_ms": time_ms(lambda: lstm_cuda.lstm_seq_infer(*pair[0]), 5, 4, 1),
                "oracle_ms": time_ms(lambda: lstm_cuda._bilstm_seq_per_utterance(*args),
                                     5, 4, 1),
                "plain_ms": time_ms(lambda: lstm_cuda.bilstm_seq_plain(*args), 3, 1, 1)}
        ref = cudnn_lstm(D, wih, whh, bias)
        xf = x.float()
        with torch.no_grad():
            case["library_ms"] = time_ms(lambda: ref(xf), 5, 4, 1)
        case["bound_ms"], case["bound_by"] = bounds["fwd"]
        case.update(grid_record(args, b, max(lengths), dual=True))
        case["grid_sweep"] = dual_grid_sweep(args, b, got)
        print(f"bilstm_seq dual grid, {tag}: {json.dumps(case['grid'])}, "
              f"recurrence {case['recurrence_ms']:.4f} ms, {case['us_per_step']:.3f} us a "
              f"step of {max(lengths)} {json.dumps(case['step_us_median'])}, call "
              f"{case['ms']:.4f} ms, two K2 {case['two_k2_ms']:.4f} ms, oracle "
              f"{case['oracle_ms']:.4f} ms, cuDNN {case['library_ms']:.4f} ms, sweep "
              f"{json.dumps(case['grid_sweep'])}")
        cases.append(case)
        if tag != "config 1":
            continue
        train = {}
        gy = torch.randn(b, T, 2 * Hd, generator=g).cuda()
        for res in (torch.float32, torch.bfloat16):
            targs = (*args, res)
            fwd = lstm_cuda.bilstm_seq_train_fwd(*targs)
            torch.cuda.synchronize()
            k3 = [lstm_cuda.lstm_seq_train_fwd(*p, res) for p in pair]
            check(torch.equal(fwd[0], torch.cat([k3[0][0], k3[1][0]], -1))
                  and torch.equal(fwd[1], torch.stack([k3[0][1], k3[1][1]]))
                  and torch.equal(fwd[2], torch.stack([k3[0][2], k3[1][2]])),
                  f"K11 training forward ({res}): differs from two K3 launches")
            oracle = lstm_cuda._bilstm_seq_per_utterance(*targs)
            check(all(torch.equal(a, o) for a, o in zip(fwd, oracle)),
                  f"K11 training forward ({res}): differs from the per-utterance oracle")
            bargs = (gy, x, wih, whh, lens, fwd[1], fwd[2])
            build.reset_launches()
            grads = lstm_cuda.bilstm_seq_bwd(*bargs)
            torch.cuda.synchronize()
            check({k: v for k, v in build.LAUNCHES.items() if v} == {"bilstm_seq_bwd": 1},
                  f"K11 backward ({res}): not the dual grid: {dict(build.LAUNCHES)}")
            k3b = [lstm_cuda.lstm_seq_bwd(gy[..., d * Hd:(d + 1) * Hd].contiguous(), x, wih[d],
                                          whh[d], lens, fwd[1][d], fwd[2][d], bool(d))
                   for d in (0, 1)]
            k3g = (k3b[0][0] + k3b[1][0], *(torch.stack([k3b[0][i], k3b[1][i]])
                                            for i in (1, 2, 3)))
            want = (*lstm_cuda.bilstm_seq_train_plain(*targs),
                    *lstm_cuda.bilstm_seq_bwd_plain(*bargs))
            rec = {"grads_bit_equal_k3": all(torch.equal(a, c) for a, c in zip(grads, k3g)),
                   "grads_bit_equal_oracle": all(torch.equal(a, c) for a, c in zip(
                       grads, lstm_cuda._bilstm_seq_bwd_per_utterance(*bargs)))}
            check(rec["grads_bit_equal_k3"] and rec["grads_bit_equal_oracle"],
                  f"K11 backward ({res}): differs from two K3 backward launches or the oracle")
            for name, a, w, c in zip(("out", "acts", "ct", "dx", "dwih", "dwhh", "db"),
                                     (*fwd, *grads), want, (None, None, None, *k3g)):
                tol = K3_BF16_TOL if a.dtype == torch.bfloat16 else K3_F32_TOL
                check(a.dtype == w.dtype and bool(torch.isfinite(a.float()).all()),
                      f"K11 {name} ({res}): non-finite or of type {a.dtype}")
                err, rel = errors(a, w)
                check(rel <= tol, f"K11 {name} ({res}): {rel} > {tol} of the plain version's")
                if c is not None:
                    k3_rel = errors(a, c)[1]
                    check(k3_rel <= tol, f"K11 {name} ({res}): {k3_rel} > {tol} of K3's pair")
                rec[name] = {"max_abs_err": err, "max_rel_err": rel, "tol": tol}
            train[str(res).split(".")[1]] = rec
        res = torch.bfloat16
        targs = (*args, res)
        fwd = lstm_cuda.bilstm_seq_train_fwd(*targs)
        bargs = (gy, x, wih, whh, lens, fwd[1], fwd[2])
        k3_fwd = [(*p, res) for p in pair]
        k3_bwd = [(gy[..., d * Hd:(d + 1) * Hd].contiguous(), x, wih[d], whh[d], lens,
                   fwd[1][d], fwd[2][d], bool(d)) for d in (0, 1)]
        xg = xf.clone().requires_grad_(True)
        ref_out, _ = ref(xg)
        ref_in = [xg, *ref.parameters()]
        timed = {
            "fwd_ms": time_ms(lambda: lstm_cuda.bilstm_seq_train_fwd(*targs), 5, 4, 1),
            "fwd_two_k3_ms": time_ms(lambda: [lstm_cuda.lstm_seq_train_fwd(*p)
                                              for p in k3_fwd], 5, 4, 1),
            "fwd_oracle_ms": time_ms(lambda: lstm_cuda._bilstm_seq_per_utterance(*targs),
                                     5, 4, 1),

            "plain_fwd_ms": time_ms(lambda: lstm_cuda.bilstm_seq_train_plain(*targs), 3, 1, 1),
            "plain_bwd_ms": time_ms(lambda: lstm_cuda.bilstm_seq_bwd_plain(*bargs), 3, 1, 1),
            "library_fwd_ms": time_ms(lambda: ref(xg), 5, 4, 1)}
        # The backward in turns: the dual grid, two K3 backward launches,
        # the per-utterance oracle and cuDNN's backward.
        bwd_turns = in_turns({
            "bwd": lambda: lstm_cuda.bilstm_seq_bwd(*bargs),
            "bwd_two_k3": lambda: [lstm_cuda.lstm_seq_bwd(*p) for p in k3_bwd],
            "bwd_oracle": lambda: lstm_cuda._bilstm_seq_bwd_per_utterance(*bargs),
            "library_bwd": lambda: torch.autograd.grad(ref_out, ref_in, gy, retain_graph=True)})
        timed.update({f"{n}_ms": statistics.median(v) for n, v in bwd_turns.items()})
        timed["bwd_turns_ms"] = bwd_turns
        timed["fwd_bound_ms"], timed["fwd_bound_by"] = bounds["train_fwd"]
        timed["bwd_bound_ms"], timed["bwd_bound_by"] = bounds["bwd"]
        timed["fwd_grid"] = grid_record(args, b, T, res, dual=True)
        print(f"bilstm_seq_train_fwd dual grid, {tag}: {json.dumps(timed['fwd_grid'])}")
        timed["bwd_grid"] = bwd_grid_record(bargs, max(lengths), dual=True)
        timed["bwd_grid"]["products_ms"] = sum(
            device_ms_per_call(lambda: lstm_cuda.bilstm_seq_bwd(*bargs), kernel, 5)
            for kernel in ("gemm_kernel", "column_sum_kernel", "add_halves_kernel"))
        print(f"bilstm_seq_bwd dual grid, {tag}: {json.dumps(timed['bwd_grid'])}, in turns "
              f"{json.dumps(bwd_turns)}")
        # The op's own path: without gradients, then under autograd.
        params = [t.clone().requires_grad_(True) for t in (x, wih, whh, bias)]
        plain = [(lstm_cuda, n) for n in ("bilstm_seq_plain", "bilstm_seq_train_plain",
                                          "bilstm_seq_bwd_plain")]
        torch.cuda.synchronize()
        build.reset_launches()
        with plain_calls_of(*plain) as plain_calls:
            with torch.no_grad():
                lstm_cuda.bilstm_seq(*args)
            y = lstm_cuda.bilstm_seq(*params, lens, torch.bfloat16)
            y.float().square().sum().backward()
            torch.cuda.synchronize()
        path_launches = {k: v for k, v in build.LAUNCHES.items() if v}
        check(path_launches == {"bilstm_seq": 1, "bilstm_seq_train_fwd": 1, "bilstm_seq_bwd": 1},
              f"bilstm_seq path launches {path_launches}")
        check(not plain_calls, f"a plain version ran on the bilstm_seq path: {plain_calls}")
        check(all(p.grad is not None and bool(torch.isfinite(p.grad.float()).all())
                  for p in params), "bilstm_seq path: non-finite gradients")
    head, shape = cases[0], (f"x ({B}, {T_LSTM}, {2 * H}) bf16, H {H}, lengths {LSTM_LENGTHS}; "
                             f"also x ({BEAM_B}, {T_LSTM}, 1024), H 512, forward")
    common = {"route": "cuda", "source": "pytorch_asr_tpu_torch/csrc/lstm_seq.cu",
              "shape": shape}
    out.append({"name": "bilstm_seq", **common,
                "replaces": "pytorch_asr_tpu/ops/lstm_pallas.py:703",
                "max_abs_err": max(c["max_abs_err"] for c in cases), "tol": LSTM_TOL,
                "ms": head["ms"], "plain_ms": head["plain_ms"], "library_ms": head["library_ms"],
                "library": "torch.nn.LSTM(bidirectional=True) (cuDNN, fp32, all lengths = T)",
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"], "cases": cases})
    for name, outs, stem, line, what in (
            ("bilstm_seq_train_fwd", ("out", "acts", "ct"), "fwd", 722, "forward"),
            ("bilstm_seq_bwd", ("dx", "dwih", "dwhh", "db"), "bwd", 822,
             "backward (autograd.grad, graph kept)")):
        out.append({
            "name": name, **common, "replaces": f"pytorch_asr_tpu/ops/lstm_pallas.py:{line}",
            "max_abs_err": max(r[o]["max_abs_err"] for r in train.values() for o in outs),
            "tol": {"float32": K3_F32_TOL, "bfloat16": K3_BF16_TOL},
            "ms": timed[f"{stem}_ms"], "two_k3_ms": timed[f"{stem}_two_k3_ms"],
            "oracle_ms": timed[f"{stem}_oracle_ms"], "grid": timed[f"{stem}_grid"],
            **({"turns_ms": timed["bwd_turns_ms"]} if stem == "bwd" else {}),
            "plain_ms": timed[f"plain_{stem}_ms"], "library_ms": timed[f"library_{stem}_ms"],
            "library": f"torch.nn.LSTM(bidirectional=True) (cuDNN, fp32) {what}",
            "bound_ms": timed[f"{stem}_bound_ms"], "bound_by": timed[f"{stem}_bound_by"],
            "residuals": {r: {o: v[o] for o in outs} | {
                k: v[k] for k in ("grads_bit_equal_k3", "grads_bit_equal_oracle")}
                          for r, v in train.items()}})
    return out, path_launches


def ctc_paired_phase() -> dict:
    """The paired alpha recursion at K4's shape (``ctc_case``: a row of no
    frames and an infeasible row), against its plain version and K4's
    alphas, and bit for bit against its wide form; the loss and gradient
    through it against K4's; timed in turns with K4's forward and
    ``F.ctc_loss``, with the pair's phase split from its trace."""
    logits, labels, logit_len, label_len, T = ctc_case()
    _, logp_tbs, _, skip = ctc.prep(logits, labels.long(), label_len, 0)
    S = logp_tbs.shape[2]
    alphas, final = ctc_cuda.ctc_alpha_paired(logp_tbs, skip, logit_len)
    torch.cuda.synchronize()
    ref_alphas, ref_final = ctc.alphas_paired_plain(logp_tbs, skip, logit_len)
    err = max(ctc_close("alphas", alphas, ref_alphas, CTC_RTOL, CTC_ALPHA_ATOL, "paired"),
              ctc_close("final alpha", final, ref_final, CTC_RTOL, CTC_ALPHA_ATOL, "paired"))
    wide, wide_final = ctc_cuda.ctc_alpha_paired(logp_tbs, skip, logit_len, wide=True)
    check(torch.equal(wide, alphas) and torch.equal(wide_final, final),
          "paired: the register form's bits differ from the wide form's")
    k4, _ = ctc_cuda.ctc_alpha(logp_tbs, skip, logit_len)
    live = k4 > ctc.NEG_INF / 2
    check(torch.equal(live, alphas > ctc.NEG_INF / 2), "paired: live states differ from K4's")
    k4_err = ctc_close("alphas vs K4", alphas[live], k4[live], CTC_RTOL, CTC_ALPHA_ATOL,
                       "paired")
    a, b = logits.clone().requires_grad_(True), logits.clone().requires_grad_(True)
    ref = ctc_cuda.ctc_loss(b, logit_len, labels, label_len)
    ref.sum().backward()
    ctc_cuda.PAIRED_FWD = True
    try:
        loss = ctc_cuda.ctc_loss(a, logit_len, labels, label_len)
        loss.sum().backward()
    finally:
        ctc_cuda.PAIRED_FWD = False
    loss_err = ctc_close("loss vs K4", loss, ref, PAIRED_LOSS_TOL, PAIRED_LOSS_TOL, "paired")
    grad_err = ctc_close("gradient vs K4", a.grad, b.grad, PAIRED_GRAD_TOL, PAIRED_GRAD_TOL,
                         "paired")
    lib, _ = ctc_library(logits, labels, logit_len, label_len)
    frames = int(logit_len.sum())
    # The paired alpha, K4's and the library call in turns (a b c c b a).
    fwd = in_turns({"kernel": lambda: ctc_cuda.ctc_alpha_paired(logp_tbs, skip, logit_len),
                    "k4": lambda: ctc_cuda.ctc_alpha(logp_tbs, skip, logit_len),
                    "library": lib}, reps=10, inner=10)
    return {"name": "ctc_alpha_paired", "route": "cuda",
            "source": "pytorch_asr_tpu_torch/csrc/ctc_alpha_beta.cu",
            "replaces": "pytorch_asr_tpu/ops/ctc_pallas.py:139",
            "shape": f"logp_tbs ({T}, {B}, {S}) f32, label_len {label_len.tolist()}, "
                     f"logit_len {logit_len.tolist()}",
            "plan": list(ctc_cuda.lane_plan(S)),
            "max_abs_err": err, "max_abs_err_vs_k4": k4_err, "loss_max_abs_err_vs_k4": loss_err,
            "grad_max_abs_err_vs_k4": grad_err,
            "tol": {"rtol": CTC_RTOL, "atol": CTC_ALPHA_ATOL, "loss_vs_k4": PAIRED_LOSS_TOL,
                    "grad_vs_k4": PAIRED_GRAD_TOL},
            "ms": statistics.mean(fwd["kernel"]), "k4_ms": statistics.mean(fwd["k4"]),
            "plain_ms": time_ms(lambda: ctc.alphas_paired_plain(logp_tbs, skip, logit_len),
                                3, 1, 1),
            "library_ms": statistics.mean(fwd["library"]),
            "library": "F.ctc_loss forward (zero_infinity)",
            "turns_ms": {"kernel, k4, library, library, k4, kernel": fwd},
            "frame_split_us": ctc_split(
                lambda tr: ctc_cuda.ctc_alpha_paired(logp_tbs, skip, logit_len, trace=tr), T,
                bench_kernel_turns.PAIRED_PHASES),
            **dict(zip(("bound_ms", "bound_by"), ctc_bound("paired", T, B, S, frames)))}


def train_paired_phase() -> dict:
    """The paired alpha's main path: ``train.main ctc_bilstm_dev1h`` at full
    width for a few steps with ``ops.ctc_cuda.PAIRED_FWD`` set in this
    process (restored after), as the JAX package's switch is set; every step
    launches the paired alpha and K4's beta, and no unpaired alpha."""
    with tempfile.TemporaryDirectory() as ckpt:
        argv = ["ctc_bilstm_dev1h", "data.synthetic_min_sec=10", "data.synthetic_max_sec=16",
                f"data.synthetic_num_utts={PAIRED_UTTS}", "data.auto_buckets=1",
                f"steps={PAIRED_STEPS}", f"train.eval_every={PAIRED_STEPS}",
                f"train.log_every={PAIRED_STEPS}", f"train.checkpoint_dir={ckpt}"]
        torch.cuda.synchronize()
        ctc_cuda.PAIRED_FWD = True
        try:
            build.reset_launches()
            t0 = time.perf_counter()
            result = train.main(argv)
            wall = time.perf_counter() - t0
            launches = {k: v for k, v in build.LAUNCHES.items() if v}
        finally:
            ctc_cuda.PAIRED_FWD = False
    last = result["train"]
    check(launches.get("ctc_alpha_paired") == PAIRED_STEPS
          and launches.get("ctc_beta") == PAIRED_STEPS and "ctc_alpha" not in launches,
          f"paired train launches {launches}")
    check(last.get("step") == PAIRED_STEPS and math.isfinite(last["ctc_loss"])
          and math.isfinite(last["grad_norm"]), f"paired train: bad record {last}")
    return {"record": last, "wall_s": wall, "launches": launches}


K13_PHASES = ("row", "extend", "absorb", "select", "picks", "copy")
K12_PHASES = ("wait", "row", "extend", "absorb", "select", "picks")


def launch_split(trace: torch.Tensor) -> dict:
    """K12's frames from its (T, 9) trace: block 0 of each launch, which may
    run on another SM each frame, so the clock rate comes from each frame's
    own span (its clocks over its global-clock span, summed); the median
    µs of each phase (``K12_PHASES``), the median global-clock time from
    one frame's start to the next's, and from a frame's end to the next
    frame's start (negative where the next frame's blocks started while the
    last frame ran: programmatic dependent launch)."""
    tr = trace.cpu().numpy().astype(np.float64)
    tr = tr[tr[:, 0] != 0]
    check(len(tr) > 1, "K12 trace: fewer than two frames written")
    ghz = (tr[:, 7] - tr[:, 1]).sum() / (tr[:, 8] - tr[:, 0]).sum()
    return {"frames": len(tr), "trace_clock_ghz": ghz,
            "frame_us_median": float(np.median(tr[1:, 0] - tr[:-1, 0])) / 1e3,
            "next_start_after_end_us_median": float(np.median(tr[1:, 0] - tr[:-1, 8])) / 1e3,
            "us_median": {n: float(np.median(tr[:, i + 2] - tr[:, i + 1])) / ghz / 1e3
                          for i, n in enumerate(K12_PHASES)}}


def in_turns(fns: dict, reps: int = 5, inner: int = 4) -> dict:
    """Each of ``fns`` ({name: call}) timed with ``time_ms`` in turns, a b b
    a: {name: [ms, ms]}."""
    names = list(fns)
    order = names + names[::-1]
    out = {n: [] for n in names}
    for n in order:
        out[n].append(time_ms(fns[n], reps, inner, 1))
    return out


def study_beam_phase() -> list[dict]:
    """K13 (tokens carried) and K12 (a launch a frame), K 16, L 256, at two
    shapes: K7's row shape, config 2's random-weight model logits for 16
    utterances of 10-16 s, with each row's transcript planted and as they
    are, the last row cut to no frames; and the benchmark scripts' shape,
    their seed's (16, 1000, 32) logits, where the best beams fill L (the
    full-buffer path: appends dropped, dead fillers from full beams, the
    backtrace capped at L).  Tokens, lengths and scores bit for bit against
    the plain search, and K12's pointers of every frame and its last state
    against the plain frames.  Both kernels are timed in turns at each shape
    beside K7, with block 0's frame split (their traces, at K7's shape);
    K12 also by the profiler's device time of its frame kernel, whose
    difference to the event time a frame is the launch's share of a frame."""
    cfg = get_config(CFG2, **{"data.synthetic_min_sec": "10", "data.synthetic_max_sec": "16",
                              "data.synthetic_num_utts": str(BEAM_B), "data.auto_buckets": "1"})
    logits, lens = cfg2_batch_logits(cfg)
    B2, T, V2 = logits.shape
    batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    path = transcript_path(batch, lens.cpu(), T).to(CARD)
    planted = logits.clone()
    planted.scatter_add_(2, path[..., None], torch.full((B2, T, 1), 4.0, device=CARD))
    ragged = lens.clone().to(torch.int32)
    ragged[B2 - 1] = 0
    bench = bench_beam_compile.DEFAULTS
    _, bench_logits, bench_lens = _timing.random_logits(
        int(bench["batches"].split(",")[0]), int(bench["T"]), int(bench["V"]), CARD)
    kw = dict(beam_size=BEAM_K, max_len=BEAM_L)
    fns = {"prefix_beam_fused": beam_cuda.prefix_beam_fused,
           "prefix_beam_stepwise": beam_cuda.prefix_beam_lanes_stepwise}
    cases = {name: [] for name in fns}
    for which, lg, ln in (("planted", planted, ragged), ("model", logits, ragged),
                          ("bench_scripts", bench_logits, bench_lens)):
        want = prefix_beam.prefix_beam_search_plain(lg, ln, **kw)
        k7 = prefix_beam.prefix_beam_search(lg, ln, **kw)
        check(all(torch.equal(a, w) for a, w in zip(k7, want)), f"K7 {which}: differs")
        full = int((want[1] == BEAM_L).sum())
        check(which != "bench_scripts" or full > 0, "bench_scripts: no best beam fills L")
        scratch = {}
        for name, fn in fns.items():
            build.reset_launches()
            got = fn(lg, ln, **kw, **({"scratch": scratch} if name == "prefix_beam_stepwise"
                                      else {}))
            torch.cuda.synchronize()
            n = {k: v for k, v in build.LAUNCHES.items() if v}
            check(n == {name: 1 if name == "prefix_beam_fused" else lg.shape[1]},
                  f"{name}: launches {n}")
            for part, a, w in zip(("tokens", "lengths", "scores"), got, want):
                check(a.dtype == w.dtype and torch.equal(a, w),
                      f"{name} {which}: {part} differ from the plain search")
            if which != "bench_scripts":
                check(got[1][B2 - 1] == 0 and got[2][B2 - 1] == 0, f"{name}: the empty row")
            cases[name].append({"logits": which, "shape": list(lg.shape),
                                "mean_len": got[1].float().mean().item(), "rows_full": full,
                                "bit_equal": True})
        steps = prefix_beam.prefix_beam_stepwise_plain(
            torch.log_softmax(lg.float(), -1), ln, BEAM_K, BEAM_L)
        for f, w in steps.items():
            g = scratch[f]
            if not torch.equal(g, w):
                bad = (g != w).reshape(g.shape[0], -1, BEAM_K).any(2).any(0).nonzero()
                check(False, f"K12 {which}: {f} differs from the plain frames"
                             + (f" from frame {int(bad[0])}" if f in ("parent", "append")
                                else " after the last frame"))
        cases["prefix_beam_stepwise"][-1]["pointers_and_state_bit_equal"] = True
    # The traces change no bit, and split block 0's frames.
    splits = {}
    for name, cols, split in (("prefix_beam_fused", 8, lambda tr: frame_split(tr, K13_PHASES)),
                              ("prefix_beam_stepwise", 9, launch_split)):
        trace = torch.zeros((T, cols), dtype=torch.int64, device=CARD)
        got = fns[name](logits, ragged, **kw, trace=trace)
        check(all(torch.equal(a, b) for a, b in zip(got, fns[name](logits, ragged, **kw))),
              f"{name}: the traced run differs")
        splits[name] = split(trace)
    logp = torch.log_softmax(logits.float(), -1).contiguous()
    frames, lens32 = int(ragged.sum()), ragged.contiguous()

    def calls(lg, ln):
        return {"prefix_beam_search": lambda: prefix_beam.prefix_beam_search(lg, ln, **kw),
                **{n: lambda fn=fn: fn(lg, ln, **kw) for n, fn in fns.items()}}

    turns = {"k7_shape": in_turns(calls(logits, ragged)),
             "scripts_shape": in_turns(calls(bench_logits, bench_lens))}
    plain_ms = time_ms(lambda: prefix_beam.beam_scan_plain(logp, lens32, BEAM_K, BEAM_L),
                       3, 1, 1)
    out = []
    for name, line in (("prefix_beam_fused", 313), ("prefix_beam_stepwise", 905)):
        fn = fns[name]
        ms = statistics.median(turns["k7_shape"][name])
        b_ms, b_by = study_bound(frames, B2, T, BEAM_K, V2, BEAM_L,
                                 name == "prefix_beam_stepwise")
        entry = {"name": name, "route": "cuda",
                 "source": "pytorch_asr_tpu_torch/csrc/prefix_beam_study.cu",
                 "replaces": f"pytorch_asr_tpu/ops/beam_pallas.py:{line}",
                 "shape": f"logp ({B2}, {T}, {V2}) f32, lengths {ragged.tolist()}, K {BEAM_K}, "
                          f"L {BEAM_L}, no LM",
                 "max_abs_err": 0.0, "tol": "tokens, lengths and scores bit-equal",
                 "ms": ms, "ms_in_turns": turns["k7_shape"][name],
                 "k7_ms_in_turns": turns["k7_shape"]["prefix_beam_search"],
                 "scripts_shape": {"shape": list(bench_logits.shape),
                                   "ms_in_turns": turns["scripts_shape"][name],
                                   "k7_ms_in_turns": turns["scripts_shape"]["prefix_beam_search"]},
                 "plain_ms": plain_ms, "library_ms": None,
                 "library": "none: no PyTorch call computes a prefix beam search",
                 "bound_ms": b_ms, "bound_by": b_by, "frame_split_us": splits[name],
                 "cases": cases[name]}
        if name == "prefix_beam_stepwise":
            device = device_ms_per_call(lambda fn=fn: fn(logits, ragged, **kw),
                                        "beam_step_kernel", calls=3) / T
            entry.update({"ms_per_frame": ms / T, "bound_ms_per_frame": b_ms / T,
                          "frame_kernel_device_ms": device,
                          "launch_gap_ms": ms / T - device})
        out.append(entry)
    return out


def bench_scripts_phase() -> dict:
    """K13's and K12's main paths: the ported benchmark scripts in this
    process at their default widths (B 16, T 1000, K 16, V 32) with one
    timed call an arm, ``bench_prefix_beam fused=1`` (its hashed-LM arm too:
    the hashed K7 once a call) and ``bench_beam_compile stepwise=1
    batches=16``, each with the counters set to 0 just before and read just
    after: K13 once a call, K12 T a call.
    ``study_beam_phase`` holds both kernels to the plain search on the
    scripts' own logits."""
    out = {}
    for name, main, argv, kernel, per_frame in (
            ("bench_prefix_beam", bench_prefix_beam.main, ["fused=1", "iters=1"],
             "prefix_beam_fused", False),
            ("bench_beam_compile", bench_beam_compile.main,
             ["stepwise=1", "batches=16", "iters=1"], "prefix_beam_stepwise", True)):
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        res = main(argv)
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
        want = res["calls_per_arm"] * (res["T"] if per_frame else 1)
        check(launches.get(kernel) == want,
              f"{name}: {kernel} launched {launches.get(kernel)} times, not {want}")
        check(name != "bench_prefix_beam" or launches.get("prefix_beam_hashed") == want,
              f"{name}: the hashed arm launched {launches.get('prefix_beam_hashed')} times")
        check(all(math.isfinite(a["ms"]) and a["ms"] > 0 for a in res["arms"].values()),
              f"{name}: bad timings {res['arms']}")
        out[name] = {**res, "argv": argv, "wall_s": wall, "launches": launches}
    # The streaming script: each arm's calls run one block each, counted by
    # the script itself (K9's LM, E 64 x 1 layer, on its grid at B 1).
    t0 = time.perf_counter()
    res = bench_streaming.main(["B=1", "blocks=16", "chunks=8"])
    for arm, kernel in (("greedy_16", None), ("beam_16", "prefix_beam_carry"),
                        ("beam_rnnlm_16", "prefix_beam_rnn_carry")):
        want = {"stft_log_mel": 8, "lstm_seq_stream": 4 * 8, **({kernel: 8} if kernel else {})}
        check(res["arms"][arm]["launches"] == want,
              f"bench_streaming {arm}: launches {res['arms'][arm]['launches']} != {want}")
        check(math.isfinite(res["arms"][arm]["p50_ms"]), f"bench_streaming {arm}: {res}")
    out["bench_streaming"] = {**res, "wall_s": time.perf_counter() - t0}
    return out


def slice_phase(config: str = "ctc_bilstm_dev1h") -> dict:
    """Full width, float32 compute, one short synthetic batch of 8: card vs CPU."""
    cfg = get_config(config, **{"model.compute_dtype": "float32", "data.synthetic_num_utts": "8",
                                "data.batch_size": "8", "data.auto_buckets": "1"})
    batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    outs = {}
    for name, device in (("cpu", torch.device("cpu")), ("card", CARD)):
        model = build_model(cfg, device)
        with torch.inference_mode():
            out = model(torch.from_numpy(batch["audio"]).to(device),
                        torch.from_numpy(batch["audio_len"]).to(device))
        outs[name] = {k: v.cpu() for k, v in out.items()}
    cpu, gpu = outs["cpu"], outs["card"]
    check(torch.equal(cpu["enc_len"], gpu["enc_len"]), "slice: enc_len differs")
    check(bool(torch.isfinite(gpu["ctc_logits"]).all()), "slice: non-finite logits")
    err, _ = errors(gpu["ctc_logits"], cpu["ctc_logits"])
    check(err <= SLICE_TOL, f"slice logits card vs CPU: {err}")
    top2 = cpu["ctc_logits"].topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * SLICE_TOL
    same = gpu["ctc_logits"].argmax(-1)[clear] == cpu["ctc_logits"].argmax(-1)[clear]
    check(bool(same.all()), "slice: greedy tokens differ where the top-2 gap is clear")
    ids_c, n_c = greedy_ctc(cpu["ctc_logits"], cpu["enc_len"])
    ids_g, n_g = greedy_ctc(gpu["ctc_logits"], gpu["enc_len"])
    return {"logits_max_abs_err": err, "tol": SLICE_TOL,
            "clear_frames": float(clear.float().mean()),
            "tokens_equal": bool(torch.equal(ids_c, ids_g) and torch.equal(n_c, n_g)),
            "shape": list(gpu["ctc_logits"].shape)}


def train_step_phase(config: str = "ctc_bilstm_dev1h", front: str = "encoder.conv.",
                     **extra: str) -> dict:
    """One float32 train step at full width, card vs CPU, from the same seeded
    weights and batch, dropout 0, SpecAugment and waveform augmentation off
    (``extra``: more overrides).  Both save float32 LSTM residuals: bf16
    residuals would round differently on the two devices.  ``front`` names
    the convs that see the log-mel directly.  A parameter off the loss's
    graph (config 4's CTC head) has no gradient on either device."""
    cfg = get_config(config, **{
        "model.compute_dtype": "float32", "model.encoder.dropout": "0.0",
        "frontend.specaugment": "false", "frontend.waveform_augment": "false",
        "data.synthetic_num_utts": str(B), "data.batch_size": str(B),
        "data.auto_buckets": "1", "train.optim.peak_lr": "1e-3",
        "train.optim.warmup_steps": "1", **extra})
    batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    runs = {}
    for name, dev in (("cpu", torch.device("cpu")), ("card", CARD)):
        model = set_residual_dtype(train_state.build_model(cfg, dev), torch.float32)
        st = train_state.init_train_state(cfg, model)
        before = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        aux = train_state.train_step(cfg, st, train_state.batch_to_device(batch, dev))
        runs[name] = {"aux": aux, "before": before,
                      "grads": {k: p.grad.cpu() for k, p in model.named_parameters()
                                if p.grad is not None},
                      "after": {k: v.cpu() for k, v in model.state_dict().items()}}
    cpu, gpu = runs["cpu"], runs["card"]
    check(cpu["grads"].keys() == gpu["grads"].keys(), "train step: gradients of other params")
    loss_c, loss_g = float(cpu["aux"]["loss"]), float(gpu["aux"]["loss"])
    check(math.isfinite(loss_g) and abs(loss_g - loss_c) <= STEP_LOSS_RTOL * abs(loss_c),
          f"train step loss card {loss_g} vs CPU {loss_c}")
    lr = gpu["aux"]["lr"]
    check(lr == cpu["aux"]["lr"], "train step: lr differs")
    grad_rel = {}
    for k, gc in cpu["grads"].items():
        _, grad_rel[k] = errors(gpu["grads"][k], gc)
        tol = STEP_CONV_GRAD_TOL if k.startswith(front) else STEP_GRAD_TOL
        check(grad_rel[k] <= tol, f"train step gradient {k}: {grad_rel[k]} of its largest entry")
    worst = sorted(grad_rel.items(), key=lambda kv: -kv[1])
    conv_rel = max(v for k, v in worst if k.startswith(front))
    rest_rel = max(v for k, v in worst if not k.startswith(front))
    param_err = max(errors(gpu["after"][k], v)[0] for k, v in cpu["after"].items())
    check(param_err <= 2 * lr, f"params after one AdamW step differ by {param_err} > 2 lr")
    moved = max(errors(v, cpu["before"][k])[0] for k, v in cpu["after"].items())
    return {"loss_cpu": loss_c, "loss_card": loss_g, "loss_rtol": STEP_LOSS_RTOL,
            "terms": {k: [float(cpu["aux"][k]), float(gpu["aux"][k])]
                      for k in ("ctc_loss", "ce_loss") if k in cpu["aux"]},
            "no_grad": sorted(set(cpu["after"]) - set(cpu["grads"])),
            "grad_norm_cpu": float(cpu["aux"]["grad_norm"]),
            "grad_norm_card": float(gpu["aux"]["grad_norm"]),
            "conv_grad_max_rel_err": conv_rel, "conv_grad_tol": STEP_CONV_GRAD_TOL,
            "grad_max_rel_err": rest_rel, "grad_tol": STEP_GRAD_TOL, "worst_grads": worst[:4],
            "param_max_abs_err": param_err, "param_tol": 2 * lr, "param_max_move": moved,
            "audio_len": batch["audio_len"].tolist()}


def train_main_phase(extra: tuple[str, ...] = (), dirs: int = 2) -> dict:
    """The training main path: ``train.main`` at full width in bf16, full
    batches of 8 utterances of 10-16 s, then one greedy eval of 8 batches;
    with the overrides ``extra`` (the causal model: ``CAUSAL``, ``dirs`` 1)."""
    with tempfile.TemporaryDirectory() as ckpt:
        argv = ["ctc_bilstm_dev1h", "data.synthetic_min_sec=10", "data.synthetic_max_sec=16",
                f"data.synthetic_num_utts={TRAIN_UTTS}", "data.auto_buckets=1",
                f"steps={TRAIN_STEPS}", f"train.eval_every={TRAIN_STEPS}",
                f"train.log_every={TRAIN_STEPS}", f"train.checkpoint_dir={ckpt}", *extra]
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        result = train.main(argv)
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
    last, ev = result["train"], result["eval"]
    want = {"stft_log_mel": TRAIN_STEPS + EVAL_BATCHES,
            "lstm_seq": dirs * LAYERS * EVAL_BATCHES,
            "lstm_seq_train_fwd": dirs * LAYERS * TRAIN_STEPS,
            "lstm_seq_bwd": dirs * LAYERS * TRAIN_STEPS,
            "ctc_alpha": TRAIN_STEPS, "ctc_beta": TRAIN_STEPS}
    check({k: v for k, v in launches.items() if v} == want,
          f"train launches {launches} != {want}")
    check(last.get("step") == TRAIN_STEPS and math.isfinite(last["ctc_loss"])
          and math.isfinite(last["grad_norm"]), f"train: bad record {last}")
    check(ev.get("num_utts") == EVAL_BATCHES * B, f"train eval: {ev}")
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()
                if k not in ("lstm_seq", "stft_log_mel")}
    per_step["stft_log_mel"] = (launches["stft_log_mel"] - EVAL_BATCHES) / TRAIN_STEPS
    return {"record": last, "eval": ev, "wall_s": wall,
            "step_s": 1.0 / last["steps_per_sec"], "launches": launches,
            "launches_per_step": per_step,
            "lstm_seq_per_eval_batch": launches["lstm_seq"] / EVAL_BATCHES}


def learn_phase(arpa: str, rnn_lm: str) -> dict:
    """The tiny config of the JAX package's end-to-end test, on the card: its
    loss must fall below half the first logged value and its greedy WER below
    0.3 after 300 steps.  Then ``Trainer.decode_eval`` decodes the learned
    model with config 2's prefix beam search, with the 4-gram LM and with the
    RNN LM: neither WER may exceed the greedy WER."""
    cfg = dataclasses.replace(
        get_config("ctc_bilstm_dev1h"),
        frontend=FrontendConfig(specaugment=False),
        data=DataConfig(batch_size=4, bucket_audio_lens=(40000,), bucket_label_lens=(48,),
                        synthetic_num_utts=24),
        model=ModelConfig(encoder=BiLSTMEncoderConfig(conv_channels=(8, 8), hidden_dim=96,
                                                      num_layers=2, dropout=0.0),
                          compute_dtype="float32"),
        train=TrainConfig(optim=OptimConfig(peak_lr=3e-3, warmup_steps=30, total_steps=400,
                                            grad_clip_norm=5.0), log_every=50))
    corpus = synthetic_corpus(cfg.data.synthetic_num_utts, cfg.frontend.sample_rate, seed=0,
                              min_words=1, max_words=3)
    dataset = BucketedDataset(corpus, batch_size=cfg.data.batch_size,
                              bucket_audio_lens=cfg.data.bucket_audio_lens,
                              bucket_label_lens=cfg.data.bucket_label_lens)
    t0 = time.perf_counter()
    with Trainer(cfg, dataset=dataset, enable_checkpoints=False, device=CARD) as trainer:
        first = trainer.train(num_steps=LEARN_STEPS[0])
        rest = trainer.train(num_steps=LEARN_STEPS[1])
        result = trainer.evaluate()
        wall = time.perf_counter() - t0
        c2 = get_config(CFG2).decode
        trainer.cfg = dataclasses.replace(cfg, decode=DecodeConfig(
            method="prefix_beam", beam_size=c2.beam_size, lm_path=arpa,
            lm_alpha=c2.lm_alpha, lm_beta=c2.lm_beta))
        build.reset_launches()
        beam = trainer.decode_eval()
        beam_launches = build.LAUNCHES["prefix_beam"]
        trainer.cfg = dataclasses.replace(trainer.cfg, decode=dataclasses.replace(
            trainer.cfg.decode, lm_path=rnn_lm))
        build.reset_launches()
        rnn = trainer.decode_eval()
        rnn_launches = build.LAUNCHES["prefix_beam_rnn"]
    check(rest["ctc_loss"] < 0.5 * first["ctc_loss"],
          f"learn: ctc_loss {rest['ctc_loss']} not below half of {first['ctc_loss']}")
    check(result["wer"] < 0.3 and result["num_utts"] == 24, f"learn: {result}")
    check(beam["num_utts"] == 24 and beam_launches > 0 and beam["wer"] <= result["wer"],
          f"learn: beam + LM {beam} ({beam_launches} K7 launches) vs greedy {result}")
    check(rnn["num_utts"] == 24 and rnn_launches > 0 and rnn["wer"] <= result["wer"],
          f"learn: beam + RNN LM {rnn} ({rnn_launches} K9 launches) vs greedy {result}")
    return {"first_ctc_loss": first["ctc_loss"], "last_ctc_loss": rest["ctc_loss"],
            "wer": result["wer"], "cer": result["cer"], "steps": sum(LEARN_STEPS),
            "wall_s": wall, "beam_lm_wer": beam["wer"], "beam_lm_cer": beam["cer"],
            "beam_lm_k7_launches": beam_launches, "beam_rnn_lm_wer": rnn["wer"],
            "beam_rnn_lm_cer": rnn["cer"], "beam_rnn_lm_k9_launches": rnn_launches}


def build_lm() -> str:
    """Config 2's LM, made at run time by the port's ``train_ngram``: an
    order-4 Kneser-Ney char LM of ``synthetic_texts(512)``, into the build
    directory (gitignored)."""
    path = build.BUILD_DIR / "syn4.arpa"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    train_ngram.main([str(path), "num_synthetic=512", "order=4"])
    return str(path)


def build_rnn_lm() -> tuple[str, dict]:
    """Config 2's RNN LM, trained on the card at run time by the port's
    ``train_lm`` at its default widths on ``synthetic_texts(256)``, into the
    build directory (gitignored).  Returns its path and the CLI's record."""
    path = build.BUILD_DIR / "rnn_lm.npz"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    record = train_lm.main([str(path), f"steps={LM_STEPS}", "log_every=100"])
    torch.cuda.synchronize()
    record["wall_s"] = time.perf_counter() - t0
    # uniform over the 31 chars is log(31) ~ 3.43 nats
    check(math.isfinite(record["nll"]) and record["nll"] < 3.0, f"train_lm: {record}")
    return str(path), record


def cfg2_batch_logits(cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """Config 2's random-weight model on one full synthetic batch of 16
    utterances of 10-16 s: (ctc_logits (16, T', 31) f32, enc_len)."""
    batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    with torch.inference_mode():
        out = model_outputs(build_model(cfg, CARD), batch)
    return out["ctc_logits"], out["enc_len"]


def beam_phase(arpa: str) -> list[dict]:
    """K7 and K8 against the plain search, both on the card, at config 2's
    serving shapes: B 16, T' ~ 400, V 31, K 16, L 256, A 8; on planted-path
    logits (random plus a planted path, as tests/test_tpu_parity.py plants
    one) and on the random-weight model's logits, each with no LM and with
    the 4-gram table.  The kernels are timed on the model logits with the
    table, the serving path's case, and block 0's frame is split into its
    phases (its trace)."""
    cfg = get_config(CFG2, **{"data.synthetic_min_sec": "10", "data.synthetic_max_sec": "16",
                              "data.synthetic_num_utts": str(BEAM_B), "data.auto_buckets": "1"})
    logits, lens = cfg2_batch_logits(cfg)
    B, T, V = logits.shape
    rng = np.random.default_rng(19)
    planted = rng.standard_normal((B, T, V)).astype(np.float32)
    path = rng.integers(0, V, size=(B, T))
    for b in range(B):
        planted[b, np.arange(T), path[b]] += 4.0
    table = driver.load_lm(get_config(CFG2, **{"decode.lm_path": arpa}), CARD)
    dec = cfg.decode
    inputs = {"planted": (torch.from_numpy(planted).to(CARD), lens), "model": (logits, lens)}
    out = []
    for name, A, line in (("prefix_beam", 0, 756), ("prefix_beam_topa", BEAM_A, 1566)):
        cases = []
        for which, (lg, ln) in inputs.items():
            for lm in (None, table):
                kw = dict(beam_size=BEAM_K, max_len=BEAM_L, ext_top_a=A, lm_table=lm,
                          lm_alpha=dec.lm_alpha if lm is not None else 0.0,
                          lm_beta=dec.lm_beta if lm is not None else 0.0)
                build.reset_launches()
                got = prefix_beam.prefix_beam_search(lg, ln, **kw)
                torch.cuda.synchronize()
                check(build.LAUNCHES[name] == 1, f"{name}: {dict(build.LAUNCHES)}")
                want = prefix_beam.prefix_beam_search_plain(lg, ln, **kw)
                tag = f"{name} {which} {'4-gram' if lm is not None else 'no LM'}"
                check(torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]),
                      f"{tag}: tokens or lengths differ from the plain search")
                torch.testing.assert_close(got[2], want[2], rtol=BEAM_RTOL, atol=0,
                                           msg=lambda m, tag=tag: f"{tag} scores: {m}")
                cases.append({"logits": which, "lm": lm is not None,
                              "max_abs_err": (got[2] - want[2]).abs().max().item(),
                              "mean_len": got[1].float().mean().item()})
        logp, (tv, ti) = prefix_beam._prepare(logits, A)
        args = (logp, lens.to(torch.int32).contiguous(), BEAM_K, BEAM_L, table, dec.lm_alpha,
                dec.lm_beta, tv, ti)
        C = A or V
        b_ms, b_by = search_bound(int(lens.sum()), BEAM_K, C, V, A, B, BEAM_L,
                                  table.numel() * 4)
        trace = torch.zeros((T, 2 + len(K7_PHASES)), dtype=torch.int64, device=CARD)
        beam_cuda.prefix_beam(*args, trace=trace)
        out.append({
            "name": name, "route": "cuda", "source": "pytorch_asr_tpu_torch/csrc/prefix_beam.cu",
            "replaces": f"pytorch_asr_tpu/ops/beam_pallas.py:{line}",
            "shape": f"logp ({B}, {T}, {V}) f32, lengths {lens.tolist()}, K {BEAM_K}, "
                     f"L {BEAM_L}, C {C}, table {tuple(table.shape)}",
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "tol": {"tokens": "equal", "scores_rtol": BEAM_RTOL},
            "ms": time_ms(lambda: beam_cuda.prefix_beam(*args)),
            "frame_split_us": frame_split(trace, K7_PHASES),
            "plain_ms": time_ms(lambda: prefix_beam.beam_scan_plain(*args), 3, 1, 1),
            "library_ms": None, "library": "none: no PyTorch call computes a prefix beam search",
            "bound_ms": b_ms, "bound_by": b_by, "cases": cases})
    return out


@contextlib.contextmanager
def lm_steps_counted():
    """Counts the LM steps the plain search's frames need: beams that append
    a char at a frame inside their row's length, the steps K9 computes."""
    count, fn = [0], prefix_beam._advance_lm

    def counted(rnn_lm, carry, parent, append, active):
        count[0] += int(((append >= 0) & active[:, None]).sum())
        return fn(rnn_lm, carry, parent, append, active)

    prefix_beam._advance_lm = counted
    try:
        yield count
    finally:
        prefix_beam._advance_lm = fn


def transcript_path(batch: dict, lens: torch.Tensor, T: int) -> torch.Tensor:
    """(B, T) int64 CTC path of each row's transcript: its n chars on the
    first frames of n equal spans of the row's frames, blanks elsewhere."""
    path = torch.zeros((len(lens), T), dtype=torch.long)
    for b, n_t in enumerate(lens.tolist()):
        ids = torch.from_numpy(batch["tokens"][b, : batch["token_len"][b]]).long()[:n_t]
        n = len(ids)
        if n:
            path[b, (torch.arange(n) * n_t + n - 1) // n] = ids
    return path


def rnn_beam_phase(rnn_lm_path: str) -> list[dict]:
    """K9 against the plain search, both on the card, at config 2's serving
    shapes (B 16, T' ~ 400, V 31, K 16, L 256) with the trained LM (E 128,
    H 256, 2 layers), over all chars and each frame's top 8: on the
    random-weight model's logits plus a planted path, the last row cut to no
    frames, tokens and lengths exact and scores within RNN_RTOL / RNN_ATOL;
    on the model's logits alone, the share of rows with equal tokens
    (information only).  Timed on the model's logits, the serving path's
    case: on the co-resident grid (the route config 2 takes), in turns with
    the block kernel (which must give the grid's tokens on the planted
    input), and CTA 0's frame split into its phases (the grid's trace).

    The planted path is each row's transcript (~200 chars, below L), not
    a random char a frame: a random path of ~380 chars fills the beams to L,
    and full beams only stay, so their candidates tie to the last ulps and
    the LM's rounding decides (on the card the kernel then agreed with a
    float64 plain search where the float32 one did not)."""
    cfg = get_config(CFG2, **{"data.synthetic_min_sec": "10", "data.synthetic_max_sec": "16",
                              "data.synthetic_num_utts": str(BEAM_B), "data.auto_buckets": "1",
                              "decode.lm_path": rnn_lm_path})
    logits, lens = cfg2_batch_logits(cfg)
    B, T, V = logits.shape
    batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    path = transcript_path(batch, lens.cpu(), T).to(CARD)
    planted = logits.clone()
    planted.scatter_add_(2, path[..., None], torch.full((B, T, 1), 4.0, device=CARD))
    ragged = lens.clone()
    ragged[B - 1] = 0
    rnn = driver.load_lm(cfg, CARD)
    lmc, dec, sos = rnn.cfg, cfg.decode, get_tokenizer(cfg.data.vocab).sos_id
    h0, c0, lmp0 = prefix_beam.primed_lm_state(rnn, sos)
    n_weights = sum(p.numel() for p in rnn.parameters())
    out = []
    for name, A in (("prefix_beam_rnn", 0), ("prefix_beam_rnn_topa", BEAM_A)):
        kw = dict(beam_size=BEAM_K, max_len=BEAM_L, ext_top_a=A, rnn_lm=rnn, sos_id=sos,
                  lm_alpha=dec.lm_alpha, lm_beta=dec.lm_beta)
        build.reset_launches()
        got = prefix_beam.prefix_beam_search(planted, ragged, **kw)
        torch.cuda.synchronize()
        check({k: v for k, v in build.LAUNCHES.items() if v} == {name: 1},
              f"{name}: {dict(build.LAUNCHES)}")
        want = prefix_beam.prefix_beam_search_plain(planted, ragged, **kw)
        check(torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]),
              f"{name} planted: tokens or lengths differ from the plain search")
        torch.testing.assert_close(got[2], want[2], rtol=RNN_RTOL, atol=RNN_ATOL,
                                   msg=lambda m, name=name: f"{name} planted scores: {m}")
        check(got[1][B - 1] == 0 and got[2][B - 1] == 0, f"{name}: the empty row")
        model_got = prefix_beam.prefix_beam_search(logits, lens, **kw)
        with lm_steps_counted() as lm_steps:
            model_want = prefix_beam.prefix_beam_search_plain(logits, lens, **kw)
        same = (got_rows := (model_got[0] == model_want[0]).all(1)
                & (model_got[1] == model_want[1])).float().mean().item()
        logp, (tv, ti) = prefix_beam._prepare(logits, A)
        args = (logp, lens.to(torch.int32).contiguous(), BEAM_K, BEAM_L, rnn, h0, c0, lmp0,
                dec.lm_alpha, dec.lm_beta, tv, ti)
        frames, C, Hd = int(lens.sum()), A or V, lmc.hidden_dim
        route = beam_cuda.rnn_grid_route(B, BEAM_K, C, V, lmc.num_layers, lmc.embed_dim, Hd,
                                         build.sm_count(0))
        check(route is not None, f"{name}: config 2 does not fit K9's grid")
        planted_logp, (ptv, pti) = prefix_beam._prepare(planted, A)
        block = beam_cuda.rnn_on_route(None, planted_logp, ragged.to(torch.int32).contiguous(),
                                       *args[2:10], ptv, pti)
        check(torch.equal(block[0], got[0]) and torch.equal(block[1], got[1]),
              f"{name} planted: the block kernel's tokens differ from the grid's")
        times = {"ms": [], "block_ms": []}
        for which in ("ms", "block_ms", "block_ms", "ms"):
            times[which].append(time_ms(
                lambda r=route if which == "ms" else None: beam_cuda.rnn_on_route(r, *args),
                5, 2, 1))
        trace = torch.zeros((T, 2 + len(k9_phases(lmc.num_layers))), dtype=torch.int64,
                            device=CARD)
        beam_cuda.rnn_on_route(route, *args, trace=trace)
        b_ms, b_by = search_bound(
            frames, BEAM_K, C, V, A, B, BEAM_L, 4 * (n_weights + 2 * lmc.num_layers * Hd + V),
            lm_steps[0] * lm_step_ops(lmc, V))
        out.append({
            "name": name, "route": "cuda", "source": "pytorch_asr_tpu_torch/csrc/prefix_beam.cu",
            "replaces": "pytorch_asr_tpu/ops/beam_pallas.py:1452",
            "shape": f"logp ({B}, {T}, {V}) f32, lengths {lens.tolist()}, K {BEAM_K}, "
                     f"L {BEAM_L}, C {C}, LM E {lmc.embed_dim} H {Hd} x {lmc.num_layers}",
            "max_abs_err": (got[2] - want[2]).abs().max().item(),
            "tol": {"tokens": "equal", "scores_rtol": RNN_RTOL, "scores_atol": RNN_ATOL},
            "model_logits_rows_equal": same,
            "model_logits_max_abs_err": (model_got[2] - model_want[2])[got_rows].abs().max()
            .item() if bool(got_rows.any()) else None,
            "lm_steps": lm_steps[0], "lm_steps_per_frame": lm_steps[0] / frames,
            "grid": route._asdict(), "ms": statistics.median(times["ms"]),
            "ms_in_turns": times["ms"], "block_ms_in_turns": times["block_ms"],
            "frame_split_us": frame_split(trace, k9_phases(lmc.num_layers)),
            "plain_ms": time_ms(lambda: prefix_beam.beam_scan_plain(
                *args[:4], None, *args[8:], rnn_lm=rnn, lm_state=(h0, c0, lmp0)), 3, 1, 1),
            "library_ms": None, "library": "none: no PyTorch call computes a prefix beam search",
            "bound_ms": b_ms, "bound_by": b_by})
    return out


@contextlib.contextmanager
def plain_calls_of(*targets):
    """Wrap each (module, name) plain version so that its calls record the
    device of their first argument; yields that list, and restores them."""
    calls, saved = [], [(mod, name, getattr(mod, name)) for mod, name in targets]

    def counted(fn):
        def run(x, *args, **kwargs):
            # A merge's stays, a carried search's BeamState, else a tensor.
            first = x["pb"] if isinstance(x, dict) else getattr(x, "pb", x)
            calls.append(first.device.type)
            return fn(x, *args, **kwargs)
        return run

    for mod, name, fn in saved:
        setattr(mod, name, counted(fn))
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def beam_decode_phase(lm_path: str, top_a: int) -> dict:
    """Config 2's serving path through ``decode.main`` at full width with the
    LM at ``lm_path`` (the 4-gram ARPA or the RNN LM's ``.npz``) and its own
    decode ladder (14 buckets over 64 utterances of 10-16 s, so batches may
    be partly filled), DECODE_BATCHES batches: exactly 1 K1, 8 K2 and 1 beam kernel a
    batch (K7, K8 with ``decode.ext_top_a``; K9 over all chars or the top-A
    with the RNN LM), no other kernel, and no call of the plain search on
    the card."""
    with tempfile.TemporaryDirectory() as ckpt, plain_calls_of(
            (prefix_beam, "beam_scan_plain")) as plain_calls:
        argv = [CFG2, f"decode.lm_path={lm_path}", "data.synthetic_min_sec=10",
                "data.synthetic_max_sec=16", "data.synthetic_num_utts=64",
                f"max_batches={DECODE_BATCHES}", f"train.checkpoint_dir={ckpt}"]
        if top_a:
            argv.append(f"decode.ext_top_a={top_a}")
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        result = decode.main(argv)
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
    beam = ("prefix_beam_rnn" if lm_path.endswith(".npz") else "prefix_beam") + (
        "_topa" if top_a else "")
    want = {"stft_log_mel": DECODE_BATCHES, "lstm_seq": DECODE_BATCHES * CFG2_LAYERS * 2,
            beam: DECODE_BATCHES}
    check({k: v for k, v in launches.items() if v} == want,
          f"beam decode launches {launches} != {want}")
    check(not plain_calls, f"the plain search ran on the serving path: {plain_calls}")
    check(set(result) == {"method", "wer", "cer", "num_utts", "decode_rtf",
                          "padding_efficiency_decode", "world_size", "dist_backend"}
          and result["num_utts"] > 0 and result["decode_rtf"] > 0
          and result["world_size"] == 1, f"beam decode: bad result {result}")
    return {**result, "wall_s": wall, "batches": DECODE_BATCHES, "ext_top_a": top_a,
            "launches": launches}


def beam_profile_phase(lm_path: str, *extra: str) -> dict:
    """Device time by kernel over one config-2 decode batch (16 utterances of
    10-16 s, bf16, the LM at ``lm_path``, the ``extra`` overrides): the
    shares of K2 and of the beam kernel (K7 with the 4-gram, K9 with the RNN
    LM, the hashed K7 with ``data.vocab=bpe:`` and a piece n-gram)."""
    cfg = get_config(CFG2, **{"data.synthetic_min_sec": "10", "data.synthetic_max_sec": "16",
                              "data.synthetic_num_utts": str(BEAM_B), "data.auto_buckets": "1",
                              "decode.lm_path": lm_path,
                              **dict(a.split("=", 1) for a in extra)})
    batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    model = build_model(cfg, CARD)
    decode_fn = driver.make_decode_fn(cfg, model, driver.load_lm(cfg, CARD))
    with torch.inference_mode():
        decode_fn(batch)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            ids, _ = decode_fn(batch)
            ids.cpu()
            wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    total = sum(r["device_ms"] for r in rows)
    check(total > 0, "beam profile: no device time recorded")
    share = lambda key: sum(r["device_ms"] for r in rows if key in r["name"]) / total  # noqa: E731
    return {"batch_wall_ms": wall_ms, "device_ms": total, "device_busy": total / wall_ms,
            "lstm_share": share("lstm"), "prefix_beam_share": share("prefix_beam"),
            "top": rows[:8]}


def decode_phase(extra: tuple[str, ...] = (), dirs: int = 2) -> dict:
    """Config 1's serving path, ``decode.main`` with the overrides ``extra``
    (the causal model: ``CAUSAL``, ``dirs`` 1): exactly 1 K1 and ``dirs`` K2
    a layer a batch, no beam kernel."""
    # One bucket and 8 utterances a batch: every batch the path decodes is full.
    argv = ["ctc_bilstm_dev1h", "data.synthetic_min_sec=10", "data.synthetic_max_sec=16",
            f"data.synthetic_num_utts={DECODE_BATCHES * B}", "data.auto_buckets=1",
            f"max_batches={DECODE_BATCHES}", *extra]
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    result = decode.main(argv)
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    check(set(result) == {"wer", "cer", "num_utts", "decode_rtf", "world_size",
                          "dist_backend"}, f"decode: {result}")
    check(result["num_utts"] == DECODE_BATCHES * B and 0.0 <= result["wer"]
          and result["decode_rtf"] > 0, f"decode: bad result {result}")
    check(launches["stft_log_mel"] == DECODE_BATCHES,
          f"stft launches {launches['stft_log_mel']} != {DECODE_BATCHES} batches")
    check(launches["lstm_seq"] == DECODE_BATCHES * LAYERS * dirs,
          f"lstm launches {launches['lstm_seq']} != {DECODE_BATCHES} x {LAYERS} x {dirs}")
    check(launches["prefix_beam"] == launches["prefix_beam_topa"] == 0,
          f"greedy decode launched a beam kernel: {launches}")
    if extra:    # the causal path: nothing else at all
        check({k: v for k, v in launches.items() if v}
              == {"stft_log_mel": DECODE_BATCHES, "lstm_seq": DECODE_BATCHES * LAYERS * dirs},
              f"decode {extra}: launches {launches}")
    return {**result, "wall_s": wall, "batches": DECODE_BATCHES, "launches": launches}


def profile_phase() -> list:
    """Device time by kernel name over one bf16 decode batch of 10-16 s utterances."""
    cfg = get_config("ctc_bilstm_dev1h", **{"data.synthetic_min_sec": "10",
                                            "data.synthetic_max_sec": "16",
                                            "data.synthetic_num_utts": "8",
                                            "data.auto_buckets": "1"})
    batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    model = build_model(cfg, CARD)
    with torch.inference_mode():
        eval_step(model, batch)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            ids, _ = eval_step(model, batch)
            ids.cpu()
    return device_rows(prof)[:8]


def device_rows(prof, width: int | None = 60) -> list:
    """Device time by kernel name (cut to ``width`` characters), largest
    first."""
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0))
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append({"name": ev.key[:width], "device_ms": dev_us / 1e3, "calls": ev.count})
    rows.sort(key=lambda r: -r["device_ms"])
    return rows


def train_profile_phase() -> dict:
    """Device time by kernel name over one full-width bf16 train step on a
    full batch of 10-16 s utterances, beside the step's host-clock time."""
    cfg = get_config("ctc_bilstm_dev1h", **{"data.synthetic_min_sec": "10",
                                            "data.synthetic_max_sec": "16",
                                            "data.synthetic_num_utts": str(B),
                                            "data.auto_buckets": "1"})
    host_batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    st = train_state.init_train_state(cfg, train_state.build_model(cfg, CARD))
    batch = train_state.batch_to_device(host_batch, CARD)
    train_state.train_step(cfg, st, batch)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        train_state.train_step(cfg, st, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    total = sum(r["device_ms"] for r in rows)
    check(total > 0, "train profile: no device time recorded")
    return {"step_wall_ms": wall_ms, "device_ms": total, "device_busy": total / wall_ms,
            "top": rows[:12]}


def tcn_weights(g: torch.Generator) -> list[torch.Tensor]:
    """Block weights at lecun-normal scales, as the model draws them, with
    LayerNorm scales near 1 and nonzero biases."""
    C, K = TCN_C, TCN_K
    return [t.cuda() for t in (1 + 0.1 * torch.randn(C, generator=g),
                               0.1 * torch.randn(C, generator=g),
                               torch.randn(K, C, 2 * C, generator=g) / (K * C) ** 0.5,
                               0.1 * torch.randn(2 * C, generator=g),
                               torch.randn(C, C, generator=g) / C ** 0.5,
                               0.1 * torch.randn(C, generator=g))]


def tcn_composite(p: list[torch.Tensor], d: int):
    """The yardstick, a composite of torch calls in fp32 that the port never
    makes: body(xn) = F.conv1d (dilation d, padding 2d) -> F.glu -> F.linear,
    and block(x) = body(F.layer_norm(x)) (+ x).  Weights in the layouts the
    calls take, made once."""
    w_conv = p[2].permute(2, 1, 0).contiguous()              # (2C, C, K)
    w_point = p[4].T.contiguous()                            # (out, in)

    def body(xn, wc=w_conv, bc=p[3], wp=w_point, bp=p[5]):
        acc = F.conv1d(xn.transpose(1, 2), wc, bc, dilation=d, padding=(TCN_K // 2) * d)
        return F.linear(F.glu(acc.transpose(1, 2), dim=-1), wp, bp)

    def block(x, residual):
        y = body(F.layer_norm(x, (TCN_C,), p[0], p[1], eps=tcn_cuda.EPS))
        return x + y if residual else y

    return body, block, (w_conv, w_point)


def tcn_phase() -> list[dict]:
    """K5, the K6 forward and the K6 backward against their plain versions
    at config 3's block shapes, B 16 x T' 400 and a ragged T' 397, C 384,
    K 5, every dilation of the cycle; rows of 10-16 s with zero padding past
    their lengths; K5 also on bf16 input, as the model feeds it; each of the
    three gives the same bits on a second call.  Kernels are timed at every
    dilation, the plain versions and the composite yardstick at d = 1."""
    g = torch.Generator().manual_seed(11)
    p = tcn_weights(g)
    names = {"tcn_block": ("out",), "tcn_block_train_fwd": ("y", "xn"),
             "tcn_block_bwd": ("dxn", "dwc", "dbc", "dwp", "dbp")}
    errs = {n: {"max_abs_err": 0.0, "max_rel_err": 0.0} for n in names}
    timed, cases = {}, []
    B, C, K = TCN_B, TCN_C, TCN_K
    for T in (TCN_T, TCN_RAGGED_T):
        lengths = torch.linspace(T, 0.625 * T, B).int()
        x = torch.randn(B, T, C, generator=g)
        x = torch.where(torch.arange(T)[None, :, None] < lengths[:, None, None], x, 0.0).cuda()
        dy = torch.randn(B, T, C, generator=g).cuda()
        for d in TCN_DILATIONS:
            out = tcn_cuda.tcn_block(x, *p, d)
            y, xn = tcn_cuda.tcn_block_train_fwd(x, *p, d)
            grads = tcn_cuda.tcn_block_bwd(xn, dy, p[2], p[3], p[4], d)
            torch.cuda.synchronize()
            want_y, want_xn = tcn_cuda.tcn_block_train_fwd_plain(x, *p, d)
            want = {"out": tcn_cuda.tcn_block_plain(x, *p, d), "y": want_y, "xn": want_xn,
                    **dict(zip(names["tcn_block_bwd"], tcn_cuda.tcn_block_bwd_plain(
                        want_xn, dy, p[2], p[3], p[4], d)))}
            got = {"out": out, "y": y, "xn": xn, **dict(zip(names["tcn_block_bwd"], grads))}
            case = {"T": T, "dilation": d}
            for kernel, outs in names.items():
                for o in outs:
                    check(got[o].dtype == want[o].dtype and got[o].shape == want[o].shape
                          and bool(torch.isfinite(got[o]).all()), f"{kernel} {o}: bad output")
                    err, rel = errors(got[o], want[o])
                    check(rel <= TCN_TOL, f"{kernel} {o} T={T} d={d}: {rel} > {TCN_TOL} "
                                          "of its largest entry")
                    e = errs[kernel]
                    e["max_abs_err"], e["max_rel_err"] = (max(e["max_abs_err"], err),
                                                          max(e["max_rel_err"], rel))
                    case[o] = rel
            if T == TCN_T:
                case["ms"] = {"tcn_block": time_ms(lambda: tcn_cuda.tcn_block(x, *p, d)),
                              "tcn_block_train_fwd": time_ms(
                                  lambda: tcn_cuda.tcn_block_train_fwd(x, *p, d)),
                              "tcn_block_bwd": time_ms(lambda: tcn_cuda.tcn_block_bwd(
                                  xn, dy, p[2], p[3], p[4], d))}
            if T == TCN_T and d == 1:
                timed = {"x": x, "dy": dy, "xn": xn}
                again = tcn_cuda.tcn_block_bwd(xn, dy, p[2], p[3], p[4], d)
                check(all(torch.equal(a, b) for a, b in zip(grads, again)),
                      "tcn_block_bwd: two calls differ")
                check(torch.equal(out, tcn_cuda.tcn_block(x, *p, d)),
                      "tcn_block: two calls differ")
                check(all(torch.equal(a, b) for a, b in zip(
                    (y, xn), tcn_cuda.tcn_block_train_fwd(x, *p, d))),
                      "tcn_block_train_fwd: two calls differ")
            cases.append(case)
        xb = x.bfloat16()
        outb, wantb = tcn_cuda.tcn_block(xb, *p, 4), tcn_cuda.tcn_block_plain(xb, *p, 4)
        check(outb.dtype == torch.bfloat16, "tcn_block: bf16 input must give bf16 output")
        bf16_err, bf16_rel = errors(outb, wantb)
        check(bf16_rel <= TCN_BF16_TOL, f"tcn_block bf16 T={T}: {bf16_rel}")
        cases.append({"T": T, "dilation": 4, "x": "bf16", "out": bf16_rel})

    # Timed at d = 1, B 16, T' 400: the plain versions and the yardstick.
    x, dy, xn = timed["x"], timed["dy"], timed["xn"]
    body, block, (wc_l, wp_l) = tcn_composite(p, 1)
    lib_err, _ = errors(block(x, True), tcn_cuda.tcn_block_plain(x, *p, 1))
    check(lib_err <= 1e-3, f"tcn yardstick computes another function: {lib_err}")
    leaves = [t.detach().clone().requires_grad_(True) for t in (xn, wc_l, p[3], wp_l, p[5])]
    lib_out = body(*leaves)
    plain = {"tcn_block": lambda: tcn_cuda.tcn_block_plain(x, *p, 1),
             "tcn_block_train_fwd": lambda: tcn_cuda.tcn_block_train_fwd_plain(x, *p, 1),
             "tcn_block_bwd": lambda: tcn_cuda.tcn_block_bwd_plain(xn, dy, p[2], p[3], p[4], 1)}
    library = {"tcn_block": lambda: block(x, True), "tcn_block_train_fwd": lambda: block(x, False),
               "tcn_block_bwd": lambda: torch.autograd.grad(lib_out, leaves, dy,
                                                            retain_graph=True)}
    what = {"tcn_block": "4-call composite F.layer_norm -> F.conv1d -> F.glu -> F.linear, + x "
                         "(fp32, cuDNN and cuBLAS, no TF32)",
            "tcn_block_train_fwd": "4-call composite F.layer_norm -> F.conv1d -> F.glu -> "
                                   "F.linear (fp32)",
            "tcn_block_bwd": "3-call composite F.conv1d -> F.glu -> F.linear from xn, its "
                             "autograd backward (autograd.grad, graph kept)"}
    # Operations: the conv 2 B T C K 2C and the pointwise 2 B T C C; the
    # backward recomputes the conv, then dglu, dw_point, dw_conv and dxn.
    BT, P = B * TCN_T, 4 * (2 * C + K * C * 2 * C + 2 * C + C * C + C)
    fwd_ops = 2 * BT * C * (K * 2 * C + C)
    bwd_ops = 2 * BT * C * C * (6 * K + 2)
    # Every product runs as 3xTF32 on the tensor cores: three TF32 products
    # for each one; the fp32 bound is reported beside.
    nbytes = {"tcn_block": 4 * BT * C * 2 + P, "tcn_block_train_fwd": 4 * BT * C * 3 + P,
              "tcn_block_bwd": 4 * BT * C * 3 + 2 * P}
    ops = {"tcn_block": fwd_ops, "tcn_block_train_fwd": fwd_ops, "tcn_block_bwd": bwd_ops}
    bounds = {n: bound(nbytes[n], 3 * ops[n] / PEAK_TF32_S) for n in names}
    fp32_bounds = {n: bound(nbytes[n], ops[n] / PEAK_FP32_S)[0] for n in names}
    lines = {"tcn_block": 83, "tcn_block_train_fwd": 302, "tcn_block_bwd": 321}
    head = next(c for c in cases if c["T"] == TCN_T and c["dilation"] == 1)
    out = []
    for name in names:
        b_ms, b_by = bounds[name]
        out.append({
            "name": name, "route": "cuda", "source": "pytorch_asr_tpu_torch/csrc/tcn_block.cu",
            "replaces": f"pytorch_asr_tpu/ops/dilated_conv_pallas.py:{lines[name]}",
            "shape": f"x ({B}, {TCN_T}, {C}) f32 (also T' {TCN_RAGGED_T}, bf16 x for K5), "
                     f"w_conv ({K}, {C}, {2 * C}), d {list(TCN_DILATIONS)}",
            **errs[name], "tol": {"max_rel_err": TCN_TOL} if name != "tcn_block" else
            {"max_rel_err": TCN_TOL, "bf16 x max_rel_err": TCN_BF16_TOL},
            "ms": head["ms"][name], "plain_ms": time_ms(plain[name], 5, 4, 1),
            "library_ms": time_ms(library[name], 5, 4, 1), "library": what[name],
            "bound_ms": b_ms, "bound_by": b_by, "bound_fp32_ms": fp32_bounds[name],
            "bound_note": "bound_ms: 3xTF32 on tensor cores (3 x ops / 495 TFLOP/s); "
                          "bound_fp32_ms: ops / 67 TFLOP/s",
            "bit_equal_run_to_run": True,
            "ms_by_dilation": {c["dilation"]: c["ms"][name] for c in cases if "ms" in c}})
    out[0]["cases"] = cases
    return out


def tcn_decode_phase() -> dict:
    """Config 3's serving path through ``decode.main`` at full width in bf16
    on its own 14-bucket decode ladder over 64 utterances of 10-16 s, 4
    batches: exactly 1 K1, 10 K5 and 1 K7 a batch, no other kernel, and no
    call of the plain block or the plain search on the card."""
    with tempfile.TemporaryDirectory() as ckpt, plain_calls_of(
            (tcn_cuda, "tcn_block_plain"), (prefix_beam, "beam_scan_plain")) as plain_calls:
        argv = [CFG3, "data.synthetic_min_sec=10", "data.synthetic_max_sec=16",
                "data.synthetic_num_utts=64", f"max_batches={DECODE_BATCHES}",
                f"train.checkpoint_dir={ckpt}"]
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        result = decode.main(argv)
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
    want = {"stft_log_mel": DECODE_BATCHES, "tcn_block": DECODE_BATCHES * TCN_BLOCKS,
            "prefix_beam": DECODE_BATCHES}
    check({k: v for k, v in launches.items() if v} == want,
          f"tcn decode launches {launches} != {want}")
    check(not plain_calls, f"a plain version ran on the serving path: {plain_calls}")
    check(set(result) == {"method", "wer", "cer", "num_utts", "decode_rtf",
                          "padding_efficiency_decode", "world_size", "dist_backend"}
          and result["num_utts"] > 0 and result["decode_rtf"] > 0,
          f"tcn decode: bad result {result}")
    return {**result, "wall_s": wall, "batches": DECODE_BATCHES, "launches": launches}


def tcn_train_phase() -> dict:
    """Config 3's training path: ``train.main`` at full width in bf16, full
    batches of 16 utterances of 10-16 s in one bucket, dropout 0.1 and
    SpecAugment from the trainer's generator, then the greedy eval: per step
    1 K1, 10 K6 forwards, 10 K6 backwards, 1 K4 alpha and 1 beta; per eval
    batch 1 K1 and 10 K5; and no call of a plain block version on the card."""
    plain = [(tcn_cuda, name) for name in ("tcn_block_plain", "tcn_block_train_fwd_plain",
                                           "tcn_block_bwd_plain")]
    with tempfile.TemporaryDirectory() as ckpt, plain_calls_of(*plain) as plain_calls:
        argv = [CFG3, "data.synthetic_min_sec=10", "data.synthetic_max_sec=16",
                f"data.synthetic_num_utts={TCN_TRAIN_UTTS}", "data.auto_buckets=1",
                f"steps={TRAIN_STEPS}", f"train.eval_every={TRAIN_STEPS}",
                f"train.log_every={TRAIN_STEPS}", f"train.checkpoint_dir={ckpt}"]
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        result = train.main(argv)
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
    last, ev = result["train"], result["eval"]
    evals = TCN_TRAIN_UTTS // TCN_B
    want = {"stft_log_mel": TRAIN_STEPS + evals, "tcn_block": TCN_BLOCKS * evals,
            "tcn_block_train_fwd": TCN_BLOCKS * TRAIN_STEPS,
            "tcn_block_bwd": TCN_BLOCKS * TRAIN_STEPS, "ctc_alpha": TRAIN_STEPS,
            "ctc_beta": TRAIN_STEPS}
    check({k: v for k, v in launches.items() if v} == want,
          f"tcn train launches {launches} != {want}")
    check(not plain_calls, f"a plain version ran on the training path: {plain_calls}")
    check(last.get("step") == TRAIN_STEPS and math.isfinite(last["ctc_loss"])
          and math.isfinite(last["grad_norm"]), f"tcn train: bad record {last}")
    check(ev.get("num_utts") == TCN_TRAIN_UTTS, f"tcn train eval: {ev}")
    return {"record": last, "eval": ev, "wall_s": wall, "step_s": 1.0 / last["steps_per_sec"],
            "launches": launches,
            "launches_per_step": {k: (v - (want["tcn_block"] if k == "tcn_block" else 0)
                                      - (evals if k == "stft_log_mel" else 0)) / TRAIN_STEPS
                                  for k, v in launches.items() if v},
            "launches_per_eval_batch": {"stft_log_mel": 1, "tcn_block": TCN_BLOCKS}}


def tcn_profile_phase() -> dict:
    """Device time by kernel over one config-3 decode batch (16 utterances of
    10-16 s, bf16, beam 16, no LM) and one full-width bf16 train step on the
    same batch, each beside its host-clock time.  Every product of K5 and
    K6 is ``tc_gemm_kernel``'s: no SIMT ``gemm_kernel`` (that name exactly)
    runs in either."""
    cfg = get_config(CFG3, **{"data.synthetic_min_sec": "10", "data.synthetic_max_sec": "16",
                              "data.synthetic_num_utts": str(TCN_B), "data.auto_buckets": "1"})
    host_batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    decode_fn = driver.make_decode_fn(cfg, build_model(cfg, CARD))
    with torch.inference_mode():
        decode_fn(host_batch)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            ids, _ = decode_fn(host_batch)
            ids.cpu()
            dec_ms = (time.perf_counter() - t0) * 1e3
    st = train_state.init_train_state(cfg, train_state.build_model(cfg, CARD))
    batch = train_state.batch_to_device(host_batch, CARD)
    train_state.train_step(cfg, st, batch)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as tprof:
        t0 = time.perf_counter()
        train_state.train_step(cfg, st, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    out = {}
    for name, p, wall in (("decode", prof, dec_ms), ("train", tprof, step_ms)):
        rows = device_rows(p)
        total = sum(r["device_ms"] for r in rows)
        check(total > 0, f"tcn {name} profile: no device time recorded")
        share = lambda hit: sum(r["device_ms"] for r in rows if hit(r["name"])) / total  # noqa
        out[name] = {"wall_ms": wall, "device_ms": total, "device_busy": total / wall,
                     "simt_gemm_share": share(lambda n: SIMT_GEMM.search(n) is not None),
                     "tc_gemm_share": share(lambda n: "tc_gemm_kernel" in n),
                     "prefix_beam_share": share(lambda n: "prefix_beam" in n),
                     "top": rows[:12]}
        check(out[name]["simt_gemm_share"] == 0,
              f"tcn {name} profile: a SIMT gemm_kernel ran: {out[name]['top']}")
    return out

def wide_layer(g: torch.Generator, D: int, dirs: int):
    """x (B, T_LSTM, D) and wih bf16, whh and bias fp32 at H WIDE_H, scaled
    as the other LSTM phases scale them; stacked (2, ...) for ``dirs`` 2."""
    G, lead = 4 * WIDE_H, (2,) if dirs == 2 else ()
    x = (torch.randn(B, T_LSTM, D, generator=g) * 0.5).bfloat16().cuda()
    wih = (torch.randn(*lead, D, G, generator=g) / D ** 0.5).bfloat16().cuda()
    whh = (torch.randn(*lead, WIDE_H, G, generator=g) / WIDE_H ** 0.5).cuda()
    bias = (torch.randn(*lead, G, generator=g) * 0.1).cuda()
    return x, wih, whh, bias


def held(tag: str, got, want, names) -> dict:
    """Each output within K3's tolerance of its largest entry (bf16 or
    float32 by its type), finite and of the plain version's type."""
    rec = {}
    for name, a, w in zip(names, got, want):
        tol = K3_BF16_TOL if a.dtype == torch.bfloat16 else K3_F32_TOL
        check(a.dtype == w.dtype and bool(torch.isfinite(a.float()).all()),
              f"{tag} {name}: non-finite or of type {a.dtype}, not {w.dtype}")
        err, rel = errors(a, w)
        check(rel <= tol, f"{tag} {name}: {rel} > {tol} of its largest entry")
        rec[name] = {"max_abs_err": err, "max_rel_err": rel, "tol": tol}
    return rec


def wide_lstm_rows(g: torch.Generator) -> list[dict]:
    """K2, K3's training pair and K11's three kernels on their wide route
    (the per-utterance kernel) at the shapes the wide paths give them: K2 at
    config 1's layer inputs at H 1536, x (8, 400, 640) and (8, 400, 3072)
    bf16, both directions; K3's training forward and backward and K11's
    forward, training forward and backward at x (8, 400, 640); lengths 400
    down to 250, bf16 residuals.  Each against its plain version on the
    same inputs (the forwards' bf16 output to LSTM_TOL, the residuals and
    gradients to K3's tolerances of their largest entry), timed beside it
    and cuDNN's fp32 LSTM."""
    lens = torch.tensor(LSTM_LENGTHS, dtype=torch.int32).cuda()
    valid, bf16 = int(sum(LSTM_LENGTHS)), torch.bfloat16
    shape = (f"x ({B}, {T_LSTM}, 640) bf16, H {WIDE_H}, lengths {LSTM_LENGTHS}, "
             f"bf16 residuals")
    common = {"route": "cuda", "source": "pytorch_asr_tpu_torch/csrc/lstm_seq.cu",
              "shape": shape, "library_ms": None}
    rows = {}
    # K2, both directions at both layer inputs; the first case is timed.
    cases = []
    for D in (640, 2 * WIDE_H):
        x, wih, whh, bias = wide_layer(g, D, 1)
        for reverse in (False, True):
            args = (x, wih, whh, bias, lens, reverse, bf16)
            got = lstm_cuda.lstm_seq_infer(*args)
            torch.cuda.synchronize()
            err, rel = errors(got, lstm_cuda.lstm_seq_plain(*args))
            check(bool(torch.isfinite(got.float()).all()) and err <= LSTM_TOL,
                  f"lstm_seq wide D={D} reverse={reverse} disagrees: {err}")
            cases.append({"x": [B, T_LSTM, D], "reverse": reverse, "max_abs_err": err,
                          "max_rel_err": rel})
            if not rows:
                ref = cudnn_lstm(D, wih, whh, bias)
                xf = x.float()
                with torch.no_grad():
                    library = time_ms(lambda: ref(xf), 3, 2, 1)
                rows["lstm_seq_wide"] = {
                    "ms": time_ms(lambda: lstm_cuda.lstm_seq_infer(*args), 3, 1, 1),
                    "plain_ms": time_ms(lambda: lstm_cuda.lstm_seq_plain(*args), 2, 1, 1),
                    "library_ms": library,
                    "library": "torch.nn.LSTM (cuDNN, fp32, all lengths = T)",
                    **dict(zip(("bound_ms", "bound_by"),
                               lstm_bounds(B, T_LSTM, D, WIDE_H, valid)["fwd"]))}
    rows["lstm_seq_wide"].update(
        replaces="pytorch_asr_tpu/ops/lstm_pallas.py:280", tol=LSTM_TOL, cases=cases,
        max_abs_err=max(c["max_abs_err"] for c in cases),
        shape=f"{shape}; also x ({B}, {T_LSTM}, {2 * WIDE_H})")
    # K3's training pair at layer 0's input, both directions.
    x, wih, whh, bias = wide_layer(g, 640, 1)
    gy = torch.randn(B, T_LSTM, WIDE_H, generator=g).cuda()
    bounds = lstm_bounds(B, T_LSTM, 640, WIDE_H, valid)
    fwd_cases, bwd_cases = [], []
    for reverse in (False, True):
        args = (x, wih, whh, bias, lens, reverse, bf16, bf16)
        got = lstm_cuda.lstm_seq_train_fwd(*args)
        torch.cuda.synchronize()
        fwd_cases.append({"reverse": reverse, **held(
            "K3 wide", got, lstm_cuda.lstm_seq_train_plain(*args), ("out", "acts", "ct"))})
        bargs = (gy, x, wih, whh, lens, got[1], got[2], reverse)
        grads = lstm_cuda.lstm_seq_bwd(*bargs)
        torch.cuda.synchronize()
        bwd_cases.append({"reverse": reverse, **held(
            "K3 wide", grads, lstm_cuda.lstm_seq_bwd_plain(*bargs),
            ("dx", "dwih", "dwhh", "db"))})
        if reverse:
            continue
        ref = cudnn_lstm(640, wih, whh, bias)
        xg = x.float().requires_grad_(True)
        ref_out, _ = ref(xg)
        ref_in = [xg, *ref.parameters()]
        rows["lstm_seq_train_wide"] = {
            "replaces": "pytorch_asr_tpu/ops/lstm_pallas.py:395",
            "ms": time_ms(lambda: lstm_cuda.lstm_seq_train_fwd(*args), 3, 1, 1),
            "plain_ms": time_ms(lambda: lstm_cuda.lstm_seq_train_plain(*args), 2, 1, 1),
            "library_ms": time_ms(lambda: ref(xg), 3, 2, 1),
            "library": "torch.nn.LSTM (cuDNN, fp32, all lengths = T) forward",
            **dict(zip(("bound_ms", "bound_by"), bounds["train_fwd"]))}
        rows["lstm_seq_bwd_wide"] = {
            "replaces": "pytorch_asr_tpu/ops/lstm_pallas.py:403",
            "ms": time_ms(lambda: lstm_cuda.lstm_seq_bwd(*bargs), 3, 1, 1),
            "plain_ms": time_ms(lambda: lstm_cuda.lstm_seq_bwd_plain(*bargs), 2, 1, 1),
            "library_ms": time_ms(lambda: torch.autograd.grad(ref_out, ref_in, gy,
                                                              retain_graph=True), 3, 2, 1),
            "library": "torch.nn.LSTM (cuDNN, fp32) backward (autograd.grad, graph kept)",
            **dict(zip(("bound_ms", "bound_by"), bounds["bwd"]))}
    for name, cs in (("lstm_seq_train_wide", fwd_cases), ("lstm_seq_bwd_wide", bwd_cases)):
        rows[name].update(cases=cs, tol={"float32": K3_F32_TOL, "bfloat16": K3_BF16_TOL},
                          max_abs_err=max(v["max_abs_err"] for c in cs for k, v in c.items()
                                          if k != "reverse"))
    # K11: its forward, training forward and backward, both directions a launch.
    x, wih, whh, bias = wide_layer(g, 640, 2)
    gy2 = torch.randn(B, T_LSTM, 2 * WIDE_H, generator=g).cuda()
    bounds = lstm_bounds(B, T_LSTM, 640, WIDE_H, valid, dirs=2)
    args = (x, wih, whh, bias, lens, bf16)
    got = lstm_cuda.bilstm_seq_infer(*args)
    torch.cuda.synchronize()
    err, rel = errors(got, lstm_cuda.bilstm_seq_plain(*args))
    check(bool(torch.isfinite(got.float()).all()) and err <= LSTM_TOL,
          f"bilstm_seq wide disagrees: {err}")
    fwd = lstm_cuda.bilstm_seq_train_fwd(*args, bf16)
    torch.cuda.synchronize()
    fwd_rec = held("K11 wide", fwd, lstm_cuda.bilstm_seq_train_plain(*args, bf16),
                   ("out", "acts", "ct"))
    bargs = (gy2, x, wih, whh, lens, fwd[1], fwd[2])
    grads = lstm_cuda.bilstm_seq_bwd(*bargs)
    torch.cuda.synchronize()
    bwd_rec = held("K11 wide", grads, lstm_cuda.bilstm_seq_bwd_plain(*bargs),
                   ("dx", "dwih", "dwhh", "db"))
    ref = cudnn_lstm(640, wih, whh, bias)
    xg = x.float().requires_grad_(True)
    ref_out, _ = ref(xg)
    ref_in = [xg, *ref.parameters()]
    with torch.no_grad():
        library = time_ms(lambda: ref(xg), 3, 2, 1)
    k11 = "torch.nn.LSTM(bidirectional=True) (cuDNN, fp32"
    rows["bilstm_seq_wide"] = {
        "replaces": "pytorch_asr_tpu/ops/lstm_pallas.py:703", "tol": LSTM_TOL,
        "max_abs_err": err, "max_rel_err": rel,
        "ms": time_ms(lambda: lstm_cuda.bilstm_seq_infer(*args), 3, 1, 1),
        "plain_ms": time_ms(lambda: lstm_cuda.bilstm_seq_plain(*args), 2, 1, 1),
        "library_ms": library, "library": f"{k11}, all lengths = T)",
        **dict(zip(("bound_ms", "bound_by"), bounds["fwd"]))}
    rows["bilstm_seq_train_wide"] = {
        "replaces": "pytorch_asr_tpu/ops/lstm_pallas.py:722", "outputs": fwd_rec,
        "ms": time_ms(lambda: lstm_cuda.bilstm_seq_train_fwd(*args, bf16), 3, 1, 1),
        "plain_ms": time_ms(lambda: lstm_cuda.bilstm_seq_train_plain(*args, bf16), 2, 1, 1),
        "library_ms": time_ms(lambda: ref(xg), 3, 2, 1), "library": f"{k11}) forward",
        **dict(zip(("bound_ms", "bound_by"), bounds["train_fwd"]))}
    rows["bilstm_seq_bwd_wide"] = {
        "replaces": "pytorch_asr_tpu/ops/lstm_pallas.py:822",
        "outputs": bwd_rec,
        "ms": time_ms(lambda: lstm_cuda.bilstm_seq_bwd(*bargs), 3, 1, 1),
        "plain_ms": time_ms(lambda: lstm_cuda.bilstm_seq_bwd_plain(*bargs), 2, 1, 1),
        "library_ms": time_ms(lambda: torch.autograd.grad(ref_out, ref_in, gy2,
                                                          retain_graph=True), 3, 2, 1),
        "library": f"{k11}) backward (autograd.grad, graph kept)",
        **dict(zip(("bound_ms", "bound_by"), bounds["bwd"]))}
    for name in ("bilstm_seq_train_wide", "bilstm_seq_bwd_wide"):
        outs = rows[name]["outputs"]
        rows[name].update(tol={"float32": K3_F32_TOL, "bfloat16": K3_BF16_TOL},
                          max_abs_err=max(v["max_abs_err"] for v in outs.values()))
    return [{"name": name, **common, **row} for name, row in rows.items()]


def wide_beam_rows(logits: torch.Tensor, lens: torch.Tensor, kw7: dict, kw9: dict,
                   got7, got9) -> list[dict]:
    """K7 at beam 400 and K9 at beam 64 with an LM of H 512, each with its
    working set in a device scratch, on the wide path's inputs: its results
    there (``got7``, ``got9``) against the plain search on the card (K7 bit
    for bit; K9 tokens and lengths exact, scores to RNN_RTOL / RNN_ATOL),
    then each wrapper timed beside the plain search."""
    Bw, T, V = logits.shape
    want7 = prefix_beam.prefix_beam_search_plain(logits, lens, **kw7)
    check(all(torch.equal(a, b) for a, b in zip(got7, want7)),
          f"K7 at beam {kw7['beam_size']}: differs from the plain search")
    with lm_steps_counted() as lm_steps:
        want9 = prefix_beam.prefix_beam_search_plain(logits, lens, **kw9)
    check(torch.equal(got9[0], want9[0]) and torch.equal(got9[1], want9[1]),
          f"K9 at beam {kw9['beam_size']}: tokens or lengths differ from the plain search")
    torch.testing.assert_close(got9[2], want9[2], rtol=RNN_RTOL, atol=RNN_ATOL,
                               msg=lambda m: f"K9 wide scores: {m}")
    logp = prefix_beam._prepare(logits, 0)[0]
    frames, lens32 = int(lens.sum()), lens.to(torch.int32).contiguous()
    K7, K9, L = kw7["beam_size"], kw9["beam_size"], kw7["max_len"]
    args7 = (logp, lens32, K7, L)
    lm, dec = kw9["rnn_lm"], (kw9["lm_alpha"], kw9["lm_beta"])
    state0 = prefix_beam.primed_lm_state(lm, kw9["sos_id"])
    args9 = (logp, lens32, K9, L, lm, *state0, *dec)
    lmc = lm.cfg
    lm_shape = (lmc.num_layers, lmc.embed_dim, lmc.hidden_dim)
    n_weights = sum(p.numel() for p in lm.parameters())
    common = {"route": "cuda", "source": "pytorch_asr_tpu_torch/csrc/prefix_beam.cu",
              "library_ms": None, "library": "none: no PyTorch call computes a prefix beam search"}
    return [
        {"name": "prefix_beam_wide", **common, "replaces": "pytorch_asr_tpu/ops/beam_pallas.py:756",
         "shape": f"logp ({Bw}, {T}, {V}) f32, lengths {lens.tolist()}, K {K7}, L {L}, C {V}, "
                  f"no LM; scratch {beam_cuda.scratch_bytes(K7, V, V)} bytes a block",
         "max_abs_err": (got7[2] - want7[2]).abs().max().item(),
         "tol": "tokens, lengths and scores bit-equal",
         "ms": time_ms(lambda: beam_cuda.prefix_beam(*args7), 3, 1, 1),
         "plain_ms": time_ms(lambda: prefix_beam.beam_scan_plain(*args7), 1, 1, 0),
         **dict(zip(("bound_ms", "bound_by"), search_bound(frames, K7, V, V, 0, Bw, L)))},
        {"name": "prefix_beam_rnn_wide", **common,
         "replaces": "pytorch_asr_tpu/ops/beam_pallas.py:1452",
         "shape": f"logp ({Bw}, {T}, {V}) f32, lengths {lens.tolist()}, K {K9}, L {L}, C {V}, "
                  f"LM E {lmc.embed_dim} H {lmc.hidden_dim} x {lmc.num_layers}; scratch "
                  f"{beam_cuda.scratch_bytes(K9, V, V, lm_shape)} bytes a block",
         "max_abs_err": (got9[2] - want9[2]).abs().max().item(),
         "tol": {"tokens": "equal", "scores_rtol": RNN_RTOL, "scores_atol": RNN_ATOL},
         "lm_steps": lm_steps[0], "lm_steps_per_frame": lm_steps[0] / frames,
         "ms": time_ms(lambda: beam_cuda.prefix_beam_rnn(*args9), 3, 1, 1),
         "plain_ms": time_ms(lambda: prefix_beam.beam_scan_plain(
             *args7, None, *dec, rnn_lm=lm, lm_state=state0), 1, 1, 0),
         **dict(zip(("bound_ms", "bound_by"), search_bound(
             frames, K9, V, V, 0, Bw, L, 4 * (n_weights + 2 * lmc.num_layers * lmc.hidden_dim + V),
             lm_steps[0] * lm_step_ops(lmc, V))))}]


def wide_study_rows(inputs: dict, got: dict) -> list[dict]:
    """K13 at beam 32 with max_len 1024 and K12 at beam 32 over 1024 chars,
    each with its working set in a device scratch, on the wide path's
    inputs (``inputs``: {name: (logits, lengths, max_len)}): its results
    there (``got``: {name: (outputs, K12's pointers and state or None)})
    bit for bit against the plain search on the card, K12's every frame's
    pointers and last state against the plain frames; then each wrapper
    timed beside the plain search."""
    fns = {"prefix_beam_fused": beam_cuda.prefix_beam_fused,
           "prefix_beam_stepwise": beam_cuda.prefix_beam_lanes_stepwise}
    rows = []
    for name, line in (("prefix_beam_fused", 313), ("prefix_beam_stepwise", 905)):
        lg, ln, L = inputs[name]
        Bw, T, V = lg.shape
        K = WIDE_STUDY_BEAM
        outs, steps = got[name]
        want = prefix_beam.prefix_beam_search_plain(lg, ln, beam_size=K, max_len=L)
        check(all(a.dtype == w.dtype and torch.equal(a, w) for a, w in zip(outs, want)),
              f"{name} past a block: differs from the plain search")
        logp = torch.log_softmax(lg.float(), -1).contiguous()
        if steps is not None:
            for f, w in prefix_beam.prefix_beam_stepwise_plain(logp, ln, K, L).items():
                check(torch.equal(steps[f], w), f"{name} past a block: {f} differs")
        need = (beam_cuda.fused_bytes(K, V, L) if name == "prefix_beam_fused"
                else beam_cuda.step_bytes(K, V))
        rows.append({
            "name": f"{name}_wide", "route": "cuda",
            "source": "pytorch_asr_tpu_torch/csrc/prefix_beam_study.cu",
            "replaces": f"pytorch_asr_tpu/ops/beam_pallas.py:{line}",
            "shape": f"logp ({Bw}, {T}, {V}) f32, lengths {ln.tolist()}, K {K}, L {L}, no LM; "
                     f"scratch {need} bytes a block",
            "max_abs_err": 0.0, "tol": "tokens, lengths and scores bit-equal",
            "ms": time_ms(lambda fn=fns[name]: fn(lg, ln, K, 0, L), 3, 1, 1),
            "plain_ms": time_ms(lambda: prefix_beam.beam_scan_plain(logp, ln, K, L), 1, 1, 0),
            "library_ms": None, "library": "none: no PyTorch call computes a prefix beam search",
            **dict(zip(("bound_ms", "bound_by"), study_bound(
                int(ln.sum()), Bw, T, K, V, L, name == "prefix_beam_stepwise")))})
    return rows


def wide_phase() -> tuple[dict, list[dict], dict]:
    """The routes past the kernels' capacity, which no model configuration
    of the repo reaches, each driven as a path of its own with the counts
    set to 0 just before and read just after: config 1 at
    ``model.encoder.hidden_dim`` 1536, past the co-resident grid, through
    ``decode.main`` (one batch of 8: "wide_decode") and ``train.main`` (one
    step, then its eval: "wide_train"), every LSTM forward on the
    per-utterance kernel under its wide count and none on the grid; K11's
    op at that width without gradients and under autograd ("wide_bilstm");
    and, through ``prefix_beam_search``, a beam-400 search over config 2's
    char vocab and K9 at beam 64 with an LM of H 512 ("wide_beam"), each
    past a block's shared memory, so on the kernels' in-scratch form.  Then
    every kernel of those paths against its plain version at the shapes the
    paths give it (``wide_lstm_rows``, ``wide_beam_rows``).  Returns (the
    record, the kernel rows, each path's launches)."""
    sms = build.sm_count(0)
    check(lstm_cuda.forward_route(WIDE_H, B, sms) is None
          and lstm_cuda.forward_route(WIDE_H, B, sms, 2) is None,
          f"H {WIDE_H} fits the grid: the wide phase would not leave it")
    common = ["ctc_bilstm_dev1h", f"model.encoder.hidden_dim={WIDE_H}",
              "data.synthetic_min_sec=10", "data.synthetic_max_sec=16",
              f"data.synthetic_num_utts={B}", "data.auto_buckets=1"]
    out, paths = {}, {}
    for path, extra in (("decode", ["max_batches=1"]),
                        ("train", ["steps=1", "train.eval_every=1", "train.log_every=1"])):
        with tempfile.TemporaryDirectory() as ckpt:
            torch.cuda.synchronize()
            build.reset_launches()
            t0 = time.perf_counter()
            result = (decode.main if path == "decode" else train.main)(
                [*common, *extra, f"train.checkpoint_dir={ckpt}"])
            wall = time.perf_counter() - t0
            launches = {k: v for k, v in build.LAUNCHES.items() if v}
        evals = launches.get("stft_log_mel", 0) - (path == "train")
        want = {"stft_log_mel": evals + (path == "train"), "lstm_seq_wide": 2 * LAYERS * evals}
        if path == "train":
            want.update({"lstm_seq_train_wide": 2 * LAYERS, "lstm_seq_bwd_wide": 2 * LAYERS,
                         "ctc_alpha": 1, "ctc_beta": 1})
            rec = result["train"]
            check(rec.get("step") == 1 and math.isfinite(rec["ctc_loss"])
                  and math.isfinite(rec["grad_norm"]), f"wide train: bad record {rec}")
        else:
            check(result["num_utts"] == B and result["decode_rtf"] > 0,
                  f"wide decode: bad result {result}")
        check(evals >= 1 and launches == want, f"wide {path} launches {launches} != {want}")
        out[path] = {"result": result, "wall_s": wall, "launches": launches}
        paths[f"wide_{path}"] = launches

    # K11's op at H 1536: without gradients, then under autograd.
    g = torch.Generator().manual_seed(42)
    x, wih, whh, bias = wide_layer(g, 640, 2)
    lens = torch.tensor(LSTM_LENGTHS, dtype=torch.int32).cuda()
    params = [t.clone().requires_grad_(True) for t in (x, wih, whh, bias)]
    torch.cuda.synchronize()
    build.reset_launches()
    with torch.no_grad():
        y0 = lstm_cuda.bilstm_seq(x, wih, whh, bias, lens, torch.bfloat16)
    y = lstm_cuda.bilstm_seq(*params, lens, torch.bfloat16)
    y.float().square().sum().backward()
    torch.cuda.synchronize()
    paths["wide_bilstm"] = {k: v for k, v in build.LAUNCHES.items() if v}
    want = {"bilstm_seq_wide": 1, "bilstm_seq_train_wide": 1, "bilstm_seq_bwd_wide": 1}
    check(paths["wide_bilstm"] == want, f"wide bilstm launches {paths['wide_bilstm']}")
    check(torch.equal(y0, y.detach()) and all(
        bool(torch.isfinite(p.grad.float()).all()) for p in params),
        "wide bilstm: the two forwards differ, or a gradient is not finite")
    out["bilstm"] = {"launches": paths["wide_bilstm"]}

    # The searches past a block: K7 at beam 400, K9 at beam 64 with an LM of H 512.
    cfg = get_config(CFG2)
    logits = torch.randn(2, T_LSTM, V, generator=torch.Generator().manual_seed(40)).mul(2)
    logits[0, torch.arange(T_LSTM), torch.randint(0, V, (T_LSTM,),
                                                  generator=torch.Generator().manual_seed(41))] += 4
    logits, blens = logits.to(CARD), torch.tensor([T_LSTM, 250], dtype=torch.int32, device=CARD)
    wide_lm = CharRNNLM(WIDE_LM, V, seed=23).to(CARD).eval()
    lm_shape = (WIDE_LM.num_layers, WIDE_LM.embed_dim, WIDE_LM.hidden_dim)
    kw7 = dict(beam_size=WIDE_SEARCH_BEAM, max_len=BEAM_L)
    kw9 = dict(beam_size=WIDE_RNN_BEAM, max_len=BEAM_L, rnn_lm=wide_lm,
               sos_id=get_tokenizer(cfg.data.vocab).sos_id, lm_alpha=cfg.decode.lm_alpha,
               lm_beta=cfg.decode.lm_beta)
    check(not beam_cuda.fits(WIDE_SEARCH_BEAM, V, V)
          and not beam_cuda.fits(WIDE_RNN_BEAM, V, V, lm_shape), "a wide search fits a block")
    check(beam_cuda.rnn_grid_route(2, WIDE_RNN_BEAM, V, V, *lm_shape, sms) is None,
          "K9 at beam 64 with an LM of H 512 fits the grid: the wide phase would not leave it")
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    got7 = prefix_beam.prefix_beam_search(logits, blens, **kw7)
    got9 = prefix_beam.prefix_beam_search(logits, blens, **kw9)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    paths["wide_beam"] = {k: v for k, v in build.LAUNCHES.items() if v}
    check(paths["wide_beam"] == {"prefix_beam_wide": 1, "prefix_beam_rnn_wide": 1},
          f"wide beam launches {paths['wide_beam']}")
    out["beam"] = {"shape": [2, T_LSTM, V], "beams": [WIDE_SEARCH_BEAM, WIDE_RNN_BEAM],
                   "wall_s": wall, "launches": paths["wide_beam"],
                   "lengths": [got7[1].tolist(), got9[1].tolist()]}

    # The study kernels past a block: K13 at beam 32 with max_len 1024 on
    # the logits above, K12 at beam 32 over 1024 chars.
    wide_v = torch.randn(2, T_WIDE_STUDY, WIDE_STUDY_V,
                         generator=torch.Generator().manual_seed(43)).mul(2).to(CARD)
    wide_lens = torch.tensor([T_WIDE_STUDY, T_WIDE_STUDY // 2 + 3], dtype=torch.int32,
                             device=CARD)
    study_in = {"prefix_beam_fused": (logits, blens, WIDE_STUDY_L),
                "prefix_beam_stepwise": (wide_v, wide_lens, BEAM_L)}
    check(not beam_cuda.study_fits(WIDE_STUDY_BEAM, V, WIDE_STUDY_L)
          and not beam_cuda.study_fits(WIDE_STUDY_BEAM, WIDE_STUDY_V),
          "a wide study search fits a block")
    steps = {}
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    got_fused = beam_cuda.prefix_beam_fused(logits, blens, WIDE_STUDY_BEAM, 0, WIDE_STUDY_L)
    got_step = beam_cuda.prefix_beam_lanes_stepwise(wide_v, wide_lens, WIDE_STUDY_BEAM, 0,
                                                    BEAM_L, scratch=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    paths["wide_study"] = {k: v for k, v in build.LAUNCHES.items() if v}
    check(paths["wide_study"] == {"prefix_beam_fused_wide": 1,
                                  "prefix_beam_stepwise_wide": T_WIDE_STUDY},
          f"wide study launches {paths['wide_study']}")
    out["study"] = {"beam": WIDE_STUDY_BEAM, "wall_s": wall, "launches": paths["wide_study"],
                    "lengths": [got_fused[1].tolist(), got_step[1].tolist()]}
    merge_row, out["merge"], paths["wide_merge"] = wide_merge(logits, blens)
    deep_row, out["deep_lm"], paths["wide_deep_lm"] = wide_deep_lm(cfg)
    ctc_rows, out["ctc"], ctc_paths = wide_ctc()
    stft_row, out["stft"], paths["wide_stft"] = wide_stft()
    rows = [*wide_lstm_rows(g), *wide_beam_rows(logits, blens, kw7, kw9, got7, got9),
            *wide_study_rows(study_in, {"prefix_beam_fused": (got_fused, None),
                                        "prefix_beam_stepwise": (got_step, steps)}),
            merge_row, deep_row, *ctc_rows, stft_row]
    return out, rows, {**paths, **ctc_paths}


def wide_ctc() -> tuple[list[dict], dict, dict]:
    """K4 past its registers, which no configuration reaches (labels past
    2047 tokens): the CTC loss and its gradient through ``ctc_cuda.ctc_loss``
    at S 4097 and 20001 ("wide_ctc") and, with ``PAIRED_FWD`` set, at S 4097
    ("wide_paired"), each path with the counts set to 0 just before and read
    just after; then each kernel against its plain version at both sizes
    (the paired alpha at S 4097), timed in turns with ``F.ctc_loss``.
    Returns (the kernel rows, the record, each path's launches)."""
    cases = [bench_kernel_turns.ctc_case(CARD, *c) for c in WIDE_CTC_CASES]
    paths, rec = {}, {}
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    for logits, logit_len, labels, label_len in cases:
        a = logits.clone().requires_grad_(True)
        loss = ctc_cuda.ctc_loss(a, logit_len, labels, label_len)
        loss.sum().backward()
        check(bool(torch.isfinite(loss).all()) and loss[0] > 0 and not loss[1:].any()
              and not a.grad[1:].any() and bool(torch.isfinite(a.grad).all()),
              f"wide ctc: loss {loss.tolist()} or its gradient is wrong")
    torch.cuda.synchronize()
    rec["wall_s"] = time.perf_counter() - t0
    paths["wide_ctc"] = {k: v for k, v in build.LAUNCHES.items() if v}
    check(paths["wide_ctc"] == {"ctc_alpha_wide": 2, "ctc_beta_wide": 2},
          f"wide ctc launches {paths['wide_ctc']}")
    logits, logit_len, labels, label_len = cases[0]
    torch.cuda.synchronize()
    ctc_cuda.PAIRED_FWD = True
    try:
        build.reset_launches()
        a = logits.clone().requires_grad_(True)
        loss = ctc_cuda.ctc_loss(a, logit_len, labels, label_len)
        loss.sum().backward()
        torch.cuda.synchronize()
        paths["wide_paired"] = {k: v for k, v in build.LAUNCHES.items() if v}
    finally:
        ctc_cuda.PAIRED_FWD = False
    check(paths["wide_paired"] == {"ctc_alpha_paired_wide": 1, "ctc_beta_wide": 1}
          and bool(torch.isfinite(a.grad).all()), f"wide paired launches {paths['wide_paired']}")

    replaces = {"ctc_alpha_wide": "279", "ctc_beta_wide": "312", "ctc_alpha_paired_wide": "139"}
    rows = {n: {"name": n, "route": "cuda",
                "source": "pytorch_asr_tpu_torch/csrc/ctc_alpha_beta.cu",
                "replaces": f"pytorch_asr_tpu/ops/ctc_pallas.py:{line}", "cases": []}
            for n, line in replaces.items()}
    for i, (logits, logit_len, labels, label_len) in enumerate(cases):
        _, lp, _, skip = ctc.prep(logits, labels.long(), label_len, 0)
        T, b, S = lp.shape
        check(ctc_cuda.lane_plan(S).form == "wide", f"S {S} fits the register form")
        frames = int(logit_len.sum())
        shape = f"logp_tbs ({T}, {b}, {S}) f32, logit_len {logit_len.tolist()}"
        alphas, final = ctc_cuda.ctc_alpha(lp, skip, logit_len)
        ref_alphas, ref_final = ctc.alphas_plain(lp, skip, logit_len)
        err = max(ctc_close("wide alphas", alphas, ref_alphas, CTC_RTOL, CTC_ALPHA_ATOL),
                  ctc_close("wide final alpha", final, ref_final, CTC_RTOL, CTC_ALPHA_ATOL))
        logz = ctc.terminal_logz(ref_final, label_len)
        feasible = (logz > ctc.NEG_INF / 2) & (logit_len > 0)
        bargs = (lp, ref_alphas, ctc.shift_left(skip, 2, fill=False).contiguous(),
                 ctc.terminal_betas(label_len, S),
                 torch.where(feasible, logit_len, 0).to(torch.int32),
                 torch.where(feasible, logz, 0.0))
        w_err = ctc_close("wide posteriors", ctc_cuda.ctc_beta(*bargs),
                          ctc.posteriors_plain(*bargs), CTC_GRAD_RTOL, CTC_GRAD_ATOL)
        lib, lib_backward = ctc_library(logits, labels, logit_len, label_len)
        fwd = in_turns({"kernel": lambda: ctc_cuda.ctc_alpha(lp, skip, logit_len),
                        "library": lib}, reps=3, inner=2)
        bwd = in_turns({"kernel": lambda: ctc_cuda.ctc_beta(*bargs),
                        "library": lib_backward}, reps=3, inner=2)
        done = [("ctc_alpha_wide", "alpha", err, fwd,
                 lambda: ctc.alphas_plain(lp, skip, logit_len), "F.ctc_loss forward"),
                ("ctc_beta_wide", "beta", w_err, bwd, lambda: ctc.posteriors_plain(*bargs),
                 "F.ctc_loss backward (autograd.grad, graph kept)")]
        if i == 0:
            pa, pf = ctc_cuda.ctc_alpha_paired(lp, skip, logit_len)
            ref_pa, ref_pf = ctc.alphas_paired_plain(lp, skip, logit_len)
            p_err = max(ctc_close("wide paired alphas", pa, ref_pa, CTC_RTOL, CTC_ALPHA_ATOL),
                        ctc_close("wide paired final", pf, ref_pf, CTC_RTOL, CTC_ALPHA_ATOL))
            pfwd = in_turns({"kernel": lambda: ctc_cuda.ctc_alpha_paired(lp, skip, logit_len),
                             "library": lib}, reps=3, inner=2)
            done.append(("ctc_alpha_paired_wide", "paired", p_err, pfwd,
                         lambda: ctc.alphas_paired_plain(lp, skip, logit_len),
                         "F.ctc_loss forward"))
        for name, kind, e, turns, plain, library in done:
            b_ms, b_by = ctc_bound(kind, T, b, S, frames)
            rows[name]["cases"].append({
                "shape": shape, "S": S, "max_abs_err": e, "ms": statistics.mean(turns["kernel"]),
                "plain_ms": time_ms(plain, 1, 1, 1),
                "library_ms": statistics.mean(turns["library"]), "library": library,
                "turns_ms": {"kernel, library, library, kernel": turns},
                "bound_ms": b_ms, "bound_by": b_by})
    tols = {"ctc_alpha_wide": {"rtol": CTC_RTOL, "atol": CTC_ALPHA_ATOL},
            "ctc_beta_wide": {"rtol": CTC_GRAD_RTOL, "atol": CTC_GRAD_ATOL},
            "ctc_alpha_paired_wide": {"rtol": CTC_RTOL, "atol": CTC_ALPHA_ATOL}}
    out = []
    for name, row in rows.items():
        first = row["cases"][0]
        row.update({k: first[k] for k in ("shape", "ms", "plain_ms", "library_ms", "library",
                                           "bound_ms", "bound_by")})
        row["max_abs_err"] = max(c["max_abs_err"] for c in row["cases"])
        row["tol"] = tols[name]
        out.append(row)
    return out, rec, paths


def wide_stft() -> tuple[dict, dict, dict]:
    """K1's DFT form, which no configuration reaches (every config's n_fft
    is 512): ``decode.main`` at ``frontend.n_fft`` 400 and 2048 (a batch of
    8 each), with the counts set to 0 before the first and read after the
    second ("wide_stft"); then the kernel against its plain version and a
    float64 DFT at the serving audio (8 x 16 s) at both sizes, timed in
    turns with ``torch.stft`` + mel + log, with its phase split.  Returns
    (the kernel row, the record, the path's launches)."""
    rec = {}
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    for n_fft in WIDE_N_FFT:
        with tempfile.TemporaryDirectory() as ckpt:
            result = decode.main(["ctc_bilstm_dev1h", f"frontend.n_fft={n_fft}",
                                  "data.synthetic_min_sec=10", "data.synthetic_max_sec=16",
                                  f"data.synthetic_num_utts={B}", "data.auto_buckets=1",
                                  "max_batches=1", f"train.checkpoint_dir={ckpt}"])
        check(result["num_utts"] == B and result["decode_rtf"] > 0,
              f"wide stft decode at n_fft {n_fft}: {result}")
        rec[f"decode_n_fft_{n_fft}"] = result
    torch.cuda.synchronize()
    rec["wall_s"] = time.perf_counter() - t0
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    want = {"stft_log_mel_dft": len(WIDE_N_FFT), "lstm_seq": len(WIDE_N_FFT) * 2 * LAYERS}
    check(launches == want, f"wide stft launches {launches} != {want}")
    cases = []
    for n_fft in WIDE_N_FFT:
        cfg = FrontendConfig(n_fft=n_fft)
        check(not stft_cuda.has_fft_plan(n_fft), f"n_fft {n_fft} has an FFT plan")
        audio = serving_audio(cfg)
        got = stft_cuda.stft_log_mel(audio, cfg)
        err, _ = errors(got, stft_cuda.stft_log_mel_plain(audio, cfg))
        exact_err, _ = errors(got, exact_log_mel(audio, cfg))
        check(bool(torch.isfinite(got).all()) and err <= STFT_TOL and exact_err <= STFT_EXACT_TOL,
              f"stft_log_mel_dft at n_fft {n_fft}: {err} vs plain, {exact_err} vs float64")
        turns = in_turns({"kernel": lambda: stft_cuda.stft_log_mel(audio, cfg),
                          "library": stft_library(cfg, audio)}, reps=5, inner=4)
        b_ms, b_by = stft_bound(cfg, B, AUDIO)
        T = features.max_frames(AUDIO, cfg)
        cases.append({"shape": f"audio ({B}, {AUDIO}) f32 -> ({B}, {T}, {cfg.n_mels}) f32, "
                               f"n_fft {n_fft}",
                      "max_abs_err": err, "max_abs_err_vs_fp64": exact_err,
                      "ms": statistics.mean(turns["kernel"]),
                      "plain_ms": time_ms(lambda: stft_cuda.stft_log_mel_plain(audio, cfg), 3, 1),
                      "library_ms": statistics.mean(turns["library"]),
                      "turns_ms": {"kernel, library, library, kernel": turns},
                      "phase_split": stft_split(audio, cfg), "bound_ms": b_ms, "bound_by": b_by})
    row = {"name": "stft_log_mel_dft", "route": "cuda",
           "source": "pytorch_asr_tpu_torch/csrc/stft_log_mel.cu",
           "replaces": "pytorch_asr_tpu/ops/stft_pallas.py:189",
           **{k: cases[0][k] for k in ("shape", "ms", "plain_ms", "library_ms", "bound_ms",
                                       "bound_by")},
           "max_abs_err": max(c["max_abs_err"] for c in cases),
           "tol": {"vs_plain": STFT_TOL, "vs_fp64": STFT_EXACT_TOL},
           "library": "torch.stft + mel matmul + log", "cases": cases}
    return row, rec, launches



def wide_merge(logits: torch.Tensor, lens: torch.Tensor) -> tuple[dict, dict, dict]:
    """K10 past a block's shared memory: the candidates that 2 shards of a
    beam-640 search gather at frame WIDE_MERGE_FRAME of the wide phase's
    logits, merged to 640 by ``merge_topk`` with the counts set to 0 just
    before and read just after (its in-scratch form, ``merge_topk_wide``),
    then held to the plain merge on the card bit for bit, every field, and
    timed beside it.  Returns (its kernel row, the record, the launches)."""
    Bw, _, V = logits.shape
    K, nb = WIDE_MERGE_BEAM, V - 1
    check(not beam_cuda.merge_fits(K, nb), f"K10 at beam {K} fits a block")
    logp = torch.log_softmax(logits.float(), dim=-1)
    kw = dict(blank=0, vocab=V, lm_table=None, lm_alpha=0.0, lm_beta=0.0, L=BEAM_L)
    state = prefix_beam._init_state(Bw, K, BEAM_L, CARD)
    for t in range(WIDE_MERGE_FRAME):
        state, _ = prefix_beam._step(state, logp[:, t], t < lens, K=K, **kw)
    parts = [prefix_beam._build_candidates(prefix_beam_sharded._local_slice(state, p, K // 2),
                                           logp[:, WIDE_MERGE_FRAME], lm_rows=None, K=K // 2,
                                           parent_offset=p * K // 2, **kw) for p in (0, 1)]
    stay, ext = ({k: torch.cat([q[i][k] for q in parts], 1).contiguous() for k in parts[0][i]}
                 for i in (0, 1))
    torch.cuda.synchronize()
    build.reset_launches()
    score, got = beam_cuda.merge_topk(stay, ext, K)
    torch.cuda.synchronize()
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    check(launches == {"merge_topk_wide": 1}, f"wide merge launches {launches}")
    want_score, want = prefix_beam._merge_topk(stay, ext, K)
    check(torch.equal(score, want_score) and all(
        got[n].dtype == w.dtype and torch.equal(got[n], w) for n, w in want.items()),
        f"K10 at beam {K}: differs from the plain merge")
    merge = lambda: beam_cuda.merge_topk(stay, ext, K)  # noqa: E731
    row = {"name": "merge_topk_wide", "route": "cuda",
           "source": "pytorch_asr_tpu_torch/csrc/prefix_beam.cu",
           "replaces": "pytorch_asr_tpu/ops/beam_pallas.py:1026",
           "shape": f"stays ({Bw}, {K}) x 7 fields, lanes ({Bw}, {K * nb}) x 6 fields, K {K}, "
                    f"from 2 shards at frame {WIDE_MERGE_FRAME}; scratch "
                    f"{beam_cuda.merge_slice_bytes(K, nb)} bytes a block",
           "max_abs_err": 0.0, "tol": "every field bit-equal",
           "ms": time_ms(merge, 5, 4, 1),
           "plain_ms": time_ms(lambda: prefix_beam._merge_topk(stay, ext, K), 5, 4, 1),
           "library_ms": None, "library": "none: no PyTorch call computes this merge",
           **dict(zip(("bound_ms", "bound_by"), merge_bound(Bw, K, nb, K)))}
    rec = {"beam": K, "dead_picks": int((want_score <= prefix_beam.NEG_INF / 2).sum()),
           "launches": launches}
    return row, rec, launches


def wide_deep_lm(cfg) -> tuple[dict, dict, dict]:
    """K9 with an LM of 10 layers (DEEP_LM, random weights from a seed), past
    the 8 its kernel once held, through ``prefix_beam_search`` over config
    2's chars with the counts set to 0 just before and read just after (its
    grid: ``prefix_beam_rnn``), on 2 rows of random logits with a path
    planted at +8 and max_len above the frames (decisive inputs); tokens
    and lengths exact against the plain search on the card, scores within
    RNN_RTOL / RNN_ATOL; timed beside it.  Returns (its kernel row, the
    record, the launches)."""
    g = torch.Generator().manual_seed(44)
    T = 200
    logits = torch.randn(2, T, V, generator=g).mul(2)
    path = torch.randint(0, V, (2, T), generator=g)
    logits.scatter_add_(2, path[..., None], torch.full((2, T, 1), 8.0))
    logits, lens = logits.to(CARD), torch.tensor([T, 150], dtype=torch.int32, device=CARD)
    lm = CharRNNLM(DEEP_LM, V, seed=24).to(CARD).eval()
    shape = (DEEP_LM.num_layers, DEEP_LM.embed_dim, DEEP_LM.hidden_dim)
    check(beam_cuda.rnn_grid_route(2, BEAM_K, V, V, *shape, build.sm_count(0)) is not None,
          "K9 with the deep LM does not fit its grid")
    kw = dict(beam_size=BEAM_K, max_len=BEAM_L, rnn_lm=lm,
              sos_id=get_tokenizer(cfg.data.vocab).sos_id, lm_alpha=cfg.decode.lm_alpha,
              lm_beta=cfg.decode.lm_beta)
    torch.cuda.synchronize()
    build.reset_launches()
    got = prefix_beam.prefix_beam_search(logits, lens, **kw)
    torch.cuda.synchronize()
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    check(launches == {"prefix_beam_rnn": 1}, f"deep LM launches {launches}")
    with lm_steps_counted() as lm_steps:
        want = prefix_beam.prefix_beam_search_plain(logits, lens, **kw)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "K9 with 10 LM layers: tokens or lengths differ from the plain search")
    torch.testing.assert_close(got[2], want[2], rtol=RNN_RTOL, atol=RNN_ATOL,
                               msg=lambda m: f"K9 deep LM scores: {m}")
    logp = prefix_beam._prepare(logits, 0)[0]
    state0 = prefix_beam.primed_lm_state(lm, kw["sos_id"])
    args = (logp, lens, BEAM_K, BEAM_L, lm, *state0, kw["lm_alpha"], kw["lm_beta"])
    frames = int(lens.sum())
    n_weights = sum(p.numel() for p in lm.parameters())
    row = {"name": "prefix_beam_rnn_deep", "counted_as": "prefix_beam_rnn", "route": "cuda",
           "source": "pytorch_asr_tpu_torch/csrc/prefix_beam.cu",
           "replaces": "pytorch_asr_tpu/ops/beam_pallas.py:1452",
           "shape": f"logp (2, {T}, {V}) f32, lengths {lens.tolist()}, K {BEAM_K}, L {BEAM_L}, "
                    f"C {V}, LM E {DEEP_LM.embed_dim} H {DEEP_LM.hidden_dim} x "
                    f"{DEEP_LM.num_layers} (its grid)",
           "max_abs_err": (got[2] - want[2]).abs().max().item(),
           "tol": {"tokens": "equal", "scores_rtol": RNN_RTOL, "scores_atol": RNN_ATOL},
           "lm_steps_per_frame": lm_steps[0] / frames,
           "ms": time_ms(lambda: beam_cuda.prefix_beam_rnn(*args), 3, 1, 1),
           "plain_ms": time_ms(lambda: prefix_beam.beam_scan_plain(
               *args[:4], None, *args[8:], rnn_lm=lm, lm_state=state0), 1, 1, 0),
           "library_ms": None, "library": "none: no PyTorch call computes a prefix beam search",
           **dict(zip(("bound_ms", "bound_by"), search_bound(
               frames, BEAM_K, V, V, 0, 2, BEAM_L,
               4 * (n_weights + 2 * DEEP_LM.num_layers * DEEP_LM.hidden_dim + V),
               lm_steps[0] * lm_step_ops(DEEP_LM, V))))}
    rec = {"lm": f"E {DEEP_LM.embed_dim} H {DEEP_LM.hidden_dim} x {DEEP_LM.num_layers}",
           "lengths": got[1].tolist(), "launches": launches}
    return row, rec, launches


def shard_candidates(state, logp_t, P: int, lm, kw: dict) -> tuple[dict, dict]:
    """One frame's candidates as P beam shards build them (each its K/P
    beams, with global parent ids) and the all-gather assembles them:
    shard-major, contiguous."""
    kl, parts = BEAM_K // P, []
    for p in range(P):
        local = prefix_beam_sharded._local_slice(state, p, kl)
        rows = lm[local.ctx.long()] if lm is not None else None
        parts.append(prefix_beam._build_candidates(local, logp_t, lm_rows=rows, K=kl,
                                                   parent_offset=p * kl, **kw))
    return tuple({k: torch.cat([q[i][k] for q in parts], 1).contiguous() for k in parts[0][i]}
                  for i in (0, 1))


def merge_phase(arpa: str) -> dict:
    """K10 against the plain merge (``_merge_topk``), both on the card, every
    output field bit for bit, dead picks included: config 2's model logits
    for 16 utterances of 10-16 s (the last row cut to no frames), the plain
    search's state advanced to frames 0 and 1 (most beams dead) and 150,
    with no LM and with the 4-gram, candidates gathered from 2 and 4 beam
    shards (B 16, K 16, 30 lanes a beam).  Timed at frame 150 with the
    4-gram and 2 shards."""
    cfg = get_config(CFG2, **{"data.synthetic_min_sec": "10", "data.synthetic_max_sec": "16",
                              "data.synthetic_num_utts": str(BEAM_B), "data.auto_buckets": "1"})
    logits, lens = cfg2_batch_logits(cfg)
    lens = lens.clone()
    lens[BEAM_B - 1] = 0
    B, T, V = logits.shape
    logp = torch.log_softmax(logits.float(), dim=-1)
    table = driver.load_lm(get_config(CFG2, **{"decode.lm_path": arpa}), CARD)
    dec, cases, timed = cfg.decode, [], None
    for lm in (None, table):
        kw = dict(blank=0, vocab=V, lm_table=lm, lm_alpha=dec.lm_alpha if lm is not None else 0.0,
                  lm_beta=dec.lm_beta if lm is not None else 0.0, L=BEAM_L)
        state = prefix_beam._init_state(B, BEAM_K, BEAM_L, CARD)
        for t in range(max(MERGE_FRAMES) + 1):
            for P in ((2, 4) if t in MERGE_FRAMES else ()):
                stay, ext = shard_candidates(state, logp[:, t], P, lm, kw)
                build.reset_launches()
                score, got = beam_cuda.merge_topk(stay, ext, BEAM_K)
                torch.cuda.synchronize()
                check(build.LAUNCHES["merge_topk"] == 1, f"merge_topk: {dict(build.LAUNCHES)}")
                want_score, want = prefix_beam._merge_topk(stay, ext, BEAM_K)
                tag = f"merge_topk frame {t} P {P} {'4-gram' if lm is not None else 'no LM'}"
                check(torch.equal(score, want_score), f"{tag}: scores differ")
                for name, w in want.items():
                    check(got[name].dtype == w.dtype and torch.equal(got[name], w),
                          f"{tag}: {name} differs from the plain merge")
                alive = prefix_beam._lse(stay["pb"], stay["pnb"]) > prefix_beam.NEG_INF / 2
                cases.append({"frame": t, "P": P, "lm": lm is not None,
                              "alive_stays": int(alive.sum()),
                              "dead_picks": int((want_score <= prefix_beam.NEG_INF / 2).sum())})
                if lm is not None and t == max(MERGE_FRAMES) and P == 2:
                    timed = (stay, ext)
            state, _ = prefix_beam._step(state, logp[:, t], t < lens, K=BEAM_K, **kw)
    stay, ext = timed
    nb = V - 1
    # Back-to-back calls measure the wrapper (its checks, 9 output tensors,
    # the ctypes call) where that costs more than the kernel; the profiler
    # gives the kernel's own device time.
    merge = lambda: beam_cuda.merge_topk(stay, ext, BEAM_K)  # noqa: E731
    return {"name": "merge_topk", "route": "cuda",
            "source": "pytorch_asr_tpu_torch/csrc/prefix_beam.cu",
            "replaces": "pytorch_asr_tpu/ops/beam_pallas.py:1026",
            "shape": f"stays ({B}, {BEAM_K}) x 7 fields, lanes ({B}, {BEAM_K * nb}) x 6 fields, "
                     f"K {BEAM_K}, from 2 and 4 shards, frames {list(MERGE_FRAMES)}",
            "max_abs_err": 0.0, "tol": "every field bit-equal",
            "ms": time_ms(merge), "device_ms": device_ms_per_call(merge, "merge_topk_kernel",
                                                                one_launch=True),
            "split_us": merge_split(stay, ext, BEAM_K),
            "plain_ms": time_ms(lambda: prefix_beam._merge_topk(stay, ext, BEAM_K)),
            "library_ms": None, "library": "none: no PyTorch call computes this merge",
            **dict(zip(("bound_ms", "bound_by"), merge_bound(B, BEAM_K, nb, BEAM_K))),
            "cases": cases}


def merge_bound(B: int, Ks: int, nb: int, K: int, cols: int = 0) -> tuple[float, str]:
    """``bound`` of K10 over B rows of Ks stays and Ks nb lanes.  Bytes: the
    7 stay and 6 lane fields read once, the 9 outputs written; with ``cols``
    (the window form) the ctx field is no column of every stay, lane and
    output but each pick's ``cols`` window ids, read and written once, as
    the kernel copies only a pick's window.  Operations a row: ~3 a
    candidate (its score and key), 3 a (beam, beam) absorb test, and a
    top-K over N candidates at log2(K) compares each."""
    N = Ks + Ks * nb
    nbytes = 4 * (7 * B * Ks + 6 * B * Ks * nb + 9 * B * K)
    if cols:
        nbytes += 4 * B * (2 * K * cols - (Ks + Ks * nb + K))
    ops = B * (3 * N + 3 * Ks ** 2 + N * math.log2(max(K, 2)))
    return bound(nbytes, ops / PEAK_FP32_S)


MERGE_PHASES = ("loads", "absorb", "sort", "picks")


def merge_split(stay: dict, ext: dict, K: int, calls: int = 40) -> dict:
    """K10's block 0 by phase over ``calls`` launches (``merge_topk``'s
    (7,) trace each): the median µs of the loads, the absorb, the keys and
    warp sorts, and the merge tree (or ranks) with the picks, at the clock
    the traces saw (their clocks over their global-clock spans, summed)."""
    trace = torch.zeros((calls, 7), dtype=torch.int64, device=CARD)
    for i in range(calls):
        beam_cuda.merge_topk(stay, ext, K, trace=trace[i])
    tr = trace.cpu().numpy().astype(np.float64)
    check(bool((tr[:, 0] > 0).all()), "merge_topk trace: a launch wrote no trace")
    ghz = (tr[:, 5] - tr[:, 1]).sum() / (tr[:, 6] - tr[:, 0]).sum()
    return {"launches": calls, "trace_clock_ghz": ghz,
            "us_median": {n: float(np.median(tr[:, i + 2] - tr[:, i + 1])) / ghz / 1e3
                          for i, n in enumerate(MERGE_PHASES)},
            "us_total_median": float(np.median(tr[:, 5] - tr[:, 1])) / ghz / 1e3}


def rnn_past_smem_phase(rnn_lm_path: str) -> dict:
    """K9 where the LM state does not fit a block's shared memory beside the
    search: an LM of H 512 x 2 layers (random weights from a seed) at beam
    16, past K9's grid too, so its block kernel keeps the state in a device
    scratch ("prefix_beam_rnn_block"), and the trained default LM at beam 32,
    which the grid takes; planted transcripts on config 2's model logits,
    the last row cut to no frames; tokens and lengths exact against the
    plain search on the card, scores within RNN_RTOL / RNN_ATOL; both timed."""
    cfg = get_config(CFG2, **{"data.synthetic_min_sec": "10", "data.synthetic_max_sec": "16",
                              "data.synthetic_num_utts": str(BEAM_B), "data.auto_buckets": "1",
                              "decode.lm_path": rnn_lm_path})
    logits, lens = cfg2_batch_logits(cfg)
    B, T, V = logits.shape
    batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    path = transcript_path(batch, lens.cpu(), T).to(CARD)
    planted = logits.clone()
    planted.scatter_add_(2, path[..., None], torch.full((B, T, 1), 4.0, device=CARD))
    ragged = lens.clone()
    ragged[B - 1] = 0
    dec, sos = cfg.decode, get_tokenizer(cfg.data.vocab).sos_id
    wide = CharRNNLM(WIDE_LM, V, seed=23).to(CARD).eval()
    out = {}
    for name, lm, K in (("h512", wide, BEAM_K), ("beam32", driver.load_lm(cfg, CARD), WIDE_BEAM)):
        lmc = lm.cfg
        smem = beam_cuda.rnn_smem_bytes(K, V, V, lmc.num_layers, lmc.embed_dim, lmc.hidden_dim)
        check(smem > beam_cuda.MAX_SMEM, f"{name}: its state fits shared memory ({smem} bytes)")
        kw = dict(beam_size=K, max_len=BEAM_L, rnn_lm=lm, sos_id=sos, lm_alpha=dec.lm_alpha,
                  lm_beta=dec.lm_beta)
        route = beam_cuda.rnn_grid_route(B, K, V, V, lmc.num_layers, lmc.embed_dim,
                                         lmc.hidden_dim, build.sm_count(0))
        counted = "prefix_beam_rnn" if route is not None else "prefix_beam_rnn_block"
        build.reset_launches()
        got = prefix_beam.prefix_beam_search(planted, ragged, **kw)
        torch.cuda.synchronize()
        check({k: v for k, v in build.LAUNCHES.items() if v} == {counted: 1},
              f"K9 {name}: {dict(build.LAUNCHES)}")
        want = prefix_beam.prefix_beam_search_plain(planted, ragged, **kw)
        check(torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]),
              f"K9 {name}: tokens or lengths differ from the plain search")
        torch.testing.assert_close(got[2], want[2], rtol=RNN_RTOL, atol=RNN_ATOL,
                                   msg=lambda m, name=name: f"K9 {name} scores: {m}")
        logp = prefix_beam._prepare(planted, 0)[0]
        state0 = prefix_beam.primed_lm_state(lm, sos)
        args = (logp, ragged.to(torch.int32).contiguous(), K, BEAM_L, lm, *state0, dec.lm_alpha,
                dec.lm_beta)
        out[name] = {"K": K, "lm": f"E {lmc.embed_dim} H {lmc.hidden_dim} x {lmc.num_layers}",
                     "counted_as": counted, "state_in_smem_bytes": smem,
                     "scratch_bytes": 4 * B * beam_cuda.lm_state_floats(K, V, lmc.num_layers,
                                                                        lmc.hidden_dim),
                     "max_abs_err": (got[2] - want[2]).abs().max().item(),
                     "mean_len": got[1].float().mean().item(),
                     "ms": time_ms(lambda: beam_cuda.prefix_beam_rnn(*args), 3, 1, 1),
                     "plain_ms": time_ms(lambda: prefix_beam.beam_scan_plain(
                         *args[:4], None, *args[8:], rnn_lm=lm, lm_state=state0), 1, 1, 0)}
    return out


def profiled(fn, calls: int):
    """The profile of ``calls`` calls of ``fn`` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return prof


def device_ms_per_call(fn, kernel: str, calls: int = 20, attempts: int = 4,
                       one_launch: bool = False) -> float:
    """The device time of the kernels named ``kernel`` per call of ``fn``,
    from the profiler over ``calls`` calls after one warm-up.  A profile
    that comes back with no device time for it (seen on the H100 in a
    process's first profile, and twice in a row for K10 in one run) is
    taken again, up to ``attempts`` profiles, each failure naming the
    kernels the profile did record; if none records it, the run fails.
    With ``one_launch`` (``fn`` launches ``kernel`` once) it is the mean of
    the launches the profile kept: late in this script's process a profile
    has kept 5-13 of 20 launches of a kernel of milliseconds, and their sum
    over ``calls`` then reads low."""
    for attempt in range(attempts):
        rows = device_rows(profiled(fn, calls), width=None)
        got = sum(r["device_ms"] for r in rows if kernel in r["name"])
        kept = sum(r["calls"] for r in rows if kernel in r["name"])
        if got > 0:
            break
        print(f"no device time recorded for {kernel} in profile {attempt + 1}; recorded: "
              f"{[r['name'][:120] for r in rows[:5]]}", file=sys.stderr)
        time.sleep(1.0)
    check(got > 0, f"no device time recorded for {kernel}")
    if not one_launch:
        if kept % calls:
            print(f"the profile kept {kept} launches of {kernel} over {calls} calls",
                  file=sys.stderr)
        return got / calls
    if kept != calls:
        print(f"the profile kept {kept} of {calls} launches of {kernel}", file=sys.stderr)
    return got / kept


@contextlib.contextmanager
def timed_calls(*targets, sync: bool = True):
    """Wrap each (module or class, name) function so that every call is
    timed on the host clock, between two synchronisations with ``sync``,
    with its first argument's second dim (a search's frames); yields
    {name: [(seconds, dim), ...]}."""
    log = {name: [] for _, name in targets}
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def timed(name, fn):
        def run(x, *args, **kwargs):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(x, *args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            dim = x.shape[1] if isinstance(x, torch.Tensor) and x.dim() > 1 else 0
            log[name].append((time.perf_counter() - t0, dim))
            return out
        return run

    for mod, name, fn in saved:
        setattr(mod, name, timed(name, fn))
    try:
        yield log
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def rank_decode(argv: list[str]) -> dict:
    """One rank of a decode (spawned, or in this process for one rank):
    ``decode.main(argv)`` with the launch counters set to 0 just before and
    read just after, the device of every plain merge or plain search call,
    and each batch's encoder and search times, with the all-gathers inside
    each (a collective's time includes waiting for the slowest rank)."""
    torch.cuda.synchronize()
    with plain_calls_of((prefix_beam, "_merge_topk"), (prefix_beam, "beam_scan_plain")) as plain, \
            timed_calls((driver, "model_outputs"), (driver, "prefix_beam_search_sharded"),
                        (driver, "prefix_beam_search")) as steps, \
            timed_calls((encoder_bilstm, "model_all_gather")) as enc_x, \
            timed_calls((prefix_beam_sharded, "model_all_gather")) as search_x:
        build.reset_launches()
        t0 = time.perf_counter()
        result = decode.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
    searches = steps["prefix_beam_search_sharded"] + steps["prefix_beam_search"]
    return {"rank": distributed.topology()["rank"], "result": result, "wall_s": wall,
            "launches": {k: v for k, v in launches.items() if v}, "plain": plain,
            "frames": [d for _, d in searches],
            "encoder_s": sum(t for t, _ in steps["model_outputs"]),
            "search_s": sum(t for t, _ in searches),
            "encoder_exchange_s": sum(t for t, _ in enc_x["model_all_gather"]),
            "search_exchange_s": sum(t for t, _ in search_x["model_all_gather"])}


def rank_search(logits: np.ndarray, lens: np.ndarray, lm_path: str, kw: dict) -> dict:
    """One of 4 ranks: the sharded search with the RNN LM at model axis 4
    on the same rows as every rank; its result and launch counts."""
    distributed.initialize("cuda")
    dev = resolve_device("cuda")
    mesh = make_mesh(MeshConfig(model_axis=4))
    rnn = driver.load_lm(get_config(CFG2, **{"decode.lm_path": lm_path}), dev)
    build.reset_launches()
    got = prefix_beam_sharded.prefix_beam_search_sharded(
        torch.from_numpy(logits).to(dev), torch.from_numpy(lens).to(dev), mesh, rnn_lm=rnn, **kw)
    torch.cuda.synchronize()
    return {"out": [g.cpu().numpy() for g in got],
            "launches": {k: v for k, v in build.LAUNCHES.items() if v}}


def read_dump(prefix: str) -> list[tuple[str, str]]:
    """(reference, hypothesis) text pairs of a decode dump, in its order."""
    with open(prefix + ".ref.tsv") as r, open(prefix + ".hyp.tsv") as h:
        return [(a.split("\t", 1)[1], b.split("\t", 1)[1]) for a, b in zip(r, h)]


def sharded_decode_phase(arpa: str, rnn_lm: str) -> dict:
    """Config 2's serving path across ranks: ``decode.main ctc_bilstm_beam_lm
    decode.shard_beams=true`` at full width on its 14-bucket decode ladder
    over 64 utterances of 10-16 s, SHARD_BATCHES batches, in ranks spawned on the one
    card over gloo.  Each rank and batch runs 1 K1, the K2 launches of its
    direction (4, or 8 without the split), one K10 a frame, no K7 or K9, and
    no plain merge or search on the card.
      one:    the one-rank decode of the same batches (K7), the reference;
      model2: 2 ranks, model axis 2, the 4-gram: the same hypotheses;
      data2_model2: 4 ranks, data 2 x model 2, the 4-gram: the same
              hypotheses, each utterance counted once;
      rnn_model4: 4 ranks, model axis 4, the RNN LM;
    then the sharded search with the RNN LM in 4 ranks on config 2's logits
    with each row's transcript planted, against the plain search on the
    card: tokens and lengths exact, scores within RNN_RTOL / RNN_ATOL."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        base = [CFG2, "data.synthetic_min_sec=10", "data.synthetic_max_sec=16",
                "data.synthetic_num_utts=64", f"max_batches={SHARD_BATCHES}",
                f"train.checkpoint_dir={tmp}/none"]
        ngram = base + [f"decode.lm_path={arpa}"]
        one = rank_decode(ngram + [f"dump_path={tmp}/one"])
        check(one["launches"] == {"stft_log_mel": SHARD_BATCHES,
                                  "lstm_seq": 2 * CFG2_LAYERS * SHARD_BATCHES,
                                  "prefix_beam": SHARD_BATCHES} and not one["plain"],
              f"one-rank decode: {one['launches']} {one['plain']}")
        want_pairs = read_dump(f"{tmp}/one")
        # name: (ranks, model axis, argv, K2 directions a layer on each rank)
        runs = {"model2": (2, 2, ngram + ["mesh.model_axis=2"], 1),
                "data2_model2": (4, 2, ngram + ["mesh.data_axis=2", "mesh.model_axis=2"], 1),
                "rnn_model4": (4, 4, base + [f"decode.lm_path={rnn_lm}", "mesh.model_axis=4"],
                               2)}
        for name, (world, model, argv, dirs) in runs.items():
            ranks = launch.spawn(rank_decode, world, argv + [
                "decode.shard_beams=true", f"dump_path={tmp}/{name}"], timeout=RANK_TIMEOUT)
            for r in ranks:
                frames = r["frames"]
                want = {"stft_log_mel": SHARD_BATCHES,
                        "lstm_seq": dirs * CFG2_LAYERS * SHARD_BATCHES, "merge_topk": sum(frames)}
                check(len(frames) == SHARD_BATCHES and r["launches"] == want,
                      f"{name} rank {r['rank']}: launches {r['launches']} != {want}")
                check(not r["plain"], f"{name}: a plain merge or search ran: {r['plain']}")
                res = r["result"]
                check(res["world_size"] == world and res["dist_backend"] == "gloo"
                      and res["num_utts"] == one["result"]["num_utts"], f"{name}: {res}")
            res = ranks[0]["result"]
            if name != "rnn_model4":
                check(all(r["result"]["wer"] == one["result"]["wer"]
                          and r["result"]["cer"] == one["result"]["cer"] for r in ranks),
                      f"{name}: WER/CER {res} differ from one rank's {one['result']}")
                pairs = [p for r in ranks if r["rank"] % model == 0
                         for p in read_dump(f"{tmp}/{name}.p{r['rank']}")]
                check(sorted(pairs) == sorted(want_pairs) and (name != "model2"
                                                               or pairs == want_pairs),
                      f"{name}: hypotheses differ from the one-rank decode")
            r0 = ranks[0]
            exchange = r0["encoder_exchange_s"] + r0["search_exchange_s"]
            out[name] = {"world": world, **{k: res[k] for k in (
                "wer", "cer", "num_utts", "decode_rtf", "dist_backend")},
                "launches_rank0": r0["launches"], "frames": r0["frames"],
                **{k: r0[k] for k in ("wall_s", "encoder_s", "search_s", "encoder_exchange_s",
                                      "search_exchange_s")},
                "search_ms_per_frame": 1e3 * r0["search_s"] / sum(r0["frames"]),
                "exchange_share_of_batches": exchange / (r0["encoder_s"] + r0["search_s"])}
        out["one"] = {**{k: one["result"][k] for k in ("wer", "cer", "num_utts", "decode_rtf")},
                      "launches": one["launches"], "encoder_s": one["encoder_s"],
                      "search_s": one["search_s"]}
    out["search_rnn_model4"] = sharded_rnn_search(rnn_lm)
    return out


def sharded_rnn_search(rnn_lm: str) -> dict:
    """The sharded search with the RNN LM in 4 ranks at model axis 4 (one
    K10 a frame) against the plain search on the card."""
    cfg = get_config(CFG2, **{"data.synthetic_min_sec": "10", "data.synthetic_max_sec": "16",
                              "data.synthetic_num_utts": str(BEAM_B), "data.auto_buckets": "1",
                              "decode.lm_path": rnn_lm})
    logits, lens = cfg2_batch_logits(cfg)
    B, T, V = logits.shape
    batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    path = transcript_path(batch, lens.cpu(), T).to(CARD)
    planted = logits.clone()
    planted.scatter_add_(2, path[..., None], torch.full((B, T, 1), 4.0, device=CARD))
    ragged = lens.clone()
    ragged[B - 1] = 0
    dec = cfg.decode
    kw = dict(beam_size=BEAM_K, max_len=BEAM_L, lm_alpha=dec.lm_alpha, lm_beta=dec.lm_beta,
              sos_id=get_tokenizer(cfg.data.vocab).sos_id)
    t0 = time.perf_counter()
    ranks = launch.spawn(rank_search, 4, planted.float().cpu().numpy(),
                         ragged.int().cpu().numpy(), rnn_lm, kw, timeout=RANK_TIMEOUT)
    wall = time.perf_counter() - t0
    want = prefix_beam.prefix_beam_search_plain(planted, ragged, rnn_lm=driver.load_lm(cfg, CARD),
                                                **kw)
    for r in ranks:
        check(r["launches"] == {"merge_topk": T}, f"sharded RNN search: {r['launches']}")
        toks, n, score = (torch.from_numpy(x).to(CARD) for x in r["out"])
        check(torch.equal(n, want[1]) and torch.equal(toks, want[0]),
              "sharded RNN search: tokens or lengths differ from the plain search")
        torch.testing.assert_close(score, want[2], rtol=RNN_RTOL, atol=RNN_ATOL,
                                   msg=lambda m: f"sharded RNN search scores: {m}")
    score = torch.from_numpy(ranks[0]["out"][2]).to(CARD)
    return {"ranks": 4, "frames": T, "max_abs_err": (score - want[2]).abs().max().item(),
            "tol": {"tokens": "equal", "scores_rtol": RNN_RTOL, "scores_atol": RNN_ATOL},
            "spawn_and_search_s": wall, "mean_len": want[1].float().mean().item()}


def las_parity_phase(config: str) -> dict:
    """Configs 4 and 5 at full width, float32 compute, one short synthetic
    batch (LAS_UTTS utterances of at most LAS_MAX_SEC s: the cut that keeps
    the CPU side short), card vs CPU with the same seeded weights: the
    teacher-forced decoder logits and the CTC logits, then the attention
    beam search (and for config 5 the joint search at its CTC weight) at
    the config's beam and ``max_decode_len``, with ``las.w_out`` scaled by
    LAS_SHARPEN on both devices.  Tokens and lengths equal on every row whose
    best final score leads the runner-up by more than LAS_MARGIN, at least
    one such row a search (the rows inside it are counted), final scores
    within LAS_SCORE_RTOL."""
    cfg = get_config(config, **{"model.compute_dtype": "float32",
                                "data.synthetic_num_utts": str(LAS_UTTS),
                                "data.batch_size": str(LAS_UTTS), "data.auto_buckets": "1",
                                "data.synthetic_max_sec": LAS_MAX_SEC})
    batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    tok = get_tokenizer(cfg.data.vocab)
    dec = cfg.decode
    searches = {"attention_beam": 0.0}
    if config == CFG5:
        searches["joint_beam"] = dec.joint_ctc_weight
    outs = {}
    for name, device in (("cpu", torch.device("cpu")), ("card", CARD)):
        model = build_model(cfg, device)
        t = {k: torch.from_numpy(batch[k]).to(device)
             for k in ("audio", "audio_len", "tokens", "token_len")}
        dec_in = make_decoder_io(t["tokens"], t["token_len"], tok.sos_id, tok.eos_id)[0]
        with torch.inference_mode():
            out = model(t["audio"], t["audio_len"], targets=dec_in)
            res = {k: out[k].cpu() for k in ("enc_len", "ctc_logits", "dec_logits")}
            model.las.w_out.mul_(LAS_SHARPEN)
            for method, w in searches.items():
                t0 = time.perf_counter()
                toks, lens, final = attention_beam.final_beams(
                    model, out["enc"], out["enc_len"], tok.sos_id, tok.eos_id,
                    beam_size=dec.beam_size, max_len=dec.max_decode_len,
                    length_norm=dec.length_norm,
                    ctc_logits=out["ctc_logits"] if w > 0 else None, ctc_weight=w)
                res[method] = (toks.cpu(), lens.cpu(), final.cpu(), time.perf_counter() - t0)
        outs[name] = res
    cpu, gpu = outs["cpu"], outs["card"]
    check(torch.equal(cpu["enc_len"], gpu["enc_len"]), f"{config} slice: enc_len differs")
    rec = {"shape": list(gpu["dec_logits"].shape), "tol": SLICE_TOL,
           "audio_len": batch["audio_len"].tolist()}
    for key in ("ctc_logits", "dec_logits"):
        check(bool(torch.isfinite(gpu[key]).all()), f"{config} slice: non-finite {key}")
        rec[f"{key}_max_abs_err"], _ = errors(gpu[key], cpu[key])
        check(rec[f"{key}_max_abs_err"] <= SLICE_TOL,
              f"{config} {key} card vs CPU: {rec[f'{key}_max_abs_err']}")
    for method in searches:
        (ct, cl, cf, cs), (gt, gl, gf, gs) = cpu[method], gpu[method]
        check(bool(torch.isfinite(gf).all()), f"{config} {method}: non-finite scores")
        top2 = cf.topk(2, dim=1).values
        margin = top2[:, 0] - top2[:, 1]
        decisive = margin > LAS_MARGIN
        b_i = torch.arange(cf.shape[0])
        best_c, best_g = cf.argmax(1), gf.argmax(1)
        same = [bool(torch.equal(ct[b, best_c[b]], gt[b, best_g[b]])
                     and cl[b, best_c[b]] == gl[b, best_g[b]]) for b in range(cf.shape[0])]
        check(bool(decisive.any()), f"{config} {method}: no row leads by {LAS_MARGIN} "
              f"(margins {margin.tolist()})")
        check(all(s for s, d in zip(same, decisive.tolist()) if d),
              f"{config} {method}: tokens differ on a decisive row (margins {margin.tolist()}, "
              f"same {same})")
        score_err = float(((gf[b_i, best_g] - cf[b_i, best_c]).abs()
                           / cf[b_i, best_c].abs()).max())
        check(score_err <= LAS_SCORE_RTOL, f"{config} {method} scores card vs CPU: {score_err}")
        rec[method] = {"margins": margin.tolist(), "rows_inside_margin": int((~decisive).sum()),
                       "rows_equal": sum(same), "score_max_rel_err": score_err,
                       "score_rtol": LAS_SCORE_RTOL, "lengths": gl[b_i, best_g].tolist(),
                       "cpu_s": cs, "card_s": gs, "margin": LAS_MARGIN, "sharpen": LAS_SHARPEN}
    return rec


def las_decode_phase(config: str, batches: int, *extra: str) -> dict:
    """A serving path of configs 4 and 5 through ``decode.main`` at full width
    in bf16 on 10-16 s synthetic utterances, ``batches`` batches: exactly 1
    K1 and 2 K2 a layer a batch and no other kernel, no call of a plain
    STFT or LSTM version, the decoder steps and scorer calls a batch."""
    plain = [(stft_cuda, "stft_log_mel_plain"), (lstm_cuda, "lstm_seq_plain")]
    layers = get_config(config).model.encoder.num_layers
    with tempfile.TemporaryDirectory() as ckpt, plain_calls_of(*plain) as plain_calls, \
            timed_calls(*SEARCH_CALLS, sync=False) as steps:
        argv = [config, "data.synthetic_min_sec=10", "data.synthetic_max_sec=16",
                f"max_batches={batches}", f"train.checkpoint_dir={ckpt}", *extra]
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        result = decode.main(argv)
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
    want = {"stft_log_mel": batches, "lstm_seq": batches * layers * 2}
    check({k: v for k, v in launches.items() if v} == want,
          f"{config} decode launches {launches} != {want}")
    check(not plain_calls, f"a plain version ran on the serving path: {plain_calls}")
    check(set(result) >= {"method", "wer", "cer", "num_utts", "decode_rtf"}
          and result["num_utts"] > 0 and result["decode_rtf"] > 0
          and math.isfinite(result["wer"]), f"{config} decode: bad result {result}")
    return {**result, "wall_s": wall, "batches": batches, "launches": launches,
            "decoder_steps_per_batch": len(steps["decoder_step"]) / batches,
            "scorer_calls_per_batch": len(steps["score_extensions"]) / batches}


def las_train_phase(config: str, b: int) -> dict:
    """A training path of configs 4 and 5: ``train.main`` at full width in bf16,
    full batches of ``b`` utterances of 10-16 s in one bucket (config 5 with
    its waveform augmentation), then the greedy eval: per step 1 K1, 2 K3
    forwards and backwards a layer, and K4's alpha and beta only where the
    config's CTC weight is above 0; per eval batch 1 K1 and 2 K2 a layer;
    no call of a plain STFT, LSTM or CTC version on the card."""
    cfg = get_config(config)
    layers, ctc_on = cfg.model.encoder.num_layers, cfg.model.ctc_weight > 0
    plain = [(stft_cuda, "stft_log_mel_plain"), (lstm_cuda, "lstm_seq_plain"),
             (lstm_cuda, "lstm_seq_train_plain"), (lstm_cuda, "lstm_seq_bwd_plain"),
             (ctc, "alphas_plain"), (ctc, "posteriors_plain")]
    with tempfile.TemporaryDirectory() as ckpt, plain_calls_of(*plain) as plain_calls:
        argv = [config, "data.synthetic_min_sec=10", "data.synthetic_max_sec=16",
                f"data.synthetic_num_utts={LAS_TRAIN_UTTS}", "data.auto_buckets=1",
                f"steps={TRAIN_STEPS}", f"train.eval_every={TRAIN_STEPS}",
                f"train.log_every={TRAIN_STEPS}", f"train.checkpoint_dir={ckpt}"]
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        result = train.main(argv)
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
    last, ev = result["train"], result["eval"]
    evals = LAS_TRAIN_UTTS // b
    want = {"stft_log_mel": TRAIN_STEPS + evals, "lstm_seq": 2 * layers * evals,
            "lstm_seq_train_fwd": 2 * layers * TRAIN_STEPS,
            "lstm_seq_bwd": 2 * layers * TRAIN_STEPS}
    if ctc_on:
        want.update(ctc_alpha=TRAIN_STEPS, ctc_beta=TRAIN_STEPS)
    check({k: v for k, v in launches.items() if v} == want,
          f"{config} train launches {launches} != {want}")
    check(not plain_calls, f"a plain version ran on the training path: {plain_calls}")
    terms = ("ce_loss", "ctc_loss") if ctc_on else ("ce_loss",)
    check(last.get("step") == TRAIN_STEPS and all(math.isfinite(last[k]) for k in terms)
          and math.isfinite(last["grad_norm"]) and ("ctc_loss" in last) == ctc_on,
          f"{config} train: bad record {last}")
    check(ev.get("num_utts") == LAS_TRAIN_UTTS, f"{config} train eval: {ev}")
    return {"record": last, "eval": ev, "wall_s": wall, "step_s": 1.0 / last["steps_per_sec"],
            "launches": launches,
            "launches_per_step": {k: (v - want["lstm_seq"] * (k == "lstm_seq")
                                      - evals * (k == "stft_log_mel")) / TRAIN_STEPS
                                  for k, v in launches.items() if v and k != "lstm_seq"},
            "launches_per_eval_batch": {"stft_log_mel": 1, "lstm_seq": 2 * layers}}


def learn_joint_phase() -> dict:
    """The tiny joint config of the JAX package's end-to-end test
    (``tests/test_train_e2e.py``: H 64 x 2, decoder E 24 / H 48 / A 32,
    location 7 x 4, CTC weight 0.3, 16 utterances of 1-2 words, batch 8) on
    the card: its loss after 250 steps must be below the first logged one;
    then ``Trainer.decode_eval`` decodes it with the joint search (beam 4,
    CTC weight 0.3) and the attention search, WER finite."""
    base_cfg = get_config(CFG5)
    cfg = dataclasses.replace(
        base_cfg,
        frontend=FrontendConfig(specaugment=False),
        data=DataConfig(batch_size=8, bucket_audio_lens=(32000,), bucket_label_lens=(32,),
                        synthetic_num_utts=16),
        model=ModelConfig(
            encoder=BiLSTMEncoderConfig(conv_channels=(8, 8), hidden_dim=64, num_layers=2,
                                        dropout=0.0),
            decoder=LASDecoderConfig(embed_dim=24, hidden_dim=48, attention_dim=32,
                                     location_kernel=7, location_filters=4,
                                     label_smoothing=0.0),
            ctc_weight=0.3, compute_dtype="float32"),
        train=TrainConfig(optim=OptimConfig(peak_lr=3e-3, warmup_steps=30, total_steps=300),
                          log_every=100),
        decode=dataclasses.replace(base_cfg.decode, method="joint_beam", beam_size=4,
                                   max_decode_len=40, joint_ctc_weight=0.3))
    corpus = synthetic_corpus(16, cfg.frontend.sample_rate, seed=1, min_words=1, max_words=2)
    ds = BucketedDataset(corpus, batch_size=8, bucket_audio_lens=cfg.data.bucket_audio_lens,
                         bucket_label_lens=cfg.data.bucket_label_lens)
    t0 = time.perf_counter()
    with Trainer(cfg, dataset=ds, enable_checkpoints=False, device=CARD) as trainer:
        first = trainer.train(num_steps=LEARN_JOINT_STEPS[0])
        rest = trainer.train(num_steps=LEARN_JOINT_STEPS[1])
        wall = time.perf_counter() - t0
        joint = trainer.decode_eval(max_batches=2)
        trainer.cfg = dataclasses.replace(cfg, decode=dataclasses.replace(
            cfg.decode, method="attention_beam"))
        att = trainer.decode_eval(max_batches=2)
    check(rest["loss"] < first["loss"] and "ce_loss" in rest and "ctc_loss" in rest,
          f"learn joint: loss {rest} not below {first}")
    for name, res in (("joint_beam", joint), ("attention_beam", att)):
        check(res["method"] == name and math.isfinite(res["wer"]) and res["num_utts"] > 0,
              f"learn joint: {name} {res}")
    return {"first_loss": first["loss"], "last_loss": rest["loss"],
            "last_ce_loss": rest["ce_loss"], "last_ctc_loss": rest["ctc_loss"],
            "steps": sum(LEARN_JOINT_STEPS), "wall_s": wall,
            "joint_beam_wer": joint["wer"], "joint_beam_cer": joint["cer"],
            "attention_beam_wer": att["wer"], "attention_beam_cer": att["cer"]}


def las_split_phase(config: str, profile: bool) -> dict:
    """One full batch of a config-4 or config-5 decode (10-16 s, bf16, the
    config's own search), its wall split on the host clock: the encoder
    (``model_outputs``), the decoder steps and the CTC prefix scorer calls
    (each timed between two synchronisations), and the rest of the search;
    with ``profile``, then the same batch under the profiler: device time by
    kernel and the device's busy share of the batch (config 5's scorer
    launches over a million kernels a batch, too many to profile)."""
    cfg = get_config(config, **{"data.synthetic_min_sec": "10", "data.synthetic_max_sec": "16",
                                "data.synthetic_num_utts": str(get_config(config).data.batch_size),
                                "data.auto_buckets": "1"})
    batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    model = build_model(cfg, CARD)
    decode_fn = driver.make_decode_fn(cfg, model)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model_outputs(model, batch)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        with timed_calls(*SEARCH_CALLS) as log:
            t0 = time.perf_counter()
            ids, _ = decode_fn(batch)
            ids.cpu()
            total_s = time.perf_counter() - t0
        dec_s, sc_s = (sum(t for t, _ in log[k]) for k in ("decoder_step", "score_extensions"))
        out = {"batch_wall_s": total_s, "encoder_s": enc_s,
               "decoder_steps": len(log["decoder_step"]), "decoder_step_s": dec_s,
               "scorer_s": sc_s, "encoder_share": enc_s / total_s,
               "decoder_share": dec_s / total_s, "scorer_share": sc_s / total_s,
               "rest_of_search_share": (total_s - enc_s - dec_s - sc_s) / total_s}
        if not profile:
            return out
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            ids, _ = decode_fn(batch)
            ids.cpu()
            wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    total = sum(r["device_ms"] for r in rows)
    check(total > 0, f"{config} decode profile: no device time recorded")
    return {**out, "profiled_batch_wall_ms": wall_ms, "device_ms": total,
            "device_busy": total / wall_ms,
            "lstm_share_of_device": sum(r["device_ms"] for r in rows if "lstm" in r["name"])
            / total, "top": rows[:12]}


def las_train_profile_phase(config: str = CFG5) -> dict:
    """Device time by kernel over one full-width bf16 train step of config 5
    (a full batch of 32 utterances of 10-16 s, its waveform augmentation on)
    beside the step's host-clock time."""
    cfg = get_config(config, **{"data.synthetic_min_sec": "10", "data.synthetic_max_sec": "16",
                                "data.synthetic_num_utts": str(get_config(config).data.batch_size),
                                "data.auto_buckets": "1"})
    host_batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    st = train_state.init_train_state(cfg, train_state.build_model(cfg, CARD))
    batch = train_state.batch_to_device(host_batch, CARD)
    train_state.train_step(cfg, st, batch)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        train_state.train_step(cfg, st, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    total = sum(r["device_ms"] for r in rows)
    check(total > 0, f"{config} train profile: no device time recorded")
    share = lambda key: sum(r["device_ms"] for r in rows if key in r["name"]) / total  # noqa
    return {"step_wall_ms": wall_ms, "device_ms": total, "device_busy": total / wall_ms,
            "lstm_share": share("lstm"), "ctc_share": share("ctc_"),
            "stft_share": share("stft"), "top": rows[:16]}


def las_phases() -> dict:
    """Configs 4 and 5: card vs CPU (model, searches, one train step), the
    serving and training paths with counts, the tiny joint model learning,
    and K2, K3 and K4 at their shapes.  Returns the paths' results (each
    with its ``launches``) and {"kernels": las_kernels_phase()}."""
    out = {}
    for config in (CFG4, CFG5):
        print(f"{config} slice:", json.dumps(las_parity_phase(config)))
        print(f"{config} train_step:", json.dumps(train_step_phase(config, **{
            "data.synthetic_num_utts": str(LAS_UTTS), "data.batch_size": str(LAS_UTTS),
            "data.synthetic_max_sec": LAS_MAX_SEC})))
    out["las_decode"] = las_decode_phase(CFG4, LAS_DECODE_BATCHES, "data.synthetic_num_utts=64")
    out["joint_decode"] = las_decode_phase(CFG5, JOINT_DECODE_BATCHES,
                                           "data.synthetic_num_utts=64", "decode.auto_buckets=1")
    out["las_train"] = las_train_phase(CFG4, CFG4_B)
    out["joint_train"] = las_train_phase(CFG5, CFG5_B)
    for path, res in out.items():
        print(f"{path}:", json.dumps(res))
        if "decode_rtf" in res:
            print(f"{path}: decode_rtf {res['decode_rtf']:.5f} wer {res['wer']:.4f} wall "
                  f"{res['wall_s']:.2f} s decoder steps a batch "
                  f"{res['decoder_steps_per_batch']:.1f}")
        else:
            rec = res["record"]
            print(f"{path}: audio_seconds_per_sec_per_chip "
                  f"{rec['audio_seconds_per_sec_per_chip']:.2f} step {res['step_s']:.4f} s "
                  f"ce_loss {rec['ce_loss']:.4f} ctc_loss {rec.get('ctc_loss')}")
    print("learn_joint:", json.dumps(learn_joint_phase()))
    out["kernels"] = las_kernels_phase()
    print("las_kernels:", json.dumps(out["kernels"]))
    return out


def las_kernels_phase() -> dict:
    """K2, K3's forward and backward at configs 4 and 5's LSTM layer shapes
    (B 16, H 512, D 1024; B 32, H 640, D 1280; bf16 inputs and residuals,
    lengths from 400 down to 250 frames) and K4 at config 5's training
    shape (its first batch's labels over T' 400), each against its plain
    version on the card, on the co-resident grids; timed beside the plain
    version.  Returns {kernel name: [case, ...]}."""
    g = torch.Generator().manual_seed(19)
    out = {k: [] for k in ("lstm_seq", "lstm_seq_train_fwd", "lstm_seq_bwd", "ctc_alpha",
                           "ctc_beta")}
    for tag, b, Hd in (("config 4", CFG4_B, 512), ("config 5", CFG5_B, 640)):
        D, G = 2 * Hd, 4 * Hd
        check(lstm_cuda.forward_route(Hd, b) is not None
              and lstm_cuda.backward_route(Hd, b) is not None,
              f"{tag}: H {Hd} B {b} is past the co-resident grids")
        lengths = np.linspace(T_LSTM, 250, b).astype(int).tolist()
        x = (torch.randn(b, T_LSTM, D, generator=g) * 0.5).bfloat16().cuda()
        wih = (torch.randn(D, G, generator=g) / D ** 0.5).bfloat16().cuda()
        whh = (torch.randn(Hd, G, generator=g) / Hd ** 0.5).cuda()
        bias = (torch.randn(G, generator=g) * 0.1).cuda()
        gy = torch.randn(b, T_LSTM, Hd, generator=g).cuda()
        lens = torch.tensor(lengths, dtype=torch.int32).cuda()
        shape = {"layer": tag, "x": [b, T_LSTM, D], "H": Hd}
        args = (x, wih, whh, bias, lens, False, torch.bfloat16)
        got = lstm_cuda.lstm_seq(*args)
        torch.cuda.synchronize()
        err, rel = errors(got, lstm_cuda.lstm_seq_plain(*args))
        check(err <= LSTM_TOL, f"lstm_seq {tag} disagrees: {err}")
        bnd = lstm_bounds(b, T_LSTM, D, Hd, int(sum(lengths)))
        out["lstm_seq"].append({**shape, "max_abs_err": err, "max_rel_err": rel,
                                "ms": time_ms(lambda: lstm_cuda.lstm_seq(*args), 5, 4, 1),
                                "plain_ms": time_ms(lambda: lstm_cuda.lstm_seq_plain(*args),
                                                    2, 1, 1), "bound_ms": bnd["fwd"][0]})
        targs = (*args, torch.bfloat16)
        fwd = lstm_cuda.lstm_seq_train_fwd(*targs)
        torch.cuda.synchronize()
        fwant = lstm_cuda.lstm_seq_train_plain(*targs)
        bargs = (gy, x, wih, whh, lens, fwd[1], fwd[2], False)
        bwd = lstm_cuda.lstm_seq_bwd(*bargs)
        torch.cuda.synchronize()
        bwant = lstm_cuda.lstm_seq_bwd_plain(*bargs)
        for name, gots, wants, call, plain_call, bkey in (
                ("lstm_seq_train_fwd", fwd, fwant, lambda: lstm_cuda.lstm_seq_train_fwd(*targs),
                 lambda: lstm_cuda.lstm_seq_train_plain(*targs), "train_fwd"),
                ("lstm_seq_bwd", bwd, bwant, lambda: lstm_cuda.lstm_seq_bwd(*bargs),
                 lambda: lstm_cuda.lstm_seq_bwd_plain(*bargs), "bwd")):
            errs = []
            for a, w in zip(gots, wants):
                check(a.dtype == w.dtype and bool(torch.isfinite(a.float()).all()),
                      f"K3 {name} {tag}: non-finite or of type {a.dtype}")
                tol = K3_BF16_TOL if a.dtype == torch.bfloat16 else K3_F32_TOL
                e, r = errors(a, w)
                check(r <= tol, f"K3 {name} {tag}: {r} > {tol} of its largest entry")
                errs.append((e, r))
            out[name].append({**shape, "max_abs_err": max(e for e, _ in errs),
                              "max_rel_err": max(r for _, r in errs),
                              "ms": time_ms(call, 5, 4, 1),
                              "plain_ms": time_ms(plain_call, 2, 1, 1),
                              "bound_ms": bnd[bkey][0]})
    logits, logit_len, labels, label_len = bench_kernel_turns.train_ctc_case(CARD, CFG5)
    _, logp_tbs, _, skip = ctc.prep(logits, labels.long(), label_len, 0)
    T, S = logp_tbs.shape[0], logp_tbs.shape[2]
    alphas, final = ctc_cuda.ctc_alpha(logp_tbs, skip, logit_len)
    torch.cuda.synchronize()
    ref_alphas, ref_final = ctc.alphas_plain(logp_tbs, skip, logit_len)
    alpha_err = max(ctc_close("alphas", alphas, ref_alphas, CTC_RTOL, CTC_ALPHA_ATOL),
                    ctc_close("final alpha", final, ref_final, CTC_RTOL, CTC_ALPHA_ATOL))
    logz = ctc.terminal_logz(ref_final, label_len)
    feasible = (logz > ctc.NEG_INF / 2) & (logit_len > 0)
    bargs = (logp_tbs, ref_alphas, ctc.shift_left(skip, 2, fill=False).contiguous(),
             ctc.terminal_betas(label_len, S), torch.where(feasible, logit_len, 0).to(torch.int32),
             torch.where(feasible, logz, 0.0))
    w = ctc_cuda.ctc_beta(*bargs)
    torch.cuda.synchronize()
    beta_err = ctc_close("posteriors", w, ctc.posteriors_plain(*bargs), CTC_GRAD_RTOL,
                         CTC_GRAD_ATOL)
    frames, shape = int(logit_len.sum()), {"layer": "config 5", "logp_tbs": [T, CFG5_B, S]}
    out["ctc_alpha"].append({
        **shape, "max_abs_err": alpha_err,
        "ms": time_ms(lambda: ctc_cuda.ctc_alpha(logp_tbs, skip, logit_len), 10, 10, 1),
        "plain_ms": time_ms(lambda: ctc.alphas_plain(logp_tbs, skip, logit_len), 2, 1, 1),
        "bound_ms": ctc_bound("alpha", T, CFG5_B, S, frames)[0]})
    out["ctc_beta"].append({
        **shape, "max_abs_err": beta_err,
        "ms": time_ms(lambda: ctc_cuda.ctc_beta(*bargs), 10, 10, 1),
        "plain_ms": time_ms(lambda: ctc.posteriors_plain(*bargs), 2, 1, 1),
        "bound_ms": ctc_bound("beta", T, CFG5_B, S, frames)[0]})
    return out


def stream_case(g: torch.Generator, b: int, T: int, Hd: int, D: int = STREAM_KERNEL_D):
    """``lstm_seq_stream``'s inputs at a streaming shape: x (b, T, D) bf16, the
    layer's weights, the lengths (all T but the last row's, T // 2, where b
    > 1) and a carried state (h0, c0) (b, Hd) float32, on the card."""
    G = 4 * Hd
    x = (torch.randn(b, T, D, generator=g) * 0.5).bfloat16().cuda()
    wih = (torch.randn(D, G, generator=g) / D ** 0.5).bfloat16().cuda()
    whh = (torch.randn(Hd, G, generator=g) / Hd ** 0.5).cuda()
    bias = (torch.randn(G, generator=g) * 0.1).cuda()
    lens = torch.tensor([T] * (b - 1) + [T // 2 if b > 1 else T], dtype=torch.int32).cuda()
    h0, c0 = ((torch.randn(b, Hd, generator=g) * 0.3).cuda() for _ in range(2))
    return x, wih, whh, bias, lens, h0, c0


def stream_bound(b: int, T: int, D: int, Hd: int, valid: int) -> tuple[float, str]:
    """``bound`` of ``lstm_seq_stream``: K2's bytes (x, wih bf16; whh, bias,
    lengths; out bf16) plus the state read and handed on (4 b Hd floats); its
    operations at the valid steps (the projection in bf16, the recurrence
    in fp32)."""
    G = 4 * Hd
    nbytes = 2 * b * T * D + 2 * D * G + 4 * Hd * G + 4 * G + 4 * b + 2 * b * T * Hd + 16 * b * Hd
    return bound(nbytes, 2 * D * G * valid / PEAK_BF16_S + 2 * Hd * G * valid / PEAK_FP32_S)


def stream_kernel_case(g: torch.Generator, b: int, T: int, Hd: int) -> dict:
    """One shape of ``lstm_seq_stream``: against its plain version (output
    and state), its wide form (forced) bit for bit, and STREAM_KERNEL_CHUNKS
    chunks of T steps bit-equal to one K2 launch over their frames (from
    zeros) and to one carried launch over them (from (h0, c0)); then timed
    beside its plain version and cuDNN's ``nn.LSTM`` with ``hx``."""
    args = stream_case(g, b, T, Hd)
    x, wih, whh, bias, lens, h0, c0 = args
    out, hT, cT = lstm_cuda.lstm_seq_stream(*args, torch.bfloat16)
    torch.cuda.synchronize()
    want = lstm_cuda.lstm_seq_plain(x, wih, whh, bias, lens, False, torch.bfloat16, h0, c0)
    err = max(errors(a, w)[0] for a, w in zip((out, hT, cT), want))
    check(bool(torch.isfinite(out.float()).all()), "lstm_seq_stream: non-finite output")
    check(err <= LSTM_TOL, f"lstm_seq_stream b {b} T {T} H {Hd}: {err} from its plain version")
    grid = lstm_cuda.forward_route(Hd, b, build.sm_count(0))
    wide = lstm_cuda.stream_on_route(None, *args, torch.bfloat16)
    on_grid = grid is not None
    if on_grid:
        check(all(torch.equal(a, w) for a, w in zip(wide, (out, hT, cT))),
              f"lstm_seq_stream b {b} T {T}: the wide form differs from the grid's")
    # Chunks: a sequence of STREAM_KERNEL_CHUNKS x T steps, its rows' lengths
    # all of it but the last row's (3.5 chunks).
    n = STREAM_KERNEL_CHUNKS
    xs = stream_case(g, b, n * T, Hd)[0]
    seq = torch.tensor([n * T] * (b - 1) + [n * T * 7 // 10 if b > 1 else n * T],
                       dtype=torch.int32).cuda()
    one_k2 = lstm_cuda.lstm_seq_infer(xs, wih, whh, bias, seq, False, torch.bfloat16)
    zeros = torch.zeros_like(h0)
    one_carried = lstm_cuda.lstm_seq_stream(xs, wih, whh, bias, seq, h0, c0, torch.bfloat16)
    for start, whole in (((zeros, zeros), (one_k2,)), ((h0, c0), one_carried)):
        parts, (h, c) = [], start
        for i in range(n):
            part_len = torch.clamp(seq - i * T, 0, T).int()
            o, h, c = lstm_cuda.lstm_seq_stream(xs[:, i * T:(i + 1) * T].contiguous(), wih, whh,
                                                bias, part_len, h, c, torch.bfloat16)
            parts.append(o)
        check(torch.equal(torch.cat(parts, dim=1), whole[0]),
              f"lstm_seq_stream b {b} T {T}: chunks differ from one launch")
        if len(whole) == 3:
            check(torch.equal(h, whole[1]) and torch.equal(c, whole[2]),
                  f"lstm_seq_stream b {b} T {T}: the chunks' state differs from one launch's")
    ref = cudnn_lstm(STREAM_KERNEL_D, wih, whh, bias)
    xf, hx = x.float(), (h0[None], c0[None])
    with torch.no_grad():
        library_ms = time_ms(lambda: ref(xf, hx))
    bound_ms, bound_by = stream_bound(b, T, STREAM_KERNEL_D, Hd, int(lens.sum()))
    return {"x": [b, T, STREAM_KERNEL_D], "H": Hd, "grid": grid._asdict() if on_grid else None,
            "max_abs_err": err, "wide_equal": on_grid, "chunks_equal": True,
            "ms": time_ms(lambda: lstm_cuda.lstm_seq_stream(*args, torch.bfloat16)),
            "wide_ms": time_ms(lambda: lstm_cuda.stream_on_route(None, *args, torch.bfloat16)),
            "plain_ms": time_ms(lambda: lstm_cuda.lstm_seq_plain(
                x, wih, whh, bias, lens, False, torch.bfloat16, h0, c0), reps=5, inner=1,
                warmup=1),
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def stream_kernels_phase() -> list[dict]:
    """``lstm_seq_stream`` (K2 from a carried state) at the streaming step's
    shapes, B 1 and 8, chunks of 4 and 12 steps (blocks of 16 and 48
    frames), H 384, the first layer's D 640; and its wide form at H 1536
    (``stream_kernel_case``).  -> the two kernel rows."""
    g = torch.Generator().manual_seed(20)
    cases = [stream_kernel_case(g, b, T, H) for b in (1, STREAM_B) for T in (4, 12)]
    check(all(c["grid"] for c in cases), f"lstm_seq_stream left the grid: {cases}")
    wide = stream_kernel_case(g, STREAM_B, 4, WIDE_H)
    check(wide["grid"] is None, "lstm_seq_stream at H 1536 fits the grid")
    print("stream_kernels:", json.dumps(cases + [wide]))
    head = cases[2]          # B 8, chunks of 4 steps: the default block of 16 frames
    row = {"name": "lstm_seq_stream", "route": "cuda",
           "source": "pytorch_asr_tpu_torch/csrc/lstm_seq.cu",
           "replaces": "pytorch_asr_tpu/decoding/streaming.py:156",
           "shape": f"x ({STREAM_B}, 4, {STREAM_KERNEL_D}) bf16, H {H}, a carried (h, c); "
                    f"also B 1 and chunks of 12",
           "max_abs_err": max(c["max_abs_err"] for c in cases), "tol": LSTM_TOL,
           "library": "torch.nn.LSTM with hx (cuDNN, fp32, all lengths = T)", "cases": cases,
           **{k: head[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}}
    wide_row = {**{k: wide[k] for k in ("max_abs_err", "plain_ms", "library_ms", "bound_ms",
                                        "bound_by")},
                "name": "lstm_seq_stream_wide", "route": "cuda",
                "source": "pytorch_asr_tpu_torch/csrc/lstm_seq.cu",
                "replaces": "pytorch_asr_tpu/decoding/streaming.py:156",
                "shape": f"x ({STREAM_B}, 4, {STREAM_KERNEL_D}) bf16, H {WIDE_H}",
                "tol": LSTM_TOL, "library": row["library"], "ms": wide["wide_ms"]}
    return [row, wide_row]


def stream_audio(b: int, cfg: FrontendConfig) -> np.ndarray:
    """(b, STREAM_SEC s) float32: stream i is sines at 300 + 70 i Hz under a
    3 Hz envelope (tests/test_streaming.py's structured audio) for its first
    10 + 6 i / (b - 1) s, plus 0.1 noise throughout (numpy seed 20)."""
    n = STREAM_SEC * cfg.sample_rate
    t = np.arange(n, dtype=np.float32) / cfg.sample_rate
    rng = np.random.default_rng(20)
    audio = rng.normal(size=(b, n)).astype(np.float32) * 0.1
    for i in range(b):
        sec = 10.0 + 6.0 * i / max(b - 1, 1)
        on = t < sec
        audio[i, on] += (np.sin(2 * np.pi * (300 + 70 * i) * t[on])
                         * (1.0 + 0.5 * np.sin(2 * np.pi * 3.0 * t[on])))
    return audio


def run_stream(model, cfg, audio: np.ndarray, block_frames: int, **rec_kw) -> dict:
    """Feed ``audio`` to a ``StreamingRecognizer`` (``rec_kw``: beam mode and
    its fusion) in STREAM_CHUNK-sample chunks, then ``finish``: {"tokens"
    (greedy: the ids collected; beam: ``finish``'s best prefixes),
    "block_s" (host wall a block, the device's work and the ids' copy
    included), "launches", "plain_calls", "enc", "logits" (each block's LSTM
    output and logits, concatenated), "blocks" (each block's logits), and in
    beam mode "searches" (each block's log-probs, valid frames and best beam
    as the search got and gave them) and "state" (the beams and LM state
    after the last block)}."""
    rec = streaming.StreamingRecognizer(model, cfg, audio.shape[0], block_frames, **rec_kw)
    got = [[] for _ in range(audio.shape[0])]
    encs, logits, searches, head = [], [], [], model.ctc_logits
    search = prefix_beam.prefix_beam_continue_best

    def recorded(enc):
        encs.append(enc)
        logits.append(head(enc))
        return logits[-1]

    def searched(state, logp, n_valid, **kw):
        out = search(state, logp, n_valid, **kw)
        searches.append((logp, n_valid, out[2]))
        return out

    model.ctc_logits = recorded
    prefix_beam.prefix_beam_continue_best = searched
    plain = [(stft_cuda, "stft_log_mel_plain"), (lstm_cuda, "lstm_seq_plain"),
             (prefix_beam, "beam_scan_plain"), (prefix_beam, "continue_plain")]
    beam = rec.mode == "beam"
    try:
        with plain_calls_of(*plain) as plain_calls, timed_calls(
                (streaming.StreamingRecognizer, "_run_block"), sync=False) as log:
            torch.cuda.synchronize()
            build.reset_launches()
            for off in range(0, audio.shape[1], STREAM_CHUNK):
                for b, new in enumerate(rec.accept(audio[:, off:off + STREAM_CHUNK])):
                    got[b].extend(new)
            final = rec.finish()
            got = final if beam else [g + new for g, new in zip(got, final)]
            launches = dict(build.LAUNCHES)
    finally:
        del model.ctc_logits
        prefix_beam.prefix_beam_continue_best = search
    out = {"tokens": got, "block_s": [s for s, _ in log["_run_block"]], "launches": launches,
           "plain_calls": list(plain_calls), "enc": torch.cat(encs, dim=1),
           "logits": torch.cat(logits, dim=1), "blocks": logits}
    if beam:
        out.update(searches=searches, state=(rec.state.beam, rec.state.lm_carry))
    return out


def stream_parity(run: dict, out: dict, offline: list, strict: bool) -> dict:
    """A streaming run's blocks against the offline model on the same audio.
    The encoder's outputs must be bit-equal: K1's frames, the convs over the
    carried context (cuDNN picked the same bits for a block as for the
    utterance in every run so far) and K2's steps do not depend on where a
    block starts.  The logits may differ (cuBLAS's head GEMM sums in another
    order for a block's rows than for the utterance's); then every frame
    whose offline top two differ by more than twice the largest difference
    keeps its argmax, and every row whose frames all do gives the offline
    tokens (``strict``: at least one row must)."""
    T_enc = int(out["enc_len"][0])
    check(torch.equal(run["enc"][:, :T_enc], out["enc"][:, :T_enc]),
          "stream: the blocks' encoder outputs differ from the offline encoder's")
    chunked, whole = run["logits"][:, :T_enc], out["ctc_logits"][:, :T_enc]
    equal = torch.equal(chunked, whole)
    diff = float((chunked - whole).abs().max())
    top2 = whole.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    clear = gap > 2 * diff
    check(torch.equal(chunked.argmax(-1)[clear], whole.argmax(-1)[clear]),
          f"stream: an argmax differs where the top two differ by more than {2 * diff}")
    rows = [b for b in range(len(offline)) if equal or bool(clear[b].all())]
    check(all(run["tokens"][b] == offline[b] for b in rows),
          f"stream: tokens differ from offline on rows {rows}")
    check(bool(rows) or not strict, f"stream: no row leads by more than {2 * diff} on every frame")
    check(any(run["tokens"]), "stream: nothing decoded")
    return {"enc_bit_equal": True, "logits_bit_equal": equal, "logits_max_abs_diff": diff, "margin": 2 * diff,
            "clear_frames": float(clear.float().mean()),
            "min_top2_gap_by_row": gap.amin(dim=1).tolist(), "rows_checked": rows,
            "tokens": sum(map(len, run["tokens"])),
            "tokens_equal_rows": sum(run["tokens"][b] == offline[b] for b in range(len(offline)))}


def stream_offline(cfg, audio: np.ndarray):
    """The causal model of ``cfg`` (seeded) on the card, and its offline
    outputs and greedy tokens over the whole of ``audio``."""
    model = build_model(cfg, CARD)
    with torch.inference_mode():
        out = model(torch.from_numpy(audio).to(CARD),
                    torch.full((audio.shape[0],), audio.shape[1], device=CARD))
        ids, lens = greedy_ctc(out["ctc_logits"], out["enc_len"])
    return model, out, [ids[b, :lens[b]].tolist() for b in range(audio.shape[0])]


def stream_phase() -> dict:
    """The greedy streaming recognizer at full width on the card: config 1's
    widths made causal (``CAUSAL``), seeded weights; B 8 streams of
    ``stream_audio`` in 1600-sample chunks, in blocks of 16 and 48 frames.
    In bf16, the path: each block launches exactly one K1 and three
    ``lstm_seq_stream`` (on the grid) and nothing else, no plain STFT or LSTM
    version runs on the card, and the tokens are held to the offline greedy
    decode on the card (``stream_parity``); the host-observed latency a
    block (p50, p99) and the streaming RTF (the blocks' wall over the
    stream's seconds) at B 1 and 8, and one profiled run's device busy
    share.  bf16 logits tie often (their top two equal, a block's head one
    bf16 step off), so the same comparison also runs at float32, where it
    must find decisive rows."""
    cfg = get_config("ctc_bilstm_dev1h", **dict(a.split("=", 1) for a in CAUSAL))
    audio = stream_audio(STREAM_B, cfg.frontend)
    model, out, offline = stream_offline(cfg, audio)
    res = {"streams": STREAM_B, "seconds": STREAM_SEC, "chunk": STREAM_CHUNK,
           "offline_tokens": sum(map(len, offline))}
    for block in STREAM_BLOCKS:
        run = run_stream(model, cfg, audio, block)
        blocks = len(run["block_s"])
        want = {"stft_log_mel": blocks, "lstm_seq_stream": LAYERS * blocks}
        check({k: v for k, v in run["launches"].items() if v} == want,
              f"stream block {block}: launches {run['launches']} != {want}")
        check(not run["plain_calls"], f"a plain version ran on the card: {run['plain_calls']}")
        res[f"block{block}"] = {"blocks": blocks, "launches": run["launches"],
                                **stream_parity(run, out, offline, strict=False)}
        for b in (1, STREAM_B):
            times = np.array(run["block_s"] if b == STREAM_B
                             else run_stream(model, cfg, audio[:1], block)["block_s"]) * 1e3
            res[f"block{block}"][f"b{b}"] = {
                "p50_ms": float(np.percentile(times, 50)), "p99_ms": float(np.percentile(times, 99)),
                "rtf": float(times.sum() / 1e3 / STREAM_SEC)}
    # Device busy share of one run of blocks of 16 at B 8.
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_stream(model, cfg, audio, STREAM_BLOCKS[0])
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    device_ms = sum(r["device_ms"] for r in rows)
    check(device_ms > 0, "stream profile: no device time recorded")
    res["profile"] = {"wall_ms": wall_ms, "device_ms": device_ms, "busy": device_ms / wall_ms,
                      "top": rows[:6]}
    # float32: the same weights and audio, the comparison strict.
    cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                               compute_dtype="float32"))
    model32, out32, offline32 = stream_offline(cfg32, audio)
    for block in STREAM_BLOCKS:
        res[f"float32_block{block}"] = stream_parity(run_stream(model32, cfg32, audio, block),
                                                     out32, offline32, strict=True)
    res["launches"] = res[f"block{STREAM_BLOCKS[0]}"]["launches"]
    return res


def wide_stream_phase() -> dict:
    """The streaming recognizer past the co-resident grid: the causal model
    at H 1536 (``WIDE_H``), B 8 streams, 2 s, blocks of 16 frames: three
    ``lstm_seq_stream_wide`` a block and no grid launch."""
    cfg = get_config("ctc_bilstm_dev1h", **dict(a.split("=", 1) for a in CAUSAL),
                     **{"model.encoder.hidden_dim": str(WIDE_H)})
    model = build_model(cfg, CARD)
    run = run_stream(model, cfg, stream_audio(STREAM_B, cfg.frontend)[:, :2 * 16000],
                     STREAM_BLOCKS[0])
    blocks = len(run["block_s"])
    want = {"stft_log_mel": blocks, "lstm_seq_stream_wide": LAYERS * blocks}
    check({k: v for k, v in run["launches"].items() if v} == want,
          f"wide stream: launches {run['launches']} != {want}")
    return {"blocks": blocks, "launches": run["launches"]}


def planted_alignment(g: torch.Generator):
    """Logits (8, 400, 31) float32 with each row's transcript planted (+4 on
    each lattice label over an even split of its frames, blank between),
    over normal(0, 1): rows of 400 down to 100 frames, one of no frames and
    one infeasible (110 tokens in 100 frames); transcripts of random chars
    with repeats."""
    logit_len = [400, 371, 352, 330, 310, 120, 0, 100]
    token_len = [150, 140, 130, 120, 100, 40, 5, 110]
    logits = torch.randn(8, 400, V, generator=g)
    tokens = torch.zeros(8, max(token_len), dtype=torch.int32)
    for b, (T, L) in enumerate(zip(logit_len, token_len)):
        tokens[b, :L] = torch.randint(1, V, (L,), generator=g, dtype=torch.int32)
        tokens[b, 1:L:7] = tokens[b, :L - 1:7]               # repeats
        ext = [0] + [x for t in tokens[b, :L].tolist() for x in (t, 0)]
        edges = np.linspace(0, T, len(ext) + 1).astype(int)
        for s, lab in enumerate(ext):
            logits[b, edges[s]:edges[s + 1], lab] += 4.0
    return logits, torch.tensor(logit_len), tokens, torch.tensor(token_len)


def align_phase() -> dict:
    """``ctc_forced_align`` on the card against the CPU on planted logits
    (integer outputs equal, scores to ALIGN_RTOL), timed on both (host
    clock, synchronised); then ``align.main`` on the card over config 1
    (ALIGN_BATCHES batches of 8 utterances of 10-16 s): exactly 1 K1 and 6
    K2 a batch, a segment per token."""
    args = planted_alignment(torch.Generator().manual_seed(21))
    cpu = align_mod.ctc_forced_align(*args)
    card_args = [a.to(CARD) for a in args]
    card = align_mod.ctc_forced_align(*card_args)
    for k in ("frame_state", "frame_label", "starts", "ends"):
        check(torch.equal(card[k].cpu(), cpu[k]), f"align: {k} differs card vs CPU")
    score_err = float(((card["score"].cpu() - cpu["score"]).abs()
                       / cpu["score"].abs().clamp(min=1e-30)).max())
    check(score_err <= ALIGN_RTOL, f"align: scores differ by {score_err} relative")

    def wall(fn, reps=3):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e3

    res = {"shape": [8, 400, V], "score_rel_err": score_err, "rtol": ALIGN_RTOL,
           "card_ms": wall(lambda: align_mod.ctc_forced_align(*card_args)),
           "cpu_ms": wall(lambda: align_mod.ctc_forced_align(*args), reps=1)}
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["ctc_bilstm_dev1h", "data.synthetic_min_sec=10", "data.synthetic_max_sec=16",
                f"data.synthetic_num_utts={ALIGN_BATCHES * B}", "data.auto_buckets=1",
                f"max_batches={ALIGN_BATCHES}", f"train.checkpoint_dir={tmp}/ckpt",
                f"dump_path={tmp}/segs.tsv"]
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        out = align.main(argv)
        res["main_wall_s"] = time.perf_counter() - t0
        res["launches"] = dict(build.LAUNCHES)
        with open(f"{tmp}/segs.tsv") as fh:
            rows = [line.split("\t") for line in fh.read().splitlines()]
    want = {"stft_log_mel": ALIGN_BATCHES, "lstm_seq": ALIGN_BATCHES * LAYERS * 2}
    check({k: v for k, v in res["launches"].items() if v} == want,
          f"align.main launches {res['launches']} != {want}")
    check(out["utts"] == ALIGN_BATCHES * B and out["segments"] == len(rows) > 0
          and all(len(r) == 4 for r in rows),
          f"align.main: {out}, {rows[:3]}")
    res.update(out)
    return res


def slice20_phases() -> tuple[list[dict], dict]:
    """Slice 20's paths: the kernel rows of ``lstm_seq_stream``, the
    streaming recognizer, the causal model's decode and train CLIs, forced
    alignment, and the streaming recognizer past the grid.  -> (rows,
    {path: launches}), the wide path under ``wide_stream``."""
    t0 = time.perf_counter()
    rows = stream_kernels_phase()
    for k in rows:
        print(f"check {k['name']}: max_abs_err {k['max_abs_err']:.3g} (tol {k['tol']}) "
              f"ms {k['ms']:.4f} plain {k['plain_ms']:.4f} library {k['library_ms']:.4f} "
              f"bound {k['bound_ms']:.4f} ({k['bound_by']})")
    stream = stream_phase()
    print("stream:", json.dumps(stream))
    for block in STREAM_BLOCKS:
        for tag in ("", "float32_"):
            r = stream[f"{tag}block{block}"]
            print(f"stream {tag}block {block}: enc bit_equal {r['enc_bit_equal']} logits "
                  f"bit_equal {r['logits_bit_equal']} max_diff {r['logits_max_abs_diff']:.3g} "
                  f"rows {r['rows_checked']} tokens {r['tokens']} equal rows "
                  f"{r['tokens_equal_rows']} "
                  + " ".join(f"B{b}: p50 {r[f'b{b}']['p50_ms']:.3f} ms p99 "
                             f"{r[f'b{b}']['p99_ms']:.3f} ms rtf {r[f'b{b}']['rtf']:.5f}"
                             for b in (1, STREAM_B) if f"b{b}" in r))
    print(f"stream busy {stream['profile']['busy']:.3f}")
    dec = decode_phase(CAUSAL, 1)
    print("causal_decode:", json.dumps(dec))
    trn = train_main_phase(CAUSAL, 1)
    print("causal_train:", json.dumps(trn))
    print(f"causal_train: audio_seconds_per_sec_per_chip "
          f"{trn['record']['audio_seconds_per_sec_per_chip']:.2f} step {trn['step_s']:.4f} s")
    aln = align_phase()
    print("align:", json.dumps(aln))
    print(f"align: {aln['segments']} segments, align.main {aln['main_wall_s']:.2f} s, "
          f"ctc_forced_align card {aln['card_ms']:.1f} ms cpu {aln['cpu_ms']:.1f} ms")
    wide = wide_stream_phase()
    print("wide_stream:", json.dumps(wide))
    print(f"slice20: {time.perf_counter() - t0:.1f} s")
    return rows, {"stream_greedy": stream["launches"], "causal_decode": dec["launches"],
                  "causal_train": trn["launches"], "align": aln["launches"],
                  "wide_stream": wide["launches"]}


def carried_name(src, A: int) -> str:
    """The carried search's count on its main route (K9 on its grid)."""
    base = "prefix_beam_rnn" if src == "rnn" else "prefix_beam"
    return base + ("_topa" if A else "") + "_carry"


def stream_beam_sources(cfg, arpa: str, rnn_lm_path: str) -> dict:
    """The fusion keywords of each source: the 4-gram table through
    ``driver.load_lm`` (as ``decode.main`` loads it) and the RNN LM with its
    ``sos_id``, at config 2's alpha and beta."""
    dec, sos = cfg.decode, get_tokenizer(cfg.data.vocab).sos_id
    lm = dict(lm_alpha=dec.lm_alpha, lm_beta=dec.lm_beta)
    return {None: {},
            "dense": {**lm, "lm_table": driver.load_lm(
                get_config(CFG2, **{"decode.lm_path": arpa}), CARD)},
            "rnn": {**lm, "sos_id": sos, "rnn_lm": driver.load_lm(
                get_config(CFG2, **{"decode.lm_path": rnn_lm_path}), CARD)}}


def stream_beam_parity(run: dict, whole: dict, full: tuple, fusion: dict, cfg) -> dict:
    """A beam-mode run against the same kernel over the blocks' logits,
    concatenated (each block's valid frames): the log-softmax and top-A of
    the concatenation must equal the blocks' bit for bit; the run's beams
    and LM state after its last block must equal the carried form's in one
    launch over the concatenation on every beam, and its last best beam
    (tokens, length, score) that launch's and the offline kernel's
    (``prefix_beam_search``), bit for bit; its tokens that search's, and
    something decoded.  The agreement with ``full``, the search over the
    whole utterance's logits (where the head's GEMM sums a block's rows in
    another order), is reported only."""
    searches, dec = run["searches"], cfg.decode
    check(all(bool((nv == nv[0]).all()) for _, nv, _ in searches),
          "stream beam: rows of one block have different valid frames")
    n = [int(nv[0]) for _, nv, _ in searches]
    logp = torch.cat([lp[:, :k] for (lp, _, _), k in zip(searches, n)], dim=1).contiguous()
    logits = torch.cat([lg[:, :k] for lg, k in zip(run["blocks"], n)], dim=1).contiguous()
    check(torch.equal(torch.log_softmax(logits, dim=-1), logp),
          "stream beam: the log-softmax of the blocks differs from the concatenation's")
    A = fusion["ext_top_a"]
    if A:
        parts = [prefix_beam.top_a(lp[:, :k].contiguous(), A) for (lp, _, _), k in zip(searches, n)]
        whole_top = prefix_beam.top_a(logp, A)
        check(all(torch.equal(torch.cat([p[i] for p in parts], dim=1), whole_top[i])
                  for i in (0, 1)), "stream beam: the blocks' top-A differs from the whole's")
    B, K, L = logp.shape[0], dec.beam_size, dec.max_decode_len
    lens = torch.full((B,), logp.shape[1], dtype=torch.int32, device=CARD)
    kw = {k: v for k, v in fusion.items() if k != "sos_id"}
    carry0 = (prefix_beam.rnn_lm_carry_init(kw["rnn_lm"], B, K, fusion["sos_id"])
              if "rnn_lm" in kw else None)
    width = kw["hash_lm"].order - 1 if kw.get("hash_lm") is not None else 0
    one = prefix_beam.prefix_beam_continue_best(prefix_beam.prefix_beam_init(B, K, L, CARD, width),
                                                logp, lens, lm_carry=carry0, **kw)
    state, carry = run["state"]
    for name, a, b in zip(prefix_beam.BeamState._fields, state, one[0]):
        check(torch.equal(a, b), f"stream beam: state.{name} differs from one launch's")
    if carry is not None:
        for name, a, b in zip(prefix_beam.LMCarry._fields, carry, one[1]):
            check(torch.equal(a, b), f"stream beam: lm_carry.{name} differs from one launch's")
    offline = prefix_beam.prefix_beam_search(logits, lens, beam_size=K, max_len=L,
                                             sos_id=fusion.get("sos_id", 29), **kw)
    best = searches[-1][2]
    check(all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(best, one[2], offline)),
          "stream beam: the best beam differs from the kernel's over the blocks' logits")
    want = [offline[0][b, :offline[1][b]].tolist() for b in range(B)]
    check(run["tokens"] == want, "stream beam: tokens differ from the offline kernel's")
    check(any(run["tokens"]), "stream beam: nothing decoded")
    return {"frames": logp.shape[1], "tokens": sum(map(len, run["tokens"])),
            "bit_equal": True,
            "utterance_rows_equal": sum(run["tokens"][b] == full[0][b, :full[1][b]].tolist()
                                        for b in range(B)),
            "utterance_logits_max_abs_diff": float(
                (logits - whole["ctc_logits"][:, :logits.shape[1]]).abs().max())}


def stream_beam_phase(arpa: str, rnn_lm_path: str) -> tuple[dict, dict]:
    """The beam recognizer at full width on the card: config 2's settings
    made causal (``CAUSAL``: H 512 x 4 in one direction, bf16, beam 16,
    max_len 256), seeded weights, B 8 streams of ``stream_audio`` in
    1600-sample chunks, blocks of 16 and 48 frames, five arms
    (``STREAM_BEAM_ARMS``).  Each block launches exactly one K1, four
    ``lstm_seq_stream`` and one carried search (K7, K8, or K9 on its grid)
    and nothing else, and no plain version runs; each run is held to the
    kernel over its blocks' logits (``stream_beam_parity``).  The
    host-observed latency a block (p50, p99) and the RTF at B 8, and at B 1
    in blocks of 16, and one profiled run's busy share (RNN LM, blocks of
    16, B 8).  ->
    (results, the launches of the arms' runs at blocks of 16 and B 8)."""
    cfg = get_config(CFG2, **dict(a.split("=", 1) for a in CAUSAL))
    audio = stream_audio(STREAM_B, cfg.frontend)
    model = build_model(cfg, CARD)
    with torch.inference_mode():
        whole = model(torch.from_numpy(audio).to(CARD),
                      torch.full((STREAM_B,), audio.shape[1], device=CARD))
    sources = stream_beam_sources(cfg, arpa, rnn_lm_path)
    res, path = {"streams": STREAM_B, "seconds": STREAM_SEC, "chunk": STREAM_CHUNK}, {}
    for arm, (src, A) in STREAM_BEAM_ARMS.items():
        fusion = {**sources[src], "ext_top_a": A}
        name = carried_name(src, A)
        kw = {k: v for k, v in fusion.items() if k != "sos_id"}
        full = prefix_beam.prefix_beam_search(
            whole["ctc_logits"], whole["enc_len"], beam_size=cfg.decode.beam_size,
            max_len=cfg.decode.max_decode_len, sos_id=fusion.get("sos_id", 29), **kw)
        for block in STREAM_BLOCKS:
            rec = {}
            for b in (STREAM_B, 1) if block == STREAM_BLOCKS[0] else (STREAM_B,):
                run = run_stream(model, cfg, audio[:b], block, mode="beam", **fusion)
                n = len(run["block_s"])
                want = {"stft_log_mel": n, "lstm_seq_stream": CFG2_LAYERS * n, name: n}
                check({k: v for k, v in run["launches"].items() if v} == want,
                      f"stream beam {arm} block {block} B {b}: launches {run['launches']} "
                      f"!= {want}")
                check(not run["plain_calls"],
                      f"a plain version ran on the card: {run['plain_calls']}")
                times = np.array(run["block_s"]) * 1e3
                rec[f"b{b}"] = {"p50_ms": float(np.percentile(times, 50)),
                                "p99_ms": float(np.percentile(times, 99)),
                                "rtf": float(times.sum() / 1e3 / STREAM_SEC)}
                if b == STREAM_B:
                    rec.update(blocks=n, launches=run["launches"],
                               **stream_beam_parity(run, whole, full, fusion, cfg))
                    if block == STREAM_BLOCKS[0]:
                        for k, v in run["launches"].items():
                            path[k] = path.get(k, 0) + v
            res[f"{arm}_block{block}"] = rec
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fusion = {**sources["rnn"], "ext_top_a": 0}
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_stream(model, cfg, audio, STREAM_BLOCKS[0], mode="beam", **fusion)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    device_ms = sum(r["device_ms"] for r in rows)
    check(device_ms > 0, "stream beam profile: no device time recorded")
    res["profile"] = {"arm": "rnn", "wall_ms": wall_ms, "device_ms": device_ms,
                      "busy": device_ms / wall_ms, "top": rows[:6]}
    return res, path


def carried_planted(g: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """Log-probs (8, CARRY_T, 31) on the card: normal(0, 2) logits with a
    random char path planted at +8 (decisive: K9's sums in another order
    cannot flip a pick), rows of CARRY_LENS frames."""
    logits = torch.randn(len(CARRY_LENS), CARRY_T, V, generator=g) * 2
    path = torch.randint(0, V, (len(CARRY_LENS), CARRY_T), generator=g)
    logits.scatter_add_(2, path[..., None], torch.full(path.shape + (1,), 8.0))
    return (torch.log_softmax(logits, dim=-1).to(CARD),
            torch.tensor(CARRY_LENS, dtype=torch.int32, device=CARD))


def carry_bound(K: int, C: int, A: int, B: int, L: int, frames: int, extra_bytes: int,
                lm_ops: float = 0.0, lm_state_floats: int = 0) -> tuple[float, str]:
    """``search_bound`` of one carried launch at a block: its frames' bytes
    and operations, plus the beams' state read and written (tokens (B, K, L)
    and 7 fields each way) and, for K9, each beam's LM state
    (``lm_state_floats``) each way."""
    state = 2 * 4 * (B * K * L + 7 * B * K) + 2 * 4 * lm_state_floats
    return search_bound(frames, K, C, V, A, B, L, extra_bytes + state, lm_ops)


def carried_table_bytes(state, blk: torch.Tensor, nv: torch.Tensor, fusion: dict,
                        A: int) -> int:
    """The dense table's bytes that one carried block needs: its distinct
    entries (context, char) that a live beam extends by at a valid frame
    (chars 1..V-1, or the frame's top-A but the blank), 4 bytes each, from
    the plain carried search run a frame at a time.  A block reads a few
    hundred of the table's 29,791 rows, so the whole table is no measure."""
    table, need = fusion["lm_table"], []
    for t in range(blk.shape[1]):
        f, v = blk[:, t:t + 1].contiguous(), (nv > t).to(torch.int32)
        top = prefix_beam.top_a(f, A) if A else (None, None)
        chars = top[1][:, 0] if A else torch.arange(1, V, device=CARD).expand(len(v), -1)
        live = (prefix_beam._lse(state.pb, state.pnb) > prefix_beam.NEG_INF / 2) & (v > 0)[:, None]
        ent = state.ctx.long()[..., None] * table.shape[1] + chars.long()[:, None, :]
        need.append(ent[live[..., None] & (chars != 0)[:, None, :]])
        state, _ = prefix_beam.continue_plain(state, f, v, table, fusion["lm_alpha"],
                                              fusion["lm_beta"], *top)
    return 4 * int(torch.unique(torch.cat(need)).numel())


def carried_kernels_phase(arpa: str, rnn_lm_path: str) -> list[dict]:
    """Each carried form at the stream's block shape (logp (8, 4, 31), K 16,
    L 256; config 2's fusion): over CARRY_T // CARRY_BLOCK blocks of
    planted log-probs against the plain carried search
    (``continue_plain``) on the card after every block, on the beams alive
    in the plain search (K7/K8's dead fillers may differ: their lanes
    include the blank's): K7 and K8 bit for bit, K9 (grid) with tokens,
    lengths, hashes, contexts and last chars exact and pb, pnb, lm_s and
    the LM state within RNN_RTOL / RNN_ATOL; then timed on one mid-stream
    block (the profiler's device time a launch, and a wrapper call's with
    CUDA events) beside the plain loop, K9 also on a block of no frames (its
    grid's prologue and epilogue alone).  K7's in-scratch form (``fits`` forced
    off, ``prefix_beam_carry_wide``) must give the shared form's bits and
    K9's block form (``prefix_beam_rnn_carry_block``) the grid's tokens, at
    that block."""
    cfg = get_config(CFG2, **dict(a.split("=", 1) for a in CAUSAL))
    sources = stream_beam_sources(cfg, arpa, rnn_lm_path)
    logp, lens = carried_planted(torch.Generator().manual_seed(23))
    Bc, K, L = len(CARRY_LENS), cfg.decode.beam_size, cfg.decode.max_decode_len
    rows = []
    for src, A, line in ((None, 0, 756), ("dense", BEAM_A, 1566), ("rnn", 0, 1452),
                         ("rnn", BEAM_A, 1452)):
        fusion = {k: v for k, v in sources[src].items() if k != "sos_id"}
        rnn = fusion.get("rnn_lm")
        carry = (prefix_beam.rnn_lm_carry_init(rnn, Bc, K, sources["rnn"]["sos_id"])
                 if rnn is not None else None)
        state = plain = prefix_beam.prefix_beam_init(Bc, K, L, CARD)
        plain_carry, err, mid = carry, 0.0, None
        for t0 in range(0, CARRY_T, CARRY_BLOCK):
            blk = logp[:, t0:t0 + CARRY_BLOCK].contiguous()
            nv = torch.clamp(lens - t0, 0, CARRY_BLOCK).to(torch.int32)
            if t0 == CARRY_T // 2:
                mid = (state, carry, blk, nv)
            top = prefix_beam.top_a(blk, A) if A else (None, None)
            state, carry, _ = prefix_beam.prefix_beam_continue_best(
                state, blk, nv, lm_carry=carry, ext_top_a=A, **fusion)
            with lm_steps_counted() as steps:
                plain, plain_carry = prefix_beam.continue_plain(
                    plain, blk, nv, fusion.get("lm_table"), fusion.get("lm_alpha", 0.0),
                    fusion.get("lm_beta", 0.0), *top, rnn_lm=rnn, lm_carry=plain_carry)
            if t0 == CARRY_T // 2:
                mid_steps = steps[0]
            live = prefix_beam._lse(plain.pb, plain.pnb) > prefix_beam.NEG_INF / 2
            tag = f"{carried_name(src, A)} block {t0 // CARRY_BLOCK}"
            check(torch.equal(prefix_beam._lse(state.pb, state.pnb) > prefix_beam.NEG_INF / 2,
                              live), f"{tag}: other beams alive than the plain search's")
            below = (torch.arange(L, device=CARD) < plain.length[..., None]) & live[..., None]
            check(torch.equal(torch.where(below, state.tokens, 0),
                              torch.where(below, plain.tokens, 0)), f"{tag}: tokens differ")
            for f in ("length", "hash", "ctx", "last"):
                check(torch.equal(getattr(state, f)[live], getattr(plain, f)[live]),
                      f"{tag}: {f} differs")
            pairs = [(getattr(state, f)[live], getattr(plain, f)[live]) for f in ("pb", "pnb",
                                                                               "lm_s")]
            if rnn is not None:
                pairs += [(a[:, live] if a.dim() == 4 else a[live],
                           b[:, live] if b.dim() == 4 else b[live])
                          for a, b in zip(carry, plain_carry)]
            for a, b in pairs:
                if rnn is not None:
                    torch.testing.assert_close(a, b, rtol=RNN_RTOL, atol=RNN_ATOL,
                                               msg=lambda m, tag=tag: f"{tag}: {m}")
                else:
                    check(torch.equal(a, b), f"{tag}: a score differs")
                err = max(err, float((a - b).abs().max()) if a.numel() else 0.0)
        st, cy, blk, nv = mid
        tv, ti = prefix_beam.top_a(blk, A) if A else (None, None)
        if rnn is None:
            call = lambda: beam_cuda.prefix_beam_carry(  # noqa: E731
                st, blk, nv, fusion.get("lm_table"), fusion.get("lm_alpha", 0.0),
                fusion.get("lm_beta", 0.0), tv, ti)
        else:
            call = lambda: beam_cuda.prefix_beam_rnn_carry(  # noqa: E731
                st, cy, blk, nv, rnn, fusion["lm_alpha"], fusion["lm_beta"], tv, ti)
        plain_call = lambda: prefix_beam.continue_plain(  # noqa: E731
            st, blk, nv, fusion.get("lm_table"), fusion.get("lm_alpha", 0.0),
            fusion.get("lm_beta", 0.0), tv, ti, rnn_lm=rnn, lm_carry=cy)
        C, frames = A or V, int(nv.sum())
        if rnn is None:
            extra = carried_table_bytes(st, blk, nv, fusion, A) if "lm_table" in fusion else 0
            b_ms, b_by = carry_bound(K, C, A, Bc, L, frames, extra)
        else:
            lmc = rnn.cfg
            b_ms, b_by = carry_bound(
                K, C, A, Bc, L, frames, 4 * sum(p.numel() for p in rnn.parameters()),
                mid_steps * lm_step_ops(lmc, V),
                lmc.num_layers * Bc * K * lmc.hidden_dim * 2 + Bc * K * V)
        kernel = "prefix_beam_kernel" if rnn is None else "prefix_beam_rnn_grid_kernel"
        row = {"name": carried_name(src, A), "route": "cuda",
               "source": "pytorch_asr_tpu_torch/csrc/prefix_beam.cu",
               "replaces": f"pytorch_asr_tpu/ops/beam_pallas.py:{line}",
               "shape": f"logp ({Bc}, {CARRY_BLOCK}, {V}) f32 a block, lengths {CARRY_LENS} over "
                        f"{CARRY_T // CARRY_BLOCK} blocks, K {K}, L {L}, C {C}"
                        + (", 4-gram table" if "lm_table" in fusion else "")
                        + (f", LM E {rnn.cfg.embed_dim} H {rnn.cfg.hidden_dim} x "
                           f"{rnn.cfg.num_layers}" if rnn is not None else ""),
               "max_abs_err": err,
               "tol": ({"ints": "equal", "scores_rtol": RNN_RTOL, "scores_atol": RNN_ATOL}
                       if rnn is not None else {"live beams": "bit-equal"}),
               "ms": device_ms_per_call(call, kernel, one_launch=True),
               "call_ms": time_ms(call),
               "plain_ms": time_ms(plain_call, 3, 1, 1),
               "library_ms": None, "library": "none: no PyTorch call computes a prefix beam search",
               "bound_ms": b_ms, "bound_by": b_by}
        if rnn is not None:   # the grid's per-block prologue and epilogue: a block of no frames
            idle = torch.zeros_like(nv)
            row["no_frame_ms"] = device_ms_per_call(lambda: beam_cuda.prefix_beam_rnn_carry(
                st, cy, blk, idle, rnn, fusion["lm_alpha"], fusion["lm_beta"], tv, ti), kernel,
                one_launch=True)
        if rnn is None and A == 0:   # the in-scratch form at the same block
            shared = call()
            fits = beam_cuda.fits
            beam_cuda.fits = lambda *a, **k: False
            try:
                build.reset_launches()
                wide = call()
                torch.cuda.synchronize()
                check({k: v for k, v in build.LAUNCHES.items() if v}
                      == {"prefix_beam_carry_wide": 1}, f"carried wide: {dict(build.LAUNCHES)}")
                check(all(torch.equal(a, b) for a, b in zip(wide[0], shared[0]))
                      and all(torch.equal(a, b) for a, b in zip(wide[1], shared[1])),
                      "prefix_beam_carry_wide: bits differ from the shared form's")
                row["wide_form"] = {"name": "prefix_beam_carry_wide", "bit_equal": True,
                                    "ms": device_ms_per_call(call, kernel, one_launch=True)}
            finally:
                beam_cuda.fits = fits
        if rnn is not None and A == 0:   # the block form at the same block
            grid = call()
            build.reset_launches()
            block_call = lambda: beam_cuda.rnn_carry_on_route(  # noqa: E731
                None, st, cy, blk, nv, rnn, fusion["lm_alpha"], fusion["lm_beta"])
            block = block_call()
            torch.cuda.synchronize()
            check({k: v for k, v in build.LAUNCHES.items() if v}
                  == {"prefix_beam_rnn_carry_block": 1}, f"carried block: {dict(build.LAUNCHES)}")
            check(torch.equal(block[0].tokens, grid[0].tokens)
                  and torch.equal(block[0].length, grid[0].length),
                  "prefix_beam_rnn_carry_block: tokens differ from the grid's")
            row["block_form"] = {"name": "prefix_beam_rnn_carry_block", "tokens_equal": True,
                                 "max_abs_err": float((block[2][2] - grid[2][2]).abs().max()),
                                 "ms": device_ms_per_call(block_call, "prefix_beam_kernel",
                                                          one_launch=True)}
        rows.append(row)
    return rows


def slice21_phases(arpa: str, rnn_lm_path: str) -> tuple[list[dict], dict]:
    """Slice 21's paths: the carried search's kernel rows and the beam
    recognizer.  -> (rows, {path: launches})."""
    t0 = time.perf_counter()
    rows = carried_kernels_phase(arpa, rnn_lm_path)
    for k in rows:
        print(f"check {k['name']}: max_abs_err {k['max_abs_err']:.3g} (tol {k['tol']}) "
              f"ms {k['ms']:.4f} (a call {k['call_ms']:.4f}) plain {k['plain_ms']:.4f} "
              f"library none bound {k['bound_ms']:.5f} ({k['bound_by']})"
              + (f" no frames {k['no_frame_ms']:.4f}" if "no_frame_ms" in k else "")
              + "".join(f" {f} {k[f]['name']} {k[f]['ms']:.4f} ms"
                        for f in ("wide_form", "block_form") if f in k))
    stream, launches = stream_beam_phase(arpa, rnn_lm_path)
    print("stream_beam:", json.dumps(stream))
    for arm in STREAM_BEAM_ARMS:
        for block in STREAM_BLOCKS:
            r = stream[f"{arm}_block{block}"]
            print(f"stream_beam {arm} block {block}: bit_equal {r['bit_equal']} tokens "
                  f"{r['tokens']} utterance rows equal {r['utterance_rows_equal']} "
                  + " ".join(f"B{b}: p50 {r[f'b{b}']['p50_ms']:.3f} ms p99 "
                             f"{r[f'b{b}']['p99_ms']:.3f} ms rtf {r[f'b{b}']['rtf']:.5f}"
                             for b in (1, STREAM_B) if f"b{b}" in r))
    print(f"stream_beam busy {stream['profile']['busy']:.3f}")
    print(f"slice21: {time.perf_counter() - t0:.1f} s")
    return rows, {"stream_beam": launches}


# ---------------------------------------------- slice 22: BPE and the hashed LM

BPE_BATCHES = 2              # each BPE decode arm (cut as the slice's clock asks)
HASH_T, HASH_V, HASH_A = 200, 1024, 128    # the wide case: the bench script's BPE scale
HASH_BLOCK, HASH_CARRY_T = 4, 48


def build_bpe_lm() -> tuple[str, str]:
    """Config 2's BPE path set-up, at run time into the build directory: the
    vocab by the port's ``train_bpe`` on ``synthetic_texts(512)`` (it stops
    at 78 merges, V 135), and a KN 4-gram over its pieces
    (``train_char_ngram_kn(texts, 4, tokenizer=tok)``, ``write_arpa``), as
    the JAX package's BPE end-to-end test builds its LM.  -> (vocab, arpa)."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    vocab, arpa = build.BUILD_DIR / "bpe_vocab.json", build.BUILD_DIR / "bpe4.arpa"
    train_bpe.main([str(vocab)])
    tok = bpe.BPETokenizer.load(str(vocab))
    check(tok.vocab_size == 135, f"train_bpe: V {tok.vocab_size}, not 135")
    lm_mod.write_arpa(lm_mod.train_char_ngram_kn(synthetic_texts(512), 4, tokenizer=tok),
                      str(arpa), tok)
    return str(vocab), str(arpa)


def bpe_cfg(vocab: str, arpa: str, *extra: str):
    return get_config(CFG2, **dict(a.split("=", 1) for a in (
        f"data.vocab=bpe:{vocab}", f"decode.lm_path={arpa}", *extra)))


def planted_pieces(tok, B: int, T: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Log-probs (B, T, V) on the card: normal logits with row b's synthetic
    transcript planted a piece every other frame (+6) and blanks between
    (+6), so no near-tie decides; ragged lengths, the last row empty."""
    texts = synthetic_texts(512)
    g = np.random.default_rng(seed)
    logits = g.standard_normal((B, T, tok.vocab_size)).astype(np.float32)
    for b in range(B):
        ids = np.concatenate([tok.encode(texts[(5 * b + i) % 512]) for i in range(12)])
        for t in range(T):
            logits[b, t, ids[(t // 2) % len(ids)] if t % 2 == 0 else 0] += 6.0
    lens = [T - (7 * b) % (T // 3) for b in range(B - 1)] + [0]
    return (torch.log_softmax(torch.from_numpy(logits), -1).to(CARD).contiguous(),
            torch.tensor(lens, dtype=torch.int32, device=CARD))


def planted_random(V: int, B: int, T: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Log-probs (B, T, V) on the card with a random char path planted at
    +8 (V 1024: the bench script's scale, whose synthetic LM has no
    transcripts), ragged lengths."""
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(B, T, V, generator=g) * 2
    path = torch.randint(1, V, (B, T), generator=g)
    logits.scatter_add_(2, path[..., None], torch.full(path.shape + (1,), 8.0))
    lens = torch.tensor([T - (5 * b) % (T // 4) for b in range(B)], dtype=torch.int32)
    return torch.log_softmax(logits, -1).to(CARD).contiguous(), lens.to(CARD)


def hashed_rows_read(hash_lm, state, logp, lens, lm_alpha: float, lm_beta: float,
                     A: int = 0, k: int = 0) -> tuple[int, int]:
    """The bucket rows the hashed search's data needs, from the plain search
    run a frame at a time on the card from ``state`` (its windows): at each
    valid frame, for each live
    beam and each context level its window makes valid, the backoff row of
    a context of 2+ ids and the n-gram row of each candidate the kernel
    looks up (chars 1..V-1; with ``lm_top_k`` = k the frame's top k; K8 the
    frame's top A but the blank).  -> (distinct (table, bucket) rows over the
    launch, the per-frame distinct rows summed over the frames)."""
    B, T, V = logp.shape
    K, W = state.pb.shape[1], hash_lm.order - 1
    seen, per_frame = [], 0
    for t in range(int(lens.max())):
        f = logp[:, t:t + 1].contiguous()
        v = (lens > t).to(torch.int32)
        tv, ti = prefix_beam.top_a(f, A) if A else (None, None)
        ex = prefix_beam.top_a(f, k)[1] if k else None
        live = (prefix_beam._lse(state.pb, state.pnb) > prefix_beam.NEG_INF / 2) & (v > 0)[:, None]
        if A:
            cands = ti[:, 0][:, None, :].expand(B, K, A)
        elif k:
            cands = ex[:, 0][:, None, :].expand(B, K, k)
        else:
            cands = torch.arange(1, V, device=CARD).expand(B, K, V - 1)
        keys = []
        for n in range(2, W + 2):
            valid, _, h1, h2 = lm_hashed._context_level(hash_lm, state.ctx, n)
            use = live & valid
            if n >= 3:
                tab = W + n - 3
                keys.append(tab * 2 ** 40 + (h1 & (hash_lm.backoffs[n - 3].data.shape[0] - 1))[use])
            ch1, _ = lm_hashed._fold(h1[..., None], h2[..., None], cands)
            mask = hash_lm.probs[n - 2].data.shape[0] - 1
            keys.append((n - 2) * 2 ** 40 + (ch1 & mask)[use[..., None] & (cands != 0)])
        frame = torch.unique(torch.cat(keys))
        per_frame += int(frame.numel())
        seen.append(frame)
        state, _ = prefix_beam.continue_plain(state, f, v, None, lm_alpha, lm_beta, tv, ti,
                                              hash_lm=hash_lm, exact_idx=ex)
    return int(torch.unique(torch.cat(seen)).numel()), per_frame


def hashed_bound(hash_lm, logp, lens, K, L, alpha, beta, A=0, k=0) -> tuple[float, str, dict]:
    """``search_bound`` with the LM's bytes counted as the distinct bucket
    rows the data needs over the launch (128 bytes each) plus its unigram and
    backoff rows (8 V bytes), and beside the search's own operations ~6 a
    level's lookup for each lane the kernel looks up (all C, or with
    ``lm_top_k`` the frame's top k) and 1 a level (the all-miss row's add)
    for each other lane."""
    B, T, V = logp.shape
    W = hash_lm.order - 1
    rows, per_frame = hashed_rows_read(hash_lm, prefix_beam._init_state(
        B, K, L, CARD, W), logp, lens, alpha, beta, A, k)
    frames, C = int(lens.sum()), A or V
    exact = k or C
    b_ms, b_by = search_bound(frames, K, C, V, A, B, L, 128 * rows + 8 * V,
                              frames * K * W * (6 * exact + (C - exact)))
    return b_ms, b_by, {"distinct_rows": rows, "per_frame_rows": per_frame}


def hashed_case_row(name: str, counted: str, line: int, hash_lm, logp, lens, K, L, alpha, beta,
                    A=0, k=0, shape="") -> dict:
    """One hashed form at one shape: the entry point (``prefix_beam_search``)
    and the wrapper against the plain hashed search on the card, tokens,
    lengths and scores bit for bit; the wrapper timed (CUDA events and the
    profiler's device time) beside the plain search and the bound."""
    tv, ti = prefix_beam.top_a(logp, A) if A else (None, None)
    ex = prefix_beam.top_a(logp, k)[1] if k else None
    args = (logp, lens, K, L, None, alpha, beta, tv, ti)
    build.reset_launches()
    got = beam_cuda.prefix_beam(*args, hash_lm=hash_lm, exact_idx=ex)
    torch.cuda.synchronize()
    check({n: c for n, c in build.LAUNCHES.items() if c} == {counted: 1},
          f"{name}: launches {dict(build.LAUNCHES)}")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = prefix_beam.beam_scan_plain(*args, hash_lm=hash_lm, exact_idx=ex)
    end.record()
    end.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"{name}: tokens, lengths or scores differ from the plain hashed search's")
    check(int((got[1] > 0).sum()) >= logp.shape[0] - 1, f"{name}: empty hypotheses {got[1]}")
    b_ms, b_by, rows = hashed_bound(hash_lm, logp, lens, K, L, alpha, beta, A, k)
    call = lambda: beam_cuda.prefix_beam(*args, hash_lm=hash_lm, exact_idx=ex)  # noqa: E731
    return {"name": name, "counted_as": counted, "route": "cuda",
            "source": "pytorch_asr_tpu_torch/csrc/prefix_beam.cu",
            "replaces": f"pytorch_asr_tpu/ops/beam_pallas.py:{line}",
            "shape": shape or f"logp {tuple(logp.shape)} f32, lengths {lens.tolist()}, K {K}, "
                              f"L {L}, C {A or logp.shape[-1]}",
            "max_abs_err": 0.0, "tol": {"tokens, lengths, scores": "bit-equal"},
            "ms": time_ms(call, 5, 3, 1),
            "device_ms": device_ms_per_call(call, "prefix_beam_kernel", one_launch=True),
            "plain_ms": start.elapsed_time(end),
            "library_ms": None, "library": "none: no PyTorch call computes a prefix beam search",
            "bound_ms": b_ms, "bound_by": b_by, "lm_rows": rows,
            "mean_len": float(got[1].float().mean())}


def hashed_kernels_phase(vocab: str, arpa: str) -> tuple[list[dict], dict]:
    """The hashed K7 and K8 against the plain hashed search on the card:
    at config 2's BPE path shapes (B 16, T 400, V 135, K 16, L 256; all
    pieces, and the top 8), and at the BPE scale of the bench script (V
    1024, its synthetic hashed 3-gram; T 200): K7 over all chars and with
    lm_top_k 128 (its block past shared memory: ``_wide``), K8 over the top
    128 (shared).  The V-1024 cases go through ``prefix_beam_search``, the
    entry point, counted as the path ``hashed_v1024``.  -> (rows, paths)."""
    cfg = bpe_cfg(vocab, arpa)
    tok, dec = get_tokenizer(cfg.data.vocab), cfg.decode
    hash_lm = driver.load_lm(cfg, CARD)
    check(isinstance(hash_lm, lm_hashed.HashedNgramLM), "lm_backend=auto did not pick hashed")
    logp, lens = planted_pieces(tok, BEAM_B, 400, 31)
    rows = [hashed_case_row("prefix_beam_hashed", "prefix_beam_hashed", 756, hash_lm, logp, lens,
                            BEAM_K, BEAM_L, dec.lm_alpha, dec.lm_beta),
            hashed_case_row("prefix_beam_topa_hashed", "prefix_beam_topa_hashed", 1566, hash_lm,
                            logp, lens, BEAM_K, BEAM_L, dec.lm_alpha, dec.lm_beta, A=BEAM_A)]
    check(beam_cuda.fits(BEAM_K, 135, 135, W=3) and not beam_cuda.fits(BEAM_K, HASH_V, HASH_V, W=2),
          "hashed: the shared form must take V 135 and not V 1024")
    wide_lm = bench_prefix_beam.synthetic_hashed_lm(np.random.default_rng(0), HASH_V, CARD)
    wlogp, wlens = planted_random(HASH_V, BEAM_B, HASH_T, 37)
    for name, counted, line, A, k in (
            ("prefix_beam_hashed_wide", "prefix_beam_hashed_wide", 756, 0, 0),
            ("prefix_beam_hashed_wide_lm_top_k", "prefix_beam_hashed_wide", 756, 0, HASH_A),
            ("prefix_beam_topa_hashed_v1024", "prefix_beam_topa_hashed", 1566, HASH_A, 0)):
        rows.append(hashed_case_row(name, counted, line, wide_lm, wlogp, wlens, BEAM_K, BEAM_L,
                                    0.5, 1.0, A=A, k=k))
    build.reset_launches()
    with plain_calls_of((prefix_beam, "beam_scan_plain")) as plain:
        for kw in ({}, {"lm_top_k": HASH_A}, {"ext_top_a": HASH_A}):
            prefix_beam.prefix_beam_search(wlogp, wlens, beam_size=BEAM_K, max_len=BEAM_L,
                                           hash_lm=wide_lm, lm_alpha=0.5, lm_beta=1.0, **kw)
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
    check({n: c for n, c in launches.items() if c} == {"prefix_beam_hashed_wide": 2,
                                                      "prefix_beam_topa_hashed": 1}
          and not plain, f"hashed_v1024: launches {launches}, plain calls {plain}")
    return rows, {"hashed_v1024": launches}


def bpe_decode_phase(vocab: str, arpa: str, top_a: int, dump: str) -> dict:
    """Config 2's BPE path through ``decode.main`` at full width: ``data.vocab
    =bpe:`` (V 135), the piece 4-gram (``lm_backend=auto`` picks the hashed
    tables: 135^4 floats pass the dense budget), 64 utterances of 10-16 s on
    its decode ladder, BPE_BATCHES batches: exactly 1 K1, 8 K2 and 1 hashed
    K7 (K8 with ``decode.ext_top_a``) a batch, no ``_wide`` form and no call
    of the plain search."""
    with tempfile.TemporaryDirectory() as ckpt, plain_calls_of(
            (prefix_beam, "beam_scan_plain"), (prefix_beam, "continue_plain")) as plain_calls:
        argv = [CFG2, f"data.vocab=bpe:{vocab}", f"decode.lm_path={arpa}",
                "data.synthetic_min_sec=10", "data.synthetic_max_sec=16",
                "data.synthetic_num_utts=64", f"max_batches={BPE_BATCHES}",
                f"train.checkpoint_dir={ckpt}", f"dump_path={dump}"]
        if top_a:
            argv.append(f"decode.ext_top_a={top_a}")
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        result = decode.main(argv)
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
    beam = "prefix_beam_topa_hashed" if top_a else "prefix_beam_hashed"
    want = {"stft_log_mel": BPE_BATCHES, "lstm_seq": BPE_BATCHES * CFG2_LAYERS * 2,
            beam: BPE_BATCHES}
    check({k: v for k, v in launches.items() if v} == want,
          f"bpe decode launches {launches} != {want}")
    check(not plain_calls, f"the plain search ran on the BPE serving path: {plain_calls}")
    check(result["num_utts"] > 0 and result["decode_rtf"] > 0, f"bpe decode: {result}")
    return {**result, "wall_s": wall, "batches": BPE_BATCHES, "ext_top_a": top_a,
            "launches": launches}


def bpe_learn_phase() -> dict:
    """The JAX package's BPE end-to-end test on the card: 16 utterances of 1-2
    words, a vocab of 40 merges, an order-3 LM over its pieces, the tiny
    BiLSTM (conv 4, 4, H 48 x 1) 5 + 115 steps; its loss must fall, then
    ``decode_eval`` with the hashed LM (``lm_backend=hashed``, one hashed K7
    a batch) must reach WER <= greedy + 0.3."""
    corpus = synthetic_corpus(16, 16000, seed=0, min_words=1, max_words=2)
    texts = [t for _, t in corpus]
    tok = bpe.train_bpe(texts, num_merges=40)
    vocab = build.BUILD_DIR / "bpe_e2e_vocab.json"
    arpa = build.BUILD_DIR / "bpe_e2e.arpa"
    tok.save(str(vocab))
    lm_mod.write_arpa(lm_mod.train_char_ngram(texts, order=3, tokenizer=tok), str(arpa), tok)
    cfg = dataclasses.replace(
        get_config("ctc_bilstm_dev1h"), frontend=FrontendConfig(specaugment=False),
        data=DataConfig(vocab=f"bpe:{vocab}", batch_size=4, bucket_audio_lens=(40000,),
                        bucket_label_lens=(24,)),
        model=ModelConfig(encoder=BiLSTMEncoderConfig(conv_channels=(4, 4), hidden_dim=48,
                                                      num_layers=1, dropout=0.0),
                          compute_dtype="float32"),
        train=TrainConfig(optim=OptimConfig(peak_lr=3e-3, warmup_steps=20, total_steps=300),
                          log_every=1),
        decode=DecodeConfig(method="prefix_beam", beam_size=4, lm_path=str(arpa),
                            lm_backend="hashed", lm_alpha=0.2, lm_beta=0.3, max_decode_len=32))
    data = BucketedDataset(corpus, batch_size=4, bucket_audio_lens=cfg.data.bucket_audio_lens,
                           bucket_label_lens=cfg.data.bucket_label_lens, tokenizer=tok)
    t0 = time.perf_counter()
    with Trainer(cfg, dataset=data, enable_checkpoints=False, device=CARD) as trainer:
        check(trainer.state.model.ctc_head.weight.shape[0] == tok.vocab_size > 31,
              "bpe learn: the model's head is not the BPE vocab's")
        first = trainer.train(num_steps=5)
        rest = trainer.train(num_steps=115)
        greedy = trainer.evaluate()
        build.reset_launches()
        beam = trainer.decode_eval()
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
    check(rest["ctc_loss"] < first["ctc_loss"], f"bpe learn: loss {first} -> {rest}")
    check(beam["method"] == "prefix_beam" and beam["num_utts"] == 16
          and math.isfinite(beam["wer"]) and beam["wer"] <= greedy["wer"] + 0.3
          and launches.get("prefix_beam_hashed", 0) > 0,
          f"bpe learn: hashed beam {beam} ({launches}) vs greedy {greedy}")
    return {"first_ctc_loss": first["ctc_loss"], "last_ctc_loss": rest["ctc_loss"],
            "greedy_wer": greedy["wer"], "beam_wer": beam["wer"], "V": tok.vocab_size,
            "launches": launches, "wall_s": time.perf_counter() - t0}


def bpe_sharded_phase(vocab: str, arpa: str, one_dump: str) -> dict:
    """The BPE decode across 2 ranks on the one card (gloo; model axis 2,
    ``decode.shard_beams``), the hashed LM's windows through K10's window
    form: each rank and batch 1 K1, 4 K2 and one K10 a frame, no plain
    merge or search; the hypotheses the one-rank hashed decode's."""
    with tempfile.TemporaryDirectory() as tmp:
        argv = [CFG2, f"data.vocab=bpe:{vocab}", f"decode.lm_path={arpa}",
                "data.synthetic_min_sec=10", "data.synthetic_max_sec=16",
                "data.synthetic_num_utts=64", f"max_batches={BPE_BATCHES}",
                f"train.checkpoint_dir={tmp}/none", "mesh.model_axis=2",
                "decode.shard_beams=true", f"dump_path={tmp}/sh"]
        ranks = launch.spawn(rank_decode, 2, argv, timeout=RANK_TIMEOUT)
        for r in ranks:
            want = {"stft_log_mel": BPE_BATCHES, "lstm_seq": CFG2_LAYERS * BPE_BATCHES,
                    "merge_topk": sum(r["frames"])}
            check(r["launches"] == want, f"bpe sharded rank {r['rank']}: {r['launches']}")
            check(not r["plain"], f"bpe sharded: a plain merge or search ran: {r['plain']}")
        pairs = read_dump(f"{tmp}/sh.p0")
    check(pairs == read_dump(one_dump), "bpe sharded: hypotheses differ from one rank's")
    r0 = ranks[0]
    return {"world": 2, **{k: r0["result"][k] for k in ("wer", "cer", "num_utts", "decode_rtf",
                                                         "dist_backend")},
            "launches_rank0": r0["launches"], "frames": r0["frames"],
            "search_ms_per_frame": 1e3 * r0["search_s"] / sum(r0["frames"]),
            "exchange_share_of_batches": (r0["encoder_exchange_s"] + r0["search_exchange_s"])
            / (r0["encoder_s"] + r0["search_s"])}


def merge_window_row(vocab: str, arpa: str) -> dict:
    """K10's window form at the sharded BPE shape (16 rows, Ks 16, 134
    lanes, windows of 3), on the candidates of 40 frames of the plain hashed
    search over planted pieces: every pick and field (the windows' columns
    too) equal to the plain merge's; timed (device time a launch) on the
    last frame."""
    cfg = bpe_cfg(vocab, arpa)
    tok, dec = get_tokenizer(cfg.data.vocab), cfg.decode
    hash_lm = driver.load_lm(cfg, CARD)
    logp, lens = planted_pieces(tok, BEAM_B, 40, 41)
    V = logp.shape[-1]
    state = prefix_beam._init_state(BEAM_B, BEAM_K, BEAM_L, CARD, hash_lm.order - 1)
    for t in range(logp.shape[1]):
        rows = prefix_beam.hashed_rows(hash_lm, state.ctx)
        stay, ext = prefix_beam._build_candidates(state, logp[:, t], blank=0, vocab=V,
                                                  lm_table=None, lm_rows=rows,
                                                  lm_alpha=dec.lm_alpha, lm_beta=dec.lm_beta,
                                                  K=BEAM_K, L=BEAM_L)
        stay = {n: v.contiguous() for n, v in stay.items()}
        ext = {n: v.contiguous() for n, v in ext.items()}
        score, got = beam_cuda.merge_topk(stay, ext, BEAM_K)
        want_score, want = prefix_beam._merge_topk(stay, ext, BEAM_K)
        check(torch.equal(score, want_score) and all(
            torch.equal(got[n], want[n].to(got[n].dtype)) for n in got),
            f"merge window: frame {t} differs from the plain merge")
        state = prefix_beam._finish_step(state, want, t < lens, BEAM_L)
    nb, W = V - 1, hash_lm.order - 1
    call = lambda: beam_cuda.merge_topk(stay, ext, BEAM_K)  # noqa: E731
    b_ms, b_by = merge_bound(BEAM_B, BEAM_K, nb, BEAM_K, cols=W)
    return {"name": "merge_topk_window", "counted_as": "merge_topk", "route": "cuda",
            "source": "pytorch_asr_tpu_torch/csrc/prefix_beam.cu",
            "replaces": "pytorch_asr_tpu/ops/beam_pallas.py:1026",
            "shape": f"{BEAM_B} rows, Ks {BEAM_K}, {nb} lanes, ctx windows of {W}",
            "max_abs_err": 0.0, "tol": {"every pick and field": "bit-equal"},
            "ms": time_ms(call),
            "device_ms": device_ms_per_call(call, "merge_topk_kernel", one_launch=True),
            "plain_ms": time_ms(lambda: prefix_beam._merge_topk(stay, ext, BEAM_K), 3, 1, 1),
            "library_ms": None, "library": "none: no PyTorch call does this merge",
            "bound_ms": b_ms, "bound_by": b_by}


def hashed_carried_rows(vocab: str, arpa: str) -> list[dict]:
    """The hashed carried forms at a stream block (logp (8, 4, 135), K 16, L
    256, windows of 3): over HASH_CARRY_T // HASH_BLOCK blocks of planted
    pieces against the plain carried search after every block, the live
    beams' fields (windows included) bit for bit; timed on a mid-stream
    block beside the plain loop, the bound from the rows the block needs."""
    cfg = bpe_cfg(vocab, arpa)
    tok, dec = get_tokenizer(cfg.data.vocab), cfg.decode
    hash_lm = driver.load_lm(cfg, CARD)
    logp, lens = planted_pieces(tok, len(CARRY_LENS), HASH_CARRY_T, 43)
    K, L, W = dec.beam_size, dec.max_decode_len, hash_lm.order - 1
    out = []
    for A, line in ((0, 756), (BEAM_A, 1566)):
        name = ("prefix_beam_topa" if A else "prefix_beam") + "_hashed_carry"
        state = plain = prefix_beam.prefix_beam_init(len(CARRY_LENS), K, L, CARD, ctx_width=W)
        mid = None
        for t0 in range(0, HASH_CARRY_T, HASH_BLOCK):
            blk = logp[:, t0:t0 + HASH_BLOCK].contiguous()
            nv = torch.clamp(lens - t0, 0, HASH_BLOCK).to(torch.int32)
            if t0 == HASH_CARRY_T // 2:
                mid = (state, blk, nv)
            tv, ti = prefix_beam.top_a(blk, A) if A else (None, None)
            state, _ = beam_cuda.prefix_beam_carry(state, blk, nv, None, dec.lm_alpha,
                                                   dec.lm_beta, tv, ti, hash_lm=hash_lm)
            plain, _ = prefix_beam.continue_plain(plain, blk, nv, None, dec.lm_alpha,
                                                  dec.lm_beta, tv, ti, hash_lm=hash_lm)
            live = prefix_beam._lse(plain.pb, plain.pnb) > prefix_beam.NEG_INF / 2
            for f in ("length", "pb", "pnb", "lm_s", "hash", "ctx", "last"):
                check(torch.equal(getattr(state, f)[live], getattr(plain, f)[live]),
                      f"{name} block {t0 // HASH_BLOCK}: {f} differs from the plain search")
        st, blk, nv = mid
        tv, ti = prefix_beam.top_a(blk, A) if A else (None, None)
        call = lambda: beam_cuda.prefix_beam_carry(  # noqa: E731
            st, blk, nv, None, dec.lm_alpha, dec.lm_beta, tv, ti, hash_lm=hash_lm)
        rows, _ = hashed_rows_read(hash_lm, st, blk, nv, dec.lm_alpha, dec.lm_beta, A)
        C, frames = A or tok.vocab_size, int(nv.sum())
        b_ms, b_by = carry_bound(K, C, A, len(CARRY_LENS), L, frames,
                                 128 * rows + 8 * tok.vocab_size + 2 * 4 * len(CARRY_LENS) * K * W,
                                 frames * K * W * 6 * C)
        out.append({"name": name, "route": "cuda",
                    "source": "pytorch_asr_tpu_torch/csrc/prefix_beam.cu",
                    "replaces": f"pytorch_asr_tpu/ops/beam_pallas.py:{line}",
                    "shape": f"logp ({len(CARRY_LENS)}, {HASH_BLOCK}, {tok.vocab_size}) f32 a "
                             f"block, lengths {lens.tolist()}, K {K}, L {L}, C {A or 135}, "
                             f"windows of {W}",
                    "max_abs_err": 0.0, "tol": {"live beams": "bit-equal"},
                    "ms": device_ms_per_call(call, "prefix_beam_kernel", one_launch=True),
                    "call_ms": time_ms(call),
                    "plain_ms": time_ms(lambda: prefix_beam.continue_plain(
                        st, blk, nv, None, dec.lm_alpha, dec.lm_beta, tv, ti,
                        hash_lm=hash_lm), 3, 1, 1),
                    "library_ms": None,
                    "library": "none: no PyTorch call computes a prefix beam search",
                    "bound_ms": b_ms, "bound_by": b_by, "lm_rows": rows})
    return out


def stream_hashed_phase(vocab: str, arpa: str) -> tuple[dict, dict]:
    """The beam recognizer with the hashed LM at full width: config 2 made
    causal (``CAUSAL``) with the BPE vocab, seeded weights, B 8 streams of
    ``stream_audio``, blocks of 16, all pieces and the top 8: each block 1
    K1, 4 ``lstm_seq_stream`` and one hashed carried search, no plain
    version; each run held to the kernel over its blocks' logits bit for bit
    (``stream_beam_parity``).  -> (results, launches)."""
    cfg = get_config(CFG2, **dict(a.split("=", 1) for a in (*CAUSAL, f"data.vocab=bpe:{vocab}",
                                                            f"decode.lm_path={arpa}")))
    audio = stream_audio(STREAM_B, cfg.frontend)
    model = build_model(cfg, CARD)
    with torch.inference_mode():
        whole = model(torch.from_numpy(audio).to(CARD),
                      torch.full((STREAM_B,), audio.shape[1], device=CARD))
    hash_lm = driver.load_lm(cfg, CARD)
    res, path = {}, {}
    for A in (0, BEAM_A):
        fusion = {"hash_lm": hash_lm, "lm_alpha": cfg.decode.lm_alpha,
                  "lm_beta": cfg.decode.lm_beta, "ext_top_a": A}
        full = prefix_beam.prefix_beam_search(
            whole["ctc_logits"], whole["enc_len"], beam_size=cfg.decode.beam_size,
            max_len=cfg.decode.max_decode_len, **fusion)
        run = run_stream(model, cfg, audio, STREAM_BLOCKS[0], mode="beam", **fusion)
        n = len(run["block_s"])
        name = ("prefix_beam_topa" if A else "prefix_beam") + "_hashed_carry"
        want = {"stft_log_mel": n, "lstm_seq_stream": CFG2_LAYERS * n, name: n}
        check({k: v for k, v in run["launches"].items() if v} == want,
              f"stream hashed A {A}: launches {run['launches']} != {want}")
        check(not run["plain_calls"], f"a plain version ran on the card: {run['plain_calls']}")
        times = np.array(run["block_s"]) * 1e3
        res[f"top{A}" if A else "all"] = {
            "blocks": n, "p50_ms": float(np.percentile(times, 50)),
            "p99_ms": float(np.percentile(times, 99)), "rtf": float(times.sum() / 1e3 / STREAM_SEC),
            **stream_beam_parity(run, whole, full, fusion, cfg)}
        for k, v in run["launches"].items():
            path[k] = path.get(k, 0) + v
    return res, path


def slice22_phases(arpa_char: str) -> tuple[list[dict], dict]:
    """Slice 22's paths: the BPE vocab and piece 4-gram (set-up), the hashed
    kernels' rows, config 2's BPE decode (all pieces and the top 8), its
    profile, the tiny BPE model learning and decoding with the hashed LM,
    the decode across 2 ranks (K10's window form), the hashed carried
    forms and the beam recognizer with the hashed LM.  -> (rows, {path:
    launches})."""
    t0 = time.perf_counter()
    vocab, arpa = build_bpe_lm()
    print(f"bpe lm: {time.perf_counter() - t0:.1f} s (set-up)")
    # Every profiled phase runs before the ranks' spawn (bpe_sharded_phase).
    rows, paths = hashed_kernels_phase(vocab, arpa)
    rows.append(merge_window_row(vocab, arpa))
    rows += hashed_carried_rows(vocab, arpa)
    print("bpe_profile:", json.dumps(beam_profile_phase(arpa, f"data.vocab=bpe:{vocab}")))
    with tempfile.TemporaryDirectory() as tmp:
        dec = {"bpe_decode": bpe_decode_phase(vocab, arpa, 0, f"{tmp}/one"),
               "bpe_decode_topa": bpe_decode_phase(vocab, arpa, BEAM_A, f"{tmp}/topa")}
        for path, r in dec.items():
            print(f"{path}:", json.dumps(r))
            print(f"{path}: decode_rtf {r['decode_rtf']:.5f} wer {r['wer']:.4f} "
                  f"padding_efficiency_decode {r['padding_efficiency_decode']:.4f}")
            paths[path] = r["launches"]
        stream, paths["stream_beam_hashed"] = stream_hashed_phase(vocab, arpa)
        print("stream_beam_hashed:", json.dumps(stream))
        print("bpe_learn:", json.dumps(bpe_learn_phase()))
        sharded = bpe_sharded_phase(vocab, arpa, f"{tmp}/one")
    print("bpe_sharded:", json.dumps(sharded))
    paths["bpe_sharded_model2"] = sharded["launches_rank0"]
    for k in rows:
        print(f"check {k['name']}: max_abs_err {k['max_abs_err']:.3g} (tol {k['tol']}) "
              f"ms {k['ms']:.4f} plain {k['plain_ms']:.4f} library none "
              f"bound {k['bound_ms']:.5f} ({k['bound_by']})"
              + (f" rows {k['lm_rows']}" if "lm_rows" in k else ""))
    print(f"slice22: {time.perf_counter() - t0:.1f} s")
    return rows, paths


# ---------------------------------------------------------------- slice 23
SLICE23_SPLITS = {"train-clean-100": 22, "train-clean-360": 21, "train-other-500": 21,
                  "dev-clean": 16}          # 64 training utterances of 10-16 s, 16 to evaluate
FLAC_STEPS, FLAC_EVAL_EVERY, FLAC_RESUME_TO = 20, 10, 30
JOINT_FLAC_STEPS = 4
SR = 16000
ENCODE_PROCS = 8                             # processes writing the tree (write_flac is Python)
TRAIN_PLAIN = [(stft_cuda, "stft_log_mel_plain"), (lstm_cuda, "lstm_seq_plain"),
               (lstm_cuda, "lstm_seq_train_plain"), (lstm_cuda, "lstm_seq_bwd_plain"),
               (ctc, "alphas_plain"), (ctc, "posteriors_plain")]


def flac_options(split: str, i: int) -> dict:
    """``write_flac`` keywords of file i: fixed order 2, except in
    train-clean-100 two LPC files (orders 2 and 3), a 24-bit and a stereo one."""
    if split != "train-clean-100" or i > 3:
        return {}
    return [{"subframe": "lpc", "order": 2, "lpc_coefs": [64, -32], "lpc_shift": 5},
            {"subframe": "lpc", "order": 3, "lpc_coefs": [96, -96, 32], "lpc_shift": 5},
            {"bps": 24}, {"stereo_mode": "mid_side"}][i]


def numpy_decode(path: str) -> dict:
    """One file through the numpy decoder (in a pool process): its samples
    and host seconds."""
    t0 = time.perf_counter()
    audio, sr = flac_mod.read_flac(path)
    return {"audio": audio, "sr": sr, "seconds": time.perf_counter() - t0}


def flac_tree_phase(root: str) -> dict:
    """The fixture: a LibriSpeech-layout FLAC tree written by the port's
    ``write_flac`` on a process pool (every split at once).  Every file's
    native decode equals, bit for bit, the numpy decoder's float32 of the
    PCM that was encoded (``flac.pcm_to_float``: ``read_flac``'s own
    scaling; FLAC is lossless); the numpy decoder itself runs on one file of
    each kind (the LPC, 24-bit and stereo files and one fixed-order file a
    split), every native decode of those equal to it.  Host seconds per
    audio second: native one file at a time and in its batch form on the
    stream's pool width, numpy in the pool."""
    t0 = time.perf_counter()
    check(native.available(), f"native decoder: {native.build_error()}")
    build_s = time.perf_counter() - t0
    corpora, want = {}, {}
    for k, (split, n) in enumerate(SLICE23_SPLITS.items()):
        corpus = synthetic_corpus(n, SR, seed=230 + k, min_sec=10, max_sec=16)
        if split == "train-clean-100":
            a, text = corpus[3]
            corpus[3] = (np.stack([a, 0.5 * a], axis=1), text)           # stereo
        corpora[split] = corpus
        for i, (audio, _text) in enumerate(corpus):
            bps = flac_options(split, i).get("bps", 16)
            path = os.path.join(root, split, "1", "1", f"1-1-{i:04d}.flac")
            want[path] = flac_mod.pcm_to_float(synthetic.flac_pcm(audio, bps), bps)
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(ENCODE_PROCS, mp_context=ctx) as pool:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(corpora)) as writers:
            list(writers.map(lambda item: synthetic.materialize_flac_tree(
                item[1], root, item[0], SR, flac_kw=lambda i, s=item[0]: flac_options(s, i),
                pool=pool), corpora.items()))
        encode_s = time.perf_counter() - t0
        kinds = [os.path.join(root, split, "1", "1", f"1-1-{i:04d}.flac")
                 for split, idx in (("train-clean-100", range(5)), ("train-clean-360", [0]),
                                    ("train-other-500", [0]), ("dev-clean", [0]))
                 for i in idx]
        t0 = time.perf_counter()
        by_numpy = dict(zip(kinds, pool.map(numpy_decode, kinds)))
        numpy_wall = time.perf_counter() - t0
    paths = [u.audio_path for s in SLICE23_SPLITS for u in librispeech.scan_manifest(root, s)]
    check(sorted(paths) == sorted(want), f"tree holds {len(paths)} files")
    t0 = time.perf_counter()
    got = {p: native.read_flac(p) for p in paths}
    native_serial = time.perf_counter() - t0
    bad = [p for p in paths if got[p][1] != SR or got[p][0].dtype != np.float32
           or not np.array_equal(got[p][0], want[p])]
    bad += [p for p, r in by_numpy.items() if not np.array_equal(got[p][0], r["audio"])]
    check(not bad, f"native FLAC decode differs from numpy's: {bad}")
    audio_s = sum(len(w) for w in want.values()) / SR
    width = stream_mod.decode_pool_width(0)
    t0 = time.perf_counter()
    _audio, lens, _rates = native.read_flac_batch(paths, max_seconds=20.0, n_threads=width)
    native_batch = time.perf_counter() - t0
    check([int(n) for n in lens] == [len(want[p]) for p in paths], "batch decode lengths")
    with open(os.path.join(root, "train-clean-100", "1", "1", "1-1.trans.txt")) as fh:
        first = fh.readline()
    check(first.split(" ", 1)[1].strip().isupper(), f"transcripts upper case: {first!r}")
    numpy_audio_s = sum(len(r["audio"]) for r in by_numpy.values()) / SR
    return {"files": len(paths), "audio_s": audio_s, "encode_s": encode_s,
            "encode_procs": ENCODE_PROCS, "build_s": build_s,
            "numpy_files": len(kinds), "numpy_pool_wall_s": numpy_wall,
            "python_s_per_audio_s": sum(r["seconds"] for r in by_numpy.values()) / numpy_audio_s,
            "native_s_per_audio_s": native_serial / audio_s,
            "native_batch_s_per_audio_s": native_batch / audio_s,
            "decode_pool_width": width, "cpu_count": os.cpu_count()}


def batch_digest(batch: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(batch):
        h.update(k.encode())
        h.update(np.ascontiguousarray(batch[k]).tobytes())
    return h.hexdigest()[:16]


@contextlib.contextmanager
def corpus_reads():
    """Record the audio path of every ``LazyCorpus`` access (any thread)."""
    reads, lock = [], threading.Lock()
    real = librispeech.LazyCorpus.__getitem__

    def recording(self, idx):
        with lock:
            reads.append(self.utts[int(idx)].audio_path)
        return real(self, idx)

    librispeech.LazyCorpus.__getitem__ = recording
    try:
        yield reads
    finally:
        librispeech.LazyCorpus.__getitem__ = real


@contextlib.contextmanager
def first_batches():
    """Record the digest of the first batch each ``BatchStream`` delivers."""
    firsts = []
    real = stream_mod.BatchStream.__next__

    def recording(self):
        batch = real(self)
        if not getattr(self, "_smoke_seen", False):
            self._smoke_seen = True
            firsts.append(batch_digest(batch))
        return batch

    stream_mod.BatchStream.__next__ = recording
    try:
        yield firsts
    finally:
        stream_mod.BatchStream.__next__ = real


def counted_run(fn, argv: list[str]) -> dict:
    """``fn(argv)`` with the kernel and decode counters set to 0 just before
    and read just after, every corpus read recorded, no plain version called."""
    with corpus_reads() as reads, plain_calls_of(*TRAIN_PLAIN) as plain_calls:
        torch.cuda.synchronize()
        build.reset_launches()
        native.reset_decodes()
        t0 = time.perf_counter()
        result = fn(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
        decodes = dict(native.DECODES)
    check(not plain_calls, f"{argv[0]}: a plain version ran: {plain_calls}")
    check(decodes["audio_decode_python"] == 0 and decodes["audio_decode_native"] == len(reads) > 0,
          f"{argv[0]}: decodes by route {decodes}, corpus reads {len(reads)}")
    return {"result": result, "wall_s": wall, "launches": launches, "decodes": decodes,
            "reads": list(reads)}


def split_reads(reads: list[str], split: str) -> list[str]:
    return [p for p in reads if f"{os.sep}{split}{os.sep}" in p]


def tb_events(log_dir: str) -> set:
    """(tag, step, float32 value) of every simple-value scalar under ``log_dir``."""
    from tensorboard.backend.event_processing import event_accumulator

    acc = event_accumulator.EventAccumulator(log_dir, size_guidance={"scalars": 0})
    acc.Reload()
    return {(tag, e.step, float(np.float32(e.value)))
            for tag in acc.Tags()["scalars"] for e in acc.Scalars(tag)}


def tb_want(records: list[dict]) -> set:
    """The JAX logger's mirror of JSONL records: numbers only, never
    ``step``; a record with no step one past the largest so far."""
    out, nxt = set(), 0
    for rec in records:
        fields = {k: v for k, v in rec.items() if k not in ("event", "ts")}
        step = int(fields.get("step", nxt))
        nxt = max(nxt, step) + 1
        out |= {(f"{rec['event']}/{k}", step, float(np.float32(float(v))))
                for k, v in fields.items() if isinstance(v, (int, float)) and k != "step"}
    return out


def flac_train_phase(root: str, tmp: str, synthetic_record: dict) -> dict:
    """Config 1 trained from the tree: ``train.main`` at full width in bf16 on
    train-960, eval on dev-clean every 10 steps, 20 steps, with the
    TensorBoard mirror where tensorboard imports; then resumed to step 30
    from the step-20 checkpoint (the restored stream's first batch is the
    21st of a fresh stream)."""
    dev = librispeech.scan_manifest(root, "dev-clean")
    dev_audio_s = sum(librispeech.audio_info(u.audio_path)[0] for u in dev) / SR
    try:
        import torch.utils.tensorboard  # noqa: F401
        from tensorboard.backend.event_processing import event_accumulator  # noqa: F401
        tb_dir = os.path.join(tmp, "tb")
    except ImportError as e:
        tb_dir, tb_error = None, str(e)
    ckpt, metrics = os.path.join(tmp, "ckpt"), os.path.join(tmp, "metrics.jsonl")
    argv = ["ctc_bilstm_dev1h", f"data.librispeech_root={root}", "data.split=train-960",
            "data.eval_split=dev-clean", "data.auto_buckets=1", f"steps={FLAC_STEPS}",
            f"train.eval_every={FLAC_EVAL_EVERY}", f"train.log_every={FLAC_EVAL_EVERY}",
            f"train.checkpoint_dir={ckpt}", f"metrics_path={metrics}"]
    run = counted_run(train.main, argv + ([f"tb_dir={tb_dir}"] if tb_dir else []))
    last, ev = run["result"]["train"], run["result"]["eval"]
    evals = FLAC_STEPS // FLAC_EVAL_EVERY
    eval_batches = evals * math.ceil(len(dev) / B)
    want = {"stft_log_mel": FLAC_STEPS + eval_batches, "lstm_seq": 2 * LAYERS * eval_batches,
            "lstm_seq_train_fwd": 2 * LAYERS * FLAC_STEPS, "lstm_seq_bwd": 2 * LAYERS * FLAC_STEPS,
            "ctc_alpha": FLAC_STEPS, "ctc_beta": FLAC_STEPS}
    check(run["launches"] == want, f"flac train launches {run['launches']} != {want}")
    check(last.get("step") == FLAC_STEPS and math.isfinite(last["ctc_loss"]),
          f"flac train: bad record {last}")
    dev_reads = split_reads(run["reads"], "dev-clean")
    per_eval_s = sum(librispeech.audio_info(p)[0] for p in dev_reads) / SR / evals
    check(ev.get("num_utts") == len(dev) and sorted(dev_reads)
          == sorted(u.audio_path for u in dev for _ in range(evals))
          and abs(per_eval_s - dev_audio_s) < 1e-9,
          f"flac eval: {ev}, {len(dev_reads)} dev-clean reads, {per_eval_s} s")
    train_reads = len(run["reads"]) - len(dev_reads)
    check(train_reads >= FLAC_STEPS * B, f"flac train decoded {train_reads} training files")
    with open(metrics) as fh:
        records = [json.loads(line) for line in fh]
    out = {"record": last, "eval": ev, "wall_s": run["wall_s"], "launches": run["launches"],
           "decodes": run["decodes"], "train_files_decoded": train_reads,
           "dev_clean_utts": len(dev), "dev_clean_audio_s": dev_audio_s,
           "eval_audio_s_each": per_eval_s,
           "stream_wait_s_per_step": last["stream_wait_s"] / FLAC_EVAL_EVERY,
           "synthetic_audio_seconds_per_sec_per_chip":
               synthetic_record["audio_seconds_per_sec_per_chip"]}
    if tb_dir:
        got, want_tb = tb_events(tb_dir), tb_want(records)
        check(got == want_tb and len(got) > 0,
              f"tensorboard events differ from the JSONL records: {got ^ want_tb}")
        out["tensorboard"] = {"imports": True, "scalars": len(got)}
    else:
        try:
            MetricsLogger(tensorboard_dir=os.path.join(tmp, "tb_refused"))
            check(False, "tb_dir was not refused without tensorboard")
        except ImportError as e:
            check("'tensorboard' package" in str(e), f"tb_dir refusal: {e}")
            out["tensorboard"] = {"imports": False, "import_error": tb_error,
                                  "refusal": str(e)}
    # Resume: the checkpoint's stream position against a fresh stream.
    cfg = train.parse_args(argv)[0]
    state = CheckpointManager(cfg, ckpt).restore_iterator_state()
    ds = build_dataset(cfg.data, SR)
    fresh = stream_mod.BatchStream(ds, cfg.data.shuffle_seed, cfg.data.sortagrad)
    want_digest = [batch_digest(next(fresh)) for _ in range(FLAC_STEPS + 1)][-1]
    restored = stream_mod.BatchStream(ds, cfg.data.shuffle_seed, cfg.data.sortagrad, state)
    check(batch_digest(next(restored)) == want_digest,
          f"restored stream at {state}: its next batch is not a fresh stream's 21st")
    with first_batches() as firsts:
        resumed = counted_run(train.main, [*argv, f"steps={FLAC_RESUME_TO}"])
    check(firsts[:1] == [want_digest], f"the resumed run's first batch {firsts} != {want_digest}")
    steps = FLAC_RESUME_TO - FLAC_STEPS
    rwant = {"stft_log_mel": steps + eval_batches // evals,
             "lstm_seq": 2 * LAYERS * eval_batches // evals,
             "lstm_seq_train_fwd": 2 * LAYERS * steps, "lstm_seq_bwd": 2 * LAYERS * steps,
             "ctc_alpha": steps, "ctc_beta": steps}
    check(resumed["launches"] == rwant, f"resumed launches {resumed['launches']} != {rwant}")
    check(resumed["result"]["train"].get("step") == FLAC_RESUME_TO, f"resume: {resumed['result']}")
    out["resume"] = {"iterator_state": state, "first_batch_digest": want_digest,
                     "record": resumed["result"]["train"], "launches": resumed["launches"],
                     "decodes": resumed["decodes"]}
    return out


def flac_joint_phase(root: str, tmp: str) -> dict:
    """Config 5 on the tree: its own splits (train-960, eval on dev-clean),
    its 6-bucket ladder from the headers, 4 steps of ``train.main``."""
    argv = ["joint_ctc_attention_960h", f"data.librispeech_root={root}",
            f"steps={JOINT_FLAC_STEPS}", f"train.log_every={JOINT_FLAC_STEPS}",
            f"train.checkpoint_dir={os.path.join(tmp, 'joint')}"]
    cfg = train.parse_args(argv)[0]
    check(cfg.data.split == "train-960" and cfg.data.eval_split == "dev-clean"
          and cfg.data.auto_buckets == 6, f"config 5 data: {cfg.data}")
    native.reset_decodes()
    ladder = build_dataset(cfg.data, SR).buckets
    eval_batches = len(build_eval_dataset(cfg.data, SR).epoch_plan(0))
    check(sum(native.DECODES.values()) == 0, "the ladder from headers decoded audio")
    run = counted_run(train.main, argv)
    layers = cfg.model.encoder.num_layers
    want = {"stft_log_mel": JOINT_FLAC_STEPS + eval_batches, "lstm_seq": 2 * layers * eval_batches,
            "lstm_seq_train_fwd": 2 * layers * JOINT_FLAC_STEPS,
            "lstm_seq_bwd": 2 * layers * JOINT_FLAC_STEPS,
            "ctc_alpha": JOINT_FLAC_STEPS, "ctc_beta": JOINT_FLAC_STEPS}
    check(run["launches"] == want, f"config 5 flac launches {run['launches']} != {want}")
    last, ev = run["result"]["train"], run["result"]["eval"]
    check(last.get("step") == JOINT_FLAC_STEPS and math.isfinite(last["ce_loss"])
          and math.isfinite(last["ctc_loss"]), f"config 5 flac: bad record {last}")
    check(ev.get("num_utts") == SLICE23_SPLITS["dev-clean"], f"config 5 flac eval: {ev}")
    return {"record": last, "eval": ev, "wall_s": run["wall_s"], "launches": run["launches"],
            "decodes": run["decodes"], "eval_batches": eval_batches,
            "ladder": [[b.audio_len, b.label_len] for b in ladder]}


def flac_serve_phase(root: str, tmp: str) -> dict:
    """``decode.main`` and ``align.main`` of config 1 with the tree and
    ``data.eval_split=dev-clean``, from the trained checkpoint: both read
    dev-clean's utterances, each once, natively."""
    dev = sorted(u.audio_path for u in librispeech.scan_manifest(root, "dev-clean"))
    argv = ["ctc_bilstm_dev1h", f"data.librispeech_root={root}", "data.eval_split=dev-clean",
            f"train.checkpoint_dir={os.path.join(tmp, 'ckpt')}"]
    batches = len(build_eval_dataset(train.parse_args(argv)[0].data, SR).epoch_plan(0))
    out = {}
    for name, fn, extra in (("decode", decode.main, []),
                            ("align", align.main, [f"dump_path={os.path.join(tmp, 'segs.tsv')}"])):
        run = counted_run(fn, argv + extra)
        res = run["result"]
        want = {"stft_log_mel": batches, "lstm_seq": 2 * LAYERS * batches}
        check(run["launches"] == want, f"flac {name} launches {run['launches']} != {want}")
        check(sorted(run["reads"]) == dev, f"flac {name} read {len(run['reads'])} files")
        check(res.get("num_utts", res.get("utts")) == len(dev), f"flac {name}: {res}")
        out[name] = {"result": res, "wall_s": run["wall_s"], "launches": run["launches"],
                     "decodes": run["decodes"], "batches": batches}
    check(out["decode"]["result"].get("step") == FLAC_RESUME_TO,
          f"flac decode restored {out['decode']['result']}")
    return out


def remat_phase(config: str, counted: str, per_step: int) -> dict:
    """One float32 train step at full width, dropout 0.1, one batch of 8
    utterances of 14-16 s, with ``train.remat_encoder`` off and on, cuDNN
    deterministic in both arms: the same loss, gradients, parameters after
    the update and generator state, bit for bit; ``counted`` (the encoder
    unit's training forward) launched ``per_step`` times off and twice that
    on; the peak memory of each arm."""
    over = {"model.compute_dtype": "float32", "model.encoder.dropout": "0.1",
            "data.synthetic_num_utts": str(B), "data.batch_size": str(B),
            "data.auto_buckets": "1", "data.synthetic_min_sec": "14",
            "data.synthetic_max_sec": "16"}
    cfg0 = get_config(config, **over)
    batch = next(build_dataset(cfg0.data, SR).epoch_batches(seed=0))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    arms = {}
    try:
        for remat in (False, True):
            cfg = get_config(config, **{**over, "train.remat_encoder": str(remat).lower()})
            model = train_state.build_model(cfg, CARD)
            st = train_state.init_train_state(cfg, model)
            dev_batch = train_state.batch_to_device(batch, CARD)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            build.reset_launches()
            aux = train_state.train_step(cfg, st, dev_batch)
            torch.cuda.synchronize()
            arms[remat] = {"loss": aux["loss"].cpu(), "peak": torch.cuda.max_memory_allocated(),
                           "base": base, "launches": {k: v for k, v in build.LAUNCHES.items() if v},
                           "grads": {k: p.grad.cpu() for k, p in model.named_parameters()
                                     if p.grad is not None},
                           "params": {k: v.cpu() for k, v in model.state_dict().items()},
                           "generator": st.generator.get_state()}
            del model, st, dev_batch, aux
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    off, on = arms[False], arms[True]
    check(off["launches"].get(counted) == per_step and on["launches"].get(counted) == 2 * per_step,
          f"{config} remat: {counted} off {off['launches']} on {on['launches']}")
    check(torch.equal(off["loss"], on["loss"]) and math.isfinite(float(off["loss"])),
          f"{config} remat loss {float(on['loss'])} vs {float(off['loss'])}")
    differ = [k for k, g in off["grads"].items() if not torch.equal(on["grads"].get(k), g)]
    differ += [k for k, v in off["params"].items() if not torch.equal(on["params"][k], v)]
    check(off["grads"].keys() == on["grads"].keys() and not differ,
          f"{config} remat: gradients or parameters differ: {differ}")
    check(torch.equal(off["generator"], on["generator"]), f"{config} remat: generator state")
    return {"loss": float(off["loss"]), "bit_equal": True, "cudnn_deterministic": True,
            f"{counted}_off": off["launches"][counted], f"{counted}_on": on["launches"][counted],
            "launches_off": off["launches"], "launches_on": on["launches"],
            "max_memory_allocated_off": off["peak"], "max_memory_allocated_on": on["peak"],
            "step_memory_off": off["peak"] - off["base"], "step_memory_on": on["peak"] - on["base"],
            "audio_len": batch["audio_len"].tolist()}


def slice23_phases(synthetic_record: dict) -> dict:
    """Slice 23's paths: the FLAC tree and both decoders, config 1 trained
    from it (with the eval on dev-clean, the TensorBoard mirror and the
    resume), config 5's 4 steps, the decode and align CLIs on dev-clean, and
    remat at configs 1 and 3.  -> {path: launches}."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "LibriSpeech")
        tree = flac_tree_phase(root)
        print("flac_tree:", json.dumps(tree))
        print(f"flac_tree: {tree['files']} files, {tree['audio_s']:.1f} audio s, written in "
              f"{tree['encode_s']:.1f} s on {ENCODE_PROCS} processes; host s per audio s: "
              f"native {tree['native_s_per_audio_s']:.6f} (batch form on {tree['decode_pool_width']}"
              f" threads {tree['native_batch_s_per_audio_s']:.6f}), numpy "
              f"{tree['python_s_per_audio_s']:.4f} ({tree['numpy_files']} files in the pool); "
              f"decode pool width {tree['decode_pool_width']}")
        trn = flac_train_phase(root, tmp, synthetic_record)
        print("flac_train:", json.dumps(trn))
        print(f"flac_train: audio_seconds_per_sec_per_chip "
              f"{trn['record']['audio_seconds_per_sec_per_chip']:.2f} (in-memory synthetic "
              f"{trn['synthetic_audio_seconds_per_sec_per_chip']:.2f} in this run), stream wait "
              f"{trn['stream_wait_s_per_step'] * 1e3:.3f} ms a step, decodes {trn['decodes']}, "
              f"tensorboard {trn['tensorboard']}")
        joint = flac_joint_phase(root, tmp)
        print("flac_joint_train:", json.dumps(joint))
        serve = flac_serve_phase(root, tmp)
        print("flac_serve:", json.dumps(serve))
    remat = {"bilstm": remat_phase("ctc_bilstm_dev1h", "lstm_seq_train_fwd", 2 * LAYERS),
             "tcn": remat_phase(CFG3, "tcn_block_train_fwd", TCN_BLOCKS)}
    print("remat:", json.dumps(remat))
    for name, r in remat.items():
        print(f"remat {name}: bit_equal {r['bit_equal']}, max_memory_allocated "
              f"{r['max_memory_allocated_off'] / 2**20:.1f} MiB off, "
              f"{r['max_memory_allocated_on'] / 2**20:.1f} MiB on")
    print(f"slice23: {time.perf_counter() - t0:.1f} s")
    return {"flac_train": trn["launches"], "flac_resume": trn["resume"]["launches"],
            "flac_joint_train": joint["launches"], "flac_decode": serve["decode"]["launches"],
            "flac_align": serve["align"]["launches"], "remat_bilstm": remat["bilstm"]["launches_on"],
            "remat_tcn": remat["tcn"]["launches_on"]}


# Slice 24: training across ranks.  K6 at a model rank's split width (the
# GLU half-width Cm of config 3's block split over m = 2 and 4 model ranks),
# and the square K6's bits against its parent's: the digests of K5 and the
# K6 pair at tcn_phase's T' 400, d 1 inputs (seed 11), taken with the
# source before the split width existed.
S24_CMS = (192, 96)
S24_DILATIONS = (1, 16)
SQUARE_K6_DIGESTS = {"k5": "b124b74bf0ecfc5a", "k5_bf16": "83ab91fae9377eee",
                     "y": "4f7a908044fd43a0", "xn": "4cef2af77ec100ba",
                     "dxn": "f27c1a3b9ac517b3", "dwc": "15c7e0d855df9fdb",
                     "dbc": "3664d71228f2cbaa", "dwp": "6fe27de78c437a56",
                     "dbp": "29c32263fd09fb73"}
# The train-step arms: path -> (config, world, data axis, model axis, global batch).
S24_ARMS = {"s24_data2": ("ctc_bilstm_dev1h", 2, 2, 1, B),
            "s24_model2": ("ctc_bilstm_dev1h", 2, 1, 2, B),
            "s24_tcn_model2": (CFG3, 2, 1, 2, TCN_B),
            "s24_data2_model2": (CFG3, 4, 2, 2, TCN_B)}
S24_PLAIN = TRAIN_PLAIN + [(tcn_cuda, "tcn_block_train_fwd_plain"),
                           (tcn_cuda, "tcn_block_bwd_plain")]
S24_MAIN_STEPS = (10, 12)    # train.main across 2 ranks: 10 steps, then resumed to 12
# A rank's reduced gradients (and grad_norm) against the one-rank step's,
# relative to each tensor's largest entry: a data rank's kernels and cuBLAS
# products run at B / D rows, and a model rank's K6 at width C / m, other
# shapes whose sums go in other orders; the recurrences carry those
# differences over 400 steps (the worst, layer 1's forward wih, read 3.1e-4
# at data 2 on an H100 80GB HBM3 at 700 W, against 1e-5-5e-5 elsewhere), and the conv front
# end's gradient sums them over every frame with cancellation (config 3's
# stem read 5.9e-3 at model 2, above STEP_CONV_GRAD_TOL's 5e-3 for card vs
# CPU).
S24_GRAD_TOL = 1e-3
S24_CONV_GRAD_TOL = 1e-2


def split_weights(p: list[torch.Tensor], k: int, m: int) -> list[torch.Tensor]:
    """Model rank k's block weights of m, as ``TCNBlock._split`` takes them."""
    C = p[0].shape[0]
    cm = C // m
    lin, gate = slice(k * cm, (k + 1) * cm), slice(C + k * cm, C + (k + 1) * cm)
    return [p[0], p[1], torch.cat([p[2][:, :, lin], p[2][:, :, gate]], 2).contiguous(),
            torch.cat([p[3][lin], p[3][gate]]).contiguous(), p[4][lin].contiguous(), p[5] / m]


def k6_split_phase() -> list[dict]:
    """K6 at Cm 192 and 96 (model rank 0 of 2 and of 4) on x (16, 400, 384),
    K 5, d 1 and 16, forward and backward against their plain versions at
    K6's tolerance, timed beside the plain versions and the 3-call
    composite at the same width; and the square K5 and K6 pair bit-equal to
    their parent's (``SQUARE_K6_DIGESTS``)."""
    g = torch.Generator().manual_seed(11)
    p = tcn_weights(g)
    B_, C, K, T = TCN_B, TCN_C, TCN_K, TCN_T
    lengths = torch.linspace(T, 0.625 * T, B_).int()
    x = torch.randn(B_, T, C, generator=g)
    x = torch.where(torch.arange(T)[None, :, None] < lengths[:, None, None], x, 0.0).cuda()
    dy = torch.randn(B_, T, C, generator=g).cuda()
    y, xn = tcn_cuda.tcn_block_train_fwd(x, *p, 1)
    got = {"k5": tcn_cuda.tcn_block(x, *p, 1), "k5_bf16": tcn_cuda.tcn_block(x.bfloat16(), *p, 1),
           "y": y, "xn": xn, **dict(zip(("dxn", "dwc", "dbc", "dwp", "dbp"),
                                        tcn_cuda.tcn_block_bwd(xn, dy, p[2], p[3], p[4], 1)))}
    digests = {k: bench_kernel_turns._digest(v) for k, v in got.items()}
    check(digests == SQUARE_K6_DIGESTS, f"square K5/K6 bits moved: {digests}")
    rows = {"tcn_block_train_fwd_split": {"max_abs_err": 0.0, "max_rel_err": 0.0, "cases": []},
            "tcn_block_bwd_split": {"max_abs_err": 0.0, "max_rel_err": 0.0, "cases": []}}
    outs = {"tcn_block_train_fwd_split": ("y", "xn"),
            "tcn_block_bwd_split": ("dxn", "dwc", "dbc", "dwp", "dbp")}
    BT = B_ * T
    for cm in S24_CMS:
        m = C // cm
        pl = split_weights(p, 0, m)
        for d in S24_DILATIONS:
            y, xn = tcn_cuda.tcn_block_train_fwd(x, *pl, d)
            grads = tcn_cuda.tcn_block_bwd(xn, dy, pl[2], pl[3], pl[4], d)
            want_y, want_xn = tcn_cuda.tcn_block_train_fwd_plain(x, *pl, d)
            want = {"y": want_y, "xn": want_xn, **dict(zip(outs["tcn_block_bwd_split"],
                    tcn_cuda.tcn_block_bwd_plain(want_xn, dy, pl[2], pl[3], pl[4], d)))}
            have = {"y": y, "xn": xn, **dict(zip(outs["tcn_block_bwd_split"], grads))}
            for name, keys in outs.items():
                case = {"Cm": cm, "dilation": d}
                for o in keys:
                    check(have[o].shape == want[o].shape and bool(torch.isfinite(have[o]).all()),
                          f"{name} {o} Cm {cm}: bad output")
                    err, rel = errors(have[o], want[o])
                    check(rel <= TCN_TOL, f"{name} {o} Cm {cm} d {d}: {rel} > {TCN_TOL}")
                    r = rows[name]
                    r["max_abs_err"], r["max_rel_err"] = (max(r["max_abs_err"], err),
                                                          max(r["max_rel_err"], rel))
                    case[o] = rel
                rows[name]["cases"].append(case)
        body, _, (wc_l, wp_l) = tcn_composite(pl, 1)
        leaves = [t.detach().clone().requires_grad_(True) for t in (xn, wc_l, pl[3], wp_l, pl[5])]
        lib_out = body(*leaves)
        lib_err, _ = errors(body(xn, wc_l, pl[3], wp_l, pl[5]),
                            tcn_cuda.tcn_block_train_fwd_plain(x, *pl, 1)[0])
        check(lib_err <= 1e-3, f"split composite computes another function: {lib_err}")
        P = 4 * (2 * C + K * C * 2 * cm + 2 * cm + cm * C + C)
        ops = {"tcn_block_train_fwd_split": 2 * BT * C * (K * 2 * cm + cm),
               "tcn_block_bwd_split": 2 * BT * C * cm * (6 * K + 2)}
        nbytes = {"tcn_block_train_fwd_split": 4 * BT * C * 3 + P,
                  "tcn_block_bwd_split": 4 * BT * C * 3 + 2 * P}
        timed = {"tcn_block_train_fwd_split": (
                     lambda: tcn_cuda.tcn_block_train_fwd(x, *pl, 1),
                     lambda: tcn_cuda.tcn_block_train_fwd_plain(x, *pl, 1),
                     lambda: body(F.layer_norm(x, (C,), pl[0], pl[1], eps=tcn_cuda.EPS))),
                 "tcn_block_bwd_split": (
                     lambda: tcn_cuda.tcn_block_bwd(xn, dy, pl[2], pl[3], pl[4], 1),
                     lambda: tcn_cuda.tcn_block_bwd_plain(xn, dy, pl[2], pl[3], pl[4], 1),
                     lambda: torch.autograd.grad(lib_out, leaves, dy, retain_graph=True))}
        for name, (kern, plain, lib) in timed.items():
            b_ms, b_by = bound(nbytes[name], 3 * ops[name] / PEAK_TF32_S)
            rows[name][cm] = {"ms": time_ms(kern), "plain_ms": time_ms(plain, 5, 4, 1),
                              "library_ms": time_ms(lib, 5, 4, 1), "bound_ms": b_ms,
                              "bound_by": b_by,
                              "bound_fp32_ms": bound(nbytes[name], ops[name] / PEAK_FP32_S)[0]}
    lines = {"tcn_block_train_fwd_split": 302, "tcn_block_bwd_split": 321}
    out = []
    for name, r in rows.items():
        head = r[S24_CMS[0]]
        out.append({
            "name": name, "route": "cuda", "source": "pytorch_asr_tpu_torch/csrc/tcn_block.cu",
            "replaces": f"pytorch_asr_tpu/ops/dilated_conv_pallas.py:{lines[name]}",
            "shape": f"x ({TCN_B}, {T}, {C}) f32, Cm {S24_CMS[0]} (also {S24_CMS[1]}): w_conv "
                     f"({K}, {C}, {2 * S24_CMS[0]}), w_point ({S24_CMS[0]}, {C}), "
                     f"d {list(S24_DILATIONS)}",
            "max_abs_err": r["max_abs_err"], "max_rel_err": r["max_rel_err"],
            "tol": {"max_rel_err": TCN_TOL}, **head,
            "library": "3-call composite F.conv1d -> F.glu -> F.linear at the split width "
                       "(fp32; the backward through autograd.grad)",
            "bound_note": "bound_ms: 3xTF32 on tensor cores (3 x ops / 495 TFLOP/s); "
                          "bound_fp32_ms: ops / 67 TFLOP/s",
            "by_cm": {cm: r[cm] for cm in S24_CMS}, "cases": r["cases"],
            "square_digests": digests})
    return out


def s24_cfg(config: str, batch: int, data: int = 1, model: int = 1):
    """A train-step arm's config: float32, dropout 0, SpecAugment off,
    ``batch`` utterances of 10-16 s in one bucket, on a data x model mesh."""
    return get_config(config, **{
        "model.compute_dtype": "float32", "model.encoder.dropout": "0.0",
        "frontend.specaugment": "false", "data.synthetic_num_utts": str(batch),
        "data.batch_size": str(batch), "data.synthetic_min_sec": "10",
        "data.synthetic_max_sec": "16", "data.auto_buckets": "1",
        "train.optim.peak_lr": "1e-3", "train.optim.warmup_steps": "1",
        "mesh.data_axis": str(data), "mesh.model_axis": str(model)})


def s24_batch(config: str, batch: int) -> dict:
    """The global batch, with a pad row in the last data rank's half."""
    cfg = s24_cfg(config, batch)
    b = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    b["audio_len"][batch - 2] = b["token_len"][batch - 2] = 0
    b["audio"][batch - 2] = 0.0
    b["tokens"][batch - 2] = 0
    return b


def s24_step(cfg, batch: dict, mesh) -> dict:
    """One train step of this rank's rows on the card with float32 LSTM
    residuals, its launches and plain calls, the gradients the optimizer saw."""
    model = set_residual_dtype(train_state.build_model(cfg, resolve_device("cuda")),
                               torch.float32)
    st = train_state.init_train_state(cfg, model, mesh)
    seen, reduce = {}, train_state.reduce_gradients

    def spy(state, grads, aux):
        seen["grads"] = reduce(state, grads, aux)
        return seen["grads"]

    rows = shard_batch_global(mesh, batch) if mesh is not None else batch
    train_state.reduce_gradients = spy
    try:
        with plain_calls_of(*S24_PLAIN) as plain, use_mesh(mesh):
            torch.cuda.synchronize()
            build.reset_launches()
            aux = train_state.train_step(cfg, st, train_state.batch_to_device(rows, CARD))
            torch.cuda.synchronize()
            launches = {k: v for k, v in build.LAUNCHES.items() if v}
    finally:
        train_state.reduce_gradients = reduce
    names = [n for n, _ in model.named_parameters()]
    grads = seen.get("grads") or [p.grad for p in model.parameters()]
    return {"loss": float(aux["loss"]), "grad_norm": float(aux["grad_norm"]), "lr": aux["lr"],
            "grads": {n: g.detach().cpu() for n, g in zip(names, grads)},
            "params": {k: v.detach().cpu() for k, v in model.state_dict().items()},
            "launches": launches, "plain": list(plain), "exchange_s": st.exchange_s}


def s24_rank_steps(inputs: dict) -> dict:
    """One rank of the train-step arms of a world, one after another (one
    spawn a world): {path: ``s24_rank_step``}."""
    distributed.initialize("cuda")
    return {path: s24_rank_step(path, batch, ref_path)
            for path, (batch, ref_path) in inputs.items()}


def s24_rank_step(path: str, batch: dict, ref_path: str) -> dict:
    """One rank of a train-step arm: its step, held to the one-rank step on
    the global batch (``ref_path``) as ``train_step_phase`` holds the card
    to the CPU; its parameters' digest."""
    config, _, data, model, b = S24_ARMS[path]
    cfg = s24_cfg(config, b, data, model)
    mesh = make_mesh(cfg.mesh, batch_size=cfg.data.batch_size)
    got = s24_step(cfg, batch, mesh)
    ref = torch.load(ref_path, weights_only=True)
    front = "encoder.conv." if config != CFG3 else "encoder.stem."
    grad_rel = {k: errors(g, ref["grads"][k])[1] for k, g in got["grads"].items()}
    tol = lambda k: S24_CONV_GRAD_TOL if k.startswith(front) else S24_GRAD_TOL  # noqa: E731
    worst = max(grad_rel.items(), key=lambda kv: kv[1] / tol(kv[0]))
    return {"rank": distributed.topology()["rank"], "place": [mesh.data_index, mesh.model_index],
            "loss": got["loss"], "grad_norm": got["grad_norm"], "launches": got["launches"],
            "plain": got["plain"], "exchange_s": got["exchange_s"],
            "loss_rel": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
            "grad_norm_rel": abs(got["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"],
            "grad_ok": all(v <= tol(k) for k, v in grad_rel.items()),
            "worst_grad": list(worst),
            "param_max_abs_err": max(errors(v, ref["params"][k])[0]
                                     for k, v in got["params"].items()),
            # AdamW's first move is about lr * sign(g) a coordinate, so a
            # gradient at float32 noise may move the two runs lr apart each
            # way; the 0.5% covers the moves' rounding and the decay term.
            "param_tol": 2.01 * got["lr"],
            "params_digest": bench_kernel_turns._digest(*got["params"].values())}


def s24_want(config: str, model: int) -> dict:
    """A rank's exact launches in one train step of an arm."""
    if config == CFG3:
        blocks = ("tcn_block_train_fwd_split", "tcn_block_bwd_split") if model > 1 else (
            "tcn_block_train_fwd", "tcn_block_bwd")
        return {"stft_log_mel": 1, blocks[0]: TCN_BLOCKS, blocks[1]: TCN_BLOCKS,
                "ctc_alpha": 1, "ctc_beta": 1}
    dirs = 1 if model == 2 else 2
    return {"stft_log_mel": 1, "lstm_seq_train_fwd": dirs * LAYERS,
            "lstm_seq_bwd": dirs * LAYERS, "ctc_alpha": 1, "ctc_beta": 1}


def train_ranks_phase() -> dict:
    """The arms' ranks spawned on the card over gloo (one spawn a world, its
    arms in turn), one float32 train step on the global batch each, against
    the one-rank step in this process: loss, grad_norm, the reduced
    gradients and the parameters after one AdamW step; every rank's exact
    launches, no plain version; every rank's parameters bit-equal."""
    out, refs, runs = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for config, _, _, _, b in S24_ARMS.values():
            if (config, b) not in refs:
                batch = s24_batch(config, b)
                one = s24_step(s24_cfg(config, b), batch, None)
                check(one["launches"] == s24_want(config, 1) and not one["plain"],
                      f"{config} one-rank step: launches {one['launches']}, plain {one['plain']}")
                ref_path = os.path.join(tmp, f"{config}.pt")
                torch.save({k: one[k] for k in ("loss", "grad_norm", "grads", "params")}, ref_path)
                refs[(config, b)] = (batch, ref_path, one)
        for world in sorted({arm[1] for arm in S24_ARMS.values()}):
            inputs = {path: refs[(arm[0], arm[4])][:2] for path, arm in S24_ARMS.items()
                      if arm[1] == world}
            t0 = time.perf_counter()
            ranks = launch.spawn(s24_rank_steps, world, inputs, timeout=RANK_TIMEOUT)
            runs[world] = (ranks, time.perf_counter() - t0)
        for path, (config, world, data, model, b) in S24_ARMS.items():
            one = refs[(config, b)][2]
            ranks, wall = [r[path] for r in runs[world][0]], runs[world][1]
            want = s24_want(config, model)
            print(f"{path} ranks:", json.dumps([{k: r[k] for k in (
                "place", "loss_rel", "grad_norm_rel", "worst_grad", "param_max_abs_err",
                "exchange_s", "params_digest")} for r in ranks]), flush=True)
            for r in ranks:
                check(r["launches"] == want, f"{path} rank {r['rank']}: {r['launches']} != {want}")
                check(not r["plain"], f"{path} rank {r['rank']}: plain calls {r['plain']}")
                check(r["loss_rel"] <= STEP_LOSS_RTOL and r["grad_norm_rel"] <= S24_GRAD_TOL
                      and r["grad_ok"] and r["param_max_abs_err"] <= r["param_tol"],
                      f"{path} rank {r['rank']} against one rank: {r}")
            digests = {r["params_digest"] for r in ranks}
            check(len(digests) == 1, f"{path}: ranks' parameters differ: {digests}")
            out[path] = {"config": config, "world": world, "mesh": [data, model],
                         "global_batch": b, "spawn_wall_s": wall, "one_rank_loss": one["loss"],
                         "one_rank_grad_norm": one["grad_norm"],
                         "ranks": ranks, "launches_rank0": ranks[0]["launches"]}
    return out


def s24_rank_main(argv: list[str]) -> dict:
    """One rank of ``train.main`` across ranks, counted."""
    with plain_calls_of(*S24_PLAIN) as plain:
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        result = train.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
    return {"rank": distributed.topology()["rank"], "result": result, "wall_s": wall,
            "launches": launches, "plain": list(plain)}


def train_main_ranks_phase() -> dict:
    """``train.main`` at config 1's defaults (bf16, dropout and SpecAugment
    on) across 2 data ranks on the card: 10 steps and an eval of 8 batches,
    then a resume to 12 and another eval; the mesh record and metrics from
    rank 0 alone, the per-chip throughput, the gradient exchange's share of
    the steps (host clock, synchronised), each data rank's stream position."""
    first, total = S24_MAIN_STEPS
    with tempfile.TemporaryDirectory() as ckpt:
        metrics = os.path.join(ckpt, "m.jsonl")
        argv = ["ctc_bilstm_dev1h", "data.synthetic_min_sec=10", "data.synthetic_max_sec=16",
                f"data.synthetic_num_utts={TRAIN_UTTS}", "data.auto_buckets=1",
                "mesh.data_axis=2", f"train.eval_every={first}", "train.log_every=2",
                f"train.checkpoint_dir={ckpt}", f"metrics_path={metrics}"]
        runs = {}
        for tag, steps in (("train", first), ("resume", total)):
            ranks = launch.spawn(s24_rank_main, 2, argv + [f"steps={steps}"],
                                 timeout=RANK_TIMEOUT)
            runs[tag] = ranks
        with open(metrics) as fh:
            records = [json.loads(line) for line in fh]
        positions = {}
        for step in (first, total):
            with open(os.path.join(ckpt, f"iterator_{step}.json")) as fh:
                positions[step] = json.load(fh)
    per_rank = EVAL_BATCHES
    for tag, steps in (("train", first), ("resume", total - first)):
        want = {"stft_log_mel": steps + per_rank, "lstm_seq": 2 * LAYERS * per_rank,
                "lstm_seq_train_fwd": 2 * LAYERS * steps, "lstm_seq_bwd": 2 * LAYERS * steps,
                "ctc_alpha": steps, "ctc_beta": steps}
        for r in runs[tag]:
            check(r["launches"] == want, f"train.main ranks {tag} rank {r['rank']}: "
                                         f"{r['launches']} != {want}")
            check(not r["plain"], f"train.main ranks {tag}: plain calls {r['plain']}")
        recs = [r["result"]["train"] for r in runs[tag]]
        check(recs[0]["loss"] == recs[1]["loss"] and recs[0]["grad_norm"] == recs[1]["grad_norm"]
              and math.isfinite(recs[0]["loss"]), f"train.main ranks {tag}: records {recs}")
    meshes = [r for r in records if r["event"] == "mesh"]
    trains = [r["step"] for r in records if r["event"] == "train"]
    check(len(meshes) == 2 and meshes[0]["layout"] == {"data": 2, "model": 1}
          and trains == [1, *range(2, total + 1, 2)], f"train.main ranks: records {records}")
    check(positions[first]["data_axis"] == 2 and len(positions[total]["positions"]) == 2,
          f"train.main ranks: positions {positions}")
    last = runs["train"][0]["result"]["train"]
    return {"record": last, "resume_record": runs["resume"][0]["result"]["train"],
            "eval": runs["train"][0]["result"]["eval"], "mesh_record": meshes[0],
            "launches": runs["train"][0]["launches"],
            "exchange_share": [r["result"]["train"]["exchange_s"] / r["result"]["train"]["wall_s"]
                               for r in runs["train"]],
            "step_s": [r["result"]["train"]["wall_s"] / first for r in runs["train"]],
            "positions": positions, "train_records": trains,
            "wall_s": [r["wall_s"] for r in runs["train"] + runs["resume"]]}


def slice24_phases() -> tuple[list[dict], dict]:
    """Slice 24's paths: K6 at the split width, the train-step arms across
    ranks, and ``train.main`` across 2 ranks with its resume.
    -> (kernel rows, {path: rank 0's launches})."""
    t0 = time.perf_counter()
    rows = k6_split_phase()
    for k in rows:
        print(f"check {k['name']}: max_abs_err {k['max_abs_err']:.3g} (tol {k['tol']}) "
              f"ms {k['ms']:.4f} plain {k['plain_ms']:.4f} library {k['library_ms']:.4f} "
              f"bound {k['bound_ms']:.4f} ({k['bound_by']}); Cm 96: "
              f"{json.dumps(k['by_cm'][S24_CMS[1]])}")
    print(f"k6_split: {time.perf_counter() - t0:.1f} s; square K5/K6 bits as the parent's")
    t1 = time.perf_counter()
    arms = train_ranks_phase()
    for path, a in arms.items():
        print(f"{path}:", json.dumps(a))
        print(f"{path}: {a['world']} ranks, mesh {a['mesh']}, launches {a['launches_rank0']}, "
              f"loss {a['ranks'][0]['loss']:.6f} (one rank {a['one_rank_loss']:.6f}), "
              f"worst grad {a['ranks'][0]['worst_grad']}, params bit-equal across ranks")
    print(f"train_ranks: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    main_ranks = train_main_ranks_phase()
    print("train_main_ranks:", json.dumps(main_ranks))
    print(f"train_main_ranks: audio_seconds_per_sec_per_chip "
          f"{main_ranks['record']['audio_seconds_per_sec_per_chip']:.2f} (2 ranks sharing "
          f"one card: no speed figure), exchange share of the steps "
          f"{main_ranks['exchange_share']}, positions {json.dumps(main_ranks['positions'])}")
    print(f"train_main_ranks: {time.perf_counter() - t1:.1f} s")
    print(f"slice24: {time.perf_counter() - t0:.1f} s")
    paths = {p: a["launches_rank0"] for p, a in arms.items()}
    paths["s24_train_main"] = main_ranks["launches"]
    return rows, paths


def main() -> int:
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    # Library yardsticks (cuDNN's LSTM and convolutions) in full fp32 too.
    set_fp32_math()
    t_start = time.perf_counter()
    t0 = time.perf_counter()
    logs = build.build(["stft_log_mel", "lstm_seq", "ctc_alpha_beta", "prefix_beam",
                       "tcn_block", "prefix_beam_study"])
    print(f"build: {time.perf_counter() - t0:.1f} s (set-up)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    t0 = time.perf_counter()
    arpa = build_lm()
    print(f"lm: {time.perf_counter() - t0:.1f} s (set-up)")
    rnn_lm, lm_record = build_rnn_lm()
    print("rnn_lm:", json.dumps(lm_record))
    print(f"rnn_lm: {lm_record['wall_s']:.1f} s (set-up), {LM_STEPS} steps, "
          f"nll {lm_record['nll']:.4f}")

    bilstm, bilstm_launches = bilstm_phase()
    kernels = [stft_phase(), lstm_phase(), *lstm_train_phase(), *ctc_phase(),
               *beam_phase(arpa), *rnn_beam_phase(rnn_lm), *tcn_phase(), merge_phase(arpa),
               *bilstm, ctc_paired_phase(), *study_beam_phase()]
    for k in kernels:
        if "frame_split_us" in k:
            print(f"frame_split {k['name']}:", json.dumps(k["frame_split_us"]))
        if "lm_steps_per_frame" in k:
            print(f"lm_steps_per_frame {k['name']}: {k['lm_steps_per_frame']:.4f}")
        lib = "none" if k["library_ms"] is None else f"{k['library_ms']:.4f}"
        print(f"check {k['name']}: max_abs_err {k['max_abs_err']:.3g} "
              f"(tol {k['tol']}) ms {k['ms']:.4f} plain {k['plain_ms']:.4f} "
              f"library {lib} bound {k['bound_ms']:.4f} ({k['bound_by']})")
    print(f"at {time.perf_counter() - t_start:.1f} s: kernel phases done")
    print("slice:", json.dumps(slice_phase()))
    print("train_step:", json.dumps(train_step_phase()))
    dec = decode_phase()
    print("decode:", json.dumps(dec))
    trn = train_main_phase()
    print("train:", json.dumps(trn))
    print(f"train: audio_seconds_per_sec_per_chip "
          f"{trn['record']['audio_seconds_per_sec_per_chip']:.2f} step {trn['step_s']:.4f} s "
          f"ctc_loss {trn['record']['ctc_loss']:.4f}")
    print("learn:", json.dumps(learn_phase(arpa, rnn_lm)))
    print(f"at {time.perf_counter() - t_start:.1f} s: config 1 paths and learn done")
    beam_dec = {"beam_decode": beam_decode_phase(arpa, 0),
                "beam_decode_topa": beam_decode_phase(arpa, BEAM_A),
                "rnn_decode": beam_decode_phase(rnn_lm, 0),
                "rnn_decode_topa": beam_decode_phase(rnn_lm, BEAM_A)}
    # Config 2's RNN decode runs K9 on its grid, a launch a batch, and never
    # its block kernel (beam_decode_phase holds every count exactly).
    for path in ("rnn_decode", "rnn_decode_topa"):
        counts = beam_dec[path]["launches"]
        grid_name = "prefix_beam_rnn" + ("_topa" if path.endswith("topa") else "")
        check(counts.get(grid_name) == DECODE_BATCHES
              and not counts.get(grid_name + "_block") and not counts.get(grid_name + "_wide"),
              f"{path}: K9's grid and block launches {counts}")
        print(f"{path}: K9 grid launches {counts[grid_name]}, block launches "
              f"{counts.get(grid_name + '_block', 0)}")
    for path, res in beam_dec.items():
        print(f"{path}:", json.dumps(res))
        print(f"{path}: decode_rtf {res['decode_rtf']:.5f} wer {res['wer']:.4f} "
              f"padding_efficiency_decode {res['padding_efficiency_decode']:.4f}")
    print(f"at {time.perf_counter() - t_start:.1f} s: config 2 decodes done")
    print("tcn_slice:", json.dumps(slice_phase(CFG3)))
    print("tcn_train_step:", json.dumps(train_step_phase(CFG3, "encoder.stem.")))
    tcn_dec = tcn_decode_phase()
    print("tcn_decode:", json.dumps(tcn_dec))
    print(f"tcn_decode: decode_rtf {tcn_dec['decode_rtf']:.5f} wer {tcn_dec['wer']:.4f} "
          f"padding_efficiency_decode {tcn_dec['padding_efficiency_decode']:.4f}")
    tcn_trn = tcn_train_phase()
    print("tcn_train:", json.dumps(tcn_trn))
    print(f"tcn_train: audio_seconds_per_sec_per_chip "
          f"{tcn_trn['record']['audio_seconds_per_sec_per_chip']:.2f} "
          f"step {tcn_trn['step_s']:.4f} s ctc_loss {tcn_trn['record']['ctc_loss']:.4f}")
    print(f"at {time.perf_counter() - t_start:.1f} s: config 3 paths done")
    slice20_rows, slice20_paths = slice20_phases()
    kernels += slice20_rows
    slice21_rows, slice21_paths = slice21_phases(arpa, rnn_lm)
    kernels += slice21_rows
    slice22_rows, slice22_paths = slice22_phases(arpa)
    kernels += slice22_rows
    slice23_paths = slice23_phases(trn["record"])
    slice24_rows, slice24_paths = slice24_phases()
    kernels += slice24_rows
    t0 = time.perf_counter()
    las = las_phases()
    print(f"las: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print("rnn_past_smem:", json.dumps(rnn_past_smem_phase(rnn_lm)))
    print(f"rnn_past_smem: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    wide, wide_rows, wide_paths = wide_phase()
    print("wide:", json.dumps(wide))
    for k in wide_rows:
        print(f"check {k['name']}: max_abs_err {k['max_abs_err']:.3g} (tol {k['tol']}) "
              f"ms {k['ms']:.4f} plain {k['plain_ms']:.4f} library {k['library_ms']} "
              f"bound {k['bound_ms']:.4f} ({k['bound_by']})")
    kernels += wide_rows
    print(f"wide: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sharded = sharded_decode_phase(arpa, rnn_lm)
    print("sharded_decode:", json.dumps(sharded))
    for path in ("model2", "data2_model2", "rnn_model4"):
        res = sharded[path]
        print(f"sharded_decode {path}: ranks {res['world']} over {res['dist_backend']} "
              f"decode_rtf {res['decode_rtf']:.5f} wer {res['wer']:.4f} "
              f"exchange_share {res['exchange_share_of_batches']:.3f}")
    print(f"sharded_decode: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    trn_paired = train_paired_phase()
    print("train_paired:", json.dumps(trn_paired))
    print(f"train_paired: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    scripts = bench_scripts_phase()
    print("bench_scripts:", json.dumps(scripts))
    print(f"bench_scripts: {time.perf_counter() - t0:.1f} s")
    # Each kernel is held to the main path that runs it: K7, K8 and K9 to
    # the config-2 serving paths, K5 to config 3's serving path, K6 to config
    # 3's training path, K10 to the sharded decode; K11 to its op's own path
    # (no model calls it, as in the JAX package), the paired alpha to config
    # 1's training with PAIRED_FWD set, K13 and K12 to the benchmark scripts
    # that reach them, the wide routes to the wide phase's paths, K2 from a
    # carried state to the streaming recognizer (its wide form past the grid
    # to the recognizer at H 1536), the carried searches to the beam
    # recognizer; the rest to config 1's training path
    # (which runs K2 in its eval); every path's count is printed.
    paths = {"train": trn["launches"], "decode": dec["launches"],
             **{p: r["launches"] for p, r in beam_dec.items()},
             "tcn_decode": tcn_dec["launches"], "tcn_train": tcn_trn["launches"],
             **{f"sharded_{p}": sharded[p]["launches_rank0"]
                for p in ("model2", "data2_model2", "rnn_model4")},
             "bilstm": bilstm_launches, "train_paired": trn_paired["launches"],
             **{p: scripts[p]["launches"] for p in ("bench_prefix_beam", "bench_beam_compile")},
             **{p: las[p]["launches"] for p in ("las_decode", "joint_decode", "las_train",
                                                "joint_train")},
             **wide_paths, **slice20_paths, **slice21_paths, **slice22_paths,
             **slice23_paths, **slice24_paths}
    wide_paths["wide_stream"] = slice20_paths["wide_stream"]
    own_path = {"prefix_beam": "beam_decode", "prefix_beam_topa": "beam_decode_topa",
                "prefix_beam_rnn": "rnn_decode", "prefix_beam_rnn_topa": "rnn_decode_topa",
                "tcn_block": "tcn_decode", "tcn_block_train_fwd": "tcn_train",
                "tcn_block_bwd": "tcn_train", "merge_topk": "sharded_model2",
                "bilstm_seq": "bilstm", "bilstm_seq_train_fwd": "bilstm",
                "bilstm_seq_bwd": "bilstm", "ctc_alpha_paired": "train_paired",
                "prefix_beam_fused": "bench_prefix_beam",
                "prefix_beam_stepwise": "bench_beam_compile",
                "lstm_seq_wide": "wide_decode", "lstm_seq_train_wide": "wide_train",
                "lstm_seq_bwd_wide": "wide_train", "bilstm_seq_wide": "wide_bilstm",
                "bilstm_seq_train_wide": "wide_bilstm", "bilstm_seq_bwd_wide": "wide_bilstm",
                "prefix_beam_wide": "wide_beam", "prefix_beam_rnn_wide": "wide_beam",
                "prefix_beam_fused_wide": "wide_study", "prefix_beam_stepwise_wide": "wide_study",
                "merge_topk_wide": "wide_merge", "prefix_beam_rnn_deep": "wide_deep_lm",
                "ctc_alpha_wide": "wide_ctc", "ctc_beta_wide": "wide_ctc",
                "ctc_alpha_paired_wide": "wide_paired", "stft_log_mel_dft": "wide_stft",
                "lstm_seq_stream": "stream_greedy", "lstm_seq_stream_wide": "wide_stream",
                "prefix_beam_carry": "stream_beam", "prefix_beam_topa_carry": "stream_beam",
                "prefix_beam_rnn_carry": "stream_beam",
                "prefix_beam_rnn_topa_carry": "stream_beam",
                "prefix_beam_hashed": "bpe_decode", "prefix_beam_topa_hashed": "bpe_decode_topa",
                "prefix_beam_hashed_wide": "hashed_v1024",
                "prefix_beam_hashed_wide_lm_top_k": "hashed_v1024",
                "prefix_beam_topa_hashed_v1024": "hashed_v1024",
                "merge_topk_window": "bpe_sharded_model2",
                "prefix_beam_hashed_carry": "stream_beam_hashed",
                "prefix_beam_topa_hashed_carry": "stream_beam_hashed",
                "tcn_block_train_fwd_split": "s24_tcn_model2",
                "tcn_block_bwd_split": "s24_tcn_model2"}
    # The per-utterance oracles of the grid kernels are no path's kernels.
    oracle_runs = {p: counts.get("bilstm_seq_per_utterance", 0)
                   + counts.get("bilstm_seq_bwd_per_utterance", 0) for p, counts in paths.items()}
    print("bilstm_seq_per_utterance and bilstm_seq_bwd_per_utterance launches by path:",
          json.dumps(oracle_runs))
    check(not any(oracle_runs.values()), f"the per-utterance oracle ran on a path: {oracle_runs}")
    # Nor does any main path take a route past the kernels' capacity.
    wide_runs = {p: {r: counts.get(r, 0) for r in WIDE_ROUTES} for p, counts in paths.items()
                 if p not in wide_paths}
    print("wide route launches by path:", json.dumps(wide_runs))
    check(not any(any(c.values()) for c in wide_runs.values()),
          f"a main path took a wide route: {wide_runs}")
    # The deep LM's row is K9's grid at 10 layers, counted under the kernel's name.
    for k in kernels:
        by_path = {p: counts.get(k.get("counted_as", k["name"]), 0) for p, counts in paths.items()}
        own = own_path.get(k["name"], "train")
        check(by_path[own] > 0, f"{k['name']} never launched on its main path ({own})")
        k["launches"], k["launches_by_path"], k["main_path"] = by_path[own], by_path, own
        k["kernel_ms"] = k["ms"]
        # K2, K3 and K4 at configs 4 and 5's shapes, held to their plain versions.
        if k["name"] in las["kernels"]:
            k["las_cases"] = las["kernels"][k["name"]]
            k["max_abs_err"] = max([k["max_abs_err"]] + [c["max_abs_err"] for c in k["las_cases"]])
    print(f"at {time.perf_counter() - t_start:.1f} s: paths checked; profiles next")
    print("profile:", json.dumps(profile_phase()))
    print("train_profile:", json.dumps(train_profile_phase()))
    print("beam_profile:", json.dumps(beam_profile_phase(arpa)))
    print("rnn_beam_profile:", json.dumps(beam_profile_phase(rnn_lm)))
    print("tcn_profile:", json.dumps(tcn_profile_phase()))
    print("las_decode_profile:", json.dumps(las_split_phase(CFG4, profile=True)))
    print("joint_decode_split:", json.dumps(las_split_phase(CFG5, profile=False)))
    print("joint_train_profile:", json.dumps(las_train_profile_phase(CFG5)))
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(1)
    adopt_orphans()
    try:
        code = main()
    finally:
        stop_descendants()
    sys.exit(code)
