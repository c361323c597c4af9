"""Typed experiment configs: the port's own copy of ``pytorch_asr_tpu.configs.base``.

Frozen dataclasses with the same fields and defaults as the JAX package, so a
``key=value`` override (see ``apply_overrides``) reads the same in both CLIs.
Fields that select a JAX-only code path (``use_pallas``, ``tp_directions``,
``rng_impl``) are kept for override compatibility; the port does not read
them: its kernels run wherever a tensor lies on the card.  The mesh is read
by the decode and eval loops over ranks (``parallel/mesh.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Tuple


@dataclass(frozen=True)
class FrontendConfig:
    """STFT -> log-mel frontend parameters (SURVEY.md §2.1 frontend row)."""

    sample_rate: int = 16000
    win_length: int = 400          # 25 ms
    hop_length: int = 160          # 10 ms
    n_fft: int = 512
    n_mels: int = 80
    fmin: float = 0.0
    fmax: float = 8000.0
    log_floor: float = 1e-6
    normalize: bool = True         # per-utterance mean/var over valid frames
    use_pallas: bool = True        # Pallas framed-STFT kernel on TPU
    # SpecAugment (train-time only)
    specaugment: bool = True
    sa_freq_masks: int = 2
    sa_freq_width: int = 27
    sa_time_masks: int = 2
    sa_time_fraction: float = 0.05
    sa_time_warp: int = 0          # Park et al. W (frames); 0 = no time warp
    # On-device waveform augmentation (train-time; frontend/augment.py).
    # The reference genre does these on host via sox; here they run inside
    # the jitted step on the raw waveform.
    waveform_augment: bool = False
    wa_speed_range: Tuple[float, float] = (0.85, 1.15)
    wa_gain_db: Tuple[float, float] = (-6.0, 6.0)
    wa_noise_snr_db: Tuple[float, float] = (15.0, 40.0)


@dataclass(frozen=True)
class DataConfig:
    """LibriSpeech / synthetic data pipeline parameters."""

    librispeech_root: str = ""      # empty -> synthetic audio fixture
    split: str = "dev-clean"
    # Periodic-eval split (SURVEY L5: 'periodic dev WER eval'); used when
    # training on real data.  '' (default) -> evaluate on ``split`` itself
    # (correct for decode/eval CLIs, where ``split`` IS the target); the
    # canonical TRAINING configs set it to dev-clean.
    eval_split: str = ""
    vocab: str = "char"             # "char" | "bpe:<vocab.json>" (asr-train-bpe)
    batch_size: int = 8
    # Bucket boundaries in audio samples; each bucket is one static XLA shape.
    bucket_audio_lens: Tuple[int, ...] = (48000, 96000, 160000, 240000, 320000)
    bucket_label_lens: Tuple[int, ...] = (96, 192, 320, 480, 640)
    # > 0: IGNORE the ladders above and derive this many buckets from the
    # corpus length profile (data/bucket_opt.py: DP-minimal padding waste;
    # SURVEY §7.3 -- bucket design is where audio-s/s is lost).
    auto_buckets: int = 0
    shuffle_seed: int = 0
    # Seed for duration-capped pseudo-splits (dev-clean-1h): the subset is a
    # pure function of (corpus, seed) and the seed is part of the recorded
    # experiment config, so resumes select the identical subset.
    subset_seed: int = 1
    # SortaGrad (Deep Speech 2): first pass in ascending length order.
    sortagrad: bool = False
    # Background prefetch depth for the grain training iterator: batches
    # assembled ahead in a producer thread so host tokenize+pad overlaps
    # device compute.  0 = synchronous (debug).
    prefetch: int = 3
    # Thread-pool width for per-batch parallel audio decode in the grain
    # iterator (lazy corpora only; the C++ decoders release the GIL).
    # 0 = auto: min(8, cpu_count - 1).
    decode_workers: int = 0
    synthetic_num_utts: int = 128   # used when librispeech_root == ""
    # Optional target duration range for the synthetic corpus; 0 = default
    # word-count range (data/synthetic.py).
    synthetic_min_sec: float = 0.0
    synthetic_max_sec: float = 0.0


@dataclass(frozen=True)
class BiLSTMEncoderConfig:
    """conv subsampling + BiLSTM stack (BASELINE config 1/2)."""

    kind: str = "bilstm"
    conv_channels: Tuple[int, ...] = (32, 32)
    conv_kernel: Tuple[int, int] = (3, 3)
    conv_stride: Tuple[int, int] = (2, 2)   # applied per conv layer: time x freq
    hidden_dim: int = 512
    num_layers: int = 4
    dropout: float = 0.1
    use_pallas: bool = True                 # fused Pallas LSTM kernel on TPU
    # Streaming variant (decoding/streaming.py): unidirectional LSTM stack +
    # left-only ("causal") conv padding, so output frame t depends only on
    # input frames <= t and chunked inference can carry exact state.
    bidirectional: bool = True
    causal_conv: bool = False
    # Direction-sharded tensor parallelism (mesh model axis == 2): each model
    # shard runs ONE direction's fully-fused Pallas kernel under shard_map;
    # outputs concatenate over the hidden dim sharded on 'model'.  One
    # activation collective per layer, zero per-step exchanges.  Set by the
    # Trainer when mesh.model_axis == 2 and use_pallas is on.
    tp_directions: bool = False


@dataclass(frozen=True)
class TCNEncoderConfig:
    """Dilated temporal-conv encoder (BASELINE config 3)."""

    kind: str = "tcn"
    channels: int = 384
    kernel_size: int = 5
    num_blocks: int = 10
    dilation_cycle: Tuple[int, ...] = (1, 2, 4, 8, 16)
    subsample: int = 4              # initial strided conv time reduction
    dropout: float = 0.1
    use_pallas: bool = True         # Pallas dilated-conv kernel on the hot path


@dataclass(frozen=True)
class LASDecoderConfig:
    """Listen-Attend-Spell attention decoder (BASELINE config 4/5)."""

    embed_dim: int = 256
    hidden_dim: int = 512
    num_layers: int = 1
    attention_dim: int = 256
    location_kernel: int = 31       # location-sensitive attention conv
    location_filters: int = 32
    dropout: float = 0.1
    label_smoothing: float = 0.1
    # Scheduled sampling (Bengio et al. 2015, used in the Chorowski-lab
    # attention ASR line): with probability p the teacher token is replaced by
    # the model's previous argmax prediction; p ramps linearly from 0 to
    # `scheduled_sampling` over `ss_ramp_steps` optimizer steps.
    scheduled_sampling: float = 0.0
    ss_ramp_steps: int = 10_000


@dataclass(frozen=True)
class ModelConfig:
    encoder: Any = field(default_factory=BiLSTMEncoderConfig)
    decoder: LASDecoderConfig | None = None   # None => CTC-only
    ctc_weight: float = 1.0         # 1.0 CTC-only; 0.0 attention-only; else joint
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"


@dataclass(frozen=True)
class OptimConfig:
    optimizer: str = "adamw"        # adamw | adam | sgd (DS2-style momentum SGD)
    peak_lr: float = 3e-4
    # LR schedule: noam (warmup + inv-sqrt) | constant (warmup + flat) |
    # cosine | exponential (both decay to end_lr_fraction*peak at total_steps).
    schedule: str = "noam"
    end_lr_fraction: float = 0.01
    warmup_steps: int = 1000
    total_steps: int = 100_000
    weight_decay: float = 1e-6
    grad_clip_norm: float = 5.0
    b1: float = 0.9
    b2: float = 0.98
    momentum: float = 0.9           # sgd only
    # Gradient accumulation: one optimizer update every accum_steps
    # micro-batches (for large effective batches on few chips).
    accum_steps: int = 1


@dataclass(frozen=True)
class TrainConfig:
    optim: OptimConfig = field(default_factory=OptimConfig)
    seed: int = 0
    log_every: int = 50
    eval_every: int = 1000
    checkpoint_every: int = 1000
    checkpoint_dir: str = "/tmp/asr_tpu_ckpt"
    keep_checkpoints: int = 3
    remat_encoder: bool = False
    # Polyak/EMA weight averaging (Chorowski-lab decode practice): eval and
    # decode use the EMA weights when ema_decay > 0.
    ema_decay: float = 0.0
    # PRNG implementation of the JAX package's training RNG chain.
    rng_impl: str = "rbg"


@dataclass(frozen=True)
class DecodeConfig:
    method: str = "greedy"          # greedy | prefix_beam | attention_beam | joint_beam
    beam_size: int = 16
    # Shallow fusion: score += lm_alpha * logP_LM(c|ctx) + lm_beta per token.
    # lm_path: '' -> no LM; '*.npz' -> RNN LM (training.lm.save_rnn_lm);
    # anything else -> ARPA n-gram tensorized to a dense device table.
    lm_path: str = ""
    lm_alpha: float = 0.5
    lm_beta: float = 1.0
    # n-gram table backend: "dense" (V^(n-1) x V device table, small vocabs),
    # "hashed" (open-addressing device hash tables, BPE/large vocabs), or
    # "auto" (dense while V^order fits 64M floats, hashed beyond).
    lm_backend: str = "auto"
    # Acoustic-pruned hashed-LM fusion: exact table lookups only for each
    # frame's top-A acoustic candidates (others get the stacked-backoff
    # approximation).  0 = exact for all V.  Only affects hashed backends.
    lm_top_k: int = 0
    # Restricted-candidate search (recommended over lm_top_k for BPE
    # vocabs): extension candidates limited to each frame's top-A acoustic
    # chars, EXACT LM scores on all of them (prefix_beam.
    # _build_candidates_topa).  0 = unrestricted.
    ext_top_a: int = 0
    # Decode-side bucket ladder (round 5): > 0 re-buckets the eval corpus
    # with a DP-optimal K-bucket ladder for DECODING ONLY.  Decode batches
    # never feed the train step, so K can be much larger than
    # data.auto_buckets without any train-step recompiles -- dev/test
    # profiles are longer-tailed than train (K=6 -> 0.79 padding
    # efficiency; K=14 recovers >= 0.9, bucket_ladder_study).  0 = reuse
    # the training ladder.
    auto_buckets: int = 0
    # attention/joint beam
    max_decode_len: int = 256
    length_norm: float = 1.0
    joint_ctc_weight: float = 0.3
    # Coverage bonus (Chorowski & Jaitly 2016): final score +=
    # coverage_beta * #frames with cumulative attention > coverage_tau.
    coverage_beta: float = 0.0
    coverage_tau: float = 0.5
    # Shard beam hypotheses over the 'model' mesh axis during prefix-beam
    # decoding (decode-state parallelism; candidate + LM state exchanged via
    # ICI all_gather).  Requires mesh model axis > 1 and K % model_axis == 0.
    shard_beams: bool = False


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout (SURVEY.md §2.3/§2.4)."""

    data_axis: int = -1             # -1: all remaining devices
    model_axis: int = 1


@dataclass(frozen=True)
class ExperimentConfig:
    name: str = "exp"
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


def _coerce(value: str, current: Any) -> Any:
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, tuple):
        elem = current[0] if current else 0
        return tuple(type(elem)(v) for v in value.split(","))
    return value


def apply_overrides(cfg: Any, overrides: dict[str, str]) -> Any:
    """Apply ``{"a.b.c": "value"}`` overrides to a (possibly nested) frozen dataclass."""
    for key, value in overrides.items():
        parts = key.split(".")
        cfg = _apply_one(cfg, parts, value)
    return cfg


def _apply_one(cfg: Any, parts: list[str], value: str) -> Any:
    head = parts[0]
    if not hasattr(cfg, head):
        raise KeyError(f"config has no field {head!r} (object {type(cfg).__name__})")
    if len(parts) == 1:
        return dataclasses.replace(cfg, **{head: _coerce(value, getattr(cfg, head))})
    return dataclasses.replace(cfg, **{head: _apply_one(getattr(cfg, head), parts[1:], value)})
