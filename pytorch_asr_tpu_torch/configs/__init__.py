"""Canonical experiment configs, one per BASELINE.json config (lines 6-12)."""

from __future__ import annotations

import dataclasses

from pytorch_asr_tpu_torch.configs.base import (
    BiLSTMEncoderConfig,
    DataConfig,
    DecodeConfig,
    ExperimentConfig,
    FrontendConfig,
    LASDecoderConfig,
    MeshConfig,
    ModelConfig,
    OptimConfig,
    TCNEncoderConfig,
    TrainConfig,
    apply_overrides,
)

__all__ = [
    "BiLSTMEncoderConfig",
    "DataConfig",
    "DecodeConfig",
    "ExperimentConfig",
    "FrontendConfig",
    "LASDecoderConfig",
    "MeshConfig",
    "ModelConfig",
    "OptimConfig",
    "TCNEncoderConfig",
    "TrainConfig",
    "apply_overrides",
    "get_config",
    "CONFIGS",
]


def ctc_bilstm_dev1h() -> ExperimentConfig:
    """BASELINE config 1: CTC-only conv+BiLSTM, greedy decode, dev-clean 1h, CPU-runnable."""
    return ExperimentConfig(
        name="ctc_bilstm_dev1h",
        data=DataConfig(split="dev-clean-1h", batch_size=8, sortagrad=True,
                        auto_buckets=6),
        model=ModelConfig(encoder=BiLSTMEncoderConfig(hidden_dim=384, num_layers=3),
                          ctc_weight=1.0),
        decode=DecodeConfig(method="greedy", auto_buckets=14),
    )


def ctc_bilstm_beam_lm() -> ExperimentConfig:
    """BASELINE config 2: CTC prefix beam search with n-gram LM shallow fusion."""
    return ExperimentConfig(
        name="ctc_bilstm_beam_lm",
        data=DataConfig(split="dev-clean", batch_size=16, sortagrad=True,
                        auto_buckets=6),
        model=ModelConfig(encoder=BiLSTMEncoderConfig(), ctc_weight=1.0),
        decode=DecodeConfig(method="prefix_beam", beam_size=16,
                            lm_alpha=0.5, lm_beta=1.0, auto_buckets=14),
    )


def tcn_ctc_devclean() -> ExperimentConfig:
    """BASELINE config 3: TCN (dilated temporal conv) encoder with CTC, full dev-clean."""
    return ExperimentConfig(
        name="tcn_ctc_devclean",
        data=DataConfig(split="dev-clean", batch_size=16, sortagrad=True,
                        auto_buckets=6),
        model=ModelConfig(encoder=TCNEncoderConfig(), ctc_weight=1.0),
        decode=DecodeConfig(method="prefix_beam", beam_size=16,
                            auto_buckets=14),
    )


def las_attention() -> ExperimentConfig:
    """BASELINE config 4: LAS attention encoder-decoder, teacher forcing + attention beam."""
    return ExperimentConfig(
        name="las_attention",
        data=DataConfig(split="train-clean-100", batch_size=16, sortagrad=True,
                        auto_buckets=6, eval_split="dev-clean"),
        model=ModelConfig(encoder=BiLSTMEncoderConfig(),
                          decoder=LASDecoderConfig(),
                          ctc_weight=0.0),
        decode=DecodeConfig(method="attention_beam", beam_size=8,
                            auto_buckets=14),
    )


def joint_ctc_attention_960h() -> ExperimentConfig:
    """BASELINE config 5: joint CTC/attention multitask + joint-score beam, 960h."""
    return ExperimentConfig(
        name="joint_ctc_attention_960h",
        data=DataConfig(split="train-960", batch_size=32, sortagrad=True,
                        auto_buckets=6, eval_split="dev-clean"),
        frontend=FrontendConfig(waveform_augment=True),
        model=ModelConfig(encoder=BiLSTMEncoderConfig(hidden_dim=640, num_layers=5),
                          decoder=LASDecoderConfig(),
                          ctc_weight=0.3),
        train=TrainConfig(optim=OptimConfig(total_steps=300_000)),
        decode=DecodeConfig(method="joint_beam", beam_size=16, joint_ctc_weight=0.3,
                            auto_buckets=14),
    )


CONFIGS = {
    "ctc_bilstm_dev1h": ctc_bilstm_dev1h,
    "ctc_bilstm_beam_lm": ctc_bilstm_beam_lm,
    "tcn_ctc_devclean": tcn_ctc_devclean,
    "las_attention": las_attention,
    "joint_ctc_attention_960h": joint_ctc_attention_960h,
}


def get_config(name: str, **overrides: str) -> ExperimentConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; available: {sorted(CONFIGS)}")
    cfg = CONFIGS[name]()
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return cfg
