"""Typed configuration backed by the reference's YAML surface.

The port's own copy of ``lass_tpu/config.py`` (the port imports nothing of
the JAX package): the same key names and sections as
config/audiosep_base.yaml, parsed into validated dataclasses. Unknown keys
raise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import yaml


@dataclasses.dataclass
class LoudnessNormConfig:
    lower_db: int = -10
    higher_db: int = 10


@dataclasses.dataclass
class DataConfig:
    datafiles: List[str] = dataclasses.field(default_factory=list)
    sampling_rate: int = 16000
    segment_seconds: int = 10
    loudness_norm: LoudnessNormConfig = dataclasses.field(
        default_factory=LoudnessNormConfig)
    max_mix_num: int = 2
    stft_hop_length: int = 160
    stft_window: str = "hann"
    stft_center: bool = True
    stft_pad_mode: str = "reflect"
    stft_win_lengths: List[int] = dataclasses.field(
        default_factory=lambda: [256, 512, 2048])

    @property
    def segment_samples(self) -> int:
        # segment_seconds may legitimately be fractional (e.g. 1.5 s test
        # configs) — shapes must still be ints
        return int(round(self.sampling_rate * self.segment_seconds))


@dataclasses.dataclass
class ModelConfig:
    query_net: str = "CLAP"
    condition_size: int = 512
    model_type: str = "ResUNet30"
    input_channels: int = 1
    output_channels: int = 1
    resume_checkpoint: str = ""
    use_text_ratio: float = 1.0
    # extensions (absent keys default; the reference has no equivalent):
    # activation dtype of the UNet ('bfloat16' or 'float32')
    compute_dtype: str = "bfloat16"
    # matmul passes of the JAX package's DSP; the port's FFT-based DSP
    # always runs in full float32, so it only validates the value
    dsp_precision: str = "high"


@dataclasses.dataclass
class OptimizerConfig:
    optimizer_type: str = "AdamW"
    learning_rate: float = 1e-3
    warm_up_steps: int = 10000
    reduce_lr_steps: int = 1000000
    lr_lambda_type: str = "constant_warm_up"


@dataclasses.dataclass
class TrainConfig:
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    num_nodes: int = 1
    num_workers: int = 12
    loss_type: str = "l1_wav"
    sync_batchnorm: bool = True
    batch_size_per_device: int = 128
    steps_per_epoch: int = 10000
    evaluate_step_frequency: int = 10000
    save_step_frequency: int = 20000
    early_stop_steps: int = 10000001
    random_seed: int = 1234
    # host->device wire format for training waveforms ('float32' or
    # 'int16'); read by the training loop of a later slice
    wire_dtype: str = "float32"


@dataclasses.dataclass
class Config:
    task_name: str = "AudioSep"
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


def _build(cls, raw: Dict[str, Any]):
    """Construct dataclass `cls` from a raw dict, recursing into nested
    dataclass fields; unknown keys raise (typo protection)."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in raw.items():
        if key not in fields:
            raise KeyError(f"unknown config key '{key}' for {cls.__name__}")
        target = _DATACLASS_FIELDS.get((cls, key))
        if target is not None and isinstance(value, dict):
            kwargs[key] = _build(target, value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


_DATACLASS_FIELDS = {
    (Config, "data"): DataConfig,
    (Config, "model"): ModelConfig,
    (Config, "train"): TrainConfig,
    (DataConfig, "loudness_norm"): LoudnessNormConfig,
    (TrainConfig, "optimizer"): OptimizerConfig,
}


def parse_yaml(config_yaml: str) -> Dict[str, Any]:
    """Raw-dict parse, API-compatible with reference utils.parse_yaml."""
    with open(config_yaml) as f:
        return yaml.safe_load(f)


def load_config(config_yaml: str) -> Config:
    raw = parse_yaml(config_yaml)
    cfg = _build(Config, raw)
    cfg.train.optimizer.learning_rate = float(cfg.train.optimizer.learning_rate)
    if cfg.data.sampling_rate <= 0:
        raise ValueError("sampling_rate must be positive")
    if cfg.data.max_mix_num < 2:
        raise ValueError("max_mix_num must be >= 2 (reference mixer asserts "
                         "mix_num >= 2, waveform_mixers.py:36)")
    if cfg.train.wire_dtype not in ("float32", "int16"):
        raise ValueError("train.wire_dtype must be 'float32' or 'int16', "
                         f"got {cfg.train.wire_dtype!r}")
    return cfg
