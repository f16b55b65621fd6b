"""Configuration: model geometries and the run config.

The port's own copy of what the captioning and training paths read from the
JAX package's ``klab_multimodalmodel_tpu/config.py``: the T5 and SwinV2
geometry tables, the custom-size registry, and a ``Config`` with the same
field names and defaults for the fields this package reads.
"""

from __future__ import annotations

import dataclasses
import json
import os


# ---------------------------------------------------------------------------
# Model geometry tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class T5Size:
    """Geometry + recipe of a T5 checkpoint family member (published
    google/t5 configs). ``feed_forward_proj`` and ``tie_word_embeddings``
    select the v1.1 / Flan recipe: gated-gelu MLPs and an untied LM head."""

    d_model: int
    d_kv: int
    d_ff: int
    num_layers: int
    num_decoder_layers: int
    num_heads: int
    vocab_size: int = 32128
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    dropout_rate: float = 0.1
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "relu"  # original T5 uses un-gated ReLU MLPs
    tie_word_embeddings: bool = True
    pad_token_id: int = 0
    eos_token_id: int = 1
    decoder_start_token_id: int = 0


T5_SIZES: dict[str, T5Size] = {
    "t5-small": T5Size(d_model=512, d_kv=64, d_ff=2048, num_layers=6,
                       num_decoder_layers=6, num_heads=8),
    "t5-base": T5Size(d_model=768, d_kv=64, d_ff=3072, num_layers=12,
                      num_decoder_layers=12, num_heads=12),
    "t5-large": T5Size(d_model=1024, d_kv=64, d_ff=4096, num_layers=24,
                       num_decoder_layers=24, num_heads=16),
    "t5-3b": T5Size(d_model=1024, d_kv=128, d_ff=16384, num_layers=24,
                    num_decoder_layers=24, num_heads=32),
    "t5-11b": T5Size(d_model=1024, d_kv=128, d_ff=65536, num_layers=24,
                     num_decoder_layers=24, num_heads=128),
}


def _v11(d_model, d_ff, num_layers, num_heads):
    return T5Size(d_model=d_model, d_kv=64, d_ff=d_ff, num_layers=num_layers,
                  num_decoder_layers=num_layers, num_heads=num_heads,
                  feed_forward_proj="gated-gelu", tie_word_embeddings=False)


for _stem in ("google/t5-v1_1", "google/flan-t5"):
    T5_SIZES[f"{_stem}-small"] = _v11(512, 1024, 8, 6)
    T5_SIZES[f"{_stem}-base"] = _v11(768, 2048, 12, 12)
    T5_SIZES[f"{_stem}-large"] = _v11(1024, 2816, 24, 16)
    T5_SIZES[f"{_stem}-xl"] = _v11(2048, 5120, 24, 32)
    T5_SIZES[f"{_stem}-xxl"] = _v11(4096, 10240, 24, 64)
del _stem  # registration loop variable; not part of the module API


@dataclasses.dataclass(frozen=True)
class SwinV2Size:
    """Geometry of a SwinV2 checkpoint family member. The default is
    microsoft/swinv2-base-patch4-window8-256."""

    image_size: int = 256
    patch_size: int = 4
    num_channels: int = 3
    embed_dim: int = 128
    depths: tuple[int, ...] = (2, 2, 18, 2)
    num_heads: tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 8
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    layer_norm_eps: float = 1e-5
    drop_path_rate: float = 0.1
    pretrained_window_sizes: tuple[int, ...] = (0, 0, 0, 0)

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (len(self.depths) - 1))

    @property
    def num_patches_out(self) -> int:
        side = self.image_size // self.patch_size
        side //= 2 ** (len(self.depths) - 1)
        return side * side


SWINV2_SIZES: dict[str, SwinV2Size] = {
    "microsoft/swinv2-tiny-patch4-window8-256": SwinV2Size(
        embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24)),
    "microsoft/swinv2-small-patch4-window8-256": SwinV2Size(
        embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24)),
    "microsoft/swinv2-base-patch4-window8-256": SwinV2Size(),
    "microsoft/swinv2-large-patch4-window12-192-22k": SwinV2Size(
        image_size=192, embed_dim=192, depths=(2, 2, 18, 2),
        num_heads=(6, 12, 24, 48), window_size=12),
}


# ---------------------------------------------------------------------------
# Run config
# ---------------------------------------------------------------------------


_DTYPE_NAMES = ("float32", "bfloat16")
_SCHEDULERS = ("", "cosine", "linear", "exponential", "step")
_REMAT = ("", "full", "dots_saveable")


@dataclasses.dataclass
class Config:
    """The fields of the JAX package's ``Config`` that captioning, the
    training step and the training loop read, with the same names and
    defaults. Options that are not ported raise ``NotImplementedError``
    naming the ROADMAP item that ports them: ``moe_experts > 0`` (A12),
    ``native_tokenizer`` (A6), ``eval_captions_every > 0`` (A8) and
    ``profile_server_port > 0`` (PyTorch has no live profiler server)."""

    image_model_name: str = "microsoft/swinv2-base-patch4-window8-256"
    # Train the image tower (it joins the optimizer unless
    # freeze_image_model_updates is set).
    image_model_train: bool = False
    language_model_name: str = "t5-large"
    transformer_model_name: str = "t5-large"
    max_source_length: int = 256
    max_target_length: int = 128
    lr: float = 0.001
    lr_scheduler: str = ""  # '', cosine, linear, exponential, step
    batch_size: int = 64  # per device
    accumulation_steps: int = 1
    num_epochs: int | None = None
    num_steps: int | None = None
    save_interval: int | None = None
    data_dir: str = "/user/data/mscoco2017/"
    result_dir: str = "results/"
    seed: int = 0
    # Compute dtype policy: params fp32, activations bf16.
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # Activation checkpointing of the trainable transformer's blocks: '',
    # 'full' or 'dots_saveable' (keep the matrix products' outputs).
    remat: str = ""
    optimizer: str = "adam"  # or 'adafactor'
    # Storage dtype of Adam's first moment (the second stays fp32).
    adam_mu_dtype: str = "float32"
    # Storage dtype of the frozen towers' parameters.
    frozen_param_dtype: str = "float32"
    # dtype of the SwinV2 attention logits/softmax chain.
    swin_softmax_dtype: str = "float32"
    # SwinV2 MLP activation: exact erf GELU, or the tanh approximation.
    swin_gelu_approximate: bool = False
    # Route SwinV2 window attention / T5 full-sequence attention through
    # the hand-written kernels (ops/fused_attention.py). Decode steps never
    # take a kernel.
    use_pallas_attention: bool = False
    use_pallas_t5_attention: bool = False
    # Only the dense model is ported; kept so configs carry the field.
    moe_experts: int = 0
    # Attend pad positions (the reference's no-mask behaviour).
    reference_pad_quirks: bool = False
    # The reference's optimizer covers only the transformer: with
    # image_model_train, the image tower still takes no update.
    freeze_image_model_updates: bool = False
    # Identity-initialized projection between vision features and d_model.
    use_vision_projection: bool = True
    generate_max_length: int = 20
    num_beams: int = 1
    # Tokenizer file, or '' for the byte tokenizer (the only one ported).
    tokenizer_path: str = ""
    native_tokenizer: bool = False  # not ported (A6)
    # Directory of a pretrained port checkpoint whose top-level submodules
    # initialize a fresh run (checkpoint/io.py load_pretrained_params);
    # ignored when resuming from a checkpoint in result_dir.
    init_checkpoint: str = ""
    # Cache the frozen towers' outputs across epochs (train/feature_cache.py):
    # epoch 1 fills, later epochs skip the towers. Needs a frozen image tower.
    cache_frozen_features: bool = False
    # Stop after this many optimizer steps with a step_N checkpoint that a
    # rerun of the same command resumes from bitwise (0 = off).
    halt_after_steps: int = 0
    # Save the same checkpoint on SIGTERM after the update in flight.
    save_on_sigterm: bool = True
    # Leftover microbatches when len(loader) % accumulation_steps != 0:
    # 'pad' (zero-weight rows, gradient-exact), 'drop' or 'error'.
    accumulation_tail: str = "pad"
    # Trace the first N optimizer steps into {result_dir}/profile (0 = off).
    profile_steps: int = 0
    profile_server_port: int = 0  # not ported (no live profiler server)
    tensorboard: bool = False  # scalars under {result_dir}/tb
    # Data pipeline: decode workers (0 = os.cpu_count() // 4), 'thread' or
    # 'process' workers, batches prefetched ahead of the step.
    num_workers: int = 0
    # Trim each update's source/target padding to the smallest power-of-two
    # width (floors 16/8) that holds its longest row; loss-identical.
    bucket_lengths: bool = False
    decode_workers: str = "thread"
    prefetch_batches: int = 2
    log_every_steps: int = 50
    eval_captions_every: int = 0  # not ported (A8)

    def __post_init__(self) -> None:
        for name in ("swin_softmax_dtype", "compute_dtype", "param_dtype",
                     "adam_mu_dtype", "frozen_param_dtype"):
            if getattr(self, name) not in _DTYPE_NAMES:
                raise ValueError(f"{name}={getattr(self, name)!r}: expected "
                                 "'float32' or 'bfloat16'")
        if self.lr_scheduler not in _SCHEDULERS:
            raise ValueError(f"unknown lr_scheduler {self.lr_scheduler!r}")
        if self.optimizer not in ("adam", "adafactor"):
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        if self.remat not in _REMAT:
            raise ValueError(f"unknown remat {self.remat!r}: expected one of "
                             f"{_REMAT}")
        if self.moe_experts != 0:
            raise NotImplementedError(
                "moe_experts > 0 is not ported (ROADMAP A12); only the dense "
                "model is")
        if self.native_tokenizer:
            raise NotImplementedError(
                "native_tokenizer is not ported (ROADMAP A6)")
        if self.eval_captions_every > 0:
            raise NotImplementedError(
                "eval_captions_every > 0 is not ported (ROADMAP A8); "
                "evaluate the checkpoints after training instead")
        if self.profile_server_port > 0:
            raise NotImplementedError(
                "profile_server_port: PyTorch has no live profiler server; "
                "use profile_steps to trace steps into result_dir/profile")
        if self.accumulation_tail not in ("pad", "drop", "error"):
            raise ValueError(
                f"unknown accumulation_tail {self.accumulation_tail!r}")
        if self.decode_workers not in ("thread", "process"):
            raise ValueError(f"unknown decode_workers {self.decode_workers!r}")
        if self.bucket_lengths and self.reference_pad_quirks:
            raise ValueError(
                "bucket_lengths trims pad columns, but reference_pad_quirks "
                "keeps every position in the loss; drop one of the flags")
        if self.cache_frozen_features and self.image_model_train:
            raise ValueError(
                "cache_frozen_features requires a frozen image tower "
                "(image_model_train=False)")

    # -- derived model geometries ------------------------------------------
    @property
    def language_t5(self) -> T5Size:
        return _t5_size(self.language_model_name)

    @property
    def transformer_t5(self) -> T5Size:
        return _t5_size(self.transformer_model_name)

    @property
    def swin(self) -> SwinV2Size:
        return _swin_size(self.image_model_name)

    # -- (de)serialization -------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    def save(self, result_dir: str | None = None) -> str:
        path = os.path.join(result_dir or self.result_dir, "config.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    @classmethod
    def from_json(cls, text: str) -> "Config":
        """A config from ``to_json``'s text; fields this package does not
        have (the JAX package's mesh and multi-host fields) are ignored."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in json.loads(text).items()
                      if k in names})


# Custom geometry registry: lets tests and users register model sizes under
# arbitrary names without touching the published tables.
_CUSTOM_T5: dict[str, T5Size] = {}
_CUSTOM_SWIN: dict[str, SwinV2Size] = {}


def register_t5_size(name: str, size: T5Size) -> None:
    _CUSTOM_T5[name] = size


def register_swin_size(name: str, size: SwinV2Size) -> None:
    _CUSTOM_SWIN[name] = size


def _t5_size(name: str) -> T5Size:
    if name in _CUSTOM_T5:
        return _CUSTOM_T5[name]
    if name in T5_SIZES:
        return T5_SIZES[name]
    raise KeyError(f"unknown T5 model name {name!r}; register_t5_size() first")


def _swin_size(name: str) -> SwinV2Size:
    if name in _CUSTOM_SWIN:
        return _CUSTOM_SWIN[name]
    if name in SWINV2_SIZES:
        return SWINV2_SIZES[name]
    raise KeyError(
        f"unknown SwinV2 model name {name!r}; register_swin_size() first")
