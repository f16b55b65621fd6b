"""Configuration: model geometries and the run config.

The port's own copy of what the captioning and training paths read from the
JAX package's ``klab_multimodalmodel_tpu/config.py``: the T5 and SwinV2
geometry tables, the custom-size registry, a ``Config`` with the same
field names and defaults for the fields this package reads, and the
command line (``build_arg_parser`` / ``parse_arguments``) with the JAX
package's flags.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any, Sequence


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
# The JAX ``Config``'s words for GPipe stages beside a seq axis and beside
# MoE (``utils/mesh.py`` raises them for a pipe axis beside either).
STAGES_WITH_SEQ = (
    "pipeline_stages > 1 with a seq mesh axis > 1 is not supported "
    "(sharding constraints inside the vmapped stages); shard long "
    "sequences with --mesh_shape seq instead of the pipeline")
STAGES_WITH_MOE = (
    "moe_experts > 0 with pipeline_stages > 1 is not supported (the MoE "
    "aux loss does not thread through the pipeline tick schedule); shard "
    "experts with the mesh expert axis instead")
_SCHEDULERS = ("", "cosine", "linear", "exponential", "step")
_REMAT = ("", "full", "dots_saveable")


@dataclasses.dataclass
class Config:
    """The fields of the JAX package's ``Config`` that captioning, the
    training step and the training loop read, with the same names,
    defaults and checks. An option that is not ported raises
    ``NotImplementedError``: ``profile_server_port > 0`` (PyTorch has no
    live profiler server)."""

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
    # Mesh: data x fsdp x tensor x seq x pipe x expert, one rank per
    # entry (-1 = the world's processes); pipe must equal pipeline_stages
    # (its ranks hold one stage each) and expert divide moe_experts (its
    # ranks hold E / expert experts each). 3 to 6 entries, right-padded
    # with 1.
    mesh_shape: tuple[int, ...] = (-1, 1, 1, 1, 1, 1)
    mesh_axis_names: tuple[str, ...] = ("data", "fsdp", "tensor", "seq",
                                        "pipe", "expert")
    # The JAX package's per-axis factors across slices; under DDP a data
    # factor here is more data ranks (global data = mesh x dcn).
    dcn_mesh_shape: tuple[int, ...] = (1, 1, 1, 1, 1, 1)
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
    # Sequence-parallel attention, effective with a seq axis above 1:
    # 'allgather' gathers the whole K/V on every seq rank; 'ring' streams
    # them around the seq group (ops/ring_attention.py), K/V O(L / S) per
    # rank. The T5 kernel, where on, wins over the ring (as in the JAX
    # package), so the port refuses that inert combination.
    seq_attention: str = "allgather"
    # GPipe over the main transformer's two stacks (models/t5.py): this
    # many stages of num_layers / stages consecutive blocks, with
    # pipeline_microbatches microbatches (0 = pipeline_stages) per forward,
    # which must divide it. On one rank the schedule only reorders work.
    pipeline_stages: int = 1
    pipeline_microbatches: int = 0
    # Switch / GShard mixture of experts in every MLP of the main
    # transformer (ops/moe.py): this many experts (0 = dense), each token
    # routed to moe_top_k of them (1 or 2) at a per-expert capacity of
    # ceil(top_k * tokens / experts * moe_capacity_factor); the balance loss
    # joins the loss at moe_aux_loss_weight. The towers stay dense.
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_aux_loss_weight: float = 0.01
    # Attend pad positions (the reference's no-mask behaviour).
    reference_pad_quirks: bool = False
    # The reference's optimizer covers only the transformer: with
    # image_model_train, the image tower still takes no update.
    freeze_image_model_updates: bool = False
    # Identity-initialized projection between vision features and d_model.
    use_vision_projection: bool = True
    generate_max_length: int = 20
    num_beams: int = 1
    # Tokenizer file (tokenizer.json or spiece.model), or '' for the byte
    # tokenizer.
    tokenizer_path: str = ""
    # The JAX package's switch to its C++ encoder. The port's unigram
    # tokenizer always encodes there: the flag only requires a
    # tokenizer_path (get_dataloader).
    native_tokenizer: bool = False
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
    # Multi-process runs agree on a halt (a SIGTERM may reach one rank
    # only) every N optimizer steps, so that every rank saves together.
    preempt_sync_steps: int = 10
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
    # Every N epochs, caption the first eval_captions_limit COCO-val images
    # and log CIDEr-D / BLEU-4 / ROUGE-L (0 = off).
    eval_captions_every: int = 0
    eval_captions_limit: int = 256

    def __post_init__(self) -> None:
        from .utils.mesh import DEFAULT_AXIS_NAMES

        names = tuple(self.mesh_axis_names)
        if names == DEFAULT_AXIS_NAMES[:len(names)]:
            names = DEFAULT_AXIS_NAMES
        self.mesh_axis_names = names
        for name in ("mesh_shape", "dcn_mesh_shape"):
            shape = tuple(int(s) for s in getattr(self, name))
            if not 3 <= len(shape) <= len(names):
                raise ValueError(
                    f"{name}={shape}: expected 3 or {len(names)} axes")
            shape = shape + (1,) * (len(names) - len(shape))
            setattr(self, name, shape)
        if self.seq_attention not in ("allgather", "ring"):
            raise ValueError(
                f"unknown seq_attention {self.seq_attention!r}")
        # Before the refusals of what waits: a value the JAX package
        # refuses raises its ValueError.
        self._check_pipeline_and_moe()
        self._check_sharding()
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

    def _axis(self, name: str) -> int | None:
        """A mesh axis's global size (ICI x DCN factor), 1 for an axis the
        names lack, None for the -1 wildcard."""
        try:
            i = self.mesh_axis_names.index(name)
        except ValueError:
            return 1
        ici, dcn = self.mesh_shape[i], self.dcn_mesh_shape[i]
        if ici == -1 or dcn == -1:
            return None
        return ici * dcn

    def _check_sharding(self) -> None:
        """The port's checks of the ``fsdp``, ``tensor`` and ``seq`` axes.
        The JAX package leaves uneven shards to XLA; the port's tensor
        parallelism runs whole heads and whole d_ff columns per rank, so
        both T5s' heads and d_ff must divide by ``tensor`` (the vocab need
        not: DTensor pads its uneven shards). MoE experts share the
        transformer's d_ff, which its check covers: under ``tensor`` each
        rank runs its columns of every expert. GPipe stages take ``fsdp``
        and ``tensor`` as the JAX package takes them, at ``pipe`` 1 or
        equal to the stages (the T5 kernel stays off under stages:
        ``_check_pipeline_and_moe``), and ``seq`` takes them too, on
        both ``seq_attention`` backends, with MoE (``expert`` beside
        ``seq`` too) as without. ``pipe`` beside ``seq`` or ``expert``
        raises the JAX package's ValueError there (stages with seq, MoE
        with stages). ``seq_attention='ring'`` with
        the T5 kernel on and ``seq`` above 1 is refused as inert: the JAX
        package runs the kernel there and never the ring."""
        tensor, seq = self._axis("tensor"), self._axis("seq")
        if seq != 1:
            if (self.seq_attention == "ring"
                    and self.use_pallas_t5_attention):
                raise ValueError(
                    "seq_attention='ring' with use_pallas_t5_attention and "
                    "a seq mesh axis > 1: the T5 kernel wins there and the "
                    "ring never runs; drop one of the flags")
        if tensor not in (None, 1):
            for which, size in (("language", self.language_t5),
                                ("transformer", self.transformer_t5)):
                if size.num_heads % tensor or size.d_ff % tensor:
                    raise ValueError(
                        f"{which} T5: num_heads={size.num_heads} and "
                        f"d_ff={size.d_ff} must divide by the mesh tensor "
                        f"axis {tensor}")

    def _check_pipeline_and_moe(self) -> None:
        """The JAX package's checks of the pipeline and MoE flags
        (``config.py:420-475``), with its messages."""
        axis = self._axis
        if self.pipeline_stages > 1:
            if self.seq_attention == "ring":
                raise ValueError(
                    "pipeline_stages > 1 with seq_attention='ring' is not "
                    "supported (shard_map inside the pipeline's vmapped "
                    "stages); use the default allgather seq path")
            if self.use_pallas_t5_attention:
                raise ValueError(
                    "pipeline_stages > 1 with use_pallas_t5_attention is "
                    "not supported; drop one of the flags")
            if axis("pipe") not in (None, 1, self.pipeline_stages):
                raise ValueError(
                    f"mesh pipe axis {axis('pipe')} must equal "
                    f"pipeline_stages={self.pipeline_stages} (or 1 to run "
                    "the schedule unsharded)")
            if axis("seq") != 1:
                raise ValueError(STAGES_WITH_SEQ)
        elif axis("pipe") != 1:
            raise ValueError(
                f"mesh pipe axis {axis('pipe')} > 1 requires "
                "--pipeline_stages to match")
        if self.moe_experts > 0:
            if self.moe_top_k not in (1, 2):
                raise ValueError(
                    f"moe_top_k={self.moe_top_k}: expected 1 (Switch) "
                    "or 2 (GShard)")
            if self.pipeline_stages > 1:
                raise ValueError(STAGES_WITH_MOE)
            expert = axis("expert")
            if expert is not None and self.moe_experts % max(expert, 1):
                raise ValueError(
                    f"moe_experts={self.moe_experts} must be divisible by "
                    f"the mesh expert axis {expert}")
            if self.moe_capacity_factor <= 0:
                raise ValueError("moe_capacity_factor must be positive")
            if self.bucket_lengths:
                raise ValueError(
                    "moe_experts > 0 with bucket_lengths is not supported: "
                    "expert capacity quantizes on the (static) padded "
                    "sequence length, so per-bucket capacities would break "
                    "bucket_lengths' loss-identity guarantee; run MoE at "
                    "fixed max lengths")
        elif axis("expert") != 1:
            raise ValueError(
                f"mesh expert axis {axis('expert')} > 1 requires "
                "--moe_experts")

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
        have (the JAX package's other options) are ignored."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in json.loads(text).items() if k in names})


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


# ---------------------------------------------------------------------------
# Command line: the JAX package's flags, names, defaults and choices
# ---------------------------------------------------------------------------

# Flags whose value the port cannot honour unless it is the default: the
# fields its Config lacks. flag: (default, the ROADMAP item that ports it).
UNPORTED_FLAGS: dict[str, tuple[Any, str]] = {
    "scan_unroll": (0, "A, not ported by design: the port's layers run "
                       "in a Python loop, with no XLA scan to unroll"),
}


def build_arg_parser() -> argparse.ArgumentParser:
    """The JAX package's training flags, with the same names, defaults and
    choices (the reference's flags first)."""
    parser = argparse.ArgumentParser(
        description="KLab MultiModalModel, PyTorch/CUDA port")
    d = Config()
    t5_names = list(T5_SIZES) + list(_CUSTOM_T5)
    add = parser.add_argument
    add("--image_model_name", type=str, default=d.image_model_name)
    add("--image_model_train", action="store_true")
    add("--language_model_name", type=str, default=d.language_model_name,
        choices=t5_names)
    add("--transformer_model_name", type=str,
        default=d.transformer_model_name, choices=t5_names)
    add("--max_source_length", type=int, default=d.max_source_length)
    add("--max_target_length", type=int, default=d.max_target_length)
    add("--lr", type=float, default=d.lr)
    add("--lr_scheduler", type=str, default=d.lr_scheduler,
        choices=list(_SCHEDULERS))
    add("--batch_size", type=int, default=d.batch_size)
    add("--accumulation_steps", type=int, default=d.accumulation_steps)
    add("--num_epochs", type=int, default=None)
    add("--num_steps", type=int, default=None)
    add("--save_interval", type=int, default=None)
    add("--data_dir", type=str, default=d.data_dir)
    add("--result_dir", type=str, default=d.result_dir)
    add("--seed", type=int, default=d.seed)
    add("--mesh_shape", type=int, nargs="+", default=list(d.mesh_shape),
        help="3-6 ints: DATA FSDP TENSOR [SEQ [PIPE [EXPERT]]]; one rank per "
             "entry (-1 = all processes); PIPE equals --pipeline_stages, "
             "EXPERT divides --moe_experts; refused as the JAX package "
             "refuses them: PIPE beside SEQ or EXPERT, each above 1")
    add("--dcn_mesh_shape", type=int, nargs="+",
        default=list(d.dcn_mesh_shape),
        help="3-6 ints: per-axis factors across slices, each multiplying "
             "its axis's ranks (PIPE and EXPERT as in --mesh_shape)")
    add("--compute_dtype", type=str, default=d.compute_dtype,
        choices=list(_DTYPE_NAMES))
    add("--remat", type=str, default=d.remat, choices=list(_REMAT))
    add("--scan_unroll", type=int, default=UNPORTED_FLAGS["scan_unroll"][0])
    add("--optimizer", type=str, default=d.optimizer,
        choices=["adam", "adafactor"])
    add("--adam_mu_dtype", type=str, default=d.adam_mu_dtype,
        choices=list(_DTYPE_NAMES))
    add("--frozen_param_dtype", type=str, default=d.frozen_param_dtype,
        choices=list(_DTYPE_NAMES))
    add("--use_pallas_attention", action="store_true")
    add("--swin_softmax_dtype", type=str, default=d.swin_softmax_dtype,
        choices=list(_DTYPE_NAMES))
    add("--swin_gelu_approximate", action="store_true")
    add("--use_pallas_t5_attention", action="store_true")
    add("--seq_attention", type=str, default=d.seq_attention,
        choices=["allgather", "ring"])
    for name in ("pipeline_stages", "pipeline_microbatches", "moe_experts",
                 "moe_top_k"):
        add(f"--{name}", type=int, default=getattr(d, name))
    for name in ("moe_capacity_factor", "moe_aux_loss_weight"):
        add(f"--{name}", type=float, default=getattr(d, name))
    add("--reference_pad_quirks", action="store_true")
    add("--freeze_image_model_updates", action="store_true")
    add("--cache_frozen_features", action="store_true")
    add("--tokenizer_path", type=str, default=d.tokenizer_path)
    add("--native_tokenizer", action="store_true")
    add("--halt_after_steps", type=int, default=d.halt_after_steps)
    add("--init_checkpoint", type=str, default=d.init_checkpoint)
    add("--num_workers", type=int, default=d.num_workers)
    add("--decode_workers", type=str, default=d.decode_workers,
        choices=["thread", "process"])
    add("--bucket_lengths", action="store_true")
    add("--accumulation_tail", type=str, default=d.accumulation_tail,
        choices=["pad", "drop", "error"])
    add("--tensorboard", action="store_true")
    add("--profile_steps", type=int, default=d.profile_steps)
    add("--profile_server_port", type=int, default=d.profile_server_port)
    add("--log_every_steps", type=int, default=d.log_every_steps)
    add("--eval_captions_every", type=int, default=d.eval_captions_every)
    add("--eval_captions_limit", type=int, default=d.eval_captions_limit)
    add("--generate_max_length", type=int, default=d.generate_max_length)
    add("--num_beams", type=int, default=d.num_beams)
    return parser


def config_from_args(args: argparse.Namespace) -> Config:
    """A ``Config`` from ``build_arg_parser``'s namespace. A flag the port
    cannot honour, given another value than its default, raises
    ``NotImplementedError`` naming the ROADMAP item that ports it (all such
    flags in one message); the ``Config`` then checks the rest as the JAX
    package's does (the pipeline and MoE flags, the pipe and expert axes)
    and refuses ``profile_server_port``."""
    kwargs: dict[str, Any] = dict(vars(args))
    fields = {f.name for f in dataclasses.fields(Config)}
    refused = []
    for name, (default, item) in UNPORTED_FLAGS.items():
        value = kwargs[name] if name in fields else kwargs.pop(name)
        if isinstance(value, list):
            value = tuple(value)
        if value != default:
            refused.append(f"--{name} {value!r} (ROADMAP {item})")
    if refused:
        raise NotImplementedError(
            "flags not ported (accepted only at their defaults): "
            + "; ".join(refused))
    return Config(**kwargs)


def parse_arguments(argv: Sequence[str] | None = None) -> Config:
    """The JAX package's ``parse_arguments``: the command line (``argv``,
    default ``sys.argv[1:]``) as a ``Config``."""
    return config_from_args(build_arg_parser().parse_args(argv))
