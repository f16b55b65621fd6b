"""The port's partitioning rules (``parallel/partitioning.py``) against the
JAX package's, the per-rank bytes they give, the kernels' head offset and
the refusals of what the sharded axes do not take yet. No process group.

(a) For every parameter of the port's model at dense t5-large, t5-3b,
t5-11b and flan-t5-xxl (gated MLP, untied head), built on the meta device,
the port's ``spec_for_path`` gives the layout the JAX ``spec_for_path``
gives for the JAX leaf it converts from. The JAX tree is abstract
(``jax.eval_shape``); each leaf becomes a zero-copy numpy view whose dim
k has stride 4 (k + 1) bytes over a buffer of its own, so that after the
port's own converters (``checkpoint/from_jax.py``) each port tensor's
buffer names its JAX leaf and its strides name the JAX dim of each torch
dim (the layer axis of a scanned stack is indexed away).

(b) Params, gradients and Adam's moments per rank under the JAX test's
meshes (``tests/test_large_model_sharding.py``) fit the same budgets, as
``parallelize`` lays them out (the Swin tower replicated over tensor,
every parameter on its ``fsdp_dim``); and t5-3b at full depth on 2 and 4
H100s.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from klab_multimodalmodel_tpu.config import Config as JaxConfig
from klab_multimodalmodel_tpu.parallel.partitioning import (
    spec_for_path as jax_spec_for_path)
from klab_multimodalmodel_tpu_torch.checkpoint import from_jax
from klab_multimodalmodel_tpu_torch.config import Config
from klab_multimodalmodel_tpu_torch.models.multimodal import MultiModalModel
from klab_multimodalmodel_tpu_torch.ops.fused_attention import (
    t5_attention_bwd_plain, t5_attention_plain)
from klab_multimodalmodel_tpu_torch.parallel.partitioning import (
    applied_spec, batch_spec, fsdp_dim, make_param_specs, mesh_axis_size,
    per_rank_bytes, spec_for_path)
from klab_multimodalmodel_tpu_torch.train.optim import trainable_names
from klab_multimodalmodel_tpu_torch.utils.mesh import Mesh

MODELS = ["t5-large", "t5-3b", "t5-11b", "google/flan-t5-xxl"]


def _configs(name: str):
    kw = dict(language_model_name=name, transformer_model_name=name,
              max_source_length=64, max_target_length=32)
    return JaxConfig(**kw), Config(**kw)


def _jax_abstract_params(cfg: JaxConfig):
    from klab_multimodalmodel_tpu.models.multimodal import (
        MultiModalModel as JaxModel)

    size = cfg.swin.image_size

    def init(rng):
        return JaxModel(cfg).init(
            rng, jnp.zeros((1, size, size, 3), jnp.float32),
            jnp.zeros((1, 16), jnp.int32), jnp.zeros((1, 4), jnp.int32)
        )["params"]
    return jax.eval_shape(init, jax.random.PRNGKey(0))


def _path(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _tagged_tree(abstract):
    """Each leaf as a zero-copy float32 view of its shape: dim k strides 4
    (k + 1) bytes over a buffer of its own. Returns (tree, buffers) with
    buffers (start address, end address, JAX path, JAX spec, shape)."""
    buffers, keep = [], []

    def tag(path, leaf):
        shape = tuple(leaf.shape)
        strides = tuple(4 * (k + 1) for k in range(len(shape)))
        n = 1 + sum((s - 1) * (k + 1) for k, s in enumerate(shape))
        base = np.zeros(n, np.float32)
        keep.append(base)
        view = np.lib.stride_tricks.as_strided(base, shape, strides)
        start = base.__array_interface__["data"][0]
        p = _path(path)
        buffers.append((start, start + 4 * n, p,
                        tuple(jax_spec_for_path(p, len(shape))), shape))
        return view

    tree = jax.tree_util.tree_map_with_path(tag, abstract)
    return tree, sorted(buffers), keep


def _converted(tree, cfg: Config) -> dict:
    """The port's names for the tagged JAX tree, through the converters
    ``convert_jax_params`` composes (numpy views, no copies)."""
    out = {}
    for prefix, part in (
            ("image_model", from_jax.convert_swinv2(tree["image_model"],
                                                    cfg.swin)),
            ("language_model", from_jax.convert_t5_encoder(
                tree["language_model"], cfg.language_t5)),
            ("transformer", from_jax.convert_t5_lm(tree["transformer"],
                                                   cfg.transformer_t5))):
        out.update({f"{prefix}.{k}": v for k, v in part.items()})
    for name in ("vision_projection", "language_projection"):
        if name in tree:
            out[f"{name}.weight"] = from_jax._t(tree[name]["kernel"])
    return out


def _expected_spec(arr: np.ndarray, buffers) -> tuple:
    """The JAX spec of the leaf ``arr`` views, read through its strides:
    torch dim j carries the spec of JAX dim k where its stride is 4 (k +
    1) (size-1 dims, whose strides a reshape may set, carry None)."""
    addr = arr.__array_interface__["data"][0]
    starts = [b[0] for b in buffers]
    start, end, path, spec, shape = buffers[
        int(np.searchsorted(starts, addr, side="right")) - 1]
    assert start <= addr < end, "a converted tensor is no view of a leaf"
    out = []
    for size, stride in zip(arr.shape, arr.strides):
        k = stride // 4 - 1
        out.append(spec[k] if size > 1 and 0 <= k < len(spec)
                   and shape[k] == size else None)
    return path, tuple(out)


@pytest.mark.parametrize("name", MODELS)
def test_rules_match_jax_spec_for_path(name):
    jcfg, cfg = _configs(name)
    tree, buffers, keep = _tagged_tree(_jax_abstract_params(jcfg))
    converted = _converted(tree, cfg)
    model = MultiModalModel(cfg, device="meta")
    specs = make_param_specs(model)
    assert set(specs) == set(converted)
    sharded = 0
    for pname, p in model.named_parameters():
        arr = converted[pname]
        assert tuple(arr.shape) == tuple(p.shape), pname
        path, want = _expected_spec(arr, buffers)
        assert specs[pname] == want, (pname, path, specs[pname], want)
        sharded += any(a is not None for a in want)
    assert sharded > len(specs) // 2
    del keep


@pytest.mark.parametrize("name,axes,budget_gb", [
    # The JAX test's meshes and budgets (60 % of each chip's memory).
    ("t5-3b", {"data": 1, "fsdp": 2, "tensor": 4}, 16.0),
    ("t5-11b", {"data": 1, "fsdp": 8, "tensor": 4}, 32.0),
    ("google/flan-t5-xxl", {"data": 1, "fsdp": 8, "tensor": 4}, 32.0),
    # t5-3b at full depth (24 + 24 layers) behind the default towers, on 2
    # and 4 H100s (80 GB).
    ("t5-3b-behind-t5-large", {"data": 1, "fsdp": 2, "tensor": 1}, 80.0),
    ("t5-3b-behind-t5-large", {"data": 1, "fsdp": 2, "tensor": 2}, 80.0),
])
def test_per_rank_bytes_fit(name, axes, budget_gb):
    if name == "t5-3b-behind-t5-large":
        cfg = Config(transformer_model_name="t5-3b")
    else:
        cfg = _configs(name)[1]
    model = MultiModalModel(cfg, device="meta")
    trainable = trainable_names(model, cfg)
    shapes = [(n, tuple(p.shape), n in trainable)
              for n, p in model.named_parameters()]
    for n, shape, _ in shapes:
        # Every large tensor is split by at least one axis.
        if math.prod(shape) >= 4 * 1024 * 1024:
            assert any(applied_spec(n, shape, axes)), n
    got = per_rank_bytes(shapes, axes)
    whole = per_rank_bytes(shapes, {})
    ranks = math.prod(axes.values())
    # Sharding divides the trainable state; the replicated Swin tower and
    # the rounding keep it above whole / ranks.
    assert whole["total"] / ranks <= got["total"] < whole["total"]
    print(f"{name} {axes}: {got['total'] / 2**30:.2f} GB per rank "
          f"(unsharded {whole['total'] / 2**30:.2f} GB)")
    assert got["total"] / 2**30 < 0.6 * budget_gb


def test_layout_helpers():
    assert batch_spec() == (("data", "fsdp"),)
    mesh = Mesh(shape=(1, 2, 4, 1, 1, 1),
                axis_names=("data", "fsdp", "tensor", "seq", "pipe",
                            "expert"), group=None, cpu_group=None, rank=6)
    assert mesh_axis_size("tensor", mesh) == 4
    assert mesh_axis_size("tensor") == 1
    assert (mesh.dp_rank, mesh.dp_size, mesh.tensor_rank) == (1, 2, 2)
    q = "transformer.encoder.block.0.layer.0.SelfAttention.q.weight"
    assert spec_for_path(q, 2) == ("tensor", "fsdp")
    assert fsdp_dim(q, (4096, 1024), 2) == 1
    assert fsdp_dim(q, (4096, 1023), 2) == 0  # uneven: dim 0
    norm = "transformer.encoder.final_layer_norm.weight"
    assert spec_for_path(norm, 1) == (None,) and fsdp_dim(norm, (8,), 2) == 0
    swin_q = ("image_model.encoder.layers.0.blocks.0.attention.self."
              "query.weight")
    assert spec_for_path(swin_q, 2) == ("tensor", "fsdp")
    # The Swin tower stays whole over tensor.
    assert applied_spec(swin_q, (128, 128), {"fsdp": 2, "tensor": 4}) == (
        (), ("fsdp",))


@pytest.mark.parametrize("backward", [False, True])
def test_head_offset_gives_the_full_calls_heads(backward):
    """(e) The plain kernel versions on heads 3..5 of 8 with
    ``head_offset`` 3 are the full call's heads 3..5, dropout on."""
    g = torch.Generator().manual_seed(5)
    B, H, Q, K, D, lo, hi, rate = 2, 8, 6, 10, 4, 3, 6, 0.4
    q, k, v, do = (torch.randn(s, generator=g) for s in (
        (B, H, Q, D), (B, H, K, D), (B, H, K, D), (B, H, Q, D)))
    bias = torch.randn(H, Q, K, generator=g)
    mask = torch.ones(B, K, dtype=torch.int32)
    mask[1, 7:] = 0
    seed = torch.tensor([987654321012345], dtype=torch.int64)
    part = [t[:, lo:hi] for t in (q, k, v, do)]
    if not backward:
        full = t5_attention_plain(q, k, v, bias, mask, rate, seed)
        got = t5_attention_plain(*part[:3], bias[lo:hi], mask, rate, seed,
                                 head_offset=lo)
        assert torch.equal(got, full[:, lo:hi])
        unshifted = t5_attention_plain(*part[:3], bias[lo:hi], mask, rate,
                                       seed)
        assert not torch.allclose(unshifted, full[:, lo:hi])
        return
    full = t5_attention_bwd_plain(q, k, v, do, bias, mask, rate, seed, True)
    got = t5_attention_bwd_plain(*part, bias[lo:hi], mask, rate, seed, True,
                                 head_offset=lo)
    for x, w in zip(got[:3], full[:3]):
        assert torch.equal(x, w[:, lo:hi])
    assert torch.equal(got[3], full[3][lo:hi])


@pytest.mark.parametrize("overrides,error,match", [
    (dict(mesh_shape=(1, 2, 1, 2)), None, None),
    (dict(mesh_shape=(1, 1, 2, 2)), None, None),
    (dict(mesh_shape=(1, 2, 2, 2), seq_attention="ring",
          use_pallas_t5_attention=False), None, None),
    (dict(mesh_shape=(1, 2, 1, 1, 2), pipeline_stages=2,
          use_pallas_t5_attention=False), None, None),
    (dict(mesh_shape=(1, 1, 2, 1, 1, 2), moe_experts=2), None, None),
    (dict(mesh_shape=(1, 2, 1), moe_experts=2), None, None),
    (dict(mesh_shape=(1, 1, 1, 2, 1, 2), moe_experts=2), None, None),
    (dict(mesh_shape=(1, 1, 2), pipeline_stages=2,
          use_pallas_t5_attention=False), None, None),
    (dict(mesh_shape=(1, 1, 1, 2, 2), pipeline_stages=2), ValueError,
     "seq mesh axis"),
    (dict(mesh_shape=(1, 1, 3)), ValueError, "divide by the mesh tensor"),
])
def test_sharded_axes_build_as_jax_or_raise_its_errors(overrides, error,
                                                       match):
    """(f) seq with fsdp and tensor, MoE with fsdp, tensor, expert and seq
    (the expert axis beside seq too), and GPipe stages with fsdp or tensor
    (at pipe 1 or equal to the stages), build as the JAX ``Config`` builds
    them; stages with seq raise the JAX package's ValueError; heads that
    do not divide over tensor raise."""
    if error is None:
        import klab_multimodalmodel_tpu.config as jcfg

        assert tuple(Config(**overrides).mesh_shape) == tuple(
            jcfg.Config(**overrides).mesh_shape)
        return
    with pytest.raises(error, match=match):
        Config(**overrides)
    Config(mesh_shape=(1, 2, 2))
    Config(mesh_shape=(2, 1, 1), moe_experts=2)
