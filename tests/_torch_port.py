"""Shared set-up of the port's CPU tests: tiny geometries registered in both
packages under the tests' own names, and JAX parameters made from a seed
and converted to the port's state dict."""

import dataclasses

import numpy as np

import jax

import klab_multimodalmodel_tpu.config as jcfg
import klab_multimodalmodel_tpu_torch.config as tcfg

TINY_T5 = dict(d_model=32, d_kv=8, d_ff=64, num_layers=2,
               num_decoder_layers=2, num_heads=4, vocab_size=512,
               relative_attention_num_buckets=8,
               relative_attention_max_distance=16, dropout_rate=0.0)
TINY_T5_V11 = dict(TINY_T5, feed_forward_proj="gated-gelu",
                   tie_word_embeddings=False)
# Final feature dim 16 * 2 = 32 == T5 d_model. Stage 0 (8x8 tokens, window
# 4) has 4 windows per image and a shifted block; stage 1 (4x4) shrinks the
# window to the map and never shifts.
TINY_SWIN = dict(image_size=32, patch_size=4, embed_dim=16, depths=(2, 2),
                 num_heads=(2, 4), window_size=4, drop_path_rate=0.0,
                 pretrained_window_sizes=(0, 0))

T5_NAMES = {"v10": ("t5-torchport-tiny", TINY_T5),
            "v11": ("t5-torchport-tiny-v11", TINY_T5_V11)}
SWIN_NAME = "swin-torchport-tiny"

for _name, _kw in T5_NAMES.values():
    jcfg.register_t5_size(_name, jcfg.T5Size(**_kw))
    tcfg.register_t5_size(_name, tcfg.T5Size(**_kw))
jcfg.register_swin_size(SWIN_NAME, jcfg.SwinV2Size(**TINY_SWIN))
tcfg.register_swin_size(SWIN_NAME, tcfg.SwinV2Size(**TINY_SWIN))


def configs(t5="v10", kernels=True, **overrides):
    """(JAX Config, port Config) for the tiny cascade."""
    name = T5_NAMES[t5][0]
    kw = dict(image_model_name=SWIN_NAME, language_model_name=name,
              transformer_model_name=name, max_source_length=32,
              generate_max_length=8, use_pallas_attention=kernels,
              use_pallas_t5_attention=kernels)
    kw.update(overrides)
    return jcfg.Config(**kw), tcfg.Config(**kw)


def jax_multimodal_params(jax_config, seed=0):
    """Seeded JAX MultiModalModel params as nested dicts of numpy arrays.
    Initialized with the kernel flags off (same tree, no Pallas at init)."""
    from klab_multimodalmodel_tpu.models.multimodal import MultiModalModel

    cfg = dataclasses.replace(jax_config, use_pallas_attention=False,
                              use_pallas_t5_attention=False)
    size = cfg.swin.image_size
    params = jax.jit(MultiModalModel(cfg).init)(  # jitted: eager init is slow
        jax.random.PRNGKey(seed), np.zeros((1, size, size, 3), np.float32),
        np.zeros((1, 16), np.int32), np.zeros((1, 4), np.int32))["params"]
    return jax.tree.map(np.asarray, params)


def jax_train_state(trainer, params):
    """What ``Trainer.init_state`` sets up, on given parameters (nested
    dicts of numpy arrays) and without tracing the model's init: the
    optimizer, a fresh state and the state's shardings on the trainer's
    mesh."""
    import jax.numpy as jnp

    from klab_multimodalmodel_tpu.parallel.partitioning import (
        make_param_specs, make_shardings)
    from klab_multimodalmodel_tpu.train.optim import make_optimizer
    from klab_multimodalmodel_tpu.train.trainer import TrainState

    p = jax.tree.map(jnp.asarray, params)
    trainer.tx = make_optimizer(trainer.config, p, trainer.num_epochs)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=p,
                       opt_state=trainer.tx.init(p))
    trainer.state_specs = make_param_specs(state)
    trainer.state_shardings = make_shardings(trainer.state_specs,
                                             trainer.mesh)
    return state
