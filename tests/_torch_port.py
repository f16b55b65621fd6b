"""Shared set-up of the port's CPU tests: tiny geometries registered in both
packages under the tests' own names, and JAX parameters made from a seed
and converted to the port's state dict."""

import contextlib
import dataclasses

import numpy as np
import torch

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

# One intra-op thread: xdist runs several test processes at once, and
# torch's default of a thread per core in each of them (the torchrun jobs'
# ranks run on one already) oversubscribes the host's cores.
DEFAULT_THREADS = torch.get_num_threads()
torch.set_num_threads(1)


@contextlib.contextmanager
def torch_threads(n: int):
    """torch's intra-op thread count set to ``n`` inside the block."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)

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


def jax_native():
    """The JAX package's ``native`` module with its library loaded whole.

    Its ``load_library`` runs ``make`` in place when the library is
    missing and latches None for the rest of the process if ``ctypes``
    fails, as it does on a file that another test process is still
    writing. Here the build runs under a file lock, into a temporary file
    moved into place with ``os.replace``, and the library is loaded only
    once a ``dlopen`` of it succeeds; a file left half-written by a build
    outside the lock is built again."""
    import ctypes
    import fcntl
    import os
    import subprocess

    import klab_multimodalmodel_tpu.native as jnative

    if jnative._lib is not None:
        return jnative
    path = jnative._LIB_PATH
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            ctypes.CDLL(path)
        except OSError:
            tmp = f"{path}.{os.getpid()}.tmp"
            subprocess.run(["make", "-C", jnative._NATIVE_DIR,
                            f"TARGET={os.path.basename(tmp)}"], check=True,
                           capture_output=True, timeout=300)
            os.replace(tmp, path)
        jnative._load_attempted = False
        if jnative.load_library() is None:
            raise RuntimeError(f"{path}: built, but ctypes cannot load it")
    return jnative


def jax_t5_lm(name="v11", seed=3, src=6, eos_scale=1.0):
    """(JAX T5ForConditionalGeneration, its seeded params as numpy, the
    port's model on the CPU with the same weights) of a tiny T5 LM. With
    the untied head ('v11'), ``eos_scale`` scales the eos column so that
    rows finish at varied steps."""
    import torch

    import klab_multimodalmodel_tpu.models.t5 as jt5
    from klab_multimodalmodel_tpu_torch.checkpoint.from_jax import (
        convert_t5_lm)
    from klab_multimodalmodel_tpu_torch.models import t5 as tt5

    kw = T5_NAMES[name][1]
    jmodel = jt5.T5ForConditionalGeneration(jcfg.T5Size(**kw))
    ids = np.zeros((1, src), np.int32)
    params = jax.tree.map(np.array, jax.jit(jmodel.init)(
        jax.random.PRNGKey(seed), ids, decoder_input_ids=ids)["params"])
    if eos_scale != 1.0:
        params["lm_head"]["kernel"][:, 1] *= eos_scale
    size = tcfg.T5Size(**kw)
    model = tt5.T5ForConditionalGeneration(size, device="cpu")
    model.load_state_dict({k: torch.tensor(v) for k, v in convert_t5_lm(
        params, size).items()}, strict=True)
    return jmodel, params, model.eval()


def first_difference_margin(model, enc, mask, got, want):
    """Where token rows ``got`` and ``want`` (1-D, from the same encoder
    row) first differ: (position, top-1 minus top-2 logit of the port's
    teacher-forced pass that chose it, relative to the top-1's size). None
    when they are equal. A greedy choice between two tokens whose logits
    are this close is a knife edge: fp32 rounding of another batch shape
    may flip it."""
    import torch

    got, want = np.asarray(got), np.asarray(want)
    diff = np.flatnonzero(got != want)
    if diff.size == 0:
        return None
    s = int(diff[0])
    L = len(want)
    tokens = torch.as_tensor(want[None, :s]).to(torch.int32)
    with torch.inference_mode():
        logits = None
        cache = None
        for t in range(s):
            logits, cache = model.decode_step(tokens[:, t:t + 1], t, enc,
                                              L, mask, cache=cache)
        top2 = logits[0, -1].float().topk(2).values
    margin = float(top2[0] - top2[1]) / max(abs(float(top2[0])), 1e-30)
    print(f"rows differ first at {s}: relative top-2 margin {margin:.3e}")
    return s, margin


def port_cascade_state(t5="v10", seed=0, **overrides):
    """(port Config, seeded port MultiModalModel state dict on the CPU):
    for tests of the port alone."""
    import torch

    from klab_multimodalmodel_tpu_torch.models.multimodal import (
        MultiModalModel)

    _, cfg = configs(t5, **overrides)
    model = MultiModalModel(cfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(seed))
    return cfg, model.state_dict()


def png_bytes(rng, size=32) -> bytes:
    """A seeded RGB image encoded as PNG (Pillow)."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
                    ).save(buf, format="PNG")
    return buf.getvalue()


HTTP_WAIT = 30  # seconds: the bound on a test's HTTP call


def http_get(base: str, path: str):
    """(status, JSON body) of a GET."""
    import json
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(base + path, timeout=HTTP_WAIT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def http_post(base: str, path: str, payload: dict, raw: bool = False):
    """(status, JSON body, or the raw bytes with ``raw``) of a JSON POST."""
    import json
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=HTTP_WAIT) as r:
            body = r.read()
            return r.status, (body if raw else json.loads(body))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def sse_events(body: bytes) -> list:
    """The JSON payloads of a server-sent-events body."""
    import json

    return [json.loads(chunk[len(b"data: "):])
            for chunk in body.split(b"\n\n") if chunk.startswith(b"data: ")]


def run_threads(targets, timeout: float = HTTP_WAIT) -> None:
    """Start a thread per callable, join each with a timeout, and fail if
    one is still running."""
    import threading

    threads = [threading.Thread(target=t) for t in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
        assert not t.is_alive(), "a thread hung"
