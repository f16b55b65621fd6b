"""The GPipe schedule's written-out backward under FSDP2, alone: a
pipelined T5 decoder stack (4 blocks, 2 stages, 2 microbatches) over four
gloo ranks on the CPU, mesh (1, 2, 1, 1, 2, 1): the stages split over
pipe 2, and every block the rank holds and the relative-position table an
FSDP2 unit of its two fsdp ranks, each of which runs its half of the rows.

The forward reads FSDP2's unsharded parameters, which autograd does not
link to the sharded ones, so the backward must let FSDP2 see each
microbatch's gradients and reduce-scatter them once. Held against the same
stack in one process (both stages in tick order, the whole batch), at
dropout 0 and at dropout 0.1 with one generator seed on every rank (each
rank keeps its rows of one process's masks): every trainable shard has a
gradient (none None, none zero where one process's is not), the gathered
gradients and the inputs' gradients equal one process's within 1e-5
relative, and every unit holds only its shards after the step.
"""

import pytest
import torch

import _torch_port as tp
from _torch_ddp_worker import Job
from klab_multimodalmodel_tpu_torch.config import T5Size
from klab_multimodalmodel_tpu_torch.models.t5 import T5Stack
from test_torch_sharded import WORKER

LAYOUT = (1, 2, 1, 1, 2, 1)
SIZE = dict(tp.TINY_T5, dropout_rate=0.1)
LAYERS, MICRO = 4, 2
B, L, LE = 8, 8, 12
TOL = 1e-5
RATES = (0.0, 0.1)


def make_inputs(seed: int = 0) -> tuple[T5Stack, dict]:
    """A seeded stack and its seeded inputs: rows of padded keys, an
    encoder output, and the output's cotangent."""
    g = torch.Generator().manual_seed(seed)
    stack = T5Stack(T5Size(**SIZE), LAYERS, True, pipeline_stages=2,
                    pipeline_microbatches=MICRO)
    stack.init_weights(g)
    D = SIZE["d_model"]
    kmask = torch.ones(B, L, dtype=torch.int32)
    kmask[1, 5:] = 0
    cross = torch.ones(B, LE, dtype=torch.int32)
    cross[6, 7:] = 0
    return stack, dict(size=SIZE, layers=LAYERS, microbatches=MICRO,
                       state=stack.state_dict(),
                       x=torch.randn(B, L, D, generator=g),
                       enc_out=torch.randn(B, LE, D, generator=g),
                       kmask=kmask, cross_kmask=cross,
                       ct=torch.randn(B, L, D, generator=g), seed=5)


def one_process(stack: T5Stack, x: dict, rate: float) -> dict:
    """The gradients of the whole batch through one process's ticks."""
    stack.zero_grad(set_to_none=True)
    inp = x["x"].clone().requires_grad_()
    enc = x["enc_out"].clone().requires_grad_()
    gen = torch.Generator().manual_seed(x["seed"])
    y = stack(inp, head_bias=stack.position_bias(L, causal=True),
              kmask=x["kmask"], enc_out=enc, cross_kmask=x["cross_kmask"],
              deterministic=rate == 0, generator=gen)
    (y * x["ct"]).sum().backward()
    return dict(grads={n: p.grad.clone() for n, p in stack.named_parameters()},
                x_grad=inp.grad, enc_grad=enc.grad)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipe_fsdp_backward")
    stack, inputs = make_inputs()
    spec = []
    for rate in RATES:
        path = root / f"inputs_{rate}.pt"
        torch.save(dict(inputs, rate=rate), path)
        spec.append(dict(stack=True, inputs=str(path), layout=LAYOUT,
                         out=str(root / f"rate_{rate}.{{rank}}.pt")))
    job = Job(root, spec, dict(t5_sizes={}, swin_sizes={}), nproc=4,
              script=WORKER)
    ones = {rate: one_process(stack, inputs, rate) for rate in RATES}
    job.wait()
    got = {rate: [torch.load(run["out"].format(rank=r)) for r in range(4)]
           for rate, run in zip(RATES, spec)}
    return ones, got


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / want.norm().clamp(min=1e-12))


@pytest.mark.parametrize("rate", RATES)
def test_every_shard_gets_its_gradient(runs, rate):
    """Every trainable parameter a rank holds (its stage's blocks and the
    table) has a gradient: its shard is the rank's part of one process's
    gradient (over the fsdp ranks' mean), none None and none zero where
    one process's is not; the whole gradient, gathered, is one process's
    within 1e-5 relative; a rank holds its stage's blocks only."""
    ones, got = runs
    # FSDP2 averages over the fsdp ranks (the Trainer scales each rank's
    # loss by their count): each rank's loss here is its rows' sum.
    want = {n: g / LAYOUT[1] for n, g in ones[rate]["grads"].items()}
    for r, out in enumerate(got[rate]):
        assert out["grads"], r
        fsdp_rank = r // LAYOUT[4]
        for name, g in out["grads"].items():
            assert g is not None and out["local"][name] is not None, (r, name)
            assert rel(g, want[name]) <= TOL, (r, name, rel(g, want[name]))
            # FSDP2's default: dim 0 in torch.chunk's pieces.
            shard = want[name].chunk(LAYOUT[1])[fsdp_rank]
            local = out["local"][name]
            assert local.shape == shard.shape, (r, name)
            assert rel(local, shard) <= TOL, (r, name)
            assert bool(local.any()) == bool(shard.any()), (r, name)
        held = {n for n in out["grads"] if n.startswith("block.")
                and "relative_attention_bias" not in n}
        stage = {int(n.split(".")[1]) // 2 for n in held}
        assert stage == {r % 2}, (r, stage)


@pytest.mark.parametrize("rate", RATES)
def test_inputs_gradients_are_one_process(runs, rate):
    """The gradients of each rank's rows of the stack's input and of the
    encoder output (summed over the pipe group) are one process's rows."""
    ones, got = runs
    for r, out in enumerate(got[rate]):
        lo, n = out["rows"]
        for key in ("x_grad", "enc_grad"):
            assert rel(out[key], ones[rate][key][lo:lo + n]) <= TOL, (r, key)


@pytest.mark.parametrize("rate", RATES)
def test_every_unit_ends_resharded(runs, rate):
    """After the step every FSDP2 unit (the rank's blocks and the table)
    holds only its shards: FSDP2 resharded each after its backward."""
    _, got = runs
    for r, out in enumerate(got[rate]):
        assert out["sharded"] and all(out["sharded"].values()), (r, out[
            "sharded"])
