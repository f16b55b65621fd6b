"""MoE under sequence parallelism, against one process: the ring, dropout,
an uneven target, data x seq under DDP and checkpoints, over four gloo
ranks on the CPU.

One torchrun job of 4 ranks runs, one after the other:

* seq 2 x expert 2 (1, 1, 1, 2, 1, 2) on ``--seq_attention ring`` with
  the T5 kernel off: the ring over each seq group, the routing groups
  spanning it;
* the same on the all-gather path with both kernel flags at dropout 0.1:
  the experts' masks are drawn whole at (E, G, C, F), where a seq rank's
  tokens take the slots one process gives them, and every other mask at
  the full length and sliced, so the run equals one process's; it then
  restores a one-process checkpoint;
* seq 2 x expert 2 at a target length (7) that does not divide by seq:
  the decoder runs whole on both seq ranks, routes whole, and only seq
  rank 0 counts its tokens and its balance loss; its checkpoint restores
  bitwise into one process;
* data 2 x seq 2 (2, 1, 1, 2) under DDP: each data rank its rows, the
  balance loss one mean over both data ranks' groups (and not over the
  seq ranks, which hold the same rows).

Each is held against the port's one-process ``Trainer`` on the same rows:
losses, eval losses, parameters and optimizer state within 1e-5 relative;
the ranks of each seq group hold the same parameters, bitwise.
"""

import pytest

import _torch_port as tp
import _torch_split as ts
import klab_multimodalmodel_tpu_torch.config as tcfg
from test_torch_moe_seq import MOE, SEQ_EXPERT
from test_torch_pipe_sharded import assert_held_bytes
from test_torch_seq_sharded import assert_seq_ranks_hold_alike

NPROC = 4
DATA_SEQ = (2, 1, 1, 2)
DROP_T5 = "t5-torchport-tiny-dropout-moe-seq"
tcfg.register_t5_size(DROP_T5, tcfg.T5Size(**dict(tp.TINY_T5,
                                                  dropout_rate=0.1)))
SIZES = dict(t5_sizes={tp.T5_NAMES["v10"][0]: tp.TINY_T5,
                       DROP_T5: dict(tp.TINY_T5, dropout_rate=0.1)},
             swin_sizes={tp.SWIN_NAME: tp.TINY_SWIN})
BASE = dict(kernels=True, compute_dtype="float32", max_target_length=ts.TGT,
            batch_size=ts.B, **MOE)
PORT_RUNS = {"ring_seq2_expert2": dict(seq_attention="ring",
                                       use_pallas_t5_attention=False),
             "dropout_seq2_expert2": dict(transformer_model_name=DROP_T5),
             "target_7": dict(max_target_length=7),
             "data2_seq2": dict(mesh_shape=DATA_SEQ)}
MESHES = {name: kw.get("mesh_shape", SEQ_EXPERT)
          for name, kw in PORT_RUNS.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ts.split_runs(tmp_path_factory.mktemp("moe_seq_options"),
                         SEQ_EXPERT, BASE, {}, PORT_RUNS, SIZES, None,
                         nproc=NPROC)


@pytest.mark.parametrize("name", list(PORT_RUNS))
def test_moe_seq_runs_match_one_process(runs, name):
    """The same rows through one process: losses, eval losses, parameters
    and the optimizer's state within 1e-5 relative (on the ring, at
    dropout 0.1, with the decoder whole on both seq ranks, and over data x
    seq); the seq ranks of each group hold the same parameters, bitwise;
    the ring turned only in its run."""
    ts.assert_matches_one_process(runs, name)
    assert_seq_ranks_hold_alike(runs, name, MESHES[name])
    exchanges = runs["got"][name]["ring_exchanges"]
    assert (exchanges > 0) == (name == "ring_seq2_expert2"), exchanges


def test_moe_seq_checkpoints_restore_in_one_process(runs):
    """The seq 2 x expert 2 run's checkpoint (its decoder whole on both
    seq ranks) restores bitwise into one process, optimizer state
    included: one copy of each expert slice, from seq rank 0; the dropout
    run restored one process's checkpoint bitwise."""
    ts.assert_checkpoints_cross(runs, "target_7", "dropout_seq2_expert2")


def test_moe_seq_ddp_over_data_and_seq(runs):
    """Under data 2 x seq 2 DDP spans all four ranks (the seq ranks too),
    and the seq 2 x expert 2 runs reduce over the two seq ranks of each
    expert slice."""
    got = runs["got"]
    assert got["data2_seq2"]["ddp_ranks"] == 4
    assert got["target_7"]["ddp_ranks"] == 2


@pytest.mark.parametrize("name", [n for n in PORT_RUNS if n != "data2_seq2"])
def test_moe_seq_options_held_bytes_are_the_reckoning(runs, name):
    """Each seq 2 x expert 2 rank holds ``per_rank_bytes``' reckoning: its
    experts' banks and the rest whole."""
    assert_held_bytes(runs, name, MESHES[name])
