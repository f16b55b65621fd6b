#!/usr/bin/env python3
"""Which collectives two processes sharing one CUDA card can run over gloo
(the PyTorch port's phases 10 and 13 put two ranks on one card so: NCCL
refuses two ranks on one device), and how long the large ones take.

    python3 tools/torch_gloo_cuda_probe.py [CASE ...]

Each case (all of ``CASES``, or those named) runs in its own two-rank ``torch.distributed.run`` job (a case
that crashes takes only its job down) and prints one line: ok or the
failure, and the seconds of the timed ones. The cases: the c10d
collectives on CUDA tensors (``all_reduce``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``; the large ones at 256 MB), the sequence-parallel
exchanges at one layer's K/V of a t5-large rank at seq 2 (batch 16, 160 of
320 rows, K and V of 16 heads x 64 side by side in bf16: 10 MB a rank):
``all_gather_into_tensor`` and ``reduce_scatter_tensor`` as the all-gather
path runs them, and the ring's point-to-point exchange
(``batch_isend_irecv`` of a send and a receive, each rank to the other;
then the same staged through host copies, as the ring runs it where gloo
refuses CUDA tensors), each timed over 10 calls after one warm-up, the
pipeline's stage shift at one microbatch of a phase-15c stage (4 rows of
t5-large's encoder, 320 x 1024 in bf16: 2.6 MB), rank 0's ``isend`` to rank
1's ``recv``, direct and staged through host copies as
``parallel/partitioning.py`` ``PipeGroup`` runs it where gloo refuses CUDA
tensors, the functional
collectives behind DTensor (``all_reduce``, ``all_gather_tensor``,
``reduce_scatter_tensor``), and DTensor's ``full_tensor`` and
``distribute_tensor``. Needs a card and the port's torch; no JAX.
"""

import os
import subprocess
import sys
import time

CASES = ("c10d_all_reduce", "c10d_all_gather", "c10d_reduce_scatter",
         "seq_all_gather", "seq_reduce_scatter", "seq_batch_isend_irecv",
         "seq_batch_isend_irecv_host", "pipe_send_recv",
         "pipe_send_recv_host",
         "funcol_all_reduce", "funcol_all_gather", "funcol_reduce_scatter",
         "dtensor_full_tensor", "dtensor_distribute")


def run_case(case: str) -> None:
    """One rank of one case's job."""
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    dist.init_process_group("gloo")
    rank = dist.get_rank()
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    mesh = init_device_mesh("cuda", (2,), mesh_dim_names=("t",))
    x = torch.arange(8, device=dev, dtype=torch.float32) + 10 * rank
    big = torch.ones(64 << 20, device=dev)  # 256 MB of fp32
    timed = None
    if case == "c10d_all_reduce":
        dist.all_reduce(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(big)
        torch.cuda.synchronize()
        timed = ("all_reduce of 256 MB", time.perf_counter() - t0)
    elif case == "c10d_all_gather":
        out = torch.empty(128 << 20, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_gather_into_tensor(out, big)
        torch.cuda.synchronize()
        timed = ("all_gather_into_tensor of 256 MB in, 512 MB out",
                 time.perf_counter() - t0)
    elif case == "c10d_reduce_scatter":
        out = torch.empty(32 << 20, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.reduce_scatter_tensor(out, big)
        torch.cuda.synchronize()
        timed = ("reduce_scatter_tensor of 256 MB in",
                 time.perf_counter() - t0)
    elif case.startswith("seq_"):
        kv = torch.randn(16, 160, 2048, device=dev).to(torch.bfloat16)
        whole = torch.empty(32, 160, 2048, device=dev, dtype=torch.bfloat16)
        peer = 1 - rank

        def once():
            if case == "seq_all_gather":
                dist.all_gather_into_tensor(whole, kv)
            elif case == "seq_reduce_scatter":
                dist.reduce_scatter_tensor(kv, whole)
            else:
                host = case.endswith("_host")
                send = kv.cpu() if host else kv
                recv = torch.empty_like(send)
                for req in dist.batch_isend_irecv(
                        [dist.P2POp(dist.isend, send, peer),
                         dist.P2POp(dist.irecv, recv, peer)]):
                    req.wait()
                if host:
                    recv.to(dev)

        once()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            once()
        torch.cuda.synchronize()
        timed = (f"{case[4:]} of 10 MB a rank (bf16 16x160x2048), "
                 "mean of 10", (time.perf_counter() - t0) / 10)
        if case.startswith("seq_batch_isend_irecv"):
            # What arrives is the peer's tensor.
            at = "cpu" if case.endswith("_host") else dev
            mine = torch.full((4,), float(rank), device=at)
            got = torch.empty(4, device=at)
            for req in dist.batch_isend_irecv(
                    [dist.P2POp(dist.isend, mine, peer),
                     dist.P2POp(dist.irecv, got, peer)]):
                req.wait()
            if got.tolist() != [float(peer)] * 4:
                raise RuntimeError(f"received {got.tolist()}")
    elif case.startswith("pipe_send_recv"):
        host = case.endswith("_host")
        act = torch.randn(4, 320, 1024, device=dev).to(torch.bfloat16)

        def shift(t):
            if rank == 0:
                buf = t.cpu() if host else t
                dist.isend(buf, 1).wait()
                return t
            buf = torch.empty_like(t, device="cpu" if host else dev)
            dist.recv(buf, 0)
            return buf.to(dev)

        shift(act)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            shift(act)
        torch.cuda.synchronize()
        timed = ("stage shift of 2.6 MB (bf16 4x320x1024), rank 0 to 1, "
                 "mean of 10", (time.perf_counter() - t0) / 10)
        # What arrives is rank 0's tensor.
        mine = torch.full((4,), float(rank), device=dev)
        got = shift(mine)
        if rank == 1 and got.tolist() != [0.0] * 4:
            raise RuntimeError(f"received {got.tolist()}")
    elif case == "funcol_all_reduce":
        funcol.all_reduce(x, "sum", mesh).tolist()
    elif case == "funcol_all_gather":
        funcol.all_gather_tensor(x, 0, mesh).tolist()
    elif case == "funcol_reduce_scatter":
        funcol.reduce_scatter_tensor(x, "sum", 0, mesh).tolist()
    elif case == "dtensor_full_tensor":
        DTensor.from_local(x, mesh, [Shard(0)]).full_tensor().tolist()
    elif case == "dtensor_distribute":
        distribute_tensor(torch.arange(8.0, device=dev), mesh,
                          [Shard(0)]).to_local().tolist()
    torch.cuda.synchronize()
    if rank == 0:
        print(f"RESULT {case}: ok" + (f"; {timed[0]}: {timed[1]:.4f} s"
                                      if timed else "")
              + f" (the tensors on {dev})", flush=True)
    dist.destroy_process_group()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for case in sys.argv[1:] or CASES:
        if case not in CASES:
            print(f"unknown case {case!r}; the cases: {', '.join(CASES)}",
                  file=sys.stderr)
            return 2
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2", os.path.abspath(__file__), "--case",
             case], env=env, capture_output=True, text=True, timeout=300)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT")]
        if proc.returncode == 0 and lines:
            print(lines[0].removeprefix("RESULT "), flush=True)
        else:
            crashed = "SIGSEGV" in proc.stdout + proc.stderr
            errors = [ln.strip() for ln in (proc.stdout + proc.stderr)
                      .splitlines() if "Error" in ln
                      and "ChildFailedError" not in ln]
            print(f"{case}: fails (exit {proc.returncode}"
                  + (", a rank crashed with SIGSEGV" if crashed else "")
                  + ")" + (f": {errors[-1][:300]}" if errors else ""),
                  flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--case"]:
        run_case(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
