"""Which collectives two ranks that share one card can run, and their cost.

    python -m gen3c_tpu_torch.scripts.probe_collectives [--tokens 56320]

Starts two processes on cuda:0, as chip_smoke.py's ``cp`` phase places its
two ranks, and prints one JSON line:

  nccl       whether NCCL runs an all_reduce between two ranks of one
             communicator on the same GPU, and the error it gives if not
  gloo_cuda  for each op the context-parallel collectives use (all_reduce,
             all_to_all_single, all_gather, broadcast, isend/irecv),
             whether gloo takes CUDA tensors and gives the right values
             ("ok"), or the error or exit it gives instead; each op runs in
             a pair of processes of its own, since gloo handed a device
             pointer it cannot use aborts the process
  staged,    seconds (median of 3 after a warm-up) of the port's own
  gloo_cuda_s  collectives (gen3c_tpu_torch.parallel.collectives) over a
             gloo group on one bf16 (2, tokens/2, 32, 128) shard of the
             GEN3C-7B self-attention (461 MB at 56,320 tokens): seq_to_heads
             (the Ulysses all-to-all), all_gather on the sequence and a
             ring_shift of one tensor, with the shard's GB/s; "staged" with
             every op copied through pinned host memory, "gloo_cuda_s" with
             the CUDA tensors handed to gloo where it takes them
             (collectives.GLOO_CUDA_OPS; the ring shift is staged in both)

Each rank runs in its own subprocess under a time limit, so a collective
that hangs ends the probe instead of the machine. The card's name and power
limit come first, as nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from datetime import timedelta

GLOO_OPS = ("all_reduce", "all_to_all_single", "all_gather", "broadcast", "send_recv")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _init(backend: str, rank: int, port: int) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2, timeout=timedelta(seconds=60))


def _nccl_worker(rank: int, port: int) -> dict:
    import torch
    import torch.distributed as dist

    _init("nccl", rank, port)
    x = torch.ones(1024, device="cuda:0")
    try:
        dist.all_reduce(x)
        torch.cuda.synchronize()
        return {"ok": bool(x[0].item() == 2.0)}
    except Exception as e:  # noqa: BLE001 - the error is the finding
        return {"ok": False, "error": f"{type(e).__name__}: {str(e)[:300]}"}


def _gloo_op_worker(op: str, rank: int, port: int) -> dict:
    """One gloo op on CUDA tensors between the two ranks: "ok" when it ran
    and gave the values the op defines, else what went wrong."""
    import torch
    import torch.distributed as dist

    _init("gloo", rank, port)
    x = torch.arange(64, device="cuda:0", dtype=torch.float32) + 100 * rank
    other = torch.arange(64, device="cuda:0", dtype=torch.float32) + 100 * (1 - rank)
    try:
        if op == "all_reduce":
            got, want = x.clone(), x + other
            dist.all_reduce(got)
        elif op == "all_to_all_single":
            got = torch.empty_like(x)
            dist.all_to_all_single(got, x)  # rank r keeps half r of each rank's x
            halves = [t[rank * 32:(rank + 1) * 32] for t in ((x, other) if rank == 0 else (other, x))]
            want = torch.cat(halves)
        elif op == "all_gather":
            parts = [torch.empty_like(x), torch.empty_like(x)]
            dist.all_gather(parts, x)
            got, want = torch.cat(parts), torch.cat([x, other] if rank == 0 else [other, x])
        elif op == "broadcast":
            got = x.clone()
            dist.broadcast(got, 0)
            want = x if rank == 0 else other
        else:
            got = torch.empty_like(x)
            ops = [dist.P2POp(dist.isend, x, 1 - rank), dist.P2POp(dist.irecv, got, 1 - rank)]
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            want = other
        torch.cuda.synchronize()
        return {"result": "ok" if torch.equal(got, want) else "wrong values"}
    except Exception as e:  # noqa: BLE001 - the error is the finding
        return {"result": f"{type(e).__name__}: {str(e)[:200]}"}


def _gloo_worker(rank: int, port: int, tokens: int) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist

    from gen3c_tpu_torch.parallel import collectives
    from gen3c_tpu_torch.parallel.mesh import make_groups

    _init("gloo", rank, port)
    axis = make_groups(cp=2, backend="gloo").cp
    shard = torch.randn((2, tokens // 2, 32, 128), device="cuda:0").to(torch.bfloat16)
    nbytes = shard.numel() * shard.element_size()
    cases = {"seq_to_heads": lambda: collectives.seq_to_heads(shard, axis),
             "all_gather": lambda: collectives.all_gather(shard, 1, axis),
             "ring_shift": lambda: collectives.ring_shift([shard], axis)}
    native = collectives.GLOO_CUDA_OPS
    out = {"shard_bytes": nbytes, "shard": list(shard.shape)}
    for mode, ops in (("staged", frozenset()), ("gloo_cuda_s", native)):
        collectives.GLOO_CUDA_OPS = ops
        out[mode] = {}
        for name, fn in cases.items():
            times = []
            for i in range(4):
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                if i:
                    times.append(time.perf_counter() - t0)
            s = float(np.median(times))
            out[mode][name] = {"s": s, "shard_gb_per_s": nbytes / s / 1e9}
    collectives.GLOO_CUDA_OPS = native
    return out


def _start(kind: str, extra: list) -> list:
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.getcwd() + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return [subprocess.Popen([sys.executable, "-m", "gen3c_tpu_torch.scripts.probe_collectives",
                              "--worker", kind, "--rank", str(r), "--port", str(port), *extra],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
            for r in range(2)]


def _collect(procs: list, timeout: float) -> dict:
    """Rank 0's JSON line, or how the pair ended without one; both ranks
    are waited for (or killed at the time limit)."""
    t0 = time.perf_counter()
    outs = []
    for proc in procs:
        try:
            outs.append(proc.communicate(timeout=max(1.0, timeout - (time.perf_counter() - t0))))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.wait()
            return {"ok": False, "error": f"timed out after {timeout} s"}
    stdout, stderr = outs[0]
    lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
    if lines:
        return json.loads(lines[-1])
    return {"ok": False, "error": f"rank 0 exited {procs[0].returncode}: {stderr[-300:]}"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tokens", type=int, default=56320)
    p.add_argument("--worker", choices=["nccl", "gloo", "gloo_op"], default=None)
    p.add_argument("--op", choices=GLOO_OPS, default="all_reduce")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--port", type=int, default=0)
    args = p.parse_args(argv)
    if args.worker == "nccl":
        print(json.dumps(_nccl_worker(args.rank, args.port)), flush=True)
        return 0
    if args.worker == "gloo_op":
        print(json.dumps(_gloo_op_worker(args.op, args.rank, args.port)), flush=True)
        return 0
    if args.worker == "gloo":
        print(json.dumps(_gloo_worker(args.rank, args.port, args.tokens)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    # the NCCL pair and one pair per gloo op, all at once
    pairs = {"nccl": _start("nccl", [])}
    pairs.update({op: _start("gloo_op", ["--op", op]) for op in GLOO_OPS})
    found = {name: _collect(procs, 240) for name, procs in pairs.items()}
    res = {"card": smi, "nccl": found.pop("nccl"),
           "gloo_cuda": {op: r.get("result", r.get("error")) for op, r in found.items()}}
    res.update(_collect(_start("gloo", ["--tokens", str(args.tokens)]), 600))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
