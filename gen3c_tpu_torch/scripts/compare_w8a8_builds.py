"""Two versions of the W8A8 kernels (K7, K7q) side by side, on one card.

A change to ``kernels/csrc/w8a8.cu`` that should not change what K7 or K7q
compute (a new body, a new tile order) is held to the version before it:

    python -m gen3c_tpu_torch.scripts.compare_w8a8_builds ptx OLD.cu NEW.cu
        ``compare_attention_builds``' ptx mode: both sources compiled with
        kernels/build.py's flags; per kernel entry whether its PTX is the
        same, and its registers, stack and spill bytes in each version.

    PYTHONPATH=<checkout> python gen3c_tpu_torch/scripts/compare_w8a8_builds.py run TAG
        runs the K7 and K7q of the gen3c_tpu_torch found first on the path
        and prints one JSON line: at the four GEN3C-7B linear shapes (the CFG
        batch's 112,640 tokens: q/k/v/out, fc1, fc2; the 1,024 text tokens
        of the cross-attention k/v) and a ragged one (contiguous, K = 1,000:
        rows no tensor map describes), a hash of K7's int32 accumulators and of its bf16
        output, its bf16 milliseconds and those of ``torch._int_mm`` (the
        library's int8 product, int32 out); at both 7B activation widths
        (4,096 and 16,384 bf16), a hash of K7q's codes and scales and its
        milliseconds; CUDA events around 10 back-to-back calls queued
        behind a device sleep, median of 5 after a warm-up.

Run ``run`` for the old and the new checkout in one call, in the order old,
new, new, old: equal hashes show the same bits (K7's int32 sums are exact
in any order, and the rescale is the same), and the times compare.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

TOKENS = 2 * 56320  # the CFG batch of one 121-frame chunk
GEMM_SHAPES = (("qkv_out", TOKENS, 4096, 4096), ("fc1", TOKENS, 4096, 16384),
               ("fc2", TOKENS, 16384, 4096), ("cross_kv", 2 * 512, 1024, 4096),
               ("ragged", 4099, 1000, 4104))
QUANT_WIDTHS = (4096, 16384)
REPS = 5  # samples, the median kept
LAUNCHES = 10  # back-to-back calls a sample
SLEEP_CYCLES = 40_000_000  # ~20 ms of the card asleep while a sample is queued


def _ms(fn) -> float:
    """Milliseconds of one call of fn on the card: each sample queues
    LAUNCHES calls behind a device sleep and times them with CUDA events,
    so that the host's launch overhead (which exceeds the kernel at the
    1,024-token shape) overlaps the sleep and the events see the card's
    time for back-to-back launches."""
    import torch

    fn()
    times = []
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(LAUNCHES):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / LAUNCHES)
    return sorted(times)[REPS // 2]


def _codes(rows: int, k: int, gen):
    """Seeded contiguous int8 codes in [-127, 127], (rows, k)."""
    import torch

    return torch.randint(-127, 128, (rows, k), generator=gen, device="cuda", dtype=torch.int8)


def run(tag: str) -> dict:
    """K7's and K7q's hashes and times of the gen3c_tpu_torch on the path."""
    import torch

    import gen3c_tpu_torch
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.kernels import cuda
    from gen3c_tpu_torch.scripts.compare_attention_builds import _hash

    kernels.reset_launch_counts()
    res = {"tag": tag, "package": str(Path(gen3c_tpu_torch.__file__).parent)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, M, K, N in GEMM_SHAPES:
        xq, wq = _codes(M, K, gen), _codes(N, K, gen)
        xs = torch.rand(M, generator=gen, device="cuda") * 0.05 + 1e-3
        ws = torch.rand(N, generator=gen, device="cuda") * 0.01 + 1e-4
        res[f"k7_{name}_acc_hash"] = _hash(cuda.int8_gemm(xq, wq, None, None, torch.int32))
        res[f"k7_{name}_bf16_hash"] = _hash(cuda.int8_gemm(xq, wq, xs, ws, torch.bfloat16))
        res[f"k7_{name}_ms"] = _ms(lambda: cuda.int8_gemm(xq, wq, xs, ws, torch.bfloat16))
        if name != "ragged":  # _int_mm takes no K of 1,000
            wt = wq.t()
            res[f"int_mm_{name}_ms"] = _ms(lambda: torch._int_mm(xq, wt))
        del xq, wq, xs, ws
        torch.cuda.empty_cache()
    for k in QUANT_WIDTHS:
        x = torch.randn((TOKENS, k), generator=gen, device="cuda").to(torch.bfloat16)
        x[0] = 0  # a zero token
        res[f"k7q_{k}_hash"] = _hash(*cuda.quantize_rows(x))
        res[f"k7q_{k}_ms"] = _ms(lambda: cuda.quantize_rows(x))
        del x
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    return res


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) == 3 and argv[0] == "ptx":
        from gen3c_tpu_torch.scripts.compare_attention_builds import compare_ptx

        return 0 if compare_ptx(argv[1], argv[2]) else 1
    if len(argv) == 2 and argv[0] == "run":
        run(argv[1])
        return 0
    raise SystemExit(__doc__)


if __name__ == "__main__":
    sys.exit(main())
