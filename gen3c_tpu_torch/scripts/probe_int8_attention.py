"""P1: the card's mma.sync matmul rate, bf16 against int8, by contraction depth.

Port of scripts/probe_int8_attention.py. The Pallas kernel there keeps one
(M, K) x (K, N) tile resident and issues the product R times; here
``kernels.mma_probe`` (``csrc/mma_probe.cu``) does the same on the tensor
cores with ``mma.sync`` m16n8k16 bf16 -> fp32 and m16n8k32 s8 -> s32, the
instruction every kernel of the port is built on. The sweep is the JAX
script's: M = N = 512 at K in {128, 256, 512, 1024}, then the two
attention-block shapes (1408, 128) x (128, 1024) and (1408, 1024) x (1024,
128), with its R.

Each case is first checked against ``mma_probe_reference`` at a small R
(int8 exactly, on small integers so that int32 cannot wrap; bf16 within
1e-5 of R * (|a| + 1) @ |b|), then timed with CUDA events (median of 5
after a warm-up). Printed per case, as one JSON line: the time, the rate
of the function (2 M K N R operations) and the rate the card issued (the
CTAs of a small output compute it several times over, one CTA per SM at
least), against the data-sheet dense peaks (989 TF/s bf16, 1,979 TOPS
int8). Each case is timed with at least 1 and at least 4 CTAs per SM
(``CTAS_PER_SM``): one CTA of four warps per SM leaves each MMA's latency
exposed, so the second is the nearer measure of the instruction's ceiling.
The last line is the JSON list of every case.

    python -m gen3c_tpu_torch.scripts.probe_int8_attention

It needs a CUDA card; it writes nothing but its standard output.
"""

from __future__ import annotations

import json
import sys

import torch

PEAK = {"bf16": 989.0, "int8": 1979.0}  # H100 SXM dense, data sheet (T/s)
SQUARE_K = (128, 256, 512, 1024)
BLOCK_SHAPES = ((1408, 128, 1024, "QK^T"), (1408, 1024, 128, "PV"))
CTAS_PER_SM = (1, 4)  # the least CTAs per SM each case is timed with


def _operands(m: int, k: int, n: int, dtype: str, gen: torch.Generator):
    if dtype == "int8":
        a = torch.randint(-100, 100, (m, k), generator=gen, device="cuda").to(torch.int8)
        b = torch.randint(-100, 100, (k, n), generator=gen, device="cuda").to(torch.int8)
    else:
        a = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        b = torch.randn((k, n), generator=gen, device="cuda").to(torch.bfloat16)
    return a, b


def check(a: torch.Tensor, b: torch.Tensor, reps: int = 3) -> float:
    """The kernel against its plain version at ``reps``: raises if they
    disagree; returns the max abs error."""
    from gen3c_tpu_torch import kernels

    got = kernels.mma_probe(a, b, reps)
    want = kernels.mma_probe_reference(a, b, reps)
    torch.cuda.synchronize()
    err = (got.double() - want.double()).abs()
    if a.dtype == torch.int8:
        ok = torch.equal(got, want)
    else:
        ok = bool((err <= 1e-5 * reps * ((a.float().abs() + 1) @ b.float().abs())).all())
    if not ok:
        raise AssertionError(f"P1 disagrees with its plain version at {tuple(a.shape)} x "
                             f"{tuple(b.shape)} {a.dtype}: max |err| {err.max().item()}")
    return err.max().item()


def _ms(fn, timings: int) -> float:
    """Median CUDA-event milliseconds of fn() over ``timings`` runs."""
    times = []
    for _ in range(timings):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def measure(m: int, k: int, n: int, dtype: str, reps: int, gen: torch.Generator,
            timings: int = 5, plain: bool = False, ctas_per_sm: int = 1) -> dict:
    """One case: checked, then timed (with ``plain``, its plain version at the
    same R too, once). ctas_per_sm > 1 times the kernel with that many CTAs
    per SM at least (``cuda.mma_probe``): more warps to hide each MMA's
    latency."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.kernels import cuda

    a, b = _operands(m, k, n, dtype, gen)
    err = check(a, b)
    _, ctas = cuda.mma_probe(a, b, reps, ctas_per_sm)  # warm-up
    ms = _ms(lambda: kernels.mma_probe(a, b, reps, ctas_per_sm), timings)
    bn = cuda.mma_probe_cols(k, a.element_size())
    ops = 2.0 * m * k * n * reps
    issued = 2.0 * ctas * 64 * bn * k * reps  # every CTA's 64 x bn block, padding included
    res = {"M": m, "K": k, "N": n, "dtype": dtype, "reps": reps, "ctas": ctas,
           "ctas_per_sm": ctas_per_sm,
           "cta_cols": bn, "max_abs_err": err, "ms": ms, "rate": ops / ms / 1e9,
           "issued_rate": issued / ms / 1e9, "peak_share": ops / ms / 1e9 / PEAK[dtype],
           "issued_peak_share": issued / ms / 1e9 / PEAK[dtype]}
    if plain:
        res["plain_ms"] = _ms(lambda: kernels.mma_probe_reference(a, b, reps), 1)
    return res


def main() -> list:
    if not torch.cuda.is_available():
        raise SystemExit("the probe needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    cases = [(512, k, 512, max(2000, int(20000 * 128 / k)), f"square K={k}") for k in SQUARE_K]
    cases += [(m, k, n, max(1000, int(8000 * 128 / k)), tag) for m, k, n, tag in BLOCK_SHAPES]
    for m, k, n, reps, tag in cases:
        for dtype in ("bf16", "int8"):
            for per_sm in CTAS_PER_SM:
                r = measure(m, k, n, dtype, reps, gen, ctas_per_sm=per_sm)
                r["case"] = tag
                print(json.dumps(r), flush=True)
                results.append(r)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
