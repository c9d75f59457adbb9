"""P2: K1's tile sweep at the GEN3C-7B self-attention shape, on one card.

Port of scripts/sweep_attention.py, which times the Pallas splash kernel
over (block_q, block_kv, block_kv_compute, layouts). Here the knobs are K1's
compile-time tile (``kernels.attention_tiles``, ``csrc/attention.cu``): the
queries per CTA (64 or 128, 16 rows per warp: 4 or 8 warps) and the keys
per K/V tile (32, 64 or 128), every pair whose shared memory, (BM + 2 BN)
(D + 8) 2 bytes, fits the 227 KB of a CTA (``cuda.TILE_CONFIGS``). The
layout axis becomes Q/K/V read in the model's (B, L, H, D) strides
("blhd") or from a contiguous (B, H, L, D) copy ("bhld"), for K1's own
64 x 64 tile only, as the JAX script sweeps layouts for its production
tile only. K1 keeps its tile: the ranking is recorded, not adopted.

Shape: B = 2 (CFG), H = 32, L = 56,320 (16 x 88 x 160 / 4 latent tokens),
D = 128, bf16. Each config is first checked on a small shape (2, 1,000, 4,
128) x 777 keys against the plain attention (bf16 atol 2e-2; K1's own tile
equal to ``kernels.attention`` bit for bit), then timed with CUDA events
(median of 3 after a warm-up). Each result goes to stderr as it comes, then
the ranking; the best prints as one JSON line {"best", "tflops", "ms"} on
stdout.

    python -m gen3c_tpu_torch.scripts.sweep_attention [--quick]

--quick sweeps the tiles in the model's layout only. It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Tuple

import torch

B, H, L, D = 2, 32, 56320, 128
FLOPS = 4.0 * B * H * L * L * D  # QK^T + PV
CHECK_SHAPE = ((2, 1000, 4, D), (2, 777, 4, D))
CHECK_ATOL = 2e-2  # bf16 outputs of an fp32 softmax
LAYOUTS = ("blhd", "bhld")

Config = Tuple[int, int, str]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def configs(quick: bool = False) -> List[Config]:
    """Every tile in the model's layout, then K1's tile from the (B, H, L,
    D) copy."""
    from gen3c_tpu_torch.kernels.cuda import TILE_CONFIGS

    out = [(bm, bn, "blhd") for bm, bn in TILE_CONFIGS]
    return out if quick else out + [(64, 64, "bhld")]


def tag(config: Config) -> str:
    bm, bn, layout = config
    return f"bm={bm} bn={bn} warps={bm // 16} layout={layout}"


def qkv(shape_q, shape_kv, layout: str, gen: torch.Generator):
    """bf16 q, k, v as (B, L, H, D) tensors: contiguous ("blhd") or views of
    contiguous (B, H, L, D) copies ("bhld")."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    out = []
    for shape in (shape_q, shape_kv, shape_kv):
        t = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        out.append(t if layout == "blhd" else t.transpose(1, 2).contiguous().transpose(1, 2))
    return out


def check(config: Config, gen: torch.Generator) -> float:
    """The config against the plain attention on CHECK_SHAPE: raises if they
    disagree (or K1's tile is not K1's bits); returns the max abs error."""
    from gen3c_tpu_torch import kernels

    bm, bn, layout = config
    q, k, v = qkv(*CHECK_SHAPE, layout, gen)
    out = kernels.attention_tiles(q, k, v, bm, bn)
    ref = kernels.attention_reference(q, k, v)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not (err <= CHECK_ATOL and torch.isfinite(out).all()):
        raise AssertionError(f"P2 {tag(config)} disagrees with the plain attention: {err}")
    if (bm, bn) == (64, 64) and not torch.equal(out, kernels.attention(q, k, v)):
        raise AssertionError(f"P2 {tag(config)} is not K1's output")
    return err


def cuda_ms(fn, reps: int = 3) -> float:
    """Median CUDA-event milliseconds of fn() after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def measure(config: Config, q, k, v) -> dict:
    """One config timed on the given (B, L, H, D) inputs: ms and TF/s."""
    from gen3c_tpu_torch import kernels

    bm, bn, _ = config
    ms = cuda_ms(lambda: kernels.attention_tiles(q, k, v, bm, bn))
    Bq, Lq, Hq, Dq = q.shape
    flop = 4.0 * Bq * Hq * Lq * k.shape[1] * Dq
    return {"config": tag(config), "block_m": bm, "block_n": bn, "layout": config[2],
            "ms": ms, "tflops": flop / ms / 1e9}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true", help="tiles only, the model's layout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the sweep needs a CUDA card")
    log(f"device: {torch.cuda.get_device_name(0)}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    results, inputs = [], {}
    for config in configs(args.quick):
        err = check(config, gen)
        layout = config[2]
        if layout not in inputs:
            inputs.clear()  # one layout's full-size inputs at a time
            inputs[layout] = qkv((B, L, H, D), (B, L, H, D), layout, gen)
        r = measure(config, *inputs[layout])
        r["check_max_abs_err"] = err
        results.append(r)
        log(f"  {r['config']}: {r['ms']:.1f} ms = {r['tflops']:.1f} TF/s (check err {err:.2e})")
    results.sort(key=lambda r: r["ms"])
    log("\n== ranking ==")
    for r in results:
        log(f"  {r['tflops']:7.1f} TF/s  {r['ms']:8.1f} ms  {r['config']}")
    best = {"best": results[0]["config"], "tflops": round(results[0]["tflops"], 1),
            "ms": round(results[0]["ms"], 1)}
    print(json.dumps(best), flush=True)
    return best


if __name__ == "__main__":
    main()
