"""P2: K1's tile sweep at the GEN3C-7B self-attention shape, on one card.

Port of scripts/sweep_attention.py, which times the Pallas splash kernel
that K1 runs over (block_q, block_kv, block_kv_compute, layouts). Here the
kernel is K1's own forward, ``csrc/attention_wgmma.cu``'s attn_fwd_wgmma,
compiled at each point (``kernels.attention_point``), and the knobs are
the Hopper counterparts of splash's:
  consumer warpgroups, 2 or 3: 128 or 192 queries a CTA (block_q);
  keys per tile, 64 or 128 (block_kv);
  ring stages, 2 to 4 (block_kv against block_kv_compute);
every point whose CTA fits the card (``cuda.fwd_point_fits``: shared
memory within 232,448 bytes, the setmaxnreg split within ptxas's budget).
The layout axis becomes Q/K/V read in the model's (B, L, H, D) strides
("blhd") or from a contiguous (B, H, L, D) copy ("bhld"), for K1's own
point only, as the JAX script sweeps layouts for its production block
sizes only. K1's point is the kernel library's forward; each other point
is built apart, forward only, at first use (``build.forward_only``, all at
once), and its ptxas registers and spills recorded. K1 keeps its
point: the ranking is recorded, not adopted.

Shape: B = 2 (CFG), H = 32, L = 56,320 (16 x 88 x 160 / 4 latent tokens),
D = 128, bf16. Each point is first checked on a small shape (2, 1,000, 4,
128) x 777 keys against the plain attention (bf16 atol 2e-2); K1's point
must give ``kernels.attention``'s bits, and whether every other point does
is recorded (points of 64 keys a tile sum every row as K1 does; 128 keys
reorder the online softmax). Then it is timed with CUDA events (median of
3 after a warm-up). One JSON line per point goes to stdout as it comes,
the ranking to stderr, and the best as the last line {"best", "tflops",
"ms"}.

    python -m gen3c_tpu_torch.scripts.sweep_attention [--quick]

--quick sweeps the points in the model's layout only. It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import torch

B, H, L, D = 2, 32, 56320, 128
FLOPS = 4.0 * B * H * L * L * D  # QK^T + PV
CHECK_SHAPE = ((2, 1000, 4, D), (2, 777, 4, D))
CHECK_ATOL = 2e-2  # bf16 outputs of an fp32 softmax
LAYOUTS = ("blhd", "bhld")
WARPGROUPS = (2, 3)
BLOCK_N = (64, 128)
STAGES = (2, 3, 4)

Point = Tuple[int, int, int]  # (consumer warpgroups, keys per tile, ring stages)
Config = Tuple[Point, str]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def points() -> List[Point]:
    """K1's point, then every other point of the axes that fits a CTA."""
    from gen3c_tpu_torch.kernels.cuda import K1_POINT, fwd_point_fits

    grid = [(wg, bn, st) for wg in WARPGROUPS for bn in BLOCK_N for st in STAGES]
    return [K1_POINT] + [p for p in grid if p != K1_POINT and fwd_point_fits(p, D)]


def configs(quick: bool = False) -> List[Config]:
    """Every point in the model's layout, then K1's point from the (B, H,
    L, D) copy."""
    from gen3c_tpu_torch.kernels.cuda import K1_POINT

    out = [(p, "blhd") for p in points()]
    return out if quick else out + [(K1_POINT, "bhld")]


def tag(config: Config) -> str:
    (wg, bn, st), layout = config
    return f"wg={wg} bm={64 * wg} bn={bn} stages={st} layout={layout}"


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


def build_points(pts: List[Point]) -> dict:
    """Build every point's forward at once (K1's: the kernel library), and
    read each one's ptxas line for the entry P2 runs (attn_fwd_wgmma<128,
    false, false, false>): {point: {"registers", "stack", "spill_stores",
    "spill_loads", "build_s"}}."""
    from gen3c_tpu_torch.kernels import build
    from gen3c_tpu_torch.kernels.cuda import fwd_point_defines
    from gen3c_tpu_torch.scripts.compare_attention_builds import _ptxas_counts

    def one(point):
        defines = fwd_point_defines(point)
        return build.build(**build.forward_only(defines)) if defines else build.build()

    with ThreadPoolExecutor(max_workers=len(pts)) as pool:
        builds = list(pool.map(one, pts))
    out = {}
    for point, info in zip(pts, builds):
        counts = _ptxas_counts(info["log"])
        regs, stack, st, ld = next(v for k, v in counts.items()
                                   if "attn_fwd_wgmmaILi128ELb0ELb0ELb0EE" in k)
        out[point] = {"registers": regs, "stack": stack, "spill_stores": st, "spill_loads": ld,
                      "build_s": info["seconds"]}
    return out


def check(config: Config, gen: torch.Generator) -> dict:
    """The point against the plain attention on CHECK_SHAPE: raises if they
    disagree, or if K1's point is not K1's bits; returns the max abs error
    and whether the point gave K1's bits."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.kernels.cuda import K1_POINT

    point, layout = config
    q, k, v = qkv(*CHECK_SHAPE, layout, gen)
    out = kernels.attention_point(q, k, v, point)
    ref = kernels.attention_reference(q, k, v)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not (err <= CHECK_ATOL and torch.isfinite(out).all()):
        raise AssertionError(f"P2 {tag(config)} disagrees with the plain attention: {err}")
    k1_bits = bool(torch.equal(out, kernels.attention(q, k, v)))
    if point == K1_POINT and not k1_bits:
        raise AssertionError(f"P2 {tag(config)} is not K1's output")
    return {"check_max_abs_err": err, "k1_bits": k1_bits}


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
    """One point timed on the given (B, L, H, D) inputs: ms and TF/s."""
    from gen3c_tpu_torch import kernels

    point, layout = config
    ms = cuda_ms(lambda: kernels.attention_point(q, k, v, point))
    Bq, Lq, Hq, Dq = q.shape
    flop = 4.0 * Bq * Hq * Lq * k.shape[1] * Dq
    return {"config": tag(config), "warpgroups": point[0], "block_m": 64 * point[0],
            "block_n": point[1], "stages": point[2], "layout": layout, "ms": ms,
            "tflops": flop / ms / 1e9}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true", help="the model's layout only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the sweep needs a CUDA card")
    log(f"device: {torch.cuda.get_device_name(0)}")
    todo = configs(args.quick)
    ptxas = build_points(sorted({p for p, _ in todo}))
    gen = torch.Generator(device="cuda").manual_seed(0)
    results, inputs = [], {}
    for config in todo:
        checked = check(config, gen)
        layout = config[1]
        if layout not in inputs:
            inputs.clear()  # one layout's full-size inputs at a time
            inputs[layout] = qkv((B, L, H, D), (B, L, H, D), layout, gen)
        r = {**measure(config, *inputs[layout]), **checked, **ptxas[config[0]]}
        results.append(r)
        print(json.dumps(r), flush=True)
        log(f"  {r['config']}: {r['ms']:.2f} ms = {r['tflops']:.1f} TF/s, {r['registers']} "
            f"registers, spills {r['spill_stores']}/{r['spill_loads']} B")
    results.sort(key=lambda r: r["ms"])
    log("\n== ranking ==")
    for r in results:
        log(f"  {r['tflops']:7.1f} TF/s  {r['ms']:8.2f} ms  {r['config']}")
    best = {"best": results[0]["config"], "tflops": results[0]["tflops"], "ms": results[0]["ms"]}
    print(json.dumps(best), flush=True)
    return best


if __name__ == "__main__":
    main()
