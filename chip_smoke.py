#!/usr/bin/env python3
"""Smoke run of gen3c_tpu_torch on one NVIDIA GPU (H100 class).

    python3 chip_smoke.py            # every phase, one card

Phases, each printing one JSON line of its own numbers:
  1 device   the card's name and power limit (nvidia-smi), torch/CUDA versions
  2 build    compile the CUDA kernels from gen3c_tpu_torch/kernels/csrc
  3 kernels  each kernel against its plain PyTorch version at the main
             paths' shapes: max/mean abs error, kernel and reference ms
             (CUDA events, median after a warm-up), attention TF/s; K3
             (band attention) also its visited key tiles and agreement
             with K1 at a full window; K7q/K7 (W8A8) exact codes at both
             activation widths, int32 accumulators and outputs at the four
             7B shapes and a ragged one (K = 1,000: codes copied into
             16-byte rows), TOPS, torch._int_mm and cuBLAS bf16 at the shape
  4 main     GEN3C-7B at full width (28 blocks x 4096, 32 x 128 heads,
             bf16, random weights from seed 0) generating one 121-frame
             704x1280 chunk through run_chunked_generation with MAIN_STEPS
             Euler steps and batched CFG; seconds per phase, peak memory,
             and the launches of each kernel in that run
  5 fast     the same model and chunk with the --perf_preset fast knobs:
             W8A8 (quantized on the card), band window 2, step-cache
             interval 2, guidance interval 1.75..81, 8 steps: the asserted
             CFG/condition-only and refresh/cached step pattern, seconds
             per step by kind, quantize seconds, peak memory, launches
  6 fast_parity  a 1024-channel, 2-block bf16 DiT with W8A8 and band
             window 1 over 5 latent frames, on the card (kernels) and on
             the CPU (plain versions) with the same weights
  7 chain    the tiny preset chaining two chunks (17 frames) on the card:
             update_cache (non-rigid Adam fit), re-render and the kernels
             between chunks; the first chunk is compared with the same
             model run on the CPU through the plain versions
  8 train    train_step at GEN3C-7B width (4096 channels, 32 x 128 heads,
             bf16, 12 of 28 blocks, gates randomized) on one 121-frame
             704x1280 clip (56,320 tokens, 512 text tokens), B=1, remat,
             TrainerConfig's optimizer defaults, TRAIN_STEPS steps: s per step, loss
             and grad-norm per step, state GiB reckoned and measured, peak
             GiB, and the launches of K1, K2 and K4
  9 lora_band_train  LoRA fine-tuning of the full 28-block GEN3C-7B (bf16,
             random base from seed 0, gates randomized) with the fast
             preset's band (window 2, prefix 1): the batch from
             build_gen3c_train_batch on a seeded 121-frame 704x1280 RGBD
             clip (7B VAE, K5), then LORA_STEPS lora_train_steps (rank 16 on the
             attention projections, remat): s per step, loss, grad-norm,
             peak GiB, base and adapter GiB reckoned and measured, launches
             per step (K4band 28, K3lse 56, K2 56, K4 28, K1 0), and the base
             bitwise unchanged
 10 train_parity  one train_step of a 1024-channel, 2-block bf16 DiT on the
             card (kernels) and on the CPU (plain versions) with the same
             weights and draws: loss, grad-norm, each grad leaf's error
 11 band_train_parity  the same with band window 1 (K4-band on the card)
 12 train_cli the training CLI (gen3c_tiny, fp32, remat) for 4 steps with
             checkpoints, then resumed to 6, then 2 steps with --data_root on
             a packaged clip and band window 1
 13 dynamic  the gen3c_dynamic CLI's entry point with the same 7B (built once
             for main, dynamic and multiview) on a seeded 121-frame 704x1280
             packaged clip whose depth has nearer discs and a railing (depth
             boundaries), --foreground_masking, DYNAMIC_STEPS Euler steps: render s with
             and without masking, K6 launches (121), the culled fraction,
             s per denoise step, peak GiB
 14 multiview the gen3c_multiview CLI's entry point, same 7B, 4 key frames,
             --frame_buffer_max 2, --foreground_masking, 1 chunk, 1 step: the
             buffers each chunk kept, render s, launches
 15 cp       context- and CFG-parallel denoising: CP_RANKS processes on the
             one card, each a rank (torchrun's environment, gloo: NCCL
             refuses two ranks of a communicator on one GPU) that builds
             the 7B from main_path's seeds through build_gen3c_model and runs
             main_path's chunk through its entry point: Ulysses over all
             28 blocks, held to main_path's latent, then ring, all-gather
             and cfg2 at CP_SHORT_BLOCKS blocks, held to the single process
             at that depth within CP_NOISE_FACTOR times the bf16 noise floor
             measured there (the single process with its CFG pair as two
             B = 1 calls), not below CP_TOL; per rank s per step, the bytes each
             collective moved, peak GiB and launches (K1cp, K1ring +
             K1merge, K1ag). The ranks share the card and their collectives
             pass through host memory: none of these is a multi-card time
Every bf16 attention case of phase 3 also prints its launches by body
(kernels.route_counts: wgmma or mma_sync), its share of its bound, and the
registers, stack and spill bytes (ptxas -v, the build log) and dynamic
shared memory of the attention_wgmma.cu entries it ran; phase 2 lists every
such entry and fails if one spills. Every 7B-shape call of the attention
family, and main, train, lora_band_train and cp, must run the wgmma body
only. K4's cases also hold two backward calls to the same bits. At the 7B
self shape the mma.sync bodies, which serve the bf16 inputs no TMA map
describes, are held too: the same values at a base off 16-byte alignment
through K1's forward, the forward with lse, a ring step and the backward,
against the same plain versions, counted apart from K4's routes.
Phase 3 also holds K4 (the attention backward) and its forward with the
row logsumexp at the 7B self- and cross-attention shapes and at a ragged
fp32 tiny shape; K4-band at the 7B self shape with the fast preset's band
(its visited-tile fractions, its forward against K3's bits), at a full
window against K4's bits and at a ragged fp32 shape; K3lse, the band
forward with the row logsumexp, at the LoRA + band shape; P1, the mma.sync
rate probe, in bf16 and int8; K5 (the splat) on a smooth flow, uniformly
random targets and NaN / +inf depths (the plain version's NaN pixels), and
forward_warp's depth splat (C = 1) on the smooth and the random flow, its
three kernels timed apart beside the parent's torch passes and its corners
merged across lanes counted; K6 (the ray-triangle depth) on the 901,120
rays of a 704x1280 frame against the boundary mesh of a seeded depth (~19k
triangles) and of a dense one (~112k), the plain version's bits (its setup
kernel's too), the triangles it cannot cull, the
pairs its tiles keep and those the bound counts (a per-ray footprint), its
setup and kernel timed apart; and P2, K1's tile sweep, at the 7B self-attention
shape over K1's tile and three others; and the context-parallel kernels
at the 7B shard shapes: K1cp (K1, or K3 under the band, on a Ulysses
rank's 32/cp heads read in place from the all-to-all's layout) at cp 2, 4
and 8 against K1's output sliced, K1ag (a 28,160-query shard over the
gathered 56,320 keys), and K1ring + K1merge (every rank's ring over its
KV shards) at cp 2 and 4, with and without the band, against K1 or K3 on
the whole sequence and the plain ring, the folded steps against the
band's visible frame pairs. Every kernel's bound (bytes or operations at
the data-sheet peaks) and the time of one PyTorch call that computes its
function, where there is one, go beside its time. Then the kernel table as
one JSON line, the nvidia-smi line, and as the last line {"ok": true,
"device": {...}}. Any failure raises: the script exits non-zero and prints
no last line. There is no CPU fallback.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

OUT_DIR = "outputs"
ATTN_TOL = {"max": 2e-2, "mean": 2e-3}  # bf16 output, fp32 softmax, 56k-key sums
ATTN_F32_TOL = 1e-4
SPLAT_TOL = 1e-4  # fp32 sums whose order the atomics change
SPLAT_MASK_AGREE = 0.999  # a pixel whose only weight is ~1e-7 may flip known/unknown
# both bf16, the card through the kernels and the CPU through the plain
# versions, each rounding in its own places, and W8A8 activation codes at a
# rounding boundary may take the neighbouring code: twice the bf16
# port-vs-JAX DiT tolerance (3e-2 / 3e-3 at a mean |out| of 0.8), taken
# relative to the mean |out| of the net under test
FAST_PARITY_TOL = {"max": 6e-2 / 0.8, "mean": 6e-3 / 0.8}
INT8_PEAK_TOPS = 1979.0  # H100 SXM dense int8 (data sheet)
BAND_7B = (44 * 80, 2, 1)  # tokens per latent frame, window, prefix frames
LATENT_T_7B = 16
# K4 against an fp32 truth (the plain backward in fp32 at the same bf16
# inputs): no further from it than the plain bf16 version (which also rounds
# the logits and dO.V^T to bf16) plus a margin, relative to mean |truth|
K4_TOL = {"max_margin": 1e-2, "mean_margin": 1e-3}
K4_F32_TOL = 1e-4  # relative to mean |plain|, fp32 on both sides
TRAIN_BLOCKS_7B = 12  # of 28: the state (12 bytes a parameter) must fit 80 GB
# card (kernels) against CPU (plain versions), both bf16, per gradient leaf:
# mean |delta| / mean |cpu| and max |delta| / max |cpu|; loss and grad-norm
# relative (set before the first run, PERF.md)
TRAIN_PARITY_TOL = {"loss": 1e-2, "grad_norm": 2e-2, "leaf_mean": 5e-2, "leaf_max": 0.1}
BF16_PEAK_TFLOPS = 989.0  # H100 SXM dense bf16 (data sheet)
FP32_PEAK_TFLOPS = 67.0  # H100 SXM fp32 outside the tensor cores (data sheet)
HBM_TB_PER_S = 3.35  # H100 SXM HBM3 (data sheet)
LORA_RANK = 16
LORA_STEPS = 2
P1_SHAPE = (1408, 128, 1024)  # the QK^T block shape of scripts/probe_int8_attention.py
P1_REPS = 8000  # that script's R at K = 128
# K6 against its plain version (the same operations in the same order, no
# contraction): hit decisions may flip on at most 1e-4 of the rays, and hit
# distances both report agree within 1e-5 relative
K6_TOL = {"flip_fraction": 1e-4, "rel_err": 1e-5}
# per (ray, triangle) pair: 29 fp32 arithmetic operations (cross 9, a 5,
# reciprocal 1, u 6, v 6, t 1, u + v 1) and 7 comparisons (raycast.cu)
K6_OPS_PER_PAIR = 36
# _foreground_depth's dense scene: the boundary covers the whole frame, so
# the mesh holds every quad of the 1/4-resolution grid (111,650 triangles)
K6_DENSE_SCENE = {"discs": 64, "bars": 128, "bar_top": 0.0}
# P2 in the smoke: K1's own tile, two larger tiles and K1's tile read from the
# (B, H, L, D) layout (the script sweeps them all)
P2_SMOKE_CONFIGS = ((64, 64, "blhd"), (128, 64, "blhd"), (64, 128, "blhd"), (64, 64, "bhld"))
DYNAMIC_STEPS = 1
MULTIVIEW_STEPS = 1
MULTIVIEW_KEY_FRAMES = 4
MAIN_STEPS = 1  # main_path's Euler steps; its latent is the cp phase's reference
TRAIN_STEPS = 1
CP_SIZES = (2, 4, 8)  # K1cp's shard shapes: (2, 56,320, 32 / cp, 128)
RING_CP_SIZES = (2, 4)  # K1ring's: (2, 56,320 / cp, 32, 128), cp = 2 the cp phase's
CP_RANKS = 2  # the cp phase: two ranks on the one card
CP_SHORT_BLOCKS = 4  # of 28: the depth of the ring, all-gather and cfg2 runs
# a rank's latent against the single process's, relative to mean
# |reference|: both are bf16 7B forwards, but each rank's linears run on half
# the rows (cuBLAS tiles them otherwise, and bf16 rounds each output), so
# the bound is CP_NOISE_FACTOR times the bf16 noise floor measured in the
# same run (the single process with its CFG pair as two B = 1 calls, the
# same halving with no parallel code; phase_cp_reference), and never below
# CP_TOL. A wrong shard, position or combine moves the latent by O(1)
CP_TOL = {"max": 0.1, "mean": 0.01}
CP_NOISE_FACTOR = 2.0
CP_TIMEOUT_S = 700  # the cp phase's two ranks, together
# the share of the card each rank's caching allocator may hold: each peaks at
# ~31 GiB allocated (the 7B and the VAE's 121-frame activations, as main_path),
# and memory one rank's allocator keeps cached is lost to the other, so
# without a cap the two reserve more than the card has
CP_MEMORY_FRACTION = 0.45


def emit(phase: str, **numbers) -> None:
    print(json.dumps({"phase": phase, **numbers}), flush=True)


def bound(nbytes: float, ops: float, peak_tops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the peak rate of their type."""
    t_bytes = nbytes / (HBM_TB_PER_S * 1e12) * 1e3
    t_ops = ops / (peak_tops * 1e12) * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes > t_ops else "operations"}


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def library_ms(fn, reps: int = 3):
    """cuda_ms of one PyTorch call that computes a kernel's function (its
    yardstick; the port never calls it), or None where the card cannot
    hold it."""
    try:
        return cuda_ms(fn, reps=reps)
    except torch.OutOfMemoryError:
        torch.cuda.empty_cache()
        return None


def _sdpa(q, k, v, mask=None):
    """F.scaled_dot_product_attention in the kernels' (B, L, H, D) layout."""
    import torch.nn.functional as F

    out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                         attn_mask=mask)
    return out.transpose(1, 2)


def _band_mask(L: int, band) -> torch.Tensor:
    """The dense (L, L) boolean band mask, built from its (T, T) frame mask
    (no (L, L) temporaries beside it)."""
    hw, window, prefix = band
    f = torch.arange(L, device="cuda") // hw
    t = torch.arange(int(f[-1]) + 1, device="cuda")
    frames = ((t[:, None] - t[None, :]).abs() <= window) | (t[None, :] < prefix)
    return frames[f][:, f]


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_times(fn, reps: int = 3, warmup: int = 1) -> list:
    """Milliseconds of each of reps calls of fn() on the current stream
    (CUDA events), after warmup calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def cuda_ms(fn, reps: int = 3, warmup: int = 1) -> float:
    """Median milliseconds of fn() on the current stream (CUDA events)."""
    return float(np.median(cuda_times(fn, reps, warmup)))


def _ptxas() -> dict:
    """{kernel entry: (registers, stack, spill-store, spill-load bytes)} from
    ptxas -v in the kernel build's log."""
    from gen3c_tpu_torch.kernels import build
    from gen3c_tpu_torch.scripts.compare_attention_builds import _ptxas_counts

    return _ptxas_counts(build.build()["log"])


def wgmma_entries(kind: str, d: int, band: bool, lse: bool = False) -> dict:
    """The attention_wgmma.cu entries one call launches ("fwd": the forward,
    "bwd": Delta, dK/dV and dQ) at head dim d: registers, stack and spill
    bytes from the build log, and the dynamic shared memory they ask for."""
    from gen3c_tpu_torch.kernels import cuda

    dp = 64 if d <= 64 else 128
    smem = cuda.wgmma_smem_bytes(d)
    b = f"Lb{int(band)}E"
    if kind == "fwd":
        want = {f"attn_fwd_wgmma<{dp},{int(band)},{int(lse)}>":
                (f"attn_fwd_wgmmaILi{dp}E{b}Lb{int(lse)}EE", smem["fwd"])}
    else:
        want = {f"attn_bwd_dkdv_wgmma<{dp},{int(band)}>": (f"attn_bwd_dkdv_wgmmaILi{dp}E{b}E",
                                                          smem["dkdv"]),
                f"attn_bwd_dq_wgmma<{dp},{int(band)}>": (f"attn_bwd_dq_wgmmaILi{dp}E{b}E",
                                                        smem["dq"]),
                "attn_bwd_delta_wgmma": ("attn_bwd_delta_wgmma", 0)}
    counts = _ptxas()
    out = {}
    for name, (pattern, dynamic) in want.items():
        regs, stack, spill_st, spill_ld = next(v for k, v in counts.items() if pattern in k)
        out[name] = {"registers": regs, "stack": stack, "spill_stores": spill_st,
                     "spill_loads": spill_ld, "smem_dynamic": dynamic}
    return out


def route_delta(before: dict) -> dict:
    """The bf16 attention family's launches per body since ``before``."""
    from gen3c_tpu_torch import kernels

    return {k: kernels.route_counts[k] - before[k] for k in before}


def require_wgmma(name: str, routes: dict) -> None:
    """Every launch of the family went to the wgmma body, and one did."""
    if routes["mma_sync"] or not routes["wgmma"]:
        raise AssertionError(f"{name}: attention launches by body {routes}, expected wgmma only")


# ----------------------------------------------------------------------------


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke run needs a GPU")
    smi = nvidia_smi_line()
    print(smi, flush=True)
    info = {
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "capability": list(torch.cuda.get_device_capability(0)),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "ninja": shutil.which("ninja"),
        "nvcc": shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"),
    }
    emit("device", **info)
    return info


def phase_build() -> None:
    from gen3c_tpu_torch.kernels import build, cuda

    info = build.build()
    cuda.library()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "kernel_build.log"), "w") as f:
        f.write(info["log"])
    wgmma = {k: v for k, v in _ptxas().items() if "_wgmma" in k}
    emit("build", seconds=round(info["seconds"], 3), cached=info["cached"], library=info["path"],
         wgmma_entries={k: {"registers": v[0], "stack": v[1], "spill_stores": v[2],
                            "spill_loads": v[3]} for k, v in wgmma.items()})
    spilled = [k for k, v in wgmma.items() if v[2] or v[3]]
    if len(wgmma) < 17 or spilled:
        raise AssertionError(f"attention_wgmma.cu: {len(wgmma)} entries, spilling: {spilled}")


def _attention_case(name, shape_q, shape_kv, dtype, tol, gen, time_it=True):
    from gen3c_tpu_torch import kernels

    q = torch.randn(shape_q, generator=gen, device="cuda").to(dtype)
    k = torch.randn(shape_kv, generator=gen, device="cuda").to(dtype)
    v = torch.randn(shape_kv, generator=gen, device="cuda").to(dtype)
    before = dict(kernels.route_counts)
    out = kernels.attention(q, k, v)
    ref = kernels.attention_reference(q, k, v)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    res = {"name": name, "q": list(shape_q), "kv": list(shape_kv), "dtype": str(dtype),
           "max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
           "finite": bool(torch.isfinite(out).all().item())}
    del out, ref, err
    if time_it:
        ms = cuda_ms(lambda: kernels.attention(q, k, v), reps=3)
        plain_ms = cuda_ms(lambda: kernels.attention_reference(q, k, v), reps=1, warmup=0)
        B, Lq, H, D = shape_q
        flop = 4.0 * B * H * Lq * shape_kv[1] * D
        res.update(ms=ms, plain_ms=plain_ms, tflops=flop / ms / 1e9,
                   plain_tflops=flop / plain_ms / 1e9, library_ms=library_ms(lambda: _sdpa(q, k, v)),
                   **bound(tensor_bytes(q, k, v, q), flop,
                           BF16_PEAK_TFLOPS if dtype == torch.bfloat16 else FP32_PEAK_TFLOPS))
        res["bound_share"] = res["bound_ms"] / ms
    res["routes"] = route_delta(before)
    if dtype == torch.bfloat16:
        res["entries"] = wgmma_entries("fwd", shape_q[3], band=False)
    emit("kernel", **res)
    if dtype == torch.bfloat16:
        require_wgmma(name, res["routes"])
    if not res["finite"] or res["max_abs_err"] > tol["max"] or res["mean_abs_err"] > tol["mean"]:
        raise AssertionError(f"{name}: kernel disagrees with its plain version: {res}")
    return res


def _rel_err(a, ref):
    """(max, mean) |a - ref| relative to mean |ref|."""
    d = (a.float() - ref.float()).abs()
    m = ref.float().abs().mean()
    return (d.max() / m).item(), (d.mean() / m).item()


def _library_backward_ms(q, k, v, do, mask=None):
    """The backward of F.scaled_dot_product_attention (with the dense band
    mask, if given) on the same inputs: one torch.autograd.grad call after
    one forward, or None where the card cannot hold it."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    try:
        out = _sdpa(*leaves, mask)
        ms = library_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True))
    except torch.OutOfMemoryError:
        ms = None
    del leaves
    torch.cuda.empty_cache()
    return ms


def _off_alignment(t: torch.Tensor) -> torch.Tensor:
    """t's values at a base 2 bytes past a 16-byte boundary, which no TMA
    tensor map describes."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def _mma_sync_check(q, k, v, do, band, ref, ref_lse, plain, truth) -> dict:
    """The mma.sync bodies (attention.cu, attention_bwd.cu), which serve
    every bf16 input no TMA map describes, at the shape of q, k, v: the same
    values at a base off 16-byte alignment through K1's forward, the forward
    with lse, a ring step at offsets 0 and the backward, against the plain
    versions the wgmma body was held to (ATTN_TOL; K4_TOL's margins)."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.kernels import cuda

    qm, km, vm, dom = (_off_alignment(t) for t in (q, k, v, do))
    before = dict(kernels.route_counts)
    outs = {"attention": (cuda.attention(qm, km, vm, band), None),
            "fwd_lse": cuda.attention_fwd_lse(qm, km, vm, band),
            "ring_fold": cuda.attention_ring_fold(qm, km, vm, band, 0, 0)}
    res = {"forward_err": {}}
    for entry, (out, lse) in outs.items():
        err = (out.float() - ref.float()).abs()
        res["forward_err"][entry] = {"max": err.max().item(), "mean": err.mean().item(),
                                     "lse_max": None if lse is None else
                                     (lse - ref_lse).abs().max().item()}
        del err
    out, lse = outs["fwd_lse"]
    got = cuda.attention_bwd(qm, km, vm, out, dom, lse, band)
    torch.cuda.synchronize()
    res["routes"] = route_delta(before)
    ok = res["routes"] == {"wgmma": 0, "mma_sync": 4} and all(
        e["max"] <= ATTN_TOL["max"] and e["mean"] <= ATTN_TOL["mean"]
        for e in res["forward_err"].values())
    for n, g, p, t in zip("qkv", got, plain, truth):
        kmax, kmean = _rel_err(g, t)
        pmax, pmean = _rel_err(p, t)
        res[f"d{n}_vs_fp32"] = {"kernel_max": kmax, "kernel_mean": kmean}
        ok = ok and kmax <= pmax + K4_TOL["max_margin"] and kmean <= pmean + K4_TOL["mean_margin"]
    res["ok"] = ok
    return res


def _k4_case(name, shape_q, shape_kv, dtype, gen, time_it=True, band=None, mma_sync_too=False):
    """K4 (K4-band with a band) and its forward with lse against the plain
    versions; a bf16 band call also counts the tiles it visits. With
    mma_sync_too, also the mma.sync bodies on the same values
    (``_mma_sync_check``), apart in the route counts."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.kernels import cuda

    q = torch.randn(shape_q, generator=gen, device="cuda").to(dtype)
    k = torch.randn(shape_kv, generator=gen, device="cuda").to(dtype)
    v = torch.randn(shape_kv, generator=gen, device="cuda").to(dtype)
    do = torch.randn(shape_q, generator=gen, device="cuda").to(dtype)
    B, Lq, H, D = shape_q
    Lk = shape_kv[1]
    vis_f = torch.zeros(1, dtype=torch.int64, device="cuda")
    vis_b = torch.zeros(2, dtype=torch.int64, device="cuda")
    before = dict(kernels.route_counts)
    out, lse = cuda.attention_fwd_lse(q, k, v, band, visited=vis_f)
    forward = "k3" if band is not None else "k1"  # the serving forward it must equal
    res = {"name": name, "q": list(shape_q), "kv": list(shape_kv), "dtype": str(dtype),
           "band": list(band) if band else None,
           f"fwd_equals_{forward}": bool(torch.equal(out, cuda.attention(q, k, v, band)))}
    ref_out, ref_lse = kernels.attention_forward_reference(q, k, v, band)
    res["lse_max_abs_err"] = (lse - ref_lse).abs().max().item()
    got = cuda.attention_bwd(q, k, v, out, do, lse, band, visited=vis_b)
    res["equal_bits_twice"] = all(bool(torch.equal(a, b)) for a, b in
                                  zip(got, cuda.attention_bwd(q, k, v, out, do, lse, band)))
    plain = kernels.attention_backward_reference(q, k, v, out, do, lse, band)
    torch.cuda.synchronize()
    res["finite"] = bool(all(torch.isfinite(g).all().item() for g in got))
    res["max_abs_err"] = max((g.float() - p.float()).abs().max().item() for g, p in zip(got, plain))
    ok = res["finite"] and res[f"fwd_equals_{forward}"] and res["equal_bits_twice"]
    pairs = Lq * Lk  # visible (query, key) pairs
    if band is not None:
        T = -(-Lq // band[0])
        pairs = _band_pairs(T, *band[1:]) * band[0] ** 2
        if dtype == torch.bfloat16:  # the units of both bodies: 64-key, 64- and 32-query tiles
            tiles64, tiles32 = -(-Lk // 64), -(-Lq // 32)
            res["visited_fraction"] = {
                "forward": vis_f.item() / (B * H * tiles64 * -(-Lq // 64)),
                "dkdv": vis_b[0].item() / (B * H * tiles64 * tiles32),
                "dq": vis_b[1].item() / (B * H * tiles64 * -(-Lq // 64)),
                "frame_pairs": pairs / (Lq * Lk)}
    if dtype == torch.float32:
        for n, g, p in zip("qkv", got, plain):
            res[f"d{n}_rel_max"], res[f"d{n}_rel_mean"] = _rel_err(g, p)
            ok = ok and res[f"d{n}_rel_max"] <= K4_F32_TOL
    else:
        q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
        o32, l32 = kernels.attention_forward_reference(q32, k32, v32, band)
        truth = kernels.attention_backward_reference(q32, k32, v32, o32, do32, l32, band)
        del q32, k32, v32, do32, o32, l32
        for n, g, p, t in zip("qkv", got, plain, truth):
            res[f"d{n}_rel_max"], res[f"d{n}_rel_mean"] = _rel_err(g, p)
            kmax, kmean = _rel_err(g, t)
            pmax, pmean = _rel_err(p, t)
            res[f"d{n}_vs_fp32"] = {"kernel_max": kmax, "kernel_mean": kmean,
                                   "plain_max": pmax, "plain_mean": pmean}
            ok = ok and kmax <= pmax + K4_TOL["max_margin"] and kmean <= pmean + K4_TOL["mean_margin"]
        if mma_sync_too:
            res["mma_sync_route"] = _mma_sync_check(q, k, v, do, band, ref_out, ref_lse, plain,
                                                    truth)
            ok = ok and res["mma_sync_route"]["ok"]
        del truth
    del got, plain, ref_out, ref_lse
    if time_it:
        res["ms"] = cuda_ms(lambda: cuda.attention_bwd(q, k, v, out, do, lse, band), reps=3)
        res["plain_ms"] = cuda_ms(
            lambda: kernels.attention_backward_reference(q, k, v, out, do, lse, band), reps=1,
            warmup=0)
        res["fwd_lse_ms"] = cuda_ms(lambda: cuda.attention_fwd_lse(q, k, v, band), reps=3)
        flop = 10.0 * B * H * pairs * D  # the visible work only
        res.update(tflops=flop / res["ms"] / 1e9, plain_tflops=flop / res["plain_ms"] / 1e9,
                   bf16_peak_share=flop / res["ms"] / 1e9 / BF16_PEAK_TFLOPS,
                   **bound(tensor_bytes(q, k, v, out, do, lse, q, k, v), flop, BF16_PEAK_TFLOPS))
        # this design recomputes S in both kernels: 14 L^2 D flop against the 10 counted
        res["deterministic_floor_ms"] = res["bound_ms"] * 14 / 10
        res["bound_share"] = res["bound_ms"] / res["ms"]
        res["fwd_lse_tflops"] = flop * 4 / 10 / res["fwd_lse_ms"] / 1e9
        del out, lse
        torch.cuda.empty_cache()
        res["library_ms"] = _library_backward_ms(
            q, k, v, do, None if band is None else _band_mask(Lq, band))
    res["routes"] = route_delta(before)
    if "mma_sync_route" in res:  # the check's launches, apart
        res["routes"] = {key: n - res["mma_sync_route"]["routes"][key]
                         for key, n in res["routes"].items()}
    if dtype == torch.bfloat16:
        res["entries"] = {**wgmma_entries("fwd", D, band is not None, lse=True),
                          **wgmma_entries("bwd", D, band is not None)}
    emit("kernel", **res)
    if not ok:
        raise AssertionError(f"{name}: the backward disagrees with its plain version: {res}")
    if dtype == torch.bfloat16:
        require_wgmma(name, res["routes"])
    if band is not None and dtype == torch.bfloat16:
        frac = res["visited_fraction"]
        if abs(frac["dkdv"] - frac["frame_pairs"]) > 0.01 or vis_b[1].item() != vis_f.item():
            raise AssertionError(f"{name} did not skip the masked tiles: {res}")
    return res


def _k4_full_window_case(gen) -> dict:
    """K4-band at a window over every frame of the 7B self shape: K4's tiles
    in K4's order, so the forward with lse and the backward give K4's bits."""
    from gen3c_tpu_torch.kernels import cuda

    q, k, v, do = (torch.randn((1, LATENT_T_7B * BAND_7B[0], 32, 128), generator=gen,
                               device="cuda").to(torch.bfloat16) for _ in range(4))
    full_band = (BAND_7B[0], LATENT_T_7B - 1, 1)
    out, lse = cuda.attention_fwd_lse(q, k, v)
    out_b, lse_b = cuda.attention_fwd_lse(q, k, v, full_band)
    res = {"name": "K4-band at a full window against K4", "band": list(full_band),
           "forward_equal": bool(torch.equal(out, out_b) and torch.equal(lse, lse_b))}
    del out_b, lse_b
    want = cuda.attention_bwd(q, k, v, out, do, lse)
    got = cuda.attention_bwd(q, k, v, out, do, lse, full_band)
    res["backward_equal"] = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
    emit("kernel", **res)
    if not (res["forward_equal"] and res["backward_equal"]):
        raise AssertionError(f"K4-band at a full window differs from K4: {res}")
    return res


def _mma_probe_case(gen, dtype: str) -> dict:
    """P1 against its plain version (probe_int8_attention.check), then its
    rate at the attention QK^T block shape, as the probe script runs it."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.scripts import probe_int8_attention as probe

    M, K, N = P1_SHAPE
    kernels.reset_launch_counts()
    r = probe.measure(M, K, N, dtype, P1_REPS, gen, plain=True)
    r["launches"] = kernels.launch_counts["P1"]  # the probe's own run: check and timings
    r["name"] = f"P1 mma.sync rate probe ({dtype})"
    elem = 1 if dtype == "int8" else 2
    r.update(**bound((M * K + K * N) * elem + M * N * 4, 2.0 * M * K * N * P1_REPS,
                     INT8_PEAK_TOPS if dtype == "int8" else BF16_PEAK_TFLOPS),
             library_ms=None)  # no one PyTorch call sums R products
    emit("kernel", **r)
    return r


def splat_inputs(gen, random_flow: bool = False, nonfinite: bool = False):
    """K5's inputs at the render's shape: two 704x1280 buffers warped into a
    shifted camera, (frame (2, 3, h, w), mask, target depth (2, 1, h, w),
    flow (2, 2, h, w)), fp32 on the card. ``random_flow`` sends every pixel
    to a uniformly random target (neighbouring pixels land apart: no corner
    merges);
    ``nonfinite`` puts a NaN depth in buffer 0 and a +inf depth in buffer 1
    (each then its own splat group)."""
    from gen3c_tpu_torch.ops import geometry
    from gen3c_tpu_torch.pipelines.depth import default_intrinsics

    b, c, h, w = 2, 3, 704, 1280
    yy, xx = torch.meshgrid(torch.linspace(0, 1, h, device="cuda"),
                            torch.linspace(0, 1, w, device="cuda"), indexing="ij")
    depth = (2.5 - 0.8 * yy + 0.3 * torch.sin(6 * xx)
             + 0.6 * (xx > 0.55).float())[None, None].repeat(b, 1, 1, 1)
    depth[1] *= 1.2
    frame = torch.rand((b, c, h, w), generator=gen, device="cuda") * 2 - 1
    k = torch.from_numpy(default_intrinsics(h, w)).cuda()[None].repeat(b, 1, 1)
    w2c = torch.eye(4, device="cuda")[None].repeat(b, 1, 1)
    pts = geometry.unproject_points(depth, w2c, k)
    tgt = w2c.clone()
    tgt[:, 0, 3] = torch.tensor([0.12, -0.2], device="cuda")
    tgt[:, 2, 3] = 0.05
    proj, _ = geometry.project_points(pts, tgt, k)
    mask = (proj[..., 2] > 0)[:, None].float()
    coords = (proj[..., :2] / (proj[..., 2:3] + 1e-7)).permute(0, 3, 1, 2)
    flow = coords - geometry.create_grid(h, w, device="cuda")[None]
    if random_flow:
        grid = geometry.create_grid(h, w, device="cuda")[None]
        scale = torch.tensor([w, h], dtype=torch.float32, device="cuda")[None, :, None, None]
        flow = torch.rand((b, 2, h, w), generator=gen, device="cuda") * scale - grid
    tdepth = proj[..., 2][:, None].contiguous()
    if nonfinite:
        tdepth[0, 0, 100, 200] = float("nan")
        tdepth[1, 0, 300, 600] = float("inf")
    return frame.contiguous(), mask, tdepth, flow.contiguous()


def _splat_agreement(out, m, ref, m_ref) -> dict:
    """K5 against its plain version: the same NaN pixels, the share of equal
    mask pixels, and the largest error on finite pixels both call known."""
    both = ((m > 0) & (m_ref > 0)).expand_as(out) & torch.isfinite(out) & torch.isfinite(ref)
    return {"max_abs_err": torch.where(both, (out - ref).abs(), 0.0).max().item(),
            "mask_agree": (m == m_ref).float().mean().item(),
            "nan_equal": bool(torch.equal(torch.isnan(out), torch.isnan(ref))),
            "nan_pixels": int(torch.isnan(ref).sum())}


def _splat_case(gen) -> dict:
    """K5 at the render's shape (2 x 3 x 704x1280): two buffers warped into
    a shifted camera (a smooth flow; timed, its three kernels apart, the
    parent's torch passes beside them), then uniformly random targets
    (nothing merges) and NaN / +inf depths (each buffer its own group), and
    the depth splat of forward_warp(render_depth=True) (C = 1: its own
    accumulate body) on the smooth and the random flow, each held to the
    plain version."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.kernels import cuda, reference

    frame, mask, tdepth, flow = splat_inputs(gen)
    b, c, h, w = frame.shape
    out, m = kernels.splat(frame, mask, tdepth, flow, None, True)
    ref, m_ref = kernels.splat_reference(frame, mask, tdepth, flow, None, True)
    torch.cuda.synchronize()
    res = {"name": "K5 splat", "shape": [b, c, h, w], **_splat_agreement(out, m, ref, m_ref),
           "known_fraction": m.mean().item()}
    # a sub-millisecond kernel: every run is kept, to show the spread
    res["ms_runs"] = cuda_times(lambda: kernels.splat(frame, mask, tdepth, flow, None, True), reps=5)
    res["ms"] = float(np.median(res["ms_runs"]))
    res["plain_ms"] = cuda_ms(lambda: kernels.splat_reference(frame, mask, tdepth, flow, None, True),
                              reps=3)
    parts = []
    for _ in range(5):
        cuda.splat(frame, mask, tdepth, flow, None, True, part_ms=parts)
    res["parts_ms"] = {key: float(np.median(parts[i::3]))
                       for i, key in enumerate(("prepare", "accumulate", "finish"))}
    acc = torch.zeros((b, (h + 2) * (w + 2), c + 1), device="cuda")
    # the parent's passes around its accumulate kernel, on the same inputs
    res["parent_torch_parts_ms"] = {
        "max_logd": cuda_ms(lambda: reference.splat_max_logd(tdepth), reps=5),
        "zero_fill": cuda_ms(lambda: torch.zeros_like(acc), reps=5),
        "normalize": cuda_ms(lambda: reference.splat_normalize(acc, c, h, w, True), reps=5)}
    counts = torch.zeros(2, dtype=torch.int32, device="cuda")
    cuda.splat(frame, mask, tdepth, flow, None, True, counts=counts)
    res["corner_atomics"], res["corners_merged"] = counts.tolist()
    # each source pixel adds its c values and weight into 4 targets
    res.update(library_ms=None, **bound(tensor_bytes(frame, mask, tdepth, flow, out, m),
                                        8.0 * (c + 1) * b * h * w, FP32_PEAK_TFLOPS))
    del acc, ref, m_ref
    cases = {}
    gen_cases = torch.Generator(device="cuda").manual_seed(9)  # leaves gen as it was
    for name, kw, group, depth_splat in (("random_flow", {"random_flow": True}, None, False),
                                         ("nonfinite", {"nonfinite": True}, 1, False),
                                         ("depth_smooth", {}, None, True),
                                         ("depth_random", {"random_flow": True}, None, True)):
        fr, mk, dp, fl = splat_inputs(gen_cases, **kw)
        if depth_splat:  # the warped depth, as forward_warp splats it
            fr, is_image = dp, False
        else:
            is_image = True
        o, mo = kernels.splat(fr, mk, dp, fl, None, is_image, group=group)
        r, mr = kernels.splat_reference(fr, mk, dp, fl, None, is_image, group=group)
        counts.zero_()
        cuda.splat(fr, mk, dp, fl, None, is_image, group=group, counts=counts)
        cases[name] = {**_splat_agreement(o, mo, r, mr), "shape": list(fr.shape),
                       "corners_merged": counts.tolist()[1],
                       "ms": cuda_ms(lambda: kernels.splat(fr, mk, dp, fl, None, is_image,
                                                           group=group), reps=5)}
        del fr, mk, dp, fl, o, mo, r, mr
    res["cases"] = cases
    emit("kernel", **res)
    for case in [res, *cases.values()]:
        if (case["max_abs_err"] > SPLAT_TOL or case["mask_agree"] < SPLAT_MASK_AGREE
                or not case["nan_equal"]):
            raise AssertionError(f"K5: kernel disagrees with its plain version: {res}")
    if (cases["nonfinite"]["nan_pixels"] == 0 or res["corners_merged"] == 0
            or cases["depth_smooth"]["corners_merged"] == 0):
        raise AssertionError(f"K5: no NaN pixel or no merged corner: {res}")
    return res


def _band_pairs(T: int, window: int, prefix: int) -> int:
    """Visible (query frame, key frame) pairs of a band over T frames."""
    return sum(kf < prefix or abs(qf - kf) <= window for qf in range(T) for kf in range(T))


def _band_case(gen) -> dict:
    """K3 at the 7B self-attention shape with the fast preset's band."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.kernels import cuda

    B, L, H, D = 2, LATENT_T_7B * BAND_7B[0], 32, 128
    q, k, v = (torch.randn((B, L, H, D), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    before = dict(kernels.route_counts)
    out = kernels.attention(q, k, v, band=BAND_7B)
    ref = kernels.attention_reference(q, k, v, BAND_7B)
    visited = torch.zeros(1, dtype=torch.int64, device="cuda")
    cuda.attention(q, k, v, BAND_7B, visited=visited)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    tiles = -(-L // 64)
    pairs = _band_pairs(LATENT_T_7B, *BAND_7B[1:])
    res = {"name": "K3 band self-attention", "q": [B, L, H, D], "band": list(BAND_7B),
           "max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
           "finite": bool(torch.isfinite(out).all().item()),
           "visited_tiles": visited.item(), "k1_tiles": B * H * tiles * tiles,
           "frame_pairs": pairs, "frame_pairs_all": LATENT_T_7B ** 2}
    res["visited_fraction"] = res["visited_tiles"] / res["k1_tiles"]
    del out, ref, err
    full_band = (BAND_7B[0], LATENT_T_7B - 1, 1)  # every frame pair: K1's work
    res["full_window_equals_k1"] = bool(torch.equal(kernels.attention(q, k, v, band=full_band),
                                                    kernels.attention(q, k, v)))
    res["ms"] = cuda_ms(lambda: kernels.attention(q, k, v, band=BAND_7B), reps=3)
    res["plain_ms"] = cuda_ms(lambda: kernels.attention_reference(q, k, v, BAND_7B), reps=1,
                              warmup=0)
    flop = 4.0 * B * H * D * pairs * BAND_7B[0] ** 2  # the unmasked work only
    res.update(tflops=flop / res["ms"] / 1e9, plain_tflops=flop / res["plain_ms"] / 1e9,
               **bound(tensor_bytes(q, k, v, q), flop, BF16_PEAK_TFLOPS))
    mask = _band_mask(L, BAND_7B)  # SDPA with the dense mask: it computes every tile
    res["library_ms"] = library_ms(lambda: _sdpa(q, k, v, mask))
    del mask
    torch.cuda.empty_cache()
    res.update(bound_share=res["bound_ms"] / res["ms"], routes=route_delta(before),
               entries=wgmma_entries("fwd", D, band=True))
    emit("kernel", **res)
    require_wgmma(res["name"], res["routes"])
    if (not res["finite"] or res["max_abs_err"] > ATTN_TOL["max"]
            or res["mean_abs_err"] > ATTN_TOL["mean"] or not res["full_window_equals_k1"]):
        raise AssertionError(f"K3: kernel disagrees with its plain version or K1: {res}")
    if res["visited_tiles"] != B * H * tiles * tiles * pairs // LATENT_T_7B ** 2:
        raise AssertionError(f"K3 did not skip the masked tiles: {res}")
    return res


def _quant_case(gen, k: int) -> dict:
    """K7q on a 7B activation shape: the tokens of the 2B CFG batch x 4096
    (q/k/v, fc1) or x 16384 (fc2's input)."""
    from gen3c_tpu_torch import kernels

    x = torch.randn((2 * 56320, k), generator=gen, device="cuda").to(torch.bfloat16)
    x[0] = 0  # a zero token
    codes, scale = kernels.quantize_rows(x)
    want_codes, want_scale = kernels.quantize_rows_reference(x)
    torch.cuda.synchronize()
    res = {"name": f"K7q per-token int8 quantize, K={k}", "shape": list(x.shape),
           "codes_equal": bool(torch.equal(codes, want_codes)),
           "scales_equal": bool(torch.equal(scale, want_scale)),
           "max_abs_err": (scale - want_scale).abs().max().item()}
    del want_codes, want_scale
    res["ms"] = cuda_ms(lambda: kernels.quantize_rows(x), reps=5)
    res["plain_ms"] = cuda_ms(lambda: kernels.quantize_rows_reference(x), reps=3)
    res["gb_per_s"] = x.numel() * 3 / res["ms"] / 1e6  # bf16 read, int8 write
    # absmax, scale, divide, round: ~4 fp32 operations an element
    res.update(library_ms=None, **bound(tensor_bytes(x, codes, scale), 4.0 * x.numel(),
                                        FP32_PEAK_TFLOPS))
    res["bound_share"] = res["bound_ms"] / res["ms"]
    emit("kernel", **res)
    if not (res["codes_equal"] and res["scales_equal"]):
        raise AssertionError(f"K7q: kernel disagrees with its plain version: {res}")
    return res


def _gemm_case(gen, name: str, M: int, K: int, N: int) -> dict:
    """K7 at one linear shape: exact int32 accumulators and bf16 outputs
    against the plain version, then times. The codes are K7q's, contiguous:
    where K is not a multiple of 16 no tensor map describes their rows, and
    K7 reads them from a copy in 16-byte rows ("copied")."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.kernels import cuda

    bf16 = torch.bfloat16
    x = torch.randn((M, K), generator=gen, device="cuda").to(bf16)
    x[0] = 0
    w = (torch.randn((N, K), generator=gen, device="cuda") * 0.02).to(bf16)
    wq, ws = kernels.quantize_rows(w)
    xq, xs = kernels.quantize_rows(x)
    acc = cuda.int8_gemm(xq, wq, None, None, torch.int32)
    acc_ref = kernels.int8_matmul_reference(xq, wq)
    res = {"name": f"K7 int8 GEMM {name}", "M": M, "K": K, "N": N,
           "copied": cuda.w8a8_operand(xq) is not xq, "acc_equal": bool(torch.equal(acc, acc_ref))}
    del acc
    out = cuda.int8_gemm(xq, wq, xs, ws, bf16)
    ref = acc_ref.float().mul_(xs[:, None]).mul_(ws[None, :]).to(bf16)
    del acc_ref
    res["max_abs_err"] = (out.float() - ref.float()).abs().max().item()
    del out, ref
    res["linear_equal"] = bool(torch.equal(kernels.w8a8_matmul(x, wq, ws, bf16),
                                           kernels.w8a8_matmul_reference(x, wq, ws, bf16)))

    def plain():
        return kernels.int8_matmul_reference(xq, wq).float().mul_(xs[:, None]).mul_(
            ws[None, :]).to(bf16)

    res["ms"] = cuda_ms(lambda: cuda.int8_gemm(xq, wq, xs, ws, bf16), reps=5)
    res["plain_ms"] = cuda_ms(plain, reps=1)
    res["cublas_bf16_ms"] = cuda_ms(lambda: x @ w.T, reps=5)
    ops = 2.0 * M * N * K
    res.update(tops=ops / res["ms"] / 1e9, plain_tops=ops / res["plain_ms"] / 1e9,
               cublas_bf16_tflops=ops / res["cublas_bf16_ms"] / 1e9)
    res["int8_peak_share"] = res["tops"] / INT8_PEAK_TOPS
    res.update(**bound(tensor_bytes(xq, wq, xs, ws) + M * N * 2, ops, INT8_PEAK_TOPS))
    try:  # cuBLAS's int8 product (int32 out): the GEMM without K7's rescale
        res["library_ms"] = library_ms(lambda: torch._int_mm(xq, wq.t()), reps=5)
    except RuntimeError as e:  # a shape _int_mm does not take
        res["library_ms"], res["library_error"] = None, str(e)[:200]
    emit("kernel", **res)
    if not (res["acc_equal"] and res["linear_equal"]) or res["max_abs_err"] != 0.0:
        raise AssertionError(f"K7: kernel disagrees with its plain version: {res}")
    return res


def _foreground_depth(h: int, w: int, seed: int, shift: float = 0.0, discs: int = 16,
                      bars: int = 16, bar_top: float = 0.35) -> torch.Tensor:
    """(h, w) depth on the card: a slanted plane with ``discs`` nearer discs
    and a railing of ``bars`` bars (14 pixels wide, at most half their
    period) below ``bar_top`` of the height in front, all moved right by
    ``shift`` pixels. Its depth boundaries give ~19k boundary-mesh
    triangles at 704x1280 with the defaults, over 100k with K6_DENSE_SCENE."""
    rng = np.random.default_rng(seed)
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device="cuda"),
                            torch.arange(w, dtype=torch.float32, device="cuda"), indexing="ij")
    depth = 2.5 - 0.8 * yy / h + 0.3 * torch.sin(6 * xx / w)
    for _ in range(discs):
        cy, cx, r = rng.uniform(0.1 * h, 0.9 * h), rng.uniform(0.1 * w, 0.9 * w), rng.uniform(30, 90)
        depth = torch.where((yy - cy) ** 2 + (xx - cx - shift) ** 2 < r * r,
                            float(rng.uniform(1.2, 1.6)), depth)
    bar_w = min(14.0, w / bars / 2)
    return torch.where((((xx - shift) % (w / bars)) < bar_w) & (yy > bar_top * h), 1.0, depth)


def k6_mesh(**scene):
    """K6's inputs as foreground masking forms them: the 901,120 pixel rays
    of a 704x1280 camera moved left and forward, and the boundary mesh of
    ``_foreground_depth(**scene)`` (seed 0) seen from it: (rays (R, 3),
    v0, v1, v2 (T, 3)) fp32 on the card."""
    from gen3c_tpu_torch.ops import geometry, raycast
    from gen3c_tpu_torch.pipelines.depth import default_intrinsics

    h, w = 704, 1280
    depth = _foreground_depth(h, w, seed=0, **scene)[None, None]
    k = torch.from_numpy(default_intrinsics(h, w)).cuda()[None]
    pts = geometry.unproject_points(depth, torch.eye(4, device="cuda")[None], k)
    target = torch.eye(4, device="cuda")[None]
    target[0, 0, 3], target[0, 2, 3] = 0.15, -0.1
    _, cam = geometry.project_points(pts, target, k)
    vertices, faces = raycast.build_boundary_mesh(cam[0], ~geometry.reliable_depth_mask(depth)[0, 0])
    v0, v1, v2 = (vertices[faces[:, i]].contiguous() for i in range(3))
    rays = geometry.pixel_rays(h, w, k)[0].reshape(-1, 3).contiguous()
    return rays, v0, v1, v2


def _ray_case(name: str = "K6 ray-triangle depth", scene: Optional[dict] = None) -> dict:
    """K6 on the 901,120 rays of a 704x1280 camera against the boundary mesh
    of a seeded depth (``scene``: _foreground_depth's arguments) seen from a
    camera moved left and forward, as foreground masking builds it: the
    plain version's bits (and its setup kernel's), the triangles it cannot
    bound, the pairs the 256-ray tiles keep and those a per-ray footprint
    keeps (the bound's), and the call, its setup and its kernel timed
    apart."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.kernels import cuda, reference

    rays, v0, v1, v2 = k6_mesh(**(scene or {}))
    R, T = rays.shape[0], v0.shape[0]
    got = kernels.ray_triangle_depth(rays, v0, v1, v2)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = kernels.ray_triangle_depth_reference(rays, v0, v1, v2)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    both = (got > 0) & (want > 0)
    diff = (got - want).abs()[both]
    mesh = cuda.ray_triangle_setup_and_bounds(v0, v1, v2)
    tri = reference.ray_triangle_setup(v0, v1, v2)
    boxes = reference.ray_triangle_bounds(tri)
    tiles, cull = reference.ray_tiles(rays)
    tile_rays = torch.bincount(torch.arange(R, device=rays.device) // reference.RAY_TILE)
    survivors = sum(int((reference.ray_triangle_kept(tiles, cull, boxes[t0:t0 + 8192])
                         .sum(dim=1) * tile_rays).sum()) for t0 in range(0, T, 8192))
    footprint = reference.ray_triangle_footprint_pairs(rays, boxes)
    res = {"name": name, "rays": R, "triangles": T, "bit_equal": bool(torch.equal(got, want)),
           "setup_bit_equal": bool(torch.equal(mesh[0], tri) and torch.equal(mesh[1], boxes)
                                   and torch.equal(mesh[2], reference.ray_chunk_bounds(boxes))),
           "hit_fraction": (want > 0).float().mean().item(),
           "flip_fraction": ((got > 0) != (want > 0)).float().mean().item(),
           "max_abs_err": diff.max().item() if diff.numel() else 0.0,
           "rel_err": (diff / want[both]).max().item() if diff.numel() else 0.0,
           "tol": K6_TOL, "uncullable": int(torch.isinf(boxes).all(dim=1).sum()),
           "all_pairs": R * T, "survivor_pairs": survivors, "footprint_pairs": footprint,
           "plain_ms": plain_ms}
    res["ms"] = cuda_ms(lambda: kernels.ray_triangle_depth(rays, v0, v1, v2), reps=5)
    res["setup_ms"] = cuda_ms(lambda: cuda.ray_triangle_setup_and_bounds(v0, v1, v2), reps=5)
    res["kernel_ms"] = cuda_ms(lambda: cuda.ray_triangle_hits(rays, *mesh), reps=5)
    nbytes = tensor_bytes(rays, v0, v1, v2, got)
    # the bound counts the footprint's pairs; the all-pairs yardstick counts all R x T
    res.update(gpairs_per_s=survivors / res["kernel_ms"] / 1e6, library_ms=None,
               all_pairs_bound_ms=bound(nbytes, K6_OPS_PER_PAIR * R * T,
                                        FP32_PEAK_TFLOPS)["bound_ms"],
               **bound(nbytes, K6_OPS_PER_PAIR * footprint, FP32_PEAK_TFLOPS))
    emit("kernel", **res)
    if (T == 0 or not (res["bit_equal"] and res["setup_bit_equal"])
            or res["flip_fraction"] > K6_TOL["flip_fraction"]
            or res["rel_err"] > K6_TOL["rel_err"] or res["hit_fraction"] == 0):
        raise AssertionError(f"K6: kernel disagrees with its plain version: {res}")
    del rays, v0, v1, v2, got, want, mesh
    torch.cuda.empty_cache()
    return res


def _p2_case(gen) -> dict:
    """P2, K1's tile sweep, at the 7B self-attention shape over
    P2_SMOKE_CONFIGS: each config checked on a small shape against the plain
    attention (the script's check), then timed and held to the plain
    attention on the full-shape inputs (the same values in both layouts)."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.scripts import sweep_attention as sweep

    shape = (sweep.B, sweep.L, sweep.H, sweep.D)
    kernels.reset_launch_counts()
    q, k, v = sweep.qkv(shape, shape, "blhd", gen)
    layouts = {"blhd": (q, k, v),
               "bhld": tuple(t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))}
    plain = {}
    plain_ms = cuda_ms(lambda: plain.__setitem__("out", kernels.attention_reference(q, k, v)),
                       reps=1, warmup=0)
    rows = []
    for config in P2_SMOKE_CONFIGS:
        check_err = sweep.check(config, gen)
        bm, bn, layout = config
        err = (kernels.attention_tiles(*layouts[layout], bm, bn).float() - plain["out"].float()).abs()
        row = sweep.measure(config, *layouts[layout])
        row.update(check_max_abs_err=check_err, max_abs_err=err.max().item(),
                   mean_abs_err=err.mean().item())
        del err
        emit("p2_config", **row)
        rows.append(row)
    best = min(rows, key=lambda r: r["ms"])
    res = {"name": "P2 K1 tile sweep", "q": list(shape), "configs": rows, "best": best["config"],
           "ms": best["ms"], "tflops": best["tflops"], "k1_tile_ms": rows[0]["ms"],
           "plain_ms": plain_ms, "launches": kernels.launch_counts["P2"],  # the sweep's own run
           "max_abs_err": max(r["max_abs_err"] for r in rows),
           **bound(tensor_bytes(q, k, v, q), sweep.FLOPS, BF16_PEAK_TFLOPS)}
    del plain
    torch.cuda.empty_cache()
    res["library_ms"] = library_ms(lambda: _sdpa(q, k, v))
    emit("kernel", **res)
    bad = [r["config"] for r in rows
           if r["max_abs_err"] > ATTN_TOL["max"] or r["mean_abs_err"] > ATTN_TOL["mean"]]
    if bad:
        raise AssertionError(f"P2: {bad} disagree with the plain attention: {res}")
    return res


def _k3lse_case(gen) -> dict:
    """K3lse, the band forward that keeps the row logsumexp (the forward of
    K4-band in LoRA + band training), at B=1, the 7B self shape, the fast
    preset's band."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.kernels import cuda

    B, L, H, D = 1, LATENT_T_7B * BAND_7B[0], 32, 128
    q, k, v = (torch.randn((B, L, H, D), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    before = dict(kernels.route_counts)
    out, lse = cuda.attention_fwd_lse(q, k, v, BAND_7B)
    ref, ref_lse = kernels.attention_forward_reference(q, k, v, BAND_7B)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    res = {"name": "K3lse band forward with lse", "q": [B, L, H, D], "band": list(BAND_7B),
           "max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
           "lse_max_abs_err": (lse - ref_lse).abs().max().item(),
           "equals_k3": bool(torch.equal(out, cuda.attention(q, k, v, BAND_7B)))}
    del ref, ref_lse, err
    res["ms"] = cuda_ms(lambda: cuda.attention_fwd_lse(q, k, v, BAND_7B), reps=3)
    res["plain_ms"] = cuda_ms(lambda: kernels.attention_forward_reference(q, k, v, BAND_7B),
                              reps=1, warmup=0)
    flop = 4.0 * B * H * D * _band_pairs(LATENT_T_7B, *BAND_7B[1:]) * BAND_7B[0] ** 2
    res.update(tflops=flop / res["ms"] / 1e9,
               **bound(tensor_bytes(q, k, v, out, lse), flop, BF16_PEAK_TFLOPS))
    mask = _band_mask(L, BAND_7B)
    res["library_ms"] = library_ms(lambda: _sdpa(q, k, v, mask))
    del mask
    torch.cuda.empty_cache()
    res.update(bound_share=res["bound_ms"] / res["ms"], routes=route_delta(before),
               entries=wgmma_entries("fwd", D, band=True, lse=True))
    emit("kernel", **res)
    require_wgmma(res["name"], res["routes"])
    if (res["max_abs_err"] > ATTN_TOL["max"] or res["mean_abs_err"] > ATTN_TOL["mean"]
            or res["lse_max_abs_err"] > 1e-2 or not res["equals_k3"]):
        raise AssertionError(f"K3lse: kernel disagrees with its plain version or K3: {res}")
    return res


def _ulysses_view(x: torch.Tensor, cp: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s H/cp heads of the whole sequence x (B, L, H, D) as
    collectives.seq_to_heads leaves them: a view of the all-to-all's (cp,
    L/cp, B, H/cp, D) receive buffer, which K1cp reads in place."""
    B, L, H, D = x.shape
    hc = H // cp
    buf = x[:, :, rank * hc:(rank + 1) * hc].reshape(B, cp, L // cp, hc, D)
    return buf.permute(1, 2, 0, 3, 4).contiguous().view(L, B, hc, D).permute(1, 0, 2, 3)


def _k1cp_cases(q, k, v, full: dict) -> list:
    """K1cp (K1, or K3 under the band, on a Ulysses rank's heads) at the 7B
    shard shapes (2, 56,320, 32/cp, 128) for cp in CP_SIZES, with and
    without the band: rank 0's heads read in place from the all-to-all's
    layout, held to K1's (K3's) output on all 32 heads, sliced (equal bits
    expected: each (batch, head) is computed alone), and to the plain
    attention on the shard."""
    from gen3c_tpu_torch import kernels

    B, L, H, D = q.shape
    rows = []
    for cp in CP_SIZES:
        for band in (None, BAND_7B):
            hc = H // cp
            qs, ks, vs = (_ulysses_view(t, cp, 0) for t in (q, k, v))
            before = dict(kernels.route_counts)
            out = kernels.attention(qs, ks, vs, kernel_id="K1cp", band=band)
            want = full[band][:, :, :hc]
            plain = {}
            plain_ms = cuda_ms(lambda: plain.__setitem__(
                "out", kernels.attention_reference(qs, ks, vs, band)), reps=1, warmup=0)
            torch.cuda.synchronize()
            err = (out.float() - plain["out"].float()).abs()
            diff = (out.float() - want.float()).abs()
            res = {"name": f"K1cp cp={cp}" + (" band" if band else ""), "cp": cp,
                   "q": [B, L, hc, D], "band": list(band) if band else None,
                   "equals_full_sliced": bool(torch.equal(out, want)),
                   "max_abs_diff_full_sliced": diff.max().item(),
                   "max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
                   "plain_ms": plain_ms}
            del out, plain, err, diff
            res["ms"] = cuda_ms(lambda: kernels.attention(qs, ks, vs, kernel_id="K1cp", band=band),
                                reps=3)
            pairs = L * L if band is None else (
                _band_pairs(LATENT_T_7B, *band[1:]) * band[0] ** 2)
            flop = 4.0 * B * hc * D * pairs
            res.update(tflops=flop / res["ms"] / 1e9,
                       **bound(4 * B * L * hc * D * 2, flop, BF16_PEAK_TFLOPS))
            res.update(bound_share=res["bound_ms"] / res["ms"], routes=route_delta(before),
                       entries=wgmma_entries("fwd", D, band=band is not None))
            require_wgmma(res["name"], res["routes"])
            contig = [t.contiguous() for t in (qs, ks, vs)]
            mask = None if band is None else _band_mask(L, band)
            res["library_ms"] = library_ms(lambda: _sdpa(*contig, mask))
            del contig, mask, qs, ks, vs
            torch.cuda.empty_cache()
            emit("kernel", **res)
            if res["max_abs_err"] > ATTN_TOL["max"] or res["mean_abs_err"] > ATTN_TOL["mean"]:
                raise AssertionError(f"K1cp disagrees with its plain version: {res}")
            if res["max_abs_diff_full_sliced"] > ATTN_TOL["max"]:
                raise AssertionError(f"K1cp disagrees with K1 on all heads: {res}")
            rows.append(res)
    return rows


def _ring_rank(q, k, v, cp: int, rank: int, band, fold, merge):
    """Rank ``rank``'s ring attention over the cp KV shards of k/v with the
    given fold and merge (the kernels or their plain versions), as
    models.dit._ring_attention runs it; returns (output, the source ranks
    whose shards it folded)."""
    from gen3c_tpu_torch.models.dit import ring_step_needed

    B, L, H, D = q.shape
    ls = L // cp
    qs = q[:, rank * ls:(rank + 1) * ls].contiguous()
    acc = torch.zeros((B, ls, H, D), dtype=torch.float32, device=q.device)
    lse = torch.full((B, H, ls), float("-inf"), device=q.device)
    out, folded = None, []
    for step in range(cp):
        src = (rank - step) % cp
        last = step == cp - 1
        if band is None or ring_step_needed(rank, src, ls // band[0], band):
            o, l_ = fold(qs, k[:, src * ls:(src + 1) * ls], v[:, src * ls:(src + 1) * ls], band,
                         rank * ls, src * ls)
            out = merge(acc, lse, o, l_, q.dtype if last else None)
            folded.append(src)
            del o, l_
        elif last:
            out = merge(acc, lse, None, None, q.dtype)
    return out, folded


def _ring_case(q, k, v, full: dict, cp: int, band) -> dict:
    """K1ring + K1merge at the 7B shard shapes: every rank of a cp-way ring
    folds its shards and merges, held to K1 (K3 under the band) on the
    whole sequence, and rank 1's result to the plain fold and merge; the
    folded steps are held to the visible frame pairs of each shard pair.
    Times of one fold and one merge at the shard shape; the library's
    time is SDPA's flash attention with lse at that shape."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.kernels import reference

    B, L, H, D = q.shape
    ls = L // cp
    errs, folded_all, plain_err = [], [], None
    before = dict(kernels.route_counts)
    for rank in range(cp):
        got, folded = _ring_rank(q, k, v, cp, rank, band, kernels.ring_fold, kernels.ring_merge)
        errs.append((got.float() - full[band][:, rank * ls:(rank + 1) * ls].float()).abs())
        if rank == 1:
            plain, _ = _ring_rank(q, k, v, cp, rank, band, reference.ring_fold_reference,
                                  reference.ring_merge_reference)
            plain_err = (got.float() - plain.float()).abs()
            del plain
        folded_all.append(folded)
        del got
    frames = ls // BAND_7B[0]
    want_folded = [[s for s in ((r - i) % cp for i in range(cp))
                    if band is None or _shards_see_each_other(r, s, frames, band)]
                   for r in range(cp)]
    res = {"name": f"K1ring + K1merge cp={cp}" + (" band" if band else ""), "cp": cp,
           "q_shard": [B, ls, H, D], "band": list(band) if band else None,
           "max_abs_err_vs_full": max(e.max().item() for e in errs),
           "mean_abs_err_vs_full": float(np.mean([e.mean().item() for e in errs])),
           "max_abs_err": plain_err.max().item(), "mean_abs_err": plain_err.mean().item(),
           "folded": folded_all, "folded_expected": want_folded,
           "skipped_steps": sum(cp - len(f) for f in folded_all)}
    del errs, plain_err
    qs, ks, vs = (t[:, ls:2 * ls].contiguous() for t in (q, k, v))  # rank 1, its own shard
    o, l_ = kernels.ring_fold(qs, ks, vs, band, ls, ls)
    acc = torch.zeros((B, ls, H, D), dtype=torch.float32, device=q.device)
    lse = torch.full((B, H, ls), float("-inf"), device=q.device)
    res["fold_ms"] = cuda_ms(lambda: kernels.ring_fold(qs, ks, vs, band, ls, ls), reps=3)
    res["merge_ms"] = cuda_ms(lambda: kernels.ring_merge(acc, lse, o, l_), reps=3)
    res["plain_fold_ms"] = cuda_ms(lambda: reference.ring_fold_reference(qs, ks, vs, band, ls, ls),
                                   reps=1, warmup=0)
    res["plain_merge_ms"] = cuda_ms(lambda: reference.ring_merge_reference(acc, lse, o, l_),
                                    reps=1, warmup=0)
    pairs = ls * ls if band is None else _band_pairs(frames, *band[1:]) * band[0] ** 2
    flop = 4.0 * B * H * D * pairs  # one diagonal step's visible work
    res["fold_bound"] = bound(tensor_bytes(qs, ks, vs, o, l_), flop, BF16_PEAK_TFLOPS)
    # fp32 state read and written, the step's bf16 output and both lses read
    res["merge_bound"] = bound(tensor_bytes(acc, acc, o, l_, lse, lse), 6.0 * acc.numel(),
                               FP32_PEAK_TFLOPS)
    res["library_ms"] = library_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention(
        qs.transpose(1, 2), ks.transpose(1, 2), vs.transpose(1, 2)))
    res["fold_tflops"] = flop / res["fold_ms"] / 1e9
    res.update(fold_bound_share=res["fold_bound"]["bound_ms"] / res["fold_ms"],
               routes=route_delta(before), entries=wgmma_entries("fwd", D, band is not None, True))
    del qs, ks, vs, o, l_, acc, lse
    torch.cuda.empty_cache()
    emit("kernel", **res)
    require_wgmma(res["name"], res["routes"])
    if (res["max_abs_err_vs_full"] > ATTN_TOL["max"] or res["mean_abs_err_vs_full"] > ATTN_TOL["mean"]
            or res["max_abs_err"] > ATTN_TOL["max"] or res["mean_abs_err"] > ATTN_TOL["mean"]):
        raise AssertionError(f"K1ring/K1merge disagree with K1 or the plain ring: {res}")
    if folded_all != want_folded:
        raise AssertionError(f"K1ring skipped other steps than the band's frame pairs: {res}")
    return res


def _shards_see_each_other(q_rank: int, kv_rank: int, frames: int, band) -> bool:
    """Whether a query shard and a KV shard of ``frames`` frames hold a
    visible (query frame, key frame) pair: counted pair by pair, not by
    the ring's rule."""
    _, window, prefix = band
    return any(kf < prefix or abs(qf - kf) <= window
               for qf in range(q_rank * frames, (q_rank + 1) * frames)
               for kf in range(kv_rank * frames, (kv_rank + 1) * frames))


def _k1ag_case(q, k, v) -> dict:
    """K1ag: K1 on rank 0's query shard of a 2-way all-gather (Lq = L/2)
    over all L keys, read in place from the gather's (rank, position,
    batch, ...) layout, against K1's rows and the plain attention."""
    from gen3c_tpu_torch import kernels

    B, L, H, D = q.shape
    ls = L // 2
    qs = q[:, :ls]
    ks, vs = (t.transpose(0, 1).contiguous().transpose(0, 1) for t in (k, v))  # gathered layout
    before = dict(kernels.route_counts)
    out = kernels.attention(qs, ks, vs, kernel_id="K1ag")
    plain = {}
    plain_ms = cuda_ms(lambda: plain.__setitem__("out", kernels.attention_reference(qs, ks, vs)),
                       reps=1, warmup=0)
    torch.cuda.synchronize()
    err = (out.float() - plain["out"].float()).abs()
    res = {"name": "K1ag all-gather self-attention", "q": [B, ls, H, D], "kv": [B, L, H, D],
           "max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(), "plain_ms": plain_ms}
    del out, plain, err
    res["ms"] = cuda_ms(lambda: kernels.attention(qs, ks, vs, kernel_id="K1ag"), reps=3)
    flop = 4.0 * B * H * ls * L * D
    res.update(tflops=flop / res["ms"] / 1e9,
               **bound(tensor_bytes(qs, ks, vs, qs), flop, BF16_PEAK_TFLOPS))
    res.update(bound_share=res["bound_ms"] / res["ms"], routes=route_delta(before),
               entries=wgmma_entries("fwd", D, band=False))
    contig = [t.contiguous() for t in (qs, ks, vs)]
    res["library_ms"] = library_ms(lambda: _sdpa(*contig))
    del contig, ks, vs
    torch.cuda.empty_cache()
    emit("kernel", **res)
    require_wgmma(res["name"], res["routes"])
    if res["max_abs_err"] > ATTN_TOL["max"] or res["mean_abs_err"] > ATTN_TOL["mean"]:
        raise AssertionError(f"K1ag disagrees with its plain version: {res}")
    return res


def cp_kernel_cases(gen) -> dict:
    """K1cp, K1ring + K1merge and K1ag at the 7B self-attention shape,
    (2, 56,320, 32, 128) bf16, on one set of inputs whose K1 and K3 outputs
    on the whole sequence are the reference."""
    from gen3c_tpu_torch import kernels

    q, k, v = (torch.randn((2, LATENT_T_7B * BAND_7B[0], 32, 128), generator=gen,
                           device="cuda").to(torch.bfloat16) for _ in range(3))
    full = {None: kernels.attention(q, k, v), BAND_7B: kernels.attention(q, k, v, band=BAND_7B)}
    out = {"K1cp": _k1cp_cases(q, k, v, full), "K1ag": _k1ag_case(q, k, v)}
    out["K1ring"] = [_ring_case(q, k, v, full, cp, band) for cp in RING_CP_SIZES
                     for band in (None, BAND_7B)]
    del q, k, v, full
    torch.cuda.empty_cache()
    return out


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    results = {
        "K1": _attention_case("K1 self-attention", (2, 56320, 32, 128), (2, 56320, 32, 128),
                              bf16, ATTN_TOL, gen),
        "K2": _attention_case("K2 cross-attention", (2, 56320, 32, 128), (2, 512, 32, 128),
                              bf16, ATTN_TOL, gen),
    }
    tol32 = {"max": ATTN_F32_TOL, "mean": ATTN_F32_TOL}
    results["K1_f32"] = _attention_case("K1 fp32 D=24 ragged", (2, 1000, 4, 24), (2, 1000, 4, 24),
                                        torch.float32, tol32, gen)
    results["K1_bf16_d24"] = _attention_case("K1 bf16 D=24 ragged", (2, 1000, 4, 24),
                                             (2, 333, 4, 24), bf16, ATTN_TOL, gen, time_it=False)
    torch.cuda.empty_cache()
    results["K4_self"] = _k4_case("K4 self-attention backward", (1, 56320, 32, 128),
                                  (1, 56320, 32, 128), bf16, gen, mma_sync_too=True)
    torch.cuda.empty_cache()
    results["K4_cross"] = _k4_case("K4 cross-attention backward", (1, 56320, 32, 128),
                                   (1, 512, 32, 128), bf16, gen)
    results["K4_f32"] = [_k4_case(f"K4 fp32 D=24 ragged, {lk} keys", (2, 250, 4, 24),
                                  (2, lk, 4, 24), torch.float32, gen, time_it=False)
                         for lk in (250, 37)]
    torch.cuda.empty_cache()
    results["K4band"] = _k4_case("K4-band self-attention backward", (1, 56320, 32, 128),
                                 (1, 56320, 32, 128), bf16, gen, band=BAND_7B)
    torch.cuda.empty_cache()
    results["K4band_full"] = _k4_full_window_case(gen)
    torch.cuda.empty_cache()
    # fp32, ragged: frames of 37 tokens straddle the 32-wide tiles; prefix 2
    results["K4band_f32"] = _k4_case("K4-band fp32 D=24 ragged", (2, 250, 4, 24), (2, 250, 4, 24),
                                     torch.float32, gen, time_it=False, band=(37, 1, 2))
    results["K3lse"] = _k3lse_case(gen)
    torch.cuda.empty_cache()
    results["P1"] = [_mma_probe_case(gen, dtype) for dtype in ("bf16", "int8")]
    results["K5"] = _splat_case(gen)
    results["K6"] = _ray_case()
    results["K6_dense"] = _ray_case("K6 ray-triangle depth, dense mesh", K6_DENSE_SCENE)
    torch.cuda.empty_cache()
    results["P2"] = _p2_case(gen)
    torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    results["K3"] = _band_case(gen)
    torch.cuda.empty_cache()
    results["K7q"] = [_quant_case(gen, k) for k in (4096, 16384)]
    torch.cuda.empty_cache()
    tokens = 2 * 56320  # the CFG batch of one 121-frame chunk
    results["K7"] = [_gemm_case(gen, name, M, K, N) for name, M, K, N in [
        ("q/k/v/out", tokens, 4096, 4096), ("fc1", tokens, 4096, 16384),
        ("fc2", tokens, 16384, 4096), ("cross k/v", 2 * 512, 1024, 4096)]]
    if any(r["copied"] for r in results["K7"]):  # the 7B's codes go to TMA as they are
        raise AssertionError(f"K7 copied the codes of a 7B shape: {results['K7']}")
    torch.cuda.empty_cache()
    # ragged M, N and K (1,000: no tensor map describes rows of 1,000 bytes)
    results["K7_ragged"] = _gemm_case(gen, "ragged", 4099, 1000, 4104)
    torch.cuda.empty_cache()
    results.update(cp_kernel_cases(gen))
    return results


def _seed_image(h: int, w: int, seed: int) -> np.ndarray:
    """A numpy-seeded smooth image, (1, 3, 1, h, w) in [-1, 1]."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(-1, 1, (3, h // 32 + 1, w // 32 + 1)).astype(np.float32)
    img = np.repeat(np.repeat(coarse, 32, axis=1), 32, axis=2)[:, :h, :w]
    img = img + 0.1 * rng.standard_normal((3, h, w)).astype(np.float32)
    return np.clip(img, -1, 1)[None, :, None]


def _run_chain(model, preset, device, num_frames, num_steps, seed, **pipeline_kw):
    from gen3c_tpu_torch.cache import Cache3DBuffer
    from gen3c_tpu_torch.ops.camera import generate_camera_trajectory
    from gen3c_tpu_torch.pipelines.chunked import run_chunked_generation
    from gen3c_tpu_torch.pipelines.depth import HeuristicDepthEstimator
    from gen3c_tpu_torch.pipelines.gen3c_pipeline import Gen3cPipeline

    h, w = preset.height, preset.width
    image = _seed_image(h, w, seed)
    estimator = HeuristicDepthEstimator()
    depth, k, _ = estimator((image[0, :, 0].transpose(1, 2, 0) + 1) / 2)
    w2c0 = np.eye(4, dtype=np.float32)
    cache = Cache3DBuffer(frame_buffer_max=2, input_image=torch.from_numpy(image[:, :, 0]),
                          input_depth=torch.from_numpy(depth[None, None]),
                          input_w2c=torch.from_numpy(w2c0[None]),
                          input_intrinsics=torch.from_numpy(k[None]),
                          filter_points_threshold=0.05, device=device)
    w2cs, ks = generate_camera_trajectory("left", w2c0, k, num_frames, 0.3, "center_facing", 1.0,
                                          device=device)
    pipeline = Gen3cPipeline(model=model, num_steps=num_steps, guidance=1.0, **pipeline_kw)
    timings = {}
    video, _ = run_chunked_generation(pipeline, cache, w2cs, ks, seed_frames=image, prompt="",
                                      update_cache_with_depth=estimator, timings=timings)
    return video, pipeline, timings


def build_7b():
    """The GEN3C-7B (bf16 DiT, fp32 VAE, seed 0, AdaLN output layers and
    final linear randomized from seed 1 so that the output depends on the
    attention) on the card, built once for main_path, dynamic, multiview
    and the cp phase's references: (model, preset, seconds)."""
    from gen3c_tpu_torch.pipelines.factory import build_gen3c_model

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, preset = build_gen3c_model("gen3c_7b", device="cuda", seed=0)
    _randomize_gates(model.net, torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    return model, preset, time.perf_counter() - t0


@contextlib.contextmanager
def _depth(net, blocks):
    """Run ``net`` with its first ``blocks`` blocks only (None: all of
    them); the others come back after."""
    if blocks is None:
        yield
        return
    saved = dict(net.blocks.items())
    for name in list(saved)[blocks:]:
        del net.blocks[name]
    try:
        yield
    finally:
        for name, blk in saved.items():
            if name not in net.blocks:
                net.blocks[name] = blk


class _OneSampleAtATime(torch.nn.Module):
    """The DiT called on one sample at a time: the CFG pair as two B = 1
    forwards, whose linears run on half the rows, as each cp or cfg rank
    runs them. The same arithmetic as the batched call but for cuBLAS's
    tiling and bf16's rounding of it."""

    def __init__(self, net):
        super().__init__()
        self.net = net
        self.cfg = net.cfg

    def forward(self, x, t, ctx, **kw):
        return torch.cat([self.net(x[i:i + 1], t[i:i + 1], ctx[i:i + 1], **kw)
                          for i in range(x.shape[0])])


def _rel_diff(got: np.ndarray, ref: np.ndarray) -> dict:
    d = np.abs(got - ref)
    scale = float(np.abs(ref).mean())
    return {"max_abs_diff": float(d.max()), "mean_abs_diff": float(d.mean()),
            "rel_max": float(d.max()) / scale, "rel_mean": float(d.mean()) / scale}


def phase_cp_reference(model, preset, main_latent: np.ndarray) -> dict:
    """What the cp phase is held to: the single-process latents (main_path's
    for the 28-block run, main_path's chunk and steps at CP_SHORT_BLOCKS
    blocks for the others) and, at both depths, the bf16 noise floor: how
    far the same single process moves when it runs one sample at a time."""
    def run(blocks, one_at_a_time):
        net = model.net
        if one_at_a_time:
            model.net = _OneSampleAtATime(net)
        try:
            with _depth(net, blocks):
                _, pipeline, _ = _run_chain(model, preset, "cuda", num_frames=121,
                                            num_steps=MAIN_STEPS, seed=0)
        finally:
            model.net = net
        return pipeline.last_samples.float().cpu().numpy()

    short = run(CP_SHORT_BLOCKS, False)
    noise = {"full": _rel_diff(run(None, True), main_latent),
             "short": _rel_diff(run(CP_SHORT_BLOCKS, True), short)}
    torch.cuda.empty_cache()
    emit("cp_reference", blocks=CP_SHORT_BLOCKS, one_sample_at_a_time=noise)
    return {"short": short, "noise": noise}


# the cp phase's runs, in order: (name, parallel strategy, cp_attn, blocks)
CP_RUNS = (("ulysses", "cp", "ulysses", None), ("ring", "cp", "ring", CP_SHORT_BLOCKS),
           ("allgather", "cp", "allgather", CP_SHORT_BLOCKS),
           ("cfg2", "cfg2", "allgather", CP_SHORT_BLOCKS))


def cp_worker(rank: int, port: int, out_dir: str) -> int:
    """One rank of the cp phase, a process of its own with torchrun's
    environment: the 7B (main_path's seeds) through build_gen3c_model over
    CP_RANKS ranks on cuda:0 with gloo, then each of CP_RUNS through
    main_path's entry point (run_chunked_generation, 121 frames,
    MAIN_STEPS steps); per run its seconds, collective traffic, peak GiB
    and launches to rank<r>.json, and rank 0's latent to cp_<name>.npy."""
    import dataclasses

    import torch.distributed as dist

    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.models import dit
    from gen3c_tpu_torch.parallel import collectives, mesh
    from gen3c_tpu_torch.pipelines.factory import build_gen3c_model

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(CP_RANKS),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.cuda.set_per_process_memory_fraction(CP_MEMORY_FRACTION, 0)
    t0 = time.perf_counter()
    model, preset = build_gen3c_model("gen3c_7b", device="cuda:0", seed=0, num_devices=CP_RANKS,
                                      parallel="cp", cp_attn="ulysses", dist_backend="gloo")
    _randomize_gates(model.net, torch.Generator(device="cuda:0").manual_seed(1))
    groups = {"cp": model.groups, "cfg2": mesh.make_groups(cfg=2, backend="gloo")}
    torch.cuda.synchronize()
    out = {"rank": rank, "build_s": time.perf_counter() - t0,
           "backend": dist.get_backend(model.groups.cp.group), "runs": {}}
    for name, parallel, impl, blocks in CP_RUNS:
        model.groups = groups[parallel]
        model.net.cfg = dataclasses.replace(model.net.cfg, cp_attn_impl=impl)
        with _depth(model.net, blocks):
            torch.cuda.synchronize()
            dist.barrier()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            collectives.reset_traffic()
            dit.ring_steps.update(folded=0, skipped=0)
            t0 = time.perf_counter()
            _, pipeline, _ = _run_chain(model, preset, "cuda:0", num_frames=121,
                                        num_steps=MAIN_STEPS, seed=0)
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
            launches = dict(kernels.launch_counts)
            routes = dict(kernels.route_counts)
        samples = pipeline.last_samples
        if rank == 0:
            np.save(os.path.join(out_dir, f"cp_{name}.npy"), samples.float().cpu().numpy())
        steps = pipeline.last_timings["denoise_steps"]
        out["runs"][name] = {
            "parallel": parallel, "cp_attn": impl, "blocks": blocks or preset.dit.num_blocks,
            "step_s": [s["seconds"] for s in steps], "chunk_s": total_s,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "launches": launches,
            "routes": routes, "traffic_per_step": {op: {k: v / len(steps) for k, v in c.items()}
                                 for op, c in collectives.traffic.items() if c["calls"]},
            "ring_steps": dict(dit.ring_steps),
            "latents_finite": bool(torch.isfinite(samples).all().item())}
        del pipeline, samples
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_cp(main_latent: np.ndarray, refs: dict) -> dict:
    """CP_RANKS ranks of the 7B on the one card (cp_worker, gloo): Ulysses
    over all 28 blocks against main_path's single-process latent, and
    ring, all-gather and cfg2 at CP_SHORT_BLOCKS blocks against
    phase_cp_reference's, each within CP_NOISE_FACTOR times that depth's
    noise floor (not below CP_TOL). The ranks share the card and their
    collectives go through host memory: none of these times is a
    multi-card time."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    parent_gib = torch.cuda.memory_allocated() / 2 ** 30
    free_gib = torch.cuda.mem_get_info()[0] / 2 ** 30
    os.makedirs(OUT_DIR, exist_ok=True)
    out_dir = tempfile.mkdtemp(dir=OUT_DIR, prefix="cp_")
    logs = [open(os.path.join(out_dir, f"rank{r}.log"), "w") for r in range(CP_RANKS)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--cp-rank", str(r),
                               "--cp-port", str(port), "--cp-out", out_dir],
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(CP_RANKS)]
    t0 = time.perf_counter()
    try:
        for proc in procs:
            proc.wait(timeout=max(1.0, CP_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs:
            f.close()
    wall_s = time.perf_counter() - t0
    if any(proc.returncode != 0 for proc in procs):
        tails = [open(os.path.join(out_dir, f"rank{r}.log")).read()[-3000:] for r in range(CP_RANKS)]
        raise AssertionError(f"cp: ranks exited {[p.returncode for p in procs]} after "
                             f"{wall_s:.0f} s (this process held {parent_gib:.2f} GiB, "
                             f"{free_gib:.2f} GiB free):\n" + "\n----\n".join(tails))
    ranks = [json.load(open(os.path.join(out_dir, f"rank{r}.json"))) for r in range(CP_RANKS)]
    res = {"ranks": CP_RANKS, "backend": ranks[0]["backend"], "wall_s": wall_s,
           "build_s": [r["build_s"] for r in ranks], "parent_gib": parent_gib,
           "free_gib_at_start": free_gib, "noise": refs["noise"],
           "note": "both ranks share one card and their collectives go through host memory "
                   "(gloo): no time here is a multi-card time", "runs": {}}
    bad = []
    for name, _, _, blocks in CP_RUNS:
        ref = main_latent if blocks is None else refs["short"]
        noise = refs["noise"]["full" if blocks is None else "short"]
        tol = {k: max(CP_TOL[k], CP_NOISE_FACTOR * noise[f"rel_{k}"]) for k in ("max", "mean")}
        run = {"rank": [r["runs"][name] for r in ranks], "tol": tol,
               **_rel_diff(np.load(os.path.join(out_dir, f"cp_{name}.npy")), ref)}
        res["runs"][name] = run
        if run["rel_max"] > tol["max"] or run["rel_mean"] > tol["mean"] or not all(
                r["latents_finite"] for r in run["rank"]):
            bad.append(f"{name} disagrees with the single process")
        launches = run["rank"][0]["launches"]
        want = {"ulysses": ("K1cp", "K2", "K5"), "ring": ("K1ring", "K1merge", "K2"),
                "allgather": ("K1ag", "K2"), "cfg2": ("K1", "K2")}[name]
        stray = {"ulysses": ("K1", "K1ag", "K1ring"), "ring": ("K1", "K1cp", "K1ag"),
                 "allgather": ("K1", "K1cp", "K1ring"), "cfg2": ("K1cp", "K1ag", "K1ring")}[name]
        if any(launches[k] == 0 for k in want) or any(launches[k] for k in stray):
            bad.append(f"{name} launched {launches}")
        routes = [r["routes"] for r in run["rank"]]
        if any(r["mma_sync"] or not r["wgmma"] for r in routes):
            bad.append(f"{name}: attention launches by body {routes}, expected wgmma only")
    shutil.rmtree(out_dir, ignore_errors=True)
    emit("cp", **res)
    if bad:
        raise AssertionError(f"cp: {bad}: {res}")
    return res


def phase_main(model, preset, build_s: float) -> dict:
    from gen3c_tpu_torch import kernels

    cfg = preset.dit
    n_params = sum(p.numel() for p in model.net.parameters())

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    video, pipeline, timings = _run_chain(model, preset, "cuda", num_frames=121,
                                          num_steps=MAIN_STEPS, seed=0)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    routes = dict(kernels.route_counts)
    samples = pipeline.last_samples
    res = {
        "model": preset.name, "blocks": cfg.num_blocks, "channels": cfg.model_channels,
        "heads": cfg.num_heads, "head_dim": cfg.head_dim, "dtype": str(cfg.dtype),
        "dit_params": n_params, "tokens": int(np.prod(samples.shape[2:]) // 4),
        "cfg_batch": 2 * samples.shape[0], "frames": int(video.shape[0]),
        "build_model_s": build_s, "render_s": timings["render"],
        "encode_condition_s": pipeline.last_timings["encode_condition"],
        "encode_warps_s": pipeline.last_timings["encode_warps"],
        "denoise_step_s": [s["seconds"] for s in pipeline.last_timings["denoise_steps"]],
        "decode_s": pipeline.last_timings["decode"], "chunk_total_s": total_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "launches": launches,
        "routes": routes, "latents_finite": bool(torch.isfinite(samples).all().item()),
        "latent_std": samples.float().std().item(),
    }
    emit("main_path", **res)
    require_wgmma("main path", routes)
    os.makedirs(OUT_DIR, exist_ok=True)
    np.save(os.path.join(OUT_DIR, "smoke_7b_video.npy"), video)
    np.save(os.path.join(OUT_DIR, "smoke_7b_latents.npy"), samples.float().cpu().numpy())
    if video.shape != (121, 704, 1280, 3) or video.dtype != np.uint8:
        raise AssertionError(f"main path: video {video.shape} {video.dtype}")
    if not res["latents_finite"]:
        raise AssertionError("main path: non-finite latents")
    missing = [k for k in ("K1", "K2", "K5") if launches[k] == 0]
    if missing:
        raise AssertionError(f"main path did not launch kernels {missing}: {launches}")
    res["samples"] = samples.float().cpu().numpy()  # the cp phase's 28-block reference
    del pipeline, samples
    torch.cuda.empty_cache()
    return res


def _dynamic_clip(path: str, preset, seed: int = 0) -> None:
    """A seeded packaged clip of one chunk: the seed image panning 2 pixels
    a frame over a depth whose discs and railing (``_foreground_depth``)
    move 2 pixels a frame, filmed by a static camera."""
    from gen3c_tpu_torch.pipelines.depth import default_intrinsics

    h, w, n = preset.height, preset.width, preset.chunk_size
    base = _seed_image(h, w, seed)[0, :, 0].astype(np.float16)
    image = np.stack([np.roll(base, 2 * i, axis=2) for i in range(n)])
    depth = np.stack([_foreground_depth(h, w, seed, shift=2.0 * i).cpu().numpy()
                      for i in range(n)])[:, None]
    np.savez(path, image=image, depth=depth,
             w2c=np.repeat(np.eye(4, dtype=np.float32)[None], n, 0),
             intrinsics=np.repeat(default_intrinsics(h, w)[None], n, 0))


def phase_dynamic(model, preset) -> dict:
    """The gen3c_dynamic CLI's entry point on a packaged 121-frame clip with
    foreground masking, then the chunk's buffers rendered again without and
    with masking (render seconds, the fraction of splatted pixels culled)."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.pipelines import gen3c_dynamic

    n = preset.chunk_size
    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as root:
        t0 = time.perf_counter()
        _dynamic_clip(os.path.join(root, "clip.npz"), preset)
        clip_s = time.perf_counter() - t0
        argv = ["--input_video_path", os.path.join(root, "clip.npz"), "--model_preset", preset.name,
                "--num_video_frames", str(n), "--num_steps", str(DYNAMIC_STEPS),
                "--trajectory", "left", "--video_save_folder", root, "--device", "cuda"]
        args = gen3c_dynamic.create_parser().parse_args(argv + ["--foreground_masking"])
        record = {}
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        path = gen3c_dynamic.demo(args, built=(model, preset), record=record)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = dict(kernels.launch_counts)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        saved = os.path.getsize(path) if os.path.isfile(path) else 0
        renders = {}
        for masking in (False, True):
            cache, w2cs, ks, _ = gen3c_dynamic.load_scene(
                gen3c_dynamic.create_parser().parse_args(
                    argv + (["--foreground_masking"] if masking else [])), preset,
                torch.device("cuda"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, masks = cache.render_cache(w2cs, ks, start_frame_idx=0)
            torch.cuda.synchronize()
            renders[masking] = (time.perf_counter() - t0, masks > 0)
            del cache, masks
        known, kept = renders[False][1], renders[True][1]
        pipe = record["pipeline"]
        res = {"model": preset.name, "frames": n, "steps": DYNAMIC_STEPS, "clip_s": clip_s,
               "render_s": record["render"], "render_unmasked_s": renders[False][0],
               "render_masked_s": renders[True][0],
               "culled_fraction": ((known & ~kept).sum() / known.sum()).item(),
               "known_fraction": known.float().mean().item(),
               "encode_condition_s": pipe["encode_condition"], "encode_warps_s": pipe["encode_warps"],
               "denoise_step_s": [st["seconds"] for st in pipe["denoise_steps"]],
               "decode_s": pipe["decode"], "total_s": total_s, "peak_mem_gib": peak,
               "launches": launches, "saved": [os.path.basename(path), saved],
               "video_shape": list(record["video"].shape)}
        del known, kept, renders
    emit("dynamic", **res)
    if res["video_shape"] != [n, preset.height, preset.width, 3] or not saved:
        raise AssertionError(f"dynamic: video {res['video_shape']}, {saved} bytes saved")
    missing = [k for k in ("K1", "K2", "K5", "K6") if launches[k] == 0]
    if missing or launches["K6"] != n or not res["culled_fraction"] > 0:
        raise AssertionError(f"dynamic: launches {launches} (K6 {n} expected), "
                             f"culled {res['culled_fraction']}: {res}")
    torch.cuda.empty_cache()
    return res


def _multiview_npz(path: str, preset, seed: int = 1) -> None:
    """MULTIVIEW_KEY_FRAMES seeded key frames of one scene (the depth of
    ``_foreground_depth``) from cameras 0.1 apart, and the trajectory: one
    chunk moving left from the first key frame's camera."""
    from gen3c_tpu_torch.ops.camera import generate_camera_trajectory
    from gen3c_tpu_torch.pipelines.depth import default_intrinsics

    h, w, n, keys = preset.height, preset.width, preset.chunk_size, MULTIVIEW_KEY_FRAMES
    k = default_intrinsics(h, w)
    w2c = np.repeat(np.eye(4, dtype=np.float32)[None], keys, 0)
    w2c[:, 0, 3] = [0.0, 0.1, -0.1, 0.2]
    w2cs, ks = generate_camera_trajectory("left", np.eye(4, dtype=np.float32), k, n, 0.3,
                                          "center_facing", 1.0)
    depth = _foreground_depth(h, w, seed).cpu().numpy()
    np.savez(path, images_key_frames=np.concatenate([_seed_image(h, w, seed + i)[:, :, 0]
                                                     for i in range(keys)]),
             depth_key_frames=np.repeat(depth[None, None], keys, 0),
             K_key_frames=np.repeat(k[None], keys, 0), w2cs_key_frames=w2c,
             w2cs_all=np.asarray(w2cs, np.float32).reshape(n, 4, 4),
             Ks_all=np.asarray(ks, np.float32).reshape(n, 3, 3))


def phase_multiview(model, preset) -> dict:
    """The gen3c_multiview CLI's entry point: 4 key frames, the top 2
    buffers by rendered overlap, foreground masking, one chunk."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.pipelines import gen3c_multiview

    n = preset.chunk_size
    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as root:
        _multiview_npz(os.path.join(root, "mv.npz"), preset)
        args = gen3c_multiview.create_parser().parse_args(
            ["--npz_path", os.path.join(root, "mv.npz"), "--model_preset", preset.name,
             "--num_video_frames", str(n), "--num_steps", str(MULTIVIEW_STEPS),
             "--frame_buffer_max", "2", "--foreground_masking", "--video_save_folder", root,
             "--device", "cuda"])
        record = {}
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        path = gen3c_multiview.demo(args, built=(model, preset), record=record)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = dict(kernels.launch_counts)
        saved = os.path.getsize(path) if os.path.isfile(path) else 0
    pipe = record["pipeline"]
    res = {"model": preset.name, "key_frames": MULTIVIEW_KEY_FRAMES, "frame_buffer_max": 2,
           "frames": n, "steps": MULTIVIEW_STEPS, "selections": record["selections"],
           "render_s": record["render"], "encode_warps_s": pipe["encode_warps"],
           "denoise_step_s": [st["seconds"] for st in pipe["denoise_steps"]],
           "decode_s": pipe["decode"], "total_s": total_s,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "launches": launches,
           "saved": [os.path.basename(path), saved], "video_shape": list(record["video"].shape)}
    emit("multiview", **res)
    if res["video_shape"] != [n, preset.height, preset.width, 3] or not saved:
        raise AssertionError(f"multiview: video {res['video_shape']}, {saved} bytes saved")
    if (len(res["selections"]) != 1 or len(res["selections"][0]) != 2
            or any(launches[k] == 0 for k in ("K1", "K2", "K5", "K6"))):
        raise AssertionError(f"multiview: {res}")
    torch.cuda.empty_cache()
    return res


FAST_STEPS = 8
# at 8 steps the guidance interval 1.75..81 covers steps 0-3; the cache
# (interval 2, 2 warmup and 2 tail steps) runs the net on 0, 1, 2, 4, 6, 7
FAST_PATTERN = [(True, True)] * 3 + [(True, False), (False, True), (False, False),
                                     (False, True), (False, True)]


def phase_fast() -> dict:
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.models.quantize import QuantLinear
    from gen3c_tpu_torch.pipelines import factory

    args = argparse.Namespace(perf_preset="fast", quantize_w8a8=False, quantize_int8=False,
                              attn_temporal_window=None, step_cache_interval=1,
                              step_cache_threshold=0.0, guidance_interval=None)
    factory.apply_perf_preset(args)
    torch.cuda.reset_peak_memory_stats()
    timed = {}
    quantize = factory.quantize_dit_

    def timed_quantize(net, act_quant):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = quantize(net, act_quant=act_quant)
        torch.cuda.synchronize()
        timed["quantize_s"] = time.perf_counter() - t0
        return out

    factory.quantize_dit_ = timed_quantize  # time the quantize inside the user entry point
    try:
        t0 = time.perf_counter()
        model, preset = factory.build_gen3c_model(
            "gen3c_7b", device="cuda", seed=0, quantize="w8a8" if args.quantize_w8a8 else False,
            attn_temporal_window=args.attn_temporal_window)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    finally:
        factory.quantize_dit_ = quantize
    qlinears = [m for m in model.net.modules() if isinstance(m, QuantLinear)]
    int8_bytes = sum(m.weight.numel() for m in qlinears)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    video, pipeline, timings = _run_chain(
        model, preset, "cuda", num_frames=121, num_steps=FAST_STEPS, seed=0,
        step_cache_interval=args.step_cache_interval,
        guidance_interval=tuple(args.guidance_interval))
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    steps = pipeline.last_timings["denoise_steps"]
    kinds = [(s["cfg"], s["refresh"]) for s in steps]
    samples = pipeline.last_samples
    res = {
        "model": preset.name, "quantize": "w8a8", "band": [44 * 80, args.attn_temporal_window, 1],
        "step_cache_interval": args.step_cache_interval,
        "guidance_interval": list(args.guidance_interval), "num_steps": FAST_STEPS,
        "quant_linears": len(qlinears), "int8_weight_gb": int8_bytes / 1e9,
        "build_model_s": build_s, "quantize_s": timed["quantize_s"],
        "steps": [{"s": s["seconds"], "cfg": s["cfg"], "refresh": s["refresh"]} for s in steps],
        "denoise_s": sum(s["seconds"] for s in steps),
        "encode_condition_s": pipeline.last_timings["encode_condition"],
        "encode_warps_s": pipeline.last_timings["encode_warps"],
        "decode_s": pipeline.last_timings["decode"], "render_s": timings["render"],
        "chunk_total_s": total_s, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": launches, "latents_finite": bool(torch.isfinite(samples).all().item()),
        "latent_std": samples.float().std().item(), "frames": int(video.shape[0]),
    }
    emit("fast", **res)
    if kinds != FAST_PATTERN:
        raise AssertionError(f"fast: step pattern {kinds}, expected {FAST_PATTERN}")
    if video.shape != (121, 704, 1280, 3) or not res["latents_finite"]:
        raise AssertionError(f"fast: video {video.shape}, finite latents {res['latents_finite']}")
    if len(qlinears) != 28 * 10 + 3:  # q/k/v/out x 2, fc1, fc2 per block; x/t embedders
        raise AssertionError(f"fast: {len(qlinears)} quantized linears")
    if not (launches["K3"] > 0 and launches["K7"] > 0 and launches["K7q"] > 0
            and launches["K1"] == 0):
        raise AssertionError(f"fast path launches: {launches}")
    del model, pipeline, samples
    torch.cuda.empty_cache()
    return res


def phase_fast_parity() -> dict:
    """W8A8 + band DiT on the card (kernels) against the CPU (plain versions)."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.models.dit import DiTConfig, GeneralDIT
    from gen3c_tpu_torch.models.quantize import QuantLinear, quantize_dit_

    cfg = DiTConfig(in_channels=16 + 16 * 4 + 1, model_channels=1024, num_blocks=2,
                    num_heads=8, rope_t_extrapolation_ratio=2.0, attn_temporal_window=1)
    cpu = GeneralDIT(cfg).init_random(torch.Generator().manual_seed(2))
    _randomize_gates(cpu, torch.Generator().manual_seed(3))
    gpu = copy.deepcopy(cpu).to("cuda")
    rng = np.random.default_rng(0)
    T, H, W = 5, 24, 40  # 12 x 20 = 240 tokens per latent frame: frames straddle tiles
    x = torch.from_numpy(rng.standard_normal((2, cfg.in_channels, T, H, W)).astype(np.float32))
    t = torch.from_numpy(rng.uniform(-2, 1, (2,)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 512, 1024)).astype(np.float32))
    ctx[1] = 0  # the zero text embedding of the uncond half
    # the bf16 rounding noise between the two routes, before quantization
    base = (gpu(x.cuda(), t.cuda(), ctx.cuda(), fps=24.0).float().cpu()
            - cpu(x, t, ctx, fps=24.0).float()).abs()
    quantize_dit_(cpu, act_quant=True)  # plain version
    quantize_dit_(gpu, act_quant=True)  # K7q
    cpu_q = {n: m for n, m in cpu.named_modules() if isinstance(m, QuantLinear)}
    codes_equal = all(torch.equal(m.weight.cpu(), cpu_q[n].weight)
                      and torch.equal(m.scale.cpu(), cpu_q[n].scale)
                      for n, m in gpu.named_modules() if isinstance(m, QuantLinear))
    kernels.reset_launch_counts()
    got = gpu(x.cuda(), t.cuda(), ctx.cuda(), fps=24.0).float().cpu()
    launches = dict(kernels.launch_counts)
    want = cpu(x, t, ctx, fps=24.0).float()
    err = (got - want).abs()
    scale = want.abs().mean().item()
    res = {"dit": "1024 ch x 2 blocks x 8 heads, bf16, W8A8, band window 1",
           "tokens": T * H * W // 4, "quant_linears": len(cpu_q), "weight_codes_equal": codes_equal,
           "max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
           "mean_abs_out": scale, "rel_max_err": err.max().item() / scale,
           "rel_mean_err": err.mean().item() / scale,
           "bf16_unquantized_rel_max_err": base.max().item() / scale,
           "bf16_unquantized_rel_mean_err": base.mean().item() / scale,
           "rel_tol": FAST_PARITY_TOL, "launches": launches}
    emit("fast_parity", **res)
    if not codes_equal or not torch.isfinite(got).all():
        raise AssertionError(f"fast_parity: {res}")
    if res["rel_max_err"] > FAST_PARITY_TOL["max"] or res["rel_mean_err"] > FAST_PARITY_TOL["mean"]:
        raise AssertionError(f"fast_parity: card and CPU disagree: {res}")
    if launches["K3"] != cfg.num_blocks or launches["K1"] or not launches["K7"]:
        raise AssertionError(f"fast_parity did not run K3/K7: {launches}")
    return res


def _randomize_gates(net, gen) -> None:
    """Random AdaLN output layers and final linear (a fresh init has them
    zero, which makes the network's output identically zero)."""
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("adaLN_modulation.2.weight") or name == "final_layer.linear.weight":
                p.copy_(0.1 * torch.randn(p.shape, generator=gen, device=p.device))


def phase_chain() -> dict:
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.pipelines.factory import build_gen3c_model

    cpu_model, preset = build_gen3c_model("gen3c_tiny", device="cpu", seed=0)
    _randomize_gates(cpu_model.net, torch.Generator().manual_seed(1))
    gpu_model, _ = build_gen3c_model("gen3c_tiny", device="cuda", seed=0)
    gpu_model.net.load_state_dict(cpu_model.net.state_dict())
    gpu_model.tokenizer.vae.load_state_dict(cpu_model.tokenizer.vae.state_dict())

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # compare fp32 with fp32
    try:
        kernels.reset_launch_counts()
        gpu_video, _, timings = _run_chain(gpu_model, preset, "cuda", 17, 2, seed=1)
        launches = dict(kernels.launch_counts)
        cpu_video, _, _ = _run_chain(cpu_model, preset, "cpu", 17, 2, seed=1)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    diff = np.abs(gpu_video.astype(np.int16) - cpu_video.astype(np.int16))
    res = {
        "model": preset.name, "frames": int(gpu_video.shape[0]), "launches": launches,
        "render_s": timings["render"], "update_s": timings["update"],
        "chunk1_within_1": float((diff[:9] <= 1).mean()), "chunk1_max_diff": int(diff[:9].max()),
        # chunk 2 follows a 100-step Adam fit on an L1 objective on each
        # device: a few lr apart by construction, so it is reported only
        "chunk2_mean_abs_diff": float(diff[9:].mean()),
    }
    emit("ar_chain", **res)
    if gpu_video.shape != (17, preset.height, preset.width, 3):
        raise AssertionError(f"AR chain: video {gpu_video.shape}")
    if len(timings["update"]) != 1 or any(launches[k] == 0 for k in ("K1", "K2", "K5")):
        raise AssertionError(f"AR chain did not run update_cache and every kernel on the card: {res}")
    if res["chunk1_within_1"] < 0.999:
        raise AssertionError(f"AR chain: card and CPU disagree on chunk 1: {res}")
    return res


def _train_batch(cfg, T, H, W, ctx_len, seed):
    """One synthetic clip (B=1) drawn on the CPU from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return {"x0": torch.randn((1, 16, T, H, W), generator=gen),
            "crossattn_emb": torch.randn((1, ctx_len, 1024), generator=gen),
            "extra_channels": torch.randn((1, cfg.in_channels - 16, T, H, W), generator=gen)}


def phase_train() -> dict:
    """train_step at GEN3C-7B width, 12 blocks, one 121-frame clip."""
    import dataclasses

    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.pipelines.factory import GEN3C_7B_PRESET
    from gen3c_tpu_torch.training.train import build_net
    from gen3c_tpu_torch.training.train_step import init_train_state, make_optimizer, train_step
    from gen3c_tpu_torch.training.trainer import TrainerConfig

    cfg = dataclasses.replace(GEN3C_7B_PRESET.dit, num_blocks=TRAIN_BLOCKS_7B)
    tc = TrainerConfig()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    net = build_net(cfg, "cuda", seed=0)
    _randomize_gates(net, torch.Generator(device="cuda").manual_seed(1))
    opt = make_optimizer(lr=tc.lr, weight_decay=tc.weight_decay, grad_clip=tc.grad_clip,
                         warmup_steps=tc.warmup_steps, grad_accum_steps=tc.grad_accum_steps)
    state = init_train_state(net, opt)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in net.parameters())
    res = {"model": "gen3c_7b", "blocks": cfg.num_blocks, "channels": cfg.model_channels,
           "heads": cfg.num_heads, "head_dim": cfg.head_dim, "dtype": str(cfg.dtype),
           "params": n_params, "build_s": time.perf_counter() - t0,
           # bf16 params, grads, AdamW mu and nu (2 bytes each) + fp32 EMA (4)
           "state_gib_reckoned": n_params * 12 / 2 ** 30,
           "state_gib_measured_without_grads": (torch.cuda.memory_allocated() - base) / 2 ** 30}
    T, H, W = LATENT_T_7B, 88, 160
    batch = {k: v.cuda() for k, v in _train_batch(cfg, T, H, W, 512, seed=0).items()}
    res.update(latent=[16, T, H, W], tokens=T * H * W // 4, ctx_tokens=512, batch=1, remat=True,
               optimizer={"lr": tc.lr, "weight_decay": tc.weight_decay,
                          "grad_clip": tc.grad_clip, "warmup_steps": tc.warmup_steps})
    gen = torch.Generator().manual_seed(0)
    kernels.reset_launch_counts()
    steps = []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(state, batch, gen, cfg, opt, remat=True)
        torch.cuda.synchronize()
        steps.append({"s": time.perf_counter() - t0, "loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"])})
    launches = dict(kernels.launch_counts)
    res.update(steps=steps, launches=launches, routes=dict(kernels.route_counts),
               k4_by_forward=dict(kernels.k4_launches_by_forward),
               peak_gib=(torch.cuda.max_memory_allocated() - base) / 2 ** 30, step=state.step,
               ema_finite=bool(all(torch.isfinite(e).all().item()
                                   for e in state.ema_params.values())))
    emit("train", **res)
    require_wgmma("train", res["routes"])
    per_step = 2 * cfg.num_blocks  # one K4 per attention backward: self and cross
    if not all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) and s["grad_norm"] > 0
               for s in steps) or not res["ema_finite"]:
        raise AssertionError(f"train: non-finite or zero loss / grad-norm: {res}")
    if (launches["K4"] != TRAIN_STEPS * per_step or launches["K1"] != TRAIN_STEPS * per_step
            or launches["K2"] != TRAIN_STEPS * per_step or launches["K3"]):
        raise AssertionError(f"train: launches {launches}, expected K4 = K1 = K2 = "
                             f"{TRAIN_STEPS * per_step} (remat runs each forward twice)")
    del state, net, batch
    torch.cuda.empty_cache()
    return res


def _synthetic_clip(frames: int, h: int, w: int, seed: int):
    """A seeded RGBD clip: the seed image panning (2 pixels a frame), a
    slanted depth plane, and cameras moving left along a trajectory; as a
    packaged clip holds them: (image, depth, w2c, intrinsics)."""
    from gen3c_tpu_torch.ops.camera import generate_camera_trajectory
    from gen3c_tpu_torch.pipelines.depth import default_intrinsics

    base = _seed_image(h, w, seed)[0, :, 0]
    image = np.stack([np.roll(base, 2 * i, axis=2) for i in range(frames)])
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    depth = np.broadcast_to((2.5 - 0.8 * yy + 0.3 * np.sin(6 * xx)).astype(np.float32),
                            (frames, 1, h, w)).copy()
    k = default_intrinsics(h, w)
    w2c, ks = generate_camera_trajectory("left", np.eye(4, dtype=np.float32), k, frames, 0.3,
                                         "center_facing", 1.0)
    return (image, depth, np.asarray(w2c, np.float32).reshape(frames, 4, 4),
            np.asarray(ks, np.float32).reshape(frames, 3, 3))


def phase_lora_band_train() -> dict:
    """LoRA fine-tuning of the full 28-block GEN3C-7B with the fast preset's
    band: a batch from build_gen3c_train_batch on a 121-frame 704x1280 RGBD
    clip (7B VAE, K5), then lora_train_step (rank 16 on DEFAULT_TARGETS,
    remat, make_optimizer with warmup 1) over the frozen base."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.pipelines.factory import build_gen3c_model
    from gen3c_tpu_torch.training.datasets import build_gen3c_train_batch
    from gen3c_tpu_torch.training.lora import init_lora_params, lora_leaves, lora_train_step
    from gen3c_tpu_torch.training.train_step import make_optimizer
    from gen3c_tpu_torch.training.trainer import TrainerConfig

    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model, preset = build_gen3c_model("gen3c_7b", device="cuda", seed=0,
                                      attn_temporal_window=BAND_7B[1])
    net, cfg = model.net, preset.dit
    _randomize_gates(net, torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    res = {"model": preset.name, "blocks": cfg.num_blocks, "channels": cfg.model_channels,
           "heads": cfg.num_heads, "head_dim": cfg.head_dim, "dtype": str(cfg.dtype),
           "band": [BAND_7B[0], cfg.attn_temporal_window, cfg.attn_prefix_frames],
           "build_model_s": time.perf_counter() - t0,
           "base_gib_reckoned": sum(tensor_bytes(p) for p in net.parameters()) / 2 ** 30,
           "model_gib_measured": (torch.cuda.memory_allocated() - mem0) / 2 ** 30}  # DiT + VAE
    saved = {n: p.detach().cpu() for n, p in net.named_parameters()}

    image, depth, w2c, k = _synthetic_clip(preset.chunk_size, preset.height, preset.width, seed=0)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    batch = build_gen3c_train_batch(model, image, depth, w2c, k)
    torch.cuda.synchronize()
    res.update(batch_s=time.perf_counter() - t0, batch_launches=dict(kernels.launch_counts),
               latent=list(batch["x0"].shape[1:]), tokens=int(np.prod(batch["x0"].shape[2:])) // 4,
               extra_channels=batch["extra_channels"].shape[1],
               batch_finite=bool(all(torch.isfinite(t).all().item() for t in batch.values())))
    del image, depth

    mem1 = torch.cuda.memory_allocated()
    lora = init_lora_params(torch.Generator(device="cuda").manual_seed(0), net, rank=LORA_RANK)
    tc = TrainerConfig()
    opt = make_optimizer(lr=tc.lr, weight_decay=tc.weight_decay, grad_clip=tc.grad_clip,
                         warmup_steps=1)
    opt_state = opt.init(lora_leaves(lora))
    n_adapter = sum(t.numel() for t in lora_leaves(lora).values())
    res.update(rank=LORA_RANK, adapters=len(lora), adapter_params=n_adapter,
               # fp32 A and B, Adam's mu and nu
               adapter_gib_reckoned=n_adapter * 4 * 3 / 2 ** 30,
               adapter_gib_measured=(torch.cuda.memory_allocated() - mem1) / 2 ** 30,
               optimizer={"lr": tc.lr, "weight_decay": tc.weight_decay,
                          "grad_clip": tc.grad_clip, "warmup_steps": 1})
    gen = torch.Generator().manual_seed(0)
    kernels.reset_launch_counts()
    steps = []
    for _ in range(LORA_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lora, opt_state, m = lora_train_step(lora, opt_state, net, batch, gen, cfg, opt,
                                             remat=True)
        torch.cuda.synchronize()
        steps.append({"s": time.perf_counter() - t0, "loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"])})
    launches = dict(kernels.launch_counts)
    by_forward = dict(kernels.k4_launches_by_forward)
    res.update(steps=steps, launches=launches, k4_by_forward=by_forward,
               routes=dict(kernels.route_counts),
               launches_per_step={k: v / LORA_STEPS for k, v in launches.items() if v},
               peak_gib=(torch.cuda.max_memory_allocated() - mem0) / 2 ** 30,
               adapters_moved=bool(any(ab["b"].abs().max().item() > 0 for ab in lora.values())),
               base_unchanged=all(torch.equal(p.detach().cpu(), saved[n])
                                  for n, p in net.named_parameters()))
    emit("lora_band_train", **res)
    require_wgmma("lora_band_train", res["routes"])
    n = cfg.num_blocks
    want = {"K4band": n, "K3lse": 2 * n, "K3": 0, "K2": 2 * n, "K4": n, "K1": 0}  # remat: twice
    got = {key: launches[key] / LORA_STEPS for key in want}
    if got != want or by_forward["K2"] != n * LORA_STEPS or by_forward["K1"]:
        raise AssertionError(f"lora_band_train: launches per step {got}, expected {want}: {res}")
    if not (res["base_unchanged"] and res["adapters_moved"] and res["batch_finite"]
            and all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) for s in steps)
            and res["batch_launches"]["K5"] > 0 and n == 28):
        raise AssertionError(f"lora_band_train: {res}")
    del model, net, batch, lora, opt_state, saved
    torch.cuda.empty_cache()
    return res


def phase_train_parity() -> dict:
    """One train_step of a 1024-wide bf16 DiT on the card and on the CPU."""
    return _train_parity("train_parity", window=None)


def phase_band_train_parity() -> dict:
    """The same with band window 1 over the 5 latent frames of 240 tokens:
    the band forward with lse and K4-band on the card."""
    return _train_parity("band_train_parity", window=1)


def _train_parity(phase: str, window) -> dict:
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.models.dit import DiTConfig, GeneralDIT
    from gen3c_tpu_torch.training.train_step import (
        draw_step, init_train_state, loss_and_grads, make_optimizer, train_step)

    cfg = DiTConfig(in_channels=16 + 16 * 4 + 1, model_channels=1024, num_blocks=2,
                    num_heads=8, rope_t_extrapolation_ratio=2.0, attn_temporal_window=window)
    cpu = GeneralDIT(cfg).init_random(torch.Generator().manual_seed(2))
    _randomize_gates(cpu, torch.Generator().manual_seed(3))
    gpu = copy.deepcopy(cpu).to("cuda")
    T, H, W = 5, 24, 40  # 1,200 tokens: 5 latent frames of 12 x 20
    batch = _train_batch(cfg, T, H, W, 512, seed=4)
    draws = draw_step(torch.Generator().manual_seed(5), batch["x0"].shape, False, False)
    out = {}
    for dev, net in (("cuda", gpu), ("cpu", cpu)):
        opt = make_optimizer(warmup_steps=1)
        state = init_train_state(net, opt)
        kernels.reset_launch_counts()
        loss, grads, _ = loss_and_grads(net, batch, None, cfg, draws=draws)
        launches = dict(kernels.launch_counts)
        state, m = train_step(state, batch, None, cfg, opt, draws=draws)
        out[dev] = {"loss": float(loss), "step_loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]), "launches": launches,
                    "grads": {n: g.float().cpu() for n, g in grads.items()}}
    g_cuda, g_cpu = out["cuda"].pop("grads"), out["cpu"].pop("grads")
    leaves = {}
    for n, ref in g_cpu.items():
        d = (g_cuda[n] - ref).abs()
        leaves[n] = {"rel_mean": (d.mean() / ref.abs().mean().clamp_min(1e-30)).item(),
                     "rel_max": (d.max() / ref.abs().max().clamp_min(1e-30)).item()}
    worst_mean = max(leaves.items(), key=lambda kv: kv[1]["rel_mean"])
    worst_max = max(leaves.items(), key=lambda kv: kv[1]["rel_max"])
    res = {"dit": "1024 ch x 2 blocks x 8 heads, bf16, gates randomized", "tokens": T * H * W // 4,
           "band": None if window is None else [H * W // 4, window, cfg.attn_prefix_frames],
           "cuda": out["cuda"], "cpu": out["cpu"],
           "loss_rel_err": abs(out["cuda"]["loss"] - out["cpu"]["loss"]) / abs(out["cpu"]["loss"]),
           "grad_norm_rel_err": abs(out["cuda"]["grad_norm"] - out["cpu"]["grad_norm"])
           / out["cpu"]["grad_norm"],
           "leaves": len(leaves), "worst_leaf_rel_mean": [worst_mean[0], worst_mean[1]["rel_mean"]],
           "worst_leaf_rel_max": [worst_max[0], worst_max[1]["rel_max"]],
           "median_leaf_rel_mean": float(np.median([v["rel_mean"] for v in leaves.values()])),
           "tol": TRAIN_PARITY_TOL}
    emit(phase, **res)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"{phase}_leaves.json"), "w") as f:
        json.dump(leaves, f, indent=1)
    n = cfg.num_blocks
    ran = out["cuda"]["launches"]
    want = ({"K4": 2 * n, "K4band": 0, "K1": n, "K3": 0, "K3lse": 0} if window is None
            else {"K4": n, "K4band": n, "K1": 0, "K3": 0, "K3lse": n})  # cross: K2 + K4
    if any(ran[k] != v for k, v in want.items()):
        raise AssertionError(f"{phase}: the card's step ran {ran}, expected {want}: {res}")
    if (res["loss_rel_err"] > TRAIN_PARITY_TOL["loss"]
            or res["grad_norm_rel_err"] > TRAIN_PARITY_TOL["grad_norm"]
            or worst_mean[1]["rel_mean"] > TRAIN_PARITY_TOL["leaf_mean"]
            or worst_max[1]["rel_max"] > TRAIN_PARITY_TOL["leaf_max"]):
        raise AssertionError(f"{phase}: card and CPU disagree: {res}")
    return res


def phase_train_cli() -> dict:
    """The training CLI on the card (tiny, fp32: the fp32 K4), then a resume,
    then a --data_root run on a packaged clip with band window 1 (the fp32
    K4-band, and K5 in the batches)."""
    import tempfile

    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.training import train

    with tempfile.TemporaryDirectory(dir=OUT_DIR) as job:
        args = ["--synthetic", "--remat", "experiment=gen3c_tiny", "trainer.max_iter=4",
                "trainer.save_every=2", "trainer.warmup_steps=1", f"trainer.job_dir={job}"]
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        first = train.main(args)
        first_s = time.perf_counter() - t0
        launches_first = dict(kernels.launch_counts)
        first_checkpoints = first.checkpointer.steps()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        resumed = train.main([a.replace("max_iter=4", "max_iter=6") for a in args])
        resumed_s = time.perf_counter() - t0
        launches_resumed = dict(kernels.launch_counts)
        res = {"experiment": "gen3c_tiny", "device": str(next(first.state.params.parameters()).device),
               "first_run": {"steps": first.state.step, "s": first_s, "launches": launches_first,
                             "checkpoints": first_checkpoints},
               "resumed_run": {"steps": resumed.state.step, "s": resumed_s,
                               "launches": launches_resumed,
                               "checkpoints": resumed.checkpointer.steps()}}
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as root:
        from gen3c_tpu_torch.pipelines.factory import PRESETS

        tiny = PRESETS["gen3c_tiny"]
        image, depth, w2c, k = _synthetic_clip(tiny.chunk_size + 4, tiny.height, tiny.width, seed=3)
        np.savez(os.path.join(root, "clip.npz"), image=image, depth=depth, w2c=w2c, intrinsics=k)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        clips = train.main(["--data_root", root, "experiment=gen3c_tiny",
                            "dit.attn_temporal_window=1", "trainer.max_iter=2",
                            "trainer.warmup_steps=1", f"trainer.job_dir={root}/job"])
        res["data_root_run"] = {"steps": clips.state.step, "s": time.perf_counter() - t0,
                                "band_window": clips.dit_cfg.attn_temporal_window,
                                "launches": dict(kernels.launch_counts),
                                "device": str(next(clips.state.params.parameters()).device)}
    emit("train_cli", **res)
    per_step = 2 * first.dit_cfg.num_blocks
    if not (first.state.step == 4 and resumed.state.step == 6
            and res["first_run"]["checkpoints"] == [2, 4]
            and res["resumed_run"]["checkpoints"] == [2, 4, 6]
            and launches_first["K4"] == 4 * per_step
            and launches_resumed["K4"] == 2 * per_step  # steps 5 and 6: resumed at 4
            and res["device"].startswith("cuda")):
        raise AssertionError(f"train_cli: {res}")
    run, blocks = res["data_root_run"], clips.dit_cfg.num_blocks
    if not (run["steps"] == 2 and run["device"].startswith("cuda")
            and run["launches"]["K4band"] == 2 * blocks and run["launches"]["K1"] == 0
            and run["launches"]["K5"] > 0):
        raise AssertionError(f"train_cli --data_root: {res}")
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="gen3c_tpu_torch smoke run on one GPU")
    p.add_argument("--cp-rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--cp-port", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--cp-out", type=str, default="", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.cp_rank is not None:  # one rank of the cp phase
        return cp_worker(args.cp_rank, args.cp_port, args.cp_out)
    t_start = time.perf_counter()
    info = phase_device()
    phase_build()
    kern = phase_kernels()
    model, preset, build_s = build_7b()
    main_res = phase_main(model, preset, build_s)
    launches = main_res["launches"]
    dynamic_launches = phase_dynamic(model, preset)["launches"]
    phase_multiview(model, preset)
    main_latent = main_res.pop("samples")
    cp_refs = phase_cp_reference(model, preset, main_latent)
    # the two ranks need the card to themselves: the 7B must be gone, even
    # where a reference cycle still holds it
    del model
    gc.collect()
    torch.cuda.empty_cache()
    cp_runs = phase_cp(main_latent, cp_refs)["runs"]
    fast_launches = phase_fast()["launches"]
    phase_fast_parity()
    phase_chain()
    train_launches = phase_train()["k4_by_forward"]
    lora_launches = phase_lora_band_train()["launches"]
    phase_train_parity()
    phase_band_train_parity()
    phase_train_cli()
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "gen3c_tpu"))
    if foreign:
        raise AssertionError(f"the port imported JAX or the JAX package: {foreign[:8]}")
    k7 = max(kern["K7"], key=lambda r: r["M"] * r["N"] * r["K"])  # fc1
    k7_cases = kern["K7"] + [kern["K7_ragged"]]
    csrc = "gen3c_tpu_torch/kernels/csrc/"

    def row(name, source, replaces, launches, case, **override):
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "entries")
        got = {k: case[k] for k in keys if k in case}
        if source == "attention_wgmma.cu":  # the family's wgmma body, and its entries
            got["body"] = "wgmma"
        return {"name": name, "route": "cuda", "source": csrc + source, "replaces": replaces,
                "launches": launches, **{**got, **override}}

    table = [
        row("K1 self-attention", "attention_wgmma.cu", "gen3c_tpu/models/dit.py:445",
            launches["K1"], kern["K1"]),
        row("K2 cross-attention", "attention_wgmma.cu", "gen3c_tpu/models/dit.py:472",
            launches["K2"], kern["K2"]),
        row("K5 forward-warp splat", "splat.cu", "gen3c_tpu/ops/geometry.py:205",
            launches["K5"], kern["K5"],
            max_abs_err=max([kern["K5"]["max_abs_err"]]
                            + [c["max_abs_err"] for c in kern["K5"]["cases"].values()])),
        row("K3 band self-attention", "attention_wgmma.cu", "gen3c_tpu/models/dit.py:459",
            fast_launches["K3"], kern["K3"]),
        row("K7q per-token int8 quantize (K=4096)", "w8a8.cu", "gen3c_tpu/models/quantize.py:55",
            fast_launches["K7q"], kern["K7q"][0],
            max_abs_err=max(r["max_abs_err"] for r in kern["K7q"]),
            widths=[{k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_share")}
                    for r in kern["K7q"]]),
        row("K7 int8 GEMM + rescale (fc1 shape)", "w8a8.cu", "gen3c_tpu/models/quantize.py:61",
            fast_launches["K7"], k7,
            max_abs_err=max(r["max_abs_err"] for r in k7_cases),
            shapes=[{k: r[k] for k in ("name", "copied", "ms", "library_ms", "bound_ms")}
                    for r in k7_cases]),
        row("K4 self-attention backward", "attention_wgmma.cu", "gen3c_tpu/models/dit.py:464",
            train_launches["K1"], kern["K4_self"]),
        row("K4 cross-attention backward", "attention_wgmma.cu", "gen3c_tpu/models/dit.py:508",
            train_launches["K2"], kern["K4_cross"]),
        row("K4-band band self-attention backward", "attention_wgmma.cu",
            "gen3c_tpu/models/dit.py:464", lora_launches["K4band"], kern["K4band"]),
        row("K3lse band forward with lse", "attention_wgmma.cu", "gen3c_tpu/models/dit.py:459",
            lora_launches["K3lse"], kern["K3lse"]),
        row("K6 ray-triangle depth", "raycast.cu", "gen3c_tpu/ops/raycast.py:97",
            dynamic_launches["K6"], kern["K6"]),
        row(f"P2 K1 tile sweep (best {kern['P2']['best']})", "attention.cu",
            "scripts/sweep_attention.py:32", kern["P2"]["launches"], kern["P2"], body="mma_sync"),
    ] + [row(p1["name"], "mma_probe.cu", "scripts/probe_int8_attention.py:59", p1["launches"], p1)
         for p1 in kern["P1"]]
    # the cp phase's kernels, at its shard shapes (cp = 2), launches of rank 0's runs
    cp_launch = {name: run["rank"][0]["launches"] for name, run in cp_runs.items()}
    k1cp = next(r for r in kern["K1cp"] if r["cp"] == CP_RANKS and r["band"] is None)
    ring = next(r for r in kern["K1ring"] if r["cp"] == CP_RANKS and r["band"] is None)
    table += [
        row("K1cp Ulysses self-attention (cp=2 heads)", "attention_wgmma.cu",
            "gen3c_tpu/models/dit.py:653", cp_launch["ulysses"]["K1cp"], k1cp),
        row("K1ag all-gather self-attention (cp=2)", "attention_wgmma.cu",
            "gen3c_tpu/models/dit.py:766", cp_launch["allgather"]["K1ag"], kern["K1ag"]),
        row("K1ring ring-attention step (cp=2)", "attention_wgmma.cu",
            "gen3c_tpu/models/dit.py:529", cp_launch["ring"]["K1ring"], ring,
            ms=ring["fold_ms"], plain_ms=ring["plain_fold_ms"], **ring["fold_bound"]),
        row("K1merge ring-attention merge (cp=2)", "attention_merge.cu",
            "gen3c_tpu/models/dit.py:614", cp_launch["ring"]["K1merge"], ring,
            ms=ring["merge_ms"], plain_ms=ring["plain_merge_ms"], library_ms=None,
            **ring["merge_bound"]),
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    incomplete = [(r["name"], k) for r in table for k in keys if k not in r]
    if incomplete:
        raise AssertionError(f"kernel table rows without a key: {incomplete}")
    idle = [r["name"] for r in table if r["launches"] == 0]
    if idle:
        raise AssertionError(f"kernels that their path never launched: {idle}")
    print(json.dumps({"kernels": table}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
