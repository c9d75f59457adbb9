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
             with K1 at a full window; K7q/K7 (W8A8) exact codes, int32
             accumulators and outputs, TOPS, and cuBLAS bf16 at the shape
  4 main     GEN3C-7B at full width (28 blocks x 4096, 32 x 128 heads,
             bf16, random weights from seed 0) generating one 121-frame
             704x1280 chunk through run_chunked_generation with 2 Euler
             steps and batched CFG; seconds per phase, peak memory, and
             the launches of each kernel in that run
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
Then the kernel table as one JSON line, the nvidia-smi line, and as the
last line {"ok": true, "device": {...}}. Any failure raises: the script
exits non-zero and prints no last line. There is no CPU fallback.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import shutil
import subprocess
import sys
import time

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


def emit(phase: str, **numbers) -> None:
    print(json.dumps({"phase": phase, **numbers}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 3, warmup: int = 1) -> float:
    """Median milliseconds of fn() on the current stream (CUDA events)."""
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
    return float(np.median(times))


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
    emit("build", seconds=round(info["seconds"], 3), cached=info["cached"], library=info["path"])


def _attention_case(name, shape_q, shape_kv, dtype, tol, gen, time_it=True):
    from gen3c_tpu_torch import kernels

    q = torch.randn(shape_q, generator=gen, device="cuda").to(dtype)
    k = torch.randn(shape_kv, generator=gen, device="cuda").to(dtype)
    v = torch.randn(shape_kv, generator=gen, device="cuda").to(dtype)
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
                   plain_tflops=flop / plain_ms / 1e9)
    emit("kernel", **res)
    if not res["finite"] or res["max_abs_err"] > tol["max"] or res["mean_abs_err"] > tol["mean"]:
        raise AssertionError(f"{name}: kernel disagrees with its plain version: {res}")
    return res


def _splat_case(gen) -> dict:
    """Two 704x1280 buffers warped into a shifted camera."""
    from gen3c_tpu_torch import kernels
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
    tdepth = proj[..., 2][:, None].contiguous()
    flow, frame = flow.contiguous(), frame.contiguous()

    out, m = kernels.splat(frame, mask, tdepth, flow, None, True)
    ref, m_ref = kernels.splat_reference(frame, mask, tdepth, flow, None, True)
    torch.cuda.synchronize()
    both = (m > 0) & (m_ref > 0)
    err = ((out - ref).abs() * both).max().item()
    agree = (m == m_ref).float().mean().item()
    res = {"name": "K5 splat", "shape": [b, c, h, w], "max_abs_err": err, "mask_agree": agree,
           "known_fraction": m.mean().item()}
    res["ms"] = cuda_ms(lambda: kernels.splat(frame, mask, tdepth, flow, None, True), reps=5)
    res["plain_ms"] = cuda_ms(lambda: kernels.splat_reference(frame, mask, tdepth, flow, None, True),
                              reps=3)
    emit("kernel", **res)
    if err > SPLAT_TOL or agree < SPLAT_MASK_AGREE:
        raise AssertionError(f"K5: kernel disagrees with its plain version: {res}")
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
    res.update(tflops=flop / res["ms"] / 1e9, plain_tflops=flop / res["plain_ms"] / 1e9)
    emit("kernel", **res)
    if (not res["finite"] or res["max_abs_err"] > ATTN_TOL["max"]
            or res["mean_abs_err"] > ATTN_TOL["mean"] or not res["full_window_equals_k1"]):
        raise AssertionError(f"K3: kernel disagrees with its plain version or K1: {res}")
    if res["visited_tiles"] != B * H * tiles * tiles * pairs // LATENT_T_7B ** 2:
        raise AssertionError(f"K3 did not skip the masked tiles: {res}")
    return res


def _quant_case(gen) -> dict:
    """K7q on the 7B q/k/v input shape (tokens of the 2B CFG batch x 4096)."""
    from gen3c_tpu_torch import kernels

    x = torch.randn((2 * 56320, 4096), generator=gen, device="cuda").to(torch.bfloat16)
    x[0] = 0  # a zero token
    codes, scale = kernels.quantize_rows(x)
    want_codes, want_scale = kernels.quantize_rows_reference(x)
    torch.cuda.synchronize()
    res = {"name": "K7q per-token int8 quantize", "shape": list(x.shape),
           "codes_equal": bool(torch.equal(codes, want_codes)),
           "scales_equal": bool(torch.equal(scale, want_scale)),
           "max_abs_err": (scale - want_scale).abs().max().item()}
    res["ms"] = cuda_ms(lambda: kernels.quantize_rows(x), reps=5)
    res["plain_ms"] = cuda_ms(lambda: kernels.quantize_rows_reference(x), reps=3)
    res["gb_per_s"] = x.numel() * 3 / res["ms"] / 1e6  # bf16 read, int8 write
    emit("kernel", **res)
    if not (res["codes_equal"] and res["scales_equal"]):
        raise AssertionError(f"K7q: kernel disagrees with its plain version: {res}")
    return res


def _gemm_case(gen, name: str, M: int, K: int, N: int) -> dict:
    """K7 at one 7B linear shape: exact int32 accumulators and bf16
    outputs against the plain version, then times."""
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
           "acc_equal": bool(torch.equal(acc, acc_ref))}
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
    emit("kernel", **res)
    if not (res["acc_equal"] and res["linear_equal"]) or res["max_abs_err"] != 0.0:
        raise AssertionError(f"K7: kernel disagrees with its plain version: {res}")
    return res


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
    results["K5"] = _splat_case(gen)
    torch.cuda.empty_cache()
    results["K3"] = _band_case(gen)
    torch.cuda.empty_cache()
    results["K7q"] = _quant_case(gen)
    tokens = 2 * 56320  # the CFG batch of one 121-frame chunk
    results["K7"] = [_gemm_case(gen, name, M, K, N) for name, M, K, N in [
        ("q/k/v/out", tokens, 4096, 4096), ("fc1", tokens, 4096, 16384),
        ("fc2", tokens, 16384, 4096), ("cross k/v", 2 * 512, 1024, 4096)]]
    torch.cuda.empty_cache()
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


def phase_main() -> dict:
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.pipelines.factory import build_gen3c_model

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, preset = build_gen3c_model("gen3c_7b", device="cuda", seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg = preset.dit
    n_params = sum(p.numel() for p in model.net.parameters())

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    video, pipeline, timings = _run_chain(model, preset, "cuda", num_frames=121, num_steps=2,
                                          seed=0)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
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
        "latents_finite": bool(torch.isfinite(samples).all().item()),
        "latent_std": samples.float().std().item(),
    }
    emit("main_path", **res)
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
    del model, pipeline, samples
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


def main() -> int:
    t_start = time.perf_counter()
    info = phase_device()
    phase_build()
    kern = phase_kernels()
    launches = phase_main()["launches"]
    fast_launches = phase_fast()["launches"]
    phase_fast_parity()
    phase_chain()
    k7 = max(kern["K7"], key=lambda r: r["M"] * r["N"] * r["K"])  # fc1
    table = [
        {"name": "K1 self-attention", "route": "cuda",
         "source": "gen3c_tpu_torch/kernels/csrc/attention.cu",
         "replaces": "gen3c_tpu/models/dit.py:445", "launches": launches["K1"],
         "max_abs_err": kern["K1"]["max_abs_err"], "ms": kern["K1"]["ms"],
         "plain_ms": kern["K1"]["plain_ms"]},
        {"name": "K2 cross-attention", "route": "cuda",
         "source": "gen3c_tpu_torch/kernels/csrc/attention.cu",
         "replaces": "gen3c_tpu/models/dit.py:472", "launches": launches["K2"],
         "max_abs_err": kern["K2"]["max_abs_err"], "ms": kern["K2"]["ms"],
         "plain_ms": kern["K2"]["plain_ms"]},
        {"name": "K5 forward-warp splat", "route": "cuda",
         "source": "gen3c_tpu_torch/kernels/csrc/splat.cu",
         "replaces": "gen3c_tpu/ops/geometry.py:205", "launches": launches["K5"],
         "max_abs_err": kern["K5"]["max_abs_err"], "ms": kern["K5"]["ms"],
         "plain_ms": kern["K5"]["plain_ms"]},
        {"name": "K3 band self-attention", "route": "cuda",
         "source": "gen3c_tpu_torch/kernels/csrc/attention.cu",
         "replaces": "gen3c_tpu/models/dit.py:459", "launches": fast_launches["K3"],
         "max_abs_err": kern["K3"]["max_abs_err"], "ms": kern["K3"]["ms"],
         "plain_ms": kern["K3"]["plain_ms"]},
        {"name": "K7q per-token int8 quantize", "route": "cuda",
         "source": "gen3c_tpu_torch/kernels/csrc/w8a8.cu",
         "replaces": "gen3c_tpu/models/quantize.py:55", "launches": fast_launches["K7q"],
         "max_abs_err": kern["K7q"]["max_abs_err"], "ms": kern["K7q"]["ms"],
         "plain_ms": kern["K7q"]["plain_ms"]},
        {"name": "K7 int8 GEMM + rescale (fc1 shape)", "route": "cuda",
         "source": "gen3c_tpu_torch/kernels/csrc/w8a8.cu",
         "replaces": "gen3c_tpu/models/quantize.py:61", "launches": fast_launches["K7"],
         "max_abs_err": max(r["max_abs_err"] for r in kern["K7"]), "ms": k7["ms"],
         "plain_ms": k7["plain_ms"]},
    ]
    print(json.dumps({"kernels": table}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
