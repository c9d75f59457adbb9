#!/usr/bin/env python3
"""Smoke run of gen3c_tpu_torch on one NVIDIA GPU (H100 class).

    python3 chip_smoke.py            # every phase, one card

Phases, each printing one JSON line of its own numbers:
  1 device   the card's name and power limit (nvidia-smi), torch/CUDA versions
  2 build    compile the CUDA kernels from gen3c_tpu_torch/kernels/csrc
  3 kernels  each kernel against its plain PyTorch version at the main
             path's shapes: max/mean abs error, kernel and reference ms
             (CUDA events, median after a warm-up), attention TF/s
  4 main     GEN3C-7B at full width (28 blocks x 4096, 32 x 128 heads,
             bf16, random weights from seed 0) generating one 121-frame
             704x1280 chunk through run_chunked_generation with 2 Euler
             steps and batched CFG; seconds per phase, peak memory, and
             the launches of each kernel in that run
  5 chain    the tiny preset chaining two chunks (17 frames) on the card:
             update_cache (non-rigid Adam fit), re-render and the kernels
             between chunks; the first chunk is compared with the same
             model run on the CPU through the plain versions
Then the kernel table as one JSON line, the nvidia-smi line, and as the
last line {"ok": true, "device": {...}}. Any failure raises: the script
exits non-zero and prints no last line. There is no CPU fallback.
"""

from __future__ import annotations

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
    return results


def _seed_image(h: int, w: int, seed: int) -> np.ndarray:
    """A numpy-seeded smooth image, (1, 3, 1, h, w) in [-1, 1]."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(-1, 1, (3, h // 32 + 1, w // 32 + 1)).astype(np.float32)
    img = np.repeat(np.repeat(coarse, 32, axis=1), 32, axis=2)[:, :h, :w]
    img = img + 0.1 * rng.standard_normal((3, h, w)).astype(np.float32)
    return np.clip(img, -1, 1)[None, :, None]


def _run_chain(model, preset, device, num_frames, num_steps, seed):
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
    pipeline = Gen3cPipeline(model=model, num_steps=num_steps, guidance=1.0)
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
        "denoise_step_s": pipeline.last_timings["denoise_steps"],
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
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"main path did not launch kernels {missing}: {launches}")
    del model, pipeline, samples
    torch.cuda.empty_cache()
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
    if len(timings["update"]) != 1 or any(n == 0 for n in launches.values()):
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
    phase_chain()
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
    ]
    print(json.dumps({"kernels": table}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
