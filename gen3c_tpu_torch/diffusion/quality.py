"""The approximation knobs' error curve at toy scale (port of gen3c_tpu/diffusion/quality.py).

Each opt-in approximation trades output fidelity for speed: temporal-band
attention (``attn_temporal_window``), step caching on a fixed interval or
adaptively, limited-interval guidance, W8A8, and the composition that
``--perf_preset fast`` ships (W8A8 + band 2 + cache 2 + guidance q0.5). The
curve is each one's error against the exact loop: the relative L2 and the
PSNR of the final latent, from full denoise trajectories of the tiny fp32
DiT with the same weights and noise. Random weights give the ordering of
the knobs (wider band, denser refresh: smaller error), not the size of a
real checkpoint's errors.

``approximation_quality_curve`` draws the tiny DiT from the port's seeded
init (the zero-initialized AdaLN output layers and final linear drawn at
0.02, so that every knob matters) and runs on ``device``, the card by
default; ``quality_curve`` computes the rows over a given net, so that the
same weights can go through both packages.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from gen3c_tpu_torch.diffusion.sampler import generate_samples
from gen3c_tpu_torch.diffusion.scheduler import EDMEulerSchedule
from gen3c_tpu_torch.models.dit import DiTConfig, GeneralDIT
from gen3c_tpu_torch.models.quantize import quantize_dit_


def tiny_cfg(attn_temporal_window: Optional[int] = None) -> DiTConfig:
    """The toy DiT of the curve: 2 blocks x 96 channels, fp32."""
    return DiTConfig(max_img_h=16, max_img_w=16, max_frames=16, in_channels=16 + 64 + 1,
                     out_channels=16, model_channels=96, num_blocks=2, num_heads=4,
                     crossattn_emb_channels=32, adaln_lora_dim=8, rope_t_extrapolation_ratio=2.0,
                     attn_temporal_window=attn_temporal_window, dtype=torch.float32)


def init_quality_net(seed: int = 0, device="cuda") -> GeneralDIT:
    """The toy DiT from the port's init (``seed``), its all-zero weights
    then drawn from N(0, 0.02^2) (``seed + 1``), moved to ``device``. The
    draws are the CPU generator's, so every device gets the same weights."""
    net = GeneralDIT(tiny_cfg())
    net.init_random(torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in net.parameters():
            if not p.any():
                p.normal_(0.0, 0.02, generator=gen)
    return net.to(torch.device(device)).eval()


def quality_inputs(seed: int = 0, lat_t: int = 16, lat_hw: int = 16,
                   crossattn_channels: int = 32, device="cuda") -> dict:
    """The sampler's inputs, drawn from numpy's RandomState(seed) in the JAX
    package's order and dtypes: one condition frame, 64 pose channels,
    8 text tokens, guidance 1.5."""
    rng = np.random.RandomState(seed)
    B, C, T, H, W = 1, 16, lat_t, lat_hw, lat_hw
    indicator = np.zeros((1, 1, T, 1, 1), np.float32)
    indicator[:, :, :1] = 1.0
    arrays = dict(
        init_noise=rng.randn(B, C, T, H, W).astype(np.float32),
        augment_noise=rng.randn(B, C, T, H, W).astype(np.float32),
        crossattn_cond=rng.randn(B, 8, crossattn_channels).astype(np.float32),
        crossattn_uncond=np.zeros((B, 8, crossattn_channels), np.float32),
        gt_latent=rng.randn(B, C, T, H, W).astype(np.float32) * 0.5,
        condition_video_indicator=indicator,
        condition_video_input_mask=np.broadcast_to(indicator, (B, 1, T, H, W)).astype(np.float32),
        pose_latent_cond=rng.randn(B, 64, T, H, W).astype(np.float32) * 0.3,
        pose_latent_uncond=np.zeros((B, 64, T, H, W), np.float32),
    )
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}


def _metrics(exact: np.ndarray, approx: np.ndarray) -> Dict[str, float]:
    err = approx - exact
    rel_l2 = float(np.linalg.norm(err) / np.linalg.norm(exact))
    peak = float(np.abs(exact).max())
    rmse = float(np.sqrt(np.mean(err ** 2)))
    psnr = float(20 * np.log10(peak / rmse)) if rmse > 0 else float("inf")
    return {"rel_l2": round(rel_l2, 5), "psnr_db": round(psnr, 2)}


def _with_cfg(net: GeneralDIT, **changes) -> GeneralDIT:
    """The same parameters under another config (a shallow copy)."""
    other = copy.copy(net)
    other.cfg = dataclasses.replace(net.cfg, **changes)
    return other


def _sample(net: GeneralDIT, inputs: dict, num_steps: int, **options) -> np.ndarray:
    out = generate_samples(lambda x, t, ctx: net(x, t, ctx, fps=24.0), **inputs,
                           num_steps=num_steps, guidance=1.5, **options)
    return out.float().cpu().numpy()


def quality_curve(
    net: GeneralDIT,
    inputs: dict,
    num_steps: int = 35,
    windows: Sequence[int] = (4, 2, 1),
    intervals: Sequence[int] = (2, 3),
    thresholds: Sequence[float] = (0.1,),
    guidance_quantiles: Sequence[float] = (0.75, 0.5),
) -> Dict[str, Dict[str, float]]:
    """The curve's rows over ``net`` (an fp32 GeneralDIT without a band)
    and the sampler ``inputs``: band_w{w}, cache_i{n},
    cache_adaptive_t{t}, guidance_q{q} (CFG on the first round(q *
    num_steps) steps, the highest sigmas), w8a8 (every large or small
    linear W8A8) and fast_preset, each {"rel_l2", "psnr_db"} against the
    exact loop."""
    exact = _sample(net, inputs, num_steps)
    curve: Dict[str, Dict[str, float]] = {}
    for w in windows:
        curve[f"band_w{w}"] = _metrics(
            exact, _sample(_with_cfg(net, attn_temporal_window=w), inputs, num_steps))
    for interval in intervals:
        curve[f"cache_i{interval}"] = _metrics(
            exact, _sample(net, inputs, num_steps, step_cache_interval=interval))
    for thr in thresholds:
        curve[f"cache_adaptive_t{thr}"] = _metrics(
            exact, _sample(net, inputs, num_steps, step_cache_threshold=thr))
    sig = np.asarray(EDMEulerSchedule().sigmas(num_steps))[:num_steps]

    def gi(q: float):
        n_active = max(1, int(round(q * num_steps)))
        return (float(sig[n_active - 1]), float(sig[0]) + 1.0)

    for q in guidance_quantiles:
        curve[f"guidance_q{q}"] = _metrics(
            exact, _sample(net, inputs, num_steps, guidance_interval=gi(q)))
    qnet = quantize_dit_(copy.deepcopy(net), act_quant=True, min_size=0)
    curve["w8a8"] = _metrics(exact, _sample(qnet, inputs, num_steps))
    curve["fast_preset"] = _metrics(exact, _sample(
        _with_cfg(qnet, attn_temporal_window=2), inputs, num_steps, step_cache_interval=2,
        guidance_interval=gi(0.5)))
    return curve


@torch.no_grad()
def approximation_quality_curve(
    num_steps: int = 35,
    windows: Sequence[int] = (4, 2, 1),
    intervals: Sequence[int] = (2, 3),
    thresholds: Sequence[float] = (0.1,),
    guidance_quantiles: Sequence[float] = (0.75, 0.5),
    seed: int = 0,
    lat_t: int = 16,
    lat_hw: int = 16,
    device="cuda",
) -> Dict[str, Dict[str, float]]:
    """Error-vs-exact of each approximation knob at toy scale on
    ``device``: ``quality_curve`` over ``init_quality_net(seed)`` and
    ``quality_inputs(seed, lat_t, lat_hw)``."""
    net = init_quality_net(seed, device)
    inputs = quality_inputs(seed, lat_t, lat_hw, net.cfg.crossattn_emb_channels, device)
    return quality_curve(net, inputs, num_steps, windows, intervals, thresholds,
                         guidance_quantiles)
