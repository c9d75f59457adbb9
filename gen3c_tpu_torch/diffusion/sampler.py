"""EDM-Euler video sampling with conditioned-region replacement and CFG.

Port of gen3c_tpu/diffusion/sampler.py ``generate_samples`` (:148-777) as
plain Python control flow: each step re-noises the condition region, runs
the DiT (one batched [cond | uncond] forward of size 2B, or a
condition-only forward of size B outside the guidance interval), combines
with CFG (optionally rescaled), replaces the condition region in the
output and takes an Euler step. Step caching reuses the last raw network
output on skipped steps: on a fixed interval after a 2-step warmup and
before a 2-step tail, or adaptively when the latent's accumulated relative
drift crosses a threshold.

Under context parallelism (``cp``: the tensors are this rank's latent-T
shard) the per-sample statistics are summed over the axis: CFG rescale's
stds and the adaptive cache's drift, so that every rank takes the same
refresh decision. Under CFG parallelism (``cfg``, 2 ranks) rank 0 runs the
conditioned forward and rank 1 the unconditioned one, and one all-reduce
combines them (gen3c_tpu's ``cfg_axis``).

The dpm2m and res2ab solvers replace the Euler step with a multistep one
at the same network cost, and span caching (``net_fn_skip``) runs only the
blocks outside a cached span on the skipped steps. Not ported: the JAX
package's host-loop and streaming variants.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from gen3c_tpu_torch.diffusion.scheduler import EDMEulerSchedule
from gen3c_tpu_torch.diffusion.solvers import dpm2m_x0_step, res_x0_rk2_step
from gen3c_tpu_torch.parallel import collectives
from gen3c_tpu_torch.parallel.mesh import Axis

CACHE_WARMUP = 2  # first steps that always run the network
CACHE_TAIL = 2  # last steps that always run the network


def arch_invariant_randn(shape, seed: Optional[int] = None) -> np.ndarray:
    """Architecture-invariant normal noise: numpy RandomState, so the port
    and the JAX package draw the same numbers."""
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def guidance_interval_steps(schedule: EDMEulerSchedule, num_steps: int,
                            guidance_interval: Sequence[float]) -> Tuple[int, int]:
    """(i0, i1): CFG runs on steps i0 <= i < i1, the steps whose sigma lies
    in [lo, hi] (arXiv:2404.07724); the others run condition-only. The
    sigmas decrease, so the range is contiguous (sampler.py:40-68)."""
    lo, hi = float(guidance_interval[0]), float(guidance_interval[1])
    if not 0.0 <= lo <= hi:
        raise ValueError(f"guidance_interval must satisfy 0 <= lo <= hi, got ({lo}, {hi})")
    sig = np.asarray(schedule.sigmas(num_steps), np.float64)[:num_steps]
    idx = np.nonzero((sig >= lo) & (sig <= hi))[0]
    if idx.size == 0:
        return 0, 0
    return int(idx[0]), int(idx[-1]) + 1


def per_sample_std(x: torch.Tensor, shard: Optional[Axis] = None) -> torch.Tensor:
    """The population std over all non-batch dims, keepdim; over the whole
    tensor when it is sharded on ``shard`` (summed moments, as
    sampler.py:71-86 computes it)."""
    dims = tuple(range(1, x.ndim))
    if shard is None:
        return x.std(dim=dims, keepdim=True, correction=0)
    n = x[0].numel() * shard.size
    s1 = collectives.all_reduce(x.sum(dim=dims, keepdim=True), shard)
    s2 = collectives.all_reduce((x * x).sum(dim=dims, keepdim=True), shard)
    mean = s1 / n
    return (s2 / n - mean * mean).clamp_min(0.0).sqrt()


def _rescale(out: torch.Tensor, std_c: torch.Tensor, std_o: torch.Tensor,
             cfg_rescale: float) -> torch.Tensor:
    rescaled = out * (std_c / std_o.clamp_min(1e-6))
    return cfg_rescale * rescaled + (1.0 - cfg_rescale) * out


def apply_cfg(out_cond: torch.Tensor, out_uncond: torch.Tensor, guidance: float,
              cfg_rescale: float = 0.0, shard: Optional[Axis] = None) -> torch.Tensor:
    """cond + g * (cond - uncond); with cfg_rescale = phi > 0 the result is
    blended with its copy rescaled to the cond branch's per-sample
    (population) std (arXiv:2305.08891, sampler.py:89-115), taken over the
    whole latent when it is sharded on ``shard``."""
    out = out_cond + guidance * (out_cond - out_uncond)
    if cfg_rescale <= 0:
        return out
    return _rescale(out, per_sample_std(out_cond, shard), per_sample_std(out, shard), cfg_rescale)


MULTISTEP_SOLVERS = ("dpm2m", "res2ab")


@torch.no_grad()
def generate_samples(
    net_fn: Callable[..., torch.Tensor],
    init_noise: torch.Tensor,  # (B, C, T, H, W) ~ N(0, 1)
    augment_noise: torch.Tensor,  # (B, C, T, H, W), fixed across steps
    crossattn_cond: torch.Tensor,  # (B, M, 1024)
    crossattn_uncond: torch.Tensor,
    gt_latent: torch.Tensor,  # (B, C, T, H, W)
    condition_video_indicator: torch.Tensor,  # (1, 1, T, 1, 1)
    condition_video_input_mask: Optional[torch.Tensor] = None,  # (B, 1, T, H, W)
    pose_latent_cond: Optional[torch.Tensor] = None,  # (B, P, T, H, W)
    pose_latent_uncond: Optional[torch.Tensor] = None,
    num_steps: int = 35,
    guidance: float = 1.0,
    condition_augment_sigma: float = 0.001,
    schedule: EDMEulerSchedule = EDMEulerSchedule(),
    net_in_dtype: torch.dtype = torch.float32,
    step_cache_interval: int = 1,
    step_cache_threshold: float = 0.0,
    guidance_interval: Optional[Sequence[float]] = None,
    cfg_rescale: float = 0.0,
    on_step: Optional[Callable[[int, bool, bool], None]] = None,
    cp: Optional[Axis] = None,
    cfg: Optional[Axis] = None,
    solver: str = "euler",
    net_fn_skip: Optional[Callable[..., torch.Tensor]] = None,
) -> torch.Tensor:
    """Run the denoising loop; returns the final latent (B, C, T, H, W), fp32.

    net_fn(x_in, t_in, crossattn) -> raw DiT output for a batch whose
    channels carry [x, input mask, pose latent] (each of the last two only
    when given: text2world has neither): 2B for a CFG step, B for a
    condition-only one. on_step(i, cfg, refreshed) is called after each
    step (timing hooks): whether step i ran CFG and whether it ran the whole
    network (False: it reused the cache, or ran the span-skipping net).

    step_cache_interval > 1: the network runs on steps i < 2, i >= n - 2,
    (i - 2) % interval == 0 and on re-entry into the guidance interval;
    step_cache_threshold > 0 instead runs it when the accumulated relative
    L1 drift of the scaled latent exceeds the threshold (interval ignored;
    not composable with a guidance interval that excludes steps).

    solver: "euler", or a multistep rule at the same network cost, "dpm2m"
    (DPM-Solver++(2M)) or "res2ab" (exponential-integrator AB2): each step
    turns the replaced output into an x0 prediction and, for 0 < i and a
    next sigma above 0, extrapolates from it and the previous step's
    (``solvers``); otherwise it takes the Euler step (sampler.py:533-598).
    Not composable with any step caching.

    net_fn_skip: Delta-DiT span caching (arXiv:2406.01125,
    sampler.py:615-675). net_fn then returns (out, span_delta), and on the
    steps the fixed interval skips net_fn_skip(x_in, t_in, crossattn,
    span_delta) runs the blocks outside the span with the cached delta in
    its place. Needs step_cache_interval >= 2, CFG on every step, no
    threshold and no cfg axis.

    cp: the context-parallel axis the tensors are sharded on (latent T),
    for CFG rescale's stds and the adaptive drift. cfg: a 2-rank CFG axis
    (sampler.py:368-531): a CFG step runs net_fn once at batch B, the
    conditioned half on rank 0 and the unconditioned on rank 1, and
    all_reduce of (1 + g) * cond and -g * uncond combines them; the cache
    then holds that combined output, and the multistep solvers read it. It
    composes with the guidance interval (condition-only steps run
    replicated) and the fixed-interval cache, not with adaptive or span
    caching.
    """
    sigmas = [float(s) for s in schedule.sigmas(num_steps)]
    c_noises = [float(t) for t in schedule.timesteps(num_steps)]
    B = init_noise.shape[0]
    dev = init_noise.device
    xt = init_noise.float() * schedule.init_noise_sigma
    aug = condition_augment_sigma
    gt = gt_latent.float()
    indicator_base = condition_video_indicator.float()
    augment_latent = (gt + augment_noise.float() * aug) * schedule.c_in(aug)
    crossattn_both = torch.cat([crossattn_cond, crossattn_uncond], dim=0)
    extra_cond, extra_uncond = [], []
    if condition_video_input_mask is not None:
        mask = condition_video_input_mask.to(net_in_dtype)
        extra_cond.append(mask)
        extra_uncond.append(mask)
    if pose_latent_cond is not None:
        extra_cond.append(pose_latent_cond.to(net_in_dtype))
        extra_uncond.append(pose_latent_uncond.to(net_in_dtype))
    span = net_fn_skip is not None

    gi = None
    if guidance_interval is not None:
        gi = guidance_interval_steps(schedule, num_steps, guidance_interval)
        if gi == (0, num_steps):
            gi = None  # every step in the interval: the plain CFG loop
        elif step_cache_threshold > 0 or span:
            raise ValueError("guidance_interval composes with the plain and fixed-"
                             "interval-cached loops only (not adaptive/span caching)")
    adaptive = step_cache_threshold > 0
    caching = adaptive or step_cache_interval > 1
    if cfg is not None and (adaptive or span):
        raise ValueError("cfg_axis (CFG parallelism) composes with the plain and fixed-interval-"
                         "cached loops only (not adaptive/span caching)")
    multistep = None
    if solver != "euler":
        if solver not in MULTISTEP_SOLVERS:
            raise ValueError(f"unknown solver {solver!r}; expected euler/dpm2m/res2ab")
        if caching or span:
            raise ValueError("multistep solvers are not supported with step caching")
        multistep = res_x0_rk2_step if solver == "res2ab" else dpm2m_x0_step
    if span:
        if step_cache_interval <= 1:
            raise ValueError(
                f"net_fn_skip requires step_cache_interval >= 2 (interval {step_cache_interval} "
                "would silently enable caching on a caller that asked for the uncached loop)")
        if adaptive:
            raise ValueError("step_cache_threshold is not supported with net_fn_skip (span "
                             "caching refreshes on a fixed interval); use one or the other")

    def cfg_parallel_output(x_cond, x_uncond, t_in):
        """This rank's half of the CFG pair, combined by one all-reduce
        (sampler.py:380-402); with cfg_rescale the cond branch's std comes
        from rank 0 through a second, scalar-sized one."""
        is_c = cfg.rank == 0
        raw = net_fn(x_cond if is_c else x_uncond, t_in,
                     crossattn_cond if is_c else crossattn_uncond).float()
        out = collectives.all_reduce(raw * ((1.0 + guidance) if is_c else -guidance), cfg)
        if cfg_rescale <= 0:
            return out
        std_r = per_sample_std(raw, cp)
        std_c = collectives.all_reduce(std_r if is_c else torch.zeros_like(std_r), cfg)
        return _rescale(out, std_c, per_sample_std(out, cp), cfg_rescale)

    # the last raw [cond | uncond] network output (condition-only steps
    # refresh or read its cond half only); under cfg the combined B-sized
    # one; span caching carries the span's delta instead
    cached = None
    if caching and not span:
        cached = torch.zeros(((B if cfg is not None else 2 * B),) + tuple(gt.shape[1:]),
                             dtype=torch.float32, device=dev)
    delta = None
    prev = torch.zeros_like(xt)
    prev_x0 = xt  # the multistep solvers' previous x0 (unread on step 0)
    drift_acc = 0.0

    for i in range(num_steps):
        sigma = sigmas[i]
        use_cfg = gi is None or gi[0] <= i < gi[1]
        indicator = torch.zeros_like(indicator_base) if aug >= sigma else indicator_base
        c_in = schedule.c_in(sigma)
        new_xt = indicator * (augment_latent / c_in) + (1 - indicator) * xt
        edge = i < CACHE_WARMUP or i >= num_steps - CACHE_TAIL
        if adaptive:
            cur = new_xt * c_in
            num, den = (cur - prev).abs().mean(), prev.abs().mean()
            if cp is not None:  # every rank must take the same branch
                num, den = (collectives.all_reduce(t, cp, "mean") for t in (num, den))
            rel = (num / (den + 1e-8)).item()
            drift = drift_acc + rel
            refresh = edge or drift > step_cache_threshold
            drift_acc = 0.0 if refresh else drift
            prev = cur
        elif caching:
            refresh = (edge or (i - CACHE_WARMUP) % step_cache_interval == 0
                       # re-entry into the CFG range: the cache's uncond half
                       # is stale (condition-only steps never refresh it)
                       or (use_cfg and gi is not None and i == gi[0]))
        else:
            refresh = True

        if refresh or span:
            x_scaled = (new_xt * c_in).to(net_in_dtype)
            x_cond = torch.cat([x_scaled] + extra_cond, dim=1)
        if span:
            x_in = torch.cat([x_cond, torch.cat([x_scaled] + extra_uncond, dim=1)])
            t_in = torch.full((2 * B,), c_noises[i], dtype=torch.float32, device=dev)
            if refresh:
                net_out, delta = net_fn(x_in, t_in, crossattn_both)
            else:
                net_out = net_fn_skip(x_in, t_in, crossattn_both, delta)
            net_out = net_out.float()
        elif refresh:
            if cfg is not None and use_cfg:
                # the cache holds the combined B-sized output
                t_in = torch.full((B,), c_noises[i], dtype=torch.float32, device=dev)
                net_out = cfg_parallel_output(
                    x_cond, torch.cat([x_scaled] + extra_uncond, dim=1), t_in)
                cached = net_out
            elif use_cfg:
                x_in = torch.cat([x_cond, torch.cat([x_scaled] + extra_uncond, dim=1)])
                t_in = torch.full((2 * B,), c_noises[i], dtype=torch.float32, device=dev)
                net_out = net_fn(x_in, t_in, crossattn_both).float()
                if caching:
                    cached = net_out
            else:
                t_in = torch.full((B,), c_noises[i], dtype=torch.float32, device=dev)
                net_out = net_fn(x_cond, t_in, crossattn_cond).float()
                if caching:
                    cached = torch.cat([net_out, cached[B:]], dim=0)  # cached[B:] empty under cfg
        else:
            net_out = cached if use_cfg else cached[:B]
        if use_cfg and cfg is None:
            net_output = apply_cfg(net_out[:B], net_out[B:], guidance, cfg_rescale, cp)
        else:  # condition-only, or already combined over the cfg axis
            net_output = net_out
        latent_unscaled = schedule.reverse_precondition_output(gt, new_xt, sigma)
        new_output = indicator * latent_unscaled + (1 - indicator) * net_output
        sigma_next = sigmas[i + 1]
        if multistep is None:
            xt = schedule.step(new_output, new_xt, sigma, sigma_next)
        else:
            x0 = schedule.precondition_outputs(new_xt, new_output, sigma)
            if i > 0 and sigma_next > 0:
                xt = multistep(new_xt, sigma_next, sigma, x0, sigmas[max(i - 1, 0)], prev_x0)
            else:
                xt = schedule.step(new_output, new_xt, sigma, sigma_next)
            prev_x0 = x0
        if on_step is not None:
            on_step(i, use_cfg, refresh)
    return xt
