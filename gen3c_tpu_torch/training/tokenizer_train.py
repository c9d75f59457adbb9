"""Tokenizer (causal video VAE) training: the losses, the step and its CLI.

Port of gen3c_tpu/training/tokenizer_train.py (the reference:
cosmos_predict1/tokenizer/training/): reconstruction L1 + MSE, the
gradient (edge) term, the temporal-difference term, a small L2 on the
latent, and on request the reference's perceptual term (LPIPS VGG16 with
the gram term, ``training/lpips.py``), its FlowLoss (``training/flow.py``,
RAFT-Large or Lucas-Kanade) and the overlapped-window consistency loss, each
with an optional iteration schedule (WeightScheduler).

The parameters are the flat, reference-named tensors of a ``CausalVAE``
(``vae.params()``) with ``requires_grad`` on; ``vae_encode`` /
``vae_decode`` run under autograd as written (the spatial attention's
frame chunks are concatenated with ``torch.cat``, which autograd follows).
The CLI's optimizer is ``train_step.AdamW``, optax.adamw's counterpart
(constant lr, weight decay 1e-4, no clipping), as gen3c_tpu's CLI uses it.

    python -m gen3c_tpu_torch.training.tokenizer_train --synthetic \\
        --max_iter 100 [--data_root clips/] [--save path.npz] [--device cpu]
"""

from __future__ import annotations

import argparse
import bisect
import os
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from gen3c_tpu_torch.models.vae import CausalVAE, VAEConfig, vae_decode, vae_encode
from gen3c_tpu_torch.training.train_step import AdamW, OptState, Optimizer, trainable_params
from gen3c_tpu_torch.utils import log

Params = Dict[str, torch.Tensor]


def _gradients(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return x[..., 1:, :] - x[..., :-1, :], x[..., :, 1:] - x[..., :, :-1]


def piecewise_weight(iteration: int, boundaries: Sequence[int],
                     values: Sequence[float]) -> torch.Tensor:
    """WeightScheduler (continuous.py:63-74): values[i] for the first
    boundary the iteration is below, else values[-1] (fp32 scalar);
    len(values) is len(boundaries) + 1 or len(boundaries)."""
    v = list(values) + [values[-1]]
    idx = bisect.bisect_right(list(boundaries), int(iteration))
    return torch.tensor(v[min(idx, len(values))], dtype=torch.float32)


def video_consistency_windows(video: torch.Tensor, num_frames: int, step: int) -> torch.Tensor:
    """Sliding windows along T (continuous.py:400-416): (B, 3, T, H, W) ->
    (B * num_windows, 3, num_frames, H, W)."""
    B, C, T, H, W = video.shape
    if T < num_frames:
        raise ValueError(f"{T} frames < the window's {num_frames}")
    n_win = (T - num_frames) // step + 1
    wins = torch.stack([video[:, :, i * step:i * step + num_frames] for i in range(n_win)], dim=1)
    return wins.reshape(B * n_win, C, num_frames, H, W)


def video_consistency_loss(params: Params, cfg: VAEConfig, video: torch.Tensor,
                           num_frames: int, step: int) -> torch.Tensor:
    """VideoConsistencyLoss (continuous.py:391-440): each window tokenized on
    its own; the L1 between consecutive windows' reconstructions of their
    shared frames."""
    B = video.shape[0]
    wins = video_consistency_windows(video, num_frames, step)
    recon = vae_decode(params, cfg, vae_encode(params, cfg, wins))
    recon = recon.reshape(B, wins.shape[0] // B, *recon.shape[1:]).float()
    return torch.mean(torch.abs(recon[:, :-1, :, step:] - recon[:, 1:, :, :-step]))


def tokenizer_loss(
    params: Params,
    cfg: VAEConfig,
    video: torch.Tensor,  # (B, 3, T, H, W) in [-1, 1]
    w_l1: float = 1.0,
    w_mse: float = 1.0,
    w_grad: float = 0.5,
    w_temporal: float = 0.5,
    w_latent: float = 1e-4,
    w_consistency: float = 0.0,
    consistency_frames: int = 0,
    consistency_step: int = 1,
    iteration: int = 0,
    schedules: Optional[Dict[str, Tuple]] = None,
    lpips_params: Optional[Params] = None,
    w_perceptual: float = 1.0,
    w_gram: float = 0.0,
    w_flow: float = 0.0,
    flow_scale: int = 2,
    flow_fn=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics). schedules: optional {"l1" | "mse" | "grad" |
    "temporal" | "perceptual" | "gram" | "flow" | "consistency":
    (boundaries, values)} iteration-dependent multipliers on top of the
    w_* weights. lpips_params adds the reference perceptual term
    (production PerceptualLoss: layer-weighted L1 on raw VGG features, the
    gram term when w_gram > 0); w_flow > 0 the FlowLoss with ``flow_fn``
    (RAFT, or Lucas-Kanade by default); w_consistency > 0 with
    consistency_frames the overlapped-window consistency."""
    def sched(name):
        if schedules and name in schedules:
            b, v = schedules[name]
            return piecewise_weight(iteration, b, v).to(video.device)
        return 1.0

    latent = vae_encode(params, cfg, video)
    recon = vae_decode(params, cfg, latent)
    vf, rf = video.float(), recon.float()
    l1 = torch.mean(torch.abs(rf - vf))
    mse = torch.mean((rf - vf) ** 2)
    (gh_r, gw_r), (gh_v, gw_v) = _gradients(rf), _gradients(vf)
    grad_loss = torch.mean(torch.abs(gh_r - gh_v)) + torch.mean(torch.abs(gw_r - gw_v))
    dt_r, dt_v = rf[:, :, 1:] - rf[:, :, :-1], vf[:, :, 1:] - vf[:, :, :-1]
    temporal = torch.mean(torch.abs(dt_r - dt_v))
    latent_reg = torch.mean(latent.float() ** 2)
    loss = (w_l1 * sched("l1") * l1 + w_mse * sched("mse") * mse
            + w_grad * sched("grad") * grad_loss + w_temporal * sched("temporal") * temporal
            + w_latent * latent_reg)
    metrics = {"l1": l1, "mse": mse, "grad": grad_loss, "temporal": temporal}
    if lpips_params is not None:
        from gen3c_tpu_torch.training.lpips import perceptual_video

        perceptual, gram = perceptual_video(lpips_params, vf, rf, gram=w_gram > 0.0)
        loss = loss + w_perceptual * sched("perceptual") * perceptual
        metrics["perceptual"] = perceptual
        if gram is not None:
            loss = loss + w_gram * sched("gram") * gram
            metrics["gram"] = gram
    if w_flow > 0.0 and video.shape[2] > 1:
        from gen3c_tpu_torch.training.flow import flow_loss

        fl = flow_loss(vf, rf, flow_fn=flow_fn, scale=flow_scale)
        loss = loss + w_flow * sched("flow") * fl
        metrics["flow"] = fl
    if w_consistency > 0.0 and consistency_frames > 0:
        consistency = video_consistency_loss(params, cfg, video, consistency_frames,
                                             consistency_step)
        loss = loss + w_consistency * sched("consistency") * consistency
        metrics["consistency"] = consistency
    metrics["loss"] = loss
    return loss, metrics


def tokenizer_loss_and_grads(params: Params, cfg: VAEConfig, video: torch.Tensor,
                             iteration: int = 0, **loss_kwargs
                             ) -> Tuple[Dict[str, torch.Tensor], Params]:
    """``tokenizer_loss``'s detached metrics and its gradient with respect
    to every parameter (``jax.value_and_grad(..., has_aux=True)``)."""
    names = list(params)
    loss, metrics = tokenizer_loss(params, cfg, video, iteration=iteration, **loss_kwargs)
    grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
    grads = {n: torch.zeros_like(params[n]) if g is None else g for n, g in zip(names, grads)}
    return {k: v.detach() for k, v in metrics.items()}, grads


def tokenizer_train_step(params: Params, opt_state: OptState, video: torch.Tensor,
                         cfg: VAEConfig, optimizer: Optimizer, iteration: int = 0,
                         **loss_kwargs) -> Tuple[Params, OptState, Dict[str, torch.Tensor]]:
    """One optimizer step on ``tokenizer_loss`` (params and state updated in
    place and returned, as gen3c_tpu returns new ones)."""
    metrics, grads = tokenizer_loss_and_grads(params, cfg, video, iteration, **loss_kwargs)
    optimizer.update(grads, opt_state, params)
    return params, opt_state, metrics


def cli_config(channels: int, resolution: int) -> VAEConfig:
    """The CLI's tokenizer (tokenizer_train.py:265-269): the CV8x8x8 topology
    at ``channels`` wide, one res block a level, no attention, 4 latent
    channels."""
    return VAEConfig(channels=channels, channels_mult=(2, 4, 4), num_res_blocks=1,
                     attn_resolutions=(), resolution=resolution, patch_size=4,
                     latent_channels=4, z_channels=4)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="tokenizer (video VAE) training")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--frames", type=int, default=9)
    p.add_argument("--resolution", type=int, default=64)
    p.add_argument("--max_iter", type=int, default=100)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--save", type=str, default=None)
    p.add_argument("--channels", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--w_consistency", type=float, default=0.0,
                   help="overlapped-window reconstruction consistency weight "
                        "(reference VideoConsistencyLoss)")
    p.add_argument("--consistency_frames", type=int, default=0,
                   help="sliding-window length (8k+1) for --w_consistency")
    p.add_argument("--consistency_step", type=int, default=8)
    p.add_argument("--perceptual", choices=["none", "lpips"], default="none",
                   help="lpips: the reference VGG16 perceptual loss (training/lpips.py); "
                        "without --lpips_checkpoint a RANDOM VGG16 with a warning")
    p.add_argument("--lpips_checkpoint", type=str, default=None)
    p.add_argument("--w_perceptual", type=float, default=1.0)
    p.add_argument("--w_gram", type=float, default=0.0,
                   help="gram-matrix term of the production PerceptualLoss")
    p.add_argument("--w_flow", type=float, default=0.0,
                   help="flow-consistency loss (reference FlowLoss, training/flow.py)")
    p.add_argument("--flow_estimator", choices=["lk", "raft"], default="lk",
                   help="raft: RAFT-Large (aux/raft.py; without --raft_checkpoint a RANDOM "
                        "RAFT with a warning); lk: the Lucas-Kanade fallback")
    p.add_argument("--raft_checkpoint", type=str, default=None,
                   help="torchvision raft_large .pth or converted .npz")
    p.add_argument("--flow_iters", type=int, default=12,
                   help="RAFT GRU update iterations (reference default)")
    p.add_argument("--device", type=str, default="cuda",
                   help="the device to train on (cuda unless asked otherwise)")
    return p


def _clip_batches(args, rng: np.random.RandomState):
    """gen3c_tpu's batches: random clips of --frames frames from the .npz
    under --data_root (``video`` (T, H, W, 3) or (T, 3, H, W), scaled to
    [-1, 1]), or uniform [-1, 1] noise with --synthetic; numpy, drawn from
    ``rng`` as gen3c_tpu draws them."""
    if args.data_root:
        from gen3c_tpu_torch.training.datasets import _to_signed_range

        clips = sorted(os.path.join(args.data_root, f) for f in os.listdir(args.data_root)
                       if f.endswith(".npz"))
        if not clips:
            raise FileNotFoundError(f"no clips under {args.data_root}")

        def one_clip():
            path = clips[rng.randint(len(clips))]
            with np.load(path) as data:
                v = data["video"].astype(np.float32)
            if v.shape[-1] == 3:
                v = v.transpose(0, 3, 1, 2)
            v = _to_signed_range(v, path)
            if v.shape[0] < args.frames:
                raise ValueError(f"{path}: {v.shape[0]} frames < --frames {args.frames}")
            start = rng.randint(0, v.shape[0] - args.frames + 1)
            return v[start:start + args.frames].transpose(1, 0, 2, 3)

        while True:
            yield np.stack([one_clip() for _ in range(args.batch_size)])
    while True:
        yield rng.rand(args.batch_size, 3, args.frames, args.resolution,
                       args.resolution).astype(np.float32) * 2 - 1


def main(argv=None, record: Optional[dict] = None) -> Params:
    """The tokenizer training CLI (gen3c_tpu's flags, plus --device). Returns
    the trained parameters; ``record`` (a dict) receives each step's
    metrics and seconds."""
    args = _parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a card; pass --device cpu to train on the CPU")
    if (args.frames - 1) % 8:
        raise SystemExit(f"--frames {args.frames} must be 8k+1 (causal temporal compression "
                         "of the CV8x8x8 topology)")
    cfg = cli_config(args.channels, args.resolution)
    vae = CausalVAE(cfg, device=device).init_random(
        torch.Generator(device=device).manual_seed(args.seed))
    params = trainable_params(vae)
    lpips_params = None
    if args.perceptual == "lpips":
        from gen3c_tpu_torch.training import lpips as lpips_mod

        if args.lpips_checkpoint:
            lpips_params = lpips_mod.load_lpips_params(args.lpips_checkpoint, device)
            log.info(f"LPIPS VGG16 loaded from {args.lpips_checkpoint}")
        else:
            log.warning("--perceptual lpips without --lpips_checkpoint: using a RANDOM VGG16 "
                        "(structure-only; loss values are not the reference's)")
            lpips_params = lpips_mod.init_vgg16_params(
                torch.Generator(device=device).manual_seed(1234), device=device)
    flow_fn = None
    if args.w_flow > 0.0 and args.flow_estimator == "raft":
        from gen3c_tpu_torch.aux import raft as raft_mod

        if args.raft_checkpoint:
            raft_params = raft_mod.load_raft_params(args.raft_checkpoint, device)
            log.info(f"RAFT-Large loaded from {args.raft_checkpoint}")
        else:
            log.warning("--flow_estimator raft without --raft_checkpoint: using a RANDOM RAFT "
                        "(structure-only; flow values are noise — real runs need the "
                        "torchvision raft_large weights)")
            raft_params = raft_mod.init_raft_params(
                torch.Generator(device=device).manual_seed(7), device=device)
        flow_fn = raft_mod.make_raft_flow_fn(raft_params, num_flow_updates=args.flow_iters)
    optimizer = AdamW(args.lr)
    opt_state = optimizer.init(params)
    loss_kwargs = dict(w_consistency=args.w_consistency,
                       consistency_frames=args.consistency_frames,
                       consistency_step=args.consistency_step, lpips_params=lpips_params,
                       w_perceptual=args.w_perceptual, w_gram=args.w_gram, w_flow=args.w_flow,
                       flow_fn=flow_fn)
    batches = _clip_batches(args, np.random.RandomState(args.seed))
    steps = []
    for i in range(1, args.max_iter + 1):
        video = torch.from_numpy(next(batches)).to(device)
        t0 = time.perf_counter()
        params, opt_state, metrics = tokenizer_train_step(params, opt_state, video, cfg,
                                                          optimizer, iteration=i, **loss_kwargs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if record is not None:
            steps.append({"step": i, "seconds": time.perf_counter() - t0,
                          **{k: float(v) for k, v in metrics.items()}})
        if i % args.log_every == 0:
            log.info(f"tokenizer step {i}: loss {float(metrics['loss']):.4f} "
                     f"(l1 {float(metrics['l1']):.4f}, temporal {float(metrics['temporal']):.4f})")
    if record is not None:
        record["steps"] = steps
    if args.save:
        from gen3c_tpu_torch.utils.checkpoint import save_params_npz

        save_params_npz(args.save, {n: p.detach() for n, p in params.items()})
        log.info(f"saved tokenizer params to {args.save}")
    return params


if __name__ == "__main__":
    main()
