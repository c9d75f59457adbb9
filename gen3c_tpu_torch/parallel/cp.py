"""Context- and CFG-parallel denoising (port of gen3c_tpu/parallel/cp.py).

Every rank holds the same replicated inputs (it built the same model from
the same seed, rendered and encoded the same frames, drew the same global
noise). ``cp_generate_samples`` keeps this rank's contiguous latent-T
shard of the latents, condition masks and pose latents (the reference's
split_inputs_cp; text embeddings and weights stay replicated), runs the
sampler with the DiT in its context-parallel mode (``GeneralDIT.forward(cp=
...)``) and CFG split over the cfg axis when it has 2 ranks, then gathers
the samples on T (cat_outputs_cp), so that every rank returns the whole
latent. With the net's ``cache_block_span`` and step_cache_interval > 1 the
sampler carries each rank's shard of the span delta. The JAX package's
tensor- and sequence-parallel span variants (cp.py:64-91) wait for
tensor parallelism (ROADMAP item 15b).
"""

from __future__ import annotations

import torch

from gen3c_tpu_torch.diffusion.sampler import generate_samples
from gen3c_tpu_torch.models.dit import GeneralDIT
from gen3c_tpu_torch.models.gen3c import dit_net_fns
from gen3c_tpu_torch.parallel import collectives
from gen3c_tpu_torch.parallel.mesh import Groups

# generate_samples's arguments with a latent T axis (dim 2), sharded on cp
_SHARDED = ("init_noise", "augment_noise", "gt_latent", "condition_video_indicator",
            "condition_video_input_mask", "pose_latent_cond", "pose_latent_uncond")


def cp_generate_samples(groups: Groups, net: GeneralDIT, **sampler_kw) -> torch.Tensor:
    """``generate_samples`` over this rank's groups, with net as its
    network (fps 24, the DiT in its cp mode). Every tensor argument is
    global (the whole latent T, the same on every rank); returns the whole
    final latent (B, C, T, H, W), fp32, on every rank. Latent T must
    divide by the cp size (gen3c_tpu/parallel/cp.py:138)."""
    cp = groups.cp if groups.cp.size > 1 else None
    cfg = groups.cfg if groups.cfg.size > 1 else None
    n = groups.cp.size
    T = sampler_kw["init_noise"].shape[2]
    if T % n:
        raise ValueError(f"latent T={T} must divide by cp={n}")
    t0, t1 = groups.cp.rank * (T // n), (groups.cp.rank + 1) * (T // n)
    for k in _SHARDED:
        if sampler_kw.get(k) is not None:
            sampler_kw[k] = sampler_kw[k][:, :, t0:t1]
    # span caching (gen3c_tpu/parallel/cp.py:139-166): each rank carries the
    # delta of its own tokens, sharded like everything else
    span = net.cfg.cache_block_span is not None and sampler_kw.get("step_cache_interval", 1) > 1
    net_fn, net_fn_skip = dit_net_fns(net, span, cp)
    out = generate_samples(net_fn, cp=cp, cfg=cfg, net_fn_skip=net_fn_skip, **sampler_kw)
    if cp is None:
        return out
    return collectives.all_gather(out, 2, cp).contiguous()
