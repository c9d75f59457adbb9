"""Training CLI (port of gen3c_tpu/training/train.py) on one device or a
(dp, cp) mesh of ranks.

    python -m gen3c_tpu_torch.training.train --synthetic --remat \\
        experiment=gen3c_tiny trainer.max_iter=4 trainer.save_every=2 \\
        trainer.warmup_steps=1 trainer.job_dir=runs/tiny

    torchrun --nproc_per_node 4 -m gen3c_tpu_torch.training.train --synthetic \\
        --dp 2 --cp 2 --batch_size 2 experiment=gen3c_tiny trainer.max_iter=4 ...

``experiment=`` picks a preset (any name of ``utils.registry.experiments``:
gen3c_tiny, gen3c_7b, GEN3C_Cosmos_7B, the Cosmos text2world and multiview
presets, video2world_instruction_* and video2world_action_*; the net is a
GeneralDIT, a MultiviewGeneralDIT or an ActionDiT by the preset's config),
``trainer.<field>=`` overrides TrainerConfig, any other ``a.b=v`` the
preset (``dit.num_blocks=12``, ``dit.attn_temporal_window=2`` for band
attention). The DiT gets seeded random weights on ``--device``: ``cuda``
unless the caller passes another (the tests pass ``cpu``). Running again
with the same job_dir resumes from its latest checkpoint. Under torchrun
each process is a rank of a (dp, cp) mesh (``--dp``, ``--cp``; cp by
default every rank dp leaves, as gen3c_tpu's ``make_mesh``; the batch
splits over dp, the latent frames over cp, and ``--batch_size`` must
divide by dp): every rank builds the same net and the same global batches,
and ``train_step.make_sharded_train_step`` takes its slice. The ranks join
over NCCL on ``cuda:$LOCAL_RANK`` (one rank a card) or gloo on the CPU.
``--tp``, ``--fsdp`` and
``--sequence_parallel`` raise (ROADMAP item 15b, 15c). The data is
``--synthetic`` latents or ``--data_root``, a directory of packaged RGBD
clips (``datasets.Gen3CClipDataset``): the preset's GEN3C model is built
on the device, and its DiT is the one trained (one DiT, not two) while its
VAE and the 3D cache turn each clip into a batch. The synthetic stream's
context has 16 tokens a view; an action experiment's batches also carry
actions (B, 1, 7) from numpy's RandomState(17), as gen3c_tpu's do.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import torch

import numpy as np

from gen3c_tpu_torch.models.dit import DiTConfig, GeneralDIT
from gen3c_tpu_torch.models.dit_action import ActionDiT, ActionDiTConfig
from gen3c_tpu_torch.models.dit_multiview import MultiviewDiTConfig, MultiviewGeneralDIT
from gen3c_tpu_torch.parallel import mesh
from gen3c_tpu_torch.pipelines.factory import resolve_device
from gen3c_tpu_torch.training.trainer import Trainer, TrainerConfig, synthetic_latent_dataset
from gen3c_tpu_torch.utils import log, registry


def build_net(dit_cfg: DiTConfig, device, seed: int) -> GeneralDIT:
    """The net of ``dit_cfg``'s kind (MultiviewGeneralDIT, ActionDiT or
    GeneralDIT) with the JAX package's random init, drawn on ``device``."""
    device = torch.device(device)
    cls = (MultiviewGeneralDIT if isinstance(dit_cfg, MultiviewDiTConfig)
           else ActionDiT if isinstance(dit_cfg, ActionDiTConfig) else GeneralDIT)
    with torch.device("meta"):
        net = cls(dit_cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    return net.to_empty(device=device).init_random(gen)


def with_actions(stream, batch_size: int, dim: int, seed: int = 17):
    """The batches of ``stream`` with "action" (B, 1, dim) fp32 from numpy's
    RandomState(seed): bridge-style robot actions, one vector a clip."""
    rng = np.random.RandomState(seed)
    for b in stream:
        yield {**b, "action": torch.from_numpy(
            rng.randn(batch_size, 1, dim).astype(np.float32))}


def main(argv=None) -> Optional[Trainer]:
    argv = list(sys.argv[1:] if argv is None else argv)
    overrides = [a for a in argv if "=" in a and not a.startswith("--")]
    flags = [a for a in argv if a not in overrides and a != "--"]

    p = argparse.ArgumentParser()
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--cp", type=int, default=None)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--fsdp", action="store_true")
    p.add_argument("--sequence_parallel", action="store_true")
    p.add_argument("--remat", action="store_true", help="activation-checkpoint DiT blocks")
    p.add_argument("--loss_add_logvar", action="store_true",
                   help="Kendall uncertainty loss with a learned per-sigma logvar head")
    p.add_argument("--text_dropout_rate", type=float, default=0.0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda: cuda:$LOCAL_RANK under torchrun; pass "
                        "cpu to train on the CPU)")
    args = p.parse_args(flags)
    if args.tp > 1 or args.sequence_parallel:
        raise NotImplementedError(f"tensor and sequence parallelism are not ported "
                                  f"({mesh.ITEM_15B})")
    if args.fsdp:
        raise NotImplementedError(f"FSDP is not ported ({mesh.ITEM_15C})")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device here "
                           "(pass --device cpu to train on the CPU)")
    if args.batch_size % args.dp:
        raise SystemExit(f"--batch_size {args.batch_size} must be divisible by --dp {args.dp}")
    device = resolve_device(args.device)
    mesh.maybe_distributed_init(None, device)
    groups = mesh.make_groups(dp=args.dp, cp=args.cp)

    exp_name = "gen3c_tiny"
    t_cfg = TrainerConfig()
    rest = []
    for ov in overrides:
        key, _, val = ov.partition("=")
        if key == "experiment":
            exp_name = val
        elif key.startswith("trainer."):
            t_cfg = registry.apply_overrides(t_cfg, [ov[len("trainer."):]])
        else:
            rest.append(ov)
    preset = registry.apply_overrides(registry.get_experiment(exp_name), rest)
    for flag in ("remat", "loss_add_logvar"):
        if getattr(args, flag):
            t_cfg = registry.apply_overrides(t_cfg, [f"{flag}=True"])
    if args.text_dropout_rate:
        t_cfg = registry.apply_overrides(t_cfg, [f"text_dropout_rate={args.text_dropout_rate}"])

    log.info(f"experiment={exp_name} device={device} mesh dp={groups.dp.size} "
             f"cp={groups.cp.size}")
    if args.data_root:
        from gen3c_tpu_torch.pipelines.factory import build_gen3c_model
        from gen3c_tpu_torch.training.datasets import Gen3CClipDataset

        # the net build_net would draw: build_gen3c_model seeds its generator
        # the same way and draws the DiT first
        model, _ = build_gen3c_model(preset, device=device, seed=t_cfg.seed)
        net = model.net
        data = iter(Gen3CClipDataset(args.data_root, model, args.batch_size))
    else:
        net = build_net(preset.dit, device, t_cfg.seed)
        C, T, Hl, Wl = preset.state_shape
        data = synthetic_latent_dataset(args.batch_size, C, T, Hl, Wl,
                                        extra_channels=preset.dit.in_channels - C,
                                        ctx_len=16 * getattr(preset.dit, "n_views", 1))
        if isinstance(preset.dit, ActionDiTConfig):
            data = with_actions(data, args.batch_size, preset.dit.action_dim)
    trainer = Trainer(t_cfg, preset.dit, net, groups=groups)
    state = trainer.train(data)
    log.info(f"training done at step {state.step}")
    return trainer


if __name__ == "__main__":
    main()
