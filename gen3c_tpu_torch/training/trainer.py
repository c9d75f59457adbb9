"""Training loop on one device or over a (dp, cp) mesh: callbacks, async
checkpoints, resume (port of gen3c_tpu/training/trainer.py).

The hooks (``training.callbacks``) fire in gen3c_tpu's order. Over a mesh
(``groups``, one process a rank) every rank feeds the same global batches
and draws (``train_step.make_sharded_train_step`` slices them), takes the
same optimizer step and restores the same checkpoint; only rank 0 writes
the job's files (config.json, checkpoints). Tensor and sequence
parallelism (ROADMAP item 15b) and FSDP (15c) are not ported.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Callable, Iterable, Optional

import numpy as np
import torch
import torch.nn as nn

from gen3c_tpu_torch.models.dit import DiTConfig
from gen3c_tpu_torch.parallel.mesh import ITEM_15B, ITEM_15C, Groups
from gen3c_tpu_torch.training.callbacks import CallBackGroup, HangWatchdog, IterSpeed
from gen3c_tpu_torch.training.checkpointing import Checkpointer
from gen3c_tpu_torch.training.losses import LogvarHead
from gen3c_tpu_torch.training.train_step import (
    NetWithLogvar,
    TrainState,
    init_train_state,
    make_optimizer,
    make_sharded_train_step,
    train_step,
)


@dataclasses.dataclass
class TrainerConfig:
    """gen3c_tpu's TrainerConfig: the same fields and defaults."""

    job_dir: str = "runs/debug"
    max_iter: int = 1000
    save_every: int = 500
    log_every: int = 10
    validation_every: int = 0  # 0 = off
    lr: float = 1e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    seed: int = 0
    grad_accum_steps: int = 1
    remat: bool = False  # rematerialize DiT blocks (activation checkpointing)
    fsdp: bool = False  # not ported (ROADMAP item 15c)
    sequence_parallel: bool = False  # not ported (ROADMAP item 15b)
    step_timeout_s: float = 0.0  # SIGALRM watchdog per step; 0 = off
    prefetch_batches: int = 2  # background prefetch depth; 0 = synchronous
    loss_add_logvar: bool = False  # Kendall loss with a learned logvar head
    text_dropout_rate: float = 0.0
    video_cond_dropout_rate: float = 0.0
    loss_reduce: str = "mean"
    loss_scale: float = 1.0
    video_extend: bool = False
    condition_location: str = "first_random_n"
    first_random_n_min: int = 0
    first_random_n_max: int = 4
    random_condition_rate: float = 0.5
    augment_sigma_multiplier: float = 4.0
    compute_loss_for_condition_region: bool = False


class Trainer:
    """EDM training of ``net`` (a GeneralDIT, ActionDiT or
    MultiviewGeneralDIT on its device) with the config's optimizer; the
    train state lives on the net's device. Every tensor of a batch reaches
    ``train_step`` (gen3c_tpu shards "action" over dp beside the rest,
    trainer.py:118-125): an action experiment's "action" conditions its
    net. groups: this rank's (dp, cp) mesh (``parallel.mesh.make_groups``;
    None or a one-rank mesh: one device)."""

    def __init__(self, config: TrainerConfig, dit_cfg: DiTConfig, net: nn.Module,
                 callbacks: Optional[CallBackGroup] = None, groups: Optional[Groups] = None):
        if config.fsdp:
            raise NotImplementedError(f"FSDP is not ported ({ITEM_15C})")
        if config.sequence_parallel:
            raise NotImplementedError(f"sequence parallelism is not ported ({ITEM_15B})")
        self.config = config
        self.dit_cfg = dit_cfg
        self.groups = groups if groups is not None and groups.parallel else None
        self.writes = self.groups is None or self.groups.world.rank == 0
        os.makedirs(config.job_dir, exist_ok=True)
        if self.writes:
            with open(os.path.join(config.job_dir, "config.json"), "w") as f:
                json.dump(dataclasses.asdict(config), f, indent=2, default=str)
        self.optimizer = make_optimizer(
            lr=config.lr, weight_decay=config.weight_decay, grad_clip=config.grad_clip,
            warmup_steps=config.warmup_steps, grad_accum_steps=config.grad_accum_steps)
        params = net
        if config.loss_add_logvar and not isinstance(net, NetWithLogvar):
            device = next(net.parameters()).device
            head = LogvarHead(device=device).init_random(
                torch.Generator(device=device).manual_seed(config.seed + 1))
            params = NetWithLogvar(net, head)
        self.state: TrainState = init_train_state(params, self.optimizer)
        self.checkpointer = Checkpointer(os.path.join(config.job_dir, "checkpoints"))
        self.callbacks = callbacks or CallBackGroup([IterSpeed(config.log_every)])
        if config.step_timeout_s > 0:
            self.callbacks.append(HangWatchdog(config.step_timeout_s))
        self._rng = torch.Generator().manual_seed(config.seed)
        self._steps = {}

    def _step_fn(self, data_type: str):
        """The step of a batch kind: ``train_step`` on one device, else
        ``make_sharded_train_step`` over the mesh (one a kind, as gen3c_tpu
        builds its image leg)."""
        if self.groups is None:
            return functools.partial(train_step, cfg=self.dit_cfg, optimizer=self.optimizer,
                                     **self._step_kwargs(data_type))
        if data_type not in self._steps:
            self._steps[data_type] = make_sharded_train_step(
                self.groups, self.dit_cfg, self.optimizer, **self._step_kwargs(data_type))
        return self._steps[data_type]

    def _save(self, step: int) -> None:
        if self.writes:
            self.checkpointer.save(step, self.state.state_dict())

    def _step_kwargs(self, data_type: str) -> dict:
        c = self.config
        kw = dict(remat=c.remat, loss_add_logvar=c.loss_add_logvar,
                  text_dropout_rate=c.text_dropout_rate,
                  video_cond_dropout_rate=c.video_cond_dropout_rate,
                  loss_reduce=c.loss_reduce, loss_scale=c.loss_scale, data_type=data_type)
        if data_type == "video":
            kw.update(video_extend=c.video_extend, condition_location=c.condition_location,
                      first_random_n_min=c.first_random_n_min,
                      first_random_n_max=c.first_random_n_max,
                      random_condition_rate=c.random_condition_rate,
                      augment_sigma_multiplier=c.augment_sigma_multiplier,
                      compute_loss_for_condition_region=c.compute_loss_for_condition_region)
        return kw

    def maybe_resume(self) -> int:
        self.callbacks.on_load_checkpoint_start(self)
        restored = self.checkpointer.restore()
        if restored is None:
            return 0
        self.state.load_state_dict(restored)
        self.callbacks.on_load_checkpoint_end(self, self.state.step)
        return self.state.step

    def train(self, dataloader: Iterable[dict],
              validate_fn: Optional[Callable[[TrainState, int], dict]] = None) -> TrainState:
        cfg = self.config
        start = self.maybe_resume()
        self.callbacks.on_train_start(self)
        prefetch = None
        if cfg.prefetch_batches > 0:
            from gen3c_tpu_torch.training.datasets import PrefetchIterator

            dataloader = prefetch = PrefetchIterator(dataloader, prefetch=cfg.prefetch_batches)
        try:
            self._run(dataloader, start, validate_fn)
        finally:
            if prefetch is not None:
                prefetch.close()
        self._save(cfg.max_iter)
        self.checkpointer.wait()
        self.callbacks.on_train_end(self)
        self.callbacks.on_app_end(self)
        return self.state

    def _run(self, dataloader: Iterable[dict], start: int,
             validate_fn: Optional[Callable[[TrainState, int], dict]]) -> None:
        cfg = self.config
        it = iter(dataloader)
        for step in range(start + 1, cfg.max_iter + 1):
            self.callbacks.on_training_step_start(self, step)
            self.callbacks.on_before_dataloading(self, step)
            batch = next(it)
            self.callbacks.on_after_dataloading(self, step, batch)
            data_type = "video" if "extra_channels" in batch else "image"
            # forward, backward and the optimizer run inside train_step: the
            # sub-hooks fire adjacently around it, in gen3c_tpu's order
            self.callbacks.on_before_forward(self, step)
            self.callbacks.on_before_backward(self, step)
            self.callbacks.on_before_optimizer_step(self, step)
            self.state, metrics = self._step_fn(data_type)(self.state, batch, self._rng)
            self.callbacks.on_after_forward(self, step)
            self.callbacks.on_after_backward(self, step)
            self.callbacks.on_before_zero_grad(self, step)
            self.callbacks.on_training_step_end(self, step, metrics)
            if cfg.save_every and step % cfg.save_every == 0:
                self.callbacks.on_save_checkpoint_start(self, step)
                self._save(step)
                self.callbacks.on_save_checkpoint_end(self, step)
            if validate_fn is not None and cfg.validation_every \
                    and step % cfg.validation_every == 0:
                self.callbacks.on_validation_start(self, step)
                self.callbacks.on_validation_step_start(self, step)
                val = validate_fn(self.state, step)
                self.callbacks.on_validation_step_end(self, step, val)
                self.callbacks.on_validation_end(self, step, val)


def synthetic_latent_dataset(batch: int, channels: int, t: int, h: int, w: int,
                             extra_channels: int = 65, ctx_len: int = 16, seed: int = 0):
    """Infinite synthetic batches in the train_step format (fp32 CPU
    tensors drawn with numpy from ``seed``: gen3c_tpu's stream, value for
    value)."""
    rng = np.random.RandomState(seed)
    while True:
        yield {
            "x0": torch.from_numpy(rng.randn(batch, channels, t, h, w).astype(np.float32)),
            "crossattn_emb": torch.from_numpy(rng.randn(batch, ctx_len, 1024).astype(np.float32)),
            "extra_channels": torch.from_numpy(
                rng.randn(batch, extra_channels, t, h, w).astype(np.float32)),
        }


def synthetic_joint_dataset(batch: int, channels: int, t: int, h: int, w: int,
                            extra_channels: int = 65, ctx_len: int = 16, seed: int = 0,
                            image_every: int = 2):
    """Joint image+video stream: every ``image_every``-th batch is an image
    batch (T=1 latents, no extra_channels)."""
    rng = np.random.RandomState(seed)
    video = synthetic_latent_dataset(batch, channels, t, h, w, extra_channels, ctx_len, seed)
    i = 0
    while True:
        i += 1
        if image_every and i % image_every == 0:
            yield {
                "x0": torch.from_numpy(rng.randn(batch, channels, 1, h, w).astype(np.float32)),
                "crossattn_emb": torch.from_numpy(
                    rng.randn(batch, ctx_len, 1024).astype(np.float32)),
            }
        else:
            yield next(video)
