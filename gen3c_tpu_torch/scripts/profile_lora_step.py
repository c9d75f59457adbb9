"""Where the time of one LoRA + band training step of GEN3C-7B goes, on one card.

Builds the full 28-block GEN3C-7B DiT (4096 channels, 32 x 128 heads, bf16,
random weights from seed 0, AdaLN gates randomized) with the fast preset's
band (window 2, prefix 1), LoRA rank 16 on DEFAULT_TARGETS and a random
batch of one 121-frame 704x1280 clip (latent (16, 16, 88, 160), 56,320
tokens, 512 text tokens). Then it runs ``lora_train_step`` with remat: one
step to warm up, one under ``torch.profiler`` (CUDA activity). Every merge
of an adapted weight runs inside the ``lora_merge`` range (``training/
lora.py``).

The device time of the profiled step's kernels is split by kind:
  attention      the port's kernels (``attn_*``), by kernel
  gemm_merge     matrix products with the LoRA rank in a shape: A @ B and
                 its gradients
  gemm_dense_dw  products that reduce over the tokens (56,320 or 512): the
                 dense weight gradients of the adapted linears
  gemm_other     every other product: the linears' forward (twice, remat)
                 and their input gradients
  other          the rest: elementwise, reductions, copies
with ``lora_merge_range`` (the device time of everything the merges launch
in the forward and the remat recompute, their casts and adds included)
beside them, and the idle share of the step: 1 - kernel time / wall time
(one stream). Prints one JSON line; writes the profiler's table (top rows by
self device time, by op and input shapes) to ``--out``.

    python -m gen3c_tpu_torch.scripts.profile_lora_step [--out outputs/lora_step_profile.txt]

It needs a CUDA card (about 50 GB of it).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys
import time

import torch

RANK = 16
BAND = (2, 1)  # window, prefix frames: the fast preset's
LATENT = (16, 16, 88, 160)  # channels, frames, height, width
CTX = 512


def _on_device(evt) -> bool:
    return str(evt.device_type).endswith("CUDA")


def _is_kernel(evt) -> bool:
    """A device row that is not the device side of a named range (the
    profiler table's own rule for its device time total)."""
    return _on_device(evt) and not evt.is_user_annotation


def split(prof, tokens: tuple) -> dict:
    """Device milliseconds of the profiled kernels by kind (see above)."""
    rows = prof.key_averages(group_by_input_shape=True)
    kinds = {"attention": 0.0, "gemm_merge": 0.0, "gemm_dense_dw": 0.0, "gemm_other": 0.0}
    attention, total, merge_range = {}, 0.0, 0.0
    for evt in rows:
        us = evt.self_device_time_total
        if _is_kernel(evt):
            total += us
            m = re.search(r"(attn_\w+)", evt.key)
            if m:
                kinds["attention"] += us
                attention[m.group(1)] = attention.get(m.group(1), 0.0) + us / 1e3
            continue
        if evt.key == "lora_merge" and not _on_device(evt):  # the kernels in the range
            merge_range += evt.device_time_total
        if evt.key not in ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm") or not us:
            continue
        shapes = [s for s in evt.input_shapes if len(s) >= 2][-2:]  # the two matrix operands
        if len(shapes) != 2:
            kinds["gemm_other"] += us
        elif RANK in shapes[0] + shapes[1]:
            kinds["gemm_merge"] += us
        elif shapes[0][-1] in tokens:
            kinds["gemm_dense_dw"] += us
        else:
            kinds["gemm_other"] += us
    ms = {k: v / 1e3 for k, v in kinds.items()}
    ms["other"] = total / 1e3 - sum(ms.values())
    return {"kernel_ms": total / 1e3, "by_kind_ms": ms, "attention_ms": attention,
            "lora_merge_range_ms": merge_range / 1e3}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="outputs/lora_step_profile.txt",
                   help="where the profiler's table goes")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the profile needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from gen3c_tpu_torch.pipelines.factory import GEN3C_7B_PRESET
    from gen3c_tpu_torch.scripts.card import randomize_gates
    from gen3c_tpu_torch.training.lora import init_lora_params, lora_leaves, lora_train_step
    from gen3c_tpu_torch.training.train import build_net
    from gen3c_tpu_torch.training.train_step import make_optimizer
    from gen3c_tpu_torch.training.trainer import TrainerConfig

    cfg = dataclasses.replace(GEN3C_7B_PRESET.dit, attn_temporal_window=BAND[0],
                              attn_prefix_frames=BAND[1])
    net = build_net(cfg, "cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    randomize_gates(net, gen)
    c, t, h, w = LATENT
    batch = {"x0": torch.randn((1, c, t, h, w), generator=gen, device="cuda"),
             "crossattn_emb": torch.randn((1, CTX, 1024), generator=gen, device="cuda"),
             "extra_channels": torch.randn((1, cfg.in_channels - c, t, h, w), generator=gen,
                                           device="cuda")}
    lora = init_lora_params(torch.Generator(device="cuda").manual_seed(0), net, rank=RANK)
    tc = TrainerConfig()
    opt = make_optimizer(lr=tc.lr, weight_decay=tc.weight_decay, grad_clip=tc.grad_clip,
                         warmup_steps=1)
    opt_state = opt.init(lora_leaves(lora))
    rng = torch.Generator().manual_seed(0)

    def step() -> float:
        nonlocal lora, opt_state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lora, opt_state, _ = lora_train_step(lora, opt_state, net, batch, rng, cfg, opt,
                                             remat=True)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    warm_s = step()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step_s = step()
    tokens = (t * h * w // 4, CTX)
    res = {"blocks": cfg.num_blocks, "band": list(BAND), "rank": RANK, "tokens": tokens[0],
           "warmup_step_s": warm_s, "profiled_step_s": step_s, **split(prof, tokens)}
    res["idle_share"] = 1.0 - res["kernel_ms"] / (step_s * 1e3)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(prof.key_averages(group_by_input_shape=True).table(
            sort_by="self_device_time_total", row_limit=60, max_name_column_width=90,
            max_shapes_column_width=70))
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
