"""The Cosmos AR world model at ar_4b on one card, uncut and timed.

    PYTHONPATH=<checkout> python gen3c_tpu_torch/scripts/time_ar_world.py [--out FILE]

Seeded weights throughout (no checkpoints): the 4B (bf16, 3.99 B
parameters) and DV8x16x16 from seed 0. A seeded 33-frame 640x1024 clip is
tokenized to the (5, 40, 64) grid and ``generate_world_tokens`` (the CLI's
path) prefills its 5,120 prefix tokens and decodes the other TOKENS = 7,680 (top-p
0.8), once with a bf16 KV cache and once with an int8 one: prefill s, each
decode step's seconds (CUDA events at every sampled token, so the device
timeline between tokens, host gaps included: mean, p50, p90), K8's
launches, peak GiB. Then two runs of PLAIN_TOKENS = 256 from the same prefix, both
with every attention call bracketed by CUDA events: K8's (the kernel) and
the plain version's (``kernels.gqa_attention_reference`` put in place of
the module's ``_gqa_attention``), each giving the share of a decode step
spent in attention. Then the seeded 7B diffusion decoder (gates
randomized) refines the bf16 run's grid: one reflect-padded 8-frame chunk,
DD_STEPS = 15 EDM-Euler steps with CFG (B = 2) at 20,480 tokens, and the CV8x8x8
decode to 57 frames, trimmed to 33: s per step, decode s, peak GiB. It
prints one JSON object (and writes it to --out) with the card's name and
power limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch

from gen3c_tpu_torch.scripts.card import nvidia_smi_line, randomize_gates

TOKENS = 7680  # the decoded tokens: the grid's last 3 of 5 latent frames
PLAIN_TOKENS = 256  # tokens of each of the two attention-share runs
DD_STEPS = 15  # the decoder's EDM-Euler steps


class StepClock:
    """A CUDA event at every sampled token (``on_step``): the device-timeline
    seconds of each decode step, read once at the end."""

    def __init__(self):
        self.events = []

    def __call__(self, i: int) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)

    def seconds(self) -> list:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) / 1e3 for a, b in zip(self.events, self.events[1:])]


@contextlib.contextmanager
def attention_spans(plain: bool):
    """Bracket every ``_gqa_attention`` call of the AR network with CUDA
    events (and, plain, run K8's plain version in its place); yields the
    list of (start, end) pairs."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.models import ar_transformer as tar

    spans, original = [], tar._gqa_attention
    inner = kernels.gqa_attention_reference if plain else original

    def timed(*args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*args)
        end.record()
        spans.append((start, end))
        return out

    tar._gqa_attention = timed
    try:
        yield spans
    finally:
        tar._gqa_attention = original


def _summary(step_s: list) -> dict:
    a = np.asarray(step_s)
    return {"mean_s": float(a.mean()), "p50_s": float(np.percentile(a, 50)),
            "p90_s": float(np.percentile(a, 90)), "min_s": float(a.min()),
            "max_s": float(a.max()), "steps": int(a.size)}


def generate_timed(model, tokenizer, clip, quantize_kv: bool, n_tokens: int) -> dict:
    """The CLI's ``generate_world_tokens`` with a CUDA event at every token."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.pipelines import autoregressive as ar

    clock, record = StepClock(), {}
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid = ar.generate_world_tokens(model, tokenizer, clip, temperature=1.0, top_p=0.8,
                                    quantize_kv=quantize_kv, seed=0, max_new_tokens=n_tokens,
                                    record=record, on_step=clock)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    return {"kv_cache": "int8" if quantize_kv else "bf16", "tokens": n_tokens,
            "encode_s": record["encode_s"][0], "prefill_s": record["prefill_s"][0],
            "decode_s": record["decode_s"][0], "total_s": total,
            "per_token": _summary(clock.seconds()), "launches": dict(kernels.launch_counts),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "grid": grid}


def attention_share(model, prefix: torch.Tensor, n_tokens: int, plain: bool) -> dict:
    """A ``generate`` of n_tokens from ``prefix`` (bf16 cache) with every
    attention call timed: the attention's share of the decode steps."""
    from gen3c_tpu_torch.models.ar_transformer import generate

    clock = StepClock()
    with attention_spans(plain) as spans:
        generate(model, prefix, n_tokens, temperature=1.0, top_p=0.8, seed=0, on_step=clock)
        steps = clock.seconds()
        layers = model.cfg.n_layers
        per_call = [a.elapsed_time(b) / 1e3 for a, b in spans]
    decode_attn = per_call[layers:]  # after the prefill's 16 calls
    attn_per_step = [sum(decode_attn[i * layers:(i + 1) * layers])
                     for i in range(len(decode_attn) // layers)]
    return {"route": "plain" if plain else "K8", "tokens": n_tokens,
            "positions": [int(prefix.shape[1]), int(prefix.shape[1]) + n_tokens - 1],
            "per_token": _summary(steps),
            "attention_s_per_step": float(np.mean(attn_per_step)),
            "attention_share": float(np.sum(attn_per_step) / np.sum(steps)),
            "attention_s_per_call_last": float(np.mean(decode_attn[-layers:]))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_ar_world needs a CUDA card")
    from gen3c_tpu_torch.kernels import build
    from gen3c_tpu_torch.pipelines import autoregressive as ar
    from gen3c_tpu_torch.pipelines import diffusion_decoder as dd

    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": nvidia_smi_line(),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "build_s": build.build()["seconds"]}
    preset = ar.AR_PRESETS["ar_4b"]
    t0 = time.perf_counter()
    model = ar.build_ar_model(preset, "cuda", seed=0)
    tokenizer = ar.build_dv_tokenizer(preset, "cuda", seed=0)
    torch.cuda.synchronize()
    out["ar_build_s"] = time.perf_counter() - t0
    out["params"] = sum(p.numel() for p in model.parameters())
    clip = torch.rand((1, 3, preset.chunk, preset.height, preset.width),
                      generator=torch.Generator(device="cuda").manual_seed(4),
                      device="cuda") * 2 - 1
    runs = {}
    for int8 in (False, True):
        run = generate_timed(model, tokenizer, clip, int8, TOKENS)
        grid = run.pop("grid")
        if not int8:
            bf16_grid = grid
        runs[run["kv_cache"]] = run
        print(json.dumps({"run": run}), flush=True)
    out["generate"] = runs
    prefix = bf16_grid[:, :2].reshape(1, -1)
    out["attention_share"] = {
        route: attention_share(model, prefix, PLAIN_TOKENS, route == "plain")
        for route in ("K8", "plain")}
    print(json.dumps({"attention_share": out["attention_share"]}), flush=True)
    del model, tokenizer, clip
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = dd.make_dd_pipeline(dd.DIFFUSION_DECODER_7B, dd.CV8x8x8,
                               dd.DDSamplingConfig(num_steps=DD_STEPS), 2, "cuda", seed=0)
    randomize_gates(pipe.net, torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    dd_build = time.perf_counter() - t0
    record = {}
    t0 = time.perf_counter()
    video = pipe.refine(bf16_grid, seed=0, record=record)[:, :, :33]
    torch.cuda.synchronize()
    out["decoder"] = {"build_s": dd_build, "steps": DD_STEPS, "step_s": record["step_s"],
                      "s_per_step": _summary(record["step_s"][1:] or record["step_s"]),
                      "decode_s": record["decode_s"], "refine_s": time.perf_counter() - t0,
                      "video": list(video.shape),
                      "finite": bool(torch.isfinite(video).all().item()),
                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    bf16 = runs["bf16"]
    out["total_s"] = bf16["total_s"] + out["decoder"]["refine_s"]
    out["nvidia_smi_after"] = nvidia_smi_line()
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
