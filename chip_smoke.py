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
             with K1 at a full window; K7q/K7 (W8A8) exact codes at both
             activation widths, int32 accumulators and outputs at the four
             7B shapes and a ragged one (K = 1,000: codes copied into
             16-byte rows), TOPS, torch._int_mm and cuBLAS bf16 at the shape
  4 main     GEN3C-7B at full width (28 blocks x 4096, 32 x 128 heads,
             bf16, random weights from seed 0) generating one 121-frame
             704x1280 chunk through run_chunked_generation with MAIN_STEPS
             Euler steps and batched CFG; seconds per phase, peak memory,
             and the launches of each kernel in that run
  5 fast     the same model and chunk with the --perf_preset fast knobs:
             W8A8 (quantized on the card, all 28 blocks), band window 2,
             step-cache interval 2, guidance interval 1.75..81, 8 steps on
             the first FAST_BLOCKS = 7 blocks: the asserted
             CFG/condition-only and refresh/cached step pattern, seconds
             per step by kind, quantize seconds, peak memory, launches
  6 fast_parity  a 1024-channel, 2-block bf16 DiT with W8A8 and band
             window 1 over 5 latent frames, on the card (kernels) and on
             the CPU (plain versions) with the same weights
  7 chain    the tiny preset chaining two chunks (17 frames) on the card:
             update_cache (non-rigid Adam fit), re-render and the kernels
             between chunks; the first chunk is compared with the same
             model run on the CPU through the plain versions
  8 train    train_step at GEN3C-7B width (4096 channels, 32 x 128 heads,
             bf16, TRAIN_BLOCKS_7B = 6 of 28 blocks, gates randomized) on one 121-frame
             704x1280 clip (56,320 tokens, 512 text tokens), B=1, remat,
             TrainerConfig's optimizer defaults, TRAIN_STEPS steps: s per step, loss
             and grad-norm per step, state GiB reckoned and measured, peak
             GiB, and the launches of K1, K2 and K4
  9 lora_band_train  LoRA fine-tuning of GEN3C-7B at full width on
             LORA_BLOCKS = 7 of its 28 blocks (bf16,
             random base from seed 0, gates randomized) with the fast
             preset's band (window 2, prefix 1): the batch from
             build_gen3c_train_batch on a seeded 121-frame 704x1280 RGBD
             clip (7B VAE, K5), then LORA_STEPS lora_train_steps (rank 16 on the
             attention projections, remat): s per step, loss, grad-norm,
             peak GiB, base and adapter GiB reckoned and measured, launches
             per step (K4band 7, K3lse 14, K2 14, K4 7, K1 0), and the base
             bitwise unchanged
 10 train_parity  one train_step of a 1024-channel, 2-block bf16 DiT on the
             card (kernels) and on the CPU (plain versions) with the same
             weights and draws: loss, grad-norm, each grad leaf's error
 11 band_train_parity  the same with band window 1 (K4-band on the card)
 12 train_cli the training CLI (gen3c_tiny, fp32, remat) for 4 steps with
             checkpoints, then resumed to 6, then 2 steps with --data_root on
             a packaged clip and band window 1
 13 dynamic  the gen3c_dynamic CLI's entry point with the same 7B (built once
             for main, dynamic and multiview; here and in multiview its first
             DYNAMIC_BLOCKS = 2 of 28 blocks) on a seeded 121-frame 704x1280
             packaged clip whose depth has nearer discs and a railing (depth
             boundaries), --foreground_masking, DYNAMIC_STEPS Euler steps: render s with
             and without masking, K6 launches (121), the culled fraction,
             s per denoise step, peak GiB
 14 multiview the gen3c_multiview CLI's entry point, same 7B, 4 key frames,
             --frame_buffer_max 2, --foreground_masking, 1 chunk, 1 step: the
             buffers each chunk kept, render s, launches
 15 cp       context- and CFG-parallel denoising: CP_RANKS processes on the
             one card, each a rank (torchrun's environment, gloo: NCCL
             refuses two ranks of a communicator on one GPU) that builds
             the 7B from main_path's seeds through build_gen3c_model and runs
             main_path's chunk through its entry point: Ulysses, ring,
             all-gather, cfg2, then tp 2 (each rank's 16 heads and half of
             every block's linears) and cp1tp2sp (with sequence
             parallelism), each laid out by pipelines.factory.parallelize,
             at CP_SHORT_BLOCKS blocks, held to the
             single process at that depth within CP_NOISE_FACTOR times the
             bf16 noise floor
             measured there (the single process with its CFG pair as two
             B = 1 calls), not below CP_TOL; per rank s per step, the bytes each
             collective moved, peak GiB, the heads a rank ran and launches
             (K1cp, K1ring + K1merge, K1ag; K1 and K2 under tp). Then, the
             7B freed, the same two ranks run pp2 (GPipe: 2 stages over 2
             of the 7B's blocks at full width, B = 2 in 2 microbatches of
             28,160 tokens: the output and dL/dx held to one process, K1,
             K2 and K4 a stage, the p2p bytes), render_cp2 (the 121 target
             renders at 704x1280 split over the ranks, held to one
             process's render_cache; K5 a rank) and ar_tp (the 4B at full
             width on AR_TP_LAYERS of its layers, tp 2: a 5,120-token
             prefill and AR_TP_DECODE teacher-forced decode steps, bf16 and
             int8 cache, and the W8A8 model, logits held to one process
             within CP_NOISE_FACTOR times the noise floor of its row sums
             halved; a row-parallel W8A8 product bit for bit one
             process's; a greedy generate the same on both ranks; K8 on
             16 / 4 heads a rank, ms a token, the collectives' bytes, peak
             GiB). The ranks share the card and their collectives pass
             through host memory: none of these is a multi-card time
 16 moge     MoGe ViT-L (fp32, seeded weights) on a seeded 704x1280 image
             through moge_infer, the single-image path's depth source: s,
             peak GiB, its fp32 attention's launches (K1vit, 24), and the
             same call on the CPU: head output, mask and recovered shift;
             and the shift search alone on a pinhole point map with one
             optimum, card against CPU within one cell of its last grid
 17 t5       the T5 encoder at t5-11b's full width (seeded bf16 weights) on
             2 x 512 ids: s and peak GiB; a 2-layer full-width cut held to
             the CPU (fp32 products, TF32 off); the encoder freed after
 18 checkpoint  a 2-block GEN3C-7B-width net written as model.pt and as
             dit.npz and loaded back through build_gen3c_model, bits equal;
             a prompt encoder without its files raises
 19 serving  the inference server (serving.server.serve on 127.0.0.1, any
             free port, driven over HTTP with urllib) around a
             Gen3cPersistentModel of GEN3C-7B at full width (bf16, seeded,
             gates randomized; its first SERVING_BLOCKS = 1 of 28
             blocks), MAIN_STEPS steps, depth from MoGe ViT-L
             (seeded weights through GEN3C_MOGE_CHECKPOINT; moge_jax raises
             without them): /seed-model on one 704x1280 image (MoGe on the
             card), job A on a 241-frame path (two chunks, a 121-frame
             partial seen on the way, the result fetched as JPEGs and
             decoded), job B cancelled while queued behind A (never runs),
             job C cancelled while its first chunk runs (cancelled after
             exactly one chunk), /render-preview on a 5-frame path,
             /metadata: seconds of each, job A's generate / chain / depth /
             fetch split, the fetch's bytes, peak GiB and the launches of
             K1, K2 (1 x MAIN_STEPS x 3 chunks), K5 and K1vit (24 x 2);
             then job A again from a fresh seed with the DiT called one
             sample at a time: the bf16 noise floor of its frames
 19b serving_cp2  the same server over two ranks on the one card (gloo;
             `--serving-rank r`): Gen3cPersistentModel(num_devices=2,
             parallel="cp", cp_attn="ulysses") of the same 7B, MoGe and
             seeds on each rank; rank 0 serves and is driven over HTTP
             (seed, job A of 241 frames fetched as JPEGs, job C cancelled
             while its first chunk runs), then stops the server, whose
             "stop" returns rank 1 from follow(): rank 0's and rank 1's job
             A frames held to serving's within CP_NOISE_FACTOR times its
             noise floor (not below CP_TOL), job C cancelled after one
             chunk on both ranks; per rank ready s, s a step, the
             collectives' bytes and host seconds, peak GiB and launches
             (K1cp and K2 one a block a step, K5; K1vit on rank 0 only)
 20 span     span caching on main_path's 7B, before it is freed, on its
             first SPAN_BLOCKS = 8 of 28 blocks: the blocks ranked by
             rank_block_contributions at one noise level (one B = 1
             forward), the lowest 4-block span, then SPAN_STEPS = 6 steps of
             interval 2 with the bf16 carry on the 121-frame chunk through
             Gen3CModel.generate_samples: each step's kind and s, the carry's
             bytes, peak GiB, and K1 = K2 = 5 x 8 + (8 - 4) launches after
             the ranking (the skip step ran only the blocks outside the
             span); then the int8 and the
             bf16 carries over SPAN_SHORT_T = 4 latent frames (14,080
             tokens, to hold the time) at the 7B's width, their launches
             and the int8 result against the bf16 one
 21 text2world  the text2world CLI's entry point with the seeded
             cosmos_t2w_7b (16 input channels, gates randomized; its first
             SIBLING_BLOCKS = 4 of 28 blocks): 121
             frames, 704x1280, T2W_STEPS = 3 dpm2m steps, CFG B=2: the
             frames' shape and dtype, finite latents, s per step, launches
 22 interpolator  the world interpolator's entry point with the seeded
             cosmos_v2w_7b (its first SIBLING_BLOCKS of 28 blocks) on two
             seeded 704x1280 ends, INTERP_STEPS = 3
             res2ab steps: the final latent's first and last frames
             against their ends' latents and the decoded first frame
             against the VAE's decode of the first end (INTERP_*_TOL), s
             per step, peak GiB, launches
 23 tokenizer the tokenizer CLI's round trip of a 121-frame 704x1280 clip
             (JPEG frames, a seeded pan) with the seeded CV8x8x8: PSNR,
             encode and decode s, peak GiB
 24 quality  approximation_quality_curve (the tiny fp32 DiT: the fp32
             attention body of attention_f32.cu, W8A8 rows on K7q + K7) on
             the card, its band w2, W8A8 and fast rows held to the same
             rows on the CPU (QUALITY_TOL, QUALITY_CPU_ROWS); s of each,
             launches
 25 mv_world the multiview world model: K1 at the Sample-AV 7B's (2, 76,320,
             32, 128) (76,320 = 6 views x 8 x 30 x 53, not a multiple of 128;
             held to its plain version on MV_HEAD_SLICE heads) and K2 with the
             views folded into the batch, (12, 12,720) over (12, 512); the
             text2world_multiview CLI's entry point with the seeded
             cosmos_t2w_mv_7b (gates and repeat-frame Linear randomized, zero
             T5 for the 6 x 512 context; its first SIBLING_BLOCKS of 28
             blocks, as for cosmos_v2w_mv_7b), MV_T2W_STEPS CFG steps, all 6 views
             decoded to 57 x 480 x 848 uint8, then cosmos_v2w_mv_7b for
             MV_V2W_STEPS step from a seeded 480x848 image (each view's first
             latent frame held to the image's latent): s per step, decode s per
             view, peak GiB, launches by kernel and body (wgmma only); the tiny
             fp32 multiview preset drawn on the CPU, card against CPU
 26 mv_action_train  one train_step of the multiview 7B (cosmos_v2w_mv_7b,
             76,320 tokens, 6 x 512 text tokens, video-extend with the per-view
             indicator) at MV_TRAIN_BLOCKS = 5 blocks (12 would pass the
             card's memory) and of video2world_action_7b (56,320 tokens, a (1,
             1, 7) action) at TRAIN_BLOCKS_7B = 6, per-block remat: s per
             step, loss, grad-norm, peak GiB, K4's launches by forward
 27 ar_world the Cosmos AR world model (ar_4b: the 4B at full width, dim 4096,
             16 layers, 32 query / 8 KV heads of 128, vocab 64,000, seeded bf16
             weights): K8 (GQA attention over the KV cache) held to its plain
             version on a filled seeded cache layer (1, 12,800, 8, 128), decode at
             pos 5,120 and 12,799 in bf16 and int8 (K8_DECODE_TOL, relative;
             two more with the query on the key at pos; each shows that the
             check would see the last key or a key split dropped) and the
             5,120-token prefill in bf16 (wgmma) and int8 (mma.sync; plain on
             K8_PLAIN_GROUP KV-head group, ATTN_TOL); K8's and SDPA's
             (enable_gqa) device time (torch.profiler, the L2 read over
             before each call; a profile that lost a kernel, or a time under
             the bound, fails), the event time of calls back to back (host
             included) and the wrapper's host us a call;
             then generate_world_tokens, the CLI's path: DV8x16x16 encodes a
             seeded 33-frame 640x1024 clip to the (1, 5, 40, 64) grid, 5,120
             prefix tokens prefill, AR_DECODE_TOKENS = 128 decode (top-p 0.8),
             with a bf16 and with an int8 cache: prefill s, s per decode token,
             peak GiB, K8 = 16 x 128 launches each; one decode step traced
             (torch.profiler): its kernels (16 of K8's, one a layer), the
             device's busy share of an untraced step and K8's share; the DV
             decode to 33 frames; and
             ar_tiny (fp32) greedy on the card and on the CPU, tokens equal
 28 dd       the seeded 7B diffusion decoder (48 input channels, bf16, gates
             randomized) on ar_world's grid: K1 and K2 at its (2, 20,480, 32,
             128) shapes held to their plain versions, then refine's one
             reflect-padded 8-latent-frame chunk at 80 x 128 (20,480 tokens),
             DD_STEPS = 2 CFG steps (B = 2), the CV8x8x8 decode to 57 frames,
             trimmed to 33: s per step, decode s, peak GiB, K1 = K2 = 28 x 2
 29 guardrail the guardrails (aux.guardrail) at their published widths with
             seeded weights built on the card and a stand-in tokenizer (bytes
             to ids, one chat template: the card's machine has no
             transformers): K1vit at SigLIP's (16, 729, 16, 72) fp32 shape and
             its pooling probe, K8 at each guard's decode (pos 256 over a
             4,096-row cache) and prefill shapes beside SDPA and the bound;
             the text runner (blocklist + LlamaGuard3: Llama-Guard-3-8B, 32 x
             4096, 32 / 8 heads, llama3 rope scaling) twice on a ~200-byte
             prompt (s, K8 = 32 x 16 launches a run, the same new ids), a
             blocklisted prompt refused with no launch, the first new
             token's logits of a 2-layer cut, card (bf16) against CPU (fp32)
             within GUARD_CUT_TOL; Aegis (LlamaGuard-7b, rep 1, a seeded rank-16
             LoRA merged on the card) the same way with 100 tokens; the video
             runner (SigLIP so400m + the 7-class head biased to "Safe", then
             RetinaFace ResNet-50) on a seeded 121-frame 704x1280 clip: s of
             each, K1vit launches, the head biased to "Violence" refusing at
             frame 0, SigLIP's features of 2 frames and RetinaFace's loc /
             conf on 1 frame against the CPU (VISION_TOL), and a run at
             threshold 0.5 whose boxes and pixelated frame are held to the
             CPU's; Gen3cPipeline (tiny preset) with a
             blocking text runner: generate gives None, the AR loop raises
 30 upsampler the VLM prompt upsampler: Pixtral-12B's vision tower (1024 x
             24, bf16) and its text model's widths (5,120 x 40 layers, 8 KV
             heads, vocab 131,072) at 40 heads of 128 (Pixtral's own 32 x
             128 head width is not dim / heads, which no ARConfig holds):
             K1vit at the tower's (1, 2,240, 16, 64), K8 at rep 5 (decode,
             and the spliced prefill's bucket) beside SDPA and the bound;
             upsample on a 704x1280 frame
             (560x1024, 2,240 patches spliced at [IMG]) and on the text
             alone, UPSAMPLER_NEW_TOKENS = 32 new tokens of the reference's
             400: s, launches (K8 40 x 32, K1vit 24 a frame); 2-layer cuts
             of the text model and of the tower (+ projector), card
             against CPU
 31 tokenizer_train  tokenizer_train_step (AdamW) on the seeded CV8x8x8 at
             the default VAEConfig's full width, a 17-frame 256x256 clip,
             TOK_TRAIN_STEPS = 3 steps with every term (LPIPS VGG16 + gram,
             RAFT-Large at scale 2 with 12 updates, consistency windows 9 /
             8): s per step, peak GiB, each term; 2 steps of the tokenizer
             CLI (--perceptual lpips --w_flow 1 --flow_estimator raft); one
             step's terms and grad norm on a 17x64x64 cut at full width,
             card against CPU (TF32 off, TOK_PARITY_TOL)
 32 ar_train K8bwd (K8's backward) against its plain version at the 4B's
             causal (1, 12,800, 32 / 8, 128), a left-padded batch, the
             cross-attention's non-causal 512 keys (a split dK/dV grid), rep
             1 at d 32 and ar_tiny's fp32, beside SDPA's backward and the
             bound; each bf16 case on the wgmma route, its splits recorded,
             two calls the same bits (K8BWD_CASES); the same at 1, 3 and 4
             queries at rep 4 and at d 36, rep 2 (K8BWD_SHORT_CASES: K8's
             forward with lse and K8bwd on the wgmma bodies, d padded to
             40); and a tp 2 rank's (1, 12,800, 16 / 4, 128) causal bf16
             (K8BWD_TP_CASES, ar_tp_train's shape); each case's forward
             output and lse held to the plain version too; then
             ar_train_step on the
             seeded ar_4b, all 16 layers, over the 12,800-token grid, B = 1,
             AR_TRAIN_STEPS = 3 steps with per-layer remat: s per step, peak
             GiB, loss, grad norm, K8 (32) and K8bwd (16) launches a step;
             then steps traced by torch.profiler: K8bwd's and K8's share of
             a step (ar_train_trace); a 2-layer cut at full width over 256
             tokens, card (bf16) against CPU (fp32) within AR_PARITY_TOL
 33 cp_train data-, context- and tensor-parallel training (after cp): K4
             and K1cp's forward with lse at a Ulysses rank's shard (1,
             56,320, 16, 128) against the plain versions; then CP_RANKS
             processes on the one card (gloo, `--cp-train-rank r`) train the
             7B at full width on CP_TRAIN_BLOCKS = 1 of 28 blocks with
             make_sharded_train_step: cp 2 over one 121-frame clip for 2
             steps, dp 2 over two 8-latent-frame clips for 1, tp 2 over one
             8-latent-frame clip for 2 and with sequence parallelism for 1,
             then dp 2 with FSDP on dp 2's clips for 1 (each rank exactly
             half of the cut leaves' params, moments and EMA, then the
             checkpoint gather within its bound) (the leaves gathered from
             the shards), each held to
             the same net, batch and draws in this one process (loss, grad
             norm, three leaves' updates and first moments within
             CP_TRAIN_TOL): s per step per rank, peak GiB, launches (K1cp /
             K1 and K4 per block), the collectives' bytes and host seconds;
             then ar_tp_train in the same ranks: the 4B at full width on
             AR_TP_TRAIN_LAYERS = 2 of its 16 layers at tp 2 (16 / 4 heads
             a rank) over 12,800 tokens, 2 AdamW steps through
             make_sharded_ar_train_step (the vocab-parallel cross entropy),
             held to the same steps in this one process (loss, grad norm,
             five leaves within CP_TRAIN_TOL): s a step a rank, peak GiB, K8
             (2 a layer) and K8bwd (1 a layer) a step a rank, the loss's
             collective bytes
 34 offline_tools  (after checkpoint) make_random_checkpoint writes a seeded
             2-block GEN3C-7B-width dit.npz, persist_quantized_dit its W8A8
             file (quantized on the card), build_gen3c_model loads it
             pre-quantized and runs one forward at 56,320 tokens (K7q, K7;
             codes equal to the file's, within OFFLINE_W8A8_TOL of bf16);
             with phase 17's get_t5_embeddings run on the seeded T5 (two
             prompts to .t5.npy, read back through training/datasets.py)
Every bf16 attention case of phase 3 also prints its launches by body
(kernels.route_counts: wgmma or mma_sync), its share of its bound, and the
registers, stack and spill bytes (ptxas -v, the build log) and dynamic
shared memory of the attention_wgmma.cu entries it ran; phase 2 lists every
such entry, and every mma_probe.cu entry (P1), and fails if one spills. Every 7B-shape call of the attention
family, and main, train, lora_band_train and cp, must run the wgmma body
only. K4's cases also hold two backward calls to the same bits. At the 7B
self shape the mma.sync bodies, which serve the bf16 inputs no TMA map
describes, are held too: the same values at a base off 16-byte alignment
through K1's forward, the forward with lse, a ring step and the backward,
against the same plain versions, counted apart from K4's routes.
Phase 3 also holds K4 (the attention backward) and its forward with the
row logsumexp at the 7B self- and cross-attention shapes and at a ragged
fp32 tiny shape; K4-band at the 7B self shape with the fast preset's band
(its visited-tile fractions, its forward against K3's bits), at a full
window against K4's bits and at a ragged fp32 shape; K3lse, the band
forward with the row logsumexp, at the LoRA + band shape; P1, the wgmma
rate probe, in bf16 and int8 at the QK^T block shape (held to its plain
version at R 8,000, its SM clock sampled, the library's one product of the
stacked operands beside it), and every instruction form of it on a ragged
shape and timed at that block shape; K5 (the splat) on a smooth flow, uniformly
random targets and NaN / +inf depths (the plain version's NaN pixels), and
forward_warp's depth splat (C = 1) on the smooth and the random flow, its
three kernels timed apart beside the parent's torch passes and its corners
merged across lanes counted; K6 (the ray-triangle depth) on the 901,120
rays of a 704x1280 frame against the boundary mesh of a seeded depth (~19k
triangles) and of a dense one (~112k; held on every 4th image row), the
plain version's bits (its setup kernel's too), the triangles it cannot
cull, the pairs its tiles keep and those the bound counts (a per-ray footprint), its
setup and kernel timed apart; P2, K1's tile sweep, at the 7B self-attention
shape: K1's wgmma forward at K1's own point, with three consumer
warpgroups, with 128 keys a tile (those two built apart in phase 2, their
registers and spills printed) and at K1's point from the (B, H, L, D)
layout, K1's point bit for bit K1's output; the fp32 forward (three TF32
products on the tensor cores) at MoGe ViT-L's shape on views of one qkv
projection (K1vit: held to its 3xTF32 bound, the CUDA cores' fp32 bound
beside it, SDPA fp32; 20 calls back to back a run and one call a run), at D = 24
ragged and with the band; and the context-parallel kernels
at the 7B shard shapes: K1cp (K1, or K3 under the band, on a Ulysses
rank's 32/cp heads read in place from the all-to-all's layout) at cp 2, 4
and 8 against K1's output sliced, K1ag (a 28,160-query shard over the
gathered 56,320 keys), and K1ring + K1merge (every rank's ring over its
KV shards) at cp 2 and 4, with and without the band, against K1 or K3 on
the whole sequence and the plain ring, the folded steps against the
band's visible frame pairs. Every kernel's bound (bytes or operations at
the data-sheet peaks) and the time of one PyTorch call that computes its
function, where there is one, go beside its time. Then the kernel table as
one JSON line, the nvidia-smi line, and as the last line {"ok": true,
"device": {...}}. Any failure raises: the script exits non-zero and prints
no last line. There is no CPU fallback.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import io
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional

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
# K4 against an fp32 truth (the plain backward in fp32 at the same bf16
# inputs): no further from it than the plain bf16 version (which also rounds
# the logits and dO.V^T to bf16) plus a margin, relative to mean |truth|
K4_TOL = {"max_margin": 1e-2, "mean_margin": 1e-3}
K4_F32_TOL = 1e-4  # relative to mean |plain|, fp32 on both sides
TRAIN_BLOCKS_7B = 6  # of 28 (12 before serving_cp2): the train phase's and the action step's depth
# card (kernels) against CPU (plain versions), both bf16, per gradient leaf:
# mean |delta| / mean |cpu| and max |delta| / max |cpu|; loss and grad-norm
# relative (set before the first run, PERF.md)
TRAIN_PARITY_TOL = {"loss": 1e-2, "grad_norm": 2e-2, "leaf_mean": 5e-2, "leaf_max": 0.1}
BF16_PEAK_TFLOPS = 989.0  # H100 SXM dense bf16 (data sheet)
FP32_PEAK_TFLOPS = 67.0  # H100 SXM fp32 outside the tensor cores (data sheet)
TF32_PEAK_TFLOPS = 495.0  # H100 SXM dense TF32 (data sheet): the 3xTF32 fp32 forward
HBM_TB_PER_S = 3.35  # H100 SXM HBM3 (data sheet)
LORA_RANK = 16
LORA_STEPS = 2
LORA_BLOCKS = 7  # of 28 (all 28 before serving_cp2): lora_band_train's depth, at the 7B's width
P1_SHAPE = (1408, 128, 1024)  # the QK^T block shape of scripts/probe_int8_attention.py
P1_REPS = 8000  # that script's R at K = 128
# every P1 form held to its plain version here: ragged M and N, K two chunks
# of the bf16 n256 form, R cut into one-pass slices (odd starts)
P1_FORMS_SHAPE = (200, 256, 130)
P1_FORMS_REPS = 5
# K6 against its plain version (the same operations in the same order, no
# contraction): hit decisions may flip on at most 1e-4 of the rays, and hit
# distances both report agree within 1e-5 relative
K6_TOL = {"flip_fraction": 1e-4, "rel_err": 1e-5}
# per (ray, triangle) pair: 29 fp32 arithmetic operations (cross 9, a 5,
# reciprocal 1, u 6, v 6, t 1, u + v 1) and 7 comparisons (raycast.cu)
K6_OPS_PER_PAIR = 36
# _foreground_depth's dense scene: the boundary covers the whole frame, so
# the mesh holds every quad of the 1/4-resolution grid (111,650 triangles)
K6_DENSE_SCENE = {"discs": 64, "bars": 128, "bar_top": 0.0}
K6_FRAME_W = 1280  # k6_mesh's rays: row-major over a 704 x 1280 frame
# the dense mesh's rays held to the plain version: every 4th image row (its
# all-pairs plain version took 22.7 s over every ray; the seeded scene's
# case holds all 901,120)
K6_DENSE_PLAIN_ROW_STEP = 4
# P2 in the smoke, points (consumer warpgroups, keys a tile, stages) of K1's
# wgmma forward: K1's own, three warpgroups, 128 keys a tile, and K1's point
# read from the (B, H, L, D) layout (the script sweeps them all)
P2_SMOKE_CONFIGS = (((2, 64, 4), "blhd"), ((3, 64, 4), "blhd"), ((2, 128, 3), "blhd"),
                    ((2, 64, 4), "bhld"))
DYNAMIC_STEPS = 1
# of 28: the depth dynamic and multiview run main_path's 7B at (its width is the
# 7B's); their checks are the renders, the masking and the CLIs' outputs, and
# the 2 blocks (4 in PR 22) pay for the cp phase's tensor-parallel runs and,
# with the cp and cp_train cuts, for PR 23's pp2, render_cp2, ar_tp and fsdp2
DYNAMIC_BLOCKS = 2
MULTIVIEW_STEPS = 1
MULTIVIEW_KEY_FRAMES = 4
MAIN_STEPS = 1  # main_path's Euler steps; its latent is the cp phase's reference
TRAIN_STEPS = 1
CP_SIZES = (2, 4, 8)  # K1cp's shard shapes: (2, 56,320, 32 / cp, 128)
RING_CP_SIZES = (2, 4)  # K1ring's: (2, 56,320 / cp, 32, 128), cp = 2 the cp phase's
CP_RANKS = 2  # the cp phase: two ranks on the one card
CP_SHORT_BLOCKS = 1  # of 28 (4 until PR 23): the depth of every cp run and of its reference
# a rank's latent against the single process's, relative to mean
# |reference|: both are bf16 7B forwards, but each rank's linears run on half
# the rows (cuBLAS tiles them otherwise, and bf16 rounds each output), so
# the bound is CP_NOISE_FACTOR times the bf16 noise floor measured in the
# same run (the single process with its CFG pair as two B = 1 calls, the
# same halving with no parallel code; phase_cp_reference), and never below
# CP_TOL. A wrong shard, position or combine moves the latent by O(1)
CP_TOL = {"max": 0.1, "mean": 0.01}
CP_NOISE_FACTOR = 2.0
CP_TIMEOUT_S = 700  # the cp phase's two ranks, together
# the share of the card each rank's caching allocator may hold: each peaks at
# ~31 GiB allocated (the 7B and the VAE's 121-frame activations, as main_path),
# and memory one rank's allocator keeps cached is lost to the other, so
# without a cap the two reserve more than the card has
CP_MEMORY_FRACTION = 0.45
T5_LEN = 512  # the prompt encoder's padded length
T5_PADDED_AFTER = 300  # the second prompt's tokens
T5_CUT_LAYERS = 2
# the 2-layer t5-11b cut, card against CPU, both fp32 products (TF32 off):
# |delta| relative to mean |cpu|; other summation orders only
T5_CUT_TOL = {"max": 1e-2, "mean": 1e-4}
# MoGe ViT-L's head output, card against CPU, fp32 (cuDNN TF32 off in its
# convolutions), relative to mean |cpu|
MOGE_TOL = {"max": 1e-2, "mean": 1e-4}
MOGE_FIT_TOL = 1e-2  # the recovered focal and shift, card against CPU, relative
# the shift search's last grid step (recover_focal_shift: 64 candidates over
# 9.99, refined twice by 2 / 63): on a pinhole point map with one optimum the
# card and the CPU pick the same cell or its neighbour
MOGE_SHIFT_CELL = 9.99 / 63 * (2 / 63) ** 2
CKPT_BLOCKS = 2  # the checkpoint round trip's depth at 7B width


_T_START = time.perf_counter()


def emit(phase: str, **numbers) -> None:
    """One JSON line; "at_s": the process's seconds so far (the phases'
    times are the differences)."""
    print(json.dumps({"phase": phase, "at_s": round(time.perf_counter() - _T_START, 3),
                      **numbers}), flush=True)


def bound(nbytes: float, ops: float, peak_tops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the peak rate of their type."""
    t_bytes = nbytes / (HBM_TB_PER_S * 1e12) * 1e3
    t_ops = ops / (peak_tops * 1e12) * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes > t_ops else "operations"}


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def library_ms(fn, reps: int = 3, calls: int = 1):
    """cuda_ms of one PyTorch call that computes a kernel's function (its
    yardstick; the port never calls it), or None where the card cannot
    hold it."""
    try:
        return cuda_ms(fn, reps=reps, calls=calls)
    except torch.OutOfMemoryError:
        torch.cuda.empty_cache()
        return None


def _sdpa(q, k, v, mask=None):
    """F.scaled_dot_product_attention in the kernels' (B, L, H, D) layout."""
    import torch.nn.functional as F

    out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                         attn_mask=mask)
    return out.transpose(1, 2)


def _band_mask(L: int, band) -> torch.Tensor:
    """The dense (L, L) boolean band mask, built from its (T, T) frame mask
    (no (L, L) temporaries beside it)."""
    hw, window, prefix = band
    f = torch.arange(L, device="cuda") // hw
    t = torch.arange(int(f[-1]) + 1, device="cuda")
    frames = ((t[:, None] - t[None, :]).abs() <= window) | (t[None, :] < prefix)
    return frames[f][:, f]


# the helpers scripts/card.py shares, imported at call time: the
# compare_*_builds scripts load this file beside another tree's package
def nvidia_smi_line() -> str:
    from gen3c_tpu_torch.scripts.card import nvidia_smi_line as smi

    return smi()


def randomize_gates(net, gen) -> None:
    from gen3c_tpu_torch.scripts.card import randomize_gates as gates

    gates(net, gen)


def device_ms(fn, calls: int = 20):
    from gen3c_tpu_torch.scripts.card import device_ms as dev

    return dev(fn, calls)


def host_us(fn, calls: int = 20) -> float:
    from gen3c_tpu_torch.scripts.card import host_us as host

    return host(fn, calls)


def cuda_times(fn, reps: int = 3, warmup: int = 1, calls: int = 1) -> list:
    """Milliseconds a call of fn() takes on the current stream (CUDA events)
    in each of reps runs of `calls` calls back to back, after warmup calls.
    Many calls a run keep the host's time between calls out of a short
    kernel's time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return times


def cuda_ms(fn, reps: int = 3, warmup: int = 1, calls: int = 1) -> float:
    """Median milliseconds of fn() on the current stream (CUDA events)."""
    return float(np.median(cuda_times(fn, reps, warmup, calls)))


def timed_call(fn):
    """(fn()'s value, its milliseconds on the current stream by CUDA
    events): a plain version's one timed run, taken on the call whose value
    its check reads instead of on a call of its own."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _ptxas() -> dict:
    """{kernel entry: (registers, stack, spill-store, spill-load bytes)} from
    ptxas -v in the kernel build's log."""
    from gen3c_tpu_torch.kernels import build
    from gen3c_tpu_torch.scripts.compare_attention_builds import _ptxas_counts

    return _ptxas_counts(build.build()["log"])


def wgmma_entries(kind: str, d: int, band: bool, lse: bool = False, gqa: bool = False,
                  splits: int = 1) -> dict:
    """The attention_wgmma.cu entries one call launches ("fwd": the forward,
    "bwd": Delta, dK/dV, with gqa and splits > 1 the split's reduction, and
    dQ) at head dim d: registers, stack and spill bytes from the build log,
    and the dynamic shared memory they ask for. gqa: K8's mode (kGqa)."""
    from gen3c_tpu_torch.kernels import cuda

    dp = 64 if d <= 64 else 128
    smem = cuda.wgmma_smem_bytes(d)
    b, g = f"Lb{int(band)}E", f"Lb{int(gqa)}E"
    if kind == "fwd":
        want = {f"attn_fwd_wgmma<{dp},{int(band)},{int(lse)},{int(gqa)}>":
                (f"attn_fwd_wgmmaILi{dp}E{b}Lb{int(lse)}E{g}E", smem["fwd"])}
    else:
        want = {f"attn_bwd_dkdv_wgmma<{dp},{int(band)},{int(gqa)}>":
                (f"attn_bwd_dkdv_wgmmaILi{dp}E{b}{g}E", smem["dkdv"]),
                f"attn_bwd_dq_wgmma<{dp},{int(band)},{int(gqa)}>":
                (f"attn_bwd_dq_wgmmaILi{dp}E{b}{g}E", smem["dq"]),
                "attn_bwd_delta_wgmma": ("attn_bwd_delta_wgmma", 0)}
        if gqa and splits > 1:
            want["gqa_bwd_reduce"] = ("gqa_bwd_reduce", 0)
    counts = _ptxas()
    out = {}
    for name, (pattern, dynamic) in want.items():
        regs, stack, spill_st, spill_ld = next(v for k, v in counts.items() if pattern in k)
        out[name] = {"registers": regs, "stack": stack, "spill_stores": spill_st,
                     "spill_loads": spill_ld, "smem_dynamic": dynamic}
    return out


def f32_entries(d: int, q, k, v) -> dict:
    """The attention_f32.cu entry an fp32 forward at head dim d launches
    (16-byte copies or 4-byte ones, as kernels.cuda picks for q, k, v):
    registers, stack and spill bytes, and its dynamic shared memory."""
    from gen3c_tpu_torch.kernels import cuda

    dp = 32 if d <= 32 else 64 if d <= 64 else 128
    vec = cuda.rows_of_16_bytes(q, k, v)
    pattern = f"attn_fwd_tf32x3ILi{dp}ELb{int(vec)}E"
    regs, stack, spill_st, spill_ld = next(c for n, c in _ptxas().items() if pattern in n)
    return {f"attn_fwd_tf32x3<{dp},{int(vec)}>": {
        "registers": regs, "stack": stack, "spill_stores": spill_st, "spill_loads": spill_ld,
        "smem_dynamic": cuda.f32_smem_bytes(d)}}


def route_delta(before: dict) -> dict:
    """The bf16 attention family's launches per body since ``before``."""
    from gen3c_tpu_torch import kernels

    return {k: kernels.route_counts[k] - before[k] for k in before}


def require_wgmma(name: str, routes: dict) -> None:
    """Every launch of the family went to the wgmma body, and one did."""
    if routes["mma_sync"] or not routes["wgmma"]:
        raise AssertionError(f"{name}: attention launches by body {routes}, expected wgmma only")


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
    """The kernel library and, at the same time, the forwards of P2's other
    points (each its own nvcc: attention_wgmma.cu's forward alone)."""
    from concurrent.futures import ThreadPoolExecutor

    from gen3c_tpu_torch.kernels import build, cuda

    variants = sorted({cuda.fwd_point_defines(p) for p, _ in P2_SMOKE_CONFIGS} - {()})
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1 + len(variants)) as pool:
        lib = pool.submit(build.build)
        fwd = [pool.submit(build.build, **build.forward_only(d)) for d in variants]
        info, fwd = lib.result(), [f.result() for f in fwd]
    seconds = time.perf_counter() - t0
    cuda.library()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "kernel_build.log"), "w") as f:
        f.write(info["log"])
    counts = _ptxas()
    wgmma = {k: v for k, v in counts.items() if "_wgmma" in k}
    p1 = {k: v for k, v in counts.items() if "mma_probe" in k}

    def entries(found):
        return {k: {"registers": v[0], "stack": v[1], "spill_stores": v[2], "spill_loads": v[3]}
                for k, v in found.items()}

    emit("build", seconds=round(seconds, 3), library_seconds=round(info["seconds"], 3),
         cached=info["cached"], library=info["path"], wgmma_entries=entries(wgmma),
         f32_entries=entries({k: v for k, v in counts.items() if "attn_fwd_tf32x3" in k}),
         p1_entries=entries(p1), p2_forward_seconds=[round(f["seconds"], 3) for f in fwd])
    spilled = [k for k, v in wgmma.items() if v[2] or v[3]]
    if len(wgmma) < 17 or spilled:
        raise AssertionError(f"attention_wgmma.cu: {len(wgmma)} entries, spilling: {spilled}")
    spilled = [k for k, v in p1.items() if v[2] or v[3]]
    if len(p1) != 8 or spilled:  # six forms and two sums
        raise AssertionError(f"mma_probe.cu: {len(p1)} entries, spilling: {spilled}")


def _attention_case(name, shape_q, shape_kv, dtype, tol, gen, time_it=True, band=None,
                    packed=False):
    """kernels.attention against its plain version (and, timed, SDPA) on
    seeded inputs; packed: q, k, v as views of one (B, L, 3 H D) projection,
    as MoGe's are. An fp32 case's bound is its three TF32 products at the
    TF32 peak, with the CUDA cores' fp32 bound beside it; a case timed 20
    calls back to back a run is also timed one call a run.
    """
    from gen3c_tpu_torch import kernels

    if packed:
        B, L, H, D = shape_q
        qkv = torch.randn((B, L, 3 * H * D), generator=gen, device="cuda").to(dtype)
        q, k, v = (t.reshape(shape_q) for t in qkv.chunk(3, dim=-1))
    else:
        q = torch.randn(shape_q, generator=gen, device="cuda").to(dtype)
        k = torch.randn(shape_kv, generator=gen, device="cuda").to(dtype)
        v = torch.randn(shape_kv, generator=gen, device="cuda").to(dtype)
    before = dict(kernels.route_counts)
    out = kernels.attention(q, k, v, band=band)
    ref, ref_ms = timed_call(lambda: kernels.attention_reference(q, k, v, band))
    err = (out.float() - ref.float()).abs()
    res = {"name": name, "q": list(shape_q), "kv": list(shape_kv), "dtype": str(dtype),
           "band": list(band) if band else None, "strides": list(q.stride()),
           "max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
           "finite": bool(torch.isfinite(out).all().item())}
    del out, ref, err
    if time_it:
        B, Lq, H, D = shape_q
        flop = 4.0 * B * H * Lq * shape_kv[1] * D
        calls = 1 if flop > 1e11 else 20  # a sub-millisecond call: 20 back to back a run
        ms = cuda_ms(lambda: kernels.attention(q, k, v), reps=3, calls=calls)
        plain_ms = ref_ms if calls == 1 and band is None else cuda_ms(
            lambda: kernels.attention_reference(q, k, v), reps=1, warmup=int(calls > 1),
            calls=calls)
        nbytes = tensor_bytes(q, k, v, q)
        # bf16: the tensor cores' bf16 rate; fp32: attention_f32.cu's three
        # TF32 products at the TF32 rate (the CUDA cores' fp32 bound beside it)
        res.update(ms=ms, plain_ms=plain_ms, tflops=flop / ms / 1e9, calls_per_run=calls,
                   plain_tflops=flop / plain_ms / 1e9,
                   library_ms=library_ms(lambda: _sdpa(q, k, v), calls=calls),
                   **(bound(nbytes, flop, BF16_PEAK_TFLOPS) if dtype == torch.bfloat16
                      else bound(nbytes, 3 * flop, TF32_PEAK_TFLOPS)))
        res["bound_share"] = res["bound_ms"] / ms
        if calls > 1:  # and one call a run, as the larger shapes are timed
            res.update(ms_one_call=cuda_ms(lambda: kernels.attention(q, k, v), reps=3),
                       library_ms_one_call=library_ms(lambda: _sdpa(q, k, v)))
        if dtype == torch.float32:
            res["fp32_cuda_core_bound_ms"] = bound(nbytes, flop, FP32_PEAK_TFLOPS)["bound_ms"]
            res["beats_library"] = res["library_ms"] is not None and ms < res["library_ms"]
    res["routes"] = route_delta(before)
    if dtype == torch.bfloat16:
        res["entries"] = wgmma_entries("fwd", shape_q[3], band=False)
    else:
        res["entries"] = f32_entries(shape_q[3], q, k, v)
    emit("kernel", **res)
    if dtype == torch.bfloat16:
        require_wgmma(name, res["routes"])
    if not res["finite"] or res["max_abs_err"] > tol["max"] or res["mean_abs_err"] > tol["mean"]:
        raise AssertionError(f"{name}: kernel disagrees with its plain version: {res}")
    return res


def _rel_err(a, ref):
    """(max, mean) |a - ref| relative to mean |ref|."""
    d = (a.float() - ref.float()).abs()
    m = ref.float().abs().mean()
    return (d.max() / m).item(), (d.mean() / m).item()


def _library_backward_ms(q, k, v, do, mask=None):
    """The backward of F.scaled_dot_product_attention (with the dense band
    mask, if given) on the same inputs: one torch.autograd.grad call after
    one forward, or None where the card cannot hold it."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    try:
        out = _sdpa(*leaves, mask)
        ms = library_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True))
    except torch.OutOfMemoryError:
        ms = None
    del leaves
    torch.cuda.empty_cache()
    return ms


def _off_alignment(t: torch.Tensor) -> torch.Tensor:
    """t's values at a base 2 bytes past a 16-byte boundary, which no TMA
    tensor map describes."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def _mma_sync_check(q, k, v, do, band, ref, ref_lse, plain, truth) -> dict:
    """The mma.sync bodies (attention.cu, attention_bwd.cu), which serve
    every bf16 input no TMA map describes, at the shape of q, k, v: the same
    values at a base off 16-byte alignment through K1's forward, the forward
    with lse, a ring step at offsets 0 and the backward, against the plain
    versions the wgmma body was held to (ATTN_TOL; K4_TOL's margins)."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.kernels import cuda

    qm, km, vm, dom = (_off_alignment(t) for t in (q, k, v, do))
    before = dict(kernels.route_counts)
    outs = {"attention": (cuda.attention(qm, km, vm, band), None),
            "fwd_lse": cuda.attention_fwd_lse(qm, km, vm, band),
            "ring_fold": cuda.attention_ring_fold(qm, km, vm, band, 0, 0)}
    res = {"forward_err": {}}
    for entry, (out, lse) in outs.items():
        err = (out.float() - ref.float()).abs()
        res["forward_err"][entry] = {"max": err.max().item(), "mean": err.mean().item(),
                                     "lse_max": None if lse is None else
                                     (lse - ref_lse).abs().max().item()}
        del err
    out, lse = outs["fwd_lse"]
    got = cuda.attention_bwd(qm, km, vm, out, dom, lse, band)
    torch.cuda.synchronize()
    res["routes"] = route_delta(before)
    ok = res["routes"] == {"wgmma": 0, "mma_sync": 4} and all(
        e["max"] <= ATTN_TOL["max"] and e["mean"] <= ATTN_TOL["mean"]
        for e in res["forward_err"].values())
    for n, g, p, t in zip("qkv", got, plain, truth):
        kmax, kmean = _rel_err(g, t)
        pmax, pmean = _rel_err(p, t)
        res[f"d{n}_vs_fp32"] = {"kernel_max": kmax, "kernel_mean": kmean}
        ok = ok and kmax <= pmax + K4_TOL["max_margin"] and kmean <= pmean + K4_TOL["mean_margin"]
    res["ok"] = ok
    return res


def _k4_case(name, shape_q, shape_kv, dtype, gen, time_it=True, band=None, mma_sync_too=False):
    """K4 (K4-band with a band) and its forward with lse against the plain
    versions; a bf16 band call also counts the tiles it visits. With
    mma_sync_too, also the mma.sync bodies on the same values
    (``_mma_sync_check``), apart in the route counts."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.kernels import cuda

    q = torch.randn(shape_q, generator=gen, device="cuda").to(dtype)
    k = torch.randn(shape_kv, generator=gen, device="cuda").to(dtype)
    v = torch.randn(shape_kv, generator=gen, device="cuda").to(dtype)
    do = torch.randn(shape_q, generator=gen, device="cuda").to(dtype)
    B, Lq, H, D = shape_q
    Lk = shape_kv[1]
    vis_f = torch.zeros(1, dtype=torch.int64, device="cuda")
    vis_b = torch.zeros(2, dtype=torch.int64, device="cuda")
    before = dict(kernels.route_counts)
    out, lse = cuda.attention_fwd_lse(q, k, v, band, visited=vis_f)
    forward = "k3" if band is not None else "k1"  # the serving forward it must equal
    res = {"name": name, "q": list(shape_q), "kv": list(shape_kv), "dtype": str(dtype),
           "band": list(band) if band else None,
           f"fwd_equals_{forward}": bool(torch.equal(out, cuda.attention(q, k, v, band)))}
    ref_out, ref_lse = kernels.attention_forward_reference(q, k, v, band)
    res["lse_max_abs_err"] = (lse - ref_lse).abs().max().item()
    got = cuda.attention_bwd(q, k, v, out, do, lse, band, visited=vis_b)
    res["equal_bits_twice"] = all(bool(torch.equal(a, b)) for a, b in
                                  zip(got, cuda.attention_bwd(q, k, v, out, do, lse, band)))
    plain, plain_ms = timed_call(
        lambda: kernels.attention_backward_reference(q, k, v, out, do, lse, band))
    res["finite"] = bool(all(torch.isfinite(g).all().item() for g in got))
    res["max_abs_err"] = max((g.float() - p.float()).abs().max().item() for g, p in zip(got, plain))
    ok = res["finite"] and res[f"fwd_equals_{forward}"] and res["equal_bits_twice"]
    pairs = Lq * Lk  # visible (query, key) pairs
    if band is not None:
        T = -(-Lq // band[0])
        pairs = _band_pairs(T, *band[1:]) * band[0] ** 2
        if dtype == torch.bfloat16:  # the units of both bodies: 64-key, 64- and 32-query tiles
            tiles64, tiles32 = -(-Lk // 64), -(-Lq // 32)
            res["visited_fraction"] = {
                "forward": vis_f.item() / (B * H * tiles64 * -(-Lq // 64)),
                "dkdv": vis_b[0].item() / (B * H * tiles64 * tiles32),
                "dq": vis_b[1].item() / (B * H * tiles64 * -(-Lq // 64)),
                "frame_pairs": pairs / (Lq * Lk)}
    if dtype == torch.float32:
        for n, g, p in zip("qkv", got, plain):
            res[f"d{n}_rel_max"], res[f"d{n}_rel_mean"] = _rel_err(g, p)
            ok = ok and res[f"d{n}_rel_max"] <= K4_F32_TOL
    else:
        q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
        o32, l32 = kernels.attention_forward_reference(q32, k32, v32, band)
        truth = kernels.attention_backward_reference(q32, k32, v32, o32, do32, l32, band)
        del q32, k32, v32, do32, o32, l32
        for n, g, p, t in zip("qkv", got, plain, truth):
            res[f"d{n}_rel_max"], res[f"d{n}_rel_mean"] = _rel_err(g, p)
            kmax, kmean = _rel_err(g, t)
            pmax, pmean = _rel_err(p, t)
            res[f"d{n}_vs_fp32"] = {"kernel_max": kmax, "kernel_mean": kmean,
                                   "plain_max": pmax, "plain_mean": pmean}
            ok = ok and kmax <= pmax + K4_TOL["max_margin"] and kmean <= pmean + K4_TOL["mean_margin"]
        if mma_sync_too:
            res["mma_sync_route"] = _mma_sync_check(q, k, v, do, band, ref_out, ref_lse, plain,
                                                    truth)
            ok = ok and res["mma_sync_route"]["ok"]
        del truth
    del got, plain, ref_out, ref_lse
    if time_it:
        res["ms"] = cuda_ms(lambda: cuda.attention_bwd(q, k, v, out, do, lse, band), reps=3)
        res["plain_ms"] = plain_ms
        res["fwd_lse_ms"] = cuda_ms(lambda: cuda.attention_fwd_lse(q, k, v, band), reps=3)
        flop = 10.0 * B * H * pairs * D  # the visible work only
        res.update(tflops=flop / res["ms"] / 1e9, plain_tflops=flop / res["plain_ms"] / 1e9,
                   bf16_peak_share=flop / res["ms"] / 1e9 / BF16_PEAK_TFLOPS,
                   **bound(tensor_bytes(q, k, v, out, do, lse, q, k, v), flop, BF16_PEAK_TFLOPS))
        # this design recomputes S in both kernels: 14 L^2 D flop against the 10 counted
        res["deterministic_floor_ms"] = res["bound_ms"] * 14 / 10
        res["bound_share"] = res["bound_ms"] / res["ms"]
        res["fwd_lse_tflops"] = flop * 4 / 10 / res["fwd_lse_ms"] / 1e9
        del out, lse
        torch.cuda.empty_cache()
        res["library_ms"] = _library_backward_ms(
            q, k, v, do, None if band is None else _band_mask(Lq, band))
    res["routes"] = route_delta(before)
    if "mma_sync_route" in res:  # the check's launches, apart
        res["routes"] = {key: n - res["mma_sync_route"]["routes"][key]
                         for key, n in res["routes"].items()}
    if dtype == torch.bfloat16:
        res["entries"] = {**wgmma_entries("fwd", D, band is not None, lse=True),
                          **wgmma_entries("bwd", D, band is not None)}
    emit("kernel", **res)
    if not ok:
        raise AssertionError(f"{name}: the backward disagrees with its plain version: {res}")
    if dtype == torch.bfloat16:
        require_wgmma(name, res["routes"])
    if band is not None and dtype == torch.bfloat16:
        frac = res["visited_fraction"]
        if abs(frac["dkdv"] - frac["frame_pairs"]) > 0.01 or vis_b[1].item() != vis_f.item():
            raise AssertionError(f"{name} did not skip the masked tiles: {res}")
    return res


def _k4_full_window_case(gen) -> dict:
    """K4-band at a window over every frame of the 7B self shape: K4's tiles
    in K4's order, so the forward with lse and the backward give K4's bits."""
    from gen3c_tpu_torch.kernels import cuda

    q, k, v, do = (torch.randn((1, LATENT_T_7B * BAND_7B[0], 32, 128), generator=gen,
                               device="cuda").to(torch.bfloat16) for _ in range(4))
    full_band = (BAND_7B[0], LATENT_T_7B - 1, 1)
    out, lse = cuda.attention_fwd_lse(q, k, v)
    out_b, lse_b = cuda.attention_fwd_lse(q, k, v, full_band)
    res = {"name": "K4-band at a full window against K4", "band": list(full_band),
           "forward_equal": bool(torch.equal(out, out_b) and torch.equal(lse, lse_b))}
    del out_b, lse_b
    want = cuda.attention_bwd(q, k, v, out, do, lse)
    got = cuda.attention_bwd(q, k, v, out, do, lse, full_band)
    res["backward_equal"] = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
    emit("kernel", **res)
    if not (res["forward_equal"] and res["backward_equal"]):
        raise AssertionError(f"K4-band at a full window differs from K4: {res}")
    return res


def _mma_probe_case(gen, dtype: str) -> dict:
    """P1 at the attention QK^T block shape, as the probe script runs it: its
    headline form checked at R = 3, timed at R = P1_REPS and held to its
    plain version there (int8 bit for bit, bf16 within the bound), run back
    to back for a second beside nvidia-smi's SM clock, and the library
    yardstick: one product of the stacked operands, freed after."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.scripts import probe_int8_attention as probe

    M, K, N = P1_SHAPE
    kernels.reset_launch_counts()
    r = probe.measure(M, K, N, dtype, P1_REPS, gen, plain=True, library=True, sustain=True)
    r["launches"] = kernels.launch_counts["P1"]  # the probe's own run: checks and timings
    r["name"] = f"P1 wgmma rate probe ({dtype})"
    r["sm_clock_mhz"] = r["sustained"]["sm_clock_mhz"]
    elem = 1 if dtype == "int8" else 2
    r.update(**bound((M * K + K * N) * elem + M * N * 4, 2.0 * M * K * N * P1_REPS,
                     INT8_PEAK_TOPS if dtype == "int8" else BF16_PEAK_TFLOPS))
    r["bound_share"] = r["bound_ms"] / r["ms"]
    emit("kernel", **r)
    return r


def _mma_probe_forms_case(gen) -> dict:
    """Every instruction form of P1 against its plain version on a ragged
    shape at a small R whose slices start at odd passes (int8 bit for bit,
    bf16 within the bound), then each timed at the QK^T block shape."""
    from gen3c_tpu_torch.kernels import cuda
    from gen3c_tpu_torch.scripts import probe_int8_attention as probe

    M, K, N = P1_FORMS_SHAPE
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = {"name": "P1 instruction forms", "shape": list(P1_FORMS_SHAPE), "reps": P1_FORMS_REPS,
           "forms": []}
    for dtype, forms in cuda.MMA_PROBE_FORMS.items():
        for form in forms:
            plan = cuda.mma_probe_plan(M, N, K, P1_FORMS_REPS, dtype, form, sms)
            starts = [plan.unit(u)["r0"] for u in range(plan.grid)]
            if not any(r0 % 2 for r0 in starts):
                raise AssertionError(f"P1 {dtype} {form}: no R slice starts at an odd pass")
            a, b = probe.operands(M, K, N, dtype, gen)
            err = probe.check(a, b, P1_FORMS_REPS, form)
            qk = probe.measure(*P1_SHAPE, dtype, P1_REPS, gen, form=form, timings=3)
            res["forms"].append({"dtype": dtype, "form": form, "ragged_max_abs_err": err,
                                 "ragged_units": plan.grid, "qk_ms": qk["ms"],
                                 "qk_rate": qk["rate"], "qk_peak_share": qk["peak_share"]})
    emit("kernel", **res)
    return res


def splat_inputs(gen, random_flow: bool = False, nonfinite: bool = False):
    """K5's inputs at the render's shape: two 704x1280 buffers warped into a
    shifted camera, (frame (2, 3, h, w), mask, target depth (2, 1, h, w),
    flow (2, 2, h, w)), fp32 on the card. ``random_flow`` sends every pixel
    to a uniformly random target (neighbouring pixels land apart: no corner
    merges);
    ``nonfinite`` puts a NaN depth in buffer 0 and a +inf depth in buffer 1
    (each then its own splat group)."""
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
    if random_flow:
        grid = geometry.create_grid(h, w, device="cuda")[None]
        scale = torch.tensor([w, h], dtype=torch.float32, device="cuda")[None, :, None, None]
        flow = torch.rand((b, 2, h, w), generator=gen, device="cuda") * scale - grid
    tdepth = proj[..., 2][:, None].contiguous()
    if nonfinite:
        tdepth[0, 0, 100, 200] = float("nan")
        tdepth[1, 0, 300, 600] = float("inf")
    return frame.contiguous(), mask, tdepth, flow.contiguous()


def _splat_agreement(out, m, ref, m_ref) -> dict:
    """K5 against its plain version: the same NaN pixels, the share of equal
    mask pixels, and the largest error on finite pixels both call known."""
    both = ((m > 0) & (m_ref > 0)).expand_as(out) & torch.isfinite(out) & torch.isfinite(ref)
    return {"max_abs_err": torch.where(both, (out - ref).abs(), 0.0).max().item(),
            "mask_agree": (m == m_ref).float().mean().item(),
            "nan_equal": bool(torch.equal(torch.isnan(out), torch.isnan(ref))),
            "nan_pixels": int(torch.isnan(ref).sum())}


def _splat_case(gen) -> dict:
    """K5 at the render's shape (2 x 3 x 704x1280): two buffers warped into
    a shifted camera (a smooth flow; timed, its three kernels apart, the
    parent's torch passes beside them), then uniformly random targets
    (nothing merges) and NaN / +inf depths (each buffer its own group), and
    the depth splat of forward_warp(render_depth=True) (C = 1: its own
    accumulate body) on the smooth and the random flow, each held to the
    plain version."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.kernels import cuda, reference

    frame, mask, tdepth, flow = splat_inputs(gen)
    b, c, h, w = frame.shape
    out, m = kernels.splat(frame, mask, tdepth, flow, None, True)
    ref, m_ref = kernels.splat_reference(frame, mask, tdepth, flow, None, True)
    torch.cuda.synchronize()
    res = {"name": "K5 splat", "shape": [b, c, h, w], **_splat_agreement(out, m, ref, m_ref),
           "known_fraction": m.mean().item()}
    # a sub-millisecond kernel: every run is kept, to show the spread
    res["ms_runs"] = cuda_times(lambda: kernels.splat(frame, mask, tdepth, flow, None, True), reps=5)
    res["ms"] = float(np.median(res["ms_runs"]))
    res["plain_ms"] = cuda_ms(lambda: kernels.splat_reference(frame, mask, tdepth, flow, None, True),
                              reps=3)
    parts = []
    for _ in range(5):
        cuda.splat(frame, mask, tdepth, flow, None, True, part_ms=parts)
    res["parts_ms"] = {key: float(np.median(parts[i::3]))
                       for i, key in enumerate(("prepare", "accumulate", "finish"))}
    acc = torch.zeros((b, (h + 2) * (w + 2), c + 1), device="cuda")
    # the parent's passes around its accumulate kernel, on the same inputs
    res["parent_torch_parts_ms"] = {
        "max_logd": cuda_ms(lambda: reference.splat_max_logd(tdepth), reps=5),
        "zero_fill": cuda_ms(lambda: torch.zeros_like(acc), reps=5),
        "normalize": cuda_ms(lambda: reference.splat_normalize(acc, c, h, w, True), reps=5)}
    counts = torch.zeros(2, dtype=torch.int32, device="cuda")
    cuda.splat(frame, mask, tdepth, flow, None, True, counts=counts)
    res["corner_atomics"], res["corners_merged"] = counts.tolist()
    # each source pixel adds its c values and weight into 4 targets
    res.update(library_ms=None, **bound(tensor_bytes(frame, mask, tdepth, flow, out, m),
                                        8.0 * (c + 1) * b * h * w, FP32_PEAK_TFLOPS))
    del acc, ref, m_ref
    cases = {}
    gen_cases = torch.Generator(device="cuda").manual_seed(9)  # leaves gen as it was
    for name, kw, group, depth_splat in (("random_flow", {"random_flow": True}, None, False),
                                         ("nonfinite", {"nonfinite": True}, 1, False),
                                         ("depth_smooth", {}, None, True),
                                         ("depth_random", {"random_flow": True}, None, True)):
        fr, mk, dp, fl = splat_inputs(gen_cases, **kw)
        if depth_splat:  # the warped depth, as forward_warp splats it
            fr, is_image = dp, False
        else:
            is_image = True
        o, mo = kernels.splat(fr, mk, dp, fl, None, is_image, group=group)
        r, mr = kernels.splat_reference(fr, mk, dp, fl, None, is_image, group=group)
        counts.zero_()
        cuda.splat(fr, mk, dp, fl, None, is_image, group=group, counts=counts)
        cases[name] = {**_splat_agreement(o, mo, r, mr), "shape": list(fr.shape),
                       "corners_merged": counts.tolist()[1],
                       "ms": cuda_ms(lambda: kernels.splat(fr, mk, dp, fl, None, is_image,
                                                           group=group), reps=5)}
        del fr, mk, dp, fl, o, mo, r, mr
    res["cases"] = cases
    emit("kernel", **res)
    for case in [res, *cases.values()]:
        if (case["max_abs_err"] > SPLAT_TOL or case["mask_agree"] < SPLAT_MASK_AGREE
                or not case["nan_equal"]):
            raise AssertionError(f"K5: kernel disagrees with its plain version: {res}")
    if (cases["nonfinite"]["nan_pixels"] == 0 or res["corners_merged"] == 0
            or cases["depth_smooth"]["corners_merged"] == 0):
        raise AssertionError(f"K5: no NaN pixel or no merged corner: {res}")
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
    before = dict(kernels.route_counts)
    out = kernels.attention(q, k, v, band=BAND_7B)
    ref, plain_ms = timed_call(lambda: kernels.attention_reference(q, k, v, BAND_7B))
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
    res["plain_ms"] = plain_ms
    flop = 4.0 * B * H * D * pairs * BAND_7B[0] ** 2  # the unmasked work only
    res.update(tflops=flop / res["ms"] / 1e9, plain_tflops=flop / res["plain_ms"] / 1e9,
               **bound(tensor_bytes(q, k, v, q), flop, BF16_PEAK_TFLOPS))
    mask = _band_mask(L, BAND_7B)  # SDPA with the dense mask: it computes every tile
    res["library_ms"] = library_ms(lambda: _sdpa(q, k, v, mask))
    del mask
    torch.cuda.empty_cache()
    res.update(bound_share=res["bound_ms"] / res["ms"], routes=route_delta(before),
               entries=wgmma_entries("fwd", D, band=True))
    emit("kernel", **res)
    require_wgmma(res["name"], res["routes"])
    if (not res["finite"] or res["max_abs_err"] > ATTN_TOL["max"]
            or res["mean_abs_err"] > ATTN_TOL["mean"] or not res["full_window_equals_k1"]):
        raise AssertionError(f"K3: kernel disagrees with its plain version or K1: {res}")
    if res["visited_tiles"] != B * H * tiles * tiles * pairs // LATENT_T_7B ** 2:
        raise AssertionError(f"K3 did not skip the masked tiles: {res}")
    return res


def _quant_case(gen, k: int) -> dict:
    """K7q on a 7B activation shape: the tokens of the 2B CFG batch x 4096
    (q/k/v, fc1) or x 16384 (fc2's input)."""
    from gen3c_tpu_torch import kernels

    x = torch.randn((2 * 56320, k), generator=gen, device="cuda").to(torch.bfloat16)
    x[0] = 0  # a zero token
    codes, scale = kernels.quantize_rows(x)
    want_codes, want_scale = kernels.quantize_rows_reference(x)
    torch.cuda.synchronize()
    res = {"name": f"K7q per-token int8 quantize, K={k}", "shape": list(x.shape),
           "codes_equal": bool(torch.equal(codes, want_codes)),
           "scales_equal": bool(torch.equal(scale, want_scale)),
           "max_abs_err": (scale - want_scale).abs().max().item()}
    del want_codes, want_scale
    res["ms"] = cuda_ms(lambda: kernels.quantize_rows(x), reps=5)
    res["plain_ms"] = cuda_ms(lambda: kernels.quantize_rows_reference(x), reps=3)
    res["gb_per_s"] = x.numel() * 3 / res["ms"] / 1e6  # bf16 read, int8 write
    # absmax, scale, divide, round: ~4 fp32 operations an element
    res.update(library_ms=None, **bound(tensor_bytes(x, codes, scale), 4.0 * x.numel(),
                                        FP32_PEAK_TFLOPS))
    res["bound_share"] = res["bound_ms"] / res["ms"]
    emit("kernel", **res)
    if not (res["codes_equal"] and res["scales_equal"]):
        raise AssertionError(f"K7q: kernel disagrees with its plain version: {res}")
    return res


def _quant_row_scale_case(gen) -> dict:
    """K7q's row-scale mode at the 4B's row-parallel W8A8 input under tp 2:
    w2's, 5,120 prefill tokens x 14,336 hidden units, a rank holding 7,168
    of each row. Each half's row-absmax pass, their max, and each half's
    codes with it, against the plain version (bit for bit) and the whole
    row's codes and scale; timed: one rank's two passes."""
    from gen3c_tpu_torch import kernels

    k = 14336 // 2
    x = torch.randn((AR_PREFIX, 2 * k), generator=gen, device="cuda").to(torch.bfloat16)
    x[0] = 0  # a zero token
    x[1, k + 5] = 40.0  # a row whose absmax lies in the other rank's half
    halves = (x[:, :k].contiguous(), x[:, k:].contiguous())
    amax = torch.maximum(*(kernels.row_absmax(h) for h in halves))
    want_amax = torch.maximum(*(kernels.row_absmax_reference(h) for h in halves))
    whole_codes, whole_scale = kernels.quantize_rows_reference(x)
    codes, scale = zip(*(kernels.quantize_rows(h, amax) for h in halves))
    want = [kernels.quantize_rows_reference(h, want_amax) for h in halves]
    torch.cuda.synchronize()
    res = {"name": "K7q row-scale mode (4B w2 input, tp 2: a rank's 7,168 of 14,336)",
           "shape": list(halves[0].shape), "amax_equal": bool(torch.equal(amax, want_amax)),
           "codes_equal": all(torch.equal(c, w[0]) for c, w in zip(codes, want)),
           "scales_equal": all(torch.equal(sc, w[1]) for sc, w in zip(scale, want)),
           "whole_row_equal": bool(torch.equal(torch.cat(codes, 1), whole_codes)
                                   and all(torch.equal(sc, whole_scale) for sc in scale)),
           "max_abs_err": max((sc - w[1]).abs().max().item() for sc, w in zip(scale, want))}
    h = halves[0]
    res["absmax_ms"] = cuda_ms(lambda: kernels.row_absmax(h), reps=5)
    res["codes_ms"] = cuda_ms(lambda: kernels.quantize_rows(h, amax), reps=5)
    res["ms"] = cuda_ms(lambda: kernels.quantize_rows(h, kernels.row_absmax(h)), reps=5)
    res["plain_ms"] = cuda_ms(lambda: kernels.quantize_rows_reference(
        h, kernels.row_absmax_reference(h)), reps=3)
    res["one_pass_ms"] = cuda_ms(lambda: kernels.quantize_rows(h), reps=5)
    # the function reads x once and writes its codes, scales and absmax
    res.update(library_ms=None, **bound(tensor_bytes(h, codes[0], scale[0], amax),
                                        4.0 * h.numel(), FP32_PEAK_TFLOPS))
    res["bound_share"] = res["bound_ms"] / res["ms"]
    emit("kernel", **res)
    if not all(res[k] for k in ("amax_equal", "codes_equal", "scales_equal", "whole_row_equal")):
        raise AssertionError(f"K7q row-scale mode disagrees with its plain version: {res}")
    return res


def _gemm_case(gen, name: str, M: int, K: int, N: int) -> dict:
    """K7 at one linear shape: exact int32 accumulators and bf16 outputs
    against the plain version, then times. The codes are K7q's, contiguous:
    where K is not a multiple of 16 no tensor map describes their rows, and
    K7 reads them from a copy in 16-byte rows ("copied")."""
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
           "copied": cuda.w8a8_operand(xq) is not xq, "acc_equal": bool(torch.equal(acc, acc_ref))}
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
    res.update(**bound(tensor_bytes(xq, wq, xs, ws) + M * N * 2, ops, INT8_PEAK_TOPS))
    try:  # cuBLAS's int8 product (int32 out): the GEMM without K7's rescale
        res["library_ms"] = library_ms(lambda: torch._int_mm(xq, wq.t()), reps=5)
    except RuntimeError as e:  # a shape _int_mm does not take
        res["library_ms"], res["library_error"] = None, str(e)[:200]
    emit("kernel", **res)
    if not (res["acc_equal"] and res["linear_equal"]) or res["max_abs_err"] != 0.0:
        raise AssertionError(f"K7: kernel disagrees with its plain version: {res}")
    return res


def _foreground_depth(h: int, w: int, seed: int, shift: float = 0.0, discs: int = 16,
                      bars: int = 16, bar_top: float = 0.35) -> torch.Tensor:
    """(h, w) depth on the card: a slanted plane with ``discs`` nearer discs
    and a railing of ``bars`` bars (14 pixels wide, at most half their
    period) below ``bar_top`` of the height in front, all moved right by
    ``shift`` pixels. Its depth boundaries give ~19k boundary-mesh
    triangles at 704x1280 with the defaults, over 100k with K6_DENSE_SCENE."""
    rng = np.random.default_rng(seed)
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device="cuda"),
                            torch.arange(w, dtype=torch.float32, device="cuda"), indexing="ij")
    depth = 2.5 - 0.8 * yy / h + 0.3 * torch.sin(6 * xx / w)
    for _ in range(discs):
        cy, cx, r = rng.uniform(0.1 * h, 0.9 * h), rng.uniform(0.1 * w, 0.9 * w), rng.uniform(30, 90)
        depth = torch.where((yy - cy) ** 2 + (xx - cx - shift) ** 2 < r * r,
                            float(rng.uniform(1.2, 1.6)), depth)
    bar_w = min(14.0, w / bars / 2)
    return torch.where((((xx - shift) % (w / bars)) < bar_w) & (yy > bar_top * h), 1.0, depth)


def k6_mesh(**scene):
    """K6's inputs as foreground masking forms them: the 901,120 pixel rays
    of a 704x1280 camera moved left and forward, and the boundary mesh of
    ``_foreground_depth(**scene)`` (seed 0) seen from it: (rays (R, 3),
    v0, v1, v2 (T, 3)) fp32 on the card."""
    from gen3c_tpu_torch.ops import geometry, raycast
    from gen3c_tpu_torch.pipelines.depth import default_intrinsics

    h, w = 704, 1280
    depth = _foreground_depth(h, w, seed=0, **scene)[None, None]
    k = torch.from_numpy(default_intrinsics(h, w)).cuda()[None]
    pts = geometry.unproject_points(depth, torch.eye(4, device="cuda")[None], k)
    target = torch.eye(4, device="cuda")[None]
    target[0, 0, 3], target[0, 2, 3] = 0.15, -0.1
    _, cam = geometry.project_points(pts, target, k)
    vertices, faces = raycast.build_boundary_mesh(cam[0], ~geometry.reliable_depth_mask(depth)[0, 0])
    v0, v1, v2 = (vertices[faces[:, i]].contiguous() for i in range(3))
    rays = geometry.pixel_rays(h, w, k)[0].reshape(-1, 3).contiguous()
    return rays, v0, v1, v2


def _ray_case(name: str = "K6 ray-triangle depth", scene: Optional[dict] = None,
              plain_row_step: int = 1) -> dict:
    """K6 on the 901,120 rays of a 704x1280 camera against the boundary mesh
    of a seeded depth (``scene``: _foreground_depth's arguments) seen from a
    camera moved left and forward, as foreground masking builds it: the
    plain version's bits (and its setup kernel's) on the rays of every
    ``plain_row_step``-th image row, the triangles it cannot bound, the
    pairs the 256-ray tiles keep and those a per-ray footprint keeps (the
    bound's), and the call, its setup and its kernel timed apart."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.kernels import cuda, reference

    rays, v0, v1, v2 = k6_mesh(**(scene or {}))
    R, T = rays.shape[0], v0.shape[0]
    got_all = kernels.ray_triangle_depth(rays, v0, v1, v2)
    rows = torch.arange(R, device=rays.device).view(-1, K6_FRAME_W)[::plain_row_step].reshape(-1)
    got = got_all[rows]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = kernels.ray_triangle_depth_reference(rays[rows], v0, v1, v2)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    both = (got > 0) & (want > 0)
    diff = (got - want).abs()[both]
    mesh = cuda.ray_triangle_setup_and_bounds(v0, v1, v2)
    tri = reference.ray_triangle_setup(v0, v1, v2)
    boxes = reference.ray_triangle_bounds(tri)
    tiles, cull = reference.ray_tiles(rays)
    tile_rays = torch.bincount(torch.arange(R, device=rays.device) // reference.RAY_TILE)
    survivors = sum(int((reference.ray_triangle_kept(tiles, cull, boxes[t0:t0 + 8192])
                         .sum(dim=1) * tile_rays).sum()) for t0 in range(0, T, 8192))
    footprint = reference.ray_triangle_footprint_pairs(rays, boxes)
    res = {"name": name, "rays": R, "triangles": T, "bit_equal": bool(torch.equal(got, want)),
           "setup_bit_equal": bool(torch.equal(mesh[0], tri) and torch.equal(mesh[1], boxes)
                                   and torch.equal(mesh[2], reference.ray_chunk_bounds(boxes))),
           "hit_fraction": (want > 0).float().mean().item(),
           "flip_fraction": ((got > 0) != (want > 0)).float().mean().item(),
           "max_abs_err": diff.max().item() if diff.numel() else 0.0,
           "rel_err": (diff / want[both]).max().item() if diff.numel() else 0.0,
           "tol": K6_TOL, "uncullable": int(torch.isinf(boxes).all(dim=1).sum()),
           "all_pairs": R * T, "survivor_pairs": survivors, "footprint_pairs": footprint,
           "plain_ms": plain_ms, "plain_rays": int(rows.numel())}
    res["ms"] = cuda_ms(lambda: kernels.ray_triangle_depth(rays, v0, v1, v2), reps=5)
    res["setup_ms"] = cuda_ms(lambda: cuda.ray_triangle_setup_and_bounds(v0, v1, v2), reps=5)
    res["kernel_ms"] = cuda_ms(lambda: cuda.ray_triangle_hits(rays, *mesh), reps=5)
    nbytes = tensor_bytes(rays, v0, v1, v2, got_all)
    # the bound counts the footprint's pairs; the all-pairs yardstick counts all R x T
    res.update(gpairs_per_s=survivors / res["kernel_ms"] / 1e6, library_ms=None,
               all_pairs_bound_ms=bound(nbytes, K6_OPS_PER_PAIR * R * T,
                                        FP32_PEAK_TFLOPS)["bound_ms"],
               **bound(nbytes, K6_OPS_PER_PAIR * footprint, FP32_PEAK_TFLOPS))
    emit("kernel", **res)
    if (T == 0 or not (res["bit_equal"] and res["setup_bit_equal"])
            or res["flip_fraction"] > K6_TOL["flip_fraction"]
            or res["rel_err"] > K6_TOL["rel_err"] or res["hit_fraction"] == 0):
        raise AssertionError(f"K6: kernel disagrees with its plain version: {res}")
    del rays, v0, v1, v2, got, got_all, want, mesh
    torch.cuda.empty_cache()
    return res


def _p2_case(gen) -> dict:
    """P2, K1's tile sweep: K1's wgmma forward built at each point of
    P2_SMOKE_CONFIGS (the other points' forwards built in phase_build), at
    the 7B self-attention shape. Each point is checked on a small shape
    against the plain attention and for K1's bits (the script's check; K1's
    point must give them), then timed and held to the plain attention on
    the full-shape inputs (the same values in both layouts), K1's point
    also to kernels.attention's bits there; its registers and spills from
    its build's ptxas."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.kernels import cuda
    from gen3c_tpu_torch.scripts import sweep_attention as sweep

    shape = (sweep.B, sweep.L, sweep.H, sweep.D)
    ptxas = sweep.build_points(sorted({p for p, _ in P2_SMOKE_CONFIGS}))  # built: the logs
    kernels.reset_launch_counts()
    q, k, v = sweep.qkv(shape, shape, "blhd", gen)
    layouts = {"blhd": (q, k, v),
               "bhld": tuple(t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))}
    plain = {}
    plain_ms = cuda_ms(lambda: plain.__setitem__("out", kernels.attention_reference(q, k, v)),
                       reps=1, warmup=0)
    rows = []
    for config in P2_SMOKE_CONFIGS:
        point, layout = config
        row = {**sweep.check(config, gen), **ptxas[point]}
        out = kernels.attention_point(*layouts[layout], point)
        err = (out.float() - plain["out"].float()).abs()
        row.update(max_abs_err=err.max().item(), mean_abs_err=err.mean().item())
        if point == cuda.K1_POINT:
            row["full_shape_k1_bits"] = bool(torch.equal(out, kernels.attention(*layouts[layout])))
        del out, err
        row.update(sweep.measure(config, *layouts[layout]))
        emit("p2_config", **row)
        rows.append(row)
    best = min(rows, key=lambda r: r["ms"])
    res = {"name": "P2 K1 tile sweep", "q": list(shape), "configs": rows, "best": best["config"],
           "ms": best["ms"], "tflops": best["tflops"], "k1_point_ms": rows[0]["ms"],
           "plain_ms": plain_ms, "launches": kernels.launch_counts["P2"],  # the sweep's own run
           "max_abs_err": max(r["max_abs_err"] for r in rows),
           **bound(tensor_bytes(q, k, v, q), sweep.FLOPS, BF16_PEAK_TFLOPS)}
    del plain
    torch.cuda.empty_cache()
    res["library_ms"] = library_ms(lambda: _sdpa(q, k, v))
    emit("kernel", **res)
    bad = [r["config"] for r in rows
           if r["max_abs_err"] > ATTN_TOL["max"] or r["mean_abs_err"] > ATTN_TOL["mean"]
           or not r.get("full_shape_k1_bits", True)]
    if bad:
        raise AssertionError(f"P2: {bad} disagree with the plain attention or K1: {res}")
    return res


def _k3lse_case(gen) -> dict:
    """K3lse, the band forward that keeps the row logsumexp (the forward of
    K4-band in LoRA + band training), at B=1, the 7B self shape, the fast
    preset's band."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.kernels import cuda

    B, L, H, D = 1, LATENT_T_7B * BAND_7B[0], 32, 128
    q, k, v = (torch.randn((B, L, H, D), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    before = dict(kernels.route_counts)
    out, lse = cuda.attention_fwd_lse(q, k, v, BAND_7B)
    (ref, ref_lse), plain_ms = timed_call(
        lambda: kernels.attention_forward_reference(q, k, v, BAND_7B))
    err = (out.float() - ref.float()).abs()
    res = {"name": "K3lse band forward with lse", "q": [B, L, H, D], "band": list(BAND_7B),
           "max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
           "lse_max_abs_err": (lse - ref_lse).abs().max().item(),
           "equals_k3": bool(torch.equal(out, cuda.attention(q, k, v, BAND_7B)))}
    del ref, ref_lse, err
    res["ms"] = cuda_ms(lambda: cuda.attention_fwd_lse(q, k, v, BAND_7B), reps=3)
    res["plain_ms"] = plain_ms
    flop = 4.0 * B * H * D * _band_pairs(LATENT_T_7B, *BAND_7B[1:]) * BAND_7B[0] ** 2
    res.update(tflops=flop / res["ms"] / 1e9,
               **bound(tensor_bytes(q, k, v, out, lse), flop, BF16_PEAK_TFLOPS))
    mask = _band_mask(L, BAND_7B)
    res["library_ms"] = library_ms(lambda: _sdpa(q, k, v, mask))
    del mask
    torch.cuda.empty_cache()
    res.update(bound_share=res["bound_ms"] / res["ms"], routes=route_delta(before),
               entries=wgmma_entries("fwd", D, band=True, lse=True))
    emit("kernel", **res)
    require_wgmma(res["name"], res["routes"])
    if (res["max_abs_err"] > ATTN_TOL["max"] or res["mean_abs_err"] > ATTN_TOL["mean"]
            or res["lse_max_abs_err"] > 1e-2 or not res["equals_k3"]):
        raise AssertionError(f"K3lse: kernel disagrees with its plain version or K3: {res}")
    return res


def _ulysses_view(x: torch.Tensor, cp: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s H/cp heads of the whole sequence x (B, L, H, D) as
    collectives.seq_to_heads leaves them: a view of the all-to-all's (cp,
    L/cp, B, H/cp, D) receive buffer, which K1cp reads in place."""
    B, L, H, D = x.shape
    hc = H // cp
    buf = x[:, :, rank * hc:(rank + 1) * hc].reshape(B, cp, L // cp, hc, D)
    return buf.permute(1, 2, 0, 3, 4).contiguous().view(L, B, hc, D).permute(1, 0, 2, 3)


def _k1cp_cases(q, k, v, full: dict) -> list:
    """K1cp (K1, or K3 under the band, on a Ulysses rank's heads) at the 7B
    shard shapes (2, 56,320, 32/cp, 128) for cp in CP_SIZES, with and
    without the band: rank 0's heads read in place from the all-to-all's
    layout, held to K1's (K3's) output on all 32 heads, sliced (equal bits
    expected: each (batch, head) is computed alone), and to the plain
    attention on the shard."""
    from gen3c_tpu_torch import kernels

    B, L, H, D = q.shape
    rows = []
    for cp in CP_SIZES:
        for band in (None, BAND_7B):
            hc = H // cp
            qs, ks, vs = (_ulysses_view(t, cp, 0) for t in (q, k, v))
            before = dict(kernels.route_counts)
            out = kernels.attention(qs, ks, vs, kernel_id="K1cp", band=band)
            want = full[band][:, :, :hc]
            plain = {}
            plain_ms = cuda_ms(lambda: plain.__setitem__(
                "out", kernels.attention_reference(qs, ks, vs, band)), reps=1, warmup=0)
            torch.cuda.synchronize()
            err = (out.float() - plain["out"].float()).abs()
            diff = (out.float() - want.float()).abs()
            res = {"name": f"K1cp cp={cp}" + (" band" if band else ""), "cp": cp,
                   "q": [B, L, hc, D], "band": list(band) if band else None,
                   "equals_full_sliced": bool(torch.equal(out, want)),
                   "max_abs_diff_full_sliced": diff.max().item(),
                   "max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
                   "plain_ms": plain_ms}
            del out, plain, err, diff
            res["ms"] = cuda_ms(lambda: kernels.attention(qs, ks, vs, kernel_id="K1cp", band=band),
                                reps=3)
            pairs = L * L if band is None else (
                _band_pairs(LATENT_T_7B, *band[1:]) * band[0] ** 2)
            flop = 4.0 * B * hc * D * pairs
            res.update(tflops=flop / res["ms"] / 1e9,
                       **bound(4 * B * L * hc * D * 2, flop, BF16_PEAK_TFLOPS))
            res.update(bound_share=res["bound_ms"] / res["ms"], routes=route_delta(before),
                       entries=wgmma_entries("fwd", D, band=band is not None))
            require_wgmma(res["name"], res["routes"])
            contig = [t.contiguous() for t in (qs, ks, vs)]
            mask = None if band is None else _band_mask(L, band)
            res["library_ms"] = library_ms(lambda: _sdpa(*contig, mask))
            del contig, mask, qs, ks, vs
            torch.cuda.empty_cache()
            emit("kernel", **res)
            if res["max_abs_err"] > ATTN_TOL["max"] or res["mean_abs_err"] > ATTN_TOL["mean"]:
                raise AssertionError(f"K1cp disagrees with its plain version: {res}")
            if res["max_abs_diff_full_sliced"] > ATTN_TOL["max"]:
                raise AssertionError(f"K1cp disagrees with K1 on all heads: {res}")
            rows.append(res)
    return rows


def _ring_rank(q, k, v, cp: int, rank: int, band, fold, merge):
    """Rank ``rank``'s ring attention over the cp KV shards of k/v with the
    given fold and merge (the kernels or their plain versions), as
    models.dit._ring_attention runs it; returns (output, the source ranks
    whose shards it folded)."""
    from gen3c_tpu_torch.models.dit import ring_step_needed

    B, L, H, D = q.shape
    ls = L // cp
    qs = q[:, rank * ls:(rank + 1) * ls].contiguous()
    acc = torch.zeros((B, ls, H, D), dtype=torch.float32, device=q.device)
    lse = torch.full((B, H, ls), float("-inf"), device=q.device)
    out, folded = None, []
    for step in range(cp):
        src = (rank - step) % cp
        last = step == cp - 1
        if band is None or ring_step_needed(rank, src, ls // band[0], band):
            o, l_ = fold(qs, k[:, src * ls:(src + 1) * ls], v[:, src * ls:(src + 1) * ls], band,
                         rank * ls, src * ls)
            out = merge(acc, lse, o, l_, q.dtype if last else None)
            folded.append(src)
            del o, l_
        elif last:
            out = merge(acc, lse, None, None, q.dtype)
    return out, folded


def _ring_case(q, k, v, full: dict, cp: int, band) -> dict:
    """K1ring + K1merge at the 7B shard shapes: every rank of a cp-way ring
    folds its shards and merges, held to K1 (K3 under the band) on the
    whole sequence, and rank 1's result to the plain fold and merge; the
    folded steps are held to the visible frame pairs of each shard pair.
    Times of one fold and one merge at the shard shape; the library's
    time is SDPA's flash attention with lse at that shape."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.kernels import reference

    B, L, H, D = q.shape
    ls = L // cp
    errs, folded_all, plain_err = [], [], None
    before = dict(kernels.route_counts)
    for rank in range(cp):
        got, folded = _ring_rank(q, k, v, cp, rank, band, kernels.ring_fold, kernels.ring_merge)
        errs.append((got.float() - full[band][:, rank * ls:(rank + 1) * ls].float()).abs())
        if rank == 1:
            plain, _ = _ring_rank(q, k, v, cp, rank, band, reference.ring_fold_reference,
                                  reference.ring_merge_reference)
            plain_err = (got.float() - plain.float()).abs()
            del plain
        folded_all.append(folded)
        del got
    frames = ls // BAND_7B[0]
    want_folded = [[s for s in ((r - i) % cp for i in range(cp))
                    if band is None or _shards_see_each_other(r, s, frames, band)]
                   for r in range(cp)]
    res = {"name": f"K1ring + K1merge cp={cp}" + (" band" if band else ""), "cp": cp,
           "q_shard": [B, ls, H, D], "band": list(band) if band else None,
           "max_abs_err_vs_full": max(e.max().item() for e in errs),
           "mean_abs_err_vs_full": float(np.mean([e.mean().item() for e in errs])),
           "max_abs_err": plain_err.max().item(), "mean_abs_err": plain_err.mean().item(),
           "folded": folded_all, "folded_expected": want_folded,
           "skipped_steps": sum(cp - len(f) for f in folded_all)}
    del errs, plain_err
    qs, ks, vs = (t[:, ls:2 * ls].contiguous() for t in (q, k, v))  # rank 1, its own shard
    o, l_ = kernels.ring_fold(qs, ks, vs, band, ls, ls)
    acc = torch.zeros((B, ls, H, D), dtype=torch.float32, device=q.device)
    lse = torch.full((B, H, ls), float("-inf"), device=q.device)
    res["fold_ms"] = cuda_ms(lambda: kernels.ring_fold(qs, ks, vs, band, ls, ls), reps=3)
    res["merge_ms"] = cuda_ms(lambda: kernels.ring_merge(acc, lse, o, l_), reps=3)
    res["plain_fold_ms"] = cuda_ms(lambda: reference.ring_fold_reference(qs, ks, vs, band, ls, ls),
                                   reps=1, warmup=0)
    res["plain_merge_ms"] = cuda_ms(lambda: reference.ring_merge_reference(acc, lse, o, l_),
                                    reps=1, warmup=0)
    pairs = ls * ls if band is None else _band_pairs(frames, *band[1:]) * band[0] ** 2
    flop = 4.0 * B * H * D * pairs  # one diagonal step's visible work
    res["fold_bound"] = bound(tensor_bytes(qs, ks, vs, o, l_), flop, BF16_PEAK_TFLOPS)
    # fp32 state read and written, the step's bf16 output and both lses read
    res["merge_bound"] = bound(tensor_bytes(acc, acc, o, l_, lse, lse), 6.0 * acc.numel(),
                               FP32_PEAK_TFLOPS)
    res["library_ms"] = library_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention(
        qs.transpose(1, 2), ks.transpose(1, 2), vs.transpose(1, 2)))
    res["fold_tflops"] = flop / res["fold_ms"] / 1e9
    res.update(fold_bound_share=res["fold_bound"]["bound_ms"] / res["fold_ms"],
               routes=route_delta(before), entries=wgmma_entries("fwd", D, band is not None, True))
    del qs, ks, vs, o, l_, acc, lse
    torch.cuda.empty_cache()
    emit("kernel", **res)
    require_wgmma(res["name"], res["routes"])
    if (res["max_abs_err_vs_full"] > ATTN_TOL["max"] or res["mean_abs_err_vs_full"] > ATTN_TOL["mean"]
            or res["max_abs_err"] > ATTN_TOL["max"] or res["mean_abs_err"] > ATTN_TOL["mean"]):
        raise AssertionError(f"K1ring/K1merge disagree with K1 or the plain ring: {res}")
    if folded_all != want_folded:
        raise AssertionError(f"K1ring skipped other steps than the band's frame pairs: {res}")
    return res


def _shards_see_each_other(q_rank: int, kv_rank: int, frames: int, band) -> bool:
    """Whether a query shard and a KV shard of ``frames`` frames hold a
    visible (query frame, key frame) pair: counted pair by pair, not by
    the ring's rule."""
    _, window, prefix = band
    return any(kf < prefix or abs(qf - kf) <= window
               for qf in range(q_rank * frames, (q_rank + 1) * frames)
               for kf in range(kv_rank * frames, (kv_rank + 1) * frames))


def _k1ag_case(q, k, v) -> dict:
    """K1ag: K1 on rank 0's query shard of a 2-way all-gather (Lq = L/2)
    over all L keys, read in place from the gather's (rank, position,
    batch, ...) layout, against K1's rows and the plain attention."""
    from gen3c_tpu_torch import kernels

    B, L, H, D = q.shape
    ls = L // 2
    qs = q[:, :ls]
    ks, vs = (t.transpose(0, 1).contiguous().transpose(0, 1) for t in (k, v))  # gathered layout
    before = dict(kernels.route_counts)
    out = kernels.attention(qs, ks, vs, kernel_id="K1ag")
    plain = {}
    plain_ms = cuda_ms(lambda: plain.__setitem__("out", kernels.attention_reference(qs, ks, vs)),
                       reps=1, warmup=0)
    torch.cuda.synchronize()
    err = (out.float() - plain["out"].float()).abs()
    res = {"name": "K1ag all-gather self-attention", "q": [B, ls, H, D], "kv": [B, L, H, D],
           "max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(), "plain_ms": plain_ms}
    del out, plain, err
    res["ms"] = cuda_ms(lambda: kernels.attention(qs, ks, vs, kernel_id="K1ag"), reps=3)
    flop = 4.0 * B * H * ls * L * D
    res.update(tflops=flop / res["ms"] / 1e9,
               **bound(tensor_bytes(qs, ks, vs, qs), flop, BF16_PEAK_TFLOPS))
    res.update(bound_share=res["bound_ms"] / res["ms"], routes=route_delta(before),
               entries=wgmma_entries("fwd", D, band=False))
    contig = [t.contiguous() for t in (qs, ks, vs)]
    res["library_ms"] = library_ms(lambda: _sdpa(*contig))
    del contig, ks, vs
    torch.cuda.empty_cache()
    emit("kernel", **res)
    require_wgmma(res["name"], res["routes"])
    if res["max_abs_err"] > ATTN_TOL["max"] or res["mean_abs_err"] > ATTN_TOL["mean"]:
        raise AssertionError(f"K1ag disagrees with its plain version: {res}")
    return res


def cp_kernel_cases(gen) -> dict:
    """K1cp, K1ring + K1merge and K1ag at the 7B self-attention shape,
    (2, 56,320, 32, 128) bf16, on one set of inputs whose K1 and K3 outputs
    on the whole sequence are the reference."""
    from gen3c_tpu_torch import kernels

    q, k, v = (torch.randn((2, LATENT_T_7B * BAND_7B[0], 32, 128), generator=gen,
                           device="cuda").to(torch.bfloat16) for _ in range(3))
    full = {None: kernels.attention(q, k, v), BAND_7B: kernels.attention(q, k, v, band=BAND_7B)}
    out = {"K1cp": _k1cp_cases(q, k, v, full), "K1ag": _k1ag_case(q, k, v)}
    out["K1ring"] = [_ring_case(q, k, v, full, cp, band) for cp in RING_CP_SIZES
                     for band in (None, BAND_7B)]
    del q, k, v, full
    torch.cuda.empty_cache()
    return out


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
    # fp32 with the band: frames of 37 tokens straddle the 32-key tiles; prefix 2
    results["K3_f32"] = _attention_case("K3 fp32 D=24 ragged, band 37 / 1 / 2", (2, 1000, 4, 24),
                                        (2, 1000, 4, 24), torch.float32, tol32, gen,
                                        time_it=False, band=(37, 1, 2))
    # MoGe ViT-L's attention at 704x1280 (fit to 378x700: 27 x 50 patches + cls),
    # q, k, v views of one qkv projection as in aux/moge.py
    results["K1vit"] = _attention_case("K1vit MoGe ViT-L self-attention (fp32)", (1, 1351, 16, 64),
                                       (1, 1351, 16, 64), torch.float32, tol32, gen, packed=True)
    results["K1_bf16_d24"] = _attention_case("K1 bf16 D=24 ragged", (2, 1000, 4, 24),
                                             (2, 333, 4, 24), bf16, ATTN_TOL, gen, time_it=False)
    torch.cuda.empty_cache()
    results["K4_self"] = _k4_case("K4 self-attention backward", (1, 56320, 32, 128),
                                  (1, 56320, 32, 128), bf16, gen, mma_sync_too=True)
    torch.cuda.empty_cache()
    results["K4_cross"] = _k4_case("K4 cross-attention backward", (1, 56320, 32, 128),
                                   (1, 512, 32, 128), bf16, gen)
    results["K4_f32"] = [_k4_case(f"K4 fp32 D=24 ragged, {lk} keys", (2, 250, 4, 24),
                                  (2, lk, 4, 24), torch.float32, gen, time_it=False)
                         for lk in (250, 37)]
    torch.cuda.empty_cache()
    results["K4band"] = _k4_case("K4-band self-attention backward", (1, 56320, 32, 128),
                                 (1, 56320, 32, 128), bf16, gen, band=BAND_7B)
    torch.cuda.empty_cache()
    results["K4band_full"] = _k4_full_window_case(gen)
    torch.cuda.empty_cache()
    # fp32, ragged: frames of 37 tokens straddle the 32-wide tiles; prefix 2
    results["K4band_f32"] = _k4_case("K4-band fp32 D=24 ragged", (2, 250, 4, 24), (2, 250, 4, 24),
                                     torch.float32, gen, time_it=False, band=(37, 1, 2))
    results["K3lse"] = _k3lse_case(gen)
    torch.cuda.empty_cache()
    results["P1"] = [_mma_probe_case(gen, dtype) for dtype in ("bf16", "int8")]
    results["P1_forms"] = _mma_probe_forms_case(gen)
    torch.cuda.empty_cache()
    results["K5"] = _splat_case(gen)
    results["K6"] = _ray_case()
    results["K6_dense"] = _ray_case("K6 ray-triangle depth, dense mesh", K6_DENSE_SCENE,
                                    K6_DENSE_PLAIN_ROW_STEP)
    torch.cuda.empty_cache()
    results["P2"] = _p2_case(gen)
    torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    results["K3"] = _band_case(gen)
    torch.cuda.empty_cache()
    results["K7q"] = [_quant_case(gen, k) for k in (4096, 16384)]
    results["K7q_row_scale"] = _quant_row_scale_case(gen)
    torch.cuda.empty_cache()
    tokens = 2 * 56320  # the CFG batch of one 121-frame chunk
    results["K7"] = [_gemm_case(gen, name, M, K, N) for name, M, K, N in [
        ("q/k/v/out", tokens, 4096, 4096), ("fc1", tokens, 4096, 16384),
        ("fc2", tokens, 16384, 4096), ("cross k/v", 2 * 512, 1024, 4096)]]
    if any(r["copied"] for r in results["K7"]):  # the 7B's codes go to TMA as they are
        raise AssertionError(f"K7 copied the codes of a 7B shape: {results['K7']}")
    torch.cuda.empty_cache()
    # ragged M, N and K (1,000: no tensor map describes rows of 1,000 bytes)
    results["K7_ragged"] = _gemm_case(gen, "ragged", 4099, 1000, 4104)
    torch.cuda.empty_cache()
    results.update(cp_kernel_cases(gen))
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


def build_7b():
    """The GEN3C-7B (bf16 DiT, fp32 VAE, seed 0, AdaLN output layers and
    final linear randomized from seed 1 so that the output depends on the
    attention) on the card, built once for main_path, dynamic, multiview
    and the cp phase's references: (model, preset, seconds)."""
    from gen3c_tpu_torch.pipelines.factory import build_gen3c_model

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, preset = build_gen3c_model("gen3c_7b", device="cuda", seed=0)
    randomize_gates(model.net, torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    return model, preset, time.perf_counter() - t0


@contextlib.contextmanager
def _depth(net, blocks):
    """Run ``net`` with its first ``blocks`` blocks only (None: all of
    them); the others come back after."""
    if blocks is None:
        yield
        return
    saved = dict(net.blocks.items())
    for name in list(saved)[blocks:]:
        del net.blocks[name]
    try:
        yield
    finally:
        for name, blk in saved.items():
            if name not in net.blocks:
                net.blocks[name] = blk


class _OneSampleAtATime(torch.nn.Module):
    """The DiT called on one sample at a time: the CFG pair as two B = 1
    forwards, whose linears run on half the rows, as each cp or cfg rank
    runs them. The same arithmetic as the batched call but for cuBLAS's
    tiling and bf16's rounding of it."""

    def __init__(self, net):
        super().__init__()
        self.net = net
        self.cfg = net.cfg

    def forward(self, x, t, ctx, **kw):
        return torch.cat([self.net(x[i:i + 1], t[i:i + 1], ctx[i:i + 1], **kw)
                          for i in range(x.shape[0])])


def _rel_diff(got: np.ndarray, ref: np.ndarray) -> dict:
    d = np.abs(got - ref)
    scale = float(np.abs(ref).mean())
    return {"max_abs_diff": float(d.max()), "mean_abs_diff": float(d.mean()),
            "rel_max": float(d.max()) / scale, "rel_mean": float(d.mean()) / scale}


def phase_cp_reference(model, preset) -> dict:
    """What the cp phase is held to: the single-process latent (main_path's
    chunk and steps at CP_SHORT_BLOCKS blocks) and the bf16 noise floor
    there: how far the same single process moves when it runs one sample at
    a time."""
    def run(blocks, one_at_a_time):
        net = model.net
        if one_at_a_time:
            model.net = _OneSampleAtATime(net)
        try:
            with _depth(net, blocks):
                _, pipeline, _ = _run_chain(model, preset, "cuda", num_frames=121,
                                            num_steps=MAIN_STEPS, seed=0)
        finally:
            model.net = net
        return pipeline.last_samples.float().cpu().numpy()

    short = run(CP_SHORT_BLOCKS, False)
    noise = {"short": _rel_diff(run(CP_SHORT_BLOCKS, True), short)}
    torch.cuda.empty_cache()
    emit("cp_reference", blocks=CP_SHORT_BLOCKS, one_sample_at_a_time=noise)
    return {"short": short, "noise": noise}


# the cp phase's runs, in order: (name, parallel strategy, cp_attn, blocks); the
# tensor-parallel ones last: they run on the net cut to each rank's tp shards
CP_RUNS = (("ulysses", "cp", "ulysses", CP_SHORT_BLOCKS), ("ring", "cp", "ring", CP_SHORT_BLOCKS),
           ("allgather", "cp", "allgather", CP_SHORT_BLOCKS),
           ("cfg2", "cfg2", "allgather", CP_SHORT_BLOCKS),
           ("tp", "tp", "allgather", CP_SHORT_BLOCKS),
           ("cp1tp2sp", "cp1tp2sp", "allgather", CP_SHORT_BLOCKS))
# what each run must launch, and what it must not
CP_WANT = {"ulysses": ("K1cp", "K2", "K5"), "ring": ("K1ring", "K1merge", "K2"),
           "allgather": ("K1ag", "K2"), "cfg2": ("K1", "K2"), "tp": ("K1", "K2", "K5"),
           "cp1tp2sp": ("K1", "K2", "K5")}
CP_STRAY = {"ulysses": ("K1", "K1ag", "K1ring"), "ring": ("K1", "K1cp", "K1ag"),
            "allgather": ("K1", "K1cp", "K1ring"), "cfg2": ("K1cp", "K1ag", "K1ring"),
            "tp": ("K1cp", "K1ag", "K1ring"), "cp1tp2sp": ("K1cp", "K1ag", "K1ring")}


# the cp phase's ranks then run, on the card the 7B left them: pp2, GPipe over 2
# stages of 2 of the 7B's blocks at full width, one a stage, B = 2 in M = 2
# microbatches of cp_train's dp clip (8 latent frames, 28,160 tokens a sample:
# at 56,320 two ranks' backward activations would not fit the card); render_cp2,
# the 7B preset's 121 target renders at 704 x 1280 split over the two ranks; and
# ar_tp, the 4B AR model at full width (4,096 channels, 32 / 8 heads, tp 2: 16 / 4
# a rank) on AR_TP_LAYERS of its 16 layers
PP_BLOCKS, PP_B, PP_M, PP_T = 2, 2, 2, 8
RENDER_FRAMES = 121
AR_TP_LAYERS = 2
AR_TP_DECODE = 16  # teacher-forced cached decode steps after the 5,120-token prefill
AR_TP_GENERATE = 8  # greedy tokens of the short generate, the same on both ranks
AR_TP_PROMPT = 256
# a run's outputs against one process's, relative to mean |reference|: the bound
# is CP_NOISE_FACTOR times the noise floor the same process shows when the same
# arithmetic is tiled otherwise (pp2: the 2-sample forward at once against one
# sample at a time, as the microbatches run, and its gradient; ar_tp: each
# row-parallel linear as two half products summed in bf16, tp 2's arithmetic
# without the parallel code), never below PAR_TOL. A wrong stage order,
# a lost microbatch, a wrong head or vocab shard moves the output by O(1)
PAR_TOL = {"max": 0.1, "mean": 0.01}


def _rel_t(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """_rel_diff on the card."""
    d = (got.float() - ref.float()).abs()
    scale = ref.float().abs().mean().item()
    return {"max_abs_diff": d.max().item(), "mean_abs_diff": d.mean().item(),
            "rel_max": d.max().item() / scale, "rel_mean": d.mean().item() / scale}


def _counted(fn):
    """fn() with the launch counts and the collectives' traffic set to 0
    just before (after a barrier) and read just after, with its seconds and
    the card's peak: (value, record)."""
    import torch.distributed as dist

    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.parallel import collectives

    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    collectives.reset_traffic()
    t0 = time.perf_counter()
    value = fn()
    torch.cuda.synchronize()
    return value, {"s": time.perf_counter() - t0,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                   "launches": {k: v for k, v in kernels.launch_counts.items() if v},
                   "traffic": {op: dict(c) for op, c in collectives.traffic.items()
                               if c["calls"]}}


def _pp2_run(rank: int, axis) -> dict:
    """pp_dit_forward of PP_BLOCKS of the 7B over the two ranks and the
    gradient of sum(out ** 2) with respect to x; rank 0 then runs the same
    net one sample at a time (what each microbatch is) with its gradient,
    and the 2-sample forward at once (the noise floor)."""
    import dataclasses as dc

    import torch.distributed as dist

    from gen3c_tpu_torch.parallel.pp import pp_dit_forward
    from gen3c_tpu_torch.pipelines.factory import GEN3C_7B_PRESET
    from gen3c_tpu_torch.training.train import build_net

    cfg = dc.replace(GEN3C_7B_PRESET.dit, num_blocks=PP_BLOCKS)
    net = build_net(cfg, "cuda:0", seed=0)
    randomize_gates(net, torch.Generator(device="cuda:0").manual_seed(1))
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((PP_B, cfg.in_channels, PP_T, 88, 160), generator=gen).cuda()
    t = torch.rand((PP_B,), generator=gen).cuda()
    ctx = torch.randn((PP_B, 512, 1024), generator=gen).cuda()
    xg = x.clone().requires_grad_(True)

    def run():
        out = pp_dit_forward(axis, net, xg, t, ctx, n_microbatches=PP_M)
        (out.float() ** 2).sum().backward()
        return out.detach()

    out, rec = _counted(run)
    res = {"blocks": PP_BLOCKS, "stages": axis.size, "stage": axis.rank, "B": PP_B,
           "microbatches": PP_M, "tokens_a_sample": PP_T * 88 * 160 // 4, **rec,
           "finite": bool(torch.isfinite(out).all().item())}
    if rank == 0:
        grad = xg.grad
        ref_out, ref_grad = [], []
        for i in range(PP_B):
            xi = x[i:i + 1].clone().requires_grad_(True)
            oi = net(xi, t[i:i + 1], ctx[i:i + 1], fps=24.0)
            (oi.float() ** 2).sum().backward()
            ref_out.append(oi.detach())
            ref_grad.append(xi.grad)
            del oi, xi
        ref_out, ref_grad = torch.cat(ref_out), torch.cat(ref_grad)
        # the noise floor: both samples at once (remat keeps the card's peak
        # at one block's activations), the tiling the pipeline's final layer
        # sees
        xb = x.clone().requires_grad_(True)
        ob = net(xb, t, ctx, fps=24.0, remat=True)
        (ob.float() ** 2).sum().backward()
        res.update(out=_rel_t(out, ref_out), grad_x=_rel_t(grad, ref_grad),
                   noise=_rel_t(ob.detach(), ref_out), noise_grad=_rel_t(xb.grad, ref_grad))
        del ref_out, ref_grad, grad, ob, xb
    dist.barrier()
    del net, xg, out
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _render_cp2_run(rank: int, axis) -> dict:
    """sharded_render_cache of the 7B preset's RENDER_FRAMES targets at
    704 x 1280 over the two ranks; rank 0 then renders them in one process
    (``render_cache``): the share of pixels off by more than SPLAT_TOL and
    of masks that differ (K5's atomics sum in another order)."""
    import torch.distributed as dist

    from gen3c_tpu_torch.cache import Cache3DBuffer
    from gen3c_tpu_torch.ops.camera import generate_camera_trajectory
    from gen3c_tpu_torch.parallel.cache_sharding import sharded_render_cache
    from gen3c_tpu_torch.pipelines.depth import HeuristicDepthEstimator

    h, w = 704, 1280
    image = _seed_image(h, w, 3)
    depth, k, _ = HeuristicDepthEstimator()((image[0, :, 0].transpose(1, 2, 0) + 1) / 2)
    w2c0 = np.eye(4, dtype=np.float32)
    cache = Cache3DBuffer(frame_buffer_max=2, input_image=torch.from_numpy(image[:, :, 0]),
                          input_depth=torch.from_numpy(depth[None, None]),
                          input_w2c=torch.from_numpy(w2c0[None]),
                          input_intrinsics=torch.from_numpy(k[None]), device="cuda:0")
    w2cs, ks = generate_camera_trajectory("left", w2c0, k, RENDER_FRAMES, 0.3, "center_facing",
                                          1.0, device="cuda:0")
    (px, mk), rec = _counted(lambda: sharded_render_cache(cache, axis, w2cs, ks))
    res = {"frames": RENDER_FRAMES, "size": [h, w], "shape": list(px.shape), **rec,
           "finite": bool(torch.isfinite(px).all().item())}
    if rank == 0:
        one_px, one_mk = cache.render_cache(w2cs, ks)
        d = (px - one_px).abs()
        res.update(max_abs_diff=d.max().item(), share_off=(d > SPLAT_TOL).float().mean().item(),
                   mask_share_off=(mk != one_mk).float().mean().item())
        del one_px, one_mk, d
    dist.barrier()
    del px, mk, cache
    torch.cuda.empty_cache()
    return res


def _ar_tp_run(rank: int, groups) -> dict:
    """The 4B (AR_TP_LAYERS of its layers, full width, bf16, seed 0) whole
    on rank 0, then cut to each rank's tp shards (``shard_ar_params``): a
    5,120-token prefill and AR_TP_DECODE teacher-forced cached decode steps
    with the bf16 and the int8 cache, their logits held to one process's
    (and to its noise floor: its row-parallel sums halved,
    ``_halved_row_sums``); a short greedy
    generate, the same tokens on both ranks; then the W8A8 model
    (``quantize_ar_params(act_quant=True)``, the row-parallel wo and w2
    through K7q's row-scale mode and K7's summed int32 products): its
    forward's logits at every prefill position, held the same way (its
    decode is not: K8's decode splits its keys by the KV heads a call
    holds, and a bit off in its output moves W8A8's codes). Per run: K8's
    launches a rank, the collectives' bytes and host seconds, ms per decode
    token, peak GiB."""
    import dataclasses as dc

    import torch.distributed as dist

    from gen3c_tpu_torch.models import ar_transformer as tar
    from gen3c_tpu_torch.models.quantize import quantize_ar_params
    from gen3c_tpu_torch.parallel import collectives
    from gen3c_tpu_torch.parallel.sharding import shard_ar_params
    from gen3c_tpu_torch.pipelines.autoregressive import AR_PRESETS

    cfg = dc.replace(AR_PRESETS["ar_4b"].ar, n_layers=AR_TP_LAYERS)
    tokens = torch.randint(0, cfg.vocab_size, (1, AR_PREFIX + AR_TP_DECODE),
                           generator=torch.Generator().manual_seed(7)).cuda()

    def build():
        with torch.device("meta"):
            model = tar.ARTransformer(cfg)
        return model.to_empty(device="cuda:0").init_random(
            torch.Generator(device="cuda:0").manual_seed(0))

    @torch.no_grad()
    def teacher(model, int8: bool):
        cache = tar.init_kv_cache(cfg, 1, dtype=cfg.dtype, quantized=int8, device="cuda:0",
                                  tp=model.tp_size)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = model(tokens[:, :AR_PREFIX], cache=cache)
        rows = [logits[:, -1]]
        del logits
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        step_ms = []
        for i in range(AR_PREFIX, AR_PREFIX + AR_TP_DECODE):
            t0 = time.perf_counter()
            step, _ = model(tokens[:, i:i + 1], cache=cache)
            rows.append(step[:, -1])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        return torch.cat(rows).float(), prefill_s, step_ms

    @torch.no_grad()
    def prefill(model):
        """The W8A8 model's cache-free forward: every position's logits."""
        t0 = time.perf_counter()
        logits = model(tokens[:, :AR_PREFIX])[0][0]
        torch.cuda.synchronize()
        return logits, time.perf_counter() - t0, []

    res = {"layers": AR_TP_LAYERS, "dim": cfg.dim, "heads": cfg.n_heads,
           "kv_heads": cfg.n_kv_heads, "tp": groups.tp.size, "prefix": AR_PREFIX,
           "decode_steps": AR_TP_DECODE, "runs": {}}
    # the bf16 model's cached decode with either cache, then the W8A8 model's
    # forward (its logits at every prefill position)
    for quant, kind, int8 in ((None, "bf16 cache", False), (None, "int8 cache", True),
                              ("w8a8", "forward", False)):
        def run_it(model):
            return prefill(model) if quant else teacher(model, int8)

        if kind != "int8 cache":
            model = build()
            if quant:
                quantize_ar_params(model, act_quant=True)
        ref = noise = None
        if rank == 0:
            if kind == "int8 cache":  # the model is cut already: a whole one for the reference
                whole = build()
                ref = run_it(whole)[0]
                with _halved_row_sums(tar):
                    noise = _rel_t(run_it(whole)[0], ref)
                del whole
            else:
                ref = run_it(model)[0]
                with _halved_row_sums(tar):
                    noise = _rel_t(run_it(model)[0], ref)
        dist.barrier()
        shard_ar_params(model, groups)
        name = ("w8a8 " if quant else "bf16 ") + kind
        (logits, prefill_s, step_ms), rec = _counted(lambda: run_it(model))
        run = {"prefill_s": prefill_s,
               "heads_a_rank": model.layers[0].attention.wq.weight.shape[0] // cfg.head_dim,
               "kv_heads_a_rank": model.layers[0].attention.wk.weight.shape[0]
               // cfg.head_dim, **rec, "finite": bool(torch.isfinite(logits).all().item())}
        if step_ms:
            run.update(ms_per_token=float(np.mean(step_ms)),
                       ms_per_token_median=float(np.median(step_ms)))
        if rank == 0:
            run.update(logits=_rel_t(logits, ref), noise=noise)
            if step_ms:
                run["rows_rel_mean"] = [_rel_t(a, b)["rel_mean"] for a, b in zip(logits, ref)]
        res["runs"][name] = run
        del logits, ref
        if quant:
            res["w8a8_row_parallel"] = _w8a8_row_parallel_check(groups)
        if kind == "bf16 cache":
            with torch.no_grad():
                out, rec = _counted(lambda: tar.generate(model, tokens[:, :AR_TP_PROMPT],
                                                         AR_TP_GENERATE, temperature=0.0))
            both = collectives.all_gather(out, 0, groups.tp)
            res["generate"] = {**rec, "new_tokens": AR_TP_GENERATE,
                               "same_on_every_rank": bool((both == both[:1]).all().item())}
        if kind != "bf16 cache":
            del model
        gc.collect()
        torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def _halved_row_sums(tar):
    """One process's row-parallel linears (wo, w2) as two products over the
    halves of their inputs, each rounded to the model's dtype and summed:
    the arithmetic tp 2 gives them, with no parallel code (ar_tp's noise
    floor). A W8A8 linear's int32 sums are exact either way: it runs as
    it is."""
    import torch.nn.functional as F

    whole = tar._row_out

    def halved(x, lin, tp):
        if tp is not None or not isinstance(lin, torch.nn.Linear):
            return whole(x, lin, tp)
        k = x.shape[-1] // 2
        w = lin.weight.to(x.dtype)
        return F.linear(x[..., :k], w[:, :k]) + F.linear(x[..., k:], w[:, k:])

    tar._row_out = halved
    try:
        yield
    finally:
        tar._row_out = whole


def _w8a8_row_parallel_check(groups) -> dict:
    """``kernels.w8a8_matmul(tp=)`` on each rank's half of a (AR_PREFIX,
    14,336) bf16 input and of int8 weight codes (4,096, 14,336), the 4B's
    w2 at tp 2, against one process's ``w8a8_matmul`` of the whole: the
    same bits (K7q's row-scale mode, the max and the int32 sums over tp)."""
    from gen3c_tpu_torch import kernels

    gen = torch.Generator(device="cuda:0").manual_seed(9)
    x = torch.randn((AR_PREFIX, 14336), generator=gen, device="cuda:0").to(torch.bfloat16)
    w = (torch.randn((4096, 14336), generator=gen, device="cuda:0") * 0.02).to(torch.bfloat16)
    wq, ws = kernels.quantize_rows(w)
    k = x.shape[1] // groups.tp.size
    cols = slice(groups.tp.rank * k, (groups.tp.rank + 1) * k)
    one = kernels.w8a8_matmul(x, wq, ws, torch.bfloat16)
    got = kernels.w8a8_matmul(x[:, cols].contiguous(), wq[:, cols].contiguous(), ws,
                              torch.bfloat16, tp=groups.tp)
    return {"shape": [AR_PREFIX, k, 4096], "equal": bool(torch.equal(got, one)),
            **_rel_t(got, one)}


def _spawn_ranks(flag: str, n: int, out_dir: str, timeout_s: float, env=None):
    """n processes of this script with ``flag`` r (r = 0..n-1), each a rank
    (its worker sets torchrun's environment) on one free port, their output
    to ``<flag><r>.log`` in out_dir; waits for all of them (killed at
    timeout_s); (return codes, seconds, log tails)."""
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    names = [os.path.join(out_dir, f"{flag.strip('-')}{r}.log") for r in range(n)]
    logs = [open(name, "w") for name in names]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, str(r),
                               "--cp-port", str(port), "--cp-out", out_dir],
                              stdout=logs[r], stderr=subprocess.STDOUT,
                              env={**os.environ, **(env or {})}) for r in range(n)]
    t0 = time.perf_counter()
    try:
        for proc in procs:
            proc.wait(timeout=max(1.0, timeout_s - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs:
            f.close()
    tails = [open(name).read()[-3000:] for name in names]
    return [p.returncode for p in procs], time.perf_counter() - t0, tails


def _cp_extras(rank: int, out_dir: str) -> dict:
    """pp2, render_cp2 and ar_tp on the cp phase's two ranks (gloo), after
    the 7B is gone; each rank's numbers."""
    from gen3c_tpu_torch.parallel import mesh

    axis = mesh.pp_axis(backend="gloo")
    tp = mesh.make_groups(tp=CP_RANKS, backend="gloo")
    return {"pp2": _pp2_run(rank, axis), "render_cp2": _render_cp2_run(rank, axis),
            "ar_tp": _ar_tp_run(rank, tp)}


def cp_worker(rank: int, port: int, out_dir: str) -> int:
    """One rank of the cp phase, a process of its own with torchrun's
    environment: the 7B (main_path's seeds) through build_gen3c_model over
    CP_RANKS ranks on cuda:0 with gloo, then each of CP_RUNS through
    main_path's entry point (run_chunked_generation, 121 frames,
    MAIN_STEPS steps), each laid out by pipelines.factory.parallelize,
    the step build_gen3c_model ends with (the tensor-parallel runs on the
    net it cuts to this rank's shards: q/k/v/out and fc1/fc2 of all 28
    blocks);
    per run its seconds, collective traffic, peak GiB, launches and the
    heads a rank runs to rank<r>.json, and rank 0's latent to
    cp_<name>.npy."""
    import dataclasses

    import torch.distributed as dist

    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.models import dit
    from gen3c_tpu_torch.parallel import collectives
    from gen3c_tpu_torch.pipelines.factory import build_gen3c_model, parallelize

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(CP_RANKS),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.cuda.set_per_process_memory_fraction(CP_MEMORY_FRACTION, 0)
    t0 = time.perf_counter()
    model, preset = build_gen3c_model("gen3c_7b", device="cuda:0", seed=0, num_devices=CP_RANKS,
                                      parallel="cp", cp_attn="ulysses", dist_backend="gloo")
    randomize_gates(model.net, torch.Generator(device="cuda:0").manual_seed(1))
    torch.cuda.synchronize()
    out = {"rank": rank, "build_s": time.perf_counter() - t0,
           "backend": dist.get_backend(model.groups.cp.group), "runs": {}}
    for name, parallel, impl, blocks in CP_RUNS:
        model.net.cfg = dataclasses.replace(model.net.cfg, cp_attn_impl=impl)
        groups = parallelize(model, parallel, CP_RANKS, backend="gloo")
        torch.cuda.empty_cache()
        cfg, cp, tp, sp = (groups.cfg.size, groups.cp.size, groups.tp.size,
                           model.sequence_parallel)
        with _depth(model.net, blocks):
            torch.cuda.synchronize()
            dist.barrier()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            collectives.reset_traffic()
            dit.ring_steps.update(folded=0, skipped=0)
            t0 = time.perf_counter()
            _, pipeline, _ = _run_chain(model, preset, "cuda:0", num_frames=121,
                                        num_steps=MAIN_STEPS, seed=0)
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
            launches = dict(kernels.launch_counts)
            routes = dict(kernels.route_counts)
        samples = pipeline.last_samples
        if rank == 0:
            np.save(os.path.join(out_dir, f"cp_{name}.npy"), samples.float().cpu().numpy())
        steps = pipeline.last_timings["denoise_steps"]
        out["runs"][name] = {
            "parallel": parallel, "cp_attn": impl, "blocks": blocks or preset.dit.num_blocks,
            "step_s": [s["seconds"] for s in steps], "chunk_s": total_s,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "launches": launches,
            "routes": routes, "traffic_per_step": {op: {k: v / len(steps) for k, v in c.items()}
                                 for op, c in collectives.traffic.items() if c["calls"]},
            "ring_steps": dict(dit.ring_steps), "cfg": cfg, "cp": cp, "tp": tp, "sp": sp,
            "heads_a_rank": model.net.blocks.block0.blocks[0].block.attn.to_q[0].weight.shape[0]
            // model.net.cfg.head_dim,
            "latents_finite": bool(torch.isfinite(samples).all().item())}
        del pipeline, samples
        torch.cuda.empty_cache()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    out.update(_cp_extras(rank, out_dir))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_cp(refs: dict) -> dict:
    """CP_RANKS ranks of the 7B on the one card (cp_worker, gloo): Ulysses,
    ring, all-gather, cfg2, and tensor parallelism (tp 2: each rank's 16 of
    the 32 heads and half of every block's linears) without and with
    sequence parallelism at CP_SHORT_BLOCKS blocks against
    phase_cp_reference's single-process latent, each within CP_NOISE_FACTOR
    times its noise floor (not below CP_TOL), each launching CP_WANT's
    kernels and none of CP_STRAY's, on the wgmma bodies only. The ranks
    share the card and their collectives go through host memory: none of
    these times is a multi-card time."""
    from gen3c_tpu_torch.pipelines.factory import GEN3C_7B_PRESET

    parent_gib = torch.cuda.memory_allocated() / 2 ** 30
    free_gib = torch.cuda.mem_get_info()[0] / 2 ** 30
    os.makedirs(OUT_DIR, exist_ok=True)
    out_dir = tempfile.mkdtemp(dir=OUT_DIR, prefix="cp_")
    codes, wall_s, tails = _spawn_ranks("--cp-rank", CP_RANKS, out_dir, CP_TIMEOUT_S)
    if any(codes):
        raise AssertionError(f"cp: ranks exited {codes} after {wall_s:.0f} s (this process "
                             f"held {parent_gib:.2f} GiB, {free_gib:.2f} GiB free):\n"
                             + "\n----\n".join(tails))
    ranks = [json.load(open(os.path.join(out_dir, f"rank{r}.json"))) for r in range(CP_RANKS)]
    res = {"ranks": CP_RANKS, "backend": ranks[0]["backend"], "wall_s": wall_s,
           "build_s": [r["build_s"] for r in ranks], "parent_gib": parent_gib,
           "free_gib_at_start": free_gib, "noise": refs["noise"],
           "note": "both ranks share one card and their collectives go through host memory "
                   "(gloo): no time here is a multi-card time", "runs": {}}
    bad = []
    for name, _, _, blocks in CP_RUNS:
        ref, noise = refs["short"], refs["noise"]["short"]
        tol = {k: max(CP_TOL[k], CP_NOISE_FACTOR * noise[f"rel_{k}"]) for k in ("max", "mean")}
        run = {"rank": [r["runs"][name] for r in ranks], "tol": tol,
               **_rel_diff(np.load(os.path.join(out_dir, f"cp_{name}.npy")), ref)}
        res["runs"][name] = run
        if run["rel_max"] > tol["max"] or run["rel_mean"] > tol["mean"] or not all(
                r["latents_finite"] for r in run["rank"]):
            bad.append(f"{name} disagrees with the single process")
        for rk in run["rank"]:
            launches = rk["launches"]
            if any(launches[k] == 0 for k in CP_WANT[name]) or any(
                    launches[k] for k in CP_STRAY[name]):
                bad.append(f"{name} launched {launches}")
            heads = GEN3C_7B_PRESET.dit.num_heads // rk["tp"]
            if rk["heads_a_rank"] != heads:
                bad.append(f"{name}: a rank ran {rk['heads_a_rank']} heads, not {heads}")
        routes = [r["routes"] for r in run["rank"]]
        if any(r["mma_sync"] or not r["wgmma"] for r in routes):
            bad.append(f"{name}: attention launches by body {routes}, expected wgmma only")
    bad += _check_cp_extras(ranks, res)
    shutil.rmtree(out_dir, ignore_errors=True)
    emit("cp", **res)
    if bad:
        raise AssertionError(f"cp: {bad}: {res}")
    return res


def _noise_tol(noise: dict) -> dict:
    return {k: max(PAR_TOL[k], CP_NOISE_FACTOR * noise[f"rel_{k}"]) for k in ("max", "mean")}


def _off(rel: dict, tol: dict) -> bool:
    return rel["rel_max"] > tol["max"] or rel["rel_mean"] > tol["mean"]


def _check_cp_extras(ranks: list, res: dict) -> list:
    """pp2, render_cp2 and ar_tp of the cp phase's ranks (``_cp_extras``)
    against their one-process runs and bounds, into res; what failed."""
    bad = []
    pp = [r["pp2"] for r in ranks]
    tol, tol_grad = _noise_tol(pp[0]["noise"]), _noise_tol(pp[0]["noise_grad"])
    res["pp2"] = {"ranks": pp, "tol": tol, "tol_grad": tol_grad}
    if _off(pp[0]["out"], tol) or _off(pp[0]["grad_x"], tol_grad) or \
            not all(r["finite"] for r in pp):
        bad.append(f"pp2: output or gradient off the one process: {pp[0]}")
    blocks_a_stage = PP_BLOCKS // CP_RANKS
    for r in pp:
        la = r["launches"]
        want = PP_M * blocks_a_stage
        if la.get("K1") != want or la.get("K2") != want or la.get("K4") != 2 * want:
            bad.append(f"pp2: stage {r['stage']} launched {la}")
        if r["traffic"].get("p2p", {}).get("calls") != 2 * PP_M:
            bad.append(f"pp2: stage {r['stage']} point-to-point traffic {r['traffic']}")
    rd = [r["render_cp2"] for r in ranks]
    res["render_cp2"] = {"ranks": rd, "share_tol": 1 - SPLAT_MASK_AGREE}
    per_rank = -(-RENDER_FRAMES // CP_RANKS)
    from gen3c_tpu_torch.cache.cache3d import Cache3DBase

    if rd[0]["share_off"] > 1 - SPLAT_MASK_AGREE or rd[0]["mask_share_off"] > 1 - SPLAT_MASK_AGREE \
            or not all(r["finite"] for r in rd):
        bad.append(f"render_cp2: off the one-process render: {rd[0]}")
    for r in rd:
        if r["shape"] != [1, RENDER_FRAMES, 1, 3, 704, 1280] or \
                r["launches"].get("K5") != -(-per_rank // Cache3DBase.render_chunk):
            bad.append(f"render_cp2: a rank rendered {r['shape']}, launches {r['launches']}")
    ar = [r["ar_tp"] for r in ranks]
    res["ar_tp"] = {"ranks": ar}
    for name, run in ar[0]["runs"].items():
        tol = _noise_tol(run["noise"])
        run["tol"] = tol
        if _off(run["logits"], tol):
            bad.append(f"ar_tp {name}: logits off the one process: {run}")
    for r in ar:
        for name, run in r["runs"].items():
            la = run["launches"]
            k8 = AR_TP_LAYERS * (1 if name.endswith("forward") else 1 + AR_TP_DECODE)
            if la.get("K8") != k8 or run["heads_a_rank"] != 16 \
                    or run["kv_heads_a_rank"] != 4 or not run["finite"]:
                bad.append(f"ar_tp {name}: a rank ran {run['heads_a_rank']} / "
                           f"{run['kv_heads_a_rank']} heads, launched {la}")
            if name.startswith("w8a8") and not (la.get("K7q") and la.get("K7")):
                bad.append(f"ar_tp {name}: W8A8 launched {la}")
        if not r["generate"]["same_on_every_rank"]:
            bad.append(f"ar_tp: the ranks generated other tokens: {r['generate']}")
        if not r["w8a8_row_parallel"]["equal"]:
            bad.append(f"ar_tp: a row-parallel W8A8 product differs from one process's: "
                       f"{r['w8a8_row_parallel']}")
    return bad


# the cp_train phase: the 7B at full width (4096 channels, 32 x 128 heads, bf16) on
# CP_TRAIN_BLOCKS of its 28 blocks, two ranks on the one card over gloo, each
# holding the whole training state under dp and cp (12 bytes a parameter: 2 x
# ~6.6 GiB at 2 blocks) and half of every block's linears' under tp, beside
# its activations (per-block remat; the 12-block train phase's peak was 31 GiB
# above its state at 56,320 tokens, so ~15.5 GiB at a rank's 28,160): 8 blocks
# would pass the card's 80 GB. A step's time is gloo's host path, which grows
# with the blocks: 1 (PR 21 ran 6, PR 22 2) pays for the tp and FSDP runs' time
CP_TRAIN_BLOCKS = 1
CP_TRAIN_STEPS = 2
CP_TRAIN_LR = 1e-4  # warmup 1: optax's first update has lr 0, the second lr
# (name, dp, cp, tp, sequence parallelism, steps, latent T, B): Ulysses over the
# 121-frame clip's 16 latent frames (28,160 tokens a rank), then dp over two
# clips of 8 latent frames (each rank one clip of 28,160 tokens: the same
# activations a rank), then tp over one clip of 8 latent frames (each rank
# 28,160 tokens through its 16 heads; with sp 14,080 between the sub-blocks), then
# dp with FSDP over the dp run's two clips (each rank 1/2 of every block's
# linears, of the large embedders and of their moments and EMA)
CP_TRAIN_RUNS = (("cp2", 1, 2, 1, False, CP_TRAIN_STEPS, LATENT_T_7B, 1),
                 ("dp2", 2, 1, 1, False, 1, 8, 2),
                 ("tp2", 1, 1, 2, False, CP_TRAIN_STEPS, 8, 1),
                 ("tp2sp", 1, 1, 2, True, 1, 8, 1),
                 ("fsdp2", 2, 1, 1, False, 1, 8, 2))
CP_TRAIN_FSDP = ("fsdp2",)  # the runs that cut the state over dp (sharding.shard_fsdp)
# one leaf of each kind the tp runs shard or sum: q's rows (dim 0), out's columns
# (dim 1), fc1's rows, q's RMSNorm scale (a part on each tp rank, summed over
# tp) and the final layer (replicated)
CP_TRAIN_LEAVES = ("blocks.block0.blocks.0.block.attn.to_q.0.weight",
                   "blocks.block0.blocks.0.block.attn.to_out.0.weight",
                   "blocks.block0.blocks.2.block.layer1.weight",
                   "blocks.block0.blocks.0.block.attn.to_q.1.weight",
                   "final_layer.linear.weight")
# the runs whose state is then gathered as Trainer saves it
# (sharding.gather_to_host), with the card's peak held to one gathered tensor
CP_TRAIN_SAVE_RUNS = ("tp2", "fsdp2")
CP_TRAIN_MEMORY_FRACTION = 0.48
CP_TRAIN_TIMEOUT_S = 600  # the two ranks, together
# two ranks against one: the same bf16 arithmetic per token but GEMMs over half
# the rows (cuBLAS may tile them otherwise) and each rank's bf16 weight gradient
# rounded before the fp32 sum; the first moments' bounds are TRAIN_PARITY_TOL's.
# AdamW divides each gradient by its own root mean square, so an element whose
# gradient is at the noise floor steps by up to lr either way: the updates are
# held in the mean and by the share of elements off by more than a tenth of
# the largest step (the 99% of tests/test_torch_ar_train.py's two-step check)
CP_TRAIN_TOL = {"loss": 1e-2, "grad_norm": 2e-2, "leaf_mean": 5e-2, "leaf_max": 0.1,
                "update_share_off": 0.01}


def _cp_train_batch(cfg, T: int, B: int, seed: int = 0) -> dict:
    """B synthetic 704x1280 clips of T latent frames drawn on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    return {"x0": torch.randn((B, 16, T, 88, 160), generator=gen),
            "crossattn_emb": torch.randn((B, 512, 1024), generator=gen),
            "extra_channels": torch.randn((B, cfg.in_channels - 16, T, 88, 160), generator=gen)}


def _cp_train_run(cfg, groups, name: str, steps: int, T: int, B: int, sp: bool = False,
                  fsdp: bool = False) -> dict:
    """CP_TRAIN_BLOCKS of the 7B trained ``steps`` steps on ``_cp_train_batch``
    (the same net, batch and draws on every rank and in the one-rank
    reference): over ``groups`` through make_sharded_train_step (over a tp
    axis on the net cut to this rank's shards, as Trainer cuts it; sp:
    sequence parallelism), or on one device (groups None) through
    train_step. Per step s, loss, grad norm, peak GiB, launches, K4's by
    forward, routes and the collectives' bytes and host seconds; the
    CP_TRAIN_LEAVES' updates and first moments (CPU fp32; tp shards
    gathered, in CP_TRAIN_SAVE_RUNS by Trainer's save gather, whose seconds,
    bytes and growth of the card's peak it records). fsdp: the state cut
    over dp too (``shard_fsdp``, FSDP); "held" then counts the bytes of this
    rank's params, first and second moments and EMA of the cut leaves, and
    "whole" those of the one-device state."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.parallel import collectives
    from gen3c_tpu_torch.parallel.sharding import (
        gather_to_host,
        named_leaves,
        shard_fsdp,
        shard_params,
    )
    from gen3c_tpu_torch.training.train import build_net
    from gen3c_tpu_torch.training.train_step import (
        init_train_state,
        make_optimizer,
        make_sharded_train_step,
        train_step,
    )

    net = build_net(cfg, "cuda:0", seed=0)
    randomize_gates(net, torch.Generator(device="cuda:0").manual_seed(1))
    opt = make_optimizer(lr=CP_TRAIN_LR, warmup_steps=1)
    before = {n: p.detach().float().cpu() for n, p in net.named_parameters()
              if n in CP_TRAIN_LEAVES}
    whole = {n: p.numel() for n, p in net.named_parameters()}
    dims = {} if groups is None else shard_params(net, groups)
    cut = shard_fsdp(net, groups) if fsdp else {}
    state = init_train_state(net, opt)
    named = named_leaves(net)
    if groups is not None:
        step = make_sharded_train_step(groups, cfg, opt, remat=True, sequence_parallel=sp,
                                       fsdp_axis="dp" if fsdp else None)
    else:
        def step(st, b, rng):
            return train_step(st, b, rng, cfg, opt, remat=True)
    batch = {k: v.to("cuda:0") for k, v in _cp_train_batch(cfg, T, B).items()}
    rng = torch.Generator().manual_seed(0)
    out = {"run": name, "latent": [B, 16, T, 88, 160], "tokens": B * T * 88 * 160 // 4,
           "steps": []}
    for _ in range(steps):
        torch.cuda.synchronize()
        if groups is not None:
            torch.distributed.barrier()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        collectives.reset_traffic()
        t0 = time.perf_counter()
        state, m = step(state, batch, rng)
        torch.cuda.synchronize()
        out["steps"].append({
            "s": time.perf_counter() - t0, "loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"]),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": {k: v for k, v in kernels.launch_counts.items() if v},
            "k4_by_forward": dict(kernels.k4_launches_by_forward),
            "routes": dict(kernels.route_counts),
            "traffic": {op: dict(c) for op, c in collectives.traffic.items() if c["calls"]}})
    out["params"] = sum(p.numel() for p in named.values())  # this rank's
    if cut:
        sd = state.state_dict()
        parts = ("params", "mu", "nu", "ema")
        out["fsdp"] = {"leaves": len(cut), "whole_elements": sum(whole[n] for n in cut),
                       "held_elements": {part: sum(sd[part][n].numel() for n in cut)
                                         for part in parts},
                       "held_bytes": {part: sum(sd[part][n].numel() * sd[part][n].element_size()
                                                for n in cut) for part in parts}}
        del sd
    now = {n: named[n].detach() for n in CP_TRAIN_LEAVES}
    mu = {n: state.opt_state.mu[n] for n in CP_TRAIN_LEAVES}
    if (dims or cut) and name in CP_TRAIN_SAVE_RUNS:
        # Trainer._save's gather, kept on every rank here: the leaves come
        # from it. The card may grow by one gathered tensor and the
        # collective's own buffers: gloo's all-gather on CUDA tensors holds a
        # second full-size one beside the shard's contiguous copy (2.5 x the
        # largest on an H100 80GB HBM3 at 700 W); the whole state gathered at
        # once would be ~18 x (4.87 GB at 2 blocks)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        host = gather_to_host(state.state_dict(), dims, groups.tp, True, cut, groups.dp)
        torch.cuda.synchronize()
        sizes = [t.numel() * t.element_size() for part in ("params", "mu", "nu", "ema")
                 for n, t in host[part].items() if n in dims or n in cut]
        out["save"] = {"s": time.perf_counter() - t0,
                       "peak_growth_bytes": torch.cuda.max_memory_allocated() - base,
                       "bound_bytes": 3 * max(sizes),
                       "gathered_bytes": sum(sizes),
                       "host_bytes": sum(t.numel() * t.element_size()
                                         for part in ("params", "mu", "nu", "ema")
                                         for t in host[part].values())}
        now, mu = host["params"], host["mu"]
        del host
    elif dims or cut:
        now, mu = (gather_to_host(t, dims, groups.tp, True, cut, groups.dp) for t in (now, mu))
    out["leaves"] = {n: {"update": now[n].float().cpu() - before[n],
                         "mu": mu[n].float().cpu()} for n in CP_TRAIN_LEAVES}
    del state, net, named, batch, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ar_tp_train, in cp_train's ranks: the 4B AR model at full width (4,096 channels,
# 32 / 8 heads; 16 / 4 a rank at tp 2) on AR_TP_TRAIN_LAYERS of its 16 layers over
# the 12,800-token grid, AR_TP_TRAIN_STEPS AdamW steps with remat, held to one rank;
# one leaf of each kind: a column linear (rows), a row linear (columns), q's norm
# scale (a part a tp rank), the final norm (replicated) and the LM head's rows
# around the vocab's split (each rank's through the vocab-parallel cross entropy)
AR_TP_TRAIN_LAYERS = 2
AR_TP_TRAIN_STEPS = 2
AR_TP_TRAIN_LEAVES = ("layers.0.attention.wq.weight", "layers.1.feed_forward.w2.weight",
                      "layers.0.attention.q_norm.weight", "norm.weight", "output.weight")
AR_TP_HEAD_ROWS = slice(31_744, 32_256)  # output.weight's rows compared: 512 across the split


def _ar_tp_train_run(groups) -> dict:
    """The seeded 4B cut to AR_TP_TRAIN_LAYERS layers trained
    AR_TP_TRAIN_STEPS steps on one seeded 12,800-token sequence: over
    ``groups`` (tp) through make_sharded_ar_train_step on the model
    shard_ar_params cut to this rank's heads, or (groups None) one rank's
    ar_train_step. Per step s, loss, accuracy, grad norm, peak GiB, K8 and
    K8bwd launches, every collective's bytes and host seconds, and the loss's
    own in its forward (the vocab-parallel cross entropy's all-reduces; the
    recompute, which checkpoint stops early, counts among the rest); the
    AR_TP_TRAIN_LEAVES' updates and first moments (CPU
    fp32, gathered from the tp shards; the LM head's AR_TP_HEAD_ROWS)."""
    import dataclasses

    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.models.ar_transformer import ARTransformer
    from gen3c_tpu_torch.parallel import collectives, sharding
    from gen3c_tpu_torch.pipelines import autoregressive as ar
    from gen3c_tpu_torch.training import ar_train
    from gen3c_tpu_torch.training.train_step import AdamW

    cfg = dataclasses.replace(ar.AR_PRESETS["ar_4b"].ar, n_layers=AR_TP_TRAIN_LAYERS)
    model = ARTransformer(cfg, device="cuda:0").init_random(
        torch.Generator(device="cuda:0").manual_seed(7))
    tokens = torch.randint(0, cfg.vocab_size, (1, AR_TRAIN_TOKENS),
                           generator=torch.Generator().manual_seed(8)).to("cuda:0")

    def rows(n, t):
        return t[AR_TP_HEAD_ROWS] if n == "output.weight" else t

    before = {n: rows(n, p.detach().float().cpu()).clone() for n, p in model.named_parameters()
              if n in AR_TP_TRAIN_LEAVES}
    opt = AdamW(AR_TRAIN_LR)
    if groups is not None:
        sharding.shard_ar_params(model, groups)
        sharded_step = ar_train.make_sharded_ar_train_step(groups, opt)
    else:
        sharded_step = None
    named = sharding.named_leaves(model)
    state = opt.init(named)
    loss_traffic = {"calls": 0, "bytes": 0, "seconds": 0.0}
    terms = ar_train._vocab_parallel_terms

    def counted_terms(*args):  # the loss's collectives in the forward
        was = {k: sum(c[k] for c in collectives.traffic.values()) for k in loss_traffic}
        out = terms(*args)
        for k in loss_traffic:
            loss_traffic[k] += sum(c[k] for c in collectives.traffic.values()) - was[k]
        return out

    ar_train._vocab_parallel_terms = counted_terms
    out = {"layers": AR_TP_TRAIN_LAYERS, "tokens": AR_TRAIN_TOKENS, "steps": [],
           "q_heads_a_rank": model.layers[0].attention.wq.weight.shape[0] // cfg.head_dim,
           "kv_heads_a_rank": model.layers[0].attention.wk.weight.shape[0] // cfg.head_dim}
    try:
        for _ in range(AR_TP_TRAIN_STEPS):
            torch.cuda.synchronize()
            if groups is not None:
                torch.distributed.barrier()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            collectives.reset_traffic()
            loss_traffic.update(calls=0, bytes=0, seconds=0.0)
            t0 = time.perf_counter()
            if sharded_step is None:
                model, state, m = ar_train.ar_train_step(model, state, tokens, opt)
            else:
                model, state, m = sharded_step(model, state, tokens)
            torch.cuda.synchronize()
            out["steps"].append({
                "s": time.perf_counter() - t0, "loss": float(m["loss"]),
                "accuracy": float(m["accuracy"]), "grad_norm": float(m["grad_norm"]),
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                "launches": {k: kernels.launch_counts[k] for k in ("K8", "K8bwd")},
                "routes": dict(kernels.route_counts), "loss_traffic": dict(loss_traffic),
                "traffic": {op: dict(c) for op, c in collectives.traffic.items()
                            if c["calls"]}})
    finally:
        ar_train._vocab_parallel_terms = terms
    out["params"] = sum(p.numel() for p in named.values())  # this rank's
    now = {n: named[n].detach() for n in AR_TP_TRAIN_LEAVES}
    mu = {n: state.mu[n] for n in AR_TP_TRAIN_LEAVES}
    if groups is not None:
        dims = sharding.ar_sharded_leaves(model)
        now, mu = (sharding.gather_to_host(t, dims, groups.tp, True) for t in (now, mu))
    out["leaves"] = {n: {"update": rows(n, now[n].float().cpu()) - before[n],
                         "mu": rows(n, mu[n].float().cpu())} for n in AR_TP_TRAIN_LEAVES}
    del state, model, named, opt, tokens, now, mu
    gc.collect()
    torch.cuda.empty_cache()
    return out


def cp_train_worker(rank: int, port: int, out_dir: str) -> int:
    """One rank of the cp_train phase (torchrun's environment, gloo on
    cuda:0): each of CP_TRAIN_RUNS over its (dp, cp) mesh; its numbers to
    train_rank<r>.json and, rank 0, its leaves to train_<run>.pt."""
    import dataclasses

    from gen3c_tpu_torch.parallel import mesh
    from gen3c_tpu_torch.pipelines.factory import GEN3C_7B_PRESET

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(CP_RANKS),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.cuda.set_per_process_memory_fraction(CP_TRAIN_MEMORY_FRACTION, 0)
    torch.cuda.set_device(0)
    mesh.maybe_distributed_init("gloo", "cuda:0")
    cfg = dataclasses.replace(GEN3C_7B_PRESET.dit, num_blocks=CP_TRAIN_BLOCKS)
    out = {"rank": rank, "runs": {}}
    for name, dp, cp, tp, sp, steps, T, B in CP_TRAIN_RUNS:
        groups = mesh.make_groups(dp=dp, cp=cp, tp=tp, backend="gloo")
        res = _cp_train_run(cfg, groups, name, steps, T, B, sp, name in CP_TRAIN_FSDP)
        leaves = res.pop("leaves")
        if rank == 0:
            torch.save(leaves, os.path.join(out_dir, f"train_{name}.pt"))
        out["runs"][name] = {**res, "dp_rank": groups.dp.rank, "cp_rank": groups.cp.rank,
                             "tp_rank": groups.tp.rank}
    ar_tp = _ar_tp_train_run(mesh.make_groups(tp=CP_RANKS, backend="gloo"))
    leaves = ar_tp.pop("leaves")
    if rank == 0:
        torch.save(leaves, os.path.join(out_dir, "train_ar_tp.pt"))
    out["ar_tp_train"] = ar_tp
    with open(os.path.join(out_dir, f"train_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def _leaf_rel(got: torch.Tensor, ref: torch.Tensor) -> dict:
    d = (got - ref).abs()
    peak = ref.abs().max().clamp_min(1e-30)
    return {"rel_max": (d.max() / peak).item(),
            "rel_mean": (d.mean() / ref.abs().mean().clamp_min(1e-30)).item(),
            "share_off": (d > 0.1 * peak).float().mean().item()}


def phase_cp_train() -> dict:
    """Data-, context- and tensor-parallel training of the 7B at full width:
    K4 (and K1cp's forward with lse) at a Ulysses rank's shard, (1, 56,320,
    16, 128), held to the plain versions; then CP_RANKS ranks on the one
    card (cp_train_worker, gloo) train CP_TRAIN_BLOCKS blocks with
    make_sharded_train_step, CP_TRAIN_RUNS (cp 2 over one 121-frame clip,
    2 steps; dp 2 over two 8-latent-frame clips, 1 step; tp 2 over one
    8-latent-frame clip, 2 steps, and with sequence parallelism, 1 step:
    each rank its 16 heads and half of every block's linears), and the same
    net, batch and draws train in this one process: loss, grad norm and the
    CP_TRAIN_LEAVES' updates and first moments (gathered from the tp
    shards) held within CP_TRAIN_TOL; every rank's launches (K1cp or K1 2 x
    blocks a step under remat, K4 for each attention), s per step per rank,
    peak GiB, the collectives' bytes and host seconds; in CP_TRAIN_SAVE_RUN
    the card's peak during the checkpoint gather grown by no more than 3 x
    its largest gathered tensor (one tensor at a time). The ranks share the
    card and gloo passes through host memory: no time here is a multi-card
    time."""
    import dataclasses as dc

    from gen3c_tpu_torch.pipelines.factory import GEN3C_7B_PRESET

    gen = torch.Generator(device="cuda").manual_seed(23)
    heads = GEN3C_7B_PRESET.dit.num_heads // CP_RANKS
    shard = (1, LATENT_T_7B * 88 * 160 // 4, heads, 128)
    k4 = _k4_case(f"K4 cp training shard (cp={CP_RANKS}: {heads} heads)", shard, shard,
                  torch.bfloat16, gen)
    gc.collect()
    torch.cuda.empty_cache()
    os.makedirs(OUT_DIR, exist_ok=True)
    out_dir = tempfile.mkdtemp(dir=OUT_DIR, prefix="cp_train_")
    codes, wall_s, tails = _spawn_ranks("--cp-train-rank", CP_RANKS, out_dir,
                                        CP_TRAIN_TIMEOUT_S)
    if any(codes):
        raise AssertionError(f"cp_train: ranks exited {codes} after {wall_s:.0f} s:\n"
                             + "\n----\n".join(tails))
    ranks = [json.load(open(os.path.join(out_dir, f"train_rank{r}.json")))
             for r in range(CP_RANKS)]
    cfg = dc.replace(GEN3C_7B_PRESET.dit, num_blocks=CP_TRAIN_BLOCKS)
    res = {"model": "gen3c_7b", "blocks": CP_TRAIN_BLOCKS, "channels": cfg.model_channels,
           "heads": cfg.num_heads, "head_dim": cfg.head_dim, "dtype": str(cfg.dtype),
           "ranks": CP_RANKS, "backend": "gloo", "wall_s": wall_s, "k4_case": {
               k: k4[k] for k in ("q", "ms", "fwd_lse_ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "max_abs_err", "bound_share")},
           "note": "both ranks share one card and their collectives go through host memory "
                   "(gloo): no time here is a multi-card time", "runs": {}}
    bad = []
    ones = {}  # the one-rank step of each (steps, T, B): fsdp2 trains dp2's
    for name, dp, cp, tp, sp, steps, T, B in CP_TRAIN_RUNS:
        if (steps, T, B) not in ones:
            ones[(steps, T, B)] = _cp_train_run(cfg, None, name, steps, T, B)
        one = copy.deepcopy(ones[(steps, T, B)])
        got_leaves = torch.load(os.path.join(out_dir, f"train_{name}.pt"), weights_only=True)
        runs = [r["runs"][name] for r in ranks]
        rel = [{k: abs(st[k] - ref[k]) / abs(ref[k]) for k in ("loss", "grad_norm")}
               for st, ref in zip(runs[0]["steps"], one["steps"])]
        leaves = {}
        for n, ref in one["leaves"].items():
            leaves[n] = {"mu": _leaf_rel(got_leaves[n]["mu"], ref["mu"])}
            if ref["update"].abs().max() > 0:
                leaves[n]["update"] = _leaf_rel(got_leaves[n]["update"], ref["update"])
        one_leaves = one.pop("leaves")
        del got_leaves, one_leaves
        run = {"dp": dp, "cp": cp, "tp": tp, "sequence_parallel": sp, "ranks": runs,
               "one_rank": one, "rel": rel, "leaves": leaves, "tol": CP_TRAIN_TOL}
        res["runs"][name] = run
        for r, rk in enumerate(runs):
            if any(abs(st[k] - rs[k]) > 1e-6 * abs(rs[k]) for st, rs in zip(rk["steps"],
                                                                              runs[0]["steps"])
                   for k in ("loss", "grad_norm")):
                bad.append(f"{name}: rank {r}'s loss or grad norm differs from rank 0's")
        if any(v > CP_TRAIN_TOL[k] for st in rel for k, v in st.items()):
            bad.append(f"{name}: loss / grad norm off the one-rank step {rel}")
        for n, lv in leaves.items():
            mu, up = lv["mu"], lv.get("update")
            if mu["rel_max"] > CP_TRAIN_TOL["leaf_max"] or mu["rel_mean"] > CP_TRAIN_TOL[
                    "leaf_mean"] or (up is not None and (
                        up["rel_mean"] > CP_TRAIN_TOL["leaf_mean"]
                        or up["share_off"] > CP_TRAIN_TOL["update_share_off"])):
                bad.append(f"{name}: leaf {n} off the one-rank step {lv}")
        nb = CP_TRAIN_BLOCKS
        self_id = "K1cp" if cp > 1 else "K1"
        for rk in runs:
            for st in rk["steps"]:
                la, by = st["launches"], st["k4_by_forward"]
                if la.get(self_id) != 2 * nb or la.get("K4") != 2 * nb or by[self_id] != nb \
                        or by["K2"] != nb or st["routes"]["mma_sync"]:
                    bad.append(f"{name}: a step launched {la}, K4 by forward {by}, "
                               f"routes {st['routes']}")
        for st in one["steps"]:
            if not (math.isfinite(st["loss"]) and st["grad_norm"] > 0):
                bad.append(f"{name}: the one-rank step gave {st}")
        if name in CP_TRAIN_SAVE_RUNS:
            for r, rk in enumerate(runs):
                sv = rk.get("save")
                if sv is None or sv["peak_growth_bytes"] > sv["bound_bytes"]:
                    bad.append(f"{name}: rank {r}'s save gather grew the card by more than "
                               f"3 x its largest gathered tensor: {sv}")
        if name in CP_TRAIN_FSDP:  # each rank holds exactly its 1/dp of the cut leaves
            for r, rk in enumerate(runs):
                fs = rk.get("fsdp")
                if fs is None or fs["whole_elements"] % dp or any(
                        v != fs["whole_elements"] // dp for v in fs["held_elements"].values()):
                    bad.append(f"{name}: rank {r} holds {fs} of the cut leaves, not 1/{dp}")
        if tp > 1 and not all(rk["params"] < one["params"] for rk in runs):
            bad.append(f"{name}: a rank holds {[rk['params'] for rk in runs]} parameters, "
                       f"one rank {one['params']}: the linears were not sharded")
    ar_res = _check_ar_tp_train(ranks, out_dir)
    shutil.rmtree(out_dir, ignore_errors=True)
    emit("cp_train", **res)
    emit("ar_tp_train", **ar_res)
    bad += ar_res.pop("bad")
    res["ar_tp_train"] = ar_res
    if bad:
        raise AssertionError(f"cp_train: {bad}: {res}")
    res["k4"] = k4
    return res


def _leaf_rels(got: dict, ref: dict) -> dict:
    """_leaf_rel of each leaf's first moment and (where it moved) update."""
    return {n: {"mu": _leaf_rel(got[n]["mu"], r["mu"]),
                **({"update": _leaf_rel(got[n]["update"], r["update"])}
                   if r["update"].abs().max() > 0 else {})} for n, r in ref.items()}


def _check_ar_tp_train(ranks: list, out_dir: str) -> dict:
    """ar_tp_train of cp_train's ranks against the same 4B cut, sequence
    and steps in this one process: loss and grad norm a step, the leaves'
    updates and first moments within CP_TRAIN_TOL (as cp_train's runs), or
    within CP_NOISE_FACTOR times the one rank's own noise floor where that
    is wider: the one rank again with its row-parallel sums halved in bf16
    (``_halved_row_sums``, ar_tp's floor: tp 2's arithmetic without the
    parallel code). The 4B's logits are rounded to bf16 (as gen3c_tpu's)
    and the softmax over 64,000 entries turns a logit's last bit into ~1%
    of every gradient element, which AdamW's sign-like first steps turn
    into a flipped step where |g| is below it. Every rank the same loss
    and grad norm, its 16 / 4 heads and fewer parameters than one rank; K8
    2 x layers (the forward and remat's) and K8bwd once a layer, a step a
    rank. The numbers, "bad": what failed."""
    import gen3c_tpu_torch.models.ar_transformer as tar

    runs = [r["ar_tp_train"] for r in ranks]
    got = torch.load(os.path.join(out_dir, "train_ar_tp.pt"), weights_only=True)
    one = _ar_tp_train_run(None)
    ref = one.pop("leaves")
    with _halved_row_sums(tar):
        floor_run = _ar_tp_train_run(None)
    floor = {"rel": [{k: abs(st[k] - rs[k]) / abs(rs[k]) for k in ("loss", "grad_norm")}
                     for st, rs in zip(floor_run["steps"], one["steps"])],
             "leaves": _leaf_rels(floor_run.pop("leaves"), ref)}
    rel = [{k: abs(st[k] - rs[k]) / abs(rs[k]) for k in ("loss", "grad_norm")}
           for st, rs in zip(runs[0]["steps"], one["steps"])]
    leaves = _leaf_rels(got, ref)
    del got, ref

    def bound(key: str, floor_value: float) -> float:
        return max(CP_TRAIN_TOL[key], CP_NOISE_FACTOR * floor_value)

    res = {"model": "ar_4b", "layers": AR_TP_TRAIN_LAYERS, "tokens": AR_TRAIN_TOKENS, "tp": 2,
           "ranks": runs, "one_rank": one, "rel": rel, "leaves": leaves, "floor": floor,
           "tol": CP_TRAIN_TOL, "noise_factor": CP_NOISE_FACTOR,
           "note": "both ranks share one card and their collectives go through host memory "
                   "(gloo): no time here is a multi-card time"}
    bad = []
    if any(v > bound(k, fs[k]) for st, fs in zip(rel, floor["rel"]) for k, v in st.items()):
        bad.append(f"ar_tp_train: loss / grad norm off the one-rank step {rel}, floor "
                   f"{floor['rel']}")
    for n, lv in leaves.items():
        mu, up = lv["mu"], lv.get("update")
        fmu, fup = floor["leaves"][n]["mu"], floor["leaves"][n].get("update", {})
        if mu["rel_max"] > bound("leaf_max", fmu["rel_max"]) \
                or mu["rel_mean"] > bound("leaf_mean", fmu["rel_mean"]) \
                or (up is not None and (
                    up["rel_mean"] > bound("leaf_mean", fup.get("rel_mean", 0.0))
                    or up["share_off"] > bound("update_share_off", fup.get("share_off", 0.0)))):
            bad.append(f"ar_tp_train: leaf {n} off the one-rank step {lv}, floor "
                       f"{floor['leaves'][n]}")
    want = {"K8": 2 * AR_TP_TRAIN_LAYERS, "K8bwd": AR_TP_TRAIN_LAYERS}
    for r, rk in enumerate(runs):
        if any(abs(st[k] - rs[k]) > 1e-6 * abs(rs[k]) for st, rs in zip(rk["steps"],
                                                                          runs[0]["steps"])
               for k in ("loss", "grad_norm")):
            bad.append(f"ar_tp_train: rank {r}'s loss or grad norm differs from rank 0's")
        if (rk["q_heads_a_rank"], rk["kv_heads_a_rank"]) != (16, 4) \
                or rk["params"] >= one["params"]:
            bad.append(f"ar_tp_train: rank {r} ran {rk['q_heads_a_rank']} / "
                       f"{rk['kv_heads_a_rank']} heads, held {rk['params']} parameters")
        for st in rk["steps"]:
            if st["launches"] != want or not (math.isfinite(st["loss"])
                                              and st["grad_norm"] > 0):
                bad.append(f"ar_tp_train: rank {r}'s step {st['launches']} (want {want}), "
                           f"loss {st['loss']}, grad norm {st['grad_norm']}")
    res["bad"] = bad
    return res


def phase_main(model, preset, build_s: float) -> dict:
    from gen3c_tpu_torch import kernels

    cfg = preset.dit
    n_params = sum(p.numel() for p in model.net.parameters())

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    video, pipeline, timings = _run_chain(model, preset, "cuda", num_frames=121,
                                          num_steps=MAIN_STEPS, seed=0)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    routes = dict(kernels.route_counts)
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
        "routes": routes, "latents_finite": bool(torch.isfinite(samples).all().item()),
        "latent_std": samples.float().std().item(),
    }
    emit("main_path", **res)
    require_wgmma("main path", routes)
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
    res["samples"] = samples.float().cpu().numpy()  # the cp phase's 28-block reference
    del pipeline, samples
    torch.cuda.empty_cache()
    return res


def _dynamic_clip(path: str, preset, seed: int = 0) -> None:
    """A seeded packaged clip of one chunk: the seed image panning 2 pixels
    a frame over a depth whose discs and railing (``_foreground_depth``)
    move 2 pixels a frame, filmed by a static camera."""
    from gen3c_tpu_torch.pipelines.depth import default_intrinsics

    h, w, n = preset.height, preset.width, preset.chunk_size
    base = _seed_image(h, w, seed)[0, :, 0].astype(np.float16)
    image = np.stack([np.roll(base, 2 * i, axis=2) for i in range(n)])
    depth = np.stack([_foreground_depth(h, w, seed, shift=2.0 * i).cpu().numpy()
                      for i in range(n)])[:, None]
    np.savez(path, image=image, depth=depth,
             w2c=np.repeat(np.eye(4, dtype=np.float32)[None], n, 0),
             intrinsics=np.repeat(default_intrinsics(h, w)[None], n, 0))


def phase_dynamic(model, preset) -> dict:
    """The gen3c_dynamic CLI's entry point on a packaged 121-frame clip with
    foreground masking, then the chunk's buffers rendered again without and
    with masking (render seconds, the fraction of splatted pixels culled)."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.pipelines import gen3c_dynamic

    n = preset.chunk_size
    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as root:
        t0 = time.perf_counter()
        _dynamic_clip(os.path.join(root, "clip.npz"), preset)
        clip_s = time.perf_counter() - t0
        argv = ["--input_video_path", os.path.join(root, "clip.npz"), "--model_preset", preset.name,
                "--num_video_frames", str(n), "--num_steps", str(DYNAMIC_STEPS),
                "--trajectory", "left", "--video_save_folder", root, "--device", "cuda"]
        args = gen3c_dynamic.create_parser().parse_args(argv + ["--foreground_masking"])
        record = {}
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with _depth(model.net, DYNAMIC_BLOCKS):
            path = gen3c_dynamic.demo(args, built=(model, preset), record=record)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = dict(kernels.launch_counts)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        saved = os.path.getsize(path) if os.path.isfile(path) else 0
        renders = {}
        for masking in (False, True):
            cache, w2cs, ks, _ = gen3c_dynamic.load_scene(
                gen3c_dynamic.create_parser().parse_args(
                    argv + (["--foreground_masking"] if masking else [])), preset,
                torch.device("cuda"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, masks = cache.render_cache(w2cs, ks, start_frame_idx=0)
            torch.cuda.synchronize()
            renders[masking] = (time.perf_counter() - t0, masks > 0)
            del cache, masks
        known, kept = renders[False][1], renders[True][1]
        pipe = record["pipeline"]
        res = {"model": preset.name, "frames": n, "steps": DYNAMIC_STEPS, "clip_s": clip_s,
               "render_s": record["render"], "render_unmasked_s": renders[False][0],
               "render_masked_s": renders[True][0],
               "culled_fraction": ((known & ~kept).sum() / known.sum()).item(),
               "known_fraction": known.float().mean().item(),
               "encode_condition_s": pipe["encode_condition"], "encode_warps_s": pipe["encode_warps"],
               "denoise_step_s": [st["seconds"] for st in pipe["denoise_steps"]],
               "decode_s": pipe["decode"], "total_s": total_s, "peak_mem_gib": peak,
               "launches": launches, "saved": [os.path.basename(path), saved],
               "video_shape": list(record["video"].shape)}
        del known, kept, renders
    emit("dynamic", **res)
    if res["video_shape"] != [n, preset.height, preset.width, 3] or not saved:
        raise AssertionError(f"dynamic: video {res['video_shape']}, {saved} bytes saved")
    missing = [k for k in ("K1", "K2", "K5", "K6") if launches[k] == 0]
    if missing or launches["K6"] != n or not res["culled_fraction"] > 0:
        raise AssertionError(f"dynamic: launches {launches} (K6 {n} expected), "
                             f"culled {res['culled_fraction']}: {res}")
    torch.cuda.empty_cache()
    return res


def _multiview_npz(path: str, preset, seed: int = 1) -> None:
    """MULTIVIEW_KEY_FRAMES seeded key frames of one scene (the depth of
    ``_foreground_depth``) from cameras 0.1 apart, and the trajectory: one
    chunk moving left from the first key frame's camera."""
    from gen3c_tpu_torch.ops.camera import generate_camera_trajectory
    from gen3c_tpu_torch.pipelines.depth import default_intrinsics

    h, w, n, keys = preset.height, preset.width, preset.chunk_size, MULTIVIEW_KEY_FRAMES
    k = default_intrinsics(h, w)
    w2c = np.repeat(np.eye(4, dtype=np.float32)[None], keys, 0)
    w2c[:, 0, 3] = [0.0, 0.1, -0.1, 0.2]
    w2cs, ks = generate_camera_trajectory("left", np.eye(4, dtype=np.float32), k, n, 0.3,
                                          "center_facing", 1.0)
    depth = _foreground_depth(h, w, seed).cpu().numpy()
    np.savez(path, images_key_frames=np.concatenate([_seed_image(h, w, seed + i)[:, :, 0]
                                                     for i in range(keys)]),
             depth_key_frames=np.repeat(depth[None, None], keys, 0),
             K_key_frames=np.repeat(k[None], keys, 0), w2cs_key_frames=w2c,
             w2cs_all=np.asarray(w2cs, np.float32).reshape(n, 4, 4),
             Ks_all=np.asarray(ks, np.float32).reshape(n, 3, 3))


def phase_multiview(model, preset) -> dict:
    """The gen3c_multiview CLI's entry point: 4 key frames, the top 2
    buffers by rendered overlap, foreground masking, one chunk."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.pipelines import gen3c_multiview

    n = preset.chunk_size
    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as root:
        _multiview_npz(os.path.join(root, "mv.npz"), preset)
        args = gen3c_multiview.create_parser().parse_args(
            ["--npz_path", os.path.join(root, "mv.npz"), "--model_preset", preset.name,
             "--num_video_frames", str(n), "--num_steps", str(MULTIVIEW_STEPS),
             "--frame_buffer_max", "2", "--foreground_masking", "--video_save_folder", root,
             "--device", "cuda"])
        record = {}
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with _depth(model.net, DYNAMIC_BLOCKS):
            path = gen3c_multiview.demo(args, built=(model, preset), record=record)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = dict(kernels.launch_counts)
        saved = os.path.getsize(path) if os.path.isfile(path) else 0
    pipe = record["pipeline"]
    res = {"model": preset.name, "key_frames": MULTIVIEW_KEY_FRAMES, "frame_buffer_max": 2,
           "frames": n, "steps": MULTIVIEW_STEPS, "selections": record["selections"],
           "render_s": record["render"], "encode_warps_s": pipe["encode_warps"],
           "denoise_step_s": [st["seconds"] for st in pipe["denoise_steps"]],
           "decode_s": pipe["decode"], "total_s": total_s,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "launches": launches,
           "saved": [os.path.basename(path), saved], "video_shape": list(record["video"].shape)}
    emit("multiview", **res)
    if res["video_shape"] != [n, preset.height, preset.width, 3] or not saved:
        raise AssertionError(f"multiview: video {res['video_shape']}, {saved} bytes saved")
    if (len(res["selections"]) != 1 or len(res["selections"][0]) != 2
            or any(launches[k] == 0 for k in ("K1", "K2", "K5", "K6"))):
        raise AssertionError(f"multiview: {res}")
    torch.cuda.empty_cache()
    return res


FAST_STEPS = 8
# of 28: the depth the fast chunk runs at, after all 28 blocks are quantized (the
# step pattern, the launches and the video do not depend on it; 14 paid for the
# cp phase's tensor-parallel runs, 7 for serving_cp2 and ar_tp_train)
FAST_BLOCKS = 7
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
    with _depth(model.net, FAST_BLOCKS):
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
    randomize_gates(cpu, torch.Generator().manual_seed(3))
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


def phase_chain() -> dict:
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.pipelines.factory import build_gen3c_model

    cpu_model, preset = build_gen3c_model("gen3c_tiny", device="cpu", seed=0)
    randomize_gates(cpu_model.net, torch.Generator().manual_seed(1))
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


SERVING_FRAMES = 241  # two chunks
SERVING_BLOCKS = 1  # of 28 (4 before serving_cp2): the served 7B's depth (its width is the 7B's)
SERVING_POLL_S = 0.25
SERVING_TIMEOUT_S = 600  # each wait for a job's state


def _http(method: str, url: str, body: Optional[bytes] = None):
    """(status, body) of one request; an HTTP error status is returned."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=SERVING_TIMEOUT_S) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _serving_path(n: int, h: int, w: int, scale: float) -> dict:
    """The smoke's "left" path (_run_chain's: 0.3 of the centre's depth) as
    an InferenceRequest's cameras, centred on the seeded scene (``scale``:
    its median depth, as a client authors a path in the scene it sees):
    c2ws and focal lengths from the trajectory, K of a 0.8 * w focal, the
    seed's."""
    from gen3c_tpu_torch.ops.camera import generate_camera_trajectory

    k = np.array([[0.8 * w, 0, w / 2], [0, 0.8 * w, h / 2], [0, 0, 1]], np.float32)
    w2cs, ks = generate_camera_trajectory("left", np.eye(4, dtype=np.float32), k, n, 0.3,
                                          "center_facing", scale)
    ks = ks[0].numpy()
    return {"cameras_to_world": np.linalg.inv(w2cs[0].numpy())[:, :3].astype(np.float32),
            "focal_lengths": np.stack([ks[:, 0, 0], ks[:, 1, 1]], 1).astype(np.float32),
            "principal_points": np.full((n, 2), 0.5, np.float32),
            "resolutions": np.tile([[w, h]], (n, 1))}


def phase_serving() -> dict:
    """The inference server around the 7B (phase 19 of the docstring). Job
    A's frames, the noise floor of its frames and the seeded MoGe checkpoint
    stay for serving_cp2 (``frames_a``, ``noise``, ``moge_dir``: the caller
    removes the directory)."""
    import threading

    from PIL import Image

    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.aux import moge
    from gen3c_tpu_torch.pipelines.depth import make_depth_estimator
    from gen3c_tpu_torch.scripts.time_main_path import seeded_moge_params
    from gen3c_tpu_torch.serving.api_types import InferenceRequest, SeedingRequest
    from gen3c_tpu_torch.serving.encoding import CompressionFormat, compress_images
    from gen3c_tpu_torch.serving.serialization import dumps_api_message, loads_api_message
    from gen3c_tpu_torch.serving.server import serve

    tmp = tempfile.mkdtemp(prefix="smoke_serving_")
    saved_env = os.environ.get("GEN3C_MOGE_CHECKPOINT")
    server = service = model = None
    try:
        os.environ["GEN3C_MOGE_CHECKPOINT"] = os.path.join(tmp, "missing.pt")
        try:
            make_depth_estimator("moge_jax", device="cuda")
            raise AssertionError("serving: moge_jax without its checkpoint did not raise")
        except FileNotFoundError:
            pass
        ckpt = os.path.join(tmp, "moge.pt")
        torch.save({k: v.cpu() for k, v in
                    seeded_moge_params(moge.MOGE_VITL, 0, "cuda").items()}, ckpt)
        os.environ["GEN3C_MOGE_CHECKPOINT"] = ckpt
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = _served_7b(device="cuda")
        torch.cuda.synchronize()
        ready_s = time.perf_counter() - t0
        h, w, chunk = model.preset.height, model.preset.width, model.model.chunk_size
        server, service = serve(host="127.0.0.1", port=0, model=model)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{server.server_address[1]}"

        def status(rid: str) -> dict:
            code, body = _http("GET", f"{base}/job-status?request_id={rid}")
            if code != 200:
                raise AssertionError(f"serving: job-status {rid}: {code} {body[:200]}")
            st = json.loads(body)
            if st["state"] == "error":
                raise AssertionError(f"serving: job {rid} failed: {st}")
            return st

        def submit(rid: str, n: int) -> None:
            req = InferenceRequest(request_id=rid, **_serving_path(n, h, w, scale))
            code, body = _http("POST", f"{base}/request-inference", dumps_api_message(req))
            if code != 202:
                raise AssertionError(f"serving: request-inference {rid}: {code} {body[:200]}")

        def wait(rid: str, states: tuple, on_poll=None) -> dict:
            t_end = time.perf_counter() + SERVING_TIMEOUT_S
            while time.perf_counter() < t_end:
                st = status(rid)
                if on_poll is not None:
                    on_poll(st)
                if st["state"] in states:
                    return st
                time.sleep(SERVING_POLL_S)
            raise AssertionError(f"serving: job {rid} never reached {states}: {st}")

        kernels.reset_launch_counts()
        image = ((_seed_image(h, w, 5)[0, :, 0].transpose(1, 2, 0) + 1) * 127.5).round()
        seed = SeedingRequest(request_id="seed", images=image.astype(np.uint8)[None],
                              cameras_to_world=np.eye(4, dtype=np.float32)[:3][None],
                              focal_lengths=np.full((1, 2), 0.8 * w, np.float32),
                              principal_points=np.full((1, 2), 0.5, np.float32))
        t0 = time.perf_counter()
        code, body = _http("POST", f"{base}/seed-model", dumps_api_message(seed))
        seed_s = time.perf_counter() - t0
        if code != 200:
            raise AssertionError(f"serving: seed-model: {code} {body[:500]}")
        seeded = loads_api_message(body)
        seed_launches = dict(kernels.launch_counts)
        scale = float(np.median(seeded.depths))

        # A runs; B waits behind it and is cancelled there
        t_a = time.perf_counter()
        submit("A", SERVING_FRAMES)
        submit("B", SERVING_FRAMES)
        code, _ = _http("POST", f"{base}/cancel-inference?request_id=B")
        if code != 200 or status("B")["state"] != "cancelled":
            raise AssertionError(f"serving: B not cancelled while pending: {code}")
        partial = {}

        def see_partial(st):
            if st["state"] == "running" and st["frames_done"] and "frames" not in partial:
                t0 = time.perf_counter()
                code, body = _http("GET", f"{base}/inference-result?request_id=A&partial=1")
                if code == 206:
                    part = loads_api_message(body)
                    # the raw frames' JSON is built and parsed in this process,
                    # beside the worker's chain
                    partial.update(frames=len(part.images), shape=list(part.images.shape),
                                   frames_done=st["frames_done"], bytes=len(body),
                                   seen_after_s=t0 - t_a, fetch_s=time.perf_counter() - t0)

        done = wait("A", ("done", "cancelled"), see_partial)
        generate_a_s = time.perf_counter() - t_a
        timings_a = model.last_timings
        t0 = time.perf_counter()
        code, body = _http("GET", f"{base}/inference-result?request_id=A&format=jpg")
        fetch_transfer_s = time.perf_counter() - t0
        if code != 200:
            raise AssertionError(f"serving: inference-result A: {code} {body[:200]}")
        fetch_bytes = len(body)
        result = loads_api_message(body)
        frames = np.stack([np.asarray(Image.open(io.BytesIO(b)).convert("RGB"))
                           for b in result.images_compressed])
        fetch_s = time.perf_counter() - t0
        # the fetched last frame is the JPEG of the model's last frame, byte
        # for byte (the same encoder on the same frame)
        last_jpg = compress_images(model.get_latest_rgb()[None].astype(np.float32) / 255.0,
                                   CompressionFormat.JPG)[0]
        last_equal = result.images_compressed[-1] == last_jpg

        # C is cancelled while its first chunk runs
        t_c = time.perf_counter()
        submit("C", SERVING_FRAMES)
        wait("C", ("running",))
        code, _ = _http("POST", f"{base}/cancel-inference?request_id=C")
        cancel_sent_s = time.perf_counter() - t_c
        cancelled = wait("C", ("cancelled", "done"))
        cancel_s = time.perf_counter() - t_c
        chunks_c = len(model.last_timings["generate"])
        b_state = status("B")

        t0 = time.perf_counter()
        code, body = _http("POST", f"{base}/render-preview",
                           dumps_api_message(InferenceRequest(
                               request_id="P", **_serving_path(5, h, w, scale))))
        preview_s = time.perf_counter() - t0
        if code != 200:
            raise AssertionError(f"serving: render-preview: {code} {body[:200]}")
        preview = loads_api_message(body).images
        launches = dict(kernels.launch_counts)
        code, body = _http("GET", f"{base}/metadata")
        meta = json.loads(body)
        frames_a = service.results["A"].images
        noise = _serving_noise(model, seed, _serving_path(SERVING_FRAMES, h, w, scale), frames_a)
        res = {
            "model": model.preset.name, "steps": MAIN_STEPS, "depth": "moge_jax (ViT-L, seeded)",
            "blocks": SERVING_BLOCKS, "noise": noise,
            "model_ready_s": ready_s, "seed_request_s": seed_s,
            "seed_depth_shape": list(seeded.depths.shape), "seed_depth_median": scale,
            "job_a": {"frames": SERVING_FRAMES, "state": done["state"], "wall_s": generate_a_s,
                      "generate_s": timings_a["generate"], "render_s": timings_a["render"],
                      "depth_s": timings_a["depth"], "update_s": timings_a["update"],
                      "chain_s": sum(timings_a["render"][1:]) + sum(timings_a["update"]),
                      "denoise_step_s": [[s["seconds"] for s in p["denoise_steps"]]
                                         for p in timings_a["pipeline"]],
                      "partial": partial, "fetch_s": fetch_s,
                      "fetch_transfer_s": fetch_transfer_s, "fetch_bytes": fetch_bytes,
                      "jpeg_bytes": sum(len(b) for b in result.images_compressed),
                      "fetched_shape": list(frames.shape), "last_frame_jpg_equal": last_equal,
                      "frames_std": float(frames.std())},
            "job_b": b_state,
            "job_c": {"state": cancelled["state"], "frames_done": cancelled["frames_done"],
                      "progress": cancelled["progress"], "chunks_run": chunks_c,
                      "cancel_sent_after_s": cancel_sent_s, "cancelled_after_s": cancel_s},
            "preview_s": preview_s, "preview_shape": list(preview.shape),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "seed_launches": seed_launches, "launches": launches, "metadata": meta,
        }
        emit("serving", **res)
        want = SERVING_BLOCKS * MAIN_STEPS * 3  # A's two chunks and C's one
        bad = []
        if done["state"] != "done" or frames.shape != (SERVING_FRAMES, h, w, 3) \
                or frames.dtype != np.uint8:
            bad.append(f"job A {done['state']}, fetched {frames.shape} {frames.dtype}")
        if partial.get("frames") != chunk or partial.get("shape") != [chunk, h, w, 3]:
            bad.append(f"job A's partial {partial}")
        if not last_equal or frames.std() == 0:
            bad.append(f"job A's frames: last JPEG equal {last_equal}, std {frames.std()}")
        if b_state["state"] != "cancelled" or b_state["frames_done"]:
            bad.append(f"job B {b_state}")
        if cancelled["state"] != "cancelled" or cancelled["frames_done"] != chunk or chunks_c != 1:
            bad.append(f"job C {cancelled}, {chunks_c} chunks")
        if preview.shape != (5, h, w, 3) or not preview.any():
            bad.append(f"preview {preview.shape}")
        if not meta.get("seeded") or meta.get("chunk_size") != chunk:
            bad.append(f"metadata {meta}")
        if launches["K1"] != want or launches["K2"] != want or launches["K5"] == 0 \
                or launches["K1vit"] != 24 * 2 or seed_launches["K1vit"] != 24:
            bad.append(f"launches {launches} (K1 = K2 = {want}, K1vit 48, K5 > 0)")
        if bad:
            raise AssertionError(f"serving: {bad}")
        return {**res, "frames_a": frames_a, "moge_dir": tmp}
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
            service.shutdown()
            service.worker.join(timeout=SERVING_TIMEOUT_S)
        # the next phase needs the card: the handler class, the service and
        # its worker hold the model
        server = service = model = None
        gc.collect()
        torch.cuda.empty_cache()
        if saved_env is None:
            os.environ.pop("GEN3C_MOGE_CHECKPOINT", None)
        else:
            os.environ["GEN3C_MOGE_CHECKPOINT"] = saved_env


def _serving_noise(model, seed, path: dict, frames: np.ndarray) -> dict:
    """The bf16 noise floor of served frames: job A's request again from a
    fresh seed (A ran right after seeding), on the same process with its DiT
    called one sample at a time (``_OneSampleAtATime``, the cp phase's
    floor), against A's frames."""
    from gen3c_tpu_torch.serving.api_types import InferenceRequest

    net = model.model.net
    model.seed_model(seed)
    model.model.net = _OneSampleAtATime(net)
    try:
        again = model.run_inference(InferenceRequest(request_id="noise", **path)).images
    finally:
        model.model.net = net
    return _rel_diff(again.astype(np.float32), frames.astype(np.float32))


# serving_cp2: the served 7B (full width, SERVING_BLOCKS blocks, seeded MoGe) over
# two ranks on the one card, context-parallel (Ulysses), gloo for the DiT and the
# channel; rank 0 serves HTTP, rank 1 follows
SERVING_CP2_RANKS = 2
SERVING_CP2_MEMORY_FRACTION = 0.45
SERVING_CP2_TIMEOUT_S = 420  # the two ranks, together


def _served_7b(**kw):
    """serving's model: the 7B's seeds, its gates randomized from seed 1,
    cut to its first SERVING_BLOCKS blocks, MoGe depth (GEN3C_MOGE_CHECKPOINT)."""
    from gen3c_tpu_torch.serving.models import Gen3cPersistentModel

    model = Gen3cPersistentModel("gen3c_7b", checkpoint_dir=None, num_steps=MAIN_STEPS,
                                 depth_source="moge_jax", **kw)
    randomize_gates(model.model.net, torch.Generator(device=model.device).manual_seed(1))
    for name in list(model.model.net.blocks)[SERVING_BLOCKS:]:  # the full width, cut depth
        del model.model.net.blocks[name]
    gc.collect()
    torch.cuda.empty_cache()
    return model


def _recording_runs(model, runs: list, frames: dict) -> None:
    """Wrap ``model._run_inference`` (every rank's inference, rank 0's and a
    follower's alike): each call's chunks, denoise-step seconds, launches,
    collective traffic and peak GiB appended to ``runs``, its frames to
    ``frames`` by request id."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.pipelines.chunked import GenerationCancelled
    from gen3c_tpu_torch.parallel import collectives

    run = model._run_inference

    def recorded(req, *args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        collectives.reset_traffic()
        t0 = time.perf_counter()
        outcome = "done"
        try:
            result = run(req, *args, **kwargs)
            frames[req.request_id] = result.images
            return result
        except GenerationCancelled:
            outcome = "cancelled"
            raise
        finally:
            torch.cuda.synchronize()
            tm = model.last_timings
            runs.append({"request_id": req.request_id, "outcome": outcome,
                         "s": time.perf_counter() - t0, "chunks": len(tm.get("generate", [])),
                         "step_s": [[st["seconds"] for st in pl["denoise_steps"]]
                                    for pl in tm.get("pipeline", [])],
                         "generate_s": tm.get("generate", []), "update_s": tm.get("update", []),
                         "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                         "launches": {k: v for k, v in kernels.launch_counts.items() if v},
                         "traffic": {op: dict(c) for op, c in collectives.traffic.items()
                                     if c["calls"]}})

    model._run_inference = recorded


def serving_cp2_worker(rank: int, port: int, out_dir: str) -> int:
    """One rank of serving_cp2 (torchrun's environment, gloo on cuda:0):
    the served 7B through Gen3cPersistentModel(num_devices=2, parallel="cp",
    cp_attn="ulysses"); rank 0 serves it on 127.0.0.1 and drives it over
    HTTP (seed, job A of SERVING_FRAMES frames fetched as JPEGs, job C
    cancelled while its first chunk runs), then stops the server, which
    sends "stop"; rank 1 follows. Each rank's numbers to
    serving_rank<r>.json, its job A frames to serving_frames<r>.npy."""
    import threading

    import torch.distributed as dist

    from gen3c_tpu_torch.serving.api_types import InferenceRequest, SeedingRequest
    from gen3c_tpu_torch.serving.encoding import CompressionFormat, compress_images
    from gen3c_tpu_torch.serving.serialization import dumps_api_message, loads_api_message
    from gen3c_tpu_torch.serving.server import serve

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(SERVING_CP2_RANKS),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.cuda.set_per_process_memory_fraction(SERVING_CP2_MEMORY_FRACTION, 0)
    t0 = time.perf_counter()
    model = _served_7b(num_devices=SERVING_CP2_RANKS, parallel="cp", cp_attn="ulysses",
                       device="cuda:0", dist_backend="gloo",
                       channel_timeout_s=SERVING_CP2_TIMEOUT_S)
    torch.cuda.synchronize()
    out = {"rank": rank, "ready_s": time.perf_counter() - t0, "leads": model.leads,
           "backend": dist.get_backend(model.model.groups.cp.group),
           "heads_a_rank_after_all_to_all": model.model.net.cfg.num_heads // SERVING_CP2_RANKS,
           "runs": []}
    frames = {}
    _recording_runs(model, out["runs"], frames)
    h, w, chunk = model.preset.height, model.preset.width, model.model.chunk_size
    if not model.leads:
        out["calls"] = model.follow()
    else:
        server, service = serve(host="127.0.0.1", port=0, model=model)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{server.server_address[1]}"

        def status(rid: str) -> dict:
            code, body = _http("GET", f"{base}/job-status?request_id={rid}")
            st = json.loads(body)
            if code != 200 or st["state"] == "error":
                raise AssertionError(f"serving_cp2: job {rid}: {code} {st}")
            return st

        def wait(rid: str, states: tuple) -> dict:
            t_end = time.perf_counter() + SERVING_TIMEOUT_S
            while time.perf_counter() < t_end:
                st = status(rid)
                if st["state"] in states:
                    return st
                time.sleep(SERVING_POLL_S)
            raise AssertionError(f"serving_cp2: job {rid} never reached {states}: {st}")

        try:
            image = ((_seed_image(h, w, 5)[0, :, 0].transpose(1, 2, 0) + 1) * 127.5).round()
            seed = SeedingRequest(request_id="seed", images=image.astype(np.uint8)[None],
                                  cameras_to_world=np.eye(4, dtype=np.float32)[:3][None],
                                  focal_lengths=np.full((1, 2), 0.8 * w, np.float32),
                                  principal_points=np.full((1, 2), 0.5, np.float32))
            t0 = time.perf_counter()
            code, body = _http("POST", f"{base}/seed-model", dumps_api_message(seed))
            out["seed_s"] = time.perf_counter() - t0
            if code != 200:
                raise AssertionError(f"serving_cp2: seed-model: {code} {body[:500]}")
            scale = float(np.median(loads_api_message(body).depths))
            out["seed_depth_median"] = scale

            def submit(rid: str) -> None:
                req = InferenceRequest(request_id=rid,
                                       **_serving_path(SERVING_FRAMES, h, w, scale))
                code, body = _http("POST", f"{base}/request-inference", dumps_api_message(req))
                if code != 202:
                    raise AssertionError(f"serving_cp2: request {rid}: {code} {body[:200]}")

            t0 = time.perf_counter()
            submit("A")
            out["job_a"] = {"state": wait("A", ("done", "cancelled"))["state"],
                            "wall_s": time.perf_counter() - t0}
            t0 = time.perf_counter()
            code, body = _http("GET", f"{base}/inference-result?request_id=A&format=jpg")
            fetched = loads_api_message(body)
            out["job_a"].update(fetch_s=time.perf_counter() - t0, fetch_code=code,
                                fetch_bytes=len(body), fetched=len(fetched.images_compressed))
            last_jpg = compress_images(model.get_latest_rgb()[None].astype(np.float32) / 255.0,
                                       CompressionFormat.JPG)[0]
            out["job_a"]["last_frame_jpg_equal"] = fetched.images_compressed[-1] == last_jpg
            # C's cancel once its first chunk renders: past the first of the
            # polls every rank makes alike (_SharedEvent), whose round trip
            # over the channel "running" alone does not wait for
            t0 = time.perf_counter()
            previous = model.last_timings
            submit("C")
            t_end = time.perf_counter() + SERVING_TIMEOUT_S
            while not (model.last_timings is not previous and model.last_timings.get("render")):
                if time.perf_counter() > t_end:
                    raise AssertionError("serving_cp2: job C never rendered its first chunk")
                time.sleep(0.05)
            _http("POST", f"{base}/cancel-inference?request_id=C")
            st = wait("C", ("cancelled", "done"))
            out["job_c"] = {"state": st["state"], "frames_done": st["frames_done"],
                            "cancelled_after_s": time.perf_counter() - t0}
        finally:
            server.shutdown()
            server.server_close()
            service.shutdown()
            service.worker.join(timeout=SERVING_TIMEOUT_S)
            t0 = time.perf_counter()
            model.shutdown()  # "stop": rank 1's follow returns
            out["stop_s"] = time.perf_counter() - t0
    np.save(os.path.join(out_dir, f"serving_frames{rank}.npy"), frames["A"])
    out["h_w_chunk"] = [h, w, chunk]
    with open(os.path.join(out_dir, f"serving_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_serving_cp2(served: dict) -> dict:
    """The served 7B over SERVING_CP2_RANKS ranks on the one card
    (serving_cp2_worker): rank 0's job A frames held to the one-process
    serving phase's (same seeds, seed image and path) within
    CP_NOISE_FACTOR times serving's noise floor, not below CP_TOL; rank 1's
    to rank 0's the same way; job A done on both ranks in 2 chunks, job C
    cancelled after exactly one chunk on both, rank 1's follow returned
    after 3 calls (seed, A, C); every rank's launches (K1cp and K2 one a
    block a step, K5; K1vit on rank 0 only: it alone runs MoGe) and no
    K1 / K1ag / K1ring. The ranks share the card and gloo passes through
    host memory: no time here is a multi-card time."""
    os.makedirs(OUT_DIR, exist_ok=True)
    out_dir = tempfile.mkdtemp(dir=OUT_DIR, prefix="serving_cp2_")
    try:
        ckpt = os.path.join(served["moge_dir"], "moge.pt")
        codes, wall_s, tails = _spawn_ranks("--serving-rank", SERVING_CP2_RANKS, out_dir,
                                            SERVING_CP2_TIMEOUT_S,
                                            env={"GEN3C_MOGE_CHECKPOINT": ckpt})
        if any(codes):
            raise AssertionError(f"serving_cp2: ranks exited {codes} after {wall_s:.0f} s:\n"
                                 + "\n----\n".join(tails))
        ranks = [json.load(open(os.path.join(out_dir, f"serving_rank{r}.json")))
                 for r in range(SERVING_CP2_RANKS)]
        frames = [np.load(os.path.join(out_dir, f"serving_frames{r}.npy")).astype(np.float32)
                  for r in range(SERVING_CP2_RANKS)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
        shutil.rmtree(served["moge_dir"], ignore_errors=True)
    ref = served["frames_a"].astype(np.float32)
    noise = served["noise"]
    tol = {k: max(CP_TOL[k], CP_NOISE_FACTOR * noise[f"rel_{k}"]) for k in ("max", "mean")}
    lead, follower = ranks
    h, w, chunk = lead["h_w_chunk"]
    res = {"ranks": SERVING_CP2_RANKS, "parallel": "cp", "cp_attn": "ulysses",
           "backend": lead["backend"], "blocks": SERVING_BLOCKS, "steps": MAIN_STEPS,
           "wall_s": wall_s, "noise": noise, "tol": tol,
           "rank0_vs_one_process": _rel_diff(frames[0], ref),
           "rank1_vs_rank0": _rel_diff(frames[1], frames[0]),
           "rank1_equals_rank0": bool(np.array_equal(frames[1], frames[0])),
           "rank": ranks,
           "note": "both ranks share one card and their collectives go through host memory "
                   "(gloo): no time here is a multi-card time"}
    emit("serving_cp2", **res)
    bad = []
    for name in ("rank0_vs_one_process", "rank1_vs_rank0"):
        if _off(res[name], tol):
            bad.append(f"{name}: {res[name]} off {tol}")
    if frames[0].shape != (SERVING_FRAMES, h, w, 3):
        bad.append(f"job A's frames {frames[0].shape}")
    if lead["job_a"]["state"] != "done" or lead["job_a"]["fetched"] != SERVING_FRAMES \
            or not lead["job_a"]["last_frame_jpg_equal"]:
        bad.append(f"job A {lead['job_a']}")
    if lead["job_c"]["state"] != "cancelled" or lead["job_c"]["frames_done"] != chunk:
        bad.append(f"job C {lead['job_c']}")
    if follower.get("calls") != 3:
        bad.append(f"rank 1 followed {follower.get('calls')} calls, not 3 (seed, A, C)")
    for r, rk in enumerate(ranks):
        runs = {run["request_id"]: run for run in rk["runs"]}
        a, c = runs.get("A"), runs.get("C")
        if a is None or c is None or a["outcome"] != "done" or a["chunks"] != 2 \
                or c["outcome"] != "cancelled" or c["chunks"] != 1:
            bad.append(f"rank {r}'s runs {[(x['request_id'], x['outcome'], x['chunks']) for x in rk['runs']]}")
            continue
        la = a["launches"]
        want = 2 * SERVING_BLOCKS * MAIN_STEPS
        if la.get("K1cp") != want or la.get("K2") != want or not la.get("K5") \
                or any(la.get(k) for k in ("K1", "K1ag", "K1ring")) \
                or bool(la.get("K1vit")) != (r == 0):
            bad.append(f"rank {r}'s job A launched {la} (K1cp = K2 = {want}, K5, K1vit on "
                       f"rank 0 only)")
    if bad:
        raise AssertionError(f"serving_cp2: {bad}")
    return res


def _cut_rel_err(a: torch.Tensor, ref: torch.Tensor) -> dict:
    m = ref.float().abs().mean()
    d = (a.float().cpu() - ref.float()).abs()
    return {"max": (d.max() / m).item(), "mean": (d.mean() / m).item()}


def phase_t5() -> dict:
    """The T5 encoder stack at t5-11b's full width (24 layers, d_model
    1024, 128 x 128 heads, d_ff 65,536; seeded bf16 weights) on 2 x 512
    seeded ids, the second prompt padded after 300: seconds and peak; then
    a 2-layer full-width cut of the same weights on the card and on the CPU
    (fp32 products, TF32 off on both), held to T5_CUT_TOL; the encoder is
    freed after."""
    import dataclasses

    from gen3c_tpu_torch.models.t5 import T5_11B, T5Encoder

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("T5: TF32 is on for fp32 matmuls; the encoder's products need it off")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, T5_11B.vocab_size, (2, T5_LEN)))
    mask = torch.ones(2, T5_LEN, dtype=torch.long)
    mask[1, T5_PADDED_AFTER:] = 0
    with torch.device("meta"):
        enc = T5Encoder(T5_11B)
    t0 = time.perf_counter()
    enc = enc.to_empty(device="cuda").init_random(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in enc.parameters())
    enc(ids.cuda(), mask.cuda())  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = enc(ids.cuda(), mask.cuda())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    res = {"layers": T5_11B.num_layers, "d_model": T5_11B.d_model, "heads": T5_11B.num_heads,
           "d_ff": T5_11B.d_ff, "params": n_params, "dtype": str(T5_11B.dtype),
           "tokens": list(ids.shape), "init_s": init_s, "encode_s": times,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "finite": bool(torch.isfinite(out).all().item()), "out_shape": list(out.shape)}
    del out
    res["tool"] = _t5_tool(enc)
    cut_cfg = dataclasses.replace(T5_11B, num_layers=T5_CUT_LAYERS)
    state = {k: v for k, v in enc.state_dict().items()
             if not k.startswith("layers.") or int(k.split(".")[1]) < T5_CUT_LAYERS}
    del enc
    torch.cuda.empty_cache()
    with torch.device("meta"):
        cut_gpu, cut_cpu = T5Encoder(cut_cfg), T5Encoder(cut_cfg)
    cut_gpu = cut_gpu.to_empty(device="cuda")
    cut_gpu.load_state_dict(state)
    cut_cpu = cut_cpu.to_empty(device="cpu")
    cut_cpu.load_state_dict({k: v.cpu() for k, v in state.items()})
    del state
    t0 = time.perf_counter()
    got = cut_gpu(ids.cuda(), mask.cuda())
    torch.cuda.synchronize()
    cut_gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = cut_cpu(ids, mask)
    cut_cpu_s = time.perf_counter() - t0
    res.update(cut_layers=T5_CUT_LAYERS, cut_err=_cut_rel_err(got, want), cut_gpu_s=cut_gpu_s,
               cut_cpu_s=cut_cpu_s)
    del cut_gpu, cut_cpu, got, want
    torch.cuda.empty_cache()
    emit("t5", **res)
    if not res["finite"] or res["out_shape"] != [2, T5_LEN, T5_11B.d_model]:
        raise AssertionError(f"T5: {res}")
    if any(res["cut_err"][k] > T5_CUT_TOL[k] for k in T5_CUT_TOL):
        raise AssertionError(f"T5: the card and the CPU disagree on the 2-layer cut: {res}")
    return res


T5_TOOL_PROMPTS = ({"prompt": "A slow dolly shot through a sunlit greenhouse, rows of ferns "
                               "swaying as the camera moves left.", "name": "clip_000"},
                   {"prompt": "A drone rises over a harbour at dusk."})


class _SeededT5Prompts:
    """``encode_prompts`` of the seeded full-width T5 with the smoke's byte
    tokenizer (the card's machine has no T5 files): ids BYTE_BASE + b and
    </s> (1), padded to max_length, the output zero past the prompt."""

    def __init__(self, enc):
        self.enc = enc

    @torch.no_grad()
    def encode_prompts(self, prompt: str, max_length: int = 512):
        ids = [StandInTokenizer.BYTE_BASE + b for b in prompt.encode("utf-8")][:max_length - 1]
        ids.append(1)
        n = len(ids)
        tok = torch.zeros((1, max_length), dtype=torch.long)
        mask = torch.zeros((1, max_length), dtype=torch.long)
        tok[0, :n], mask[0, :n] = torch.tensor(ids), 1
        out = self.enc(tok.cuda(), mask.cuda()) * mask.cuda()[..., None]
        return out.float().cpu().numpy(), mask.numpy()


def _t5_tool(enc) -> dict:
    """scripts/get_t5_embeddings.py's port (``write_embeddings``) with the
    seeded T5 on the card: two prompts of a JSONL (one unnamed) to
    <clip>.t5.npy files, read back through training/datasets.py as their
    clips' embeddings and held bit for bit to a direct encode."""
    from gen3c_tpu_torch.models.t5 import T5_11B
    from gen3c_tpu_torch.scripts.get_t5_embeddings import write_embeddings
    from gen3c_tpu_torch.training.datasets import _t5_or_zeros

    encoder = _SeededT5Prompts(enc)
    d = tempfile.mkdtemp(dir=OUT_DIR, prefix="t5_tool_")
    try:
        prompts = os.path.join(d, "prompts.jsonl")
        with open(prompts, "w") as f:
            f.write("\n".join(json.dumps(p) for p in T5_TOOL_PROMPTS) + "\n")
        t0 = time.perf_counter()
        written = write_embeddings(encoder, prompts, d, max_length=T5_LEN)
        write_s = time.perf_counter() - t0
        names = [os.path.basename(w) for w in written]
        same = []
        for p, w in zip(T5_TOOL_PROMPTS, written):
            back = _t5_or_zeros(w[:-len(".t5.npy")] + ".npz")
            same.append(bool(np.array_equal(back, encoder.encode_prompts(
                p["prompt"], T5_LEN)[0][0])))
        shapes = [list(np.load(w).shape) for w in written]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    res = {"files": names, "shapes": shapes, "write_s": write_s, "read_back_equal": same}
    if names != ["clip_000.t5.npy", "000001.t5.npy"] or not all(same) \
            or shapes != [[T5_LEN, T5_11B.d_model]] * 2:
        raise AssertionError(f"offline_tools: get_t5_embeddings wrote or read back wrongly: {res}")
    return res


OFFLINE_BLOCKS = 2  # the seeded 7B-width checkpoint's depth (its disk write stays ~1.2 GB)
OFFLINE_W8A8_TOL = 0.1  # the W8A8 forward's relative L2 against bf16 on the same weights


def phase_offline_tools(t5_tool: dict) -> dict:
    """The offline tools of gen3c_tpu_torch/scripts/ on the card: a seeded
    GEN3C-7B-width checkpoint (OFFLINE_BLOCKS blocks) written as dit.npz by
    make_random_checkpoint, its W8A8 form persisted by persist_quantized_dit
    (quantized on the card, the JAX script's file), loaded pre-quantized
    through build_gen3c_model and run once on the fast path's linears (K7q,
    K7) at the 121-frame chunk's 56,320 tokens, its codes equal to the
    file's and its output within OFFLINE_W8A8_TOL of the bf16 net's; with
    phase_t5's get_t5_embeddings run (``_t5_tool``). s and bytes of each."""
    import dataclasses

    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.models.quantize import QuantLinear
    from gen3c_tpu_torch.pipelines.factory import GEN3C_7B_PRESET, build_gen3c_model
    from gen3c_tpu_torch.scripts import make_random_checkpoint, persist_quantized_dit
    from gen3c_tpu_torch.utils import checkpoint as ckpt

    os.makedirs(OUT_DIR, exist_ok=True)
    root = tempfile.mkdtemp(dir=OUT_DIR, prefix="offline_")
    res = {"blocks": OFFLINE_BLOCKS, "t5": t5_tool}
    try:
        t0 = time.perf_counter()
        written = make_random_checkpoint.main(["--checkpoint_dir", root, "--preset", "gen3c_7b",
                                               "--num_blocks", str(OFFLINE_BLOCKS),
                                               "--seed", "0", "--device", "cuda"])
        res["random_checkpoint"] = {"s": time.perf_counter() - t0,
                                    "bytes": os.path.getsize(written[0])}
        t0 = time.perf_counter()
        qpath = persist_quantized_dit.main(["--checkpoint_dir", root, "--mode", "w8a8",
                                            "--preset", "gen3c_7b", "--num_blocks",
                                            str(OFFLINE_BLOCKS), "--device", "cuda"])
        res["persist_w8a8"] = {"s": time.perf_counter() - t0, "bytes": os.path.getsize(qpath)}
        preset = dataclasses.replace(GEN3C_7B_PRESET, dit=dataclasses.replace(
            GEN3C_7B_PRESET.dit, num_blocks=OFFLINE_BLOCKS))
        t0 = time.perf_counter()
        model, _ = build_gen3c_model(preset, device="cuda", checkpoint_dir=root,
                                     quantize="w8a8")
        res["load_s"] = time.perf_counter() - t0
        net = model.net
        codes = ckpt.load_flat_npz(qpath)["['blocks']/[0]/['mlp']/['fc1']/['q8']"]
        fc1 = net.blocks["block0"].blocks[2].block.layer1
        res["codes_equal"] = isinstance(fc1, QuantLinear) and bool(torch.equal(
            fc1.weight.cpu(), torch.from_numpy(codes).T))
        # the same weights unquantized (the seeded file's gates are not zero)
        bf16_model, _ = build_gen3c_model(preset, device="cuda", checkpoint_dir=root)
        gen = torch.Generator(device="cuda").manual_seed(5)
        x = torch.randn((1, preset.dit.in_channels, LATENT_T_7B, 88, 160),
                        generator=gen, device="cuda")
        t = torch.full((1,), 0.25 * math.log(2.0), device="cuda")
        ctx = torch.randn((1, 512, 1024), generator=gen, device="cuda")
        with torch.no_grad():
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = net(x, t, ctx, fps=24.0)
            torch.cuda.synchronize()
            res["forward_s"] = time.perf_counter() - t0
            res["launches"] = {k: v for k, v in kernels.launch_counts.items() if v}
            want = bf16_model.net(x, t, ctx, fps=24.0)
        res["rel_l2_vs_bf16"] = ((out.float() - want.float()).norm()
                                 / want.float().norm()).item()
        res["finite"] = bool(torch.isfinite(out).all().item())
        del model, bf16_model, net, out, want, x, ctx
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    emit("offline_tools", **res)
    if not (res["codes_equal"] and res["finite"]) or res["rel_l2_vs_bf16"] > OFFLINE_W8A8_TOL \
            or not res["launches"].get("K7q") or not res["launches"].get("K7"):
        raise AssertionError(f"offline_tools: {res}")
    return res


def phase_moge() -> dict:
    """MoGe ViT-L (24 blocks x 1024, 16 x 64 heads, fp32) on a seeded
    704x1280 image through moge_infer, the depth source of the seed frame
    and of every AR chunk after the first: seconds, peak and the launches of
    its fp32 attention (K1vit, 24); then the same call on the CPU with the
    same weights: the head's output within MOGE_TOL, the masks, and the
    recovered focal and shift within MOGE_FIT_TOL. (With seeded weights the
    search's residual is flat near its minimum, so the card's and the CPU's
    sums, in other orders, may settle a few cells of its last grid apart:
    10 cells, 1.6e-3, with seed 0 on an H100.)"""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.aux import moge

    from gen3c_tpu_torch.scripts.time_main_path import seeded_moge_params

    cfg = moge.MOGE_VITL
    params = seeded_moge_params(cfg, 0, "cuda")
    image = (_seed_image(704, 1280, 3)[0, :, 0].transpose(1, 2, 0) + 1) / 2
    img = torch.from_numpy(np.ascontiguousarray(image, np.float32))
    heads = {}
    infer_head = moge.moge_head

    def keep_head(p, c, taps, hw):
        out = infer_head(p, c, taps, hw)
        heads[out.device.type] = out
        return out

    fits = {}
    recover = moge.recover_focal_shift

    def keep_fit(points, mask):
        f, t = recover(points, mask)
        fits[points.device.type] = (float(f), float(t))
        return f, t

    moge.moge_head, moge.recover_focal_shift = keep_head, keep_fit
    try:
        moge.moge_infer(params, cfg, img.cuda())  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        depth, k, mask = moge.moge_infer(params, cfg, img.cuda())
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(kernels.launch_counts)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        t0 = time.perf_counter()
        depth_cpu, k_cpu, mask_cpu = moge.moge_infer({n: v.cpu() for n, v in params.items()}, cfg,
                                                     img)
        cpu_s = time.perf_counter() - t0
    finally:
        moge.moge_head, moge.recover_focal_shift = infer_head, recover
    # the shift search on a pinhole point map with one optimum, at the fit
    # resolution: the card and the CPU within one cell of its last grid
    fh, fw = moge._fit_resolution(704, 1280, cfg.patch_size, 518 * 518)
    pts, pmask, f0, t0 = _pinhole_points(fh, fw)
    pin = {dev: tuple(float(x) for x in moge.recover_focal_shift(
        torch.from_numpy(pts).to(dev), torch.from_numpy(pmask).to(dev))) for dev in ("cuda", "cpu")}
    res = {"width": cfg.width, "depth": cfg.depth, "heads": cfg.heads, "fit": [fh, fw],
           "tokens": 1 + 27 * 50, "seconds": seconds, "cpu_seconds": cpu_s, "peak_gib": peak,
           "launches": launches, "head_err": _cut_rel_err(heads["cuda"], heads["cpu"]),
           "mask_agree": (mask.cpu() == mask_cpu).float().mean().item(),
           "valid": mask.float().mean().item(), "focal_shift": fits,
           "fit_rel_err": max(abs(a - b) / abs(b) for a, b in zip(fits["cuda"], fits["cpu"])),
           "depth_finite": bool(torch.isfinite(depth[mask]).all().item()),
           "intrinsics": k.cpu().tolist(),
           "pinhole": {"true": [f0, t0], **pin,
                       "shift_cells": abs(pin["cuda"][1] - pin["cpu"][1]) / MOGE_SHIFT_CELL,
                       "focal_rel_err": abs(pin["cuda"][0] - pin["cpu"][0]) / abs(pin["cpu"][0])}}
    emit("moge", **res)
    del params, depth, heads
    torch.cuda.empty_cache()
    if launches["K1vit"] != cfg.depth or launches["K1"]:
        raise AssertionError(f"MoGe: fp32 attention launches {launches}, expected {cfg.depth} K1vit")
    if any(res["head_err"][key] > MOGE_TOL[key] for key in MOGE_TOL) or res["mask_agree"] < 0.999:
        raise AssertionError(f"MoGe: the card and the CPU disagree: {res}")
    if res["fit_rel_err"] > MOGE_FIT_TOL or not res["depth_finite"]:
        raise AssertionError(f"MoGe: recovered shift or depth off: {res}")
    if res["pinhole"]["shift_cells"] > 1.01 or res["pinhole"]["focal_rel_err"] > MOGE_FIT_TOL:
        raise AssertionError(f"MoGe: the pinhole's shift, card against CPU: {res['pinhole']}")
    return res


def _pinhole_points(H: int, W: int, seed: int = 0):
    """A seeded (H, W, 3) point map of a pinhole camera (focal f0 in units of
    min(H, W) / 2, shift t0) over a wavy depth, 1e-3 of noise, and a mask of
    ~90% of the pixels: recover_focal_shift's residual has one optimum."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                         indexing="ij")
    s = min(H, W) / 2
    f0, t0 = rng.uniform(0.8, 2.0), rng.uniform(0.5, 3.0)
    z = rng.uniform(1.0, 4.0) + 0.5 * np.sin(xx / 7 + seed)
    pts = np.stack([(xx - (W - 1) / 2) / s * z / f0, (yy - (H - 1) / 2) / s * z / f0, z - t0], -1)
    pts = pts + rng.normal(0, 1e-3, pts.shape)
    return pts.astype(np.float32), rng.uniform(size=(H, W)) > 0.1, f0, t0


def phase_checkpoint() -> dict:
    """A checkpoint round trip at GEN3C-7B width, 2 of 28 blocks: the net
    (seeded bf16 weights) written as the reference's wrapped model.pt and as
    the JAX package's dit.npz, each loaded back by build_gen3c_model from
    its own checkpoint_dir, bits equal to the net in memory; and a prompt
    encoder that cannot load (no transformers or t5-11b files here) raises."""
    import dataclasses

    from gen3c_tpu_torch.models.convert import convert_dit_state_dict
    from gen3c_tpu_torch.models.t5 import make_t5_encoder
    from gen3c_tpu_torch.pipelines.factory import GEN3C_7B_PRESET, build_gen3c_model
    from gen3c_tpu_torch.utils.checkpoint import save_params_npz

    preset = dataclasses.replace(GEN3C_7B_PRESET, dit=dataclasses.replace(
        GEN3C_7B_PRESET.dit, num_blocks=CKPT_BLOCKS))
    model, _ = build_gen3c_model(preset, device="cuda", seed=0)
    randomize_gates(model.net, torch.Generator(device="cuda").manual_seed(1))
    state = {k: v.cpu() for k, v in model.net.state_dict().items()}
    del model
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="smoke_ckpt_")
    res = {"blocks": CKPT_BLOCKS, "params": sum(v.numel() for v in state.values()),
           "dtype": str(preset.dit.dtype)}
    try:
        t0 = time.perf_counter()
        os.makedirs(os.path.join(root, "pt", "GEN3C-Cosmos-7B"))
        torch.save({"model": {f"net.{k}": v for k, v in state.items()},
                    "ema": {f"net-{k}".replace(".", "-"): v for k, v in state.items()}},
                   os.path.join(root, "pt", "GEN3C-Cosmos-7B", "model.pt"))
        res["write_pt_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        save_params_npz(os.path.join(root, "npz", "gen3c_tpu", "dit.npz"),
                        convert_dit_state_dict(state, preset.dit, dtype=preset.dit.dtype))
        res["write_npz_s"] = time.perf_counter() - t0
        for form in ("pt", "npz"):
            t0 = time.perf_counter()
            loaded, _ = build_gen3c_model(preset, device="cuda", seed=5,
                                          checkpoint_dir=os.path.join(root, form))
            torch.cuda.synchronize()
            res[f"load_{form}_s"] = time.perf_counter() - t0
            got = loaded.net.state_dict()
            res[f"{form}_bits_equal"] = set(got) == set(state) and all(
                torch.equal(got[k].cpu(), v) for k, v in state.items())
            del loaded, got
            torch.cuda.empty_cache()
        res["bytes"] = {f: sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in
                               os.walk(os.path.join(root, f)) for n in ns) for f in ("pt", "npz")}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    try:
        make_t5_encoder("jax", checkpoint_dir=root, device="cuda")
        res["prompt_encoder_error"] = None
    except (ImportError, FileNotFoundError) as e:
        res["prompt_encoder_error"] = f"{type(e).__name__}: {str(e)[:160]}"
    emit("checkpoint", **res)
    if not (res["pt_bits_equal"] and res["npz_bits_equal"]):
        raise AssertionError(f"checkpoint round trip changed the weights: {res}")
    if res["prompt_encoder_error"] is None:
        raise AssertionError("a prompt encoder without its files loaded")
    return res


def _train_batch(cfg, T, H, W, ctx_len, seed):
    """One synthetic clip (B=1) drawn on the CPU from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return {"x0": torch.randn((1, 16, T, H, W), generator=gen),
            "crossattn_emb": torch.randn((1, ctx_len, 1024), generator=gen),
            "extra_channels": torch.randn((1, cfg.in_channels - 16, T, H, W), generator=gen)}


def phase_train() -> dict:
    """train_step at GEN3C-7B width, TRAIN_BLOCKS_7B blocks, one 121-frame clip."""
    import dataclasses

    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.pipelines.factory import GEN3C_7B_PRESET
    from gen3c_tpu_torch.training.train import build_net
    from gen3c_tpu_torch.training.train_step import init_train_state, make_optimizer, train_step
    from gen3c_tpu_torch.training.trainer import TrainerConfig

    cfg = dataclasses.replace(GEN3C_7B_PRESET.dit, num_blocks=TRAIN_BLOCKS_7B)
    tc = TrainerConfig()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    net = build_net(cfg, "cuda", seed=0)
    randomize_gates(net, torch.Generator(device="cuda").manual_seed(1))
    opt = make_optimizer(lr=tc.lr, weight_decay=tc.weight_decay, grad_clip=tc.grad_clip,
                         warmup_steps=tc.warmup_steps, grad_accum_steps=tc.grad_accum_steps)
    state = init_train_state(net, opt)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in net.parameters())
    res = {"model": "gen3c_7b", "blocks": cfg.num_blocks, "channels": cfg.model_channels,
           "heads": cfg.num_heads, "head_dim": cfg.head_dim, "dtype": str(cfg.dtype),
           "params": n_params, "build_s": time.perf_counter() - t0,
           # bf16 params, grads, AdamW mu and nu (2 bytes each) + fp32 EMA (4)
           "state_gib_reckoned": n_params * 12 / 2 ** 30,
           "state_gib_measured_without_grads": (torch.cuda.memory_allocated() - base) / 2 ** 30}
    T, H, W = LATENT_T_7B, 88, 160
    batch = {k: v.cuda() for k, v in _train_batch(cfg, T, H, W, 512, seed=0).items()}
    res.update(latent=[16, T, H, W], tokens=T * H * W // 4, ctx_tokens=512, batch=1, remat=True,
               optimizer={"lr": tc.lr, "weight_decay": tc.weight_decay,
                          "grad_clip": tc.grad_clip, "warmup_steps": tc.warmup_steps})
    gen = torch.Generator().manual_seed(0)
    kernels.reset_launch_counts()
    steps = []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(state, batch, gen, cfg, opt, remat=True)
        torch.cuda.synchronize()
        steps.append({"s": time.perf_counter() - t0, "loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"])})
    launches = dict(kernels.launch_counts)
    res.update(steps=steps, launches=launches, routes=dict(kernels.route_counts),
               k4_by_forward=dict(kernels.k4_launches_by_forward),
               peak_gib=(torch.cuda.max_memory_allocated() - base) / 2 ** 30, step=state.step,
               ema_finite=bool(all(torch.isfinite(e).all().item()
                                   for e in state.ema_params.values())))
    emit("train", **res)
    require_wgmma("train", res["routes"])
    per_step = 2 * cfg.num_blocks  # one K4 per attention backward: self and cross
    if not all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) and s["grad_norm"] > 0
               for s in steps) or not res["ema_finite"]:
        raise AssertionError(f"train: non-finite or zero loss / grad-norm: {res}")
    if (launches["K4"] != TRAIN_STEPS * per_step or launches["K1"] != TRAIN_STEPS * per_step
            or launches["K2"] != TRAIN_STEPS * per_step or launches["K3"]):
        raise AssertionError(f"train: launches {launches}, expected K4 = K1 = K2 = "
                             f"{TRAIN_STEPS * per_step} (remat runs each forward twice)")
    del state, net, batch
    torch.cuda.empty_cache()
    return res


def _synthetic_clip(frames: int, h: int, w: int, seed: int):
    """A seeded RGBD clip: the seed image panning (2 pixels a frame), a
    slanted depth plane, and cameras moving left along a trajectory; as a
    packaged clip holds them: (image, depth, w2c, intrinsics)."""
    from gen3c_tpu_torch.ops.camera import generate_camera_trajectory
    from gen3c_tpu_torch.pipelines.depth import default_intrinsics

    base = _seed_image(h, w, seed)[0, :, 0]
    image = np.stack([np.roll(base, 2 * i, axis=2) for i in range(frames)])
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    depth = np.broadcast_to((2.5 - 0.8 * yy + 0.3 * np.sin(6 * xx)).astype(np.float32),
                            (frames, 1, h, w)).copy()
    k = default_intrinsics(h, w)
    w2c, ks = generate_camera_trajectory("left", np.eye(4, dtype=np.float32), k, frames, 0.3,
                                         "center_facing", 1.0)
    return (image, depth, np.asarray(w2c, np.float32).reshape(frames, 4, 4),
            np.asarray(ks, np.float32).reshape(frames, 3, 3))


def phase_lora_band_train() -> dict:
    """LoRA fine-tuning of GEN3C-7B at full width on LORA_BLOCKS of its 28
    blocks with the fast preset's band: a batch from build_gen3c_train_batch on a 121-frame 704x1280 RGBD
    clip (7B VAE, K5), then lora_train_step (rank 16 on DEFAULT_TARGETS,
    remat, make_optimizer with warmup 1) over the frozen base."""
    from gen3c_tpu_torch import kernels
    import dataclasses

    from gen3c_tpu_torch.pipelines.factory import GEN3C_7B_PRESET, build_gen3c_model
    from gen3c_tpu_torch.training.datasets import build_gen3c_train_batch
    from gen3c_tpu_torch.training.lora import init_lora_params, lora_leaves, lora_train_step
    from gen3c_tpu_torch.training.train_step import make_optimizer
    from gen3c_tpu_torch.training.trainer import TrainerConfig

    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    full = GEN3C_7B_PRESET
    model, preset = build_gen3c_model(
        dataclasses.replace(full, dit=dataclasses.replace(full.dit, num_blocks=LORA_BLOCKS)),
        device="cuda", seed=0, attn_temporal_window=BAND_7B[1])
    net, cfg = model.net, preset.dit
    randomize_gates(net, torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    res = {"model": preset.name, "blocks": cfg.num_blocks, "channels": cfg.model_channels,
           "heads": cfg.num_heads, "head_dim": cfg.head_dim, "dtype": str(cfg.dtype),
           "band": [BAND_7B[0], cfg.attn_temporal_window, cfg.attn_prefix_frames],
           "build_model_s": time.perf_counter() - t0,
           "base_gib_reckoned": sum(tensor_bytes(p) for p in net.parameters()) / 2 ** 30,
           "model_gib_measured": (torch.cuda.memory_allocated() - mem0) / 2 ** 30}  # DiT + VAE
    saved = {n: p.detach().cpu() for n, p in net.named_parameters()}

    image, depth, w2c, k = _synthetic_clip(preset.chunk_size, preset.height, preset.width, seed=0)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    batch = build_gen3c_train_batch(model, image, depth, w2c, k)
    torch.cuda.synchronize()
    res.update(batch_s=time.perf_counter() - t0, batch_launches=dict(kernels.launch_counts),
               latent=list(batch["x0"].shape[1:]), tokens=int(np.prod(batch["x0"].shape[2:])) // 4,
               extra_channels=batch["extra_channels"].shape[1],
               batch_finite=bool(all(torch.isfinite(t).all().item() for t in batch.values())))
    del image, depth

    mem1 = torch.cuda.memory_allocated()
    lora = init_lora_params(torch.Generator(device="cuda").manual_seed(0), net, rank=LORA_RANK)
    tc = TrainerConfig()
    opt = make_optimizer(lr=tc.lr, weight_decay=tc.weight_decay, grad_clip=tc.grad_clip,
                         warmup_steps=1)
    opt_state = opt.init(lora_leaves(lora))
    n_adapter = sum(t.numel() for t in lora_leaves(lora).values())
    res.update(rank=LORA_RANK, adapters=len(lora), adapter_params=n_adapter,
               # fp32 A and B, Adam's mu and nu
               adapter_gib_reckoned=n_adapter * 4 * 3 / 2 ** 30,
               adapter_gib_measured=(torch.cuda.memory_allocated() - mem1) / 2 ** 30,
               optimizer={"lr": tc.lr, "weight_decay": tc.weight_decay,
                          "grad_clip": tc.grad_clip, "warmup_steps": 1})
    gen = torch.Generator().manual_seed(0)
    kernels.reset_launch_counts()
    steps = []
    for _ in range(LORA_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lora, opt_state, m = lora_train_step(lora, opt_state, net, batch, gen, cfg, opt,
                                             remat=True)
        torch.cuda.synchronize()
        steps.append({"s": time.perf_counter() - t0, "loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"])})
    launches = dict(kernels.launch_counts)
    by_forward = dict(kernels.k4_launches_by_forward)
    res.update(steps=steps, launches=launches, k4_by_forward=by_forward,
               routes=dict(kernels.route_counts),
               launches_per_step={k: v / LORA_STEPS for k, v in launches.items() if v},
               peak_gib=(torch.cuda.max_memory_allocated() - mem0) / 2 ** 30,
               adapters_moved=bool(any(ab["b"].abs().max().item() > 0 for ab in lora.values())),
               base_unchanged=all(torch.equal(p.detach().cpu(), saved[n])
                                  for n, p in net.named_parameters()))
    emit("lora_band_train", **res)
    require_wgmma("lora_band_train", res["routes"])
    n = cfg.num_blocks
    want = {"K4band": n, "K3lse": 2 * n, "K3": 0, "K2": 2 * n, "K4": n, "K1": 0}  # remat: twice
    got = {key: launches[key] / LORA_STEPS for key in want}
    if got != want or by_forward["K2"] != n * LORA_STEPS or by_forward["K1"]:
        raise AssertionError(f"lora_band_train: launches per step {got}, expected {want}: {res}")
    if not (res["base_unchanged"] and res["adapters_moved"] and res["batch_finite"]
            and all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) for s in steps)
            and res["batch_launches"]["K5"] > 0 and n == LORA_BLOCKS):
        raise AssertionError(f"lora_band_train: {res}")
    del model, net, batch, lora, opt_state, saved
    torch.cuda.empty_cache()
    return res


def phase_train_parity() -> dict:
    """One train_step of a 1024-wide bf16 DiT on the card and on the CPU."""
    return _train_parity("train_parity", window=None)


def phase_band_train_parity() -> dict:
    """The same with band window 1 over the 5 latent frames of 240 tokens:
    the band forward with lse and K4-band on the card."""
    return _train_parity("band_train_parity", window=1)


def _train_parity(phase: str, window) -> dict:
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.models.dit import DiTConfig, GeneralDIT
    from gen3c_tpu_torch.training.train_step import (
        draw_step, init_train_state, loss_and_grads, make_optimizer, train_step)

    cfg = DiTConfig(in_channels=16 + 16 * 4 + 1, model_channels=1024, num_blocks=2,
                    num_heads=8, rope_t_extrapolation_ratio=2.0, attn_temporal_window=window)
    cpu = GeneralDIT(cfg).init_random(torch.Generator().manual_seed(2))
    randomize_gates(cpu, torch.Generator().manual_seed(3))
    gpu = copy.deepcopy(cpu).to("cuda")
    T, H, W = 5, 24, 40  # 1,200 tokens: 5 latent frames of 12 x 20
    batch = _train_batch(cfg, T, H, W, 512, seed=4)
    draws = draw_step(torch.Generator().manual_seed(5), batch["x0"].shape, False, False)
    out = {}
    for dev, net in (("cuda", gpu), ("cpu", cpu)):
        opt = make_optimizer(warmup_steps=1)
        state = init_train_state(net, opt)
        kernels.reset_launch_counts()
        loss, grads, _ = loss_and_grads(net, batch, None, cfg, draws=draws)
        launches = dict(kernels.launch_counts)
        state, m = train_step(state, batch, None, cfg, opt, draws=draws)
        out[dev] = {"loss": float(loss), "step_loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]), "launches": launches,
                    "grads": {n: g.float().cpu() for n, g in grads.items()}}
    g_cuda, g_cpu = out["cuda"].pop("grads"), out["cpu"].pop("grads")
    leaves = {}
    for n, ref in g_cpu.items():
        d = (g_cuda[n] - ref).abs()
        leaves[n] = {"rel_mean": (d.mean() / ref.abs().mean().clamp_min(1e-30)).item(),
                     "rel_max": (d.max() / ref.abs().max().clamp_min(1e-30)).item()}
    worst_mean = max(leaves.items(), key=lambda kv: kv[1]["rel_mean"])
    worst_max = max(leaves.items(), key=lambda kv: kv[1]["rel_max"])
    res = {"dit": "1024 ch x 2 blocks x 8 heads, bf16, gates randomized", "tokens": T * H * W // 4,
           "band": None if window is None else [H * W // 4, window, cfg.attn_prefix_frames],
           "cuda": out["cuda"], "cpu": out["cpu"],
           "loss_rel_err": abs(out["cuda"]["loss"] - out["cpu"]["loss"]) / abs(out["cpu"]["loss"]),
           "grad_norm_rel_err": abs(out["cuda"]["grad_norm"] - out["cpu"]["grad_norm"])
           / out["cpu"]["grad_norm"],
           "leaves": len(leaves), "worst_leaf_rel_mean": [worst_mean[0], worst_mean[1]["rel_mean"]],
           "worst_leaf_rel_max": [worst_max[0], worst_max[1]["rel_max"]],
           "median_leaf_rel_mean": float(np.median([v["rel_mean"] for v in leaves.values()])),
           "tol": TRAIN_PARITY_TOL}
    emit(phase, **res)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"{phase}_leaves.json"), "w") as f:
        json.dump(leaves, f, indent=1)
    n = cfg.num_blocks
    ran = out["cuda"]["launches"]
    want = ({"K4": 2 * n, "K4band": 0, "K1": n, "K3": 0, "K3lse": 0} if window is None
            else {"K4": n, "K4band": n, "K1": 0, "K3": 0, "K3lse": n})  # cross: K2 + K4
    if any(ran[k] != v for k, v in want.items()):
        raise AssertionError(f"{phase}: the card's step ran {ran}, expected {want}: {res}")
    if (res["loss_rel_err"] > TRAIN_PARITY_TOL["loss"]
            or res["grad_norm_rel_err"] > TRAIN_PARITY_TOL["grad_norm"]
            or worst_mean[1]["rel_mean"] > TRAIN_PARITY_TOL["leaf_mean"]
            or worst_max[1]["rel_max"] > TRAIN_PARITY_TOL["leaf_max"]):
        raise AssertionError(f"{phase}: card and CPU disagree: {res}")
    return res


def phase_train_cli() -> dict:
    """The training CLI on the card (tiny, fp32: the fp32 K4), then a resume,
    then a --data_root run on a packaged clip with band window 1 (the fp32
    K4-band, and K5 in the batches)."""
    import tempfile

    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.training import train

    with tempfile.TemporaryDirectory(dir=OUT_DIR) as job:
        args = ["--synthetic", "--remat", "experiment=gen3c_tiny", "trainer.max_iter=4",
                "trainer.save_every=2", "trainer.warmup_steps=1", f"trainer.job_dir={job}"]
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        first = train.main(args)
        first_s = time.perf_counter() - t0
        launches_first = dict(kernels.launch_counts)
        first_checkpoints = first.checkpointer.steps()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        resumed = train.main([a.replace("max_iter=4", "max_iter=6") for a in args])
        resumed_s = time.perf_counter() - t0
        launches_resumed = dict(kernels.launch_counts)
        res = {"experiment": "gen3c_tiny", "device": str(next(first.state.params.parameters()).device),
               "first_run": {"steps": first.state.step, "s": first_s, "launches": launches_first,
                             "checkpoints": first_checkpoints},
               "resumed_run": {"steps": resumed.state.step, "s": resumed_s,
                               "launches": launches_resumed,
                               "checkpoints": resumed.checkpointer.steps()}}
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as root:
        from gen3c_tpu_torch.pipelines.factory import PRESETS

        tiny = PRESETS["gen3c_tiny"]
        image, depth, w2c, k = _synthetic_clip(tiny.chunk_size + 4, tiny.height, tiny.width, seed=3)
        np.savez(os.path.join(root, "clip.npz"), image=image, depth=depth, w2c=w2c, intrinsics=k)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        clips = train.main(["--data_root", root, "experiment=gen3c_tiny",
                            "dit.attn_temporal_window=1", "trainer.max_iter=2",
                            "trainer.warmup_steps=1", f"trainer.job_dir={root}/job"])
        res["data_root_run"] = {"steps": clips.state.step, "s": time.perf_counter() - t0,
                                "band_window": clips.dit_cfg.attn_temporal_window,
                                "launches": dict(kernels.launch_counts),
                                "device": str(next(clips.state.params.parameters()).device)}
    emit("train_cli", **res)
    per_step = 2 * first.dit_cfg.num_blocks
    if not (first.state.step == 4 and resumed.state.step == 6
            and res["first_run"]["checkpoints"] == [2, 4]
            and res["resumed_run"]["checkpoints"] == [2, 4, 6]
            and launches_first["K4"] == 4 * per_step
            and launches_resumed["K4"] == 2 * per_step  # steps 5 and 6: resumed at 4
            and res["device"].startswith("cuda")):
        raise AssertionError(f"train_cli: {res}")
    run, blocks = res["data_root_run"], clips.dit_cfg.num_blocks
    if not (run["steps"] == 2 and run["device"].startswith("cuda")
            and run["launches"]["K4band"] == 2 * blocks and run["launches"]["K1"] == 0
            and run["launches"]["K5"] > 0):
        raise AssertionError(f"train_cli --data_root: {res}")
    return res


# ----------------- span caching and the Cosmos sibling pipelines -----------------

SPAN_STEPS = 6  # the fewest steps with a skip: refreshes on 0, 1, 2, 4, 5, the skip on 3
SPAN_INTERVAL = 2
SPAN_PATTERN = [True, True, True, False, True, True]
# the int8 carry (and a bf16 one beside it) at the 7B's width over 4 of
# the chunk's 16 latent frames (14,080 tokens), to hold the phase's time
SPAN_SHORT_T = 4
SPAN_BLOCKS = 8  # of 28: the depth span caching runs at (its span: half of them)
# 3 steps each: the fewest at which a step (the second) has a next sigma
# above 0 and so takes dpm2m's and res2ab's multistep update on the card
T2W_STEPS = 3
INTERP_STEPS = 3
# text2world, the interpolator and the multiview world model run their
# 7Bs' first SIBLING_BLOCKS of 28 blocks, at full width, for the smoke's
# time: their phases hold the CLI entry points, the solvers and the views'
# fold; main_path runs the 7B's 28 blocks at this width, mv_world's K1 and
# K2 cases the multiview shapes
SIBLING_BLOCKS = 4
# the interpolator's ends: the final latent's first and last frames against
# their ends' latents (max |delta| / max |end|), and the decoded first frame
# against the VAE's own decode of the first end (mean |delta| in uint8
# levels). The last step (sigma 0.0002, below the condition's augment sigma
# 0.001) lets the network move the condition frames too, so they are not
# exact: the first run measured 0.027 / 0.037 and 4.43 levels; the bounds
# are those rounded up to about 2.5 times (PERF.md). Each end must
# also be nearer its own end than the other end
INTERP_LATENT_TOL = 0.1
INTERP_FIRST_FRAME_TOL = 10.0
# the quality curve, card against CPU, the same weights on both: each row
# as rounded (rel_l2 to 5 digits, PSNR to 2) within two units of its last
# digit. Set from the first run with the same weights, which gave every row
# equal and the two exact loops 148.65 dB apart (PERF.md)
QUALITY_TOL = {"rel_l2": 2e-5, "psnr_db": 0.02}
# the CPU's half of that check, cut for the smoke's time to the band w2,
# W8A8 and fast-preset rows (the fast preset runs W8A8, the band, the step
# cache and the guidance interval together): 4 of its 11 35-step loops.
# Every row was held in full in the smokes before the cut
QUALITY_CPU_ROWS = dict(windows=(2,), intervals=(), thresholds=(), guidance_quantiles=())
# the rows those arguments give (the W8A8 and fast-preset rows always come)
QUALITY_CPU_KEYS = {"band_w2", "w8a8", "fast_preset"}


def _timed_steps(device, steps: list):
    """An on_step hook that appends each step's seconds (synchronized) and
    kinds to ``steps``."""
    last = [time.perf_counter()]

    def on_step(i, cfg, refresh):
        torch.cuda.synchronize(device)
        now = time.perf_counter()
        steps.append({"s": now - last[0], "cfg": cfg, "refresh": refresh})
        last[0] = now

    return on_step


def phase_span(model, preset) -> dict:
    """Span caching on main_path's GEN3C-7B at its first SPAN_BLOCKS blocks
    (phase 20 of the docstring)."""
    import dataclasses

    net, cfg = model.net, model.net.cfg
    with _depth(net, SPAN_BLOCKS):
        net.cfg = dataclasses.replace(cfg, num_blocks=SPAN_BLOCKS)
        try:
            return _span_run(model, preset, net, net.cfg, SPAN_BLOCKS)
        finally:
            net.cfg = cfg


def _span_run(model, preset, net, cfg, n: int) -> dict:
    import dataclasses

    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.diffusion.sampler import generate_samples
    from gen3c_tpu_torch.models.gen3c import dit_net_fns
    from gen3c_tpu_torch.scripts.rank_block_contributions import best_span, block_contributions

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    per_block = block_contributions(net, preset.state_shape, num_sigmas=1, seed=0)
    torch.cuda.synchronize()
    rank_s = time.perf_counter() - t0
    lo, hi, _ = best_span(per_block, n // 2)
    width = hi - lo
    C, T, Hl, Wl = preset.state_shape
    rng = np.random.default_rng(3)
    cond = torch.from_numpy(rng.standard_normal((1, C, 1, Hl, Wl)).astype(np.float32) * 0.5)
    pose = torch.from_numpy(rng.standard_normal((1, 64, T, Hl, Wl)).astype(np.float32) * 0.3)
    emb = torch.zeros((1, 512, 1024), device="cuda")
    carry = {}

    def record_carry(module, args, out):
        if isinstance(out, tuple):
            d = out[1] if isinstance(out[1], tuple) else (out[1],)
            carry["bytes"], carry["dtypes"] = tensor_bytes(*d), [str(t.dtype) for t in d]

    handle = net.register_forward_hook(record_carry)
    try:
        net.cfg = dataclasses.replace(cfg, cache_block_span=(lo, hi), cache_span_dtype="bf16")
        steps = []
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        samples = model.generate_samples(
            emb, cond.cuda(), pose.cuda(), num_condition_t=1, num_steps=SPAN_STEPS, seed=0,
            step_cache_interval=SPAN_INTERVAL, on_step=_timed_steps("cuda", steps))
        torch.cuda.synchronize()
        launches = dict(kernels.launch_counts)
        full = {"steps": steps, "launches": launches, "carry_bytes": carry["bytes"],
                "carry_dtypes": carry["dtypes"],
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                "finite": bool(torch.isfinite(samples).all().item())}
        del samples
        # the int8 carry and the bf16 one at SPAN_SHORT_T latent frames,
        # the sampler called as Gen3CModel.generate_samples calls it
        short = {}
        arrays = dict(
            init_noise=rng.standard_normal((1, C, SPAN_SHORT_T, Hl, Wl)),
            augment_noise=rng.standard_normal((1, C, SPAN_SHORT_T, Hl, Wl)),
            crossattn_cond=np.zeros((1, 512, 1024)), crossattn_uncond=np.zeros((1, 512, 1024)),
            gt_latent=np.concatenate([cond.numpy(), np.zeros((1, C, SPAN_SHORT_T - 1, Hl, Wl))],
                                     axis=2),
            condition_video_indicator=np.eye(1, SPAN_SHORT_T).reshape(1, 1, SPAN_SHORT_T, 1, 1),
            condition_video_input_mask=np.broadcast_to(
                np.eye(1, SPAN_SHORT_T).reshape(1, 1, SPAN_SHORT_T, 1, 1),
                (1, 1, SPAN_SHORT_T, Hl, Wl)),
            pose_latent_cond=pose.numpy()[:, :, :SPAN_SHORT_T],
            pose_latent_uncond=np.zeros((1, 64, SPAN_SHORT_T, Hl, Wl)))
        tensors = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).cuda()
                   for k, v in arrays.items()}
        outs = {}
        for dtype in ("bf16", "int8"):
            net.cfg = dataclasses.replace(cfg, cache_block_span=(lo, hi), cache_span_dtype=dtype)
            net_fn, skip = dit_net_fns(net, True)
            steps = []
            kernels.reset_launch_counts()
            outs[dtype] = generate_samples(
                net_fn, net_fn_skip=skip, **tensors, num_steps=SPAN_STEPS,
                step_cache_interval=SPAN_INTERVAL, net_in_dtype=cfg.dtype,
                on_step=_timed_steps("cuda", steps))
            torch.cuda.synchronize()
            short[dtype] = {"steps": steps, "launches": dict(kernels.launch_counts),
                            "carry_bytes": carry["bytes"], "carry_dtypes": carry["dtypes"]}
    finally:
        net.cfg = cfg
        handle.remove()
    d = (outs["int8"] - outs["bf16"]).abs()
    ref = outs["bf16"].abs()
    res = {"model": preset.name, "per_block": [float(v) for v in per_block], "rank_s": rank_s,
           "span": [lo, hi], "width": width, "full": full, "short_latent_t": SPAN_SHORT_T,
           "short": short, "int8_vs_bf16": {"max": float(d.max() / ref.max()),
                                            "mean": float(d.mean() / ref.mean())},
           "finite_short": bool(all(torch.isfinite(o).all().item() for o in outs.values()))}
    emit("span", **res)
    want_k1 = (SPAN_STEPS - 1) * n + (n - width)
    for name, run in [("full", full)] + [(f"short {k}", v) for k, v in short.items()]:
        if [s["refresh"] for s in run["steps"]] != SPAN_PATTERN:
            raise AssertionError(f"span {name}: steps {run['steps']}")
        if run["launches"]["K1"] != want_k1 or run["launches"]["K2"] != want_k1:
            raise AssertionError(f"span {name}: K1/K2 {run['launches']['K1']}/"
                                 f"{run['launches']['K2']} launches, expected {want_k1}: the "
                                 f"skip step must run the {n - width} blocks outside the span")
    tokens = 2 * T * (Hl // 2) * (Wl // 2)  # the CFG batch's tokens
    if full["carry_bytes"] != tokens * cfg.model_channels * 2 or not full["finite"]:
        raise AssertionError(f"span: carry {full['carry_bytes']} bytes, finite {full['finite']}")
    if short["int8"]["carry_dtypes"] != ["torch.int8", "torch.float32"] or not res["finite_short"]:
        raise AssertionError(f"span int8: {short['int8']}")
    torch.cuda.empty_cache()
    return res


def phase_text2world() -> dict:
    """The text2world CLI's entry point with the seeded cosmos_t2w_7b
    (phase 21 of the docstring)."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.pipelines import text2world

    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as root:
        args = text2world.create_parser().parse_args(
            ["--prompt", "a calm lake at sunrise", "--model_preset", "cosmos_t2w_7b",
             "--num_steps", str(T2W_STEPS), "--solver", "dpm2m", "--checkpoint_dir",
             os.path.join(root, "none"), "--video_save_folder", root, "--device", "cuda"])
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model, preset = text2world.build_model(args, text2world.T2W_PRESETS["cosmos_t2w_7b"])
        randomize_gates(model.net, torch.Generator(device="cuda").manual_seed(1))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        latents = []
        decode = model.decode
        model.decode = lambda lat: (latents.append(bool(torch.isfinite(lat).all().item())),
                                    decode(lat))[1]
        record = {}
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with _depth(model.net, SIBLING_BLOCKS):
            path = text2world.demo(args, built=(model, preset), record=record)
        total_s = time.perf_counter() - t0
        launches = dict(kernels.launch_counts)
        saved = os.path.getsize(path) if os.path.isfile(path) else 0
    video = record["video"]
    cfg = preset.dit
    res = {"model": preset.name, "blocks": SIBLING_BLOCKS, "of_blocks": cfg.num_blocks,
           "channels": cfg.model_channels, "heads": cfg.num_heads,
           "in_channels": cfg.in_channels, "solver": "dpm2m",
           "frames": int(video.shape[0]), "video_shape": list(video.shape),
           "dtype": str(video.dtype), "latents_finite": latents == [True],
           "steps": record["steps"], "build_model_s": build_s, "entry_point_s": total_s,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "launches": launches,
           "saved": [os.path.basename(path), saved]}
    emit("text2world", **res)
    if res["video_shape"] != [121, 704, 1280, 3] or video.dtype != np.uint8 or not saved:
        raise AssertionError(f"text2world: video {res['video_shape']} {video.dtype}, {saved} B")
    if not res["latents_finite"] or [s["cfg"] for s in record["steps"]] != [True] * T2W_STEPS:
        raise AssertionError(f"text2world: {res}")
    if launches["K1"] != T2W_STEPS * SIBLING_BLOCKS or launches["K2"] != launches["K1"]:
        raise AssertionError(f"text2world launches: {launches}")
    del model, decode  # the decode wrapper closes a cycle
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _write_png(path: str, image: np.ndarray) -> None:
    """A (1, 3, 1, H, W) image in [-1, 1] as an 8-bit PNG."""
    from PIL import Image

    Image.fromarray(((image[0, :, 0].transpose(1, 2, 0) + 1) * 127.5).round().astype(np.uint8)
                    ).save(path)


def phase_interpolator() -> dict:
    """The world interpolator's entry point with the seeded cosmos_v2w_7b
    (phase 22 of the docstring)."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.pipelines import text2world, world_interpolator
    from gen3c_tpu_torch.pipelines.gen3c_pipeline import video_to_uint8
    from gen3c_tpu_torch.utils.io import read_image_bcthw

    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as root:
        ends = [os.path.join(root, f"{name}.png") for name in ("first", "last")]
        for path, seed in zip(ends, (1, 2)):
            _write_png(path, _seed_image(704, 1280, seed))
        args = world_interpolator.create_parser().parse_args(
            ["--first_image", ends[0], "--last_image", ends[1], "--model_preset",
             "cosmos_v2w_7b", "--num_steps", str(INTERP_STEPS), "--checkpoint_dir",
             os.path.join(root, "none"), "--video_save_folder", root, "--device", "cuda"])
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model, preset = text2world.build_model(args, text2world.T2W_PRESETS["cosmos_v2w_7b"])
        randomize_gates(model.net, torch.Generator(device="cuda").manual_seed(1))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        latents = []
        decode = model.decode
        model.decode = lambda lat: (latents.append(lat), decode(lat))[1]
        record = {}
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with _depth(model.net, SIBLING_BLOCKS):
            path = world_interpolator.demo(args, built=(model, preset), record=record)
        total_s = time.perf_counter() - t0
        launches = dict(kernels.launch_counts)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        saved = os.path.getsize(path) if os.path.isfile(path) else 0
        with torch.no_grad():
            end_latents = [model.create_condition_latent_from_input_frames(
                torch.from_numpy(read_image_bcthw(p, preset.height, preset.width)).cuda(), 1)
                for p in ends]
            end_frames = [video_to_uint8(decode(lat))[0] for lat in end_latents]
    samples, video = latents[0], record["video"]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    def levels(a, b):
        return float(np.abs(a.astype(np.int16) - b.astype(np.int16)).mean())

    ends_first, ends_last = end_latents[0][:, :, 0], end_latents[1][:, :, 0]
    res = {"model": preset.name, "blocks": SIBLING_BLOCKS, "of_blocks": preset.dit.num_blocks,
           "solver": args.solver, "frames": int(video.shape[0]),
           "video_shape": list(video.shape), "step_s": record["step_seconds"][0],
           "build_model_s": build_s, "entry_point_s": total_s, "peak_mem_gib": peak,
           "launches": launches, "saved": [os.path.basename(path), saved],
           "first_latent_rel": rel(samples[:, :, 0], ends_first),
           "last_latent_rel": rel(samples[:, :, -1], ends_last),
           "first_latent_rel_to_last_end": rel(samples[:, :, 0], ends_last),
           "last_latent_rel_to_first_end": rel(samples[:, :, -1], ends_first),
           "first_frame_mean_levels": levels(video[0], end_frames[0]),
           "first_frame_mean_levels_to_last_end": levels(video[0], end_frames[1]),
           "latent_tol": INTERP_LATENT_TOL, "first_frame_tol": INTERP_FIRST_FRAME_TOL}
    emit("interpolator", **res)
    if res["video_shape"] != [121, 704, 1280, 3] or not saved:
        raise AssertionError(f"interpolator: video {res['video_shape']}, {saved} B")
    if (max(res["first_latent_rel"], res["last_latent_rel"]) > INTERP_LATENT_TOL
            or res["first_frame_mean_levels"] > INTERP_FIRST_FRAME_TOL
            or res["first_latent_rel"] >= res["first_latent_rel_to_last_end"]
            or res["last_latent_rel"] >= res["last_latent_rel_to_first_end"]
            or res["first_frame_mean_levels"] >= res["first_frame_mean_levels_to_last_end"]):
        raise AssertionError(f"interpolator: the ends are not followed: {res}")
    if launches["K1"] != INTERP_STEPS * SIBLING_BLOCKS or launches["K2"] != launches["K1"]:
        raise AssertionError(f"interpolator launches: {launches}")
    del model, decode, samples, latents, end_latents  # the decode wrapper closes a cycle
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_tokenizer() -> dict:
    """The tokenizer CLI's round trip of a 121-frame 704x1280 clip with the
    seeded CV8x8x8 (phase 23 of the docstring)."""
    from PIL import Image

    from gen3c_tpu_torch.pipelines import tokenizer_cli

    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as root:
        clip = os.path.join(root, "clip")
        os.makedirs(clip)
        wide = _seed_image(704, 1280 + 2 * 121, 4)[0, :, 0].transpose(1, 2, 0)
        for i in range(121):  # a pan of 2 pixels a frame, JPEG frames
            frame = ((wide[:, 2 * i:2 * i + 1280] + 1) * 127.5).round().astype(np.uint8)
            Image.fromarray(frame).save(os.path.join(clip, f"{i:04d}.jpg"), quality=95)
        record = {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tokenizer_cli.main(["--mode", "roundtrip", "--input", clip, "--output",
                            os.path.join(root, "recon.mp4"), "--vae_preset", "cv8x8x8",
                            "--device", "cuda"], record=record)
        total_s = time.perf_counter() - t0
    frames = record.pop("frames")
    res = {"vae": "cv8x8x8", "frames": list(frames.shape), "psnr_db": record["psnr"],
           "encode_s": record["encode_s"], "decode_s": record["decode_s"],
           "entry_point_s": total_s, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit("tokenizer", **res)
    if res["frames"] != [121, 704, 1280, 3] or not np.isfinite(res["psnr_db"]):
        raise AssertionError(f"tokenizer: {res}")
    torch.cuda.empty_cache()
    return res


def phase_quality() -> dict:
    """The approximation error curve on the card against the CPU (phase
    24 of the docstring)."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.diffusion import quality
    from gen3c_tpu_torch.diffusion.quality import approximation_quality_curve

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    card = approximation_quality_curve(device="cuda")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    t0 = time.perf_counter()
    cpu = approximation_quality_curve(device="cpu", **QUALITY_CPU_ROWS)
    cpu_s = time.perf_counter() - t0
    # the two devices' exact loops against each other: the curve's floor
    exact = [quality._sample(quality.init_quality_net(0, dev),
                             quality.quality_inputs(0, device=dev), 35) for dev in ("cuda", "cpu")]
    floor = quality._metrics(exact[1], exact[0])
    delta = {k: {"rel_l2": abs(card[k]["rel_l2"] - cpu[k]["rel_l2"]),
                 "psnr_db": abs(card[k]["psnr_db"] - cpu[k]["psnr_db"])} for k in cpu}
    res = {"card": card, "cpu": cpu, "delta": delta, "exact_card_vs_cpu": floor,
           "tol": QUALITY_TOL, "card_s": card_s, "cpu_s": cpu_s, "launches": launches}
    emit("quality", **res)
    if set(cpu) != QUALITY_CPU_KEYS or set(cpu) - set(card) or any(
            d[m] > QUALITY_TOL[m] for d in delta.values() for m in QUALITY_TOL):
        raise AssertionError(f"quality: card against CPU {delta}")
    # the ordering gate of tests/test_quality_gate.py on the card's curve
    rel = {k: r["rel_l2"] for k, r in card.items()}
    singles = [rel[k] for k in ("w8a8", "band_w2", "cache_i2", "guidance_q0.5")]
    if not (all(0 < v < 0.1 for v in rel.values())
            and rel["band_w4"] <= rel["band_w2"] <= rel["band_w1"]
            and rel["cache_i2"] <= rel["cache_i3"]
            and rel["guidance_q0.75"] <= rel["guidance_q0.5"]
            and max(singles) * 0.5 <= rel["fast_preset"] <= 2.0 * sum(singles)):
        raise AssertionError(f"quality: the card's curve fails the ordering gate: {card}")
    if any(launches[k] == 0 for k in ("K1", "K2", "K3", "K7q", "K7")):
        raise AssertionError(f"quality launches: {launches}")
    return res


# the multiview world model: the Sample-AV 7B's 76,320 tokens
MV_T2W_STEPS = 2  # both CFG: K1 = K2 = 2 x SIBLING_BLOCKS launches
MV_V2W_STEPS = 1
MV_HEAD_SLICE = 4  # K1 at 76,320 held to its plain version on these heads (the rest timed)
# the tiny fp32 multiview preset, card (3xTF32 attention, fp32 cuBLAS) against
# CPU on the same weights: the final latent's |delta| relative to mean |cpu|
# (set before the first run, PERF.md)
MV_TINY_TOL = {"max": 1e-3, "mean": 1e-4}
MV_TINY_STEPS = 3
# v2w: each view's first latent frame against the seed image's latent, relative
# to its largest |value| (the condition region is replaced on every step above
# the augment sigma; 1 step of 1 leaves only fp32 rounding)
MV_COND_TOL = 1e-2
MV_TRAIN_STEPS = 1
# the multiview train step's depth: the train phase's 12 blocks peak at 66.49
# GiB at 56,320 tokens on an H100, 35.1 GiB of it the state; its 31.4 GiB of
# activations scaled to 76,320 tokens (x 1.36) put 12 blocks at ~78 GiB, past
# the card. 10 blocks (2 x 2.9 GiB less state) peak at 71.2 GiB; 5 since serving_cp2,
# for the smoke's time
MV_TRAIN_BLOCKS = 5


def _randomize_mv(net, gen) -> None:
    """``randomize_gates`` and a random repeat-frame Linear, so that the
    frame-repeat negative condition reaches the output."""
    randomize_gates(net, gen)
    with torch.no_grad():
        for p in net.repeat_frame_embedding.parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=gen, device=p.device))


def _mv_k1_case(gen) -> dict:
    """K1 at the multiview 7B's (2, 76,320, 32, 128) bf16: the kernel on all
    heads, held to its plain version on MV_HEAD_SLICE heads (on all 32 it
    would take ~7 s); kernel, SDPA and bound over all heads, the plain ms
    over the slice ("plain_heads")."""
    from gen3c_tpu_torch import kernels

    shape = (2, 76320, 32, 128)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    before = dict(kernels.route_counts)
    out = kernels.attention(q, k, v)
    hs = slice(0, MV_HEAD_SLICE)
    sl = [t[:, :, hs] for t in (q, k, v)]
    ref, plain_ms = timed_call(lambda: kernels.attention_reference(*sl))
    err = (out[:, :, hs].float() - ref.float()).abs()
    res = {"name": "K1 self-attention, multiview 7B", "q": list(shape), "kv": list(shape),
           "dtype": "torch.bfloat16", "ragged_tail": shape[1] % 128,
           "checked_heads": MV_HEAD_SLICE, "max_abs_err": err.max().item(),
           "mean_abs_err": err.mean().item(), "finite": bool(torch.isfinite(out).all().item())}
    del out, ref, err
    B, L, H, D = shape
    flop = 4.0 * B * H * L * L * D
    res["ms"] = cuda_ms(lambda: kernels.attention(q, k, v), reps=3)
    res["plain_ms"] = plain_ms
    res["plain_heads"] = MV_HEAD_SLICE
    res.update(tflops=flop / res["ms"] / 1e9, library_ms=library_ms(lambda: _sdpa(q, k, v)),
               **bound(tensor_bytes(q, k, v, q), flop, BF16_PEAK_TFLOPS))
    res["bound_share"] = res["bound_ms"] / res["ms"]
    res["routes"] = route_delta(before)
    emit("kernel", **res)
    require_wgmma(res["name"], res["routes"])
    if not res["finite"] or res["max_abs_err"] > ATTN_TOL["max"] \
            or res["mean_abs_err"] > ATTN_TOL["mean"]:
        raise AssertionError(f"K1 at 76,320: kernel disagrees with its plain version: {res}")
    return res


def _mv_kernel_summary(case: dict) -> dict:
    """A multiview kernel case's shapes, times, bound and error; its plain
    version's ms is over ``plain_heads`` of the heads."""
    return {**{k: case[k] for k in ("q", "kv", "ms", "plain_ms", "library_ms", "bound_ms",
                                    "bound_by", "max_abs_err", "tflops")},
            "plain_heads": case.get("plain_heads", case["q"][2])}


def _mv_tiny_card_vs_cpu() -> dict:
    """cosmos_t2w_mv_tiny (fp32, 3 views) drawn on the CPU, its gates and
    repeat-frame Linear randomized there, copied to the card:
    generate_multiview_world's final latent on both."""
    from gen3c_tpu_torch.models.vae import VideoTokenizer
    from gen3c_tpu_torch.pipelines import text2world_multiview as tmv

    preset = tmv.MV_T2W_TINY
    cpu = tmv.build_model(preset, "cpu", seed=1, checkpoint_dir=None)
    _randomize_mv(cpu.net, torch.Generator().manual_seed(2))
    tok = cpu.tokenizer
    card = tmv.MultiviewModel(
        net=copy.deepcopy(cpu.net).to("cuda"),
        tokenizer=VideoTokenizer(copy.deepcopy(tok.vae).to("cuda"), tok.pixel_chunk_duration,
                                 tok.latent_mean, tok.latent_std, tok.spatial_resolution))
    t5 = np.random.default_rng(3).standard_normal((1, 3 * 512, 1024)).astype(np.float32)
    lat = {}
    for name, model in (("card", card), ("cpu", cpu)):
        record = {}
        tmv.generate_multiview_world(model, preset, t5, num_steps=MV_TINY_STEPS, seed=4,
                                     record=record)
        lat[name] = record["latent"].float()
    d = (lat["card"] - lat["cpu"]).abs()
    scale = lat["cpu"].abs().mean().item()
    return {"preset": preset.name, "steps": MV_TINY_STEPS, "rel_max": d.max().item() / scale,
            "rel_mean": d.mean().item() / scale, "tol": MV_TINY_TOL}


def _mv_run(preset_name: str, steps: int, root: str, extra: list) -> dict:
    """The multiview CLI's entry point on a seeded, gate-randomized 7B
    preset: its record, launches, routes, peak GiB and build s."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.pipelines import text2world_multiview as tmv

    args = tmv.create_parser().parse_args(
        ["--model_preset", preset_name, "--num_steps", str(steps), "--checkpoint_dir",
         os.path.join(root, "none"), "--video_save_folder", root, "--device", "cuda", *extra])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = tmv.build_model(tmv.resolve_preset(args), "cuda", seed=1,
                            checkpoint_dir=args.checkpoint_dir)
    _randomize_mv(model.net, torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    record = {}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with _depth(model.net, SIBLING_BLOCKS):
        paths = tmv.demo(args, built=model, record=record)
    torch.cuda.synchronize()
    cfg = model.net.cfg
    res = {"model": preset_name, "blocks": SIBLING_BLOCKS, "of_blocks": cfg.num_blocks,
           "channels": cfg.model_channels,
           "heads": cfg.num_heads, "views": cfg.n_views, "in_channels": cfg.in_channels,
           "dtype": str(cfg.dtype), "latent": list(record["latent"].shape),
           "tokens": int(np.prod(record["latent"].shape[2:])) // 4,
           "videos": [list(v.shape) for v in record["videos"]],
           "video_dtypes": sorted({str(v.dtype) for v in record["videos"]}),
           "latent_finite": bool(torch.isfinite(record["latent"]).all().item()),
           "step_s": [s["seconds"] for s in record["steps"]],
           "step_cfg": [s["cfg"] for s in record["steps"]],
           "decode_s_per_view": record["decode_seconds"], "build_model_s": build_s,
           "entry_point_s": time.perf_counter() - t0,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": dict(kernels.launch_counts), "routes": dict(kernels.route_counts),
           "saved": len(paths)}
    if cfg.in_channels > 16:  # v2w: each view's first latent frame against the seed's latent
        from gen3c_tpu_torch.utils.io import read_image_bcthw

        img = read_image_bcthw(extra[extra.index("--input_image_path") + 1], 480, 848)
        pad = np.concatenate([img] + [np.zeros_like(img)] * 56, axis=2)
        cond = model.encode(torch.from_numpy(pad).cuda())[:, :, 0].float().cpu()
        Tl = record["latent"].shape[2] // cfg.n_views
        res["condition_rel_err"] = max(
            ((record["latent"][:, :, v * Tl] - cond).abs().max() / cond.abs().max()).item()
            for v in range(cfg.n_views))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_mv_world() -> dict:
    """The multiview world model (phase 25 of the docstring): K1 and K2 at
    its shapes, the CLI in both modes at the 7B, the tiny preset card
    against CPU."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    kern = {"K1": _mv_k1_case(gen)}
    torch.cuda.empty_cache()
    # views folded into the batch: (2 x 6, 12,720) queries over each view's 512 keys
    kern["K2"] = _attention_case("K2 cross-attention, multiview 7B (views folded)",
                                 (12, 12720, 32, 128), (12, 512, 32, 128), torch.bfloat16,
                                 ATTN_TOL, gen)
    torch.cuda.empty_cache()
    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as root:
        t2w = _mv_run("cosmos_t2w_mv_7b", MV_T2W_STEPS, root, [])
        seed_png = os.path.join(root, "seed.png")
        _write_png(seed_png, _seed_image(480, 848, 5))
        v2w = _mv_run("cosmos_v2w_mv_7b", MV_V2W_STEPS, root,
                      ["--mode", "video2world", "--input_image_path", seed_png])
    tiny = _mv_tiny_card_vs_cpu()
    res = {"kernels": {k: _mv_kernel_summary(r) for k, r in kern.items()},
           "t2w": t2w, "v2w": v2w, "tiny_card_vs_cpu": tiny}
    emit("mv_world", **res)
    for run, steps in ((t2w, MV_T2W_STEPS), (v2w, MV_V2W_STEPS)):
        require_wgmma(f"mv_world {run['model']}", run["routes"])
        n = steps * run["blocks"]
        if (run["tokens"] != 76320 or run["videos"] != [[57, 480, 848, 3]] * 6
                or run["video_dtypes"] != ["uint8"] or not run["latent_finite"]
                or run["step_cfg"] != [True] * steps or run["saved"] != 6
                or run["launches"]["K1"] != n or run["launches"]["K2"] != n):
            raise AssertionError(f"mv_world {run['model']}: {run}")
    if v2w["condition_rel_err"] > MV_COND_TOL:
        raise AssertionError(f"mv_world v2w: the views' first frames left the seed: {v2w}")
    if tiny["rel_max"] > MV_TINY_TOL["max"] or tiny["rel_mean"] > MV_TINY_TOL["mean"]:
        raise AssertionError(f"mv_world: tiny card against CPU {tiny}")
    res["launches"] = {k: t2w["launches"][k] + v2w["launches"][k] for k in t2w["launches"]}
    res["kernel_cases"] = kern
    return res


def _train_one(cfg, batch, name: str, **step_kw) -> dict:
    """MV_TRAIN_STEPS train_steps of a seeded, gate-randomized net of
    ``cfg`` on ``batch`` (per-block remat, TrainerConfig's optimizer)."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.training.train import build_net
    from gen3c_tpu_torch.training.train_step import init_train_state, make_optimizer, train_step
    from gen3c_tpu_torch.training.trainer import TrainerConfig

    tc = TrainerConfig()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    net = build_net(cfg, "cuda", seed=0)
    randomize_gates(net, torch.Generator(device="cuda").manual_seed(1))
    opt = make_optimizer(lr=tc.lr, weight_decay=tc.weight_decay, grad_clip=tc.grad_clip,
                         warmup_steps=tc.warmup_steps, grad_accum_steps=tc.grad_accum_steps)
    state = init_train_state(net, opt)
    batch = {k: v.cuda() for k, v in batch.items()}
    gen = torch.Generator().manual_seed(0)
    kernels.reset_launch_counts()
    steps = []
    for _ in range(MV_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(state, batch, gen, cfg, opt, remat=True, **step_kw)
        torch.cuda.synchronize()
        steps.append({"s": time.perf_counter() - t0, "loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"])})
    x0 = batch["x0"]
    res = {"model": name, "blocks": cfg.num_blocks, "channels": cfg.model_channels,
           "params": sum(p.numel() for p in net.parameters()),
           "tokens": int(np.prod(x0.shape[2:])) // 4, "ctx_tokens": batch["crossattn_emb"].shape[1],
           "steps": steps, "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
           "launches": dict(kernels.launch_counts), "routes": dict(kernels.route_counts),
           "k4_by_forward": dict(kernels.k4_launches_by_forward)}
    del state, net, batch
    gc.collect()
    torch.cuda.empty_cache()
    per_step = 2 * cfg.num_blocks
    require_wgmma(f"mv_action_train {name}", res["routes"])
    if not all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) and s["grad_norm"] > 0
               for s in steps):
        raise AssertionError(f"mv_action_train {name}: non-finite or zero loss: {res}")
    if res["launches"]["K4"] != MV_TRAIN_STEPS * per_step:
        raise AssertionError(f"mv_action_train {name}: K4 launches {res['launches']}")
    return res


def phase_mv_action_train() -> dict:
    """One train step of the multiview 7B (76,320 tokens, video-extend with
    the per-view indicator) at MV_TRAIN_BLOCKS blocks and of
    video2world_action_7b (56,320 tokens, a (1, 1, 7) action) at
    TRAIN_BLOCKS_7B, with per-block remat (phase 26 of the docstring)."""
    import dataclasses

    from gen3c_tpu_torch.pipelines.text2world_multiview import MV_V2W_7B
    from gen3c_tpu_torch.utils.registry import get_experiment

    mv_cfg = dataclasses.replace(MV_V2W_7B.dit, num_blocks=MV_TRAIN_BLOCKS)
    _, VT, Hl, Wl = MV_V2W_7B.state_shape
    mv = _train_one(mv_cfg, _train_batch(mv_cfg, VT, Hl, Wl, 6 * 512, seed=0),
                    "cosmos_v2w_mv_7b", video_extend=True)
    act_cfg = dataclasses.replace(get_experiment("video2world_action_7b").dit,
                                  num_blocks=TRAIN_BLOCKS_7B)
    batch = _train_batch(act_cfg, LATENT_T_7B, 88, 160, 512, seed=1)
    batch["action"] = torch.randn((1, 1, 7), generator=torch.Generator().manual_seed(2))
    act = _train_one(act_cfg, batch, "video2world_action_7b", video_extend=True)
    res = {"multiview": mv, "action": act}
    emit("mv_action_train", **res)
    if mv["tokens"] != 76320 or act["tokens"] != 56320:
        raise AssertionError(f"mv_action_train tokens: {mv['tokens']}, {act['tokens']}")
    return res



# the AR world model: the 4B (ar_4b) at full width, seeded bf16 weights
AR_DECODE_TOKENS = 128  # of the uncut run's 7,680 (scripts/time_ar_world.py runs them all)
AR_4B_CACHE = (1, 12800, 8, 128)  # one layer of the 4B's KV cache: (B, max_seq, Hkv, d)
AR_PREFIX = 5120  # 2 of the grid's 5 latent frames of 40 x 64 tokens
# K8's decode against its plain version, relative to mean |plain| (a row
# over thousands of random keys is small: mean |out| about 0.018 at pos
# 5,120 and 0.012 at 12,799). Both round the output to bf16 and the plain
# version its logits too, in bf16 and int8 alike (the codes and scales are
# exact in both). On an H100: 0.027-0.042 max (one bf16 step at the largest
# outputs) and 0.004 mean over the four random cases, 0.042 / 0.004 (bf16)
# and 0.074 / 0.009 (int8) with the query on the last key. A reference with
# its first split dropped reads 0.17-0.27 mean on the random cases, one with
# its last key dropped 1.0 on the aligned ones: each case shows that its
# drop would fail these limits (``_k8_drops``)
K8_DECODE_TOL = {"max": 0.15, "mean": 0.03}
# the aligned decode case's queries: K8_ALIGN x their KV head's key at pos,
# a logit of about 0.8 x 128 / sqrt(128) = 9, half the softmax's weight
K8_ALIGN = 0.8
DECODE_TRACE_STEPS = 16  # untraced decode steps timed beside the traced one
DECODE_TRACE_TRIES = 5  # traced steps at most, until two in a row agree
K8_PLAIN_GROUP = 1  # K8's prefill held to its plain version on this many KV-head groups
AR_TINY_NEW = 192  # ar_tiny's generated tokens (the grid's last 3 of 4 latent frames)
# the diffusion decoder: one reflect-padded 8-latent-frame chunk at 80 x 128
DD_STEPS = 2  # of its 15 EDM-Euler steps (a 2-step schedule: every step the same kind)


def _k8_drops(q, k, v, pos: int, ks, vs, ref: torch.Tensor) -> dict:
    """The decode check's reach: the plain version with the last visible key
    dropped (causal offset pos - 1) and with K8's first key split dropped
    (kv_valid_start at the split's end: ``cuda.gqa_plan`` over the cache's
    capacity, ``cuda.gqa_split_range``), each held to the plain reference as
    K8 is; ``seen``: it would fail K8_DECODE_TOL."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.kernels import cuda

    B, _, Hq, _ = q.shape
    vis = pos + 1
    splits = cuda.gqa_plan(B, 1, Hq, k.shape[2], k.shape[1], cuda._sm_count(q.device.index or 0),
                           ks is not None)
    per = cuda.gqa_split_range(0, splits, 0, vis)[1]
    start = torch.full((B,), per, dtype=torch.long, device=q.device)
    out = {}
    for what, args in (("last key", (pos - 1, None)), ("first split", (pos, start))):
        rmax, rmean = _rel_err(kernels.gqa_attention_reference(q, k, v, *args, ks, vs), ref)
        out[what] = {"rel_max_err": rmax, "rel_mean_err": rmean,
                     "seen": rmax > K8_DECODE_TOL["max"] or rmean > K8_DECODE_TOL["mean"]}
    out["first split"]["keys"] = per
    return out


def _k8_case(gen, name: str, pos: int, int8: bool, prefill: bool = False,
             aligned: bool = False, cache: tuple = AR_4B_CACHE, hq: int = 32,
             prefill_len: int = AR_PREFIX) -> dict:
    """K8 on one layer of a filled seeded cache (B, capacity, Hkv, d), by
    default the 4B's (1, 12,800, 8, 128) with 32 query heads: decode (one
    query at ``pos`` over keys [0, pos]) or the ``prefill_len``-token
    prefill (5,120 for the 4B), bf16
    or int8 codes with fp32 scales (quantized as the cache stores them);
    aligned: each query head is K8_ALIGN x its KV head's key at pos, so that
    the last key carries half the output. Held to its plain version (the
    prefill on K8_PLAIN_GROUP KV-head groups to ATTN_TOL, decode to
    K8_DECODE_TOL with ``_k8_drops`` showing its reach). Timed: the kernel's
    and SDPA's (enable_gqa, over the visible keys; int8: on the dequantized
    bf16 K/V) device time the same way (``device_ms``: torch.profiler's
    kernel durations, the L2 read over before each call; a time under the
    bound fails the case), beside it the CUDA-event time of calls back to
    back, which includes the host's time between launches where it exceeds
    the kernel's, and the wrapper's host microseconds a call; the plain
    version by CUDA events. The bound over the visible keys only. ``s``:
    the case's seconds, ``device_timing_s`` those of its device_ms and
    host_us calls."""
    import torch.nn.functional as F

    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.kernels import cuda
    from gen3c_tpu_torch.models.dit import quantize_span_delta

    t_case = time.perf_counter()
    B, S, Hkv, D = cache
    Hq, rep = hq, hq // Hkv
    Lq = prefill_len if prefill else 1
    vis = prefill_len if prefill else pos + 1
    k, v = (torch.randn(cache, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    ks = vs = None
    if int8:
        (k, ks), (v, vs) = quantize_span_delta(k), quantize_span_delta(v)
    q = torch.randn((B, Lq, Hq, D), generator=gen, device="cuda").to(torch.bfloat16)
    if aligned:
        key = k[:, pos].float() * (ks[:, pos] if int8 else 1.0)  # (B, Hkv, D)
        q[:, 0] = (K8_ALIGN * key).repeat_interleave(rep, dim=1).to(q.dtype)
    out = kernels.gqa_attention(q, k, v, pos, None, ks, vs)
    g = slice(0, K8_PLAIN_GROUP if prefill else Hkv)
    h = slice(0, g.stop * rep)
    plain_args = (q[:, :, h], k[:, :, g], v[:, :, g], pos, None,
                  None if ks is None else ks[:, :, g], None if vs is None else vs[:, :, g])
    ref = kernels.gqa_attention_reference(*plain_args)
    torch.cuda.synchronize()
    err = (out[:, :, h].float() - ref.float()).abs()
    res = {"name": name, "q": [B, Lq, Hq, D], "cache": list(cache), "pos": pos,
           "visible_keys": vis, "int8": int8, "aligned": aligned, "plain_heads": h.stop,
           "max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
           "mean_abs_plain": ref.float().abs().mean().item(),
           "finite": bool(torch.isfinite(out).all().item())}
    if prefill:
        res["tol"] = ATTN_TOL
        failed = res["max_abs_err"] > ATTN_TOL["max"] or res["mean_abs_err"] > ATTN_TOL["mean"]
    else:
        res["rel_max_err"], res["rel_mean_err"] = _rel_err(out[:, :, h], ref)
        res.update(tol=K8_DECODE_TOL, drops=_k8_drops(*plain_args[:4], *plain_args[5:], ref))
        failed = (res["rel_max_err"] > K8_DECODE_TOL["max"]
                  or res["rel_mean_err"] > K8_DECODE_TOL["mean"])
    del out, ref, err
    calls = 1 if prefill else 20

    def k8():
        return kernels.gqa_attention(q, k, v, pos, None, ks, vs)

    res["route"] = cuda.gqa_route(q, k, v, int8)
    t_timing = time.perf_counter()
    dev = device_ms(k8, calls=3 if prefill else 20)
    res["host_and_device_ms"] = cuda_ms(k8, reps=3, calls=calls)
    res["ms"], res["kernels_a_call"], res["kernel_names"] = dev["ms"], dev["kernels"], dev["names"]
    res["profile_tries"] = dev["tries"]
    res["host_us"] = host_us(k8, calls=3 if prefill else 20)
    timing_s = time.perf_counter() - t_timing
    res["plain_ms"] = cuda_ms(lambda: kernels.gqa_attention_reference(*plain_args), reps=1,
                              calls=calls)
    kd, vd = k[:, :vis], v[:, :vis]
    if int8:
        kd = (kd.float() * ks[:, :vis]).to(torch.bfloat16)
        vd = (vd.float() * vs[:, :vis]).to(torch.bfloat16)
    qt, kt, vt = q.transpose(1, 2), kd.transpose(1, 2), vd.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=prefill, enable_gqa=True)

    t_timing = time.perf_counter()
    lib_dev = device_ms(sdpa, calls=3 if prefill else 20)
    timing_s += time.perf_counter() - t_timing
    res["library_host_and_device_ms"] = library_ms(sdpa, calls=calls)
    res["library_ms"], res["library_kernels_a_call"] = lib_dev["ms"], lib_dev["kernels"]
    res["library_kernel_names"], res["library_profile_tries"] = lib_dev["names"], lib_dev["tries"]
    res["library_call"] = "F.scaled_dot_product_attention(enable_gqa=True" + (
        ", is_causal=True)" if prefill else ")") + (" on dequantized bf16 K/V" if int8 else "")
    pairs = Lq * (Lq + 1) // 2 if prefill else vis
    kv_bytes = 2 * vis * Hkv * D * k.element_size() + (2 * vis * Hkv * 4 if int8 else 0)
    res.update(bound(kv_bytes + 2 * tensor_bytes(q), 4.0 * Hq * D * pairs, BF16_PEAK_TFLOPS))
    res["bound_share"] = res["bound_ms"] / res["ms"]
    res["s"], res["device_timing_s"] = time.perf_counter() - t_case, timing_s
    emit("kernel", **res)
    if not res["finite"] or failed:
        raise AssertionError(f"{name}: kernel disagrees with its plain version: {res}")
    if min(res["ms"], res["library_ms"]) < res["bound_ms"]:
        raise AssertionError(f"{name}: a device time under the bound is no reading: {res}")
    if not prefill and not res["drops"]["last key" if aligned else "first split"]["seen"]:
        raise AssertionError(f"{name}: the check cannot see a dropped key range: {res}")
    del q, k, v, ks, vs, kd, vd
    torch.cuda.empty_cache()
    return res


def _decode_step_trace(model, prefix: torch.Tensor) -> dict:
    """One decode step of the 4B as ``generate`` takes it (the forward on a
    bf16 cache after a prefill of ``prefix``, then top-p sampling), traced by
    torch.profiler: the kernels it launches (K8 and PyTorch's) and the
    device's busy time (the union of its kernels and copies), beside the
    seconds of DECODE_TRACE_STEPS untraced steps (host and device, from
    synchronize to synchronize): the device's busy share of a step and K8's
    kernels' share. A profile now and then loses kernels, so steps are
    traced until two in a row hold as many (at most DECODE_TRACE_TRIES)."""
    from torch.profiler import ProfilerActivity, profile

    from gen3c_tpu_torch.models.ar_transformer import _sample, init_kv_cache, torch_gumbel

    cache = init_kv_cache(model.cfg, 1, device="cuda")
    noise = torch_gumbel(torch.Generator(device="cuda").manual_seed(0))
    logits, _ = model(prefix, cache=cache)
    tok = _sample(logits[:, -1], 0, 1.0, 0, 0.8, noise)

    def step(i):
        logits, _ = model(tok[:, None], cache=cache)
        return _sample(logits[:, -1], i, 1.0, 0, 0.8, noise)

    tok = step(1)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(DECODE_TRACE_STEPS):
        tok = step(2 + i)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / DECODE_TRACE_STEPS
    traced = []
    for i in range(DECODE_TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            tok = step(2 + DECODE_TRACE_STEPS + i)
            torch.cuda.synchronize()
        dev = sorted(((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA))
        traced.append(len(dev))
        if dev and traced[-2:] == [len(dev)] * 2:
            break
    else:
        raise AssertionError(f"ar_world: no two traced decode steps agree on their kernels "
                             f"({traced}): the profiles lost kernels")
    busy_us, end = 0.0, float("-inf")
    for a, b, _ in dev:  # the union of the intervals
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    copies = sum(1 for *_, n in dev if n.lower().startswith(("memcpy", "memset")))
    gqa_us = sum(b - a for a, b, n in dev if "gqa" in n)
    del cache
    return {"kernels": len(dev) - copies, "copies": copies, "traced": traced,
            "gqa": sum(1 for *_, n in dev if "gqa" in n), "position": int(prefix.shape[1]),
            "step_s": step_s, "untraced_steps": DECODE_TRACE_STEPS,
            "device_busy_s": busy_us / 1e6, "device_busy_share": busy_us / 1e6 / step_s,
            "gqa_kernel_s": gqa_us / 1e6, "gqa_share": gqa_us / 1e6 / step_s}


def _ar_tiny_card_vs_cpu() -> dict:
    """ar_tiny (fp32) drawn on the CPU and copied to the card; one greedy
    generate of AR_TINY_NEW tokens after a 64-token prompt on each, TF32 off
    (fp32 cuBLAS and K8's fp32 body on the card): the tokens must agree."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.models.ar_transformer import generate
    from gen3c_tpu_torch.pipelines.autoregressive import AR_PRESETS, build_ar_model

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu = build_ar_model(AR_PRESETS["ar_tiny"], "cpu", seed=2)
        card = copy.deepcopy(cpu).to("cuda")
        prompt = torch.randint(0, 64000, (1, 64), generator=torch.Generator().manual_seed(3))
        before = kernels.launch_counts["K8"]
        got = generate(card, prompt.cuda(), AR_TINY_NEW, temperature=0.0).cpu()
        k8 = kernels.launch_counts["K8"] - before
        want = generate(cpu, prompt, AR_TINY_NEW, temperature=0.0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return {"preset": "ar_tiny", "new_tokens": AR_TINY_NEW,
            "equal": bool(torch.equal(got, want)),
            "first_difference": int((got != want).nonzero()[0, 1]) if not torch.equal(got, want)
            else None, "card_k8_launches": k8}


def phase_ar_world() -> dict:
    """The Cosmos AR world model at the 4B's full width (phase 27 of the
    docstring); returns its record with the bf16 run's token grid."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.pipelines import autoregressive as ar

    gen = torch.Generator(device="cuda").manual_seed(16)
    kern = {}
    t0 = time.perf_counter()
    for name, pos, int8, prefill in (
            ("K8 decode bf16 pos 5,120", AR_PREFIX, False, False),
            ("K8 decode bf16 pos 12,799", AR_4B_CACHE[1] - 1, False, False),
            ("K8 decode int8 pos 5,120", AR_PREFIX, True, False),
            ("K8 decode int8 pos 12,799", AR_4B_CACHE[1] - 1, True, False),
            ("K8 prefill bf16 5,120", 0, False, True),
            ("K8 prefill int8 5,120", 0, True, True)):
        kern[name] = _k8_case(gen, name, pos, int8, prefill)
    for name, pos, int8 in (("K8 decode bf16 pos 5,120 aligned", AR_PREFIX, False),
                            ("K8 decode int8 pos 12,799 aligned", AR_4B_CACHE[1] - 1, True)):
        kern[name] = _k8_case(gen, name, pos, int8, aligned=True)
    k8_cases_s = time.perf_counter() - t0
    preset = ar.AR_PRESETS["ar_4b"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = ar.build_ar_model(preset, "cuda", seed=0)
    tokenizer = ar.build_dv_tokenizer(preset, "cuda", seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    clip = torch.rand((1, 3, preset.chunk, preset.height, preset.width),
                      generator=torch.Generator(device="cuda").manual_seed(4),
                      device="cuda") * 2 - 1
    runs = {}
    for kv in ("bf16", "int8"):
        record = {}
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        grid = ar.generate_world_tokens(model, tokenizer, clip, temperature=1.0, top_p=0.8,
                                        quantize_kv=kv == "int8", seed=0,
                                        max_new_tokens=AR_DECODE_TOKENS, record=record)
        torch.cuda.synchronize()
        launches = dict(kernels.launch_counts)
        runs[kv] = {"grid": list(grid.shape), "grid_max": int(grid.max()),
                    "grid_min": int(grid.min()), "encode_s": record["encode_s"][0],
                    "prefill_s": record["prefill_s"][0],
                    "s_per_decode_token": record["decode_s"][0] / (AR_DECODE_TOKENS - 1),
                    "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                    "launches": launches}
        if kv == "bf16":
            bf16_grid = grid
    prefix = bf16_grid[:, :2].reshape(1, -1)
    step = _decode_step_trace(model, prefix)
    t0 = time.perf_counter()
    frames = tokenizer.decode(bf16_grid)
    torch.cuda.synchronize()
    decode = {"s": time.perf_counter() - t0, "shape": list(frames.shape),
              "finite": bool(torch.isfinite(frames).all().item())}
    del model, tokenizer, frames, clip
    gc.collect()
    torch.cuda.empty_cache()
    tiny = _ar_tiny_card_vs_cpu()
    res = {"model": "ar_4b", "params": n_params, "dtype": "bfloat16", "layers": 16,
           "prefix_tokens": int(prefix.shape[1]), "decode_tokens": AR_DECODE_TOKENS,
           "build_s": build_s, "runs": runs, "decode_step": step,
           "dv_decode": decode, "tiny_card_vs_cpu": tiny,
           "kernel_cases": {k: {kk: r[kk] for kk in (
               "ms", "host_and_device_ms", "host_us", "kernels_a_call", "route", "plain_ms",
               "library_ms", "library_kernels_a_call", "library_host_and_device_ms", "bound_ms",
               "bound_by", "max_abs_err", "visible_keys", "s", "device_timing_s")}
               for k, r in kern.items()},
           "k8_cases_s": k8_cases_s}
    emit("ar_world", **res)
    for kv, run in runs.items():
        if (run["grid"] != [1, 5, 40, 64] or run["grid_min"] < 0 or run["grid_max"] >= 64000
                or run["launches"]["K8"] != 16 * AR_DECODE_TOKENS):
            raise AssertionError(f"ar_world {kv}: {run}")
    if decode["shape"] != [1, 3, 33, 640, 1024] or not decode["finite"]:
        raise AssertionError(f"ar_world: DV decode {decode}")
    if step["gqa"] != 16:
        raise AssertionError(f"ar_world: K8 is not one launch a layer in a decode step: {step}")
    routes = {n: c["route"] for n, c in kern.items()}
    if (routes.pop("K8 prefill bf16 5,120") != "wgmma"
            or routes.pop("K8 prefill int8 5,120") != "mma_sync"
            or set(routes.values()) != {"decode"}):
        raise AssertionError(f"ar_world: K8 took another body: {routes}")
    if not tiny["equal"] or tiny["card_k8_launches"] != 2 * AR_TINY_NEW:
        raise AssertionError(f"ar_world: ar_tiny card against CPU {tiny}")
    res["kernels"] = kern
    res["launches"] = {k: runs["bf16"]["launches"][k] + runs["int8"]["launches"][k]
                       for k in runs["bf16"]["launches"]}
    res["grid"] = bf16_grid
    return res


def phase_dd(grid: torch.Tensor) -> dict:
    """The seeded 7B diffusion decoder on ar_world's (1, 5, 40, 64) grid
    (phase 28 of the docstring)."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.pipelines import diffusion_decoder as dd

    gen = torch.Generator(device="cuda").manual_seed(17)
    kern = {"K1": _attention_case("K1 self-attention, diffusion decoder 7B", (2, 20480, 32, 128),
                                  (2, 20480, 32, 128), torch.bfloat16, ATTN_TOL, gen),
            "K2": _attention_case("K2 cross-attention, diffusion decoder 7B", (2, 20480, 32, 128),
                                  (2, 512, 32, 128), torch.bfloat16, ATTN_TOL, gen)}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = dd.make_dd_pipeline(dd.DIFFUSION_DECODER_7B, dd.CV8x8x8,
                               dd.DDSamplingConfig(num_steps=DD_STEPS), 2, "cuda", seed=0)
    randomize_gates(pipe.net, torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    chunks = pipe.chunks(grid)
    record = {}
    kernels.reset_launch_counts()
    before = dict(kernels.route_counts)
    video = pipe.refine(grid, seed=0, record=record)[:, :, :33]
    torch.cuda.synchronize()
    cfg = pipe.net.cfg
    res = {"model": "diffusion_decoder_7b", "blocks": cfg.num_blocks,
           "channels": cfg.model_channels, "in_channels": cfg.in_channels,
           "chunks": [list(c.shape) for c in chunks],
           # DiT tokens: the chunk's token grid at the latent scale, in 2 x 2 patches
           "tokens": int(np.prod(chunks[0].shape[2:]))
           * (pipe.token_to_latent_scale // cfg.patch_spatial) ** 2,
           "steps": DD_STEPS, "step_s": record["step_s"], "decode_s": record["decode_s"],
           "build_s": build_s, "video": list(video.shape),
           "finite": bool(torch.isfinite(video).all().item()),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": dict(kernels.launch_counts), "routes": route_delta(before),
           "kernel_cases": {k: _mv_kernel_summary(r) for k, r in kern.items()}}
    emit("dd", **res)
    require_wgmma("dd", res["routes"])
    n = DD_STEPS * cfg.num_blocks
    if (res["tokens"] != 20480 or res["chunks"] != [[1, 1, 8, 40, 64]]
            or res["video"] != [1, 3, 33, 640, 1024] or not res["finite"]
            or res["launches"]["K1"] != n or res["launches"]["K2"] != n):
        raise AssertionError(f"dd: {res}")
    del pipe, video
    gc.collect()
    torch.cuda.empty_cache()
    res["kernels"] = kern
    return res


# the guardrails and the prompt upsampler: every model at its published
# width with seeded weights built on the card, a stand-in tokenizer
GUARD_PROMPT = ("A slow aerial shot over a misty pine forest at dawn: a narrow river winds "
                "between the trees, sunlight breaks through low clouds and lights the water, and "
                "a flock of birds circles above the canopy before the camera tilts toward them.")
GUARD_BLOCKED_WORDS = ["forbiddenword"]
GUARD_BLOCKED_PROMPT = "a forbiddenword drawn on the forest floor"
GUARD_K8_POS = 256  # the guards' K8 decode cases: a visible position near their prompts'
GUARD_CUT_LAYERS = 2
# the first new token's logits of a 2-layer full-width cut: the card in bf16
# (the path's own arithmetic) against the CPU in fp32 on the same weights,
# relative to mean |CPU logit|; bf16 rounds the activations and the K/V
# cache (2^-8 relative) and the logits sum 4,096-5,120 products of them
GUARD_CUT_TOL = {"max": 0.1, "mean": 0.02}
AEGIS_LORA = (16, 32.0)  # (r, alpha) of the seeded adapter, on q/k/v/o and the MLP
AEGIS_TARGETS = (("self_attn", "q_proj"), ("self_attn", "k_proj"), ("self_attn", "v_proj"),
                 ("self_attn", "o_proj"), ("mlp", "gate_proj"), ("mlp", "up_proj"),
                 ("mlp", "down_proj"))
VIDEO_FRAMES = 121
SIGLIP_CPU_FRAMES = 2
# SigLIP features and RetinaFace loc / conf, card against CPU, fp32 on both
# (TF32 off for matmuls and convolutions; SigLIP's attention 3xTF32 on the
# card, within 1e-4 of fp32), relative to mean |CPU|
VISION_TOL = {"max": 1e-3, "mean": 1e-4}
SAFE_BIAS = 10.0  # the seeded head's bias toward "Safe": the runner passes, the blur runs
UNSAFE_CLASS = 2  # "Violence": the seeded head biased to it blocks at frame 0
RETINA_LOW = (0.5, (20, 20))  # (threshold, min_size) of the one-frame run held to the CPU
RETINA_BOX_AGREE = 0.99  # boxes within 0.5 px of one on the other device, each way
UPSAMPLER_NEW_TOKENS = 32  # of the reference's 400


class StandInTokenizer:
    """The smoke's tokenizer (the card's machine has no transformers): byte b
    is id BYTE_BASE + b, "[IMG]" the image id, one fixed chat template; decode
    keeps the bytes and records the ids it was given."""

    BYTE_BASE = 1000
    eos_token_id = 2
    chat_template = "<s>[INST] {} [/INST]"

    def __init__(self, image_token_id: int = 10):
        self.image_token_id = image_token_id
        self.decoded = []

    def encode(self, text: str) -> list:
        ids = []
        for i, part in enumerate(text.split("[IMG]")):
            if i:
                ids.append(self.image_token_id)
            ids += [self.BYTE_BASE + b for b in part.encode("utf-8")]
        return ids

    def apply_chat_template(self, chat, return_tensors="np", add_generation_prompt=False):
        text = self.chat_template.format("\n".join(m["content"] for m in chat))
        return np.asarray([self.encode(text)], np.int64)

    def __call__(self, texts, add_special_tokens=False, return_tensors="np"):
        return {"input_ids": np.asarray([self.encode(t) for t in texts], np.int64)}

    def decode(self, ids, skip_special_tokens=True) -> str:
        ids = np.asarray(ids).reshape(-1)
        self.decoded.append(ids.copy())
        return bytes(int(i) - self.BYTE_BASE for i in ids
                     if self.BYTE_BASE <= i < self.BYTE_BASE + 256).decode("utf-8", "replace")


def _guard_configs() -> dict:
    """The published text models' shapes: Llama-Guard-3-8B, LlamaGuard-7b
    (Aegis's base) and Pixtral-12B's text model at 40 heads of 128 (its real
    32 heads of 128 in a 5,120-wide model is a head width neither package's
    ARConfig can hold)."""
    from gen3c_tpu_torch.models.ar_transformer import ARConfig

    common = dict(norm_eps=1e-5, use_qk_normalization=False, dtype=torch.bfloat16)
    return {
        "llama_guard_3_8b": ARConfig(dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
                                     vocab_size=128256, ffn_hidden_size=14336,
                                     rope_theta=500000.0, max_seq_len=4096,
                                     rope_scaling=(8.0, 1.0, 4.0, 8192), **common),
        "llama_guard_7b": ARConfig(dim=4096, n_layers=32, n_heads=32, n_kv_heads=32,
                                   vocab_size=32000, ffn_hidden_size=11008, rope_theta=10000.0,
                                   max_seq_len=4096, **common),
        "pixtral_12b_text": ARConfig(dim=5120, n_layers=40, n_heads=40, n_kv_heads=8,
                                     vocab_size=131072, ffn_hidden_size=14336,
                                     rope_theta=1e9, max_seq_len=4300, **common),
    }


def _bucketed(cfg, ids: np.ndarray, new_tokens: int):
    """generate_bucketed's left padding of one row: (padded (1, Lpad), pad)."""
    from gen3c_tpu_torch.models.ar_transformer import _bucket_length

    lpad = _bucket_length(ids.shape[-1], 128, cfg, new_tokens)
    padded = np.zeros((1, lpad), np.int64)
    padded[0, lpad - ids.shape[-1]:] = ids.reshape(-1)
    return padded, lpad - ids.shape[-1]


def _ar_cut_check(model, ids: np.ndarray, new_tokens: int) -> dict:
    """The first new token's logits, as generate_bucketed's prefill forms
    them (left-padded, on a cache), of a GUARD_CUT_LAYERS-layer cut of
    ``model`` (its first layers, final norm and output): on the card in the
    model's dtype, on the CPU in fp32 from the same weights. Both start
    from the card's token embeddings of the padded ids (the forward's
    input_embeddings), the cut's own output is the identity and the output
    projection is applied to the last row alone: the token table's copy and
    the projection of every row would be most of the CPU's time."""
    import dataclasses

    import torch.nn as nn
    import torch.nn.functional as F

    from gen3c_tpu_torch.models.ar_transformer import ARTransformer, init_kv_cache

    cfg = dataclasses.replace(model.cfg, n_layers=GUARD_CUT_LAYERS)
    with torch.device("meta"):
        cut, cpu = ARTransformer(cfg), ARTransformer(dataclasses.replace(cfg,
                                                                         dtype=torch.float32))
    for m, dev, dt in ((cut, "cuda", cfg.dtype), (cpu, "meta", torch.float32)):
        m.tok_embeddings = nn.Embedding(1, cfg.dim, device=dev, dtype=dt)  # unread
        m.output = nn.Linear(cfg.dim, cfg.dim, bias=False, device=dev, dtype=dt)
    cut.norm = model.norm
    cut.layers = nn.ModuleList(list(model.layers[:GUARD_CUT_LAYERS]))
    with torch.no_grad():
        cut.output.weight.copy_(torch.eye(cfg.dim))
    cpu = cpu.to_empty(device="cpu")
    cpu.load_state_dict({k: v.cpu().float() for k, v in cut.state_dict().items()})
    padded, pad = _bucketed(cfg, ids, new_tokens)
    emb = model.embed(torch.from_numpy(padded).cuda())

    def first(m, dev, w_out):
        cache = init_kv_cache(m.cfg, 1, dtype=m.cfg.dtype, device=dev)
        h, _ = m(None, cache=cache, pad_lens=torch.tensor([pad], device=dev),
                 input_embeddings=emb.to(dev, m.cfg.dtype))
        h = h[0, -1].to(m.cfg.dtype)  # the normed row (the identity's output), in m's dtype
        return F.linear(h, w_out).float().cpu()

    t0 = time.perf_counter()
    got = first(cut, "cuda", model.output.weight)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = first(cpu, "cpu", model.output.weight.cpu().float())
    cpu_s = time.perf_counter() - t0
    del cpu
    return {"layers": GUARD_CUT_LAYERS, "tokens": int(padded.shape[1]), "pad": pad,
            "err": _cut_rel_err(got, want), "argmax_equal": int(got.argmax()) == int(want.argmax()),
            "finite": bool(torch.isfinite(got).all()), "card_s": card_s, "cpu_s": cpu_s}


def _seeded_lora(cfg, gen) -> dict:
    """A PEFT-named LoRA adapter of rank AEGIS_LORA[0] on every projection of
    every layer, A and B N(0, 0.02) on the card."""
    r = AEGIS_LORA[0]
    hd = cfg.dim // cfg.n_heads
    dims = {"q_proj": (cfg.dim, cfg.n_heads * hd), "k_proj": (cfg.dim, cfg.n_kv_heads * hd),
            "v_proj": (cfg.dim, cfg.n_kv_heads * hd), "o_proj": (cfg.n_heads * hd, cfg.dim),
            "gate_proj": (cfg.dim, cfg.ffn_hidden_size), "up_proj": (cfg.dim, cfg.ffn_hidden_size),
            "down_proj": (cfg.ffn_hidden_size, cfg.dim)}
    state = {}
    for i in range(cfg.n_layers):
        for block, proj in AEGIS_TARGETS:
            din, dout = dims[proj]
            key = f"base_model.model.model.layers.{i}.{block}.{proj}.lora_A.weight"
            state[key] = torch.empty(r, din, device="cuda").normal_(0, 0.02, generator=gen)
            state[key.replace("lora_A", "lora_B")] = torch.empty(dout, r, device="cuda").normal_(
                0, 0.02, generator=gen)
    return state


def _case_summary(r: dict) -> dict:
    keys = ("ms", "host_and_device_ms", "route", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "max_abs_err", "visible_keys", "q", "kv", "cache", "routes")
    return {k: r[k] for k in keys if k in r}


def _llm_guard(kind: str, seed: int) -> dict:
    """One LLM guard at full width in the text runner (the blocklist, then
    the guard): two runs of the ~200-character prompt (seconds, K8's
    launches and routes, the new ids, which must repeat), the blocklisted
    prompt (refused with no K8 launch), the 2-layer cut on the card and the
    CPU."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.aux import guardrail as G

    cfg = _guard_configs()["llama_guard_3_8b" if kind == "LlamaGuard3" else "llama_guard_7b"]
    cls = G.LlamaGuard3 if kind == "LlamaGuard3" else G.Aegis
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = G._build_ar(cfg, "cuda").init_random(gen)
    merged = None
    if cls is G.Aegis:
        adapter = _seeded_lora(cfg, gen)
        merged = G.merge_peft_lora_into_llama(model, adapter, alpha=AEGIS_LORA[1], r=AEGIS_LORA[0])
        del adapter
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    tok = StandInTokenizer()
    guard = cls(model, tok)
    runner = G.GuardrailRunner([G.Blocklist(extra_words=GUARD_BLOCKED_WORDS), guard])
    ids = guard.prompt_ids(GUARD_PROMPT)
    runs = []
    for _ in range(2):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        verdict = runner.run(GUARD_PROMPT)
        torch.cuda.synchronize()
        runs.append({"s": time.perf_counter() - t0, "verdict": verdict,
                     "k8": kernels.launch_counts["K8"], "new_ids": tok.decoded[-1].tolist()})
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    blocked = runner.run(GUARD_BLOCKED_PROMPT)
    blocked_s = time.perf_counter() - t0
    blocked_k8 = kernels.launch_counts["K8"]
    cut = _ar_cut_check(model, ids, cls.NEW_TOKENS)
    res = {"guard": kind, "params": sum(p.numel() for p in model.parameters()),
           "layers": cfg.n_layers, "heads": [cfg.n_heads, cfg.n_kv_heads], "dim": cfg.dim,
           "vocab": cfg.vocab_size, "lora_merged": merged, "build_s": build_s,
           "prompt_tokens": int(ids.shape[1]),
           "bucket": int(_bucketed(cfg, ids, cls.NEW_TOKENS)[0].shape[1]),
           "new_tokens": cls.NEW_TOKENS, "runs": [{k: r[k] for k in ("s", "verdict", "k8")}
                                                 for r in runs],
           "ids_repeat": runs[0]["new_ids"] == runs[1]["new_ids"],
           "new_ids_head": runs[0]["new_ids"][:8], "blocked": blocked, "blocked_s": blocked_s,
           "blocked_k8": blocked_k8, "cut": cut, "cut_tol": GUARD_CUT_TOL,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del runner, guard, model
    gc.collect()
    torch.cuda.empty_cache()
    emit("guardrail_text", **res)
    k8 = cfg.n_layers * cls.NEW_TOKENS
    if (any(r["k8"] != k8 or not isinstance(r["verdict"], bool) for r in runs)
            or not res["ids_repeat"] or len(runs[0]["new_ids"]) != cls.NEW_TOKENS
            or runs[0]["verdict"] != runs[1]["verdict"]):
        raise AssertionError(f"guardrail {kind}: {res}")
    if blocked is not False or blocked_k8 != 0:
        raise AssertionError(f"guardrail {kind}: the blocklisted prompt reached the model: {res}")
    if (cls is G.Aegis and merged != cfg.n_layers * len(AEGIS_TARGETS)) or not cut["finite"] or any(
            cut["err"][k] > GUARD_CUT_TOL[k] for k in GUARD_CUT_TOL):
        raise AssertionError(f"guardrail {kind}: the card and the CPU disagree on the cut: {res}")
    return res


def _video_clip(frames: int, h: int, w: int, seed: int) -> np.ndarray:
    """A seeded (T, H, W, 3) uint8 clip: 32-pixel colour blocks panning one
    block a frame, with noise."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (h // 32 + 1, w // 32 + 1 + frames, 3)).astype(np.int16)
    out = np.empty((frames, h, w, 3), np.uint8)
    for t in range(frames):
        block = np.repeat(np.repeat(coarse[:, t:t + w // 32 + 1], 32, 0), 32, 1)[:h, :w]
        out[t] = np.clip(block + rng.integers(-8, 9, (h, w, 3)), 0, 255)
    return out


def _box_agreement(a: np.ndarray, b: np.ndarray) -> float:
    """The smaller of the fractions of a's boxes within 0.5 px of one of b's
    and of b's within 0.5 px of one of a's (1.0 for two empty sets)."""
    if len(a) == 0 or len(b) == 0:
        return float(len(a) == len(b))
    near = np.abs(a[:, None, :] - b[None, :, :]).max(-1) <= 0.5
    return float(min(near.any(1).mean(), near.any(0).mean()))


def _video_guard(seed: int) -> dict:
    """The video runner (SigLIP so400m + the 7-class head, then the
    RetinaFace face blur) on a seeded 121-frame 704x1280 clip, with checks
    against the CPU."""
    import copy as _copy

    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.aux import guardrail as G
    from gen3c_tpu_torch.aux import retinaface as R
    from gen3c_tpu_torch.aux import siglip as S

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    encoder = S.SiglipVisionModel(S.SiglipVisionConfig(), device="cuda").init_random(gen)
    head = S.SafetyClassifier(encoder.cfg.hidden_size, device="cuda").init_random(gen)
    with torch.no_grad():
        head.layers[6].bias[0] = SAFE_BIAS
    net = R.init_retinaface_params(torch.Generator().manual_seed(seed)).to("cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    filt, blur = G.VideoContentSafetyFilter(encoder, head), G.RetinaFaceFilter(net)
    runner = G.GuardrailRunner([filt], postprocessors=[blur])
    clip = _video_clip(VIDEO_FRAMES, 704, 1280, seed)
    parts = {}

    def timed(fn, key):
        def run(*args):
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            parts[key] = time.perf_counter() - t
            return out
        return run

    filt.is_safe, blur.postprocess = timed(filt.is_safe, "filter_s"), timed(blur.postprocess,
                                                                           "blur_s")
    kernels.reset_launch_counts()
    before = dict(kernels.route_counts)
    t0 = time.perf_counter()
    out = runner.run(clip)
    run_s = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    routes = route_delta(before)
    del filt.is_safe, blur.postprocess
    # the seeded head biased to an unsafe class instead: refused at frame 0
    with torch.no_grad():
        head.layers[6].bias[0], head.layers[6].bias[UNSAFE_CLASS] = 0.0, SAFE_BIAS
    unsafe = filt.is_safe(clip[:filt.batch_size])
    refused = runner.run(clip[:filt.batch_size])
    with torch.no_grad():
        head.layers[6].bias[0], head.layers[6].bias[UNSAFE_CLASS] = SAFE_BIAS, 0.0
    # SigLIP's features and RetinaFace's loc / conf, card against CPU
    pixels = torch.from_numpy(np.stack([S.preprocess_frame(f) for f in clip[:SIGLIP_CPU_FRAMES]]))
    feats = encoder(pixels.cuda()).cpu()
    enc_cpu = _copy.deepcopy(encoder).to("cpu")
    t0 = time.perf_counter()
    feats_cpu = enc_cpu(pixels)
    siglip_cpu_s = time.perf_counter() - t0
    del enc_cpu
    frame = torch.from_numpy(clip[:1].astype(np.float32)).flip(-1) - torch.tensor(R.BGR_MEANS)
    frame = frame.permute(0, 3, 1, 2).contiguous()
    loc, conf = (t.cpu() for t in net(frame.cuda()))
    net_cpu = _copy.deepcopy(net).to("cpu")
    t0 = time.perf_counter()
    loc_cpu, conf_cpu = net_cpu(frame)
    retina_cpu_s = time.perf_counter() - t0
    # a lower threshold: tens of the seeded detector's boxes are pixelated,
    # on the card and on the CPU
    thr, min_size = RETINA_LOW
    priors, scale = R.prior_boxes(704, 1280), np.array([1280, 704, 1280, 704], np.float32)
    boxes = [R.filter_detected_boxes(R.decode_boxes(lc.numpy(), priors)[0] * scale,
                                     cf[0, :, 1].numpy(), confidence_threshold=thr)
             for lc, cf in ((loc, conf), (loc_cpu, conf_cpu))]
    low = [R.blur_faces_in_frames(n, clip[:1], confidence_threshold=thr, min_size=min_size)
           for n in (net, net_cpu)]
    del net_cpu
    res = {"frames": list(clip.shape), "siglip": {"params": sum(p.numel()
                                                              for p in encoder.parameters()),
                                                  "layers": encoder.cfg.num_hidden_layers,
                                                  "width": encoder.cfg.hidden_size,
                                                  "batch": filt.batch_size},
           "retinaface_params": sum(p.numel() for p in net.parameters()), "build_s": build_s,
           "run_s": run_s, **parts, "passed": out is not None,
           "unchanged_fraction": float((out == clip).mean()) if out is not None else None,
           "launches": launches, "routes": routes, "unsafe": list(unsafe),
           "refused": refused is None,
           "siglip_err": _cut_rel_err(feats, feats_cpu), "siglip_cpu_s": siglip_cpu_s,
           "loc_err": _cut_rel_err(loc, loc_cpu), "conf_err": _cut_rel_err(conf, conf_cpu),
           "retina_cpu_s": retina_cpu_s, "tol": VISION_TOL,
           "low_threshold": {"threshold": thr, "min_size": list(min_size),
                             "boxes": [len(b) for b in boxes],
                             "agreement": _box_agreement(*boxes),
                             "pixelated_fraction": float((low[0] != clip[0]).mean()),
                             "frames_equal_fraction": float((low[0] == low[1]).mean())},
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del encoder, head, net, filt, blur, runner, out
    gc.collect()
    torch.cuda.empty_cache()
    emit("guardrail_video", **res)
    batches = -(-VIDEO_FRAMES // res["siglip"]["batch"])
    if (not res["passed"] or launches["K1vit"] != batches * (S.SiglipVisionConfig().num_hidden_layers
                                                              + 1)
            or routes.get("wgmma") or res["unsafe"] != [
                False, f"unsafe frames detected (frame 0: "
                       f"{G._SAFETY_CLASS_NAMES[UNSAFE_CLASS]})"] or not res["refused"]):
        raise AssertionError(f"guardrail video runner: {res}")
    if any(res[k][m] > VISION_TOL[m] for k in ("siglip_err", "loc_err", "conf_err")
           for m in VISION_TOL):
        raise AssertionError(f"guardrail video: the card and the CPU disagree: {res}")
    lowr = res["low_threshold"]
    if (min(lowr["boxes"]) == 0 or lowr["agreement"] < RETINA_BOX_AGREE
            or lowr["pixelated_fraction"] == 0
            or lowr["frames_equal_fraction"] < RETINA_BOX_AGREE):
        raise AssertionError(f"guardrail video: the low-threshold boxes: {res}")
    return res


def _pipeline_guard() -> dict:
    """Gen3cPipeline on the tiny preset on the card with a blocking text
    runner: generate returns None before any kernel, and the AR loop raises."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.aux import guardrail as G
    from gen3c_tpu_torch.pipelines.factory import build_gen3c_model
    from gen3c_tpu_torch.pipelines.gen3c_pipeline import Gen3cPipeline

    model, preset = build_gen3c_model("gen3c_tiny", device="cuda", seed=0)
    runner = G.GuardrailRunner([G.Blocklist(extra_words=GUARD_BLOCKED_WORDS)])
    h, w, n = preset.height, preset.width, preset.chunk_size
    kernels.reset_launch_counts()
    out = Gen3cPipeline(model=model, num_steps=1, text_guardrail=runner).generate(
        GUARD_BLOCKED_PROMPT, _seed_image(h, w, 0), torch.zeros(1, n, 1, 3, h, w),
        torch.ones(1, n, 1, 1, h, w))
    launches = sum(kernels.launch_counts.values())
    try:
        _run_chain(model, preset, "cuda", n, 1, 0, text_guardrail=runner)  # prompt "": blocked
        raised = None
    except RuntimeError as e:
        raised = str(e)
    res = {"preset": preset.name, "generate": out, "launches": launches, "chain_raised": raised}
    emit("guardrail_pipeline", **res)
    if out is not None or launches or raised != "Generation blocked by guardrail":
        raise AssertionError(f"guardrail pipeline hooks: {res}")
    return res


def phase_guardrail() -> dict:
    """The guardrails on the card (phase 29 of the docstring): K8 at the
    guards' shapes, the two LLM guards, the video runner, the pipeline's
    hooks."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(18)
    cfgs = _guard_configs()
    tok = StandInTokenizer()
    from gen3c_tpu_torch.aux import guardrail as G

    buckets = {}
    for kind, cls in (("llama_guard_3_8b", G.LlamaGuard3), ("llama_guard_7b", G.Aegis)):
        ids = cls(None, tok).prompt_ids(GUARD_PROMPT)
        buckets[kind] = _bucketed(cfgs[kind], ids, cls.NEW_TOKENS)[0].shape[1]
    f32 = {"max": ATTN_F32_TOL, "mean": ATTN_F32_TOL}
    batch = G.VideoContentSafetyFilter.batch_size
    kern = {"K1vit SigLIP so400m self-attention (fp32, d 72)": _attention_case(
                "K1vit SigLIP so400m self-attention (fp32, d 72)", (batch, 729, 16, 72),
                (batch, 729, 16, 72), torch.float32, f32, gen),
            "K1vit SigLIP pooling probe (fp32, d 72)": _attention_case(
                "K1vit SigLIP pooling probe (fp32, d 72)", (batch, 1, 16, 72),
                (batch, 729, 16, 72), torch.float32, f32, gen)}
    for kind, label in (("llama_guard_3_8b", "Llama-Guard-3-8B, rep 4"),
                        ("llama_guard_7b", "LlamaGuard-7b (Aegis), rep 1")):
        c = cfgs[kind]
        cache = (1, c.max_seq_len, c.n_kv_heads, c.head_dim)
        name = f"K8 decode bf16 pos {GUARD_K8_POS}, {label}"
        kern[name] = _k8_case(gen, name, GUARD_K8_POS, False, cache=cache, hq=c.n_heads)
        name = f"K8 prefill bf16 {buckets[kind]}, {label}"
        kern[name] = _k8_case(gen, name, 0, False, prefill=True, cache=cache, hq=c.n_heads,
                              prefill_len=buckets[kind])
    text = {"LlamaGuard3": _llm_guard("LlamaGuard3", 0), "Aegis": _llm_guard("Aegis", 1)}
    video = _video_guard(2)
    pipeline = _pipeline_guard()
    res = {"kernel_cases": {k: _case_summary(r) for k, r in kern.items()},
           "text": {k: {kk: r[kk] for kk in ("build_s", "runs", "bucket", "cut")}
                    for k, r in text.items()},
           "video_s": {k: video[k] for k in ("run_s", "filter_s", "blur_s", "build_s")},
           "pipeline": pipeline, "s": time.perf_counter() - t_phase}
    emit("guardrail", **res)
    routes = {n: c["route"] for n, c in kern.items() if n.startswith("K8")}
    if [r for n, r in routes.items() if ("decode" in n) != (r == "decode")] or any(
            r not in ("decode", "wgmma") for r in routes.values()):
        raise AssertionError(f"guardrail: K8 took another body: {routes}")
    res["kernels"] = kern
    res["launches"] = {"K8": {k: r["runs"][0]["k8"] + r["runs"][1]["k8"] for k, r in text.items()},
                       "K1vit": video["launches"]["K1vit"]}
    return res


def _upsampler_prompt() -> dict:
    """The upsampler phase's text model and tower configs, stand-in
    tokenizer, seeded 704x1280 frame, chat ids, the frame's patches and the
    spliced prompt's bucket (the K8 prefill's length)."""
    from gen3c_tpu_torch.aux import prompt_upsampler as P
    from gen3c_tpu_torch.aux import vision_encoder as V
    from gen3c_tpu_torch.models.ar_transformer import _bucket_length

    cfg = _guard_configs()["pixtral_12b_text"]
    vcfg = V.VisionConfig(dtype=torch.bfloat16)
    tok = StandInTokenizer()
    frame = _video_clip(1, 704, 1280, 3)
    probe = P.VLMPromptUpsampler(None, V.VisionEncoder(vcfg, device="meta"), tok, 10,
                                 UPSAMPLER_NEW_TOKENS)
    ids = probe._chat_ids(GUARD_PROMPT)
    patches = int(np.prod(probe._prepare_frame(frame).shape[1:])) // vcfg.patch_size ** 2
    spliced = len(ids) - 1 + patches
    return {"cfg": cfg, "vcfg": vcfg, "tok": tok, "frame": frame, "ids": ids,
            "patches": patches, "spliced": spliced,
            "bucket": _bucket_length(spliced, 128, cfg, UPSAMPLER_NEW_TOKENS)}


def _upsampler_k8_cases(gen, up: dict) -> dict:
    """K8 at the upsampler's text model (rep 5): decode at GUARD_K8_POS over
    its 4,300-row cache and the prefill of ``up``'s spliced prompt
    (``_upsampler_prompt``)."""
    cfg, bucket = up["cfg"], up["bucket"]
    cache = (1, cfg.max_seq_len, cfg.n_kv_heads, cfg.head_dim)
    name = f"K8 decode bf16 pos {GUARD_K8_POS}, Pixtral-12B text (40 x 128), rep 5"
    kern = {name: _k8_case(gen, name, GUARD_K8_POS, False, cache=cache, hq=cfg.n_heads)}
    name = f"K8 prefill bf16 {bucket}, Pixtral-12B text (40 x 128), rep 5"
    kern[name] = _k8_case(gen, name, 0, False, prefill=True, cache=cache, hq=cfg.n_heads,
                          prefill_len=bucket)
    return kern


def phase_upsampler() -> dict:
    """The VLM prompt upsampler on the card (phase 30 of the docstring):
    K1vit and K8 at its shapes, the Pixtral-12B vision tower and the text
    model at 40 heads of 128, the frame-conditioned and text-only paths,
    the 2-layer cuts."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.aux import guardrail as G
    from gen3c_tpu_torch.aux import prompt_upsampler as P
    from gen3c_tpu_torch.aux import vision_encoder as V

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(19)
    up = _upsampler_prompt()
    cfg, vcfg, tok, frame, ids = up["cfg"], up["vcfg"], up["tok"], up["frame"], up["ids"]
    patches, spliced, bucket = up["patches"], up["spliced"], up["bucket"]
    name = f"K1vit Pixtral-12B tower self-attention (bf16, d 64, {patches} patches)"
    kern = {name: _attention_case(name, (1, patches, vcfg.num_heads, vcfg.head_dim),
                                  (1, patches, vcfg.num_heads, vcfg.head_dim), torch.bfloat16,
                                  ATTN_TOL, gen), **_upsampler_k8_cases(gen, up)}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    text_model = G._build_ar(cfg, "cuda").init_random(gen)
    vision = V.VisionEncoder(vcfg, device="cuda").init_random(gen)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    up = P.VLMPromptUpsampler(text_model, vision, tok, 10, UPSAMPLER_NEW_TOKENS)
    runs = {}
    for path, frames in (("vlm", frame), ("text", None)):
        kernels.reset_launch_counts()
        before = dict(kernels.route_counts)
        t0 = time.perf_counter()
        out = up.upsample(GUARD_PROMPT, frames=frames)
        torch.cuda.synchronize()
        runs[path] = {"s": time.perf_counter() - t0, "chars": len(out),
                      "new_ids": tok.decoded[-1].tolist(),
                      "launches": {k: kernels.launch_counts[k] for k in ("K8", "K1vit")},
                      "routes": route_delta(before)}
    text_cut = _ar_cut_check(text_model, ids[ids != 10][None], UPSAMPLER_NEW_TOKENS)
    # the vision cut: the tower's first two layers and the projector
    vcut_cfg = V.VisionConfig(num_layers=GUARD_CUT_LAYERS, dtype=torch.bfloat16)
    with torch.device("meta"):
        vcut = V.VisionEncoder(vcut_cfg)
    vcut.patch_conv, vcut.ln_pre = vision.patch_conv, vision.ln_pre
    vcut.multi_modal_projector = vision.multi_modal_projector
    vcut.transformer.layers = torch.nn.ModuleList(list(vision.transformer.layers[
        :GUARD_CUT_LAYERS]))
    image = torch.from_numpy(up._prepare_frame(frame))
    got = V.vision_encode(vcut, image.cuda()).float().cpu()
    vcpu = V.VisionEncoder(V.VisionConfig(num_layers=GUARD_CUT_LAYERS), device="meta")
    vcpu = vcpu.to_empty(device="cpu")
    vcpu.load_state_dict({k: v.float().cpu() for k, v in vcut.state_dict().items()})
    t0 = time.perf_counter()
    want = V.vision_encode(vcpu, image)
    vision_cpu_s = time.perf_counter() - t0
    n_text = sum(p.numel() for p in text_model.parameters())
    res = {"text_model": {"params": n_text, "dim": cfg.dim, "layers": cfg.n_layers,
                          "heads": [cfg.n_heads, cfg.n_kv_heads], "head_dim": cfg.head_dim,
                          "vocab": cfg.vocab_size, "max_seq_len": cfg.max_seq_len},
           "vision": {"params": sum(p.numel() for p in vision.parameters()),
                      "width": vcfg.hidden_size, "layers": vcfg.num_layers,
                      "heads": vcfg.num_heads, "patches": patches},
           "frame": list(frame.shape[1:]), "prepared": list(image.shape),
           "spliced_tokens": spliced, "bucket": bucket, "new_tokens": UPSAMPLER_NEW_TOKENS,
           "build_s": build_s, "runs": {k: {kk: r[kk] for kk in ("s", "chars", "launches",
                                                                   "routes")}
                                        for k, r in runs.items()},
           "text_cut": text_cut, "vision_cut": {"layers": GUARD_CUT_LAYERS,
                                                "err": _cut_rel_err(got, want),
                                                "cpu_s": vision_cpu_s},
           "cut_tol": GUARD_CUT_TOL,
           "kernel_cases": {k: _case_summary(r) for k, r in kern.items()},
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del up, text_model, vision, vcut, vcpu
    gc.collect()
    torch.cuda.empty_cache()
    res["s"] = time.perf_counter() - t_phase
    emit("upsampler", **res)
    k8 = cfg.n_layers * UPSAMPLER_NEW_TOKENS
    want_launches = {"vlm": {"K8": k8, "K1vit": vcfg.num_layers},
                     "text": {"K8": k8, "K1vit": 0}}
    if ({k: r["launches"] for k, r in runs.items()} != want_launches
            or runs["vlm"]["routes"].get("mma_sync")):
        raise AssertionError(f"upsampler: {res}")
    routes = [c["route"] for n, c in kern.items() if n.startswith("K8")]
    if routes != ["decode", "wgmma"]:
        raise AssertionError(f"upsampler: K8 took another body at rep 5: {routes}")
    if (not text_cut["finite"] or any(text_cut["err"][k] > GUARD_CUT_TOL[k] for k in GUARD_CUT_TOL)
            or any(res["vision_cut"]["err"][k] > GUARD_CUT_TOL[k] for k in GUARD_CUT_TOL)):
        raise AssertionError(f"upsampler: the card and the CPU disagree on a cut: {res}")
    res["kernels"] = kern
    res["launches"] = {"K8": sum(r["launches"]["K8"] for r in runs.values()),
                       "K1vit": sum(r["launches"]["K1vit"] for r in runs.values())}
    return res


# ------------------ the rest of training: the tokenizer and AR trainers ------------------

AR_TRAIN_TOKENS = 12800  # the 4B's (5, 40, 64) grid
# per gradient, max |kernel - plain| over max |plain| and mean over mean: bf16 P and dS
# feed the tensor cores (2^-9 relative a term) and the outputs round to bf16 (2^-9)
K8BWD_TOL = {"max": 2e-2, "mean": 4e-3}
K8BWD_F32_TOL = {"max": 1e-5, "mean": 1e-5}  # fp32 on the CUDA cores, sums in another order
K8BWD_PLAIN_GROUP = 1  # KV-head groups the plain version checks at the 4B's widths


def _k8bwd_case(gen, name: str, B: int, Lq: int, Lk: int, Hq: int, Hkv: int, D: int,
                dtype, causal: Optional[int], pad=None, plain_groups: Optional[int] = None
                ) -> dict:
    """K8bwd (``cuda.gqa_attention_bwd``) after K8's forward with lse on
    seeded q (B, Lq, Hq, D), k/v (B, Lk, Hkv, D), dout like q, held to
    ``gqa_attention_backward_reference`` (fp32) on ``plain_groups`` KV-head
    groups (all by default) per gradient: the largest error relative to
    the plain version's largest |gradient|, the mean error to its mean. pad: per-row kv_valid_start; the query rows that then
    see no key get dout 0 for the comparison (the plain version averages
    every key there, the kernel adds nothing), and a second backward with
    their dout kept must give them dq 0 and finite values everywhere.
    The forward's output is held to ``gqa_attention_reference`` within the
    same largest-error bound, its lse within 1e-2 on the rows that see a key.
    Timed (CUDA events, the backward alone: Delta, dK/dV, dQ) beside SDPA's
    backward (``is_causal`` / non-causal, ``enable_gqa``; padded: its dense
    boolean mask) and the plain version; the bound counts FlashAttention-2's
    five products over the visible pairs. A bf16 case must take the wgmma
    route (attention_wgmma.cu's pair in its kGqa mode; ``splits``: its
    dK/dV grid's, ``cuda.gqa_bwd_plan``), and a second call must give the
    same bits."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.kernels import cuda

    t_case = time.perf_counter()
    q = torch.randn((B, Lq, Hq, D), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((B, Lk, Hkv, D), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    dout = torch.randn((B, Lq, Hq, D), generator=gen, device="cuda").to(dtype)
    start = None if pad is None else torch.tensor(pad, dtype=torch.int64, device="cuda")
    out, lse = cuda.gqa_attention_fwd_lse(q, k, v, causal, start)
    qpos = torch.arange(Lq, device="cuda")
    kpos = torch.arange(Lk, device="cuda")
    lo = torch.zeros(B, dtype=torch.int64, device="cuda") if start is None else start
    last = (qpos + causal)[None].clamp(max=Lk - 1) if causal is not None else \
        torch.full((1, Lq), Lk - 1, device="cuda")
    seen = (last - lo[:, None] + 1).clamp(min=0)  # (B, Lq) visible keys a row
    none = seen == 0  # rows that see no key
    res = {"name": name, "q": [B, Lq, Hq, D], "kv": [B, Lk, Hkv, D], "dtype": str(dtype),
           "causal_offset": causal, "kv_valid_start": pad, "rows_without_keys": int(none.sum())}
    if none.any():
        dq_all, dk_all, dv_all = cuda.gqa_attention_bwd(q, k, v, out, dout, lse, causal, start)
        res["no_key_rows"] = {
            "lse_all_neg_inf": bool(torch.isneginf(lse.transpose(1, 2)[none]).all().item()),
            "out_zero": bool((out[none] == 0).all().item()),
            "dq_zero": bool((dq_all[none] == 0).all().item()),
            "finite": bool(all(torch.isfinite(t).all().item() for t in (dq_all, dk_all, dv_all)))}
        del dq_all, dk_all, dv_all
        dout = dout.masked_fill(none[:, :, None, None], 0)
    before = dict(kernels.route_counts)
    dq, dk, dv = cuda.gqa_attention_bwd(q, k, v, out, dout, lse, causal, start)
    res["routes"] = route_delta(before)
    again = cuda.gqa_attention_bwd(q, k, v, out, dout, lse, causal, start)
    res["repeats_bits"] = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                              for a, b in zip((dq, dk, dv), again))
    del again
    if dtype == torch.bfloat16:
        res["splits"] = cuda.gqa_bwd_plan(B, Lq, Lk, Hq, Hkv, causal,
                                          torch.cuda.get_device_properties(0).multi_processor_count)
        res["entries"] = wgmma_entries("bwd", D, band=False, gqa=True, splits=res["splits"])
    groups = Hkv if plain_groups is None else plain_groups
    rep = Hq // Hkv
    h, g = slice(0, groups * rep), slice(0, groups)
    plain_args = (q[:, :, h], k[:, :, g], v[:, :, g], dout[:, :, h], causal, start)
    plain, plain_ms = timed_call(lambda: kernels.gqa_attention_backward_reference(
        *(t.float() if torch.is_tensor(t) and t.is_floating_point() else t for t in plain_args)))
    errs = {}
    for nm, got, ref in zip(("dq", "dk", "dv"), (dq[:, :, h], dk[:, :, g], dv[:, :, g]), plain):
        d = (got.float() - ref.float()).abs()
        errs[nm] = {"rel_max": (d.max() / ref.float().abs().max()).item(),
                    "rel_mean": (d.mean() / ref.float().abs().mean()).item(),
                    "max_abs": d.max().item()}
    ref_lse = torch.logsumexp(torch.einsum("bqhd,bkhd->bhqk", q[:, :, h].float(),
                                           k[:, :, g].float().repeat_interleave(rep, dim=2))
                              / math.sqrt(D) + torch.where(
                                  (kpos[None, None, :] >= lo[:, None, None])
                                  & (kpos[None, None, :] <= last[..., None]),
                                  0.0, float("-inf"))[:, None], dim=-1)
    seen_rows = ~none[:, None, :].expand_as(ref_lse)
    res["lse_max_abs_err"] = (lse[:, h][seen_rows] - ref_lse[seen_rows]).abs().max().item()
    ref_out = kernels.gqa_attention_reference(*(t.float() for t in plain_args[:3]), causal, start)
    seen_out = ~none[:, :, None, None].expand_as(ref_out)
    res["out_rel_max"] = ((out[:, :, h].float() - ref_out)[seen_out].abs().max()
                          / ref_out[seen_out].abs().max()).item()
    del plain, ref_lse, ref_out
    tol = K8BWD_TOL if dtype == torch.bfloat16 else K8BWD_F32_TOL
    res.update(grads=errs, tol=tol, plain_heads=h.stop,
               max_abs_err=max(e["max_abs"] for e in errs.values()),
               finite=bool(all(torch.isfinite(t).all().item() for t in (dq, dk, dv))))
    del dq, dk, dv
    res["ms"] = cuda_ms(lambda: cuda.gqa_attention_bwd(q, k, v, out, dout, lse, causal, start),
                        reps=3, calls=3 if Lq * Lk > 1e7 else 20)
    res["forward_lse_ms"] = cuda_ms(lambda: cuda.gqa_attention_fwd_lse(q, k, v, causal, start),
                                    reps=3, calls=3 if Lq * Lk > 1e7 else 20)
    res["plain_ms"] = plain_ms
    mask = None
    if pad is not None:
        mask = ((kpos[None, None, :] >= lo[:, None, None])
                & (kpos[None, None, :] <= last[..., None]))[:, None]  # (B, 1, Lq, Lk)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    try:
        import torch.nn.functional as F

        lib_out = F.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in leaves), attn_mask=mask,
            is_causal=causal is not None and mask is None, enable_gqa=True).transpose(1, 2)
        res["library_ms"] = library_ms(lambda: torch.autograd.grad(
            lib_out, leaves, dout, retain_graph=True), calls=3 if Lq * Lk > 1e7 else 20)
        del lib_out
    except (torch.OutOfMemoryError, RuntimeError) as e:  # no SDPA backward holds the shape
        res["library_ms"], res["library_error"] = None, str(e)[:200]
    del leaves
    res["library_call"] = ("F.scaled_dot_product_attention(enable_gqa=True"
                           + (", attn_mask=dense bool)" if mask is not None else
                              ", is_causal=True)" if causal is not None else ")")
                           + " backward (torch.autograd.grad)")
    pairs = int(seen.sum().item()) * Hq
    io = tensor_bytes(q, k, v, out, dout, lse) + tensor_bytes(q, k, v)
    res.update(bound(io, 10.0 * pairs * D,
                     BF16_PEAK_TFLOPS if dtype == torch.bfloat16 else FP32_PEAK_TFLOPS))
    res["visible_pairs"] = pairs
    res["bound_share"] = res["bound_ms"] / res["ms"]
    res["s"] = time.perf_counter() - t_case
    emit("kernel", **res)
    bad = [nm for nm, e in errs.items() if e["rel_max"] > tol["max"] or e["rel_mean"] > tol["mean"]]
    nk = res.get("no_key_rows", {})
    if bad or not res["finite"] or res["lse_max_abs_err"] > 1e-2 or not all(nk.values()) \
            or res["out_rel_max"] > tol["max"]:
        raise AssertionError(f"{name}: K8bwd disagrees with its plain version ({bad}): {res}")
    if not res["repeats_bits"]:
        raise AssertionError(f"{name}: two K8bwd calls gave different bits: {res}")
    if dtype == torch.bfloat16 and res["routes"] != {"wgmma": 1, "mma_sync": 0}:
        raise AssertionError(f"{name}: a bf16 K8bwd call took {res['routes']}, not wgmma: {res}")
    if res["ms"] < res["bound_ms"]:
        raise AssertionError(f"{name}: a time under the bound is no reading: {res}")
    del q, k, v, dout, out, lse, mask
    torch.cuda.empty_cache()
    return res


# K8bwd's cases: the 4B's training shape (causal bf16, 12,800 tokens; the plain
# version on K8BWD_PLAIN_GROUP groups), a left-padded batch, the cross-attention's
# non-causal shape (512 keys: the split dK/dV grid), a short causal bf16 one at rep 1
# and d 32, and ar_tiny's fp32 (d 32, rep 2). (name, B, Lq, Lk, Hq, Hkv, D, dtype,
# causal offset, kv_valid_start, plain groups); scripts/compare_gqa_builds.py runs them too
K8BWD_CASES = (
    ("K8bwd 4B causal bf16", 1, AR_TRAIN_TOKENS, AR_TRAIN_TOKENS, 32, 8, 128, "bfloat16", 0,
     None, K8BWD_PLAIN_GROUP),
    ("K8bwd left-padded bf16", 2, 2048, 2048, 32, 8, 128, "bfloat16", 0, [0, 700], None),
    ("K8bwd cross-attention bf16", 1, AR_TRAIN_TOKENS, 512, 32, 8, 128, "bfloat16", None, None,
     None),
    ("K8bwd short rep 1 d 32 bf16", 1, 200, 200, 4, 4, 32, "bfloat16", 0, None, None),
    ("K8bwd ar_tiny fp32", 1, 255, 255, 4, 2, 32, "float32", 0, None, None),
)


# K8 with lse and K8bwd where a bf16 forward with lse once had no body: query
# axes of a decode's shape (Lq * rep <= 16: the training forward runs them on the
# wgmma body's first rows) and a head width off the multiple of 8 (d 36, zero-padded
# to 40 in the wrappers); not in scripts/compare_gqa_builds.py, whose older
# checkouts refuse them
K8BWD_SHORT_CASES = (
    ("K8bwd one query at rep 4 bf16", 1, 1, 40, 32, 8, 128, "bfloat16", 39, None, None),
    ("K8bwd 3 tokens at rep 4 bf16", 1, 3, 3, 32, 8, 128, "bfloat16", 0, None, None),
    ("K8bwd 4 tokens at rep 4 bf16", 1, 4, 4, 32, 8, 128, "bfloat16", 0, None, None),
    ("K8bwd d 36 at rep 2 bf16", 1, 200, 200, 4, 2, 36, "bfloat16", 0, None, None),
)


# K8 with lse and K8bwd on a tp 2 rank's heads of the 4B's training shape (16 / 4:
# ar_tp_train's; cuda.gqa_bwd_plan picks its dK/dV grid by key length and heads)
K8BWD_TP_CASES = (
    ("K8bwd 4B tp 2 rank causal bf16", 1, AR_TRAIN_TOKENS, AR_TRAIN_TOKENS, 16, 4, 128,
     "bfloat16", 0, None, K8BWD_PLAIN_GROUP),
)


def k8bwd_cases(gen, cases=K8BWD_CASES) -> dict:
    """K8bwd at each of ``cases`` (K8BWD_CASES by default)."""
    return {c["name"]: c for c in (
        _k8bwd_case(gen, name, B, Lq, Lk, Hq, Hkv, D, getattr(torch, dtype), causal, pad=pad,
                    plain_groups=groups)
        for name, B, Lq, Lk, Hq, Hkv, D, dtype, causal, pad, groups in cases)}


AR_TRAIN_STEPS = 3
AR_TRAIN_LR = 1e-4
AR_TRACE_TRIES = 5  # traced (1 step, 2 steps) pairs at most, until one keeps its records
# the kernels of a training step that are K8bwd (attention_wgmma.cu's backward pair in
# its kGqa mode, its Delta and the split's reduction) and K8 (the kGqa forward, with
# or without lse), by the names torch.profiler gives them
K8BWD_KERNELS = re.compile(r"attn_bwd_(?:dkdv|dq)_wgmma<\d+, ?(?:false|0), ?(?:true|1)>"
                           r"|attn_bwd_delta_wgmma|gqa_bwd_reduce")
K8_KERNELS = re.compile(r"attn_fwd_wgmma<\d+, ?(?:false|0), ?(?:true|false|1|0), ?(?:true|1)>")
AR_PARITY_LAYERS = 2  # of the 4B's 16, at its full width, card against CPU
AR_PARITY_TOKENS = 257  # the cut's sequence (256 positions in)
# bf16 weights and products on the card (fp32 softmax, norms and loss), fp32 on the CPU
AR_PARITY_TOL = {"loss": 1e-2, "grad_norm": 3e-2}
# every leaf's largest error within 5e-2 of its largest |gradient| (bf16 products
# and bf16 gradients on the card); a zeroed or mis-wired dq / dk / dv moves a
# layer's wq / wk / wv by the order of its whole gradient
AR_PARITY_LEAF_TOL = 5e-2
TOK_TRAIN_STEPS = 3
TOK_CLIP = (17, 256)  # frames, square crop (scripts/probe_raft_memory.py's training crop)
TOK_CLI_STEPS = 2
TOK_PARITY_CLIP = (17, 64)  # the card-against-CPU cut: full channel widths, a smaller clip
# fp32 on both sides (RAFT with TF32 off on the card); RAFT's 12 updates feed each
# rounding back into the lookups' coordinates (up to ~4e-4 of the flow's range in
# the CPU tests)
TOK_PARITY_TOL = {"term": 1e-2, "grad_norm": 1e-2}
TOK_RAFT_BWD_TOL = 1e-5  # the same fp32 products either way; TF32 would give ~1e-3
TOK_LOSS = dict(w_gram=1.0, w_flow=1.0, flow_scale=2, w_consistency=1.0, consistency_frames=9,
                consistency_step=8)


def read_ar_train_trace(profiles: list, step_s: float, k8bwd_launches: int,
                        k8bwd_kernels: int, k8_launches: int):
    """A traced 4B training step from its (name, µs) records in profiles of
    one step and of two: K8bwd's kernels (K8BWD_KERNELS: k8bwd_kernels
    names, each launched k8bwd_launches times a step) and K8's forward
    (K8_KERNELS: one name, k8_launches a step) read by ``scripts/card.py``'s
    ``records_known`` with those counts from the launch counters (a few lost
    records cost nothing) as seconds a step and shares of the untraced
    step's ``step_s`` seconds; the step's kernel seconds and its largest
    kernels from the two-step profile's records, halved: a lower bound when
    the profiler lost some of them (``all_records_kept`` false; late in a
    long process it lost ≈ 20 of every ≈ 10,166-record profile, now and then
    none). None when the names are not those, or ``records_known`` refuses
    their records."""
    from gen3c_tpu_torch.scripts.card import records_by_name, records_known

    bwd = sorted({n for pr in profiles for n, _ in pr if K8BWD_KERNELS.search(n)})
    fwd = sorted({n for pr in profiles for n, _ in pr if K8_KERNELS.search(n)})
    if len(bwd) != k8bwd_kernels or len(fwd) != 1:
        return None
    got = records_known(profiles, 1, {**{n: k8bwd_launches for n in bwd}, fwd[0]: k8_launches})
    if got is None:
        return None
    us, lost = got
    k8bwd_s, k8_s = sum(us[n] for n in bwd) / 1e6, us[fwd[0]] / 1e6
    two = {}
    for n, us in profiles[1]:
        c, t = two.get(n, (0, 0.0))
        two[n] = (c + 1, t + us)
    kernel_s = sum(t for _, t in two.values()) / 2e6
    top = sorted(two.items(), key=lambda kv: -kv[1][1])[:12]
    return {"step_s": step_s, "kernel_s": kernel_s, "kernel_share": kernel_s / step_s,
            "all_records_kept": records_by_name(profiles, 1) is not None,
            "records": [len(pr) for pr in profiles], "k8_records_lost": lost,
            "k8bwd_kernels_a_step": k8bwd_launches * len(bwd), "k8bwd_s": k8bwd_s,
            "k8bwd_share_of_step": k8bwd_s / step_s, "k8bwd_share_of_kernels": k8bwd_s / kernel_s,
            "k8_kernels_a_step": k8_launches, "k8_s": k8_s, "k8_share_of_step": k8_s / step_s,
            "k8_share_of_kernels": k8_s / kernel_s,
            "top_kernels": [{"name": n[:120], "a_step": c / 2, "s": t / 2e6}
                            for n, (c, t) in top]}


def _ar_train_trace(step, step_s: float, k8bwd_launches: int, k8_launches: int,
                    k8bwd_kernels: int) -> dict:
    """4B training steps traced by torch.profiler, a profile of one step and
    one of two (the host idle PROFILE_MARGIN_S at each end, as
    ``card.device_ms`` has it), read by ``read_ar_train_trace``; up to
    AR_TRACE_TRIES pairs until one reads (k8bwd_kernels K8bwd kernel names
    of k8bwd_launches each and one K8 name of k8_launches, each within
    LOST_RECORDS of its count), else it fails."""
    from torch.profiler import ProfilerActivity, profile

    from gen3c_tpu_torch.scripts.card import PROFILE_MARGIN_S

    def profiled(n):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_MARGIN_S)
            for _ in range(n):
                step()
            torch.cuda.synchronize()
            time.sleep(PROFILE_MARGIN_S)
        return [(e.name, e.time_range.end - e.time_range.start) for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    tries = []
    for _ in range(AR_TRACE_TRIES):
        profiles = [profiled(1), profiled(2)]
        res = read_ar_train_trace(profiles, step_s, k8bwd_launches, k8bwd_kernels, k8_launches)
        names = [sorted({n[:60] for pr in profiles for n, _ in pr if p.search(n)})
                 for p in (K8BWD_KERNELS, K8_KERNELS)]
        tries.append([[len(pr) for pr in profiles], res is not None])
        if res:
            res["tries"] = tries
            return res
    raise AssertionError(f"ar_train: no traced pair kept {k8bwd_kernels} K8bwd kernels of "
                         f"{k8bwd_launches} and one K8 of {k8_launches} a step (records a "
                         f"profile, read a try: {tries}; names of the last: {names})")


def phase_ar_train() -> dict:
    """K8bwd's kernel cases, then ``ar_train_step`` (AdamW, optax.adamw's
    counterpart) on the seeded ar_4b at full width (all 16 layers, 4.01 B
    parameters with their AdamW state) over the 12,800-token (5, 40, 64)
    grid, B = 1, AR_TRAIN_STEPS steps with per-layer recompute: s per step,
    peak GiB, loss, grad norm and the K8 / K8bwd launches of each step
    (counts reset before each). Then the loss, the grad norm and each
    leaf's gradient of an AR_PARITY_LAYERS-layer cut at full width over
    AR_PARITY_TOKENS tokens, card (bf16) against CPU (fp32) on the same
    weights."""
    import dataclasses

    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.kernels import cuda
    from gen3c_tpu_torch.models.ar_transformer import ARTransformer
    from gen3c_tpu_torch.pipelines import autoregressive as ar
    from gen3c_tpu_torch.training import ar_train
    from gen3c_tpu_torch.training.train_step import AdamW, global_norm, trainable_params

    gen = torch.Generator(device="cuda").manual_seed(19)
    t0 = time.perf_counter()
    kern = k8bwd_cases(gen)
    kern.update(k8bwd_cases(gen, K8BWD_SHORT_CASES))
    kern.update(k8bwd_cases(gen, K8BWD_TP_CASES))
    cases_s = time.perf_counter() - t0
    preset = ar.AR_PRESETS["ar_4b"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = ar.build_ar_model(preset, "cuda", seed=0)
    params = trainable_params(model)
    opt = AdamW(AR_TRAIN_LR)
    state = opt.init(params)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.values())
    state_gib = sum(4 * p.numel() * p.element_size() for p in params.values()) / 2 ** 30
    tokens = torch.randint(0, preset.ar.vocab_size, (1, AR_TRAIN_TOKENS), generator=gen,
                           device="cuda")
    steps = []
    for _ in range(AR_TRAIN_STEPS):
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        model, state, m = ar_train.ar_train_step(model, state, tokens, opt)
        torch.cuda.synchronize()
        steps.append({"s": time.perf_counter() - t0, "loss": m["loss"].item(),
                      "accuracy": m["accuracy"].item(), "grad_norm": m["grad_norm"].item(),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                      "launches": {k: kernels.launch_counts[k] for k in ("K8", "K8bwd")}})
    # K8bwd's and K8's share of a step, traced (the steps after the timed ones)
    live = {"model": model, "state": state}

    def one_step():
        live["model"], live["state"], _ = ar_train.ar_train_step(live["model"], live["state"],
                                                                 tokens, opt)

    splits = cuda.gqa_bwd_plan(1, AR_TRAIN_TOKENS, AR_TRAIN_TOKENS, preset.ar.n_heads,
                               preset.ar.n_kv_heads, 0,
                               torch.cuda.get_device_properties(0).multi_processor_count)
    trace = _ar_train_trace(one_step, float(np.mean([st["s"] for st in steps[1:]])),
                            steps[-1]["launches"]["K8bwd"], steps[-1]["launches"]["K8"],
                            3 + (splits > 1))
    emit("ar_train_trace", **trace)
    del model, params, state, opt, tokens, m, live
    gc.collect()
    torch.cuda.empty_cache()

    # the cut, card against CPU
    cut = dataclasses.replace(preset.ar, n_layers=AR_PARITY_LAYERS)
    card = ARTransformer(cut, device="cuda").init_random(
        torch.Generator(device="cuda").manual_seed(5))
    cpu = ARTransformer(dataclasses.replace(cut, dtype=torch.float32))
    cpu.load_state_dict({k: v.float().cpu() for k, v in card.state_dict().items()})
    toks = torch.randint(0, cut.vocab_size, (1, AR_PARITY_TOKENS),
                         generator=torch.Generator().manual_seed(6))
    parity, leaf_grads = {}, {}
    for name, model in (("card", card), ("cpu", cpu)):
        params = trainable_params(model)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        loss, _ = ar_train.ar_loss(model, toks.to(model.device))
        grads = torch.autograd.grad(loss, list(params.values()))
        parity[name] = {"loss": loss.item(),
                        "grad_norm": global_norm(dict(zip(params, grads))).item(),
                        "s": time.perf_counter() - t0,
                        "launches": {k: kernels.launch_counts[k] for k in ("K8", "K8bwd")}}
        leaf_grads[name] = {n: g.float().cpu() for n, g in zip(params, grads)}
    del card, cpu, params, model, loss, grads
    gc.collect()
    torch.cuda.empty_cache()
    rel = {k: abs(parity["card"][k] - parity["cpu"][k]) / abs(parity["cpu"][k])
           for k in ("loss", "grad_norm")}
    # each leaf's largest error relative to its largest |gradient|: the
    # attention's wq / wk / wv / wo take K8bwd's dq, dk and dv
    leaf_rel = {n: ((leaf_grads["card"][n] - g).abs().max() / g.abs().max()).item()
                for n, g in leaf_grads["cpu"].items()}
    del leaf_grads
    worst = max(leaf_rel, key=leaf_rel.get)
    res = {"model": "ar_4b", "layers": preset.ar.n_layers, "params": n_params,
           "tokens": AR_TRAIN_TOKENS, "dtype": "bfloat16", "optimizer": "AdamW (optax.adamw)",
           "lr": AR_TRAIN_LR, "state_gib_reckoned": state_gib, "build_s": build_s,
           "steps": steps, "k8bwd_cases_s": cases_s, "trace": trace,
           "parity": {"layers": AR_PARITY_LAYERS, "tokens": AR_PARITY_TOKENS, **parity,
                      "rel": rel, "tol": AR_PARITY_TOL, "leaf_rel_max": leaf_rel,
                      "worst_leaf": worst, "leaf_tol": AR_PARITY_LEAF_TOL}}
    emit("ar_train", **res)
    bad = [i for i, st in enumerate(steps)
           if not (math.isfinite(st["loss"]) and math.isfinite(st["grad_norm"]))
           or st["launches"] != {"K8": 2 * preset.ar.n_layers, "K8bwd": preset.ar.n_layers}]
    if bad or any(rel[k] > AR_PARITY_TOL[k] for k in rel) \
            or not leaf_rel[worst] <= AR_PARITY_LEAF_TOL \
            or parity["card"]["launches"]["K8bwd"] != AR_PARITY_LAYERS:
        raise AssertionError(f"ar_train: steps {bad} or the cut disagrees: {res}")
    res["kernels"] = kern
    res["launches"] = {k: sum(st["launches"][k] for st in steps) for k in ("K8", "K8bwd")}
    return res


def raft_backward_without_tf32(params: dict, video: torch.Tensor) -> float:
    """RAFT's gradient with respect to both frames of ``video`` (1, 3, 2,
    H, W) under cuDNN's default flags (TF32 on), as the step takes it,
    against the same with TF32 off everywhere: the largest difference
    relative to the largest |gradient|. TF32 anywhere in RAFT's backward
    parts them by ~1e-3."""
    from gen3c_tpu_torch.aux import raft

    dflow = torch.randn((1, 2, *video.shape[-2:]), generator=torch.Generator().manual_seed(12))

    def grads():
        frames = [video[:, :, i].detach().clone().requires_grad_(True) for i in range(2)]
        flow = raft.raft_flow(params, *frames, num_flow_updates=12)
        return torch.cat([g.flatten() for g in torch.autograd.grad(flow, frames,
                                                                   dflow.to(flow))])

    got = grads()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        want = grads()
    return ((got - want).abs().max() / want.abs().max()).item()


def phase_tokenizer_train() -> dict:
    """``tokenizer_train_step`` (AdamW) on the seeded CV8x8x8 tokenizer at
    the default VAEConfig's full width over a 17-frame 256 x 256 clip, B =
    1, TOK_TRAIN_STEPS steps with every term on (LPIPS VGG16 with the gram
    term, RAFT-Large flow at scale 2 with 12 updates, consistency windows
    of 9 frames, step 8; seeded VGG16 and RAFT): s per step, peak GiB, each
    term. Then TOK_CLI_STEPS steps of the CLI (--synthetic --perceptual lpips
    --w_flow 1 --flow_estimator raft), and one step's terms and grad norm on
    a TOK_PARITY_CLIP cut at full channel widths, card against CPU (fp32;
    the card as the step runs: RAFT with TF32 off, its backward too, the
    rest under cuDNN's default), and ``raft_backward_without_tf32``."""
    from gen3c_tpu_torch.aux import raft
    from gen3c_tpu_torch.models.vae import CV8x8x8, CausalVAE
    from gen3c_tpu_torch.training import lpips
    from gen3c_tpu_torch.training import tokenizer_train as tt
    from gen3c_tpu_torch.training.train_step import AdamW, global_norm, trainable_params

    gen = torch.Generator(device="cuda").manual_seed(21)
    vae = CausalVAE(CV8x8x8, device="cuda").init_random(gen)
    params = trainable_params(vae)
    lp = lpips.init_vgg16_params(gen, device="cuda")
    rp = raft.init_raft_params(gen, device="cuda")
    kw = dict(TOK_LOSS, lpips_params=lp, flow_fn=raft.make_raft_flow_fn(rp, 12))
    frames, res_px = TOK_CLIP
    video = torch.rand((1, 3, frames, res_px, res_px), generator=gen, device="cuda") * 2 - 1
    opt = AdamW(1e-4)
    state = opt.init(params)
    steps = []
    for i in range(1, TOK_TRAIN_STEPS + 1):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, state, m = tt.tokenizer_train_step(params, state, video, CV8x8x8, opt,
                                                   iteration=i, **kw)
        torch.cuda.synchronize()
        steps.append({"s": time.perf_counter() - t0,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                      **{k: v.item() for k, v in m.items()}})
    n_params = sum(p.numel() for p in params.values())
    del vae, params, state, opt, video
    torch.cuda.empty_cache()

    record = {}
    t0 = time.perf_counter()
    tt.main(["--synthetic", "--max_iter", str(TOK_CLI_STEPS), "--log_every", "1",
             "--perceptual", "lpips", "--w_flow", "1", "--flow_estimator", "raft",
             "--device", "cuda"], record=record)
    cli = {"s": time.perf_counter() - t0, "steps": record["steps"]}

    frames, res_px = TOK_PARITY_CLIP
    clip = torch.rand((1, 3, frames, res_px, res_px), generator=torch.Generator().manual_seed(8))
    cpu_vae = CausalVAE(CV8x8x8).init_random(torch.Generator().manual_seed(9))
    cpu_lp = lpips.init_vgg16_params(torch.Generator().manual_seed(10))
    cpu_rp = raft.init_raft_params(torch.Generator().manual_seed(11))
    parity = {}
    for name, dev in (("card", "cuda"), ("cpu", "cpu")):
        vae = copy.deepcopy(cpu_vae).to(dev)
        lp_d = {k: v.to(dev) for k, v in cpu_lp.items()}
        rp_d = {k: v.to(dev) for k, v in cpu_rp.items()}
        t0 = time.perf_counter()
        m, grads = tt.tokenizer_loss_and_grads(
            trainable_params(vae), CV8x8x8, clip.to(dev) * 2 - 1, iteration=1,
            **dict(TOK_LOSS, lpips_params=lp_d, flow_fn=raft.make_raft_flow_fn(rp_d, 12)))
        parity[name] = {"s": time.perf_counter() - t0, "grad_norm": global_norm(grads).item(),
                        **{k: v.item() for k, v in m.items()}}
        del vae, grads
    raft_tf32 = raft_backward_without_tf32({k: v.cuda() for k, v in cpu_rp.items()},
                                           clip[:, :, :2].cuda() * 2 - 1)
    torch.cuda.empty_cache()
    rel = {k: abs(parity["card"][k] - parity["cpu"][k]) / max(abs(parity["cpu"][k]), 1e-12)
           for k in parity["cpu"] if k != "s"}
    res = {"config": "CV8x8x8 (128 channels, mult (2, 4, 4), 2 res blocks, patch 4, 16 latent "
                     "channels)", "params": n_params, "clip": [1, 3, *TOK_CLIP[:1],
                                                               TOK_CLIP[1], TOK_CLIP[1]],
           "loss": {k: v for k, v in TOK_LOSS.items()}, "raft_updates": 12, "steps": steps,
           "cli": cli, "parity": {"clip": list(TOK_PARITY_CLIP), **parity, "rel": rel,
                                  "tol": TOK_PARITY_TOL},
           "raft_backward_tf32_rel": raft_tf32, "raft_backward_tol": TOK_RAFT_BWD_TOL}
    emit("tokenizer_train", **res)
    terms = {"l1", "mse", "grad", "temporal", "perceptual", "gram", "flow", "consistency",
             "loss"}
    bad = [i for i, st in enumerate(steps)
           if set(st) - {"s", "peak_gib"} != terms or not all(math.isfinite(st[k]) for k in terms)]
    bad += [f"cli {st['step']}" for st in cli["steps"]
            if not ({"perceptual", "flow"} <= set(st) and math.isfinite(st["loss"]))]
    off = [k for k, r in rel.items() if r > TOK_PARITY_TOL["grad_norm" if k == "grad_norm"
                                                         else "term"]]
    if bad or off or len(cli["steps"]) != TOK_CLI_STEPS or not raft_tf32 <= TOK_RAFT_BWD_TOL:
        raise AssertionError(f"tokenizer_train: steps {bad}, card against CPU off on {off}: {res}")
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="gen3c_tpu_torch smoke run on one GPU")
    p.add_argument("--cp-rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--cp-port", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--cp-out", type=str, default="", help=argparse.SUPPRESS)
    p.add_argument("--cp-train-rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--serving-rank", type=int, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.cp_rank is not None:  # one rank of the cp phase
        return cp_worker(args.cp_rank, args.cp_port, args.cp_out)
    if args.cp_train_rank is not None:  # one rank of the cp_train phase
        return cp_train_worker(args.cp_train_rank, args.cp_port, args.cp_out)
    if args.serving_rank is not None:  # one rank of the serving_cp2 phase
        return serving_cp2_worker(args.serving_rank, args.cp_port, args.cp_out)
    t_start = time.perf_counter()
    info = phase_device()
    phase_build()
    kern = phase_kernels()
    model, preset, build_s = build_7b()
    main_res = phase_main(model, preset, build_s)
    launches = main_res["launches"]
    dynamic_launches = phase_dynamic(model, preset)["launches"]
    phase_multiview(model, preset)
    main_res.pop("samples")
    cp_refs = phase_cp_reference(model, preset)
    span_res = phase_span(model, preset)
    # the two ranks need the card to themselves: the 7B must be gone, even
    # where a reference cycle still holds it
    del model
    gc.collect()
    torch.cuda.empty_cache()
    cp_res = phase_cp(cp_refs)
    cp_runs = cp_res["runs"]
    cp_train = phase_cp_train()
    served = phase_serving()
    serving_cp2 = phase_serving_cp2(served)
    del served
    t2w_launches = phase_text2world()["launches"]
    interp_launches = phase_interpolator()["launches"]
    phase_tokenizer()
    quality_launches = phase_quality()["launches"]
    mv_res = phase_mv_world()
    ar_res = phase_ar_world()
    dd_res = phase_dd(ar_res.pop("grid"))
    guard_res = phase_guardrail()
    ups_res = phase_upsampler()
    fast_launches = phase_fast()["launches"]
    phase_fast_parity()
    phase_chain()
    moge_launches = phase_moge()["launches"]
    t5_tool = phase_t5()["tool"]
    phase_checkpoint()
    phase_offline_tools(t5_tool)
    train_launches = phase_train()["k4_by_forward"]
    mv_train = phase_mv_action_train()
    lora_launches = phase_lora_band_train()["launches"]
    phase_train_parity()
    phase_band_train_parity()
    phase_train_cli()
    phase_tokenizer_train()
    ar_train_res = phase_ar_train()
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "gen3c_tpu"))
    if foreign:
        raise AssertionError(f"the port imported JAX or the JAX package: {foreign[:8]}")
    k7 = max(kern["K7"], key=lambda r: r["M"] * r["N"] * r["K"])  # fc1
    k7_cases = kern["K7"] + [kern["K7_ragged"]]
    csrc = "gen3c_tpu_torch/kernels/csrc/"

    def row(name, source, replaces, launches, case, **override):
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "entries")
        got = {k: case[k] for k in keys if k in case}
        if source == "attention_wgmma.cu":  # the family's wgmma body, and its entries
            got["body"] = "wgmma"
        return {"name": name, "route": "cuda", "source": csrc + source, "replaces": replaces,
                "launches": launches, **{**got, **override}}

    # the launches of the span, text2world, interpolator and multiview phases
    pp2 = cp_res["pp2"]["ranks"][0]
    render_cp2 = cp_res["render_cp2"]["ranks"][0]
    ar_tp = cp_res["ar_tp"]["ranks"][0]["runs"]

    def by_phase(kid):
        return {"span": span_res["full"]["launches"][kid],
                **{f"cp {run} (rank 0, tp 2: 16 heads)": cp_runs[run]["rank"][0]["launches"][kid]
                   for run in ("tp", "cp1tp2sp")},
                "cp pp2 (stage 0: 1 block, 2 microbatches)": pp2["launches"].get(kid, 0),
                "text2world": t2w_launches[kid],
                "interpolator": interp_launches[kid], "mv_world": mv_res["launches"][kid],
                "mv_action_train": sum(r["launches"][kid] for r in mv_train.values()),
                "dd": dd_res["launches"][kid]}

    def mv_shape(kid):  # the kernel at the multiview 7B's shape (mv_world's case)
        return _mv_kernel_summary(mv_res["kernel_cases"][kid])

    def cp_train_k4(fwd, run):  # K4 in cp_train's run, by the forward, rank 0's steps
        steps = cp_train["runs"][run]["ranks"][0]["steps"]
        return {f"cp_train {run} (rank 0, {len(steps)} steps, {fwd})":
                sum(st["k4_by_forward"][fwd] for st in steps)}

    # K4 in mv_action_train, by the forward it differentiates
    k4_mv = {f"mv_action_train ({k})": {fwd: r["k4_by_forward"][fwd] for fwd in ("K1", "K2")}
             for k, r in mv_train.items()}

    table = [
        row("K1 self-attention", "attention_wgmma.cu", "gen3c_tpu/models/dit.py:445",
            launches["K1"], kern["K1"], phase_launches=by_phase("K1"), multiview=mv_shape("K1"),
            decoder=dd_res["kernel_cases"]["K1"]),
        row("K2 cross-attention", "attention_wgmma.cu", "gen3c_tpu/models/dit.py:472",
            launches["K2"], kern["K2"], phase_launches=by_phase("K2"), multiview=mv_shape("K2"),
            decoder=dd_res["kernel_cases"]["K2"]),
        row("K5 forward-warp splat", "splat.cu", "gen3c_tpu/ops/geometry.py:205",
            launches["K5"], kern["K5"],
            phase_launches={"cp render_cp2 (rank 0: 61 of 121 targets)":
                            render_cp2["launches"]["K5"]},
            max_abs_err=max([kern["K5"]["max_abs_err"]]
                            + [c["max_abs_err"] for c in kern["K5"]["cases"].values()])),
        row("K3 band self-attention", "attention_wgmma.cu", "gen3c_tpu/models/dit.py:459",
            fast_launches["K3"], kern["K3"]),
        row("K7q per-token int8 quantize (K=4096)", "w8a8.cu", "gen3c_tpu/models/quantize.py:55",
            fast_launches["K7q"], kern["K7q"][0],
            phase_launches={"quality (fp32 W8A8 rows)": quality_launches["K7q"],
                            "cp ar_tp w8a8 (rank 0, tp 2)":
                            ar_tp["w8a8 forward"]["launches"]["K7q"]},
            max_abs_err=max(r["max_abs_err"] for r in kern["K7q"] + [kern["K7q_row_scale"]]),
            widths=[{k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_share")}
                    for r in kern["K7q"] + [kern["K7q_row_scale"]]],
            row_scale={k: kern["K7q_row_scale"][k] for k in (
                "name", "shape", "ms", "absmax_ms", "codes_ms", "one_pass_ms", "plain_ms",
                "bound_ms", "bound_by", "bound_share", "max_abs_err")}),
        row("K7 int8 GEMM + rescale (fc1 shape)", "w8a8.cu", "gen3c_tpu/models/quantize.py:61",
            fast_launches["K7"], k7,
            phase_launches={"quality (fp32 W8A8 rows)": quality_launches["K7"],
                            "cp ar_tp w8a8 (rank 0, tp 2)":
                            ar_tp["w8a8 forward"]["launches"]["K7"]},
            max_abs_err=max(r["max_abs_err"] for r in k7_cases),
            shapes=[{k: r[k] for k in ("name", "copied", "ms", "library_ms", "bound_ms")}
                    for r in k7_cases]),
        row("K4 self-attention backward", "attention_wgmma.cu", "gen3c_tpu/models/dit.py:464",
            train_launches["K1"], kern["K4_self"],
            phase_launches={**{k: v["K1"] for k, v in k4_mv.items()},
                            **cp_train_k4("K1cp", "cp2"), **cp_train_k4("K1", "dp2"),
                            **cp_train_k4("K1", "tp2"), **cp_train_k4("K1", "tp2sp"),
                            **cp_train_k4("K1", "fsdp2"),
                            "cp pp2 (stage 0, self + cross)": pp2["launches"]["K4"]},
            cp_training_shard={k: cp_train["k4"][k] for k in (
                "q", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err",
                "bound_share")}),
        row("K4 cross-attention backward", "attention_wgmma.cu", "gen3c_tpu/models/dit.py:508",
            train_launches["K2"], kern["K4_cross"],
            phase_launches={k: v["K2"] for k, v in k4_mv.items()}),
        row("K4-band band self-attention backward", "attention_wgmma.cu",
            "gen3c_tpu/models/dit.py:464", lora_launches["K4band"], kern["K4band"]),
        row("K3lse band forward with lse", "attention_wgmma.cu", "gen3c_tpu/models/dit.py:459",
            lora_launches["K3lse"], kern["K3lse"]),
        row("K6 ray-triangle depth", "raycast.cu", "gen3c_tpu/ops/raycast.py:97",
            dynamic_launches["K6"], kern["K6"]),
        row(f"P2 K1 tile sweep (best {kern['P2']['best']})", "attention_wgmma.cu",
            "scripts/sweep_attention.py:32", kern["P2"]["launches"], kern["P2"]),
    ] + [row(p1["name"], "mma_probe.cu", "scripts/probe_int8_attention.py:59", p1["launches"], p1,
             **{k: p1[k] for k in ("form", "sm_clock_mhz", "bound_share", "library_call")})
         for p1 in kern["P1"]]
    table.append(row("K1vit MoGe ViT-L self-attention (fp32)", "attention_f32.cu",
                     "gen3c_tpu/aux/moge.py:159", moge_launches["K1vit"], kern["K1vit"],
                     body="3xtf32", phase_launches={"quality (the tiny fp32 DiT's K1 + K2 + K3)":
                                                    sum(quality_launches[k]
                                                        for k in ("K1", "K2", "K3")),
                                                    "guardrail (SigLIP, 121 frames, fp32)":
                                                    guard_res["launches"]["K1vit"],
                                                    "upsampler (Pixtral tower, 1 call, bf16)":
                                                    ups_res["launches"]["K1vit"]},
                     vision_cases=[{"name": n, **_case_summary(c)}
                                   for res in (guard_res, ups_res)
                                   for n, c in res["kernels"].items() if n.startswith("K1vit")],
                     **{k: kern["K1vit"][k] for k in (
                         "bound_share", "fp32_cuda_core_bound_ms", "ms_one_call",
                         "library_ms_one_call")}))
    served_a = next(r for r in serving_cp2["rank"][0]["runs"] if r["request_id"] == "A")
    ar_tp_steps = cp_train["ar_tp_train"]["ranks"][0]["steps"]
    # the cp phase's kernels, at its shard shapes (cp = 2), launches of rank 0's runs
    cp_launch = {name: run["rank"][0]["launches"] for name, run in cp_runs.items()}
    k1cp = next(r for r in kern["K1cp"] if r["cp"] == CP_RANKS and r["band"] is None)
    ring = next(r for r in kern["K1ring"] if r["cp"] == CP_RANKS and r["band"] is None)
    table += [
        row("K1cp Ulysses self-attention (cp=2 heads)", "attention_wgmma.cu",
            "gen3c_tpu/models/dit.py:653", cp_launch["ulysses"]["K1cp"], k1cp,
            training={"forward_with_lse_ms": cp_train["k4"]["fwd_lse_ms"],
                      "shape": cp_train["k4"]["q"],
                      "launches": sum(st["launches"]["K1cp"] for st in
                                      cp_train["runs"]["cp2"]["ranks"][0]["steps"])},
            phase_launches={"serving_cp2 job A (rank 0, 2 chunks)":
                            served_a["launches"]["K1cp"]}),
        row("K1ag all-gather self-attention (cp=2)", "attention_wgmma.cu",
            "gen3c_tpu/models/dit.py:766", cp_launch["allgather"]["K1ag"], kern["K1ag"]),
        row("K1ring ring-attention step (cp=2)", "attention_wgmma.cu",
            "gen3c_tpu/models/dit.py:529", cp_launch["ring"]["K1ring"], ring,
            ms=ring["fold_ms"], plain_ms=ring["plain_fold_ms"], **ring["fold_bound"]),
        row("K1merge ring-attention merge (cp=2)", "attention_merge.cu",
            "gen3c_tpu/models/dit.py:614", cp_launch["ring"]["K1merge"], ring,
            ms=ring["merge_ms"], plain_ms=ring["plain_merge_ms"], library_ms=None,
            **ring["merge_bound"]),
    ]
    k8 = ar_res["kernels"]
    table.append(row("K8 GQA attention over the KV cache (4B decode, bf16, pos 5,120)",
                     "gqa_attention.cu", "gen3c_tpu/models/ar_transformer.py:252",
                     ar_res["launches"]["K8"], k8["K8 decode bf16 pos 5,120"],
                     max_abs_err=max(c["max_abs_err"] for c in k8.values()),
                     library_call=k8["K8 decode bf16 pos 5,120"]["library_call"],
                     phase_launches={"ar_world bf16 cache": ar_res["runs"]["bf16"]["launches"]["K8"],
                                     "ar_world int8 cache": ar_res["runs"]["int8"]["launches"]["K8"],
                                     "ar_tiny card": ar_res["tiny_card_vs_cpu"]["card_k8_launches"],
                                     **{f"cp ar_tp {n} (rank 0, tp 2: 16 / 4 heads)":
                                        r["launches"]["K8"] for n, r in ar_tp.items()},
                                     **{f"guardrail {g} (2 runs)": n
                                        for g, n in guard_res["launches"]["K8"].items()},
                                     "upsampler (VLM + text)": ups_res["launches"]["K8"],
                                     "ar_train (forward with lse, 3 steps, remat)":
                                     ar_train_res["launches"]["K8"],
                                     "cp_train ar_tp_train (rank 0, tp 2: 16 / 4 heads, "
                                     "2 steps, remat)":
                                     sum(st["launches"]["K8"] for st in ar_tp_steps)},
                     cases=[{"name": n, **{k: c[k] for k in (
                         "q", "cache", "visible_keys", "ms", "host_and_device_ms", "host_us",
                         "kernels_a_call", "route", "plain_ms", "library_ms",
                         "library_kernels_a_call", "library_host_and_device_ms",
                         "bound_ms", "bound_by", "max_abs_err", "plain_heads")}}
                            for n, c in {**k8, **{n: c for res in (guard_res, ups_res)
                                                  for n, c in res["kernels"].items()
                                                  if n.startswith("K8")}}.items()]))
    k8bwd = ar_train_res["kernels"]
    trace = ar_train_res["trace"]
    table.append(row("K8bwd GQA attention backward (4B training, 12,800 tokens, causal bf16)",
                     "attention_wgmma.cu", "gen3c_tpu/models/ar_transformer.py:252",
                     ar_train_res["launches"]["K8bwd"], k8bwd["K8bwd 4B causal bf16"],
                     max_abs_err=max(c["max_abs_err"] for c in k8bwd.values()),
                     library_call=k8bwd["K8bwd 4B causal bf16"]["library_call"],
                     fp32_source=csrc + "gqa_attention_bwd.cu",
                     phase_launches={"cp_train ar_tp_train (rank 0, tp 2: 16 / 4 heads, "
                                     "2 steps)": sum(st["launches"]["K8bwd"]
                                                     for st in ar_tp_steps)},
                     tp_shape={k: k8bwd["K8bwd 4B tp 2 rank causal bf16"].get(k) for k in (
                         "q", "kv", "ms", "forward_lse_ms", "plain_ms", "library_ms",
                         "bound_ms", "bound_by", "bound_share", "max_abs_err", "splits")},
                     share_of_ar_train_step={k: trace[k] for k in (
                         "step_s", "k8bwd_s", "k8bwd_share_of_step", "k8_s", "k8_share_of_step")},
                     cases=[{k: c.get(k) for k in (
                         "name", "q", "kv", "dtype", "causal_offset", "kv_valid_start", "ms",
                         "forward_lse_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                         "bound_share", "max_abs_err", "grads", "plain_heads", "routes", "splits",
                         "repeats_bits", "rows_without_keys", "no_key_rows")}
                            for c in k8bwd.values()]))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    incomplete = [(r["name"], k) for r in table for k in keys if k not in r]
    if incomplete:
        raise AssertionError(f"kernel table rows without a key: {incomplete}")
    idle = [r["name"] for r in table if r["launches"] == 0]
    if idle:
        raise AssertionError(f"kernels that their path never launched: {idle}")
    print(json.dumps({"kernels": table}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
