"""Two versions of K8 (GQA attention over a KV cache) side by side, on one card.

A change to K8's body (``kernels/csrc/gqa_attention.cu``, and the kGqa mode
of ``attention_wgmma.cu``'s forward that runs its bf16 prefill) is held to
the version before it:

    python -m gen3c_tpu_torch.scripts.compare_gqa_builds ptx OLD.cu NEW.cu
        both sources compiled with kernels/build.py's flags; per kernel
        entry its registers, stack, spill-store and spill-load bytes in each
        version (``compare_attention_builds``' ptx mode), and the
        tensor-core instructions its PTX holds: ``wgmma`` (wgmma.mma_async)
        and ``mma`` (mma.sync) lines, 0 for a CUDA-core body.

    PYTHONPATH=<checkout> python gen3c_tpu_torch/scripts/compare_gqa_builds.py run TAG
        runs the K8 of the gen3c_tpu_torch found first on the path at
        chip_smoke.py's shapes, on one layer of a seeded 4B cache (1, 12,800,
        8, 128): decode (q (1, 1, 32, 128)) at pos 5,120 and 12,799, and at
        pos 0 (one key: the launch's fixed cost), and the 5,120-token causal
        prefill, each over bf16 K/V and over int8 codes with fp32 scales;
        and prints one JSON line: per case the device milliseconds of a call
        (``scripts/card.py``'s ``device_ms``: torch.profiler's kernel
        durations, the 50 MB L2 read over before each call; it raises where
        the profile lost a kernel) and the kernels a call launches, those of
        SDPA (``enable_gqa``; over the dequantized K/V for int8) timed the
        same way, the wrapper's host microseconds a
        call, the largest error against the plain version (the prefill's on
        its first KV head's four query heads) with the mean |plain| beside
        it, and a hash of the output.

Run ``run`` for the old and the new checkout in one call, in the order old,
new, new, old: the times compare, and equal hashes within a version show
that its output repeats bit for bit (old and new sum in different orders,
so their hashes differ; their errors say whether each holds its tolerance).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

CACHE = (1, 12800, 8, 128)  # one layer of the 4B's KV cache: (B, max_seq, Hkv, d)
HQ = 32
PREFIX = 5120  # the 4B's prefill: 2 of the grid's 5 latent frames of 40 x 64 tokens
# (name, query length, causal offset, int8)
CASES = (("decode bf16 pos 0", 1, 0, False),
         ("decode int8 pos 0", 1, 0, True),
         ("decode bf16 pos 5,120", 1, PREFIX, False),
         ("decode bf16 pos 12,799", 1, CACHE[1] - 1, False),
         ("decode int8 pos 5,120", 1, PREFIX, True),
         ("decode int8 pos 12,799", 1, CACHE[1] - 1, True),
         ("prefill bf16 5,120", PREFIX, 0, False),
         ("prefill int8 5,120", PREFIX, 0, True))
PLAIN_HEADS = 4  # the prefill's plain version on the first KV head's query heads


def compare_ptx(old: str, new: str) -> bool:
    """Print ``compare_attention_builds``' per-entry rows with each entry's
    tensor-core instruction counts; True when every entry both versions
    have keeps its registers and spills."""
    from gen3c_tpu_torch.scripts.compare_attention_builds import compile_ptx

    ptx, counts = compile_ptx(old, new)

    def tensor_cores(lines):
        if lines is None:
            return None
        return {"wgmma": sum("wgmma.mma_async" in x for x in lines),
                "mma": sum(x.startswith("mma.sync") for x in lines)}

    same_counts = True
    for name in sorted(set(ptx["old"]) | set(ptx["new"])):
        a, b = counts["old"].get(name), counts["new"].get(name)
        same_counts &= a == b or name not in ptx["old"] or name not in ptx["new"]
        same_ptx = ptx["old"].get(name) == ptx["new"].get(name)
        print(json.dumps({"entry": name, "ptx_identical": same_ptx,
                          "regs_stack_spills_old": a, "regs_stack_spills_new": b,
                          "tensor_cores_old": tensor_cores(ptx["old"].get(name)),
                          "tensor_cores_new": tensor_cores(ptx["new"].get(name))}))
    print(json.dumps({"entries_old": len(ptx["old"]), "entries_new": len(ptx["new"]),
                      "counts_identical": same_counts}))
    return same_counts


def card():
    """This tree's ``scripts/card.py``, loaded by path: the timing helpers
    stay the same whichever checkout's package the path holds."""
    import importlib.util

    path = Path(__file__).with_name("card.py")
    spec = importlib.util.spec_from_file_location("_gqa_card", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(tag: str) -> dict:
    """K8's device times, errors and hashes of the gen3c_tpu_torch on the path."""
    import hashlib

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("compare_gqa_builds run needs a CUDA card")
    import gen3c_tpu_torch
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.models.dit import quantize_span_delta

    timing = card()
    res = {"tag": tag, "package": str(Path(gen3c_tpu_torch.__file__).parent),
           "card": timing.nvidia_smi_line()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, Lq, pos, int8 in CASES:
        k, v = (torch.randn(CACHE, generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        ks = vs = None
        if int8:
            (k, ks), (v, vs) = quantize_span_delta(k), quantize_span_delta(v)
        q = torch.randn((CACHE[0], Lq, HQ, CACHE[3]), generator=gen,
                        device="cuda").to(torch.bfloat16)

        def k8():
            return kernels.gqa_attention(q, k, v, pos, None, ks, vs)

        out = k8()
        h = slice(0, HQ if Lq == 1 else PLAIN_HEADS)
        g = slice(0, h.stop * CACHE[2] // HQ)
        ref = kernels.gqa_attention_reference(
            q[:, :, h], k[:, :, g], v[:, :, g], pos, None,
            None if ks is None else ks[:, :, g], None if vs is None else vs[:, :, g])
        calls = 3 if Lq > 1 else 20
        dev = timing.device_ms(k8, calls=calls)
        vis = pos + Lq
        kd, vd = k[:, :vis], v[:, :vis]
        if int8:
            kd, vd = ((t.float() * s[:, :vis]).to(torch.bfloat16) for t, s in ((kd, ks), (vd, vs)))
        qt, kt, vt = q.transpose(1, 2), kd.transpose(1, 2), vd.transpose(1, 2)
        sdpa = timing.device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=Lq > 1, enable_gqa=True), calls=calls)
        res[name] = {"device_ms": dev["ms"], "kernels_a_call": dev["kernels"],
                     "sdpa_device_ms": sdpa["ms"], "sdpa_kernels_a_call": sdpa["kernels"],
                     "host_us": timing.host_us(k8, calls=calls),
                     "max_abs_err": (out[:, :, h].float() - ref.float()).abs().max().item(),
                     "mean_abs_plain": ref.float().abs().mean().item(),
                     "hash": hashlib.sha256(out.view(torch.uint8).cpu().numpy().tobytes())
                     .hexdigest()[:16]}
        del q, k, v, ks, vs, out, ref, kd, vd, qt, kt, vt
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    return res


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) == 3 and argv[0] == "ptx":
        return 0 if compare_ptx(argv[1], argv[2]) else 1
    if len(argv) == 2 and argv[0] == "run":
        run(argv[1])
        return 0
    raise SystemExit(__doc__)


if __name__ == "__main__":
    sys.exit(main())
