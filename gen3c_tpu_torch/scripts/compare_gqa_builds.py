"""Two versions of K8 (GQA attention over a KV cache) and K8bwd (its backward)
side by side, on one card.

A change to K8's body (``kernels/csrc/gqa_attention.cu``, and the kGqa mode
of ``attention_wgmma.cu``'s forward that runs its bf16 prefill) or to
K8bwd's (``attention_wgmma.cu``'s backward pair in its kGqa mode, and
``gqa_attention_bwd.cu``'s fp32 bodies) is held to the version before it:

    python -m gen3c_tpu_torch.scripts.compare_gqa_builds ptx OLD.cu NEW.cu [OLD2.cu NEW2.cu ...]
        each pair of sources compiled with kernels/build.py's flags; per
        kernel entry its registers, stack, spill-store and spill-load bytes
        in each version (``compare_attention_builds``' ptx mode, entries
        paired by ``entry_key``: a template flag added with the value false
        keeps the pairing), and the tensor-core instructions its PTX holds:
        ``wgmma`` (wgmma.mma_async) and ``mma`` (mma.sync) lines, 0 for a
        CUDA-core body. Give attention_wgmma.cu and gqa_attention_bwd.cu
        both, so that K8bwd's old entries and new ones are listed.

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
        it, and a hash of the output. Then K8bwd (``cuda.gqa_attention_bwd``
        after K8's forward with lse) at chip_smoke.py's K8BWD_CASES (this
        tree's, loaded by path): device ms a call, SDPA's backward
        (``enable_gqa``; a dense mask for the padded case) timed the same
        way, each gradient's largest error against the plain version
        (relative to its largest |gradient|, on the case's plain groups;
        rows that see no key get dout 0, as in the smoke) and a hash of dq,
        dk and dv.

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


def compare_ptx(*pairs: str) -> bool:
    """Print ``compare_attention_builds``' per-entry rows, entries paired by
    ``entry_key``, with each entry's tensor-core instruction counts, for
    the (old, new) source pairs; True when every entry both versions have
    keeps its registers and spills."""
    from gen3c_tpu_torch.scripts.compare_attention_builds import compile_ptx, entry_key

    ptx = {"old": {}, "new": {}}
    counts = {"old": {}, "new": {}}
    for old, new in zip(pairs[::2], pairs[1::2]):
        got_ptx, got_counts = compile_ptx(old, new)
        for side in ("old", "new"):
            ptx[side].update({entry_key(n): x for n, x in got_ptx[side].items()})
            counts[side].update({entry_key(n): x for n, x in got_counts[side].items()})

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


def _this_tree(path: Path, name: str):
    """A module of the tree this script belongs to, loaded by path, so that
    it stays the same whichever checkout's package the path holds."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card():
    """This tree's ``scripts/card.py``: the timing helpers."""
    return _this_tree(Path(__file__).with_name("card.py"), "_gqa_card")


def chip_smoke():
    """This tree's chip_smoke.py: K8bwd's cases."""
    return _this_tree(Path(__file__).resolve().parents[2] / "chip_smoke.py", "_gqa_chip_smoke")


def run_bwd(timing, gen) -> dict:
    """K8bwd at chip_smoke.py's K8BWD_CASES: {case name: device ms, SDPA's
    backward device ms, errors, hash}."""
    import hashlib

    import torch
    import torch.nn.functional as F

    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.kernels import cuda

    out = {}
    for name, B, Lq, Lk, Hq, Hkv, D, dtype, causal, pad, groups in chip_smoke().K8BWD_CASES:
        dtype = getattr(torch, dtype)
        q = torch.randn((B, Lq, Hq, D), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((B, Lk, Hkv, D), generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        dout = torch.randn((B, Lq, Hq, D), generator=gen, device="cuda").to(dtype)
        start = None if pad is None else torch.tensor(pad, dtype=torch.int64, device="cuda")
        o, lse = cuda.gqa_attention_fwd_lse(q, k, v, causal, start)
        qpos, kpos = torch.arange(Lq, device="cuda"), torch.arange(Lk, device="cuda")
        lo = torch.zeros(B, dtype=torch.int64, device="cuda") if start is None else start
        last = ((qpos + causal).clamp(max=Lk - 1) if causal is not None
                else torch.full((Lq,), Lk - 1, device="cuda"))
        mask = (kpos[None, None] >= lo[:, None, None]) & (kpos[None, None] <= last[None, :, None])
        none = ~mask.any(-1)  # (B, Lq): rows that see no key
        dout = dout.masked_fill(none[:, :, None, None], 0)

        def bwd():
            return cuda.gqa_attention_bwd(q, k, v, o, dout, lse, causal, start)

        grads = bwd()
        g = Hkv if groups is None else groups
        rep = Hq // Hkv
        plain = kernels.gqa_attention_backward_reference(
            q[:, :, :g * rep].float(), k[:, :, :g].float(), v[:, :, :g].float(),
            dout[:, :, :g * rep].float(), causal, start)
        errs = {}
        for nm, got, ref in zip(("dq", "dk", "dv"), grads, plain):
            got = got[:, :, :g * rep] if nm == "dq" else got[:, :, :g]
            d = (got.float() - ref).abs()
            errs[nm] = {"rel_max": (d.max() / ref.abs().max()).item(),
                        "rel_mean": (d.mean() / ref.abs().mean()).item()}
        h = hashlib.sha256()
        for t in grads:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        calls = 3 if Lq * Lk > 1e7 else 20
        dev = timing.device_ms(bwd, calls=calls)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        lib = F.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in leaves), attn_mask=mask[:, None] if pad else None,
            is_causal=causal is not None and not pad, enable_gqa=True).transpose(1, 2)
        sdpa = timing.device_ms(lambda: torch.autograd.grad(lib, leaves, dout, retain_graph=True),
                                calls=calls)
        out[name] = {"device_ms": dev["ms"], "kernels_a_call": dev["kernels"],
                     "sdpa_device_ms": sdpa["ms"], "sdpa_kernels_a_call": sdpa["kernels"],
                     "errors": errs, "plain_heads": g * rep,
                     "max_rel_err": max(e["rel_max"] for e in errs.values()),
                     "hash": h.hexdigest()[:16]}
        del q, k, v, dout, o, lse, grads, plain, leaves, lib, mask
        torch.cuda.empty_cache()
    return out


def run(tag: str) -> dict:
    """K8's and K8bwd's device times, errors and hashes of the
    gen3c_tpu_torch on the path."""
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
    res["K8bwd"] = run_bwd(timing, gen)
    print(json.dumps(res), flush=True)
    return res


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) >= 3 and len(argv) % 2 == 1 and argv[0] == "ptx":
        return 0 if compare_ptx(*argv[1:]) else 1
    if len(argv) == 2 and argv[0] == "run":
        run(argv[1])
        return 0
    raise SystemExit(__doc__)


if __name__ == "__main__":
    sys.exit(main())
