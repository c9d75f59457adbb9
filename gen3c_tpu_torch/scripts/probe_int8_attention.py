"""P1: the card's wgmma matmul rate, bf16 against int8, by contraction depth and instruction form.

Port of scripts/probe_int8_attention.py. The Pallas kernel there keeps one
(M, K) x (K, N) tile resident and issues the product R times; here
``kernels.mma_probe`` (``csrc/mma_probe.cu``) does the same on the tensor
cores with ``wgmma`` (m64nNk16 bf16 -> fp32, m64nNk32 s8 -> s32), the
instruction the port's Hopper kernels issue (the attention family of
``attention_wgmma.cu``, K7's W8A8 product), its work cut into units that
fill the card without computing anything twice
(``kernels.cuda.mma_probe_plan``). The sweep is the JAX script's: M = N =
512 at K in {128, 256, 512, 1024}, then the two attention-block shapes
(1408, 128) x (128, 1024) (QK^T) and (1408, 1024) x (1024, 128) (PV), with
its R. Every case runs the headline form, the widest instruction its N tile
allows (n256; n128 at the PV block); the block shapes also run the port's
own forms no wider than their N tile (``PORT_FORMS``): bf16 SS n64 (K1's S
product with 64-key tiles), SS n128 (P2's 128-key points), RS n128 (K1's
P.V, A from registers) and s8 SS n128 and n256 (K7's: its 128-byte K stage
is the QK^T block's 4 k32 steps a pass). Last, K1's own tiles
(``K1_TILES``): its S product (SS n64, 8 k16 steps a pass) and its P.V (RS
n128, 4 steps a pass), each as one pass.

Each case is first checked against ``mma_probe_reference`` at R = 3 (int8
exactly, with 127s in A so that A + 1 wraps; bf16 within 1e-5 of R * (|a| +
1) @ |b|), then timed with CUDA events (median of 5 runs, each of enough
calls back to back to last RUN_MS, after a warm-up).
Printed per case, as one JSON line: the plan (units, R slices, K chunks),
the time and the rate of the function (2 M K N R operations) against the
data-sheet dense peaks (989 TF/s bf16, 1,979 TOPS int8). At the block
shapes and K1's tiles each case also runs back to back for about a second while
``nvidia-smi`` samples the SM clock and the power draw ("sustained": a rate
below the peak at a lowered clock is the power limit, not the kernel), and
each headline is timed beside the library yardstick: one ``torch.mm`` (fp32
out where the card's torch has ``aten::mm.dtype``, else bf16 out, named in
``library_call``) or ``torch._int_mm`` of the stacked operands
(``kernels.reference.mma_probe_stacked``: [A | A+1 | ...] @ [B; B; ...]).
Then one line of int8 / bf16 rate ratios per block shape and instruction
width, and as the last line the JSON list of every case.

    python -m gen3c_tpu_torch.scripts.probe_int8_attention

Old against new (a change to ``mma_probe.cu`` must keep P1's int8 bits):

    PYTHONPATH=<checkout> python gen3c_tpu_torch/scripts/probe_int8_attention.py run TAG

runs the ``kernels.mma_probe`` of the gen3c_tpu_torch found first on the
path at its default form on seeded operands (``RUN_CASES``) and prints one
JSON line: a hash of each output, bf16's largest error against the plain
version at the full R (absolute, relative to the largest |out|, and
whether it holds the 1e-5 R bound, which the fp32 sums keep at small R
only) and the ms (median of 5 runs of 5 calls). Run it for the old and
the new checkout in one call, in the order old, new, new, old.

It needs a CUDA card; it writes nothing but its standard output.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys

import torch

PEAK = {"bf16": 989.0, "int8": 1979.0}  # H100 SXM dense, data sheet (T/s)
SQUARE_K = (128, 256, 512, 1024)
BLOCK_SHAPES = ((1408, 128, 1024, "QK^T"), (1408, 1024, 128, "PV"))
# the port's own forms, beside the headline at the block shapes
PORT_FORMS = {"bf16": ("ss64", "ss128", "rs128"), "int8": ("ss128", "ss256")}
# K1's own tiles (attention_wgmma.cu, 64 keys a tile, head dim 128), bf16:
# S = Q K^T contracts 8 k16 steps into 64 columns (SS n64), P V 4 steps
# into 128 (RS n128), each a pass; R gives QK^T's operations at R 8,000
K1_TILES = ((1408, 128, 64, "K1 S tile", ("ss64",)), (1408, 64, 128, "K1 PV tile",
                                                      ("ss128", "rs128")))
K1_TILE_REPS = 64000
CHECK_REPS = 3
RUN_MS = 20.0  # a timed run's length: calls back to back
SUSTAIN_S = 1.0  # seconds of back-to-back calls while nvidia-smi samples
# the SM clock the data-sheet peaks assume: 989 TF/s = 132 SMs x 4,096 bf16
# flops a clock x 1.83 GHz; a rate at a sampled clock is also given against
# the peak scaled to that clock
PEAK_CLOCK_MHZ = 1830.0
# old against new: (M, K, N, R), the block shapes at the sweep's R and a
# ragged shape whose R slices start at odd passes
RUN_CASES = ((1408, 128, 1024, 8000), (1408, 1024, 128, 1000), (200, 256, 130, 5))


def reps_for(k: int, square: bool) -> int:
    """The JAX script's R at contraction depth k."""
    return max(2000, int(20000 * 128 / k)) if square else max(1000, int(8000 * 128 / k))


def cases() -> list:
    """Every (shape, dtype, form) the sweep runs, headline first at each
    shape and dtype."""
    from gen3c_tpu_torch.kernels import cuda

    out = []
    shapes = [(512, k, 512, f"square K={k}", True) for k in SQUARE_K]
    shapes += [(m, k, n, tag, False) for m, k, n, tag in BLOCK_SHAPES]
    for m, k, n, tag, square in shapes:
        for dtype in ("bf16", "int8"):
            head = cuda.mma_probe_form(n, dtype)
            forms = [head] if square else [head] + [
                f for f in PORT_FORMS[dtype]
                if f != head and cuda.MMA_PROBE_FORMS[dtype][f][0] <= max(64, n)]
            out += [{"case": tag, "M": m, "K": k, "N": n, "reps": reps_for(k, square),
                     "dtype": dtype, "form": f, "headline": f == head} for f in forms]
    for m, k, n, tag, forms in K1_TILES:
        head = cuda.mma_probe_form(n, "bf16")
        out += [{"case": tag, "M": m, "K": k, "N": n, "reps": K1_TILE_REPS, "dtype": "bf16",
                 "form": f, "headline": f == head} for f in forms]
    return out


def operands(m: int, k: int, n: int, dtype: str, gen: torch.Generator):
    """Seeded (a, b) on the card: int8 in [-100, 100) with 127s in a's first
    row (a + 1 wraps to -128 on odd passes), bf16 standard normal."""
    if dtype == "int8":
        a = torch.randint(-100, 100, (m, k), generator=gen, device="cuda").to(torch.int8)
        a[0, :4] = 127
        b = torch.randint(-100, 100, (k, n), generator=gen, device="cuda").to(torch.int8)
    else:
        a = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        b = torch.randn((k, n), generator=gen, device="cuda").to(torch.bfloat16)
    return a, b


def agreement(got: torch.Tensor, want: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              reps: int) -> tuple:
    """(agrees, max abs error) of P1's output against its plain version:
    int8 bit for bit, bf16 within 1e-5 of reps * (|a| + 1) @ |b| (fp32 sums
    in another order)."""
    err = (got.double() - want.double()).abs()
    if a.dtype == torch.int8:
        ok = torch.equal(got, want)
    else:
        ok = bool((err <= 1e-5 * reps * ((a.float().abs() + 1) @ b.float().abs())).all())
    return ok, err.max().item()


def check(a: torch.Tensor, b: torch.Tensor, reps: int = CHECK_REPS, form=None) -> float:
    """The kernel against its plain version at ``reps``: raises if they
    disagree; returns the max abs error."""
    from gen3c_tpu_torch import kernels

    got = kernels.mma_probe(a, b, reps, form)
    want = kernels.mma_probe_reference(a, b, reps)
    torch.cuda.synchronize()
    ok, err = agreement(got, want, a, b, reps)
    if not ok:
        raise AssertionError(f"P1 ({form}) disagrees with its plain version at {tuple(a.shape)} "
                             f"x {tuple(b.shape)} {a.dtype}, R {reps}: max |err| {err}")
    return err


def _ms(fn, timings: int, calls: int = 1) -> float:
    """Median CUDA-event milliseconds a call of fn() over ``timings`` runs
    of ``calls`` calls back to back (the host's time between calls kept
    out of a short kernel's)."""
    times = []
    for _ in range(timings):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return sorted(times)[len(times) // 2]


def _calls(fn) -> int:
    """Back-to-back calls a timed run needs to last about RUN_MS."""
    return max(1, int(RUN_MS / max(_ms(fn, 1), 1e-3)))


def sustained(fn, ms: float, seconds: float = SUSTAIN_S) -> dict:
    """fn() back to back for about ``seconds`` while nvidia-smi samples the
    card every 100 ms: the ms a call over that run and the medians of the
    SM clock (MHz) and power draw (W), with the power limit."""
    calls = max(1, int(seconds * 1e3 / max(ms, 1e-3)))
    smi = subprocess.Popen(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw,power.limit",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        smi.stdout.readline()  # the first sample: nvidia-smi is up, the card idle
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
    finally:
        smi.terminate()
        lines, _ = smi.communicate(timeout=30)
    samples = []
    for line in lines.splitlines():
        try:
            samples.append([float(x) for x in line.split(",")])
        except ValueError:
            continue
    if not samples:
        raise RuntimeError("nvidia-smi printed no sample while P1 ran")

    def median(i):
        vals = sorted(s[i] for s in samples)
        return vals[len(vals) // 2]

    return {"ms": start.elapsed_time(end) / calls, "calls": calls, "samples": len(samples),
            "sm_clock_mhz": median(0), "power_w": median(1), "power_limit_w": median(2)}


def _mm_fp32_out(device) -> bool:
    """Whether this torch has aten::mm.dtype on the card (bf16 in, fp32 out)."""
    x = torch.ones((16, 16), dtype=torch.bfloat16, device=device)
    try:
        return torch.mm(x, x, out_dtype=torch.float32).dtype == torch.float32
    except (RuntimeError, TypeError, NotImplementedError):
        return False


def library_call(a_st: torch.Tensor, bT_st: torch.Tensor):
    """(fn, name): the one PyTorch call that computes P1's sum from the
    stacked operands (``mma_probe_stacked``). The port never calls it."""
    if a_st.dtype == torch.int8:
        return (lambda: torch._int_mm(a_st, bT_st.t())), "torch._int_mm (int32 out)"
    if _mm_fp32_out(a_st.device):
        return ((lambda: torch.mm(a_st, bT_st.t(), out_dtype=torch.float32)),
                "torch.mm(out_dtype=torch.float32)")
    return (lambda: torch.mm(a_st, bT_st.t())), "torch.mm (bf16 out)"


def measure(m: int, k: int, n: int, dtype: str, reps: int, gen: torch.Generator,
            form=None, timings: int = 5, plain: bool = False, library: bool = False,
            sustain: bool = False) -> dict:
    """One case: checked at R = CHECK_REPS, then timed at ``reps``. With
    ``plain``, the plain version at the same R too (once), and the kernel's
    output held to it; with ``library``, the stacked one-call product timed
    (its operands freed after); with ``sustain``, ``sustained``'s run."""
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.kernels import cuda
    from gen3c_tpu_torch.kernels.reference import mma_probe_stacked

    a, b = operands(m, k, n, dtype, gen)
    form = cuda.mma_probe_form(n, dtype) if form is None else form
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    plan = cuda.mma_probe_plan(m, n, k, reps, dtype, form, sms)
    err = check(a, b, form=form)
    fn = lambda: kernels.mma_probe(a, b, reps, form)  # noqa: E731
    out = fn()  # warm-up
    calls = _calls(fn)
    ms = _ms(fn, timings, calls)
    ops = 2.0 * m * k * n * reps
    res = {"M": m, "K": k, "N": n, "dtype": dtype, "form": form, "reps": reps,
           "plan": {"units": plan.grid, "slices": plan.slices, "chunks": plan.chunks,
                    "chunk_steps": plan.chunk_steps, "smem": plan.smem,
                    "scratch_mb": plan.scratch * 4 / 1e6},
           "max_abs_err": err, "ms": ms, "calls": calls, "rate": ops / ms / 1e9,
           "peak_share": ops / ms / 1e9 / PEAK[dtype]}
    if sustain:
        s = sustained(fn, ms)
        rate = ops / s["ms"] / 1e9
        res["sustained"] = {**s, "rate": rate, "peak_share": rate / PEAK[dtype],
                            "clock_peak_share": rate / (PEAK[dtype] * s["sm_clock_mhz"]
                                                        / PEAK_CLOCK_MHZ)}
    if plain:
        want = [None]

        def run_plain():
            want[0] = kernels.mma_probe_reference(a, b, reps)

        res["plain_ms"] = _ms(run_plain, 1)
        # int8 is exact at any R. bf16's fp32 sums of R products drift in
        # both orders as R^2 (each add rounds a sum ~R times a product), so
        # the 1e-5 R bound holds at CHECK_REPS only: its error at R is kept
        ok, res["full_r_max_abs_err"] = agreement(out, want[0], a, b, reps)
        res["full_r_rel_err"] = res["full_r_max_abs_err"] / want[0].double().abs().max().item()
        if dtype == "int8" and not ok:
            raise AssertionError(f"P1 ({form}) int8 differs from its plain version at R {reps}: "
                                 f"max |err| {res['full_r_max_abs_err']}")
        del want
    if library:
        a_st, bT_st = mma_probe_stacked(a, b, reps)
        lib, res["library_call"] = library_call(a_st, bT_st)
        got = lib()
        res["library_max_abs_err"] = (got.double() - out.double()).abs().max().item()
        res["library_equal"] = bool(torch.equal(got, out))
        del got
        res["library_ms"] = _ms(lib, timings, _calls(lib))
        del a_st, bT_st, lib
        torch.cuda.empty_cache()
    return res


def ratios(results: list) -> list:
    """int8 / bf16 rate per block shape and instruction width (SS forms;
    the sustained rates where both were run)."""
    out = []
    for _, _, _, tag in BLOCK_SHAPES:
        rows = {(r["dtype"], r["form"]): r for r in results if r.get("case") == tag}
        for form in ("ss128", "ss256"):
            if ("bf16", form) in rows and ("int8", form) in rows:
                b16, i8 = rows["bf16", form], rows["int8", form]
                key = "sustained" if "sustained" in b16 and "sustained" in i8 else None
                rb = b16[key]["rate"] if key else b16["rate"]
                ri = i8[key]["rate"] if key else i8["rate"]
                out.append({"case": tag, "form": form, "int8_over_bf16": ri / rb,
                            "basis": key or "median"})
    return out


def run(tag: str) -> dict:
    """The old/new check: hashes, bf16 errors and ms of the kernels.mma_probe
    found first on the path, at each RUN_CASES shape and dtype."""
    from gen3c_tpu_torch import kernels

    res = {"tag": tag, "cases": []}
    for i, (m, k, n, reps) in enumerate(RUN_CASES):
        for dtype in ("bf16", "int8"):
            gen = torch.Generator(device="cuda").manual_seed(100 + i)
            a, b = operands(m, k, n, dtype, gen)
            out = kernels.mma_probe(a, b, reps)
            torch.cuda.synchronize()
            row = {"M": m, "K": k, "N": n, "reps": reps, "dtype": dtype,
                   "hash": hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16],
                   "ms": _ms(lambda: kernels.mma_probe(a, b, reps), 5, 5)}
            if dtype == "bf16":
                want = kernels.mma_probe_reference(a, b, reps)
                row["within_bound"], row["max_abs_err"] = agreement(out, want, a, b, reps)
                row["rel_err"] = row["max_abs_err"] / want.double().abs().max().item()
            res["cases"].append(row)
    print(json.dumps(res), flush=True)
    return res


def main(argv=None) -> list:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        raise SystemExit("the probe needs a CUDA card")
    if len(argv) == 2 and argv[0] == "run":
        return [run(argv[1])]
    if argv:
        raise SystemExit(__doc__)
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    blocks = {tag for _, _, _, tag in BLOCK_SHAPES}
    for c in cases():
        block = not c["case"].startswith("square")
        r = measure(c["M"], c["K"], c["N"], c["dtype"], c["reps"], gen, form=c["form"],
                    library=c["case"] in blocks and c["headline"], sustain=block)
        r["case"], r["headline"] = c["case"], c["headline"]
        print(json.dumps(r), flush=True)
        results.append(r)
    print(json.dumps({"ratios": ratios(results)}), flush=True)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
