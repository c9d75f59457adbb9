"""Two versions of the attention kernels side by side, on one card.

A change to ``kernels/csrc/attention.cu`` or ``attention_bwd.cu`` that should
not change K1's, K3's, K4's or K4-band's code or results (a refactor, or
instantiations added beside them) is held to the version before it:

    python -m gen3c_tpu_torch.scripts.compare_attention_builds ptx OLD.cu NEW.cu
        compiles both sources with kernels/build.py's flags, to PTX and
        through ptxas -v, and prints for every kernel entry whether its PTX
        is the same (line information, the anonymous namespace's hash and
        the module-wide numbers in block labels aside; where it differs,
        the first line that does) and its registers and stack,
        spill-store and spill-load bytes in each version.

    PYTHONPATH=<checkout> python gen3c_tpu_torch/scripts/compare_attention_builds.py run TAG
        runs the K1 and K3 (B = 2) and the K4 and K4-band (B = 1) of the
        gen3c_tpu_torch found first on the path at the GEN3C-7B self shape
        (B, 56,320, 32, 128) bf16, full and with the band 3,520 / 2 / 1,
        and K4 at two ragged bf16 shapes, and K1vit (MoGe's fp32 attention,
        (1, 1,351, 16, 64) as views of one qkv projection), and prints one
        JSON line: a hash of every output (forward, lse, dq, dk, dv),
        CUDA-event milliseconds (median of 3 after a warm-up), K1vit's
        largest error against its plain version and, where the checkout
        counts them, the attention launches by body (``route_counts``).

Run ``run`` for the old and the new checkout in one call, in the order old,
new, new, old: equal hashes show the same bits, and the times compare. The
wgmma body (attention_wgmma.cu) sums in the mma.sync bodies' order (each
k16 step in the tensor core, the same tiles per row in the same order), so
across that change of body too the hashes agree. K1vit's hash differs
wherever the fp32 body changes its summation order (the 3xTF32 body of
attention_f32.cu against the CUDA-core body before it); its error against
the plain version says whether both hold the fp32 tolerance.
"""

from __future__ import annotations

import hashlib
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

_NAMESPACE = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")
# a basic block's label, $L__BB<function>_<block>: the function's number is
# its place in the module, which moves when a source gains or loses a kernel
_BLOCK_LABEL = re.compile(r"\$L__BB\d+_")


def _ptx_entries(ptx: str) -> dict:
    """{entry name: its PTX lines, without line information, comments or
    the module-wide numbers in block labels}."""
    out, cur = {}, None
    for line in ptx.splitlines():
        m = re.match(r"\s*\.(?:visible\s+)?\.?entry\s+(\S+?)\(", line)
        if m:
            cur = _NAMESPACE.sub("NS", m.group(1))
            out[cur] = []
            continue
        s = line.strip()
        if s.startswith(".section"):  # debug sections: they spell the namespace hash in bytes
            cur = None
        if cur is not None and s and not s.startswith((".loc", ".file", "//")):
            out[cur].append(_BLOCK_LABEL.sub("$L__BB_", _NAMESPACE.sub("NS", s)))
    return out


def _ptxas_counts(log: str) -> dict:
    """{entry name: (registers, stack, spill-store, spill-load bytes)}."""
    out, cur, frame = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = _NAMESPACE.sub("NS", m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            frame = tuple(int(x) for x in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = (int(m.group(1)), *frame)
            cur = None
    return out


_TEMPLATE_ARG = re.compile(r"L([ib])(n?\d+)E")


def entry_key(name: str) -> str:
    """An entry's name for pairing two versions: a template kernel's
    mangled name read as ``kernel<arg,...>`` (ints, bools as 0 / 1) with
    its trailing false bools dropped, so that a kernel which gained a bool
    template flag (and with it, often, a parameter) pairs, at the flag's
    false value, with the entry it was; any other name as it is."""
    # a source name is <length><identifier>; the length may follow other digits
    for m, j in ((m, j) for m in re.finditer(r"\d+", name) for j in range(m.start(), m.end())):
        n, at = int(name[j:m.end()]), m.end()
        ident = name[at:at + n]
        if not re.fullmatch(r"[A-Za-z_]\w*", ident) or name[at + n:at + n + 1] != "I":
            continue
        args, pos = [], at + n + 1
        while (a := _TEMPLATE_ARG.match(name, pos)) is not None:
            args.append(a.group(2).replace("n", "-"))
            pos = a.end()
        if not args or name[pos:pos + 1] != "E":
            continue
        while len(args) > 1 and args[-1] == "0" and _TEMPLATE_ARG.findall(name[at:pos])[
                len(args) - 1][0] == "b":
            args.pop()
        return f"{ident}<{','.join(args)}>"
    return name


def compile_ptx(old: str, new: str) -> tuple:
    """Both sources compiled with kernels/build.py's flags: ({"old", "new":
    ``_ptx_entries``}, {"old", "new": ``_ptxas_counts``})."""
    from gen3c_tpu_torch.kernels.build import NVCC_FLAGS, find_nvcc

    flags = [f for f in NVCC_FLAGS if f != "--ptxas-options=-v"]
    nvcc = find_nvcc()
    ptx, counts = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, src in (("old", old), ("new", new)):
            out = Path(tmp) / f"{tag}.ptx"
            subprocess.run([nvcc, *flags, "-ptx", "-o", str(out), src], check=True)
            log = subprocess.run([nvcc, *flags, "--ptxas-options=-v", "-c", "-o",
                                  str(Path(tmp) / f"{tag}.o"), src],
                                 check=True, capture_output=True, text=True)
            ptx[tag] = _ptx_entries(out.read_text())
            counts[tag] = _ptxas_counts(log.stdout + log.stderr)
    return ptx, counts


def compare_ptx(old: str, new: str) -> bool:
    """Print the per-entry comparison; True when every entry that both
    versions have keeps its registers and spills (entries one version adds
    are listed, with null counts on the other side)."""
    ptx, counts = compile_ptx(old, new)
    for d in (*ptx.values(), *counts.values()):  # pair the entries by entry_key
        for name in list(d):
            d[entry_key(name)] = d.pop(name)
    same_counts, n_same_ptx = True, 0
    for name in sorted(set(ptx["old"]) | set(ptx["new"])):
        a, b = counts["old"].get(name), counts["new"].get(name)
        same_counts &= a == b or name not in ptx["old"] or name not in ptx["new"]
        same_ptx = ptx["old"].get(name) == ptx["new"].get(name)
        n_same_ptx += same_ptx
        row = {"entry": name, "ptx_identical": same_ptx, "regs_stack_spills_old": a,
               "regs_stack_spills_new": b}
        if not same_ptx and name in ptx["old"] and name in ptx["new"]:
            row["first_diff"] = next(
                ((i, x, y) for i, (x, y) in enumerate(zip(ptx["old"][name], ptx["new"][name]))
                 if x != y), (min(len(ptx["old"][name]), len(ptx["new"][name])), None, None))
        print(json.dumps(row))
    print(json.dumps({"entries": len(ptx["new"]), "added": len(set(ptx["new"]) - set(ptx["old"])),
                      "removed": len(set(ptx["old"]) - set(ptx["new"])),
                      "ptx_identical": n_same_ptx, "counts_identical": same_counts}))
    return same_counts


def _hash(*tensors) -> str:
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def run(tag: str) -> dict:
    """The K1 / K3 / K4 / K4-band / K1vit hashes and times of the
    gen3c_tpu_torch on the path."""
    import torch

    import gen3c_tpu_torch
    from gen3c_tpu_torch.kernels import cuda

    def ms(fn) -> float:
        fn()
        times = []
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[1]

    def inputs(shape_q, shape_kv, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        q, do = (torch.randn(shape_q, generator=gen, device="cuda").to(torch.bfloat16)
                 for _ in range(2))
        k, v = (torch.randn(shape_kv, generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        return q, k, v, do

    from gen3c_tpu_torch import kernels

    kernels.reset_launch_counts()
    res = {"tag": tag, "package": str(Path(gen3c_tpu_torch.__file__).parent)}
    q, k, v, _ = inputs((2, 56320, 32, 128), (2, 56320, 32, 128), 2)
    for name, band in (("k1", None), ("k3", (3520, 2, 1))):
        res[f"{name}_hash"] = _hash(cuda.attention(q, k, v, band))
        res[f"{name}_ms"] = ms(lambda: cuda.attention(q, k, v, band))
    del q, k, v
    q, k, v, do = inputs((1, 56320, 32, 128), (1, 56320, 32, 128), 0)
    for name, band in (("k4", None), ("k4band", (3520, 2, 1))):
        out, lse = cuda.attention_fwd_lse(q, k, v, band)
        res[f"{name}_hash"] = _hash(out, lse, *cuda.attention_bwd(q, k, v, out, do, lse, band))
        res[f"{name}_bwd_ms"] = ms(lambda: cuda.attention_bwd(q, k, v, out, do, lse, band))
        res[f"{name}_fwd_lse_ms"] = ms(lambda: cuda.attention_fwd_lse(q, k, v, band))
    del q, k, v, do, out, lse
    for name, lk, band in (("ragged_band", 1000, (37, 1, 2)), ("ragged_k4", 333, None)):
        q, k, v, do = inputs((2, 1000, 4, 64), (2, lk, 4, 64), 1)
        out, lse = cuda.attention_fwd_lse(q, k, v, band)
        res[f"{name}_hash"] = _hash(out, lse, *cuda.attention_bwd(q, k, v, out, do, lse, band))
    gen = torch.Generator(device="cuda").manual_seed(3)
    qkv = torch.randn((1, 1351, 3 * 1024), generator=gen, device="cuda")
    q, k, v = (t.reshape(1, 1351, 16, 64) for t in qkv.chunk(3, dim=-1))
    out = cuda.attention(q, k, v)
    res["k1vit_hash"] = _hash(out)
    res["k1vit_max_abs_err"] = (out - kernels.attention_reference(q, k, v)).abs().max().item()
    res["k1vit_ms"] = ms(lambda: cuda.attention(q, k, v))
    res["routes"] = dict(getattr(kernels, "route_counts", {})) or None
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
