"""The wgmma forward with three consumer warpgroups against its own two.

``kernels/csrc/attention_wgmma.cu`` gives a forward CTA two consumer
warpgroups: 128 queries, 64 a warpgroup. This probe builds a copy of that
source with three (384 consumer threads, 192 queries a CTA, so 512 threads
and ptxas's budget of 128 registers a thread, split 24 / 160 by setmaxnreg)
into a temporary directory, prints ptxas's registers and spills for each
forward entry, and times it against the repo's forward at the GEN3C-7B self shape (2, 56,320, 32, 128)
bf16, full and with the band 3,520 / 2 / 1, in the order two, three, three,
two (CUDA events, median of 5 after a warm-up). Both read the same tiles in
the same order for every row, so the outputs must be equal bit for bit.
Only the forward entry of the copy is called: its backward kernels are
built but not meaningful at 192 rows.

    python -m gen3c_tpu_torch.scripts.probe_forward_warpgroups

It needs a CUDA card and nvcc. One JSON line per entry and per case.
"""

from __future__ import annotations

import ctypes
import json
import math
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

# (the repo's line, the three-warpgroup line): 384 consumer threads, 192
# queries a CTA, and a register split that fits 512 threads' 128 a thread
_VARIANT = (("constexpr int kConsumerThreads = 256;", "constexpr int kConsumerThreads = 384;"),
            ("constexpr int kBlockM = 128;", "constexpr int kBlockM = 192;"),
            ("constexpr int kProducerRegs = 40, kConsumerRegs = 232;",
             "constexpr int kProducerRegs = 24, kConsumerRegs = 160;"),
            ("<= kThreads * 168,", "<= kThreads * 128,"))


def _build(tmp: Path) -> ctypes.CDLL:
    from gen3c_tpu_torch.kernels import build

    for path in build.CSRC.iterdir():
        if path.suffix == ".h":
            shutil.copy(path, tmp / path.name)
    src = (build.CSRC / "attention_wgmma.cu").read_text()
    for old, new in _VARIANT:
        if old not in src:
            raise RuntimeError(f"attention_wgmma.cu no longer holds {old!r}")
        src = src.replace(old, new)
    (tmp / "attention_wgmma.cu").write_text(src)
    lib_path = tmp / "libvariant.so"
    p = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib_path),
                        str(tmp / "attention_wgmma.cu")], capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(p.stderr[-3000:])
    entry = None
    for line in (p.stdout + p.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if entry and "attn_fwd_wgmma" in entry and m:
            print(json.dumps({"entry": entry, "spill_stores": int(m.group(1)),
                              "spill_loads": int(m.group(2))}), flush=True)
        m = re.search(r"Used (\d+) registers", line)
        if entry and "attn_fwd_wgmma" in entry and m:
            print(json.dumps({"entry": entry, "registers": int(m.group(1))}), flush=True)
    lib = ctypes.CDLL(str(lib_path))
    _P, _I = ctypes.c_void_p, ctypes.c_int
    lib.gen3c_attention_wgmma_fwd.argtypes = (
        [_P, _P, _P, ctypes.POINTER(ctypes.c_longlong), _P, _P] + [_I] * 5
        + [ctypes.c_float, ctypes.POINTER(_I), _I, _I, _P, _P])
    lib.gen3c_attention_wgmma_fwd.restype = _I
    return lib


def main() -> None:
    import torch

    from gen3c_tpu_torch.kernels import cuda

    def variant_fwd(lib, q, k, v, band):
        out = torch.empty_like(q)
        words = []
        for t, rows in ((q, 192), (k, cuda.WGMMA_FWD_BOX_ROWS[1]), (v, cuda.WGMMA_FWD_BOX_ROWS[2])):
            m = cuda.tensor_map_params(t, rows)
            words += m["dims"] + m["strides"] + m["box"] + [m["swizzle"], m["order"]]
        B, Lq, H, D = q.shape
        rc = lib.gen3c_attention_wgmma_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), (ctypes.c_longlong * len(words))(*words),
            out.data_ptr(), None, B, Lq, k.shape[1], H, D, 1 / math.sqrt(D),
            None if band is None else (ctypes.c_int * 3)(*band), 0, 0, None,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"three-warpgroup forward: cudaError {rc}")
        return out

    def ms(fn, reps=5):
        fn()
        times = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return sorted(times)[reps // 2]

    with tempfile.TemporaryDirectory() as tmp:
        lib = _build(Path(tmp))
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn((2, 56320, 32, 128), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        for band in (None, (3520, 2, 1)):
            two = lambda: cuda.attention(q, k, v, band)  # noqa: E731
            three = lambda: variant_fwd(lib, q, k, v, band)  # noqa: E731
            same = torch.equal(two(), three())
            times = [ms(two), ms(three), ms(three), ms(two)]
            print(json.dumps({"case": "band 3520/2/1" if band else "full", "bits_equal": same,
                              "two_wg_ms": [times[0], times[3]],
                              "three_wg_ms": [times[1], times[2]]}), flush=True)


if __name__ == "__main__":
    main()
