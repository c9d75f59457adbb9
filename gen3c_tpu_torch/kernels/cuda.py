"""ctypes bindings of the compiled kernels (CUDA tensors only).

Each function checks device, dtype, shape and layout, allocates its output
with torch, launches on PyTorch's current stream and raises if the launch
is refused. Nothing here is imported by the CPU path.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from gen3c_tpu_torch.kernels import build as _build

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build.build()["path"])
            attn = [_P, _P, _P, _P, ctypes.POINTER(ctypes.c_longlong),
                    _I, _I, _I, _I, _I, ctypes.c_float, ctypes.POINTER(_I), _P]
            lib.gen3c_attention_bf16.argtypes = attn + [_I, _P]
            lib.gen3c_attention_f32.argtypes = attn + [_I, _P]
            lib.gen3c_attention_f32_smem.argtypes = [_I]
            lib.gen3c_splat.argtypes = [_P] * 9 + [_I] * 5 + [ctypes.c_float, _I, _P,
                                                              ctypes.POINTER(ctypes.c_float), _P]
            lib.gen3c_quant_rows.argtypes = [_P, _L, _I, _I, _I, _P, _P, _P, _P, _P]
            lib.gen3c_w8a8_gemm_wgmma.argtypes = [_P, _P, ctypes.POINTER(ctypes.c_longlong),
                                                  _P, _P, _P, _I, _I, _I, _I, _P]
            lib.gen3c_w8a8_box_rows.argtypes = [ctypes.POINTER(_I)]
            lib.gen3c_w8a8_box_rows.restype = None
            shape = [_I, _I, _I, _I, _I, ctypes.c_float, _I, _I, ctypes.POINTER(_I), _P, _P]
            lib.gen3c_attention_fwd_lse.argtypes = [_P] * 5 + shape
            lib.gen3c_attention_ring_fold.argtypes = [_P] * 5 + shape[:-2] + [_I, _I, _P]
            lib.gen3c_attention_merge.argtypes = [_P] * 5 + [_I] * 6 + [_P]
            lib.gen3c_attention_bwd.argtypes = [_P] * 10 + shape
            lib.gen3c_mma_probe.argtypes = ([_P] * 4 + [_I] * 8
                                           + [ctypes.POINTER(ctypes.c_longlong), _P])
            lib.gen3c_ray_triangle_depth.argtypes = [_P, _P, _P, _P, _I, _I, _P, _P]
            lib.gen3c_ray_triangle_prepare.argtypes = [_P, _P, _P, _I, _P, _P, _P, _P]
            lib.gen3c_gqa_attention.argtypes = [_P] * 7 + [ctypes.POINTER(_L), _I, _I, _P, _P]
            lib.gen3c_gqa_attention_wgmma.argtypes = ([_P, _P, _P, ctypes.POINTER(_L), _P, _P]
                                                      + [_I] * 7 + [ctypes.c_float, _P, _P])
            lib.gen3c_gqa_attention_bwd.argtypes = [_P] * 11 + [_I] * 7 + [_P]
            lib.gen3c_gqa_attention_wgmma_bwd.argtypes = ([_P] * 5 + [ctypes.POINTER(_L)]
                                                          + [_P] * 7 + [_I] * 7
                                                          + [ctypes.c_float, _I, _P])
            lib.gen3c_gqa_plan_words.argtypes = []
            words = ctypes.POINTER(ctypes.c_longlong)
            band_ptr = ctypes.POINTER(_I)
            _fwd_argtypes(lib)
            lib.gen3c_attention_wgmma_bwd.argtypes = ([_P] * 5 + [words] + [_P] * 5 + [_I] * 5
                                                      + [ctypes.c_float, band_ptr, _P, _P])
            for fn in (lib.gen3c_attention_bf16, lib.gen3c_attention_f32, lib.gen3c_splat,
                       lib.gen3c_quant_rows, lib.gen3c_w8a8_gemm_wgmma,
                       lib.gen3c_attention_fwd_lse, lib.gen3c_attention_bwd,
                       lib.gen3c_attention_ring_fold, lib.gen3c_attention_merge,
                       lib.gen3c_mma_probe, lib.gen3c_attention_f32_smem,
                       lib.gen3c_ray_triangle_depth, lib.gen3c_ray_triangle_prepare,
                       lib.gen3c_attention_wgmma_bwd, lib.gen3c_gqa_attention,
                       lib.gen3c_gqa_attention_wgmma, lib.gen3c_gqa_plan_words,
                       lib.gen3c_gqa_attention_bwd, lib.gen3c_gqa_attention_wgmma_bwd):
                fn.restype = _I
            if _box_rows(lib) != (WGMMA_FWD_BOX_ROWS, WGMMA_BWD_BOX_ROWS):
                raise RuntimeError(f"attention_wgmma.cu's box rows {_box_rows(lib)} differ "
                                   "from cuda.py's")
            if lib.gen3c_gqa_plan_words() != GQA_PLAN_WORDS:
                raise RuntimeError(f"gqa_attention.cu's plan has {lib.gen3c_gqa_plan_words()} "
                                   f"words; cuda.py writes {GQA_PLAN_WORDS}")
            w8a8_rows = (_I * 2)()
            lib.gen3c_w8a8_box_rows(w8a8_rows)
            if tuple(w8a8_rows) != W8A8_BOX_ROWS:
                raise RuntimeError(f"w8a8.cu's box rows {tuple(w8a8_rows)} differ from "
                                   f"cuda.py's {W8A8_BOX_ROWS}")
            _lib = lib
        return _lib


def _fwd_argtypes(lib: ctypes.CDLL) -> None:
    """The signatures of attention_wgmma.cu's forward entries, in the
    library or in a forward built apart (``forward_variant``)."""
    lib.gen3c_attention_wgmma_fwd.argtypes = (
        [_P, _P, _P, ctypes.POINTER(_L), _P, _P] + [_I] * 5
        + [ctypes.c_float, ctypes.POINTER(_I), _I, _I, _P, _P])
    lib.gen3c_attention_wgmma_fwd.restype = _I
    lib.gen3c_attention_wgmma_box_rows.argtypes = [ctypes.POINTER(_I)] * 2
    lib.gen3c_attention_wgmma_box_rows.restype = None
    lib.gen3c_attention_wgmma_smem.argtypes = [_I, ctypes.POINTER(_I)]
    lib.gen3c_attention_wgmma_smem.restype = None
    lib.gen3c_attention_wgmma_fwd_point.argtypes = [ctypes.POINTER(_I)]
    lib.gen3c_attention_wgmma_fwd_point.restype = None


def _box_rows(lib: ctypes.CDLL) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The (forward, backward) box rows a build of attention_wgmma.cu wants."""
    fwd_rows, bwd_rows = (_I * 3)(), (_I * 8)()
    lib.gen3c_attention_wgmma_box_rows(fwd_rows, bwd_rows)
    return tuple(fwd_rows), tuple(bwd_rows)


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Tuple[int, ...]:
    """What every attention kernel takes: q (B, Lq, H, D), k/v (B, Lk, H, D)
    on one CUDA device, bf16 or fp32, 0 < D <= 128, B and H <= 65535;
    returns (B, Lq, Lk, H, D)."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("attention kernel: q, k, v must be on one CUDA device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"attention kernel takes bf16 or fp32, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"attention kernel: bad shapes {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    B, Lq, H, D = q.shape
    if k.shape[0] != B or k.shape[2] != H or k.shape[3] != D:
        raise ValueError(f"attention kernel: q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree")
    if not 0 < D <= 128 or B > 65535 or H > 65535:
        raise ValueError(f"attention kernel takes head dim <= 128, B and H <= 65535 (got {q.shape})")
    return B, Lq, k.shape[1], H, D


def _band_arg(band: Optional[Tuple[int, int, int]], Lq: int, Lk: int):
    """The kernels' {hw, window, prefix} array for a band (None: full
    attention). Every query row must see at least one key."""
    if band is None:
        return None
    hw, window, prefix = (int(x) for x in band)
    if hw <= 0 or window < 0 or prefix < 0:
        raise ValueError(f"attention kernel: bad band {band}")
    if prefix == 0 and ((Lq - 1) // hw - window) * hw >= Lk:
        raise ValueError(f"attention kernel: band {band} leaves queries of Lq={Lq} "
                         f"no key among Lk={Lk}")
    return (_I * 3)(hw, window, prefix)


def _visited_ptr(visited: Optional[torch.Tensor], n: int):
    """The device address of ``n`` int64 tile counters (or None)."""
    if visited is None:
        return None
    if not (visited.is_cuda and visited.dtype == torch.int64 and visited.numel() == n
            and visited.is_contiguous()):
        raise ValueError(f"attention kernel: visited must be {n} contiguous int64 on the card")
    return visited.data_ptr()

# ------------------------------ the attention route ------------------------------
#
# Every bf16 attention entry (K1, K2, K3, K1cp, K1ag, the forward with lse,
# K3lse, K1ring; K4 and K4-band) takes one of two bodies, by one rule:
# ``attention_route``. "wgmma" (csrc/attention_wgmma.cu, TMA loads and wgmma
# products) for every input a TMA tensor map can describe; "mma_sync"
# (attention.cu / attention_bwd.cu) for the rest. fp32 inputs take no route:
# the forward runs attention_f32.cu (three TF32 products on the tensor cores),
# the training kernels attention_bwd.cu's fp32 bodies. Each launch of the
# family adds one to its route's count in ``kernels.route_counts``.

TMA_BOX_COLS = 64  # elements of D per box: 128 bytes of bf16, the swizzle span
TMA_SWIZZLE = 128
# Box rows of attention_wgmma.cu's maps (gen3c_attention_wgmma_box_rows, checked
# when the library loads): forward q, k, v; backward dK/dV q, k, v, dout, then
# dQ q, k, v, dout.
WGMMA_FWD_BOX_ROWS = (128, 64, 64)
WGMMA_BWD_BOX_ROWS = (32, 128, 128, 32, 128, 64, 64, 128)


def tma_describable(t: torch.Tensor) -> bool:
    """Whether a (B, L, H, D) tensor fits attention_wgmma.cu's tensor maps:
    bf16, 0 < D <= 128 with D a multiple of 8 (rows of 16-byte multiples),
    unit stride along D, a 16-byte aligned base, and a positive 16-byte
    multiple as the byte stride of every other dim longer than 1."""
    if t.dtype != torch.bfloat16 or t.ndim != 4:
        return False
    D = t.shape[3]
    if not (0 < D <= 128 and D % 8 == 0) or t.stride(3) != 1 or t.data_ptr() % 16:
        return False
    return all(t.shape[i] == 1 or (t.stride(i) > 0 and t.stride(i) * t.element_size() % 16 == 0)
               for i in range(3))


def attention_route(*tensors: torch.Tensor) -> str:
    """The body a bf16 attention call runs: "wgmma" when every tensor of the
    call is ``tma_describable``, else "mma_sync"; "fp32" for fp32 inputs
    (attention_f32.cu and attention_bwd.cu's fp32 bodies). The same rule
    for every entry of the family, so at a given shape and layout they all
    take the same body."""
    if tensors[0].dtype == torch.float32:
        return "fp32"
    return "wgmma" if all(tma_describable(t) for t in tensors) else "mma_sync"


def tensor_map_params(t: torch.Tensor, box_rows: int) -> dict:
    """The tiled tensor map of a ``tma_describable`` (B, L, H, D) tensor for
    boxes of ``box_rows`` sequence rows by ``TMA_BOX_COLS`` of D, in the
    words cuTensorMapEncodeTiled takes: dims (elements, D first), the byte
    strides of dims 1..3, the box, the swizzle in bytes, and ``order``: for
    map dims 1..3, which of head (0), sequence (1) and batch (2) each holds,
    two bits a dim. The dims after D go in ascending order of their strides
    (a dim of length 1 last, with the extent so far as its stride): the
    layout of a permuted packed tensor, as K1cp's all-to-all view is."""
    if not tma_describable(t):
        raise ValueError(f"no tensor map for {t.dtype} {tuple(t.shape)} strides {t.stride()}")
    B, L, H, D = t.shape
    elem = t.element_size()
    outer = [(t.stride(2) * elem, H, 0), (t.stride(1) * elem, L, 1), (t.stride(0) * elem, B, 2)]
    long_dims = sorted((o for o in outer if o[1] > 1), key=lambda o: o[0])
    extent = D * elem
    dims, strides, which = [D], [], []
    for stride, n, w in long_dims:
        dims.append(n)
        strides.append(stride)
        which.append(w)
        extent = max(extent, stride * n)
    for _, n, w in (o for o in outer if o[1] == 1):
        dims.append(1)
        strides.append(-(-extent // 16) * 16)
        which.append(w)
    return {"dims": dims, "strides": strides,
            "box": [TMA_BOX_COLS] + [box_rows if w == 1 else 1 for w in which],
            "swizzle": TMA_SWIZZLE, "order": sum(w << (2 * i) for i, w in enumerate(which))}


def _map_words(pairs) -> ctypes.Array:
    """The words gen3c_attention_wgmma_* take, per (tensor, box rows): dims[4],
    strides[3], box[4], swizzle, order (attention_wgmma.cu's make_map)."""
    words = []
    for t, rows in pairs:
        m = tensor_map_params(t, rows)
        words += m["dims"] + m["strides"] + m["box"] + [m["swizzle"], m["order"]]
    return (ctypes.c_longlong * len(words))(*words)


def _count_route(route: str) -> None:
    from gen3c_tpu_torch.kernels import route_counts

    if route in route_counts:
        route_counts[route] += 1


def _wgmma_fwd(q, k, v, out, lse, band_arg, q_off, k_off, visited_ptr) -> None:
    """gen3c_attention_wgmma_fwd into out (and lse, unless None)."""
    B, Lq, H, D = q.shape
    words = _map_words(zip((q, k, v), WGMMA_FWD_BOX_ROWS))
    _check(library().gen3c_attention_wgmma_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), words, out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, Lq, k.shape[1], H, D, 1.0 / math.sqrt(D),
        band_arg, int(q_off), int(k_off), visited_ptr, _stream(q)), "attention_wgmma_fwd")


def wgmma_smem_bytes(d: int) -> dict:
    """The dynamic shared memory attention_wgmma.cu's kernels ask for at head
    dim d (its DP: 64 or 128)."""
    out = (_I * 3)()
    library().gen3c_attention_wgmma_smem(64 if d <= 64 else 128, out)
    return {"fwd": out[0], "dkdv": out[1], "dq": out[2]}


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              band: Optional[Tuple[int, int, int]] = None,
              visited: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, Lq, H, D) x (B, Lk, H, D) -> (B, Lq, H, D): for bf16 inputs the
    body of ``attention_route`` (gen3c_attention_wgmma_fwd or
    gen3c_attention_bf16), gen3c_attention_f32 (3xTF32) for fp32 inputs.

    band=(hw, window, prefix) restricts each query to its temporal band
    (K3); the kernel then visits only the key tiles the band reaches. It
    needs every query row to see at least one key. visited, a one-element
    int64 CUDA tensor, receives the number of key tiles a band call visits.
    """
    B, Lq, Lk, H, D = _check_qkv(q, k, v)
    band_arg = _band_arg(band, Lq, Lk)
    visited_ptr = _visited_ptr(visited, 1)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    route = attention_route(q, k, v)
    if route == "wgmma":
        _wgmma_fwd(q, k, v, out, None, band_arg, 0, 0, visited_ptr)
        _count_route(route)
        return out
    strides = (ctypes.c_longlong * 9)(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
    )
    scale = 1.0 / math.sqrt(D)
    lib = library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
            B, Lq, Lk, H, D, scale, band_arg, visited_ptr)
    vec = rows_of_16_bytes(q, k, v)
    if q.dtype == torch.bfloat16:
        _check(lib.gen3c_attention_bf16(*args, int(vec), _stream(q)), "attention_bf16")
        _count_route(route)
    else:
        _check(lib.gen3c_attention_f32(*args, int(vec), _stream(q)), "attention_f32")
    return out


def rows_of_16_bytes(*tensors: torch.Tensor) -> bool:
    """Whether the attention.cu / attention_f32.cu kernels may copy every
    row of these (B, L, H, D) tensors in 16-byte pieces (their `vec`): each
    row starts 16-byte aligned and holds whole 16-byte pieces."""
    per_piece = 16 // tensors[0].element_size()
    return tensors[0].shape[3] % per_piece == 0 and all(
        t.data_ptr() % 16 == 0 and all(s % per_piece == 0 for s in t.stride()[:3])
        for t in tensors)


def f32_smem_bytes(d: int) -> int:
    """The dynamic shared memory attention_f32.cu's kernel asks for at head
    dim d (its DP: 32, 64 or 128)."""
    return library().gen3c_attention_f32_smem(32 if d <= 32 else 64 if d <= 64 else 128)


# ---------------------------------- P2 -----------------------------------
#
# P2, K1's sweep, runs K1's own forward (attention_wgmma.cu's attn_fwd_wgmma)
# compiled at a point of the Hopper counterparts of splash's block sizes:
# (consumer warpgroups, keys per tile, ring stages); 64 queries a warpgroup.
# K1's point is the library's own forward; every other point is that source's
# forward built apart with -D overrides (build.forward_only), loaded once a
# process. The source is the truth: each library, K1's included, is checked
# on loading against the point asked for (its exported shape, register split
# and shared memory), so that the Python copies below (the -D values, the
# shared-memory formula that filters the points before any build) cannot
# drift from it.

K1_POINT = (2, 64, 4)
SMEM_LIMIT = 232_448  # dynamic shared memory one CTA may use on an H100
FWD_REGS = {2: (40, 232), 3: (24, 160)}  # setmaxnreg split (producer, consumers)
_forward_variants: dict = {}


def fwd_point_defines(point: Tuple[int, int, int]) -> Tuple[str, ...]:
    """The nvcc -D flags that build attention_wgmma.cu's forward at point;
    none for K1's own."""
    if tuple(point) == K1_POINT:
        return ()
    warpgroups, block_n, stages = point
    producer, consumer = FWD_REGS[warpgroups]
    return (f"-DGEN3C_FWD_WARPGROUPS={warpgroups}", f"-DGEN3C_FWD_BLOCK_N={block_n}",
            f"-DGEN3C_FWD_STAGES={stages}", f"-DGEN3C_FWD_PRODUCER_REGS={producer}",
            f"-DGEN3C_FWD_CONSUMER_REGS={consumer}")


def fwd_point_smem_bytes(point: Tuple[int, int, int], d: int = 128) -> int:
    """attention_wgmma.cu's FwdSmem at point and head dim d (the filter
    before a build; each build's own value is checked against it): 1,024
    bytes of alignment, the Q tile, each stage's K and V tiles (128-byte
    rows a 64-dim half) and the stages' two mbarriers plus Q's."""
    warpgroups, block_n, stages = point
    halves = 1 if d <= 64 else 2
    return (1024 + halves * 64 * warpgroups * 128 + stages * 2 * halves * block_n * 128
            + (1 + 2 * stages) * 8)


def fwd_point_fits(point: Tuple[int, int, int], d: int = 128) -> bool:
    """Whether a CTA at point fits the card: its shared memory, and its
    register split within what ptxas budgets its threads (65,536 registers
    an SM over the CTA's threads, a multiple of 8)."""
    warpgroups = point[0]
    threads = 128 * (warpgroups + 1)
    producer, consumer = FWD_REGS[warpgroups]
    budget = 65536 // threads // 8 * 8
    return (fwd_point_smem_bytes(point, d) <= SMEM_LIMIT
            and 128 * producer + 128 * warpgroups * consumer <= threads * budget)


def _check_point(lib: ctypes.CDLL, point: Tuple[int, int, int]) -> None:
    """Raise unless lib's forward was built at point: its exported
    (warpgroups, keys a tile, stages, producer and consumer registers) and
    its shared memory at D 64 and 128 against what this module asked for."""
    shape, smem64, smem128 = (_I * 5)(), (_I * 3)(), (_I * 3)()
    lib.gen3c_attention_wgmma_fwd_point(shape)
    lib.gen3c_attention_wgmma_smem(64, smem64)
    lib.gen3c_attention_wgmma_smem(128, smem128)
    got = (tuple(shape), smem64[0], smem128[0])
    want = ((*point, *FWD_REGS[point[0]]), fwd_point_smem_bytes(point, 64),
            fwd_point_smem_bytes(point, 128))
    if got != want:
        raise RuntimeError(f"attention_wgmma.cu's forward built for {point} reports (shape, "
                           f"smem D 64, smem D 128) {got}; cuda.py expects {want}")


def forward_variant(point: Tuple[int, int, int]) -> ctypes.CDLL:
    """The library whose gen3c_attention_wgmma_fwd is K1's forward at
    point: the kernel library itself at K1's point, else the forward built
    apart (first use); checked against point on loading."""
    point = tuple(point)
    defines = fwd_point_defines(point)
    lib = None if defines else library()
    with _lock:
        if point not in _forward_variants:
            if defines:
                lib = ctypes.CDLL(_build.build(**_build.forward_only(defines))["path"])
                _fwd_argtypes(lib)
            _check_point(lib, point)
            _forward_variants[point] = lib
        return _forward_variants[point]


def attention_point(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    point: Tuple[int, int, int]) -> torch.Tensor:
    """P2: gen3c_attention_wgmma_fwd (no band, no lse) built at point, on
    bf16 inputs a TMA tensor map describes; at K1's point, K1's call."""
    B, Lq, Lk, H, D = _check_qkv(q, k, v)
    if attention_route(q, k, v) != "wgmma":
        raise ValueError("attention point: bf16 q, k, v that a TMA tensor map describes only")
    if not fwd_point_fits(point, D):
        raise ValueError(f"attention point {point} does not fit a CTA")
    lib = forward_variant(point)
    out = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    words = _map_words(zip((q, k, v), _box_rows(lib)[0]))
    _check(lib.gen3c_attention_wgmma_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), words, out.data_ptr(), None, B, Lq, Lk, H, D,
        1.0 / math.sqrt(D), None, 0, 0, None, _stream(q)), "attention_wgmma_fwd")
    return out


def ray_triangle_setup_and_bounds(v0: torch.Tensor, v1: torch.Tensor, v2: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6's per-mesh inputs, formed by its setup kernel (one launch): the
    (T, 13) rows of ``reference.ray_triangle_setup``, their (T, 4) culling
    rectangles and the (ceil(T / 32), 4) chunk rectangles, the bits of
    ``reference.ray_triangle_bounds`` and ``ray_chunk_bounds``. v0/v1/v2
    (T, 3) fp32 on one card, T > 0."""
    T = v0.shape[0]
    dev = v0.device
    tris = torch.empty((T, 13), dtype=torch.float32, device=dev)
    boxes = torch.empty((T, 4), dtype=torch.float32, device=dev)
    chunks = torch.empty((-(-T // 32), 4), dtype=torch.float32, device=dev)
    v0, v1, v2 = (v.contiguous() for v in (v0, v1, v2))
    _check(library().gen3c_ray_triangle_prepare(v0.data_ptr(), v1.data_ptr(), v2.data_ptr(), T,
                                                tris.data_ptr(), boxes.data_ptr(),
                                                chunks.data_ptr(), _stream(v0)),
           "ray_triangle_prepare")
    return tris, boxes, chunks


def ray_triangle_depth(rays: torch.Tensor, v0: torch.Tensor, v1: torch.Tensor,
                       v2: torch.Tensor) -> torch.Tensor:
    """K6: the nearest hit distance per ray, (R,) fp32, 0.0 where none.
    rays (R, 3) and v0/v1/v2 (T, 3) fp32 on one CUDA device, R and T > 0.
    Two launches: the setup kernel (``ray_triangle_setup_and_bounds``),
    once per mesh, then the culled hit kernel (``ray_triangle_hits``)."""
    tensors = {"rays": rays, "v0": v0, "v1": v1, "v2": v2}
    for name, t in tensors.items():
        if not t.is_cuda or t.device != rays.device:
            raise ValueError(f"ray-triangle kernel: {name} must be on {rays.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"ray-triangle kernel takes fp32, {name} is {t.dtype}")
        if t.ndim != 2 or t.shape[1] != 3:
            raise ValueError(f"ray-triangle kernel: {name} has shape {tuple(t.shape)}, not (n, 3)")
    R, T = rays.shape[0], v0.shape[0]
    if v1.shape[0] != T or v2.shape[0] != T or R == 0 or T == 0 or R >= 2 ** 31:
        raise ValueError(f"ray-triangle kernel: bad counts R={R}, T={T}/{v1.shape[0]}/{v2.shape[0]}")
    return ray_triangle_hits(rays, *ray_triangle_setup_and_bounds(v0, v1, v2))


def ray_triangle_hits(rays: torch.Tensor, tris: torch.Tensor, boxes: torch.Tensor,
                      chunks: torch.Tensor) -> torch.Tensor:
    """gen3c_ray_triangle_depth: K6's hit kernel on the per-mesh inputs of
    ``ray_triangle_setup_and_bounds``, which culls the triangles per tile of
    256 consecutive rays. ``ray_triangle_depth`` has checked the shapes."""
    rays = rays.contiguous()
    out = torch.empty(rays.shape[0], dtype=torch.float32, device=rays.device)
    _check(library().gen3c_ray_triangle_depth(rays.data_ptr(), tris.data_ptr(), boxes.data_ptr(),
                                              chunks.data_ptr(), rays.shape[0], tris.shape[0],
                                              out.data_ptr(), _stream(rays)),
           "ray_triangle_depth")
    return out


def _training_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """``_check_qkv`` for the training kernels (``attention_bwd.cu``), which
    also need non-empty sequences and contiguous tensors: returns the three
    made contiguous, (B, Lq, Lk, H, D) and the bf16 and vec flags."""
    B, Lq, Lk, H, D = _check_qkv(q, k, v)
    if Lq == 0 or Lk == 0 or B == 0 or H == 0:
        raise ValueError(f"attention kernel: empty shapes {tuple(q.shape)} {tuple(k.shape)}")
    q, k, v = (t.contiguous() for t in (q, k, v))
    bf16 = q.dtype == torch.bfloat16
    vec = bf16 and D % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    return (q, k, v), (B, Lq, Lk, H, D), bf16, vec


def attention_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      band: Optional[Tuple[int, int, int]] = None,
                      visited: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """gen3c_attention_fwd_lse: attention's output (B, Lq, H, D) and the fp32
    row logsumexp of the scaled logits (B, H, Lq), the forward that K4's
    backward needs. Contiguous copies are made of strided inputs. band as
    ``attention`` (the band forward of K4-band, K3's output bit for bit);
    visited, one int64 on the card, receives a bf16 band call's key tiles."""
    (q, k, v), (B, Lq, Lk, H, D), bf16, vec = _training_layout(q, k, v)
    band_arg = _band_arg(band, Lq, Lk)
    visited_ptr = _visited_ptr(visited, 1)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    route = attention_route(q, k, v)
    if route == "wgmma":
        _wgmma_fwd(q, k, v, out, lse, band_arg, 0, 0, visited_ptr)
        _count_route(route)
        return out, lse
    _count_route(route)
    _check(library().gen3c_attention_fwd_lse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B, Lq, Lk, H, D, 1.0 / math.sqrt(D), int(bf16), int(vec), band_arg, visited_ptr,
        _stream(q)), "attention_fwd_lse")
    return out, lse


def attention_ring_fold(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        band: Optional[Tuple[int, int, int]] = None, q_off: int = 0,
                        k_off: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """gen3c_attention_ring_fold (K1ring): one ring-attention step, the
    output (B, Lq, H, D) and fp32 row logsumexp (B, H, Lq) of the queries
    (global positions q_off + i) over one KV shard (k_off + j). Under a band
    a row may see no key of the shard: its output is 0 and its lse -inf.
    Contiguous copies are made of strided inputs."""
    (q, k, v), (B, Lq, Lk, H, D), bf16, vec = _training_layout(q, k, v)
    if q_off < 0 or k_off < 0:
        raise ValueError(f"ring fold: offsets must be >= 0, got {q_off}, {k_off}")
    band_arg = None
    if band is not None:
        hw, window, prefix = (int(x) for x in band)
        if hw <= 0 or window < 0 or prefix < 0:
            raise ValueError(f"ring fold: bad band {band}")
        band_arg = (_I * 3)(hw, window, prefix)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    route = attention_route(q, k, v)
    if route == "wgmma":
        _wgmma_fwd(q, k, v, out, lse, band_arg, q_off, k_off, None)
        _count_route(route)
        return out, lse
    _count_route(route)
    _check(library().gen3c_attention_ring_fold(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B, Lq, Lk, H, D, 1.0 / math.sqrt(D), int(bf16), int(vec), band_arg, int(q_off),
        int(k_off), _stream(q)), "attention_ring_fold")
    return out, lse


def attention_merge(acc: torch.Tensor, acc_lse: torch.Tensor, out: Optional[torch.Tensor],
                    lse: Optional[torch.Tensor],
                    final_dtype: Optional[torch.dtype] = None) -> Optional[torch.Tensor]:
    """gen3c_attention_merge (K1merge): fold one ring step's (out, lse) into
    the running fp32 state (acc (B, L, H, D), acc_lse (B, H, L)), in place;
    or, with final_dtype (bf16 or fp32), return the merged result in that
    dtype and leave the state as it was. out = lse = None folds nothing
    (then final_dtype is required)."""
    if not (acc.is_cuda and acc_lse.device == acc.device) or acc.dtype != torch.float32 \
            or acc_lse.dtype != torch.float32 or acc.ndim != 4:
        raise ValueError("merge kernel: acc and acc_lse must be fp32 on one CUDA device")
    B, L, H, D = acc.shape
    if acc_lse.shape != (B, H, L) or not (acc.is_contiguous() and acc_lse.is_contiguous()):
        raise ValueError(f"merge kernel: acc {tuple(acc.shape)} and acc_lse "
                         f"{tuple(acc_lse.shape)} must be contiguous (B, L, H, D), (B, H, L)")
    if (out is None) != (lse is None) or (out is None and final_dtype is None):
        raise ValueError("merge kernel: give out and lse together, or final_dtype alone")
    if final_dtype not in (None, torch.bfloat16, torch.float32):
        raise TypeError(f"merge kernel writes bf16 or fp32, not {final_dtype}")
    if out is not None:
        if out.shape != acc.shape or out.device != acc.device \
                or out.dtype not in (torch.bfloat16, torch.float32) \
                or lse.shape != acc_lse.shape or lse.dtype != torch.float32 \
                or lse.device != acc.device:
            raise ValueError(f"merge kernel: step out {tuple(out.shape)} {out.dtype} and lse "
                             f"{tuple(lse.shape)} {lse.dtype} do not match the state")
        out, lse = out.contiguous(), lse.contiguous()
    final = None if final_dtype is None else torch.empty(acc.shape, dtype=final_dtype,
                                                        device=acc.device)
    _check(library().gen3c_attention_merge(
        acc.data_ptr(), acc_lse.data_ptr(), None if out is None else out.data_ptr(),
        None if lse is None else lse.data_ptr(), None if final is None else final.data_ptr(),
        B, L, H, D, int(out is not None and out.dtype == torch.bfloat16),
        int(final_dtype == torch.bfloat16), _stream(acc)), "attention_merge")
    return final


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                  dout: torch.Tensor, lse: torch.Tensor,
                  band: Optional[Tuple[int, int, int]] = None,
                  visited: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """gen3c_attention_bwd (K4; K4-band with a band): (dq, dk, dv) like (q,
    k, v) from the forward's out and lse and the upstream gradient dout
    (like out). visited, two int64 on the card, receives a bf16 band
    call's visited tiles: [0] the 32-query tiles of its dK/dV kernel, [1]
    the 64-key tiles of its dQ kernel."""
    (q, k, v), (B, Lq, Lk, H, D), bf16, vec = _training_layout(q, k, v)
    band_arg = _band_arg(band, Lq, Lk)
    visited_ptr = _visited_ptr(visited, 2)
    if out.shape != q.shape or dout.shape != q.shape or out.dtype != q.dtype \
            or dout.dtype != q.dtype or out.device != q.device or dout.device != q.device:
        raise ValueError(f"attention backward: out {tuple(out.shape)} {out.dtype} and dout "
                         f"{tuple(dout.shape)} {dout.dtype} must match q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (B, H, Lq) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"attention backward: lse {tuple(lse.shape)} {lse.dtype}, "
                         f"expected ({B}, {H}, {Lq}) fp32")
    out, dout, lse = out.contiguous(), dout.contiguous(), lse.contiguous()
    vec = vec and out.data_ptr() % 16 == 0 and dout.data_ptr() % 16 == 0
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    route = attention_route(q, k, v, out, dout)
    if route == "wgmma":
        words = _map_words(zip((q, k, v, dout) * 2, WGMMA_BWD_BOX_ROWS))
        _check(library().gen3c_attention_wgmma_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), words,
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, Lq, Lk, H, D, 1.0 / math.sqrt(D), band_arg, visited_ptr, _stream(q)),
            "attention_wgmma_bwd")
        _count_route(route)
        return dq, dk, dv
    _count_route(route)
    _check(library().gen3c_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, Lq, Lk, H, D, 1.0 / math.sqrt(D), int(bf16), int(vec), band_arg, visited_ptr,
        _stream(q)), "attention_bwd")
    return dq, dk, dv


def quantize_rows(x: torch.Tensor, absmax: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """gen3c_quant_rows (K7q): x (M, K) bf16/fp32 -> (int8 codes (M, K),
    fp32 scales (M,)), one pass over each row (rows over 64 KiB: two); rows
    of any stride and alignment. absmax (M,) fp32: the rows' absmax taken
    elsewhere (``row_absmax`` over every rank's slice of the rows)."""
    x = _quant_input(x)
    M, K = x.shape
    if absmax is not None and (not absmax.is_cuda or absmax.dtype != torch.float32
                               or absmax.shape != (M,)):
        raise ValueError(f"quant kernel: absmax must be fp32 ({M},) on the card, got "
                         f"{absmax.dtype} {tuple(absmax.shape)} on {absmax.device}")
    codes = torch.empty((M, K), dtype=torch.int8, device=x.device)
    scale = torch.empty((M,), dtype=torch.float32, device=x.device)
    absmax = None if absmax is None else absmax.contiguous()
    _check(library().gen3c_quant_rows(x.data_ptr(), x.stride(0), M, K,
                                      int(x.dtype == torch.bfloat16), codes.data_ptr(),
                                      scale.data_ptr(),
                                      None if absmax is None else absmax.data_ptr(), None,
                                      _stream(x)), "quant_rows")
    return codes, scale


def row_absmax(x: torch.Tensor) -> torch.Tensor:
    """K7q's row-absmax pass: max |x| of each row of x (M, K) bf16/fp32,
    fp32 (M,); nothing else is written."""
    x = _quant_input(x)
    M, K = x.shape
    amax = torch.empty((M,), dtype=torch.float32, device=x.device)
    _check(library().gen3c_quant_rows(x.data_ptr(), x.stride(0), M, K,
                                      int(x.dtype == torch.bfloat16), None, None, None,
                                      amax.data_ptr(), _stream(x)), "quant_rows")
    return amax


def _quant_input(x: torch.Tensor) -> torch.Tensor:
    if not x.is_cuda or x.ndim != 2:
        raise ValueError(f"quant kernel takes a 2-D CUDA tensor, got {x.device} {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"quant kernel takes bf16 or fp32, got {x.dtype}")
    if 0 in x.shape:
        raise ValueError(f"quant kernel: empty input {tuple(x.shape)}")
    if x.stride(1) != 1 or x.stride(0) < x.shape[1]:
        x = x.contiguous()
    return x


# ---------------------------------- K7 -----------------------------------
#
# K7 (w8a8.cu's w8a8_gemm_wgmma) reads both operands through 2-d TMA tensor
# maps. An operand no map describes (an unaligned base, a row stride off 16
# bytes, as in contiguous codes whose K is not a multiple of 16) is first
# copied into rows of K rounded up to 16 bytes: the map's K stays the true
# K, so TMA zero-fills the pad whatever it holds, and the sums are the same.

W8A8_BOX_BYTES = 128  # bytes of K per box: one 128-byte swizzle row
# Box rows of w8a8.cu's maps (gen3c_w8a8_box_rows, checked when the library
# loads): the activation codes, then the weight codes.
W8A8_BOX_ROWS = (128, 256)


def _w8a8_describable(t: torch.Tensor) -> bool:
    """A 2-d int8 operand a 2-d TMA map takes: unit stride along K, a
    16-byte aligned base, and a positive 16-byte multiple as its row stride
    (bytes) where it has more than one row."""
    if t.dtype != torch.int8 or t.ndim != 2 or t.stride(1) != 1 or t.data_ptr() % 16:
        return False
    return t.shape[0] == 1 or (t.stride(0) > 0 and t.stride(0) % 16 == 0)


def w8a8_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` (rows, K) int8 itself where a tensor map describes it, else a
    copy in rows of K rounded up to 16 bytes (the pad left unwritten)."""
    if _w8a8_describable(t):
        return t
    rows, K = t.shape
    return torch.empty((rows, -(-K // 16) * 16), dtype=torch.int8, device=t.device)[:, :K].copy_(t)


def w8a8_map_params(t: torch.Tensor, box_rows: int) -> dict:
    """The 2-d tiled tensor map of a ``_w8a8_describable`` (rows, K) int8
    operand for boxes of ``W8A8_BOX_BYTES`` of K by ``box_rows`` rows, in the
    words cuTensorMapEncodeTiled takes: dims (K first), the row stride in
    bytes (a single row: K rounded up to 16), the box and the swizzle."""
    if not _w8a8_describable(t):
        raise ValueError(f"no tensor map for {t.dtype} {tuple(t.shape)} strides {t.stride()}")
    rows, K = t.shape
    stride = t.stride(0) if rows > 1 else -(-K // 16) * 16
    return {"dims": [K, rows], "strides": [stride], "box": [W8A8_BOX_BYTES, box_rows],
            "swizzle": TMA_SWIZZLE}


def _w8a8_words(xq: torch.Tensor, wq: torch.Tensor) -> ctypes.Array:
    """The words gen3c_w8a8_gemm_wgmma takes: per operand dims[2], the
    stride, box[2], swizzle (w8a8.cu's make_gemm_map)."""
    words = []
    for t, rows in zip((xq, wq), W8A8_BOX_ROWS):
        m = w8a8_map_params(t, rows)
        words += m["dims"] + m["strides"] + m["box"] + [m["swizzle"]]
    return (ctypes.c_longlong * len(words))(*words)


_EPI = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}


def int8_gemm(xq: torch.Tensor, wq: torch.Tensor, xscale: Optional[torch.Tensor],
              wscale: Optional[torch.Tensor], out_dtype: torch.dtype) -> torch.Tensor:
    """K7 (gen3c_w8a8_gemm_wgmma): int8 xq (M, K) x int8 wq (N, K)^T -> (M, N),
    each operand as ``w8a8_operand`` lays it out.

    out_dtype int32 returns the raw accumulators (scales unused); fp32 or
    bf16 returns (acc * xscale[m]) * wscale[n] in that dtype.
    """
    if out_dtype not in _EPI:
        raise TypeError(f"int8 GEMM writes int32, fp32 or bf16, not {out_dtype}")
    if not (xq.is_cuda and wq.device == xq.device) or xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError("int8 GEMM: xq and wq must be int8 on one CUDA device")
    if xq.ndim != 2 or wq.ndim != 2 or xq.shape[1] != wq.shape[1] or 0 in xq.shape + wq.shape:
        raise ValueError(f"int8 GEMM: bad shapes {tuple(xq.shape)} x {tuple(wq.shape)}")
    M, K = xq.shape
    N = wq.shape[0]
    xq, wq = w8a8_operand(xq), w8a8_operand(wq)
    scales = (xscale, wscale)
    if out_dtype != torch.int32:
        if any(s is None or not s.is_cuda or s.dtype != torch.float32 for s in scales):
            raise ValueError("int8 GEMM: xscale and wscale must be fp32 CUDA tensors")
        if xscale.shape != (M,) or wscale.shape != (N,):
            raise ValueError(f"int8 GEMM: scales {tuple(xscale.shape)} {tuple(wscale.shape)} "
                             f"for M={M} N={N}")
        xscale, wscale = xscale.contiguous(), wscale.contiguous()
    out = torch.empty((M, N), dtype=out_dtype, device=xq.device)
    xs_ptr = None if xscale is None else xscale.data_ptr()
    ws_ptr = None if wscale is None else wscale.data_ptr()
    _check(library().gen3c_w8a8_gemm_wgmma(
        xq.data_ptr(), wq.data_ptr(), _w8a8_words(xq, wq), xs_ptr, ws_ptr, out.data_ptr(),
        M, N, K, _EPI[out_dtype], _stream(xq)), "w8a8_gemm_wgmma")
    return out


def splat(
    frame: torch.Tensor,
    mask: Optional[torch.Tensor],
    depth: torch.Tensor,
    flow: torch.Tensor,
    flow_mask: Optional[torch.Tensor],
    is_image: bool = False,
    depth_weight_scale: float = 50.0,
    group: Optional[int] = None,
    counts: Optional[torch.Tensor] = None,
    part_ms: Optional[list] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """gen3c_splat (K5): (warped (b, c, h, w), mask2 (b, 1, h, w)) fp32 in
    one call of three kernels (prepare, accumulate, finish; see splat.cu).
    ``group`` consecutive batch entries share a log-depth maximum (default:
    all). For measurement only: ``counts`` (2,) int32 on the card gets the
    corners added by atomics and the corners merged added; a ``part_ms``
    list gets the three kernels' ms (the call then waits for them)."""
    b, c, h, w = frame.shape
    group = b if group is None else group
    if group <= 0 or b % group:
        raise ValueError(f"group={group} must divide the batch {b}")
    expect = {
        "frame": (frame, (b, c, h, w)), "mask": (mask, (b, 1, h, w)),
        "depth": (depth, (b, 1, h, w)), "flow": (flow, (b, 2, h, w)),
        "flow_mask": (flow_mask, (b, 1, h, w)),
    }
    ready = {}
    for name, (t, shape) in expect.items():
        if t is None:
            ready[name] = None
            continue
        if t.device != frame.device or not t.is_cuda:
            raise ValueError(f"splat kernel: {name} must be on {frame.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"splat kernel takes fp32, {name} is {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"splat kernel: {name} has shape {tuple(t.shape)}, expected {shape}")
        ready[name] = t.contiguous()
    if counts is not None and (counts.dtype != torch.int32 or counts.numel() != 2
                               or counts.device != frame.device):
        raise ValueError("splat kernel: counts must be 2 int32 on the frame's device")
    dev = frame.device
    acc = torch.empty((b, (h + 2) * (w + 2), c + 1), dtype=torch.float32, device=dev)
    if acc.data_ptr() % 16:  # the vector atomics' rows; the caching allocator aligns to 512
        raise RuntimeError("splat kernel: accumulator not 16-byte aligned")
    max_bits = torch.empty(b // group, dtype=torch.int32, device=dev)
    out = torch.empty((b, c, h, w), dtype=torch.float32, device=dev)
    known = torch.empty((b, 1, h, w), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    ms = (ctypes.c_float * 3)() if part_ms is not None else None
    rc = library().gen3c_splat(
        ptr(ready["frame"]), ptr(ready["mask"]), ptr(ready["depth"]), ptr(ready["flow"]),
        ptr(ready["flow_mask"]), acc.data_ptr(), max_bits.data_ptr(), out.data_ptr(),
        known.data_ptr(), b, c, h, w, group, float(depth_weight_scale), int(is_image),
        ptr(counts), ms, _stream(frame),
    )
    _check(rc, "splat")
    if part_ms is not None:
        part_ms.extend(float(x) for x in ms)
    return out, known


# P1's instruction forms by operand dtype: (the instruction's N, A from
# registers). "ss": both operands in shared memory, "rs": A in registers.
MMA_PROBE_FORMS = {
    "bf16": {"ss64": (64, False), "ss128": (128, False), "ss256": (256, False),
             "rs128": (128, True)},
    "int8": {"ss128": (128, False), "ss256": (256, False)},
}
MMA_PROBE_ROWS = 128  # rows of A a unit: two warpgroups of 64
MMA_PROBE_SMEM_LIMIT = 232448  # a CTA's shared memory
MMA_PROBE_ONE_CTA = 120 * 1024  # the least a CTA asks for: one CTA an SM
MMA_PROBE_RS_MAX_STEPS = 8  # k steps of A and A + 1 a thread holds in registers
MMA_PROBE_WAVES_MAX = 4  # the most units the slice search looks at, in waves


def _probe_dtype(dtype) -> str:
    names = {torch.bfloat16: "bf16", torch.int8: "int8", "bf16": "bf16", "int8": "int8"}
    if dtype not in names:
        raise TypeError(f"mma probe takes bf16 or int8, got {dtype}")
    return names[dtype]


def mma_probe_form(n: int, dtype) -> str:
    """The headline form at N columns: the widest instruction the N tile
    allows (n256 above 128 columns, n128 above 64, else n64; int8 has no
    n64 form)."""
    if n > 128:
        return "ss256"
    return "ss64" if n <= 64 and _probe_dtype(dtype) == "bf16" else "ss128"


@dataclass(frozen=True)
class MmaProbePlan:
    """How ``mma_probe`` cuts its work (``csrc/mma_probe.cu`` recomputes it
    and refuses a launch whose plan differs). A unit is (an M tile of
    ``rows``, an N tile of the instruction's ``ni`` columns, a K chunk of
    ``chunk_steps`` k steps of 32 bytes, a slice of the R passes); one CTA
    a unit, ``grid`` of them, each writing a partial of ``scratch``
    accumulators that a second kernel sums."""

    M: int
    N: int
    K: int
    reps: int
    dtype: str
    form: str
    ni: int
    rs: bool
    rows: int
    m_tiles: int
    n_tiles: int
    steps: int  # k steps of 32 bytes along K
    chunk_steps: int
    chunks: int
    slices: int
    smem: int
    grid: int
    scratch: int  # accumulators (4 bytes each)

    def words(self) -> Tuple[int, ...]:
        """What the C entry checks, in its order."""
        return (self.chunk_steps, self.chunks, self.slices, self.smem, self.grid, self.scratch)

    def unit(self, u: int) -> dict:
        """Unit u's tiles: rows m0.., columns n0.., K elements k0 .. k0 +
        k_len, passes r0 .. r1 (the kernel's decoding of blockIdx.x)."""
        nt, u = u % self.n_tiles, u // self.n_tiles
        mt, u = u % self.m_tiles, u // self.m_tiles
        chunk, slice_ = u % self.chunks, u // self.chunks
        per_step = 32 // (2 if self.dtype == "bf16" else 1)
        steps = min(self.chunk_steps, self.steps - chunk * self.chunk_steps)
        return {"m0": mt * self.rows, "n0": nt * self.ni, "chunk": chunk, "slice": slice_,
                "k0": chunk * self.chunk_steps * per_step, "k_len": steps * per_step,
                "r0": slice_ * self.reps // self.slices,
                "r1": (slice_ + 1) * self.reps // self.slices}


@functools.lru_cache(maxsize=256)
def mma_probe_plan(M: int, N: int, K: int, reps: int, dtype, form: str,
                   sms: int) -> MmaProbePlan:
    """P1's work units on a card of ``sms`` SMs (runs on the CPU). A K chunk
    holds as many k steps as fit A, A + 1 and B^T in shared memory (SS) or
    A and A + 1 in registers (RS), in chunks as even as the steps allow; R
    is cut into slices, never more than the passes: of the counts from the
    fewest whose units reach the SM count up to ``MMA_PROBE_WAVES_MAX``
    waves, the fewest whose units fill their waves of one CTA an SM best
    (whole waves where a count gives them)."""
    name = _probe_dtype(dtype)
    if form not in MMA_PROBE_FORMS[name]:
        raise ValueError(f"mma probe: no {form!r} form in {name} "
                         f"(forms: {sorted(MMA_PROBE_FORMS[name])})")
    if K % 32 or K <= 0 or M <= 0 or N <= 0 or reps < 0 or sms <= 0:
        raise ValueError(f"mma probe takes K % 32 == 0 and positive M, N, K (got M={M} K={K} "
                         f"N={N}), reps >= 0 (got {reps})")
    ni, rs = MMA_PROBE_FORMS[name][form]
    rows = MMA_PROBE_ROWS
    steps = K * (2 if name == "bf16" else 1) // 32
    m_tiles, n_tiles = -(-M // rows), -(-N // ni)
    max_steps = (MMA_PROBE_RS_MAX_STEPS if rs
                 else 4 * ((MMA_PROBE_SMEM_LIMIT - 1024) // ((2 * rows + ni) * 128)))
    chunks = -(-steps // max_steps)
    chunk_steps = -(-steps // chunks)
    nbytes = ni * chunk_steps * 32 if rs else (2 * rows + ni) * 128 * -(-chunk_steps // 4)
    smem = max(1024 + nbytes, MMA_PROBE_ONE_CTA)
    base = m_tiles * n_tiles * chunks
    slices = 1
    if reps > 1:
        lo = min(reps, -(-sms // base))
        hi = max(lo, min(reps, MMA_PROBE_WAVES_MAX * sms // base))
        best_units, best_slots = 0, 1  # the best fill so far, units / slots
        for s in range(lo, hi + 1):
            units, slots = base * s, -(-(base * s) // sms) * sms
            if units * best_slots > best_units * slots:
                slices, best_units, best_slots = s, units, slots
    return MmaProbePlan(M=M, N=N, K=K, reps=reps, dtype=name, form=form, ni=ni, rs=rs, rows=rows,
                        m_tiles=m_tiles, n_tiles=n_tiles, steps=steps, chunk_steps=chunk_steps,
                        chunks=chunks, slices=slices, smem=smem, grid=base * slices,
                        scratch=slices * chunks * m_tiles * rows * n_tiles * ni)


def mma_probe(a: torch.Tensor, b: torch.Tensor, reps: int,
              form: Optional[str] = None) -> torch.Tensor:
    """gen3c_mma_probe (P1): sum over i < reps of (a + i % 2) @ b for a (M,
    K) and b (K, N), both bf16 (fp32 out) or both int8 (int32 out), K a
    multiple of 32, issued as ``form`` (``MMA_PROBE_FORMS``; default the
    headline ``mma_probe_form``) over ``mma_probe_plan``'s units: one CTA
    each, its operands resident in shared memory, then a pass that sums the
    units' partials."""
    if not (a.is_cuda and b.device == a.device) or a.dtype != b.dtype:
        raise ValueError("mma probe: a and b must share one CUDA device and dtype")
    name = _probe_dtype(a.dtype)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"mma probe: bad shapes {tuple(a.shape)} x {tuple(b.shape)}")
    (M, K), N = a.shape, b.shape[1]
    form = mma_probe_form(N, name) if form is None else form
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    plan = mma_probe_plan(M, N, K, int(reps), name, form, sms)
    a = _aligned(a.contiguous())
    if plan.rs:  # b as it lies, (K, N): rows padded with zeros to whole 16-byte pieces
        bmat = b.contiguous() if N % 8 == 0 else torch.nn.functional.pad(b, (0, 8 - N % 8))
        bmat, pitch = _aligned(bmat), bmat.shape[1]
    else:  # b^T (N, K), K-major as the A operand
        bmat, pitch = _aligned(b.t().contiguous()), K
    acc = torch.int32 if name == "int8" else torch.float32
    partial = torch.empty(plan.scratch, dtype=acc, device=a.device)
    out = torch.empty((M, N), dtype=acc, device=a.device)
    words = (ctypes.c_longlong * len(plan.words()))(*plan.words())
    with torch.cuda.device(a.device):  # the C entry checks the plan against this device
        rc = library().gen3c_mma_probe(a.data_ptr(), bmat.data_ptr(), partial.data_ptr(),
                                       out.data_ptr(), M, N, K, pitch, int(reps),
                                       int(name == "int8"), plan.ni, int(plan.rs), words,
                                       _stream(a))
    _check(rc, "mma_probe")
    return out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself where its data starts on 16 bytes, else a fresh copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


# ------------------------------ K8: GQA over a KV cache ------------------------------

GQA_DECODE_ROWS = 16  # rows (Lq * rep) of gqa_attention.cu's decode body: one m16 tile
GQA_TILE_KEYS = 64  # keys a stage of gqa_attention.cu's mma bodies
# decode CTAs an SM takes at once, by K/V type: bf16 one (fewer splits to
# merge), int8 codes two (one CTA's stage conversion overlaps the other's
# loads); each SM has room for two rings
GQA_DECODE_CTAS_PER_SM = {False: 1, True: 2}
GQA_PLAN_WORDS = 28  # gqa_attention.cu's kPlanWords
GQA_CACHED_LAUNCHES = 256  # launches kept (shape, layout and stream); then the cache restarts


def gqa_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, int8: bool,
              lse: bool = False) -> str:
    """The body a K8 call runs: "fp32" for fp32 queries (gqa_f32, the CUDA
    cores); for bf16 queries "decode" when Lq * rep <= GQA_DECODE_ROWS
    (gqa_mma's decode: one launch, its key splits merged in it), "wgmma" for
    a longer bf16 query over bf16 K/V that a TMA map describes (the
    attention_wgmma.cu forward in its kGqa mode), else "mma_sync" (gqa_mma's
    prefill: int8 codes, or rows no map describes). The training forward
    (lse=True, ``gqa_attention_fwd_lse``) runs bf16 at every shape on
    "wgmma": its queries and keys are copied into maps' rows (``pad_head``)
    where they are not already, and a short query axis fills the first
    rows of one 128-row tile, the rest zero-filled by TMA and never stored."""
    if q.dtype == torch.float32:
        return "fp32"
    if lse:
        return "wgmma"
    if q.shape[1] * (q.shape[2] // k.shape[2]) <= GQA_DECODE_ROWS:
        return "decode"
    if not int8 and all(tma_describable(t) for t in (q, k, v)):
        return "wgmma"
    return "mma_sync"


def gqa_plan(B: int, Lq: int, Hq: int, Hkv: int, Lk: int, sms: int, int8: bool) -> int:
    """Key splits of a K8 launch with bf16 queries over a cache of capacity
    Lk (int8: codes): a decode (Lq * rep <= GQA_DECODE_ROWS) takes as many
    as the ``sms`` SMs take at once, GQA_DECODE_CTAS_PER_SM[int8] each (one
    more CTA would wait for a second wave) and at most one a GQA_TILE_KEYS
    of the capacity; a prefill takes 1. Never the position, so a decode's
    grid is the same at every step; ``gqa_split_range`` cuts the visible
    keys."""
    if Lq * (Hq // Hkv) > GQA_DECODE_ROWS:
        return 1
    want = GQA_DECODE_CTAS_PER_SM[int8] * sms // (B * Hkv)
    return max(1, min(want, -(-Lk // GQA_TILE_KEYS)))


def gqa_split_range(split: int, splits: int, lo: int, hi: int) -> Tuple[int, int]:
    """The keys [begin, end) that split ``split`` of ``splits`` takes of the
    visible keys [lo, hi) (gqa_attention.cu's arithmetic): runs of
    ceil((hi - lo) / splits) in order, the last ones short or empty."""
    n = max(hi - lo, 0)
    per = -(-n // splits)
    begin = lo + min(split * per, n)
    return begin, min(begin + per, hi)


# ------------------------------ K8bwd's dK/dV grid ------------------------------
#
# The bf16 backward is attention_wgmma.cu's pair in its kGqa mode. Its dK/dV
# kernel takes a CTA per (GQA_BWD_KEYS keys, KV head, batch) and walks that
# tile's units: the rep query heads of the KV head, each over the
# GQA_BWD_QUERIES-query tiles from the first that sees one of its keys.
# Where those CTAs do not fill the SMs, ``gqa_bwd_plan`` splits each tile's
# units over several CTAs, and the kernel's split s takes run s of
# ``gqa_split_range(s, splits, 0, units)``. The functions below are the
# kernel's arithmetic.

GQA_BWD_KEYS = WGMMA_BWD_BOX_ROWS[1]  # keys a dK/dV CTA: its K map's box rows
GQA_BWD_QUERIES = WGMMA_BWD_BOX_ROWS[0]  # queries a dK/dV unit: its Q map's box rows


def gqa_bwd_units(Lq: int, Lk: int, rep: int, causal_offset: Optional[int], kv_start: int,
                  key_tile: int) -> list:
    """The (rep head, query tile) units of the dK/dV CTA of key tile
    ``key_tile`` (keys [GQA_BWD_KEYS key_tile, + GQA_BWD_KEYS) of Lk) in the
    order it walks them, for a batch whose first visible key is kv_start:
    per rep head, the query tiles from the first whose rows see the tile's
    first visible key (every later query sees it too) to the last; none
    when no key of the tile is visible."""
    n0 = key_tile * GQA_BWD_KEYS
    first = max(n0, min(max(kv_start, 0), Lk))
    me = -(-Lq // GQA_BWD_QUERIES)
    if first >= min(n0 + GQA_BWD_KEYS, Lk):
        return []
    mb = 0 if causal_offset is None else min(me, max(0, first - causal_offset) // GQA_BWD_QUERIES)
    return [(r, mt) for r in range(rep) for mt in range(mb, me)]


def gqa_bwd_plan(B: int, Lq: int, Lk: int, Hq: int, Hkv: int,
                 causal_offset: Optional[int], sms: int) -> int:
    """The splits of K8bwd's dK/dV grid: 1 where its key tiles x Hkv x B
    CTAs (one an SM: their shared memory) already fill the ``sms`` SMs,
    else as many as fit the SMs in one wave (sms // CTAs), never more
    than a CTA has units (``gqa_bwd_units`` of the first key tile, which
    every query that sees any key sees)."""
    ctas = -(-Lk // GQA_BWD_KEYS) * Hkv * B
    if ctas >= sms:
        return 1
    units = len(gqa_bwd_units(Lq, Lk, Hq // Hkv, causal_offset, 0, 0))
    return max(1, min(sms // ctas, units))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@dataclass
class _GqaLaunch:
    """What a K8 call of one shape, layout and stream needs beyond its
    pointers: its body, the C entry's words (the plan, or the tensor-map
    words of the wgmma route), and the decode's scratch, kept alive here."""
    route: str
    words: ctypes.Array
    scratch: Tuple[torch.Tensor, ...]
    start_int64: bool  # kv_valid_start may be passed as it is


_gqa_launches: dict = {}


def _gqa_prepare(q, k, v, k_scale, v_scale, kv_valid_start) -> _GqaLaunch:
    """Check a K8 call and build its launch (once a key of ``gqa_attention``)."""
    if not (q.is_cuda and all(t.device == q.device for t in (k, v))):
        raise ValueError("gqa kernel: q, k, v must be on one CUDA device")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"gqa kernel takes bf16 or fp32 queries, got {q.dtype}")
    int8 = k_scale is not None
    if (v_scale is not None) != int8:
        raise ValueError("gqa kernel: give k_scale and v_scale together")
    want = torch.int8 if int8 else q.dtype
    if k.dtype != want or v.dtype != want:
        raise TypeError(f"gqa kernel: k/v must be {want} with {q.dtype} queries"
                        f"{' and scales' if int8 else ''}, got {k.dtype}/{v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"gqa kernel: bad shapes {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    B, Lq, Hq, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hq % Hkv or not 0 < D <= 128 or Lk == 0:
        raise ValueError(f"gqa kernel: q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree "
                         "(Hq % Hkv == 0, d <= 128)")
    scale_strides = [0] * 6
    if int8:
        for t in (k_scale, v_scale):
            if t.shape != (B, Lk, Hkv, 1) or t.dtype != torch.float32 or t.device != q.device:
                raise ValueError(f"gqa kernel: scales must be fp32 {(B, Lk, Hkv, 1)} on the "
                                 f"card, got {tuple(t.shape)} {t.dtype}")
        scale_strides = [*k_scale.stride()[:3], *v_scale.stride()[:3]]
    start_int64 = True
    if kv_valid_start is not None:
        if kv_valid_start.shape != (B,) or kv_valid_start.device != q.device:
            raise ValueError(f"gqa kernel: kv_valid_start must be ({B},) on the card")
        start_int64 = kv_valid_start.dtype == torch.int64 and kv_valid_start.stride(0) == 1
    route = gqa_route(q, k, v, int8)
    if route == "wgmma":
        return _GqaLaunch(route, _map_words(zip((q, k, v), WGMMA_FWD_BOX_ROWS)), (), start_int64)
    splits = 1 if route == "fp32" else gqa_plan(B, Lq, Hq, Hkv, Lk,
                                                 _sm_count(q.device.index or 0), int8)
    scratch = ()
    if splits > 1:  # the splits' (o, lse), o in rows of gqa_attention.cu's DP
        rows, dp = Lq * (Hq // Hkv), 32 if D <= 32 else (64 if D <= 64 else 128)
        scratch = (torch.empty(B * Hkv * splits * rows * dp, dtype=torch.float32, device=q.device),
                   torch.empty(B * Hkv * splits * rows, dtype=torch.float32, device=q.device),
                   torch.zeros(B * Hkv, dtype=torch.int32, device=q.device))
    size = k.element_size()
    vec = (D * size) % 16 == 0 and (k.data_ptr() | v.data_ptr()) % 16 == 0 and all(
        (t.stride(i) * size) % 16 == 0 for t in (k, v) for i in range(3))
    words = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *scale_strides,
             B, Lq, Lk, Hq, Hkv, D, splits, int(q.dtype == torch.bfloat16), int(int8), int(vec),
             *(t.data_ptr() for t in scratch), *([0] * (3 - len(scratch)))]
    return _GqaLaunch(route, (ctypes.c_longlong * GQA_PLAN_WORDS)(*words), scratch, start_int64)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal_offset: Optional[int] = None,
                  kv_valid_start: Optional[torch.Tensor] = None,
                  k_scale: Optional[torch.Tensor] = None,
                  v_scale: Optional[torch.Tensor] = None,
                  lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """gen3c_gqa_attention (K8): q (B, Lq, Hq, d) bf16 or fp32 over k/v (B,
    Lk, Hkv, d) of q's dtype, or int8 codes with fp32 k_scale/v_scale (B,
    Lk, Hkv, 1); read in place (any batch, sequence and head strides, unit
    stride along d) up to the last key a query can see, by ``gqa_route``'s
    body. Returns (B, Lq, Hq, d) in q's dtype.

    The checks, the plan, the words and a decode's scratch (its split
    partials and tickets) are built once for each shape, layout, alignment
    and stream, and a call then costs a dict lookup and the launch. Each
    stream has its own scratch, so calls on concurrent streams never share
    it; calls on one stream run in order.

    lse, a (B, Hq, Lq) fp32 tensor on the card, receives the row logsumexp
    (-inf for a row that sees no key): fp32's training forward
    (``gqa_attention_fwd_lse``, which runs bf16's itself)."""
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        return gqa_attention(*(t.contiguous() for t in (q, k, v)), causal_offset,
                             kv_valid_start, k_scale, v_scale, lse)
    stream = _stream(q)
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    key = (q.shape, q.stride(), q.dtype, q.device, k.shape, k.stride(), k.dtype, k.device,
           v.shape, v.stride(), v.dtype, v.device, qp % 16 == 0, (kp | vp) % 16 == 0, stream,
           None if k_scale is None else (k_scale.shape, k_scale.stride(), k_scale.dtype,
                                         k_scale.device),
           None if v_scale is None else (v_scale.shape, v_scale.stride(), v_scale.dtype,
                                         v_scale.device),
           None if kv_valid_start is None else (kv_valid_start.shape, kv_valid_start.stride(),
                                                kv_valid_start.dtype, kv_valid_start.device))
    launch = _gqa_launches.get(key)
    if launch is None:
        launch = _gqa_prepare(q, k, v, k_scale, v_scale, kv_valid_start)
        if len(_gqa_launches) >= GQA_CACHED_LAUNCHES:
            _gqa_launches.clear()
        _gqa_launches[key] = launch
    causal = -1 if causal_offset is None else int(causal_offset)
    if causal_offset is not None and causal < 0:
        raise ValueError(f"gqa kernel: causal_offset must be >= 0, got {causal_offset}")
    B, Lq, Hq, D = q.shape
    Lk = k.shape[1]
    start = kv_valid_start
    if start is not None and not launch.start_int64:
        start = start.to(torch.int64).contiguous()
    sp = None if start is None else start.data_ptr()
    lp = None
    if lse is not None:
        if launch.route != "fp32":
            raise ValueError(f"gqa kernel: lse here is fp32's; the {launch.route} route's "
                             "forward with lse is gqa_attention_fwd_lse")
        if lse.shape != (B, Hq, Lq) or lse.dtype != torch.float32 or lse.device != q.device \
                or not lse.is_contiguous():
            raise ValueError(f"gqa kernel: lse must be contiguous fp32 {(B, Hq, Lq)} on the card")
        lp = lse.data_ptr()
    out = torch.empty((B, Lq, Hq, D), dtype=q.dtype, device=q.device)
    if launch.route == "wgmma":
        rc = library().gen3c_gqa_attention_wgmma(qp, kp, vp, launch.words, out.data_ptr(), sp, B,
                                                 Lq, Lk, Hq, k.shape[2], D, causal,
                                                 1.0 / math.sqrt(D), lp, stream)
    else:
        rc = library().gen3c_gqa_attention(
            qp, kp, vp, None if k_scale is None else k_scale.data_ptr(),
            None if v_scale is None else v_scale.data_ptr(), sp, out.data_ptr(), launch.words,
            causal, Lk if causal < 0 else min(Lk, causal + Lq), lp, stream)
    _check(rc, "gqa_attention")
    return out


def pad_head(t: torch.Tensor, d: int) -> torch.Tensor:
    """t (..., d0) with its last axis zero-padded to d (t itself when d0 ==
    d), contiguous: K8's bf16 training path runs head widths that are not
    a multiple of 8 on the wgmma bodies, whose TMA rows are 16-byte
    multiples. Zero columns add nothing to a logit q . k or to an output
    row P V, so the kernel's (out, dq, dk, dv) are the unpadded ones in
    their first d0 columns, given the scale of the unpadded width."""
    d0 = t.shape[-1]
    if d0 == d:
        return _aligned(t.contiguous())
    return torch.nn.functional.pad(t, (0, d - d0)).contiguous()


def gqa_train_width(d: int) -> int:
    """The head width K8's bf16 training path runs at: d rounded up to a
    multiple of 8 (``pad_head``)."""
    return -(-d // 8) * 8


def _gqa_train_start(kv_valid_start: Optional[torch.Tensor], B: int,
                     device: torch.device) -> Optional[torch.Tensor]:
    if kv_valid_start is None:
        return None
    if kv_valid_start.shape != (B,) or kv_valid_start.device != device:
        raise ValueError(f"gqa kernel: kv_valid_start must be ({B},) on the card")
    return kv_valid_start.to(torch.int64).contiguous()


def gqa_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal_offset: Optional[int] = None,
                          kv_valid_start: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8's training forward: (out (B, Lq, Hq, d), its fp32 row logsumexp
    (B, Hq, Lq)) of q, k, v, both bf16 or both fp32. bf16 runs at every
    shape on the "wgmma" route (``gqa_route(..., lse=True)``):
    attention_wgmma.cu's kGqa forward with lse over contiguous copies of q,
    k, v whose head axis ``pad_head`` widens to a multiple of 8, with the
    logits scaled by 1/sqrt(d) of the unpadded d and the output sliced back
    to d columns. A short query axis (Lq * rep <= GQA_DECODE_ROWS, a decode
    body's shape) takes the first rows of one 128-row tile. fp32: gqa_f32
    with lse. A row that sees no key gives 0 and -inf. int8 caches are not
    trained; d > 128 raises."""
    B, Lq, Hq, d = q.shape
    lse = torch.empty((B, Hq, Lq), dtype=torch.float32, device=q.device)
    if gqa_route(q, k, v, False, lse=True) == "fp32":
        q, k, v = (t.contiguous() for t in (q, k, v))
        return gqa_attention(q, k, v, causal_offset, kv_valid_start, lse=lse), lse
    if not (q.is_cuda and all(t.device == q.device for t in (k, v))):
        raise ValueError("gqa kernel: q, k, v must be on one CUDA device")
    if k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise TypeError(f"gqa kernel: the bf16 forward with lse takes bf16 k/v (an int8 cache "
                        f"is not trained), got {k.dtype}/{v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != d or Hq % k.shape[2] or not 0 < d <= 128 or k.shape[1] == 0:
        raise ValueError(f"gqa kernel: q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree "
                         "(Hq % Hkv == 0, 0 < d <= 128)")
    if causal_offset is not None and causal_offset < 0:
        raise ValueError(f"gqa kernel: causal_offset must be >= 0, got {causal_offset}")
    dp = gqa_train_width(d)
    qp, kp, vp = (pad_head(t, dp) for t in (q, k, v))
    start = _gqa_train_start(kv_valid_start, B, q.device)
    out = torch.empty((B, Lq, Hq, dp), dtype=q.dtype, device=q.device)
    words = _map_words(zip((qp, kp, vp), WGMMA_FWD_BOX_ROWS))
    _check(library().gen3c_gqa_attention_wgmma(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), words, out.data_ptr(),
        None if start is None else start.data_ptr(), B, Lq, k.shape[1], Hq, k.shape[2], dp,
        -1 if causal_offset is None else int(causal_offset), 1.0 / math.sqrt(d),
        lse.data_ptr(), _stream(q)), "gqa_attention_wgmma")
    return (out if dp == d else out[..., :d]), lse


def gqa_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                      dout: torch.Tensor, lse: torch.Tensor,
                      causal_offset: Optional[int] = None,
                      kv_valid_start: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8bwd: (dq, dk, dv) like (q, k, v) of K8's attention from the
    forward's out and lse (``gqa_attention_fwd_lse``) and the upstream
    gradient dout (like out), dk and dv summed over each KV head's query
    heads in the kernel. bf16, at every shape the forward takes:
    attention_wgmma.cu's backward pair in its kGqa mode
    (gen3c_gqa_attention_wgmma_bwd, TMA + wgmma; the dK/dV grid split by
    ``gqa_bwd_plan``, its fp32 partial sums in a workspace made here),
    counted in ``route_counts["wgmma"]``, over copies of q, k, v, out and
    dout whose head axis ``pad_head`` widens to a multiple of 8 (the logits
    scaled by 1/sqrt(d) of the unpadded d; dq, dk, dv sliced back to d); a
    short query axis covers the first rows of its tiles. fp32:
    gen3c_gqa_attention_bwd (the CUDA cores). Every operand is made
    contiguous, and a bf16 one a TMA map cannot describe (off 16-byte
    alignment) is copied. Raises for anything else (d > 128)."""
    if not (q.is_cuda and all(t.device == q.device for t in (k, v, out, dout, lse))):
        raise ValueError("gqa backward: every tensor must be on one CUDA device")
    if q.dtype not in (torch.bfloat16, torch.float32) or not all(
            t.dtype == q.dtype for t in (k, v, out, dout)):
        raise TypeError(f"gqa backward takes bf16 or fp32 q, k, v, out, dout alike, got "
                        f"{[t.dtype for t in (q, k, v, out, dout)]}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"gqa backward: bad shapes {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    B, Lq, Hq, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hq % Hkv or not 0 < D <= 128 or Lk == 0 or Lq == 0:
        raise ValueError(f"gqa backward: q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree "
                         "(Hq % Hkv == 0, 0 < d <= 128)")
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"gqa backward: out {tuple(out.shape)} and dout {tuple(dout.shape)} "
                         f"must be like q {tuple(q.shape)}")
    if lse.shape != (B, Hq, Lq) or lse.dtype != torch.float32:
        raise ValueError(f"gqa backward: lse {tuple(lse.shape)} {lse.dtype}, expected "
                         f"({B}, {Hq}, {Lq}) fp32")
    if causal_offset is not None and causal_offset < 0:
        raise ValueError(f"gqa backward: causal_offset must be >= 0, got {causal_offset}")
    bf16 = q.dtype == torch.bfloat16
    d = D
    lse = lse.contiguous()
    if bf16:
        D = gqa_train_width(d)
        q, k, v, out, dout = (pad_head(t, D) for t in (q, k, v, out, dout))
    else:
        q, k, v, out, dout = (t.contiguous() for t in (q, k, v, out, dout))
    start = _gqa_train_start(kv_valid_start, B, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, Hq, Lq), dtype=torch.float32, device=q.device)
    causal = -1 if causal_offset is None else int(causal_offset)
    sp = None if start is None else start.data_ptr()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr())
    if not bf16:
        _check(library().gen3c_gqa_attention_bwd(
            *ptrs, lse.data_ptr(), sp, delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, Lq, Lk, Hq, Hkv, D, causal, _stream(q)), "gqa_attention_bwd")
        return dq, dk, dv
    splits = gqa_bwd_plan(B, Lq, Lk, Hq, Hkv, causal_offset, _sm_count(q.device.index or 0))
    ws = None
    if splits > 1:  # the splits' fp32 dK, then dV: (splits, B, Lk, Hkv, D) each
        ws = torch.empty(2 * splits * B * Lk * Hkv * D, dtype=torch.float32, device=q.device)
    words = _map_words(zip((q, k, v, dout) * 2, WGMMA_BWD_BOX_ROWS))
    _check(library().gen3c_gqa_attention_wgmma_bwd(
        *ptrs, words, lse.data_ptr(), sp, delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), None if ws is None else ws.data_ptr(), B, Lq, Lk, Hq, Hkv, D, causal,
        1.0 / math.sqrt(d), splits, _stream(q)), "gqa_attention_wgmma_bwd")
    _count_route("wgmma")
    if D != d:
        dq, dk, dv = (t[..., :d] for t in (dq, dk, dv))
    return dq, dk, dv
