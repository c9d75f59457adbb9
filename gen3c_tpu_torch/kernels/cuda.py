"""ctypes bindings of the compiled kernels (CUDA tensors only).

Each function checks device, dtype, shape and layout, allocates its output
with torch, launches on PyTorch's current stream and raises if the launch
is refused. Nothing here is imported by the CPU path.
"""

from __future__ import annotations

import ctypes
import math
import threading
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
            lib.gen3c_attention_f32.argtypes = attn + [_P]
            lib.gen3c_splat.argtypes = [_P] * 9 + [_I] * 5 + [ctypes.c_float, _I, _P,
                                                              ctypes.POINTER(ctypes.c_float), _P]
            lib.gen3c_quant_rows.argtypes = [_P, _L, _I, _I, _I, _P, _P, _P]
            lib.gen3c_w8a8_gemm_wgmma.argtypes = [_P, _P, ctypes.POINTER(ctypes.c_longlong),
                                                  _P, _P, _P, _I, _I, _I, _I, _P]
            lib.gen3c_w8a8_box_rows.argtypes = [ctypes.POINTER(_I)]
            lib.gen3c_w8a8_box_rows.restype = None
            shape = [_I, _I, _I, _I, _I, ctypes.c_float, _I, _I, ctypes.POINTER(_I), _P, _P]
            lib.gen3c_attention_fwd_lse.argtypes = [_P] * 5 + shape
            lib.gen3c_attention_ring_fold.argtypes = [_P] * 5 + shape[:-2] + [_I, _I, _P]
            lib.gen3c_attention_merge.argtypes = [_P] * 5 + [_I] * 6 + [_P]
            lib.gen3c_attention_bwd.argtypes = [_P] * 10 + shape
            lib.gen3c_mma_probe.argtypes = [_P, _P, _P] + [_I] * 7 + [_P]
            lib.gen3c_attention_bf16_tiles.argtypes = attn[:-2] + [_I, _I, _P]
            lib.gen3c_ray_triangle_depth.argtypes = [_P, _P, _P, _P, _I, _I, _P, _P]
            lib.gen3c_ray_triangle_prepare.argtypes = [_P, _P, _P, _I, _P, _P, _P, _P]
            words = ctypes.POINTER(ctypes.c_longlong)
            band_ptr = ctypes.POINTER(_I)
            lib.gen3c_attention_wgmma_fwd.argtypes = ([_P, _P, _P, words, _P, _P] + [_I] * 5
                                                      + [ctypes.c_float, band_ptr, _I, _I, _P, _P])
            lib.gen3c_attention_wgmma_bwd.argtypes = ([_P] * 5 + [words] + [_P] * 5 + [_I] * 5
                                                      + [ctypes.c_float, band_ptr, _P, _P])
            lib.gen3c_attention_wgmma_box_rows.argtypes = [ctypes.POINTER(_I)] * 2
            lib.gen3c_attention_wgmma_box_rows.restype = None
            lib.gen3c_attention_wgmma_smem.argtypes = [_I, ctypes.POINTER(_I)]
            lib.gen3c_attention_wgmma_smem.restype = None
            for fn in (lib.gen3c_attention_bf16, lib.gen3c_attention_f32, lib.gen3c_splat,
                       lib.gen3c_quant_rows, lib.gen3c_w8a8_gemm_wgmma,
                       lib.gen3c_attention_fwd_lse, lib.gen3c_attention_bwd,
                       lib.gen3c_attention_ring_fold, lib.gen3c_attention_merge,
                       lib.gen3c_mma_probe, lib.gen3c_attention_bf16_tiles,
                       lib.gen3c_ray_triangle_depth, lib.gen3c_ray_triangle_prepare,
                       lib.gen3c_attention_wgmma_fwd,
                       lib.gen3c_attention_wgmma_bwd):
                fn.restype = _I
            fwd_rows, bwd_rows = (_I * 3)(), (_I * 8)()
            lib.gen3c_attention_wgmma_box_rows(fwd_rows, bwd_rows)
            if (tuple(fwd_rows), tuple(bwd_rows)) != (WGMMA_FWD_BOX_ROWS, WGMMA_BWD_BOX_ROWS):
                raise RuntimeError(f"attention_wgmma.cu's box rows {tuple(fwd_rows)} "
                                   f"{tuple(bwd_rows)} differ from cuda.py's")
            w8a8_rows = (_I * 2)()
            lib.gen3c_w8a8_box_rows(w8a8_rows)
            if tuple(w8a8_rows) != W8A8_BOX_ROWS:
                raise RuntimeError(f"w8a8.cu's box rows {tuple(w8a8_rows)} differ from "
                                   f"cuda.py's {W8A8_BOX_ROWS}")
            _lib = lib
        return _lib


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
# (attention.cu / attention_bwd.cu) for the rest. fp32 inputs run the CUDA-core
# kernels and take no route. Each launch of the family adds one to its route's
# count in ``kernels.route_counts``.

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
    (the CUDA-core kernels). The same rule for every entry of the family,
    so at a given shape and layout they all take the same body."""
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
    gen3c_attention_bf16), gen3c_attention_f32 for fp32 inputs.

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
    if q.dtype == torch.bfloat16:
        vec = D % 8 == 0 and all(
            t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])
            for t in (q, k, v)
        )
        _check(lib.gen3c_attention_bf16(*args, int(vec), _stream(q)), "attention_bf16")
        _count_route(route)
    else:
        _check(lib.gen3c_attention_f32(*args, _stream(q)), "attention_f32")
    return out


# P2: the (block_m, block_n) tiles attention.cu instantiates K1's bf16
# forward with (block_m / 16 warps); (64, 64) is K1's own.
TILE_CONFIGS = ((64, 32), (64, 64), (64, 128), (128, 32), (128, 64), (128, 128))
SMEM_LIMIT = 227 * 1024  # shared memory one CTA may use on an H100


def tile_smem_bytes(block_m: int, block_n: int, d: int = 128) -> int:
    """Shared memory of one CTA: the Q tile and the K and V tiles, rows of
    D + 8 bf16 (16 bytes of padding against bank conflicts)."""
    return (block_m + 2 * block_n) * (d + 8) * 2


def attention_tiles(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    block_m: int, block_n: int) -> torch.Tensor:
    """gen3c_attention_bf16_tiles (P2): K1's bf16 forward with a
    (block_m, block_n) tile of ``TILE_CONFIGS``. Head dim 128 only; q, k
    and v in any strides whose rows start 16-byte aligned."""
    if (block_m, block_n) not in TILE_CONFIGS:
        raise ValueError(f"attention tiles: ({block_m}, {block_n}) is not one of {TILE_CONFIGS}")
    B, Lq, Lk, H, D = _check_qkv(q, k, v)
    if q.dtype != torch.bfloat16 or D != 128:
        raise ValueError(f"attention tiles: bf16 with head dim 128 only, got {q.dtype} D={D}")
    if not all(t.stride(-1) == 1 and t.data_ptr() % 16 == 0
               and all(s % 8 == 0 for s in t.stride()[:3]) for t in (q, k, v)):
        raise ValueError("attention tiles: rows must be 16-byte aligned with unit stride along D")
    out = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(*(t.stride(i) for t in (q, k, v) for i in range(3)))
    _check(library().gen3c_attention_bf16_tiles(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides, B, Lq, Lk, H, D,
        1.0 / math.sqrt(D), block_m, block_n, _stream(q)), "attention_bf16_tiles")
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


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """gen3c_quant_rows (K7q): x (M, K) bf16/fp32 -> (int8 codes (M, K),
    fp32 scales (M,)), one pass over each row (rows over 64 KiB: two); rows
    of any stride and alignment."""
    if not x.is_cuda or x.ndim != 2:
        raise ValueError(f"quant kernel takes a 2-D CUDA tensor, got {x.device} {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"quant kernel takes bf16 or fp32, got {x.dtype}")
    M, K = x.shape
    if M == 0 or K == 0:
        raise ValueError(f"quant kernel: empty input {tuple(x.shape)}")
    if x.stride(1) != 1 or x.stride(0) < K:
        x = x.contiguous()
    codes = torch.empty((M, K), dtype=torch.int8, device=x.device)
    scale = torch.empty((M,), dtype=torch.float32, device=x.device)
    _check(library().gen3c_quant_rows(x.data_ptr(), x.stride(0), M, K,
                                      int(x.dtype == torch.bfloat16), codes.data_ptr(),
                                      scale.data_ptr(), _stream(x)), "quant_rows")
    return codes, scale


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


def mma_probe_cols(k: int, element_size: int) -> int:
    """The output columns of a P1 CTA: 64 if its 64 rows of A and 64 of B^T
    (K elements and 16 bytes of padding each) fit in shared memory, else 32."""
    return 64 if (64 + 64) * (k * element_size + 16) <= 227 * 1024 else 32


def mma_probe(a: torch.Tensor, b: torch.Tensor, reps: int,
              ctas_per_sm: int = 1) -> Tuple[torch.Tensor, int]:
    """gen3c_mma_probe (P1): sum over i < reps of (a + i % 2) @ b for a (M,
    K) and b (K, N), both bf16 (fp32 out) or both int8 (int32 out), K a
    multiple of 32 up to 1024. Returns (out, the CTAs launched): at least
    ``ctas_per_sm`` CTAs per SM, each holding a 64-row block of the output
    with its operands in shared memory (``mma_probe_cols`` columns); a
    small output is computed several times over."""
    if not (a.is_cuda and b.device == a.device) or a.dtype != b.dtype:
        raise ValueError("mma probe: a and b must share one CUDA device and dtype")
    if a.dtype not in (torch.bfloat16, torch.int8):
        raise TypeError(f"mma probe takes bf16 or int8, got {a.dtype}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"mma probe: bad shapes {tuple(a.shape)} x {tuple(b.shape)}")
    (M, K), N = a.shape, b.shape[1]
    if K % 32 or not 0 < K <= 1024 or M == 0 or N == 0 or reps < 0 or ctas_per_sm < 1:
        raise ValueError(f"mma probe takes K % 32 == 0, K <= 1024 (got M={M} K={K} N={N}), "
                         f"reps >= 0 (got {reps})")
    int8 = a.dtype == torch.int8
    a, bT = a.contiguous(), b.t().contiguous()
    out = torch.empty((M, N), dtype=torch.int32 if int8 else torch.float32, device=a.device)
    bn = mma_probe_cols(K, a.element_size())
    min_ctas = ctas_per_sm * torch.cuda.get_device_properties(a.device).multi_processor_count
    _check(library().gen3c_mma_probe(a.data_ptr(), bT.data_ptr(), out.data_ptr(), M, N, K,
                                     int(reps), int(int8), bn, min_ctas, _stream(a)), "mma_probe")
    return out, max(-(-M // 64) * -(-N // bn), min_ctas)
