"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips unless CUDA is available (decided inside
the test, never at import). Run on a GPU machine with

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda

Shapes cover what the wrappers promise: bf16 and fp32, head dims from 8 to
128 (zero-padded to the MMA depth), ragged Lq and Lk, strided inputs,
temporal bands whose frames straddle the 64-key tiles, several splat
groups in one launch, and int8 GEMMs of any M, N, K. Tolerances: bf16
outputs of fp32 softmaxes (atol 2e-2), fp32 (atol 1e-4), atomic fp32 splat
sums (1e-4 on pixels both call known, masks on >= 99.9% of pixels); int8
codes, scales, int32 accumulators and the rescaled outputs exactly.
"""

import pytest
import torch

from gen3c_tpu_torch import kernels
from gen3c_tpu_torch.kernels import cuda as kcuda
from gen3c_tpu_torch.kernels.reference import (
    attention_reference,
    int8_matmul_reference,
    quantize_rows_reference,
    splat_reference,
    w8a8_matmul_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("lq,lk,d", [(1, 1, 8), (63, 65, 24), (130, 7, 64), (200, 1000, 96),
                                     (257, 257, 128)])
def test_attention_kernel_matches_reference(gen, dtype, atol, lq, lk, d):
    b, h = 2, 3
    q = torch.randn((b, lq, h, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, lk, h, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, lk, h, d), generator=gen, device="cuda").to(dtype)
    before = kernels.launch_counts["K2"]
    out = kernels.attention(q, k, v, kernel_id="K2")
    torch.cuda.synchronize()
    assert kernels.launch_counts["K2"] == before + 1
    assert out.dtype == dtype and out.shape == (b, lq, h, d)
    ref = attention_reference(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() <= atol


def test_attention_kernel_strided_inputs(gen):
    """q/k/v as views of one packed qkv projection (non-contiguous heads)."""
    b, l, h, d = 2, 150, 4, 64
    qkv = torch.randn((b, l, 3, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = qkv.unbind(dim=2)
    assert not q.is_contiguous()
    out = kernels.attention(q, k, v)
    ref = attention_reference(q.contiguous(), k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


def test_attention_kernel_rejects_what_it_does_not_take(gen):
    q = torch.randn((1, 8, 2, 160), generator=gen, device="cuda").to(torch.bfloat16)
    with pytest.raises(ValueError):
        kernels.attention(q, q, q)  # head dim > 128
    with pytest.raises(TypeError):
        kernels.attention(q[..., :64].half(), q[..., :64].half(), q[..., :64].half())


@pytest.mark.parametrize("group", [None, 2])
def test_splat_kernel_matches_reference(gen, group):
    b, c, h, w = 4, 3, 70, 97
    frame = torch.rand((b, c, h, w), generator=gen, device="cuda") * 2 - 1
    flow = (torch.rand((b, 2, h, w), generator=gen, device="cuda") - 0.5) * 20
    flow[0, :, :5] = torch.round(flow[0, :, :5])  # integer targets: floor == ceil
    depth = torch.rand((b, 1, h, w), generator=gen, device="cuda") * 4 - 0.5  # some <= 0
    depth[2:] *= 6.0  # the second group's log-depth maximum differs
    mask = (torch.rand((b, 1, h, w), generator=gen, device="cuda") > 0.2).float()
    before = kernels.launch_counts["K5"]
    out, m = kernels.splat(frame, mask, depth, flow, None, True, group=group)
    ref, m_ref = splat_reference(frame, mask, depth, flow, None, True, group=group)
    torch.cuda.synchronize()
    assert kernels.launch_counts["K5"] == before + 1
    assert (m == m_ref).float().mean().item() >= 0.999
    both = (m > 0) & (m_ref > 0)
    assert ((out - ref).abs() * both).max().item() <= 1e-4


def _visible_tiles(lq, lk, band, q_tile, k_tile):
    """Key tiles holding a key that some query of the query tile may see."""
    hw, window, prefix = band
    n = 0
    for q0 in range(0, lq, q_tile):
        qf = set(q // hw for q in range(q0, min(q0 + q_tile, lq)))
        for k0 in range(0, lk, k_tile):
            kfs = set(k // hw for k in range(k0, min(k0 + k_tile, lk)))
            n += any(kf < prefix or any(abs(f - kf) <= window for f in qf) for kf in kfs)
    return n


@pytest.mark.parametrize("dtype,atol,k_tile,q_tile", [(torch.bfloat16, 2e-2, 64, 64),
                                                      (torch.float32, 1e-4, 32, 8)])
@pytest.mark.parametrize("hw", [7, 60, 64, 100])
def test_band_attention_kernel_matches_reference(gen, dtype, atol, k_tile, q_tile, hw):
    """K3 against the dense-mask reference, and the key tiles it visits
    against the tiles the band reaches (the skip)."""
    b, h, d = 2, 3, 64
    for lq, lk, window, prefix in [(333, 333, 0, 0), (333, 333, 1, 1), (450, 450, 2, 2),
                                   (500, 500, 3, 1), (200, 333, 1, 0), (333, 200, 2, 1)]:
        q = torch.randn((b, lq, h, d), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, lk, h, d), generator=gen, device="cuda").to(dtype)
        v = torch.randn((b, lk, h, d), generator=gen, device="cuda").to(dtype)
        band = (hw, window, prefix)
        before = dict(kernels.launch_counts)
        out = kernels.attention(q, k, v, band=band)
        assert kernels.launch_counts["K3"] == before["K3"] + 1
        assert kernels.launch_counts["K1"] == before["K1"]
        ref = attention_reference(q, k, v, band)
        visited = torch.zeros(1, dtype=torch.int64, device="cuda")
        kcuda.attention(q, k, v, band, visited=visited)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= atol, (lq, lk, band, err)
        want = b * h * _visible_tiles(lq, lk, band, q_tile, k_tile)
        assert visited.item() == want, (lq, lk, band, visited.item(), want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_band_attention_full_window_is_k1(gen, dtype):
    """window >= T - 1 visits every tile unmasked: the same bits as K1."""
    b, l, h, d, hw = 2, 700, 4, 128, 100
    q, k, v = (torch.randn((b, l, h, d), generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    full = kernels.attention(q, k, v)
    banded = kernels.attention(q, k, v, band=(hw, l // hw - 1, 1))
    torch.cuda.synchronize()
    assert torch.equal(full, banded)


def test_attention_refuses_inputs_that_require_grad(gen):
    q = torch.randn((1, 64, 2, 32), generator=gen, device="cuda", requires_grad=True)
    k = torch.randn((1, 64, 2, 32), generator=gen, device="cuda")
    with pytest.raises(NotImplementedError, match="K4"):
        kernels.attention(q, k, k)
    with pytest.raises(NotImplementedError, match="K4"):
        kernels.attention(q, k, k, band=(16, 1, 1))
    with torch.no_grad():
        kernels.attention(q, k, k)  # no graph is built: allowed


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k", [(1, 16), (130, 1000), (257, 4096)])
def test_quant_rows_kernel_matches_reference(gen, dtype, m, k):
    x = (torch.randn((m, k), generator=gen, device="cuda") * 3).to(dtype)
    if m > 1:
        x[1] = 0  # an all-zero row: codes 0, scale 1e-12
    before = kernels.launch_counts["K7q"]
    codes, scale = kernels.quantize_rows(x)
    want_codes, want_scale = quantize_rows_reference(x)
    torch.cuda.synchronize()
    assert kernels.launch_counts["K7q"] == before + 1
    assert torch.equal(codes, want_codes)
    assert torch.equal(scale, want_scale)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,n,k", [(1, 8, 16), (130, 200, 1000), (300, 4096, 1024),
                                   (129, 33, 4096)])
def test_w8a8_kernel_matches_reference(gen, out_dtype, m, n, k):
    x = torch.randn((2, m, k), generator=gen, device="cuda").to(torch.bfloat16)
    x[0, 0] = 0
    w = torch.randn((n, k), generator=gen, device="cuda") * 0.02
    wq, wscale = quantize_rows_reference(w)
    xq, xscale = quantize_rows_reference(x.reshape(-1, k))
    acc = kcuda.int8_gemm(xq, wq, None, None, torch.int32)
    torch.cuda.synchronize()
    assert torch.equal(acc, int8_matmul_reference(xq, wq))
    before = kernels.launch_counts["K7"]
    out = kernels.w8a8_matmul(x, wq, wscale, out_dtype)
    torch.cuda.synchronize()
    assert kernels.launch_counts["K7"] == before + 1
    assert out.shape == (2, m, n) and out.dtype == out_dtype
    assert torch.equal(out, w8a8_matmul_reference(x, wq, wscale, out_dtype))
    assert (out[0, 0] == 0).all()


def test_w8a8_kernel_rejects_what_it_does_not_take(gen):
    xq = torch.zeros((4, 32), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError):
        kcuda.int8_gemm(xq, torch.zeros((8, 16), dtype=torch.int8, device="cuda"),
                        None, None, torch.int32)  # K disagrees
    with pytest.raises(TypeError):
        kcuda.int8_gemm(xq, xq, None, None, torch.float16)
    with pytest.raises(ValueError):
        kcuda.int8_gemm(xq, xq, None, None, torch.float32)  # scales missing
