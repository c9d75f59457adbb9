"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips unless CUDA is available (decided inside
the test, never at import). Run on a GPU machine with

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda

Shapes cover what the wrappers promise: bf16 and fp32, head dims from 8 to
128 (zero-padded to the MMA depth), ragged Lq and Lk, strided inputs,
temporal bands whose frames straddle the 64-key tiles, several splat
groups in one launch, int8 GEMMs of any M, N, K, and K4 (the attention
backward) at ragged self and cross shapes, K6 (the ray-triangle depth)
at ragged ray and triangle counts, and every tile of P2 (K1's tile sweep).
Tolerances: bf16
outputs of fp32 softmaxes (atol 2e-2), fp32 (atol 1e-4), atomic fp32 splat
sums (1e-4 on pixels both call known, masks on >= 99.9% of pixels); int8
codes, scales, int32 accumulators and the rescaled outputs exactly.
"""

import pytest
import torch

from gen3c_tpu_torch import kernels
from gen3c_tpu_torch.kernels import cuda as kcuda
from gen3c_tpu_torch.kernels.reference import (
    attention_backward_reference,
    attention_forward_reference,
    attention_reference,
    int8_matmul_reference,
    quantize_rows_reference,
    ray_triangle_depth_reference,
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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
def test_band_attention_with_grad_launches_k4band(gen, dtype, tol):
    """A band with a gradient to track: the band forward with lse (counted
    as K3lse, apart from K3) and K4-band once per backward, with the
    gradients of autograd through the plain band forward (tolerances as for
    K4's autograd test)."""
    band = (50, 1, 1)
    q, k, v = (torch.randn((2, 230, 3, 64), generator=gen, device="cuda").to(dtype)
               .requires_grad_(True) for _ in range(3))
    do = torch.randn((2, 230, 3, 64), generator=gen, device="cuda").to(dtype)
    before = dict(kernels.launch_counts)
    out = kernels.attention(q, k, v, band=band)
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert kernels.launch_counts["K3lse"] == before["K3lse"] + 1
    assert kernels.launch_counts["K3"] == before["K3"]
    assert kernels.launch_counts["K4band"] == before["K4band"] + 1
    assert kernels.launch_counts["K4"] == before["K4"] and kernels.launch_counts["K1"] == before["K1"]
    leaves = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(attention_reference(*leaves, band), leaves, do.float())
    for g, w in zip(got, want):
        assert _rel(g, w)[0] <= tol
    with torch.no_grad():
        kernels.attention(q, k, v, band=band)  # no graph: the K3 forward alone
    assert kernels.launch_counts["K4band"] == before["K4band"] + 1
    assert kernels.launch_counts["K3"] == before["K3"] + 1
    assert kernels.launch_counts["K3lse"] == before["K3lse"] + 1


def _band_tile_pairs(lq, lk, band, q_tile, k_tile, by_key=False):
    """(query tile, key tile) pairs the band kernels visit: per query tile
    the key tiles of the frames it reaches (K3's ranges), or, by_key, per
    key tile the query tiles whose frames reach it (dK/dV's ranges)."""
    hw, window, prefix = band
    n = 0
    if not by_key:
        return _visible_tiles(lq, lk, band, q_tile, k_tile)
    for k0 in range(0, lk, k_tile):
        kf_lo, kf_hi = k0 // hw, (min(k0 + k_tile, lk) - 1) // hw
        for q0 in range(0, lq, q_tile):
            qf_lo, qf_hi = q0 // hw, (min(q0 + q_tile, lq) - 1) // hw
            n += kf_lo < prefix or (qf_hi >= kf_lo - window and qf_lo <= kf_hi + window)
    return n


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("l,d,band", [(333, 64, (60, 1, 1)), (450, 128, (64, 2, 2)),
                                      (257, 24, (100, 0, 0)), (500, 96, (7, 3, 0)),
                                      (129, 128, (40, 0, 2))])
def test_band_backward_kernel_matches_reference(gen, dtype, l, d, band):
    """K4-band (and its forward with lse) against the plain band backward,
    held as K4 is: fp32 within 1e-4 of mean |.|; bf16 no further from the
    fp32 truth than the plain bf16 version plus 1e-2 (max) / 1e-3 (mean) of
    mean |.|. The band forward is K3's output bit for bit, and the tiles
    visited are those the band reaches: dQ and the forward over 64-key
    tiles per 64-query tile, dK/dV over 32-query tiles per 64-key tile."""
    b, h = 2, 3
    q, k, v, do = (torch.randn((b, l, h, d), generator=gen, device="cuda").to(dtype)
                   for _ in range(4))
    vis_f = torch.zeros(1, dtype=torch.int64, device="cuda")
    out, lse = kcuda.attention_fwd_lse(q, k, v, band, visited=vis_f)
    ref_out, ref_lse = attention_forward_reference(q, k, v, band)
    if dtype == torch.bfloat16:
        assert torch.equal(out, kcuda.attention(q, k, v, band))  # K3's bits
    assert (out.float() - ref_out.float()).abs().max().item() <= (2e-2 if dtype == torch.bfloat16
                                                                   else 1e-4)
    assert (lse - ref_lse).abs().max().item() <= (1e-2 if dtype == torch.bfloat16 else 1e-5)
    vis_b = torch.zeros(2, dtype=torch.int64, device="cuda")
    got = kcuda.attention_bwd(q, k, v, out, do, lse, band, visited=vis_b)
    plain = attention_backward_reference(q, k, v, out, do, lse, band)
    torch.cuda.synchronize()
    assert all(g.dtype == dtype and g.shape == t.shape for g, t in zip(got, (q, k, v)))
    assert all(torch.isfinite(g).all() for g in got)
    if dtype == torch.bfloat16:
        assert vis_f.item() == b * h * _band_tile_pairs(l, l, band, 64, 64)
        assert vis_b[0].item() == b * h * _band_tile_pairs(l, l, band, 32, 64, by_key=True)
        assert vis_b[1].item() == vis_f.item()
    if dtype == torch.float32:
        for g, p in zip(got, plain):
            assert _rel(g, p)[0] <= 1e-4
        return
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    o32, l32 = attention_forward_reference(q32, k32, v32, band)
    truth = attention_backward_reference(q32, k32, v32, o32, do32, l32, band)
    for name, g, p, t in zip("qkv", got, plain, truth):
        kmax, kmean = _rel(g, t)
        pmax, pmean = _rel(p, t)
        assert kmax <= pmax + 1e-2 and kmean <= pmean + 1e-3, (name, kmax, kmean, pmax, pmean)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_band_backward_full_window_is_k4(gen, dtype):
    """window >= T - 1 visits K4's tiles in K4's order, unmasked: the forward
    with lse and the backward give K4's bits."""
    b, l, h, d, hw = 2, 700, 4, 128, 100
    q, k, v, do = (torch.randn((b, l, h, d), generator=gen, device="cuda").to(dtype)
                   for _ in range(4))
    band = (hw, l // hw - 1, 1)
    out, lse = kcuda.attention_fwd_lse(q, k, v)
    out_b, lse_b = kcuda.attention_fwd_lse(q, k, v, band)
    assert torch.equal(out, out_b) and torch.equal(lse, lse_b)
    full = kcuda.attention_bwd(q, k, v, out, do, lse)
    banded = kcuda.attention_bwd(q, k, v, out, do, lse, band)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(full, banded))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("m,k,n,reps", [(64, 128, 64, 1), (200, 256, 130, 3), (512, 1024, 512, 2),
                                        (1408, 1024, 128, 2), (1408, 128, 1024, 4), (1, 32, 1, 5)])
def test_mma_probe_matches_reference(gen, dtype, m, k, n, reps):
    """P1 against its plain version: int8 exactly (small integers: int32
    cannot wrap); bf16 within fp32 summation order, 1e-5 of reps * (|a| +
    1) @ |b| per element."""
    if dtype == torch.int8:
        a = torch.randint(-100, 100, (m, k), generator=gen, device="cuda").to(torch.int8)
        a[0, :4] = 127  # a + 1 wraps to -128 on odd passes, as the Pallas add does
        b = torch.randint(-100, 100, (k, n), generator=gen, device="cuda").to(torch.int8)
    else:
        a = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
        b = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
    before = kernels.launch_counts["P1"]
    out = kernels.mma_probe(a, b, reps)
    want = kernels.mma_probe_reference(a, b, reps)
    torch.cuda.synchronize()
    assert kernels.launch_counts["P1"] == before + 1
    assert out.shape == (m, n) and out.dtype == want.dtype
    if dtype == torch.int8:
        assert torch.equal(out, want)
    else:
        bound = reps * ((a.float().abs() + 1) @ b.float().abs())
        assert ((out - want).abs() <= 1e-5 * bound).all()
    _, ctas = kcuda.mma_probe(a, b, reps)
    assert ctas >= torch.cuda.get_device_properties(0).multi_processor_count


def test_attention_without_grad_is_the_forward_launch(gen):
    """Grad off (or no input requiring grad): one K1 launch, as serving runs."""
    q = torch.randn((1, 64, 2, 32), generator=gen, device="cuda", requires_grad=True)
    before = dict(kernels.launch_counts)
    with torch.no_grad():
        out = kernels.attention(q, q, q)
    kernels.attention(q.detach(), q.detach(), q.detach())
    torch.cuda.synchronize()
    assert out.grad_fn is None
    assert kernels.launch_counts["K1"] == before["K1"] + 2
    assert kernels.launch_counts["K4"] == before["K4"]


def _rel(a, ref):
    """max and mean |a - ref| relative to mean |ref|."""
    d = (a.float() - ref.float()).abs()
    m = ref.float().abs().mean()
    return (d.max() / m).item(), (d.mean() / m).item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lq,lk,d", [(250, 250, 24), (250, 37, 24), (130, 7, 64), (200, 333, 64),
                                     (257, 300, 128), (1, 1, 128), (100, 512, 128)])
def test_attention_backward_kernel_matches_reference(gen, dtype, lq, lk, d):
    """K4 (and its forward with lse) against the plain versions. fp32: max
    |delta| <= 1e-4 of mean |.|. bf16: the kernel and the plain bf16
    backward are both held to the fp32 backward at the same inputs; the
    kernel (S and dP in fp32, P and dS rounded to bf16 for the MMAs) must
    be no further from it than the plain version (which also rounds S and
    dP to bf16), plus 1e-2 of mean |.| on the max and 1e-3 on the mean (as
    chip_smoke.py holds it at the 7B shapes)."""
    b, h = 2, 3
    q, k, v = (torch.randn((b, n, h, d), generator=gen, device="cuda").to(dtype)
               for n in (lq, lk, lk))
    do = torch.randn((b, lq, h, d), generator=gen, device="cuda").to(dtype)
    out, lse = kcuda.attention_fwd_lse(q, k, v)
    ref_out, ref_lse = attention_forward_reference(q, k, v)
    assert torch.equal(out, kcuda.attention(q, k, v))  # the forward is K1's, bit for bit
    assert (lse - ref_lse).abs().max().item() <= (1e-2 if dtype == torch.bfloat16 else 1e-5)
    got = kcuda.attention_bwd(q, k, v, out, do, lse)
    plain = attention_backward_reference(q, k, v, out, do, lse)
    torch.cuda.synchronize()
    assert all(g.dtype == dtype and g.shape == t.shape for g, t in zip(got, (q, k, v)))
    assert all(torch.isfinite(g).all() for g in got)
    if lq == 1 and lk == 1:
        # one key: P = 1, so dv = dout and dS = dO.v - rowsum(dO * O) cancels to
        # rounding, which leaves dq = dk = 0 (no relative error can be formed)
        tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
        assert _rel(got[2], do)[0] <= tol
        assert max(got[0].abs().max().item(), got[1].abs().max().item()) <= tol
        return
    if dtype == torch.float32:
        for g, p in zip(got, plain):
            assert _rel(g, p)[0] <= 1e-4
        return
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    o32, l32 = attention_forward_reference(q32, k32, v32)
    truth = attention_backward_reference(q32, k32, v32, o32, do32, l32)
    for name, g, p, t in zip("qkv", got, plain, truth):
        kmax, kmean = _rel(g, t)
        pmax, pmean = _rel(p, t)
        assert kmax <= pmax + 1e-2 and kmean <= pmean + 1e-3, (name, kmax, kmean, pmax, pmean)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
def test_attention_autograd_launches_k4(gen, dtype, tol):
    """kernels.attention with inputs that require grad: the forward with
    lse (counted as kernel_id) and K4 once per backward, with autograd
    through the plain forward's gradients (fp32 tolerance as above; bf16
    relative to mean |.|)."""
    q, k, v = (torch.randn((2, n, 3, 64), generator=gen, device="cuda").to(dtype)
               .requires_grad_(True) for n in (150, 90, 90))
    do = torch.randn((2, 150, 3, 64), generator=gen, device="cuda").to(dtype)
    before = dict(kernels.launch_counts)
    out = kernels.attention(q, k, v, kernel_id="K2")
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert kernels.launch_counts["K2"] == before["K2"] + 1
    assert kernels.launch_counts["K4"] == before["K4"] + 1
    leaves = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(attention_reference(*leaves), leaves, do.float())
    for g, w in zip(got, want):
        assert _rel(g, w)[0] <= tol


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


@pytest.mark.parametrize("r,t", [(1, 1), (257, 0), (1000, 37), (3000, 513), (4097, 1500)])
def test_ray_triangle_kernel_matches_reference(gen, r, t):
    """K6 against its plain version: the same operations in the same order,
    no contraction, so hit decisions flip on at most 1e-4 of the rays and
    common hits agree within 1e-5 relative (the smoke holds the same at
    901,120 rays). Rays toward a boundary-like mesh of steep and flat
    triangles, some exactly through shared vertices; T = 0 launches nothing."""
    rays = torch.randn((r, 3), generator=gen, device="cuda") * torch.tensor([0.4, 0.3, 1.0],
                                                                              device="cuda")
    rays[:, 2] = rays[:, 2].abs() + 0.2
    rays = rays / rays.norm(dim=1, keepdim=True)
    v0 = torch.rand((t, 3), generator=gen, device="cuda") * 2 - 1
    v0[:, 2] = v0[:, 2] + 2.0
    v1 = v0 + torch.rand((t, 3), generator=gen, device="cuda") * 0.5
    v2 = v0 + torch.rand((t, 3), generator=gen, device="cuda") * 0.5
    if t > 1:
        v1[1] = v0[0]  # a shared vertex, and a ray straight through it
        rays[0] = v0[0] / v0[0].norm()
    before = kernels.launch_counts["K6"]
    got = kernels.ray_triangle_depth(rays, v0, v1, v2)
    want = ray_triangle_depth_reference(rays, v0, v1, v2)
    torch.cuda.synchronize()
    assert kernels.launch_counts["K6"] == before + (t > 0)
    assert got.shape == (r,) and got.dtype == torch.float32
    flips = ((got > 0) != (want > 0)).float().mean().item()
    both = (got > 0) & (want > 0)
    assert flips <= 1e-4
    assert both.any() or t < 37
    rel = ((got - want).abs() / want.clamp_min(1e-30))[both]
    assert rel.numel() == 0 or rel.max().item() <= 1e-5
    if t == 0:
        assert not got.any()


@pytest.mark.parametrize("config", [(64, 32, "blhd"), (64, 64, "blhd"), (64, 128, "blhd"),
                                    (128, 32, "blhd"), (128, 64, "blhd"), (128, 128, "blhd"),
                                    (64, 64, "bhld")])
def test_attention_tile_sweep_matches_reference(gen, config):
    """Every P2 tile against the plain attention at ragged shapes (and K1's
    own tile equal to K1), counted as P2 and not as K1."""
    from gen3c_tpu_torch.scripts import sweep_attention as sweep

    assert config in sweep.configs()
    before = dict(kernels.launch_counts)
    assert sweep.check(config, gen) <= 2e-2
    bm, bn, layout = config
    for lq, lk in ((1, 1), (130, 7), (257, 300)):
        q, k, v = sweep.qkv((2, lq, 3, 128), (2, lk, 3, 128), layout, gen)
        out = kernels.attention_tiles(q, k, v, bm, bn)
        assert (out.float() - attention_reference(q, k, v).float()).abs().max().item() <= 2e-2
    torch.cuda.synchronize()
    assert kernels.launch_counts["P2"] == before["P2"] + 4
    assert kernels.launch_counts["K1"] == before["K1"] + ((bm, bn) == (64, 64))
