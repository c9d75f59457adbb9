"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips unless CUDA is available (decided inside
the test, never at import). Run on a GPU machine with

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda

Shapes cover what the wrappers promise: bf16 and fp32, head dims from 8 to
128 (zero-padded to the MMA depth), ragged Lq and Lk, strided inputs,
temporal bands whose frames straddle the 64-key tiles, several splat
groups in one launch, int8 GEMMs of any M, N, K and row layout, every
instruction form of P1 at ragged shapes with K cut into chunks, K7q in
one pass at any K and row alignment, and K4 (the attention
backward) at ragged self and cross shapes, K6 (the ray-triangle depth)
at ragged ray and triangle counts and bit for bit at T = 0, 1, a
straddling mesh and T = 120,000 (its setup kernel: the plain rule's
bits), K5 with NaN and +inf depths and with its corners merged across lanes,
every point of P2 (K1's tile sweep), the fp32 forward (three TF32
products) on MoGe's strided q, k, v and on rows off alignment, K1cp
(K1 read in place from the Ulysses all-to-all's layout: K1's bits), and
K1ring + K1merge over 4 KV shards with and without the band (rows left
without a key by a shard: 0 and -inf, no NaN).
Tolerances: bf16
outputs of fp32 softmaxes (atol 2e-2; K8's decode rows also relative to mean
|plain|, K8_DECODE_TOL), fp32 (atol 1e-4), atomic fp32 splat
sums (1e-4 on pixels both call known, masks on >= 99.9% of pixels); int8
codes, scales, int32 accumulators and the rescaled outputs exactly.
"""

import math

import pytest
import torch

from gen3c_tpu_torch import kernels
from gen3c_tpu_torch.kernels import cuda as kcuda
from gen3c_tpu_torch.kernels import reference
from gen3c_tpu_torch.models import dit
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
                                                      (torch.float32, 1e-4, 32, 64)])
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


_P1_FORMS = [(dtype, form) for dtype, forms in kcuda.MMA_PROBE_FORMS.items() for form in forms]


@pytest.mark.parametrize("dtype,form", _P1_FORMS)
@pytest.mark.parametrize("m,k,n,reps", [(64, 128, 64, 1), (200, 256, 130, 3), (512, 1024, 512, 2),
                                        (1408, 1024, 128, 2), (1408, 128, 1024, 4), (1, 32, 1, 5),
                                        (200, 256, 130, 5), (333, 1056, 200, 9), (64, 64, 64, 0)])
def test_mma_probe_matches_reference(gen, dtype, form, m, k, n, reps):
    """Every P1 form against its plain version: int8 exactly (a + 1 wraps
    on a's 127s; small integers, so int32 cannot wrap); bf16 within fp32
    summation order, 1e-5 of reps * (|a| + 1) @ |b| per element. The cases
    hold K = 1,024 and 1,056 cut into chunks, odd R cut into slices that
    start at odd passes, ragged M and N, and R = 0. The plan's grid is its
    units, which reach the SM count wherever the work allows; a launch
    whose plan is not the C entry's own is refused."""
    from gen3c_tpu_torch.scripts import probe_int8_attention as probe

    a, b = probe.operands(m, k, n, dtype, gen)
    before = kernels.launch_counts["P1"]
    out = kernels.mma_probe(a, b, reps, form)
    want = kernels.mma_probe_reference(a, b, reps)
    torch.cuda.synchronize()
    assert kernels.launch_counts["P1"] == before + 1
    assert out.shape == (m, n) and out.dtype == want.dtype
    if dtype == "int8":
        assert torch.equal(out, want)
    else:
        bound = reps * ((a.float().abs() + 1) @ b.float().abs())
        assert ((out - want).abs() <= 1e-5 * bound).all()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = kcuda.mma_probe_plan(m, n, k, reps, dtype, form, sms)
    base = plan.m_tiles * plan.n_tiles * plan.chunks
    assert plan.grid == base * plan.slices
    if base * reps >= sms:
        assert plan.grid >= sms


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


def _k7_equal(xq, wq, xs, ws):
    """K7 on (xq, wq) against the plain version: int32 accumulators, fp32
    and bf16 outputs all equal."""
    acc = kcuda.int8_gemm(xq, wq, None, None, torch.int32)
    want = int8_matmul_reference(xq, wq)
    assert torch.equal(acc, want)
    for dtype in (torch.float32, torch.bfloat16):
        out = kcuda.int8_gemm(xq, wq, xs, ws, dtype)
        ref = want.float().mul_(xs[:, None]).mul_(ws[None, :]).to(dtype)
        torch.cuda.synchronize()
        assert out.dtype == dtype and torch.equal(out, ref), dtype


@pytest.mark.parametrize("k,pitch", [(16, 16), (48, 48), (1000, 1024), (1000, 1000),
                                     (4096, 4096), (16384, 16384)])
@pytest.mark.parametrize("n", [8, 33, 200, 4096 + 8])
@pytest.mark.parametrize("m", [1, 127, 129, 300])
def test_w8a8_wgmma_body_matches_reference(gen, m, n, k, pitch):
    """K7 at ragged M, N and K: K = 1,000 in rows of 1,024 bytes (TMA
    zero-fills past K) and contiguous (rows of 1,000 bytes, copied into
    16-byte rows first): the plain version's bits."""
    xq = torch.randint(-127, 128, (m, pitch), generator=gen, device="cuda",
                       dtype=torch.int8)[:, :k]
    wq = torch.randint(-127, 128, (n, pitch), generator=gen, device="cuda",
                       dtype=torch.int8)[:, :k]
    xs = torch.rand(m, generator=gen, device="cuda") + 1e-3
    ws = torch.rand(n, generator=gen, device="cuda") * 0.01 + 1e-4
    assert (kcuda.w8a8_operand(xq) is xq) == (pitch % 16 == 0 or m == 1)
    _k7_equal(xq, wq, xs, ws)


@pytest.mark.parametrize("m,n,k", [(130, 200, 1000), (300, 4096 + 8, 4096)])
def test_w8a8_unaligned_base_matches_reference(gen, m, n, k):
    """Codes read from a base off 16-byte alignment: no tensor map takes
    them, so K7 reads a copy, and gives the same bits."""
    buf = torch.randint(-127, 128, (m * k + 1,), generator=gen, device="cuda", dtype=torch.int8)
    xq = buf[1:].view(m, k)
    wq = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
    xs = torch.rand(m, generator=gen, device="cuda") + 1e-3
    ws = torch.rand(n, generator=gen, device="cuda") * 0.01 + 1e-4
    assert xq.data_ptr() % 16 and kcuda.w8a8_operand(xq) is not xq
    _k7_equal(xq, wq, xs, ws)


def test_w8a8_matmul_counts_its_launches(gen):
    """kernels.w8a8_matmul at the tiny preset's fc1 (96 -> 384): one K7q and
    one K7, reset with the launch counts."""
    x = torch.randn((2, 40, 96), generator=gen, device="cuda").to(torch.bfloat16)
    wq, ws = quantize_rows_reference(torch.randn((384, 96), generator=gen, device="cuda"))
    kernels.reset_launch_counts()
    out = kernels.w8a8_matmul(x, wq, ws, torch.bfloat16)
    assert torch.equal(out, w8a8_matmul_reference(x, wq, ws, torch.bfloat16))
    assert kernels.launch_counts["K7"] == 1 and kernels.launch_counts["K7q"] == 1
    kernels.reset_launch_counts()
    assert kernels.launch_counts["K7"] == 0 and kernels.launch_counts["K7q"] == 0


@pytest.mark.parametrize("layout", ["contiguous", "unaligned"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [16, 1000, 4096, 16384, 40000])
def test_quant_rows_one_pass_matches_reference(gen, k, dtype, layout):
    """K7q's one pass at both 7B widths, a ragged K and a tiny one, and a
    row longer than a CTA holds in registers (40,000: two or three slices,
    each read again for its codes), with a zero row; "unaligned": rows read
    from a buffer of pitch K + 3 at an offset of one element, so every row
    starts at another alignment (the scalar head and tail, byte-wise code
    stores)."""
    m = 37
    if layout == "contiguous":
        x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    else:
        x = torch.randn((m, k + 3), generator=gen, device="cuda").to(dtype)[:, 1:k + 1]
        assert x.data_ptr() % 16 and x.stride(0) == k + 3
    x[3] = 0
    x[5, k // 2] = 40.0  # an outlier
    x[6, k - 1] = -50.0  # one in the last slice
    codes, scale = kcuda.quantize_rows(x)
    want_codes, want_scale = quantize_rows_reference(x)
    torch.cuda.synchronize()
    assert torch.equal(codes, want_codes)
    assert torch.equal(scale, want_scale)
    assert (codes[3] == 0).all() and codes[5, k // 2] == 127 and codes[6, k - 1] == -127


@pytest.mark.parametrize("layout", ["contiguous", "unaligned"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [16, 1000, 2048, 7168, 40000])
def test_quant_rows_row_scale_mode_matches_reference(gen, k, dtype, layout):
    """K7q's row-scale mode (a row-parallel W8A8 input, the row split over
    tp): the row-absmax pass gives each row's max |x| and writes nothing
    else; the codes with a given absmax are the plain version's with it.
    Two column halves quantized with the max of their absmax are the
    whole row's codes and scale, bit for bit (the 4B's wo and w2 at tp 2:
    K 2,048 and 7,168 a rank)."""
    m = 37
    if layout == "contiguous":
        x = torch.randn((m, 2 * k), generator=gen, device="cuda").to(dtype)
    else:
        x = torch.randn((m, 2 * k + 3), generator=gen, device="cuda").to(dtype)[:, 1:2 * k + 1]
    x[3] = 0
    x[5, k + k // 2] = 40.0  # an outlier in the second half
    amax = kcuda.row_absmax(x)
    torch.cuda.synchronize()
    assert torch.equal(amax, reference.row_absmax_reference(x))
    halves = (x[:, :k], x[:, k:])
    whole_codes, whole_scale = quantize_rows_reference(x)
    row = torch.maximum(*(kcuda.row_absmax(h) for h in halves))
    for i, h in enumerate(halves):
        codes, scale = kcuda.quantize_rows(h, row)
        want_codes, want_scale = quantize_rows_reference(h, row)
        torch.cuda.synchronize()
        assert torch.equal(codes, want_codes) and torch.equal(scale, want_scale)
        assert torch.equal(codes, whole_codes[:, i * k:(i + 1) * k])
        assert torch.equal(scale, whole_scale)


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


def _splat_check(out, m, ref, m_ref):
    """K5 against its plain version: the NaN pattern equal, masks on >= 99.9%
    of pixels, finite values where both know the pixel within 1e-4."""
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    assert (m == m_ref).float().mean().item() >= 0.999
    both = ((m > 0) & (m_ref > 0)).expand_as(out) & torch.isfinite(ref) & torch.isfinite(out)
    assert ((out - ref).abs() * both).nan_to_num().max().item() <= 1e-4


def test_splat_kernel_keeps_nonfinite_depth(gen):
    """A NaN depth (buffer 0) and a +inf depth (buffer 1), each buffer its
    own group: the inputs the CPU test holds splat_reference to gen3c_tpu
    with. NaN spreads as torch.clamp and amax spread it (fmaxf / fminf
    would drop it)."""
    from torch_splat_cases import nonfinite_splat_inputs

    frame, mask, depth, flow, fmask = (torch.from_numpy(a).cuda() for a in nonfinite_splat_inputs())
    for is_image in (True, False):
        out, m = kernels.splat(frame, mask, depth, flow, fmask, is_image, group=1)
        ref, m_ref = splat_reference(frame, mask, depth, flow, fmask, is_image, group=1)
        torch.cuda.synchronize()
        assert torch.isnan(ref[0]).any() and torch.isnan(ref[1]).any()
        assert not torch.isnan(ref[1]).all()
        _splat_check(out, m, ref, m_ref)
    nan_max = depth.clone()
    nan_max[0, 0, 5, 6] = -float("nan")  # the sign bit set: still the largest
    out, m = kernels.splat(frame, mask, nan_max, flow, fmask, True, group=1)
    ref, m_ref = splat_reference(frame, mask, nan_max, flow, fmask, True, group=1)
    _splat_check(out, m, ref, m_ref)


@pytest.mark.parametrize("c", [1, 2, 3])
@pytest.mark.parametrize("flow_kind", ["constant", "integer", "smooth", "random"])
def test_splat_kernel_merges_neighbouring_corners(gen, c, flow_kind):
    """The accumulate merges a lane's east corners into the next lane's west
    ones where the cells match (C = 1 and 3; C = 2 takes scalar atomics,
    merges and counts nothing; a whole-pixel flow puts a lane's four corners on one
    cell and the next lane's elsewhere): the plain version's function, and
    every corner either added or merged."""
    b, h, w = 2, 61, 333
    frame = torch.rand((b, c, h, w), generator=gen, device="cuda") * 2 - 1
    depth = torch.rand((b, 1, h, w), generator=gen, device="cuda") * 3 + 0.5
    mask = (torch.rand((b, 1, h, w), generator=gen, device="cuda") > 0.1).float()
    yy, xx = torch.meshgrid(torch.arange(h, device="cuda"), torch.arange(w, device="cuda"),
                            indexing="ij")
    flow = torch.zeros((b, 2, h, w), device="cuda")
    if flow_kind == "constant":
        flow[:, 0], flow[:, 1] = 3.3, -1.7
    elif flow_kind == "integer":
        flow[:, 0], flow[:, 1] = 2.0, 1.0
    elif flow_kind == "smooth":
        flow[:, 0], flow[:, 1] = 0.02 * xx + 0.5 * torch.sin(yy / 9.0), 0.01 * yy - 0.003 * xx
    else:
        flow = (torch.rand((b, 2, h, w), generator=gen, device="cuda") - 0.5) * 2 * w
    ref, m_ref = splat_reference(frame, mask, depth, flow, None, True)
    counts = torch.zeros(2, dtype=torch.int32, device="cuda")
    out, m = kcuda.splat(frame, mask, depth, flow, None, True, counts=counts)
    torch.cuda.synchronize()
    _splat_check(out, m, ref, m_ref)
    added, merged = counts.tolist()
    if c == 2:  # scalar atomics: nothing merged, nothing counted
        assert added == merged == 0
        return
    assert added + merged == 4 * b * h * w
    if flow_kind in ("constant", "smooth"):  # east corners are the next lane's west ones
        assert merged > 0.4 * (added + merged)


def test_ray_triangle_setup_kernel_is_the_plain_rule(gen):
    """K6's setup kernel forms the rows, rectangles and chunk rectangles of
    reference.ray_triangle_setup / ray_triangle_bounds / ray_chunk_bounds
    bit for bit, uncullable triangles (a vertex behind the camera, NaN)
    included, at a T that is not a multiple of 32."""
    t = 1000
    v0 = torch.rand((t, 3), generator=gen, device="cuda") * 2 - 1
    v0[:, 2] += 2.0
    v1 = v0 + torch.rand((t, 3), generator=gen, device="cuda") * 0.2
    v2 = v0 + torch.rand((t, 3), generator=gen, device="cuda") * 0.2
    v0[:7, 2] = -0.5
    v1[7:9, 0] = float("nan")
    v2[9] = v0[9]
    tris, boxes, chunks = kcuda.ray_triangle_setup_and_bounds(v0, v1, v2)
    want_tris = reference.ray_triangle_setup(v0, v1, v2)
    want_boxes = reference.ray_triangle_bounds(want_tris)
    assert torch.equal(tris.nan_to_num(), want_tris.nan_to_num())
    assert torch.equal(torch.isnan(tris), torch.isnan(want_tris))
    assert torch.equal(boxes, want_boxes)
    assert torch.equal(chunks, reference.ray_chunk_bounds(want_boxes))
    assert torch.isinf(boxes[:10]).all()


@pytest.mark.parametrize("case", ["empty", "one", "straddling", "dense"])
def test_ray_triangle_kernel_is_the_plain_version_bit_for_bit(gen, case):
    """The culled K6 against the all-pairs plain version, the same bits: T
    = 0 (nothing launched), T = 1, a mesh with triangles straddling z = 0
    and rays with d_z <= 0, and T = 120,000 small triangles (a dense mesh)."""
    r = 100 * 160
    rays = torch.randn((r, 3), generator=gen, device="cuda") * torch.tensor([0.4, 0.3, 1.0],
                                                                              device="cuda")
    rays[:, 2] = rays[:, 2].abs() + 0.2
    t = {"empty": 0, "one": 1, "straddling": 500, "dense": 120_000}[case]
    v0 = torch.rand((t, 3), generator=gen, device="cuda") * 2 - 1
    v0[:, 2] += 2.0
    size = 0.02 if case == "dense" else 0.5
    v1 = v0 + torch.rand((t, 3), generator=gen, device="cuda") * size
    v2 = v0 + torch.rand((t, 3), generator=gen, device="cuda") * size
    if case == "straddling":
        v0[:50, 2] = -1.0
        rays[::97, 2] *= -1
    rays = rays / rays.norm(dim=1, keepdim=True)
    before = kernels.launch_counts["K6"]
    got = kernels.ray_triangle_depth(rays, v0, v1, v2)
    want = ray_triangle_depth_reference(rays, v0, v1, v2)
    torch.cuda.synchronize()
    assert kernels.launch_counts["K6"] == before + (t > 0)
    assert torch.equal(got, want)
    assert (want > 0).any() or t == 0


@pytest.mark.parametrize("config", [((2, 64, 4), "blhd"), ((2, 64, 2), "blhd"),
                                    ((2, 64, 3), "blhd"), ((2, 128, 2), "blhd"),
                                    ((2, 128, 3), "blhd"), ((3, 64, 2), "blhd"),
                                    ((3, 64, 3), "blhd"), ((3, 64, 4), "blhd"),
                                    ((3, 128, 2), "blhd"), ((2, 64, 4), "bhld")])
def test_attention_tile_sweep_matches_reference(gen, config):
    """Every P2 point (K1's wgmma forward built at the point) against the
    plain attention at ragged shapes, K1's own point equal to K1 and every
    64-key point too; counted as P2 and not as K1."""
    from gen3c_tpu_torch.scripts import sweep_attention as sweep

    assert config in sweep.configs()
    before = dict(kernels.launch_counts)
    checked = sweep.check(config, gen)
    assert checked["check_max_abs_err"] <= 2e-2
    point, layout = config
    for lq, lk in ((1, 1), (130, 7), (257, 300)):
        q, k, v = sweep.qkv((2, lq, 3, 128), (2, lk, 3, 128), layout, gen)
        out = kernels.attention_point(q, k, v, point)
        assert (out.float() - attention_reference(q, k, v).float()).abs().max().item() <= 2e-2
        if point[1] == 64:  # the same tiles in the same order for every row
            assert torch.equal(out, kcuda.attention(q, k, v))
    torch.cuda.synchronize()
    assert kernels.launch_counts["P2"] == before["P2"] + 4
    assert kernels.launch_counts["K1"] == before["K1"] + 1  # the check's K1 call


@pytest.mark.parametrize("layout", ["moge", "unaligned"])
def test_attention_f32_kernel_takes_any_strides(gen, layout):
    """The 3xTF32 fp32 forward on MoGe's q, k, v (views of one qkv
    projection, rows of 3,072 floats: 16-byte copies) and on rows off
    16-byte alignment (an odd row stride: 4-byte copies), within 1e-4 of the
    plain version."""
    if layout == "moge":
        qkv = torch.randn((1, 1351, 3 * 1024), generator=gen, device="cuda")
        q, k, v = (t.reshape(1, 1351, 16, 64) for t in qkv.chunk(3, dim=-1))
    else:
        buf = torch.randn((2, 333, 3 * 4 * 24 + 1), generator=gen, device="cuda")
        q, k, v = (t.reshape(2, 333, 4, 24) for t in buf[..., 1:].chunk(3, dim=-1))
        assert q.stride(1) % 4 and q.data_ptr() % 16
    out = kernels.attention(q, k, v, kernel_id="K1vit")
    ref = attention_reference(q, k, v)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 1e-4


def _ulysses_view(x, cp, rank):
    """Rank ``rank``'s heads of the whole sequence x (B, L, H, D), laid out
    as collectives.seq_to_heads leaves them: a view of an (cp, L/cp, B,
    H/cp, D) receive buffer."""
    B, L, H, D = x.shape
    hc = H // cp
    buf = x[:, :, rank * hc:(rank + 1) * hc].reshape(B, cp, L // cp, hc, D)
    buf = buf.permute(1, 2, 0, 3, 4).contiguous()
    return buf.view(L, B, hc, D).permute(1, 0, 2, 3)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("band", [None, (60, 1, 1)])
@pytest.mark.parametrize("cp", [2, 4])
def test_k1cp_on_the_ulysses_layout_is_k1_sliced(gen, dtype, band, cp):
    """K1cp: K1 (K3 under the band) on a rank's H/cp heads, read in place
    from the all-to-all's receive layout, gives the bits of K1 on all
    heads for those heads (each (batch, head) is computed alone)."""
    b, l, h, d = 2, 480, 8, 64
    q, k, v = (torch.randn((b, l, h, d), generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    full = kernels.attention(q, k, v, band=band)
    for rank in range(cp):
        views = [_ulysses_view(t, cp, rank) for t in (q, k, v)]
        assert not views[0].is_contiguous()
        before = dict(kernels.launch_counts)
        out = kernels.attention(*views, kernel_id="K1cp", band=band)
        torch.cuda.synchronize()
        assert kernels.launch_counts["K1cp"] == before["K1cp"] + 1
        assert kernels.launch_counts["K3"] == before["K3"]
        hc = h // cp
        assert torch.equal(out, full[:, :, rank * hc:(rank + 1) * hc])


def _ring(q, k, v, cp, rank, band, fold, merge):
    """Rank ``rank``'s ring attention over the cp KV shards of k/v, with
    the given fold and merge (kernels or plain versions); the steps it
    folded."""
    B, L, H, D = q.shape
    ls = L // cp
    qs = q[:, rank * ls:(rank + 1) * ls].contiguous()
    acc = torch.zeros((B, ls, H, D), dtype=torch.float32, device=q.device)
    lse = torch.full((B, H, ls), float("-inf"), device=q.device)
    out, folded = None, []
    for step in range(cp):
        src = (rank - step) % cp
        last = step == cp - 1
        if band is None or dit.ring_step_needed(rank, src, ls // band[0], band):
            o, l_ = fold(qs, k[:, src * ls:(src + 1) * ls].contiguous(),
                         v[:, src * ls:(src + 1) * ls].contiguous(), band, rank * ls, src * ls)
            assert torch.isfinite(o).all() and not torch.isnan(l_).any()
            out = merge(acc, lse, o, l_, q.dtype if last else None)
            folded.append(src)
        elif last:
            out = merge(acc, lse, None, None, q.dtype)
    return out, folded


@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("band", [None, (60, 1, 1), (60, 0, 0), (60, 2, 2)])
def test_ring_fold_and_merge_match_k1_and_plain(gen, dtype, atol, band):
    """K1ring + K1merge over 4 shards (ragged: 60-token frames straddle the
    64-key tiles) against K1 (K3 under the band) on the whole sequence and
    against the plain fold and merge; skipped steps follow JAX's rule."""
    from gen3c_tpu_torch.kernels.reference import ring_fold_reference, ring_merge_reference

    b, l, h, d, cp = 2, 960, 4, 64, 4
    q, k, v = (torch.randn((b, l, h, d), generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    want = kernels.attention(q, k, v, band=band)
    for rank in range(cp):
        before = dict(kernels.launch_counts)
        got, folded = _ring(q, k, v, cp, rank, band, kernels.ring_fold, kernels.ring_merge)
        plain, _ = _ring(q, k, v, cp, rank, band, ring_fold_reference, ring_merge_reference)
        torch.cuda.synchronize()
        assert kernels.launch_counts["K1ring"] == before["K1ring"] + len(folded)
        assert kernels.launch_counts["K1merge"] - before["K1merge"] in (len(folded),
                                                                        len(folded) + 1)
        if band is not None and band[1] == 0 and band[2] == 0:
            assert folded == [rank]  # only the diagonal shard holds visible pairs
        rows = want[:, rank * (l // cp):(rank + 1) * (l // cp)]
        assert got.dtype == dtype and torch.isfinite(got).all()
        assert (got.float() - rows.float()).abs().max().item() <= atol
        assert (got.float() - plain.float()).abs().max().item() <= atol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ring_fold_rows_without_keys_are_zero(gen, dtype):
    """A step whose shard the band hides from some query rows: those rows
    give out 0 and lse -inf (no NaN), and merging them changes nothing."""
    b, h, d, hw = 1, 2, 64, 50
    q = torch.randn((b, 200, h, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, 200, h, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, 200, h, d), generator=gen, device="cuda").to(dtype)
    band = (hw, 1, 0)  # query frames 4..7 (q_off 200) see key frames 3..8 only
    out, lse = kernels.ring_fold(q, k, v, band, q_off=200, k_off=0)
    torch.cuda.synchronize()
    assert not torch.isnan(out).any() and not torch.isnan(lse).any()
    dark = torch.arange(200, device="cuda") >= 50  # query frames 5..7 see no key frame < 4
    assert (out[:, dark] == 0).all() and torch.isinf(lse[:, :, dark]).all()
    assert torch.isfinite(lse[:, :, ~dark]).all()
    acc = torch.randn((b, 200, h, d), generator=gen, device="cuda")
    acc_lse = torch.randn((b, h, 200), generator=gen, device="cuda")
    a0, l0 = acc.clone(), acc_lse.clone()
    kernels.ring_merge(acc, acc_lse, out, lse)
    torch.cuda.synchronize()
    torch.testing.assert_close(acc[:, dark], a0[:, dark])
    torch.testing.assert_close(acc_lse[:, :, dark], l0[:, :, dark])


def test_offload_flags_are_no_ops_on_the_card(tmp_path, monkeypatch):
    """The tiny CLI on the card with --offload_diffusion_transformer and
    --offload_tokenizer gives the frames it gives without them (uint8,
    |delta| <= 1 on >= 99.9%: K5's atomics sum in any order; the frames are
    taken before the lossy video codec)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np
    from PIL import Image

    from gen3c_tpu_torch.pipelines import gen3c_single_image as cli

    img = tmp_path / "in.png"
    Image.fromarray((np.random.default_rng(0).uniform(size=(96, 160, 3)) * 255)
                    .astype(np.uint8)).save(img)
    videos = []
    monkeypatch.setattr(cli.IncrementalVideoSaver, "save",
                        lambda self, video, path: videos.append(video) or path)
    for flags in ([], ["--offload_diffusion_transformer", "--offload_tokenizer"]):
        args = cli.create_parser().parse_args(
            ["--device", "cuda", "--model_preset", "gen3c_tiny", "--num_steps", "2",
             "--depth_source", "heuristic", "--num_video_frames", "9", "--input_image_path",
             str(img), "--video_save_folder", str(tmp_path), "--checkpoint_dir",
             str(tmp_path / "n"), *flags])
        cli.demo(args)
    assert len(videos) == 2 and videos[0].shape == videos[1].shape == (9, 96, 160, 3)
    diff = np.abs(videos[0].astype(np.int16) - videos[1].astype(np.int16))
    assert (diff <= 1).mean() >= 0.999, (diff.max(), (diff > 1).mean())


# K8's decode against its plain version, relative to mean |plain| (chip_smoke.py's
# K8_DECODE_TOL): a decode row over thousands of random keys has a mean
# |out| of about 0.02, as small as the absolute bf16 tolerance
K8_DECODE_TOL = {"max": 0.15, "mean": 0.03}
K8_ALIGNED_LOGIT = 9.0  # about half the softmax's weight on the key a query lies on


def _rel_errs(out, ref):
    """max and mean |out - ref|, each relative to mean |ref|."""
    diff, scale = (out.float() - ref.float()).abs(), ref.float().abs().mean()
    return (diff.max() / scale).item(), (diff.mean() / scale).item()


def _within_decode_tol(out, ref) -> bool:
    rmax, rmean = _rel_errs(out, ref)
    return rmax <= K8_DECODE_TOL["max"] and rmean <= K8_DECODE_TOL["mean"]


def _gqa_inputs(gen, B, Lq, Lk, Hq, Hkv, d, dtype, int8):
    q = torch.randn((B, Lq, Hq, d), generator=gen, device="cuda").to(dtype)
    if not int8:
        k, v = (torch.randn((B, Lk, Hkv, d), generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        return q, k, v, None, None
    k, v = (torch.randint(-127, 128, (B, Lk, Hkv, d), generator=gen, device="cuda",
                          dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((B, Lk, Hkv, 1), generator=gen, device="cuda") * 0.02 + 1e-3
              for _ in range(2))
    return q, k, v, ks, vs


@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,Lq,Lk,Hq,Hkv,d,offset,start", [
    (1, 1, 12800, 32, 8, 128, 5120, None),    # 4B decode, splits over the visible keys
    (1, 1, 12800, 32, 8, 128, 12799, None),   # the last position
    (2, 1, 300, 4, 2, 32, 40, (0, 17)),       # tiny heads, left padding
    (1, 333, 333, 32, 8, 128, 0, None),       # prefill, ragged tiles
    (2, 70, 200, 8, 8, 64, 100, (5, 130)),    # rep 1, chunked prefill past pad rows
    (1, 5, 77, 12, 4, 24, None, None),        # cross-attention, d off the tile
    (1, 1024, 1224, 32, 8, 128, 200, (37,)),  # prefill after a prefix, left padding
    (1, 4, 12800, 32, 8, 128, 5000, None),    # decode of 16 rows (4 queries x rep 4)
    (2, 2, 700, 8, 2, 64, 600, (3, 100)),     # decode of 8 rows, left padding
    (1, 1, 1001, 32, 8, 128, 1000, None),     # Lk off the 64-key tile, the last position
    (2, 1, 1001, 16, 4, 128, None, (0, 500)),  # cross-attention decode over a ragged Lk
])
def test_gqa_kernel_matches_reference(gen, dtype, atol, int8, B, Lq, Lk, Hq, Hkv, d, offset,
                                      start):
    """K8 against its plain version on every row that sees a key (a row that
    sees none is 0 on the card: left-pad queries, never read)."""
    q, k, v, ks, vs = _gqa_inputs(gen, B, Lq, Lk, Hq, Hkv, d, dtype, int8)
    kv_start = None if start is None else torch.tensor(start, device="cuda")
    kernels.reset_launch_counts()
    out = kernels.gqa_attention(q, k, v, offset, kv_start, ks, vs)
    torch.cuda.synchronize()
    assert kernels.launch_counts["K8"] == 1 and out.dtype == dtype
    ref = reference.gqa_attention_reference(q, k, v, offset, kv_start, ks, vs)
    seen = torch.ones((B, Lq), dtype=torch.bool, device="cuda")
    if offset is not None and kv_start is not None:
        seen = (offset + torch.arange(Lq, device="cuda"))[None] >= kv_start[:, None]
    assert torch.allclose(out[seen].float(), ref[seen].float(), atol=atol, rtol=0)
    if kcuda.gqa_route(q, k, v, int8) == "decode":
        assert _within_decode_tol(out[seen], ref[seen]), _rel_errs(out[seen], ref[seen])
    assert (out[~seen] == 0).all()


@pytest.mark.parametrize("int8", [False, True])
def test_gqa_decode_repeats_its_bits_and_merges_empty_splits(gen, int8):
    """The decode's one launch: two calls in a row give the same bits (the
    last CTA of each (batch, KV head) resets its ticket), and at pos 10 of a
    12,800-row cache, where some splits see no key, the merge gives the
    plain version's values; a row whose keys all lie before its
    kv_valid_start gives 0."""
    q, k, v, ks, vs = _gqa_inputs(gen, 2, 1, 12800, 32, 8, 128, torch.bfloat16, int8)
    splits = kcuda.gqa_plan(2, 1, 32, 8, 12800, kcuda._sm_count(0), int8)
    ranges = [kcuda.gqa_split_range(s, splits, 0, 11) for s in range(splits)]
    assert any(begin == end for begin, end in ranges)  # splits that see none of the 11 keys
    start = torch.tensor([0, 11], device="cuda")
    kernels.reset_launch_counts()
    first = kernels.gqa_attention(q, k, v, 10, start, ks, vs)
    second = kernels.gqa_attention(q, k, v, 10, start, ks, vs)
    torch.cuda.synchronize()
    assert kernels.launch_counts["K8"] == 2
    assert torch.equal(first, second)
    ref = reference.gqa_attention_reference(q, k, v, 10, start, ks, vs)
    assert torch.allclose(first[0].float(), ref[0].float(), atol=2e-2, rtol=0)
    assert _within_decode_tol(first[0], ref[0]), _rel_errs(first[0], ref[0])
    assert (first[1] == 0).all()


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,Lq,Lk,Hq,Hkv,offset,start", [
    (1, 4, 12800, 32, 8, 5000, None),     # decode of 16 rows: row i's keys end at 5,000 + i
    (2, 1, 1001, 16, 4, None, (0, 500)),  # cross-attention decode, left padding
])
def test_gqa_decode_sees_exactly_its_keys(gen, int8, B, Lq, Lk, Hq, Hkv, offset, start):
    """Even query heads lie on their row's last visible key and odd ones on
    the key just outside the row (the next key of a causal row, the key
    before kv_valid_start, else the last key), each with a logit of
    K8_ALIGNED_LOGIT, so that a decode that drops its last key or sees one
    key more moves the output by about its own size. K8 is held to its
    plain version relative to mean |plain|, and the plain version with each
    of those mistakes fails that limit."""
    d, rep = 128, Hq // Hkv
    q, k, v, ks, vs = _gqa_inputs(gen, B, Lq, Lk, Hq, Hkv, d, torch.bfloat16, int8)
    kv_start = None if start is None else torch.tensor(start, device="cuda")
    for b in range(B):
        for i in range(Lq):
            last = Lk - 1 if offset is None else offset + i
            outside = (last + 1 if offset is not None
                       else start[b] - 1 if start is not None and start[b] > 0 else last)
            for h in range(Hq):
                j, g = last if h % 2 == 0 else outside, h // rep
                if int8:
                    ks[b, j, g] = vs[b, j, g] = 0.02  # the largest scale: the key stands out
                key = k[b, j, g].float() * (ks[b, j, g] if int8 else 1.0)
                q[b, i, h] = (K8_ALIGNED_LOGIT * math.sqrt(d) / key.square().sum()
                              * key).to(q.dtype)
    assert kcuda.gqa_route(q, k, v, int8) == "decode"
    out = kernels.gqa_attention(q, k, v, offset, kv_start, ks, vs)
    ref = reference.gqa_attention_reference(q, k, v, offset, kv_start, ks, vs)
    assert _within_decode_tol(out, ref), _rel_errs(out, ref)
    if offset is not None:
        wrong = [reference.gqa_attention_reference(q, k, v, offset + step, kv_start, ks, vs)
                 for step in (-1, 1)]
    else:
        cut = [None if t is None else t[:, :-1] for t in (k, v, ks, vs)]
        wrong = [reference.gqa_attention_reference(q, cut[0], cut[1], None, kv_start, *cut[2:]),
                 reference.gqa_attention_reference(q, k, v, None, (kv_start - 1).clamp(min=0),
                                                   ks, vs)]
    for w in wrong:
        assert not _within_decode_tol(w, ref), _rel_errs(w, ref)


def test_gqa_kernel_strided_cache_and_rejects(gen):
    """The kernel reads a layer of a (layers, B, S, Hkv, d) cache in place,
    and refuses what it does not take."""
    cache = torch.randn((3, 2, 96, 2, 64), generator=gen, device="cuda").to(torch.bfloat16)
    q = torch.randn((2, 3, 8, 64), generator=gen, device="cuda").to(torch.bfloat16)
    out = kernels.gqa_attention(q, cache[1], cache[2], 50)
    ref = reference.gqa_attention_reference(q, cache[1], cache[2], 50)
    assert torch.allclose(out.float(), ref.float(), atol=2e-2, rtol=0)
    with pytest.raises(TypeError):
        kernels.gqa_attention(q, cache[1].float(), cache[2].float(), 50)
    with pytest.raises(ValueError):
        kernels.gqa_attention(q[:, :, :7], cache[1], cache[2], 50)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,Lq,Lk,Hq,Hkv,offset,start", [
    (1, 1, 4096, 32, 8, 256, (56,)),    # Llama-Guard-3-8B decode: rep 4, a short cache
    (1, 1, 4096, 32, 32, 256, (56,)),   # LlamaGuard-7b (Aegis) decode: rep 1, B * Hkv = 32
    (1, 1, 4300, 40, 8, 2431, (91,)),   # the upsampler's text model decode: rep 5
    (1, 1, 4300, 40, 8, 3, None),       # rep 5 at pos 3: most splits see no key
    (1, 256, 4096, 32, 32, 0, (56,)),   # Aegis prefill: rep 1, left padding
    (1, 256, 4096, 32, 8, 0, (56,)),    # Llama-Guard-3 prefill
    (1, 2432, 4300, 40, 8, 0, (91,)),   # the VLM's spliced prefill: rep 5
    (2, 37, 300, 40, 8, 100, (5, 130)),  # rep 5, a ragged chunk past pad rows
])
def test_gqa_kernel_at_the_guard_and_upsampler_shapes(gen, int8, B, Lq, Lk, Hq, Hkv, offset,
                                                      start):
    """K8 at rep 4, rep 1 (the decode's m16 tile holds one real row, and
    gqa_plan divides the CTAs by B * Hkv = 32) and rep 5, over caches of
    the guards' capacity, against its plain version on every row that sees
    a key (bf16 atol 2e-2, the decode also relative to mean |plain|)."""
    q, k, v, ks, vs = _gqa_inputs(gen, B, Lq, Lk, Hq, Hkv, 128, torch.bfloat16, int8)
    kv_start = None if start is None else torch.tensor(start, device="cuda")
    route = kcuda.gqa_route(q, k, v, int8)
    assert route == ("decode" if Lq * Hq // Hkv <= 16 else "mma_sync" if int8 else "wgmma")
    if route == "decode":
        splits = kcuda.gqa_plan(B, Lq, Hq, Hkv, Lk, kcuda._sm_count(0), int8)
        want = kcuda.GQA_DECODE_CTAS_PER_SM[int8] * kcuda._sm_count(0) // (B * Hkv)
        assert splits == max(1, min(want, -(-Lk // kcuda.GQA_TILE_KEYS)))
    kernels.reset_launch_counts()
    out = kernels.gqa_attention(q, k, v, offset, kv_start, ks, vs)
    again = kernels.gqa_attention(q, k, v, offset, kv_start, ks, vs)
    torch.cuda.synchronize()
    assert kernels.launch_counts["K8"] == 2 and torch.equal(out, again)
    ref = reference.gqa_attention_reference(q, k, v, offset, kv_start, ks, vs)
    seen = torch.ones((B, Lq), dtype=torch.bool, device="cuda")
    if kv_start is not None:
        seen = (offset + torch.arange(Lq, device="cuda"))[None] >= kv_start[:, None]
    assert torch.allclose(out[seen].float(), ref[seen].float(), atol=2e-2, rtol=0)
    if route == "decode":
        assert _within_decode_tol(out[seen], ref[seen]), _rel_errs(out[seen], ref[seen])
    assert (out[~seen] == 0).all()


@pytest.mark.parametrize("case", ["siglip self", "siglip probe", "pixtral"])
def test_k1vit_at_the_vision_shapes(gen, case):
    """kernels.attention counted "K1vit" at SigLIP so400m's fp32 shapes (d =
    72, zero-padded to 128 in attention_f32.cu: the self-attention on views
    of one projection, the pooling head's one probe query over 729 keys;
    atol 1e-4) and Pixtral-12B's bf16 tower (d = 64, the wgmma body; atol
    2e-2)."""
    if case == "pixtral":
        q, k, v = (torch.randn((2240, 1024), generator=gen, device="cuda").to(torch.bfloat16)
                   .reshape(1, 2240, 16, 64) for _ in range(3))
        atol, route = 2e-2, "wgmma"
    else:
        x = torch.randn((2, 729, 3 * 1152), generator=gen, device="cuda")
        q, k, v = (t.reshape(2, 729, 16, 72) for t in x.chunk(3, dim=-1))
        if case == "siglip probe":
            q = torch.randn((2, 1, 16, 72), generator=gen, device="cuda")
        atol, route = 1e-4, "fp32"
    assert kcuda.attention_route(q, k, v) == route
    kernels.reset_launch_counts()
    out = kernels.attention(q, k, v, kernel_id="K1vit")
    torch.cuda.synchronize()
    assert kernels.launch_counts["K1vit"] == 1
    assert kernels.route_counts["wgmma"] == (route == "wgmma")
    assert (out.float() - attention_reference(q, k, v).float()).abs().max().item() <= atol


def _dout_layout(dout: torch.Tensor, layout: str) -> torch.Tensor:
    """dout as given ("contiguous"), as every other head of a tensor twice
    as wide ("strided": a view a tensor map cannot take whole), or
    contiguous from 2 bytes into its storage ("offset": off 16-byte
    alignment); the same values."""
    if layout == "contiguous":
        return dout
    if layout == "strided":
        wide = torch.zeros((*dout.shape[:2], 2 * dout.shape[2], dout.shape[3]),
                           dtype=dout.dtype, device=dout.device)
        wide[:, :, ::2] = dout
        return wide[:, :, ::2]
    flat = torch.empty(dout.numel() + 1, dtype=dout.dtype, device=dout.device)
    out = flat[1:].view(dout.shape)
    out.copy_(dout)
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Lq,Lk,Hq,Hkv,d,offset,start,layout", [
    (1, 200, 200, 8, 2, 128, 0, None, "contiguous"),      # causal prefill, rep 4
    (1, 200, 200, 4, 4, 32, 0, None, "contiguous"),       # causal, rep 1, d 32
    (2, 130, 130, 4, 4, 64, 0, [0, 50], "contiguous"),    # left padding: rows that see no key
    (2, 70, 150, 6, 3, 40, 80, [7, 120], "contiguous"),   # a causal offset, d off the MMA depth
    (1, 90, 33, 8, 2, 32, None, None, "contiguous"),      # the cross-attention (no causal mask)
    (2, 45, 33, 4, 2, 128, None, [3, 33], "contiguous"),  # non-causal, one row with no key at all
    (2, 1000, 200, 8, 2, 64, None, [0, 37], "contiguous"),  # a long query axis: split dK/dV
    (1, 300, 300, 8, 2, 128, 0, None, "strided"),         # dout a strided view (autograd's)
    (1, 300, 300, 8, 2, 128, 0, None, "offset"),          # dout off 16-byte alignment
    (1, 150, 150, 10, 2, 64, 0, None, "contiguous"),      # rep 5
    (1, 1, 5, 8, 2, 128, None, None, "contiguous"),       # one query at rep 4: Lq rep <= 16
    (1, 3, 3, 8, 2, 128, 0, None, "contiguous"),          # three tokens
    (2, 4, 4, 8, 2, 128, 0, [0, 1], "contiguous"),        # four tokens, left padding
    (1, 1, 40, 8, 2, 128, 39, None, "contiguous"),        # one query over a longer cache
    (1, 100, 100, 4, 2, 36, 0, None, "contiguous"),       # d 36 at rep 2: padded to 40
    (2, 3, 3, 4, 2, 36, 0, [0, 1], "strided"),            # short and padded
])
def test_gqa_backward_kernel(gen, dtype, B, Lq, Lk, Hq, Hkv, d, offset, start, layout):
    """K8bwd through ``kernels.gqa_attention`` under autograd (K8's forward
    with lse, then K8bwd): the leaves' gradients against
    ``gqa_attention_backward_reference`` (fp32) with dout zero on the rows
    that see no key (the plain version averages every key there, the kernel
    adds nothing: those rows get dq 0, and every gradient stays finite).
    bf16: the largest error within 2e-2 of the largest |gradient| (P and dS
    enter the tensor cores in bf16, the outputs round to bf16), fp32 within
    1e-5. The long query axis over 200 keys takes a split dK/dV grid
    (``cuda.gqa_bwd_plan`` > 1); dout may come strided or off alignment,
    as autograd may hand it. The short query axes (Lq * rep <= 16, a decode
    body's shape) and d 36 (zero-padded to 40 in the wrappers) run the
    same wgmma bodies in bf16."""
    q, k, v, _, _ = _gqa_inputs(gen, B, Lq, Lk, Hq, Hkv, d, dtype, False)
    kv_start = None if start is None else torch.tensor(start, device="cuda")
    dout = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    if Lq == 1000:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        assert kcuda.gqa_bwd_plan(B, Lq, Lk, Hq, Hkv, offset, sms) > 1
    lo = torch.zeros(B, dtype=torch.long, device="cuda") if start is None else kv_start
    last = (torch.arange(Lq, device="cuda") + (offset if offset is not None else Lk)).clamp(
        max=Lk - 1)
    none = last[None] < lo[:, None]  # (B, Lq): rows that see no key
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(kernels.launch_counts)
    out = kernels.gqa_attention(*leaves, offset, kv_start)
    torch.autograd.backward(out, _dout_layout(dout, layout))
    assert kernels.launch_counts["K8"] == before["K8"] + 1
    assert kernels.launch_counts["K8bwd"] == before["K8bwd"] + 1
    for t in leaves:
        assert torch.isfinite(t.grad).all()
    assert (leaves[0].grad[none] == 0).all() and (out.detach()[none] == 0).all()
    dout = dout.masked_fill(none[:, :, None, None], 0)
    want = reference.gqa_attention_backward_reference(q.float(), k.float(), v.float(),
                                                      dout.float(), offset, kv_start)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    for t, w in zip(leaves, want):
        assert (t.grad.float() - w).abs().max() <= tol * w.abs().max() + 1e-6


@pytest.mark.parametrize("B,Lq,Lk,Hq,Hkv,d,offset,start", [
    (1, 2048, 256, 32, 8, 128, None, None),   # the cross-attention's widths, 2 key tiles
    (2, 700, 200, 10, 2, 64, 100, [0, 150]),  # causal after an offset, rep 5, padding
])
def test_gqa_backward_split_repeats_its_bits_and_counts_its_route(gen, B, Lq, Lk, Hq, Hkv, d,
                                                                  offset, start):
    """A bf16 K8bwd call whose dK/dV grid is split (``gqa_bwd_plan`` > 1):
    two calls give the same bits (the splits' fp32 partial sums are added in
    split order, no atomics), each bf16 call adds one to
    ``route_counts["wgmma"]`` and none to "mma_sync", and the result holds
    the plain version within 2e-2 of the largest |gradient|."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert kcuda.gqa_bwd_plan(B, Lq, Lk, Hq, Hkv, offset, sms) > 1
    q, k, v, _, _ = _gqa_inputs(gen, B, Lq, Lk, Hq, Hkv, d, torch.bfloat16, False)
    kv_start = None if start is None else torch.tensor(start, device="cuda")
    dout = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    out, lse = kcuda.gqa_attention_fwd_lse(q, k, v, offset, kv_start)
    last = (torch.arange(Lq, device="cuda") + (offset if offset is not None else Lk)).clamp(
        max=Lk - 1)
    lo = torch.zeros(B, dtype=torch.long, device="cuda") if start is None else kv_start
    dout = dout.masked_fill((last[None] < lo[:, None])[:, :, None, None], 0)
    before = dict(kernels.route_counts)
    first = kcuda.gqa_attention_bwd(q, k, v, out, dout, lse, offset, kv_start)
    second = kcuda.gqa_attention_bwd(q, k, v, out, dout, lse, offset, kv_start)
    torch.cuda.synchronize()
    assert kernels.route_counts["wgmma"] == before["wgmma"] + 2
    assert kernels.route_counts["mma_sync"] == before["mma_sync"]
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    want = reference.gqa_attention_backward_reference(q.float(), k.float(), v.float(),
                                                      dout.float(), offset, kv_start)
    for t, w in zip(first, want):
        assert torch.isfinite(t).all()
        assert (t.float() - w).abs().max() <= 2e-2 * w.abs().max() + 1e-6


def test_tensor_map_entries_run_in_fresh_threads(gen):
    """The entries that build TMA tensor maps (the wgmma attention family,
    K8bwd, K7) called first in a thread that has made no CUDA call of its
    own, three threads in a row, as autograd's device thread calls a
    backward: cuTensorMapEncodeTiled is a driver call that needs the
    thread's context, which the library binds itself (each once failed
    there with cudaError 1, the encode's CUDA_ERROR_INVALID_CONTEXT). Each
    result equals the same call's on this thread."""
    import threading

    q, k, v, _, _ = _gqa_inputs(gen, 1, 200, 200, 8, 2, 128, torch.bfloat16, False)
    out, lse = kcuda.gqa_attention_fwd_lse(q, k, v, 0)
    dout = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
    x = torch.randn((1, 300, 4, 64), generator=gen, device="cuda").to(torch.bfloat16)
    xo, xl = kcuda.attention_fwd_lse(x, x, x)
    a = torch.randn((256, 512), generator=gen, device="cuda").to(torch.bfloat16)
    aq, asc = kcuda.quantize_rows(a)
    wq, wsc = kcuda.quantize_rows(torch.randn((384, 512), generator=gen, device="cuda"))
    calls = {"K8bwd": lambda: kcuda.gqa_attention_bwd(q, k, v, out, dout, lse, 0),
             "K4": lambda: kcuda.attention_bwd(x, x, x, xo, xo, xl),
             "K1": lambda: (kcuda.attention(x, x, x),),
             "K7": lambda: (kcuda.int8_gemm(aq, wq, asc, wsc, torch.bfloat16),)}
    want = {name: fn() for name, fn in calls.items()}
    torch.cuda.synchronize()
    for i in range(3):
        got, errors = {}, {}

        def run():
            for name, fn in calls.items():
                try:
                    got[name] = fn()
                    torch.cuda.synchronize()
                except Exception as e:  # noqa: BLE001 - reported below
                    errors[name] = repr(e)

        t = threading.Thread(target=run)
        t.start()
        t.join()
        assert not errors, (i, errors)
        for name, ref in want.items():
            assert all(torch.equal(a, b) for a, b in zip(got[name], ref)), (i, name)
