"""The wgmma attention body (csrc/attention_wgmma.cu) on the card.

Marked ``cuda``: each test skips unless CUDA is available (decided inside
the test, never at import). Run on a GPU machine with

    python -m pytest tests/test_torch_attention_wgmma.py -q -m cuda

What the route rule promises (``tests/test_torch_attention_route.py``
holds the rule itself on the CPU): every entry of the bf16 attention family
takes the same body at a given shape and layout, and agrees with its plain
version on either body (wgmma, or mma.sync for what no TMA map describes);
the backward gives the same bits on every call (two kernels owning their
rows, no atomics); and the band holds where a frame edge falls inside a 128-row CTA (hw 100, and
hw 320 = 2.5 x 128 like the 7B's 3,520 = 27.5 x 128). Tolerances as in
test_torch_kernels_cuda.py: bf16 outputs of fp32 softmaxes within 2e-2,
and the backward no further from the fp32 truth than the plain bf16
backward plus 1e-2 (max) / 1e-3 (mean) of mean |.|.
"""

import pytest
import torch

from gen3c_tpu_torch import kernels
from gen3c_tpu_torch.kernels import cuda as kcuda
from gen3c_tpu_torch.kernels.reference import (
    attention_backward_reference,
    attention_forward_reference,
    ring_fold_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(a, ref):
    d = (a.float() - ref.float()).abs()
    m = ref.float().abs().mean()
    return (d.max() / m).item(), (d.mean() / m).item()


def _off_alignment(t):
    """t's values at a base 2 bytes past a 16-byte boundary, which no TMA
    tensor map describes."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def _family_runs(q, k, v, do, band):
    """Each entry of the family at one shape: its outputs and its route counts."""
    runs = {}

    def run(name, fn):
        kernels.reset_launch_counts()
        got = fn()
        torch.cuda.synchronize()
        runs[name] = (got, dict(kernels.route_counts))

    run("attention", lambda: kcuda.attention(q, k, v, band))
    run("fwd_lse", lambda: kcuda.attention_fwd_lse(q, k, v, band))
    run("ring_fold", lambda: kcuda.attention_ring_fold(q, k, v, band, 0, 0))
    out, lse = runs["fwd_lse"][0]
    run("bwd", lambda: kcuda.attention_bwd(q, k, v, out, do, lse, band))
    return runs


@pytest.mark.parametrize("d,off_alignment,want", [(128, False, "wgmma"), (64, False, "wgmma"),
                                                  (24, False, "wgmma"), (20, False, "mma_sync"),
                                                  (128, True, "mma_sync")])
@pytest.mark.parametrize("band", [None, (50, 1, 1)])
def test_every_family_entry_takes_the_same_route(gen, d, off_alignment, want, band):
    """Every entry takes the route of the shape and layout, and on either
    body agrees with its plain version: the mma.sync bodies serve what no
    TMA map describes (D = 20, a base off 16-byte alignment)."""
    q, k, v, do = (torch.randn((2, 200, 3, d), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    if off_alignment:
        q, k, v, do = (_off_alignment(t) for t in (q, k, v, do))
    assert kcuda.attention_route(q, k, v) == want
    runs = _family_runs(q, k, v, do, band)
    for name, (_, got) in runs.items():
        assert got == {"wgmma": int(want == "wgmma"), "mma_sync": int(want == "mma_sync")}, \
            (name, got)
    ref, ref_lse = attention_forward_reference(q, k, v, band)
    out, lse = runs["fwd_lse"][0]
    ring, ring_lse = runs["ring_fold"][0]
    want_ring, want_ring_lse = ring_fold_reference(q, k, v, band, 0, 0)
    for got, plain in ((runs["attention"][0], ref), (out, ref), (ring, want_ring)):
        assert (got.float() - plain.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-2
    assert (ring_lse - want_ring_lse).abs().max().item() <= 1e-2
    plain = attention_backward_reference(q, k, v, out, do, lse, band)
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    o32, l32 = attention_forward_reference(q32, k32, v32, band)
    truth = attention_backward_reference(q32, k32, v32, o32, do32, l32, band)
    for name, g, p, t in zip("qkv", runs["bwd"][0], plain, truth):
        kmax, kmean = _rel(g, t)
        pmax, pmean = _rel(p, t)
        assert kmax <= pmax + 1e-2 and kmean <= pmean + 1e-3, (name, kmax, kmean, pmax, pmean)


def test_strided_views_take_the_route_of_their_layout(gen):
    """q/k/v unbound from a packed projection (16-byte strides): wgmma,
    with the bits of the same values made contiguous."""
    qkv = torch.randn((2, 150, 3, 4, 64), generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = qkv.unbind(dim=2)
    kernels.reset_launch_counts()
    out = kernels.attention(q, k, v)
    want = kernels.attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    assert kernels.route_counts == {"wgmma": 2, "mma_sync": 0}
    assert torch.equal(out, want)


@pytest.mark.parametrize("band", [None, (100, 1, 1), (320, 1, 1)])
@pytest.mark.parametrize("lq,lk,d", [(640, 640, 128), (333, 333, 64), (257, 100, 128)])
def test_backward_gives_equal_bits_twice(gen, band, lq, lk, d):
    if band is not None and lq != lk:
        pytest.skip("the band is self-attention")
    q, k, v, do = (torch.randn((2, n, 3, d), generator=gen, device="cuda").to(torch.bfloat16)
                   for n in (lq, lk, lk, lq))
    out, lse = kcuda.attention_fwd_lse(q, k, v, band)
    first = kcuda.attention_bwd(q, k, v, out, do, lse, band)
    second = kcuda.attention_bwd(q, k, v, out, do, lse, band)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("l,hw,window,prefix", [(700, 100, 1, 1), (1280, 320, 1, 1),
                                                (1280, 320, 0, 0), (960, 320, 2, 1)])
def test_band_edges_inside_a_cta(gen, l, hw, window, prefix):
    """Frame edges inside a 128-row CTA (and, for hw 100, inside 64-row
    groups): forward, forward with lse and backward against the plain
    band versions; a ring step's shard offsets through the same body."""
    band = (hw, window, prefix)
    q, k, v, do = (torch.randn((2, l, 4, 128), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    kernels.reset_launch_counts()
    out, lse = kcuda.attention_fwd_lse(q, k, v, band)
    ref, ref_lse = attention_forward_reference(q, k, v, band)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-2
    assert torch.equal(out, kcuda.attention(q, k, v, band))
    got = kcuda.attention_bwd(q, k, v, out, do, lse, band)
    plain = attention_backward_reference(q, k, v, out, do, lse, band)
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    o32, l32 = attention_forward_reference(q32, k32, v32, band)
    truth = attention_backward_reference(q32, k32, v32, o32, do32, l32, band)
    for name, g, p, t in zip("qkv", got, plain, truth):
        kmax, kmean = _rel(g, t)
        pmax, pmean = _rel(p, t)
        assert kmax <= pmax + 1e-2 and kmean <= pmean + 1e-3, (name, kmax, kmean, pmax, pmean)
    half = l // 2  # the second half's queries over the first half's keys, as a ring step
    ring, ring_lse = kcuda.attention_ring_fold(q[:, half:].contiguous(), k[:, :half].contiguous(),
                                               v[:, :half].contiguous(), band, half, 0)
    want, want_lse = ring_fold_reference(q[:, half:], k[:, :half], v[:, :half], band, half, 0)
    torch.cuda.synchronize()
    assert (ring.float() - want.float()).abs().max().item() <= 2e-2
    seen = torch.isfinite(want_lse)
    assert torch.equal(seen, torch.isfinite(ring_lse))
    assert not seen.any() or (ring_lse[seen] - want_lse[seen]).abs().max().item() <= 1e-2
    assert kernels.route_counts["mma_sync"] == 0
