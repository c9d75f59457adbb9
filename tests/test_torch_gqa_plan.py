"""K8's and K8bwd's launch plans on the CPU: the decode's key splits, the
routes, and the backward's dK/dV units and splits.

The decode body (``kernels/csrc/gqa_attention.cu``) launches one grid a
layer whose size follows the cache's capacity and the SM count, never the
position, and cuts the visible keys into ``splits`` ranges by
``cuda.gqa_split_range``'s arithmetic. Here the plan is held to that: the
same splits at every position, every visible key in exactly one range, a
grid that fills the card, and one split for a prefill; and ``gqa_route``
to the body each call shape takes.

K8bwd's dK/dV kernel (``attention_wgmma.cu``'s backward pair in its kGqa
mode) walks, for each key tile, the units of ``cuda.gqa_bwd_units``, its
split s taking run s of ``gqa_split_range(s, splits, 0, units)``, with
``gqa_bwd_plan``'s splits. Here the enumeration is held to a brute-force numpy mask of K8's
visibility (causal offset, kv_start): across the splits every (rep head,
query tile) whose rows see a key of the tile is visited once, and nothing
else.
"""

import inspect

import numpy as np
import pytest
import torch

from gen3c_tpu_torch.kernels import cuda as kcuda


@pytest.mark.parametrize("B,Hq,Hkv,Lk,sms", [
    (1, 32, 8, 12800, 132),  # the 4B's decode
    (2, 32, 8, 12800, 132),
    (4, 32, 8, 12800, 114),
    (1, 4, 2, 300, 132),     # a cache shorter than the grid wants
    (1, 12, 4, 77, 132),     # the T5 cross-attention's 77 keys
    (40, 32, 8, 4096, 132),  # more (batch, KV head) pairs than CTAs wanted
])
@pytest.mark.parametrize("Lq", [1, 2, 4])
@pytest.mark.parametrize("int8", [False, True])
def test_gqa_decode_splits_ignore_the_position_and_cover_each_key_once(B, Hq, Hkv, Lk, sms,
                                                                       Lq, int8):
    assert "pos" not in inspect.signature(kcuda.gqa_plan).parameters
    splits = kcuda.gqa_plan(B, Lq, Hq, Hkv, Lk, sms, int8)
    assert 1 <= splits <= -(-Lk // kcuda.GQA_TILE_KEYS)
    slots = kcuda.GQA_DECODE_CTAS_PER_SM[int8] * sms  # the CTAs the card takes at once
    if Lk >= kcuda.GQA_TILE_KEYS * slots and B * Hkv <= slots:
        assert slots - B * Hkv < splits * B * Hkv <= slots  # one wave that fills the card
    for lo in (0, 3, Lk // 2):
        for pos in sorted({0, 1, 10, lo, Lk // 3, Lk - 2, Lk - 1}):
            hi = min(Lk, pos + Lq)
            keys = []
            for s in range(splits):
                begin, end = kcuda.gqa_split_range(s, splits, min(lo, hi), hi)
                assert begin <= end
                keys += range(begin, end)
            assert keys == list(range(min(lo, hi), hi)), (lo, pos)


@pytest.mark.parametrize("Lq,Hq,Hkv", [(5, 32, 8), (5120, 32, 8), (17, 1, 1), (2, 32, 2)])
def test_gqa_prefill_takes_one_split(Lq, Hq, Hkv):
    assert Lq * (Hq // Hkv) > kcuda.GQA_DECODE_ROWS
    assert kcuda.gqa_plan(1, Lq, Hq, Hkv, 12800, 132, False) == 1
    assert kcuda.gqa_plan(1, Lq, Hq, Hkv, 12800, 132, True) == 1


def _qkv(Lq, Hq, Hkv, d, dtype=torch.bfloat16, kv_dtype=None):
    q = torch.zeros((1, Lq, Hq, d), dtype=dtype)
    k = torch.zeros((1, 96, Hkv, d), dtype=kv_dtype or dtype)
    return q, k, k.clone()


@pytest.mark.parametrize("shape,dtype,int8,route", [
    ((1, 32, 8, 128), torch.bfloat16, False, "decode"),  # one query, rep 4: 4 rows
    ((4, 32, 8, 128), torch.bfloat16, True, "decode"),   # 16 rows
    ((5, 32, 8, 128), torch.bfloat16, False, "wgmma"),   # 20 rows: the prefill
    ((5, 32, 8, 128), torch.bfloat16, True, "mma_sync"),  # int8 codes
    ((40, 4, 4, 20), torch.bfloat16, False, "mma_sync"),  # d off the 16-byte rows
    ((1, 32, 8, 128), torch.float32, False, "fp32"),
    ((40, 4, 2, 64), torch.float32, True, "fp32"),
])
def test_gqa_route(shape, dtype, int8, route):
    Lq, Hq, Hkv, d = shape
    q, k, v = _qkv(Lq, Hq, Hkv, d, dtype, torch.int8 if int8 else None)
    assert kcuda.gqa_route(q, k, v, int8) == route


def test_gqa_route_off_alignment_takes_mma_sync():
    """A bf16 prefill whose q starts off 16 bytes: no tensor map, gqa_mma."""
    q, k, v = _qkv(40, 8, 2, 64)
    q_off = torch.zeros(1 * 40 * 8 * 64 + 1, dtype=torch.bfloat16)[1:].view(1, 40, 8, 64)
    assert kcuda.gqa_route(q, k, v, False) == "wgmma"
    assert kcuda.gqa_route(q_off, k, v, False) == "mma_sync"


def _visible(Lq, Lk, offset, kv_start):
    """K8's mask, brute force: (Lq, Lk) bool, key j visible to query i iff
    kv_start <= j and (no causal offset or j <= offset + i)."""
    i, j = np.arange(Lq)[:, None], np.arange(Lk)[None, :]
    return (j >= kv_start) & ((i >= 0) if offset is None else (j <= offset + i))


@pytest.mark.parametrize("Lq,Lk", [(70, 300), (64, 128), (1000, 200), (33, 1)])
@pytest.mark.parametrize("offset", [None, 0, 80, 400])
@pytest.mark.parametrize("kv_start", [0, 7, 130, 299])
@pytest.mark.parametrize("rep", [1, 4, 5])
def test_gqa_bwd_units_visit_each_seen_tile_once(Lq, Lk, offset, kv_start, rep):
    """One split, three and more splits than units (the last ones empty)."""
    vis = _visible(Lq, Lk, offset, kv_start)
    nq, nk = kcuda.GQA_BWD_QUERIES, kcuda.GQA_BWD_KEYS
    for tile in range(-(-Lk // nk)):
        units = kcuda.gqa_bwd_units(Lq, Lk, rep, offset, kv_start, tile)
        seen = {(r, mt) for r in range(rep) for mt in range(-(-Lq // nq))
                if vis[mt * nq:(mt + 1) * nq, tile * nk:(tile + 1) * nk].any()}
        assert len(set(units)) == len(units) and set(units) == seen, tile
        for splits in (1, 3, 50):
            visited = []
            for s in range(splits):
                begin, end = kcuda.gqa_split_range(s, splits, 0, len(units))
                assert 0 <= begin <= end <= len(units)
                visited += units[begin:end]
            assert visited == units, (tile, splits)  # each unit once, in order


@pytest.mark.parametrize("B,Lq,Lk,Hq,Hkv,offset", [
    (1, 12800, 12800, 32, 8, 0),     # the 4B's training shape: 800 CTAs
    (1, 12800, 512, 32, 8, None),    # the cross-attention's 512 keys: 32 CTAs
    (2, 2048, 2048, 32, 8, 0),       # the left-padded batch: 256 CTAs
    (1, 200, 200, 4, 4, 0),          # rep 1: 8 CTAs, 7 units
    (1, 40, 100, 5, 1, 3),           # rep 5: one CTA, 10 units
    (3, 1000, 300, 8, 2, None),
])
@pytest.mark.parametrize("sms", [132, 114])
def test_gqa_bwd_plan_fills_the_card_in_one_wave(B, Lq, Lk, Hq, Hkv, offset, sms):
    splits = kcuda.gqa_bwd_plan(B, Lq, Lk, Hq, Hkv, offset, sms)
    ctas = -(-Lk // kcuda.GQA_BWD_KEYS) * Hkv * B
    units = len(kcuda.gqa_bwd_units(Lq, Lk, Hq // Hkv, offset, 0, 0))
    assert 1 <= splits <= max(1, units)
    if ctas >= sms:
        assert splits == 1
    else:
        assert splits * ctas <= sms  # one wave
        assert splits == units or (splits + 1) * ctas > sms  # no room for another split


def test_gqa_bwd_plan_at_the_4b_shapes():
    """No workspace at the 4B's 12,800 keys; a split grid over the
    cross-attention's 512 keys on 132 SMs (4 key tiles x 8 KV heads)."""
    assert (kcuda.GQA_BWD_KEYS, kcuda.GQA_BWD_QUERIES) == (128, 32)
    assert kcuda.gqa_bwd_plan(1, 12800, 12800, 32, 8, 0, 132) == 1
    assert kcuda.gqa_bwd_plan(1, 12800, 512, 32, 8, None, 132) == 4
    assert "kv_start" not in inspect.signature(kcuda.gqa_bwd_plan).parameters


@pytest.mark.parametrize("Lq,Hq,Hkv,d", [(1, 32, 8, 128), (4, 32, 8, 128), (3, 8, 2, 36),
                                         (200, 8, 2, 128)])
def test_gqa_training_forward_takes_wgmma_at_every_shape(Lq, Hq, Hkv, d):
    """K8's bf16 forward with lse runs the wgmma body whatever the query
    axis (a decode's Lq * rep <= 16 included) and head width (padded to a
    multiple of 8 first); the inference forward still picks by shape."""
    q = torch.empty((1, Lq, Hq, kcuda.gqa_train_width(d)), dtype=torch.bfloat16, device="meta")
    k = torch.empty((1, 300, Hkv, q.shape[3]), dtype=torch.bfloat16, device="meta")
    assert kcuda.gqa_route(q, k, k, False, lse=True) == "wgmma"
    short = Lq * (Hq // Hkv) <= kcuda.GQA_DECODE_ROWS
    assert kcuda.gqa_route(q, k, k, False) == ("decode" if short else "wgmma")
    assert kcuda.gqa_route(q.float(), k.float(), k.float(), False, lse=True) == "fp32"


@pytest.mark.parametrize("d,want", [(8, 8), (36, 40), (20, 24), (127, 128), (128, 128), (1, 8)])
def test_pad_head_widens_to_whole_tma_rows(d, want):
    assert kcuda.gqa_train_width(d) == want
    t = torch.randn(2, 3, 4, d).to(torch.bfloat16)
    p = kcuda.pad_head(t, want)
    assert p.shape == (2, 3, 4, want) and p.is_contiguous() and p.data_ptr() % 16 == 0
    assert torch.equal(p[..., :d], t) and not p[..., d:].any()
    assert kcuda.tma_describable(p)


@pytest.mark.parametrize("causal,start", [(0, None), (2, [0, 3]), (None, [1, 0])])
def test_padded_heads_at_the_unpadded_scale_give_the_plain_gradient(causal, start):
    """What the wrappers do around the kernels, on the plain versions: the
    head axis zero-padded from 36 to 40, the logits scaled by 1/sqrt(36),
    the results sliced back, equal the unpadded forward and backward; the
    padded width's own scale would not."""
    from gen3c_tpu_torch.kernels import reference

    g = torch.Generator().manual_seed(3)
    B, Lq, Lk, Hq, Hkv, d = 2, 4, 6, 8, 2, 36
    q = torch.randn((B, Lq, Hq, d), generator=g, dtype=torch.float64)
    k, v = (torch.randn((B, Lk, Hkv, d), generator=g, dtype=torch.float64) for _ in range(2))
    dout = torch.randn(q.shape, generator=g, dtype=torch.float64)
    kv = None if start is None else torch.tensor(start)
    dp = kcuda.gqa_train_width(d)
    padded = [kcuda.pad_head(t, dp) for t in (q, k, v, dout)]
    want = reference.gqa_attention_reference(q, k, v, causal, kv)
    got = reference.gqa_attention_reference(*padded[:3], causal, kv, scale=d ** -0.5)
    torch.testing.assert_close(got[..., :d], want, rtol=1e-12, atol=1e-12)
    assert not got[..., d:].any()
    wrong = reference.gqa_attention_reference(*padded[:3], causal, kv)
    assert (wrong[..., :d] - want).abs().max() > 1e-3
    want_g = reference.gqa_attention_backward_reference(q, k, v, dout, causal, kv)
    got_g = reference.gqa_attention_backward_reference(*padded, causal, kv, scale=d ** -0.5)
    for a, b in zip(got_g, want_g):
        torch.testing.assert_close(a[..., :d], b, rtol=1e-12, atol=1e-12)
