"""The attention route and the TMA tensor maps, on the CPU.

``cuda.attention_route`` picks the body every bf16 attention entry runs:
"wgmma" (csrc/attention_wgmma.cu, TMA loads) where a tensor map describes
every tensor of the call, else "mma_sync". ``cuda.tensor_map_params`` gives
the words of that map: dims, byte strides, box and swizzle. Both are pure
Python over shapes, strides and addresses, so they are held here at the
shapes the port calls on the card (meta tensors for the 7B, whose address
reads 0): the 7B self- and cross-attention shapes, K1cp's all-to-all
views, K1ag's gathered keys, the tiny presets' head dim 24, and layouts
that TMA cannot take.
"""

import pytest
import torch

from gen3c_tpu_torch import kernels
from gen3c_tpu_torch.kernels import cuda as kcuda

L7B, H7B, D7B = 56320, 32, 128


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _ulysses_view(x, cp, rank):
    """Rank ``rank``'s heads of x (B, L, H, D) as collectives.seq_to_heads
    leaves them: a view of the all-to-all's (cp, L/cp, B, H/cp, D) receive
    buffer (the layout chip_smoke.py and test_torch_kernels_cuda.py use)."""
    B, L, H, D = x.shape
    hc = H // cp
    buf = torch.empty((cp, L // cp, B, hc, D), dtype=x.dtype, device=x.device)
    return buf.view(L, B, hc, D).permute(1, 0, 2, 3)


@pytest.mark.parametrize("B", [1, 2])
def test_7b_self_attention_takes_wgmma(B):
    q = _meta((B, L7B, H7B, D7B))
    assert kcuda.attention_route(q, q, q) == "wgmma"
    m = kcuda.tensor_map_params(q, 128)
    row = D7B * 2
    assert m["dims"][:3] == [D7B, H7B, L7B]
    assert m["strides"][:2] == [row, row * H7B]
    assert m["box"][:3] == [kcuda.TMA_BOX_COLS, 1, 128] and m["swizzle"] == 128
    if B == 2:
        assert m["dims"][3] == 2 and m["strides"][2] == row * H7B * L7B
        assert m["order"] == 0 | (1 << 2) | (2 << 4)  # head, sequence, batch
    else:  # a batch of one goes last, its stride the extent so far
        assert m["dims"][3] == 1 and m["strides"][2] == row * H7B * L7B
    assert all(s % 16 == 0 and s < 2 ** 40 for s in m["strides"])
    assert m["box"][3] == 1


def test_7b_cross_attention_takes_wgmma():
    """K2: 56,320 queries over 512 text keys; each map has its own box rows."""
    q, k = _meta((2, L7B, H7B, D7B)), _meta((2, 512, H7B, D7B))
    assert kcuda.attention_route(q, k, k) == "wgmma"
    for t, rows in zip((q, k, k), kcuda.WGMMA_FWD_BOX_ROWS):
        m = kcuda.tensor_map_params(t, rows)
        assert m["dims"][2] == t.shape[1] and m["box"][2] == rows
    assert kcuda.WGMMA_FWD_BOX_ROWS == (128, 64, 64)


@pytest.mark.parametrize("cp", [2, 4, 8])
def test_k1cp_all_to_all_view_takes_wgmma(cp):
    """K1cp reads the all-to-all's receive buffer in place: a (B, L, H/cp,
    D) view whose batch stride is below its sequence stride. The map sorts
    the dims by stride and records the order."""
    x = _meta((2, L7B, H7B, D7B))
    view = _ulysses_view(x, cp, 0)
    hc = H7B // cp
    assert view.shape == (2, L7B, hc, D7B) and not view.is_contiguous()
    assert view.stride() == (hc * D7B, 2 * hc * D7B, D7B, 1)
    assert kcuda.attention_route(view, view, view) == "wgmma"
    m = kcuda.tensor_map_params(view, 64)
    row = D7B * 2
    assert m["dims"] == [D7B, hc, 2, L7B]
    assert m["strides"] == [row, row * hc, row * hc * 2]
    assert m["box"] == [64, 1, 1, 64]
    assert m["order"] == 0 | (2 << 2) | (1 << 4)  # head, batch, sequence


def test_k1ag_gathered_keys_take_wgmma():
    """K1ag: a query shard over keys laid out (L, B, H, D) by the gather."""
    q = _meta((2, L7B // 2, H7B, D7B))
    k = _meta((L7B, 2, H7B, D7B)).transpose(0, 1)
    assert kcuda.attention_route(q, k, k) == "wgmma"
    assert kcuda.tensor_map_params(k, 64)["order"] == 0 | (2 << 2) | (1 << 4)


@pytest.mark.parametrize("lq,lk", [(1000, 1000), (1000, 333), (250, 37), (1, 1)])
def test_tiny_head_dim_24_takes_wgmma(lq, lk):
    """The tiny presets' D = 24: 48-byte rows, a 16-byte multiple; the box
    still spans 64 elements of D (zero-filled past 24)."""
    q, k = torch.zeros((2, lq, 4, 24), dtype=torch.bfloat16), torch.zeros((2, lk, 4, 24),
                                                                          dtype=torch.bfloat16)
    assert kcuda.attention_route(q, k, k) == "wgmma"
    for t, rows in zip((q, k, k), kcuda.WGMMA_FWD_BOX_ROWS):
        m = kcuda.tensor_map_params(t, rows)
        assert m["dims"][0] == 24 and m["box"][0] == 64 and m["strides"][0] == 48


def test_fp32_takes_no_route():
    q = torch.zeros((2, 10, 3, 24))
    assert kcuda.attention_route(q, q, q) == "fp32"


@pytest.mark.parametrize("make,whole", [
    # MoGe's q, k, v: fp32 views of one qkv projection, rows of 3,072 floats
    (lambda: torch.zeros((1, 1351, 3 * 1024)).chunk(3, dim=-1)[1].reshape(1, 1351, 16, 64), True),
    (lambda: torch.zeros((2, 10, 3, 24)), True),  # the tiny preset's fp32 head dim
    (lambda: torch.zeros((2, 10, 3, 22)), False),  # 88-byte rows
    (lambda: torch.zeros((2, 10, 3 * 24 + 1))[..., 1:].view(2, 10, 3, 24), False),  # odd stride
    (lambda: torch.zeros((2, 10, 3, 24), dtype=torch.bfloat16), True),
    (lambda: torch.zeros((2, 10, 3, 20), dtype=torch.bfloat16), False),
])
def test_rows_of_16_bytes(make, whole):
    """attention.cu's and attention_f32.cu's 16-byte copies: rows that start
    16-byte aligned and hold whole 16-byte pieces; else 4-byte (fp32) or
    2-byte (bf16) copies."""
    t = make()
    assert kcuda.rows_of_16_bytes(t, t, t) == whole


@pytest.mark.parametrize("make", [
    lambda: torch.zeros((2, 10, 3, 20), dtype=torch.bfloat16),  # 40-byte rows
    lambda: torch.zeros((2, 10, 3, 32), dtype=torch.bfloat16)[..., :20],
    lambda: torch.zeros((2, 10, 3 * 24 + 4), dtype=torch.bfloat16)[..., :72].view(2, 10, 3, 24),
    lambda: torch.zeros(2 * 10 * 3 * 24 + 4, dtype=torch.bfloat16)[4:].view(2, 10, 3, 24),
    lambda: torch.zeros((1, 10, 1, 24), dtype=torch.bfloat16).expand(2, 10, 3, 24),
    lambda: torch.zeros((2, 10, 3, 256), dtype=torch.bfloat16)[..., ::2],
])
def test_layouts_tma_cannot_take_go_to_mma_sync(make):
    """A head dim that is not a multiple of 8, a stride that is not a
    16-byte multiple (a row pitch of 76 elements), an unaligned base, a
    zero stride, a stride along D: the mma.sync body, and no tensor map."""
    bad = make()
    good = torch.zeros(bad.shape, dtype=torch.bfloat16)
    assert not kcuda.tma_describable(bad)
    assert kcuda.attention_route(good, bad, good) == "mma_sync"
    with pytest.raises(ValueError):
        kcuda.tensor_map_params(bad, 64)


def test_unaligned_stride_is_refused():
    """q/k/v unbound from a packed projection whose row pitch is 3 x 3 x 24
    + 4 elements: 16-byte aligned heads but a sequence stride of 440 bytes."""
    packed = torch.zeros((2, 10, 3 * 3 * 24 + 4), dtype=torch.bfloat16)
    qkv = packed[..., :216].view(2, 10, 3, 3, 24)
    q = qkv[:, :, 0]
    assert q.stride(1) * 2 == 440 and q.stride(1) * 2 % 16
    assert kcuda.attention_route(q, q, q) == "mma_sync"


def test_route_counts_reset_with_the_launch_counts():
    kernels.route_counts["wgmma"] += 3
    kernels.route_counts["mma_sync"] += 1
    kernels.reset_launch_counts()
    assert kernels.route_counts == {"wgmma": 0, "mma_sync": 0}


def test_backward_maps_pair_each_tensor_with_its_box():
    """K4's two kernels read q, k, v and dout through maps of their own box
    rows (dK/dV: 32 queries, 128 keys; dQ: 128 queries, 64 keys), the same
    dims and order for each tensor."""
    q = _meta((1, L7B, H7B, D7B))
    assert kcuda.WGMMA_BWD_BOX_ROWS == (32, 128, 128, 32, 128, 64, 64, 128)
    words = [kcuda.tensor_map_params(q, rows) for rows in kcuda.WGMMA_BWD_BOX_ROWS]
    assert len({(tuple(w["dims"]), tuple(w["strides"]), w["order"]) for w in words}) == 1
    assert [w["box"][2] for w in words] == list(kcuda.WGMMA_BWD_BOX_ROWS)
