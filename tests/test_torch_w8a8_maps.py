"""K7's operands and their 2-d TMA tensor maps, on the CPU.

K7 (csrc/w8a8.cu's w8a8_gemm_wgmma) reads both int8 operands through 2-d
tensor maps. ``cuda.w8a8_operand`` hands it each operand as it is where a
map describes it, else a copy in rows of K rounded up to 16 bytes;
``cuda.w8a8_map_params`` gives the words of each map: dims, row stride,
box and swizzle. Both are pure Python over shapes, strides and addresses,
so they are held here at the shapes the port calls on the card (meta
tensors for the 7B, whose address reads 0): the GEN3C-7B linears at both
CFG batch sizes, the tiny preset's widths, and layouts no map takes.
"""

import pytest
import torch

from gen3c_tpu_torch.kernels import cuda as kcuda

TOKENS_7B = 56320  # latent tokens of one 121-frame 704x1280 chunk
# (K, N) of the 7B's W8A8 linears: FA/CA q/k/v/out, fc1, fc2, and the CA k/v
# over the 1,024-wide T5 embeddings
SHAPES_7B = {"qkv_out": (4096, 4096), "fc1": (4096, 16384), "fc2": (16384, 4096),
             "cross_kv": (1024, 4096)}


def _meta(rows, k):
    return torch.empty((rows, k), dtype=torch.int8, device="meta")


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("name", sorted(SHAPES_7B))
def test_7b_linears_are_mapped_as_they_are(name, batch):
    """Every K7 shape of the 7B fast path, at B = 2 (the CFG pair) and B = 1
    (condition-only steps): K7q's contiguous codes and the stored weight go
    to TMA uncopied."""
    K, N = SHAPES_7B[name]
    M = batch * (512 if name == "cross_kv" else TOKENS_7B)
    xq, wq = _meta(M, K), _meta(N, K)
    assert kcuda.w8a8_operand(xq) is xq and kcuda.w8a8_operand(wq) is wq
    mx, mw = (kcuda.w8a8_map_params(t, rows) for t, rows in zip((xq, wq), kcuda.W8A8_BOX_ROWS))
    assert mx == {"dims": [K, M], "strides": [K], "box": [128, 128], "swizzle": 128}
    assert mw == {"dims": [K, N], "strides": [K], "box": [128, 256], "swizzle": 128}
    assert kcuda.W8A8_BOX_ROWS == (128, 256) and kcuda.W8A8_BOX_BYTES == 128


@pytest.mark.parametrize("k,n", [(96, 96), (96, 384), (384, 96), (1024, 96)])
def test_tiny_preset_widths_are_mapped_as_they_are(k, n):
    """gen3c_tiny (96 channels, MLP 384, 1,024-wide text): 16-byte rows."""
    xq = torch.zeros((2 * 60, k), dtype=torch.int8)
    wq = torch.zeros((n, k), dtype=torch.int8)
    assert kcuda.w8a8_operand(xq) is xq and kcuda.w8a8_operand(wq) is wq
    assert kcuda.w8a8_map_params(wq, 256)["strides"] == [k]


def test_ragged_k_in_aligned_rows_is_mapped_as_it_is():
    """K = 1,000 read from rows of 1,024 bytes: the map's dims say 1,000, so
    TMA zero-fills the rest of the last box; the stride is the pitch."""
    xq = torch.zeros((300, 1024), dtype=torch.int8)[:, :1000]
    assert kcuda.w8a8_operand(xq) is xq
    m = kcuda.w8a8_map_params(xq, 128)
    assert m["dims"] == [1000, 300] and m["strides"] == [1024]


def test_one_row_gets_a_made_up_stride():
    """A single row has no row stride to check: the map gets K rounded up to
    16 bytes, which the encoder takes."""
    xq = torch.zeros((1, 1000), dtype=torch.int8)
    assert kcuda.w8a8_operand(xq) is xq
    assert kcuda.w8a8_map_params(xq, 128)["strides"] == [1008]


@pytest.mark.parametrize("make", [
    lambda: torch.arange(8 * 1000).view(8, 1000).to(torch.int8),  # rows of 1,000 bytes
    lambda: torch.arange(8 * 1001).view(8, 1001).to(torch.int8)[:, :1000],  # pitch 1,001
    lambda: torch.arange(8 * 64 + 1).to(torch.int8)[1:].view(8, 64),  # base off 16 bytes
    lambda: torch.arange(64 * 8).view(64, 8).to(torch.int8).t(),  # stride along K
    lambda: torch.arange(64).view(1, 64).to(torch.int8).expand(8, 64),  # zero row stride
    lambda: torch.arange(3 * 5).view(3, 5).to(torch.int8),  # K under 16
])
def test_layouts_no_map_takes_are_copied_into_16_byte_rows(make):
    """A row stride that is not a 16-byte multiple, an unaligned base, a
    stride along K, a zero stride: no tensor map, so K7 reads a copy whose
    rows are K rounded up to 16 bytes, with the same values and a map whose
    K is the true K (TMA zero-fills the pad, whatever it holds)."""
    bad = make()
    rows, k = bad.shape
    with pytest.raises(ValueError):
        kcuda.w8a8_map_params(bad, 128)
    good = kcuda.w8a8_operand(bad)
    assert good is not bad and torch.equal(good, bad)
    pitch = -(-k // 16) * 16
    assert good.stride() == (pitch, 1) and good.data_ptr() % 16 == 0
    assert kcuda.w8a8_map_params(good, 256) == {
        "dims": [k, rows], "strides": [pitch], "box": [128, 256], "swizzle": 128}


def test_other_dtypes_have_no_map():
    with pytest.raises(ValueError):
        kcuda.w8a8_map_params(torch.zeros((8, 64), dtype=torch.int32), 128)
