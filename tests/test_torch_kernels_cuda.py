"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips unless CUDA is available (decided inside
the test, never at import). Run on a GPU machine with

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda

Shapes cover what the wrappers promise: bf16 and fp32, head dims from 8 to
128 (zero-padded to the MMA depth), ragged Lq and Lk, strided inputs, and
several splat groups in one launch. Tolerances: bf16 outputs of fp32
softmaxes (atol 2e-2), fp32 (atol 1e-4), atomic fp32 splat sums (1e-4 on
pixels both call known, masks on >= 99.9% of pixels).
"""

import pytest
import torch

from gen3c_tpu_torch import kernels
from gen3c_tpu_torch.kernels.reference import attention_reference, splat_reference

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
