"""RAFT's precision on the card: its backward, like its forward, runs with
TF32 off (``aux/raft.py``'s ``_Fp32Backward``), whatever cuDNN's global
flags say. Marked ``cuda``: skips unless CUDA is available (decided inside
the test). Run on a GPU machine with
``python -m pytest tests/test_torch_raft_card.py -m cuda``."""

import pytest
import torch

from gen3c_tpu_torch.aux import raft


@pytest.mark.cuda
def test_backward_runs_without_tf32_on_the_card():
    """With cuDNN's default (TF32 on) the gradients with respect to both
    frames and a convolution's weight equal those taken with TF32 off
    everywhere, to 1e-5 of each one's largest element (TF32 anywhere in
    the backward would part them by ~1e-3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator().manual_seed(10)
    params = {k: v.cuda() for k, v in raft.init_raft_params(gen).items()}
    frames = (torch.rand((2, 1, 3, 64, 64), generator=gen) * 2 - 1).cuda()
    dflow = torch.randn((1, 2, 64, 64), generator=gen).cuda()
    name = "feature_encoder.convnormrelu.0.weight"

    def grads():
        p = dict(params)
        p[name] = p[name].clone().requires_grad_(True)
        leaves = [f.clone().requires_grad_(True) for f in frames]
        flow = raft.raft_forward(p, *leaves, num_flow_updates=12)
        return torch.autograd.grad(flow, leaves + [p[name]], dflow)

    assert torch.backends.cudnn.allow_tf32
    got = grads()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        want = grads()
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()
