"""The plain attention backward (K4's plain version) and the autograd
``attention`` against gen3c_tpu on the CPU.

``attention_backward_reference`` is held to ``jax.vjp`` of
gen3c_tpu.models.dit.attention_op (its XLA path, as the JAX package runs on
the CPU) and to torch autograd through ``attention_reference``, with and
without a temporal band (one band leaves some query rows without a key, as
K3's wrapper refuses on a card and the CPU path still averages), at ragged
unequal Lq/Lk, in fp32: max |delta| <= 1e-5 of the gradient's max |.| (the
same fp32 sums, in another order). Through GeneralDIT, per-block remat
gives bitwise the same loss and gradients as no remat (the same ops run,
only twice).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gen3c_tpu.models import dit as jdit
from gen3c_tpu_torch import kernels
from gen3c_tpu_torch.kernels.reference import (
    attention_backward_reference,
    attention_forward_reference,
    attention_reference,
)
from gen3c_tpu_torch.models import dit as tdit
from gen3c_tpu_torch.pipelines.factory import GEN3C_TINY_PRESET

torch.set_num_threads(2)
REL = 1e-5


def _inputs(seed, lq=37, lk=29, b=2, h=3, d=24):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, lk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, lk, h, d)).astype(np.float32)
    do = rng.standard_normal((b, lq, h, d)).astype(np.float32)
    return q, k, v, do


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max(), (what, err, np.abs(want).max())


BANDS = [None, (7, 1, 1), (5, 0, 0)]  # (5, 0, 0): queries of frames >= 6 see no key


@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("lq,lk", [(37, 29), (30, 30)])
def test_backward_reference_matches_jax_vjp(band, lq, lk):
    q, k, v, do = _inputs(0, lq, lk)
    out_j, vjp = jax.vjp(lambda a, b_, c: jdit.attention_op(a, b_, c, temporal_band=band),
                         *(jnp.asarray(t) for t in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(t) for t in (q, k, v, do))
    out, lse = attention_forward_reference(tq, tk, tv, band)
    _close(out, out_j, "out")
    got = attention_backward_reference(tq, tk, tv, out, tdo, lse, band)
    for name, g, w in zip("qkv", got, want):
        _close(g, w, "d" + name)


@pytest.mark.parametrize("band", BANDS)
def test_backward_reference_matches_torch_autograd(band):
    q, k, v, do = (torch.from_numpy(t) for t in _inputs(1))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(attention_reference(*leaves, band), leaves, do)
    out, lse = attention_forward_reference(q, k, v, band)
    assert torch.equal(out, attention_reference(q, k, v, band))
    got = attention_backward_reference(q, k, v, out, do, lse, band)
    for name, g, w in zip("qkv", got, want):
        _close(g.numpy(), w.numpy(), "d" + name)


def test_lse_is_the_softmax_normalizer():
    q, k, v, _ = (torch.from_numpy(t) for t in _inputs(2))
    _, lse = attention_forward_reference(q, k, v)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(logits, -1).numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("band", [None, (7, 1, 1)])
def test_autograd_attention_on_cpu(band):
    """kernels.attention with inputs that require grad is the autograd
    Function on the CPU too: the same output as without grad, and the
    gradients of autograd through the plain forward."""
    q, k, v, do = (torch.from_numpy(t) for t in _inputs(3))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = kernels.attention(*leaves, kernel_id="K2", band=band)
    assert out.grad_fn is not None
    assert torch.equal(out.detach(), kernels.attention(q, k, v, band=band))
    got = torch.autograd.grad(out, leaves, do)
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(attention_reference(*ref_leaves, band), ref_leaves, do)
    for g, w in zip(got, want):
        _close(g.numpy(), w.numpy(), "grad")


def test_dit_remat_is_bitwise_the_plain_backward():
    cfg = GEN3C_TINY_PRESET.dit
    net = tdit.GeneralDIT(cfg).init_random(torch.Generator().manual_seed(0))
    with torch.no_grad():  # random gates: every block contributes to the output
        g = torch.Generator().manual_seed(1)
        for name, p in net.named_parameters():
            if name.endswith("adaLN_modulation.2.weight") or name == "final_layer.linear.weight":
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    net.requires_grad_(True)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, cfg.in_channels, 2, 8, 12)).astype(np.float32))
    t = torch.from_numpy(rng.uniform(-2, 1, (2,)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 16, 1024)).astype(np.float32))
    results = []
    for remat in (False, True):
        loss = net(x, t, ctx, fps=24.0, remat=remat).square().mean()
        grads = torch.autograd.grad(loss, list(net.parameters()))
        results.append((loss, grads))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert sum(int(a.abs().sum() > 0) for a in g0) == len(g0)  # every leaf has a gradient
