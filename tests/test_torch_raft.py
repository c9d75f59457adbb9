"""The port's RAFT-Large against gen3c_tpu's on the CPU.

Shared seeded weights (numpy, torchvision names, running stats away from
0 / 1 so that the context encoder's BatchNorm counts) go into both; inputs
are numpy. fp32 on both sides (JAX at Precision.HIGHEST): single ops agree
to 1e-5, the 12-update forward, whose flow feeds back into the lookups'
coordinates, to atol 1e-2 px on flows of +-15 px. The parameter count pins torchvision's
raft_large (5,257,536 trainable).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gen3c_tpu.aux import raft as jr
from gen3c_tpu_torch.aux import raft as tr

torch.set_num_threads(2)


def _state_dict(seed=0):
    rng = np.random.RandomState(seed)
    sd = {}
    for name, shape in tr.raft_state_spec().items():
        if name.endswith("running_var"):
            sd[name] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif name.endswith("running_mean") or name.endswith("bias"):
            sd[name] = (rng.randn(*shape) * 0.05).astype(np.float32)
        elif len(shape) == 1:
            sd[name] = rng.uniform(0.8, 1.2, shape).astype(np.float32)
        else:
            sd[name] = (rng.randn(*shape) * (2.0 / np.prod(shape[1:])) ** 0.5).astype(np.float32)
    return sd


@pytest.fixture(scope="module")
def params():
    sd = _state_dict()
    return jr.convert_raft_state_dict(sd), tr.convert_raft_state_dict(sd)


def _pair(seed, n=1, h=64, w=64):
    rng = np.random.RandomState(seed)
    im1 = (rng.rand(n, 3, h, w) * 2 - 1).astype(np.float32)
    return im1, np.roll(im1, shift=(2, -3), axis=(2, 3)).copy()


def test_param_count_and_spec_match_jax():
    spec = tr.raft_state_spec()
    assert spec == jr.raft_state_spec()
    trainable = sum(int(np.prod(s)) for n, s in spec.items()
                    if not n.endswith(("running_mean", "running_var")))
    assert trainable == 5_257_536
    p = tr.init_raft_params(torch.Generator().manual_seed(0))
    j = jr.init_raft_params(jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: tuple(v.shape) for k, v in j.items()}
    for k in p:  # the same constants where the init is not random
        if p[k].ndim == 1:
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(j[k]))


def test_converter_strict():
    spec = tr.raft_state_spec()
    sd = {n: np.zeros(s, np.float32) for n, s in spec.items()}
    sd["context_encoder.convnormrelu.1.num_batches_tracked"] = np.zeros((), np.int64)
    assert set(tr.convert_raft_state_dict(sd)) == set(spec)
    bad = dict(sd)
    del bad["update_block.flow_head.conv2.bias"]
    with pytest.raises(ValueError, match="missing"):
        tr.convert_raft_state_dict(bad)
    with pytest.raises(ValueError, match="extra"):
        tr.convert_raft_state_dict({**sd, "foo.weight": np.zeros(1, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        tr.convert_raft_state_dict({**sd, "mask_predictor.conv.bias": np.zeros(3, np.float32)})


@pytest.mark.parametrize("prefix,bn", [("feature_encoder", False), ("context_encoder", True)])
def test_encoders_match_jax(params, prefix, bn):
    jp, tp = params
    im, _ = _pair(1)
    want = jr._encoder_forward(jp, prefix, jnp.asarray(im), bn)
    got = tr._encoder_forward(tp, prefix, torch.from_numpy(im), bn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_corr_pyramid_matches_jax():
    rng = np.random.RandomState(2)
    f1, f2 = (rng.randn(2, 16, 7, 9).astype(np.float32) for _ in range(2))
    want = jr.compute_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2))
    got = tr.compute_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2))
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=1e-5)


def test_grid_sample_zeros_matches_jax():
    rng = np.random.RandomState(3)
    vol = rng.randn(5, 6, 7).astype(np.float32)
    x = rng.uniform(-2, 9, (5, 11)).astype(np.float32)
    y = rng.uniform(-2, 8, (5, 11)).astype(np.float32)
    want = jr._grid_sample_zeros(jnp.asarray(vol), jnp.asarray(x), jnp.asarray(y))
    got = tr._grid_sample_zeros(*(torch.from_numpy(a) for a in (vol, x, y)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_index_pyramid_matches_jax():
    """x takes the first meshgrid axis: a transposed neighbourhood would
    differ on these non-square volumes."""
    rng = np.random.RandomState(4)
    f1, f2 = (rng.randn(1, 8, 6, 10).astype(np.float32) for _ in range(2))
    coords = (np.stack(np.meshgrid(np.arange(10), np.arange(6)))[None].astype(np.float32)
              + rng.randn(1, 2, 6, 10).astype(np.float32))
    want = jr.index_pyramid(jr.compute_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2)),
                            jnp.asarray(coords))
    got = tr.index_pyramid(tr.compute_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2)),
                           torch.from_numpy(coords))
    assert tuple(got.shape) == (1, 324, 6, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_upsample_flow_matches_jax():
    rng = np.random.RandomState(5)
    flow = rng.randn(2, 2, 3, 4).astype(np.float32)
    mask = rng.randn(2, 576, 3, 4).astype(np.float32)
    want = jr.upsample_flow(jnp.asarray(flow), jnp.asarray(mask))
    got = tr.upsample_flow(torch.from_numpy(flow), torch.from_numpy(mask))
    assert tuple(got.shape) == (2, 2, 24, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_full_forward_matches_jax(params):
    """12 updates, as the loss runs them: the random weights give flows of
    +-15 px, and each update's rounding feeds the next lookup's coordinates,
    so the two sides part by up to ~6e-3 px (4e-4 of the range)."""
    jp, tp = params
    im1, im2 = _pair(6)
    want = jr.raft_forward(jp, jnp.asarray(im1), jnp.asarray(im2), num_flow_updates=12)
    got = tr.raft_forward(tp, torch.from_numpy(im1), torch.from_numpy(im2), num_flow_updates=12)
    assert tuple(got.shape) == (1, 2, 64, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-2, rtol=1e-3)


def test_raft_flow_padding_and_gray_match_jax(params):
    jp, tp = params
    rng = np.random.RandomState(7)
    f1, f2 = (rng.rand(2, 1, 27, 34).astype(np.float32) for _ in range(2))
    want = jr.make_raft_flow_fn(jp, num_flow_updates=2)(jnp.asarray(f1), jnp.asarray(f2))
    got = tr.make_raft_flow_fn(tp, num_flow_updates=2)(torch.from_numpy(f1), torch.from_numpy(f2))
    assert tuple(got.shape) == (2, 2, 27, 34)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=1e-3)
    with pytest.raises(ValueError, match="multiples of 8"):
        tr.raft_forward(tp, torch.zeros(1, 3, 12, 16), torch.zeros(1, 3, 12, 16))


def test_load_raft_params_npz_and_pth_roundtrip(tmp_path):
    sd = _state_dict(8)
    np.savez(tmp_path / "raft.npz", **sd)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, tmp_path / "raft.pth")
    for name in ("raft.npz", "raft.pth"):
        got = tr.load_raft_params(str(tmp_path / name))
        want = jr.load_raft_params(str(tmp_path / name))
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(FileNotFoundError, match="raft_large"):
        tr.load_raft_params(str(tmp_path / "missing.pth"))


def _grads(params, images, name, dflow, fn):
    """The gradients of <fn(params, *images), dflow> with respect to the
    images and to the weight ``name``, on fresh leaves."""
    p = dict(params)
    p[name] = p[name].detach().clone().requires_grad_(True)
    leaves = [t.detach().clone().requires_grad_(True) for t in images]
    flow = fn(p, *leaves, num_flow_updates=2)
    return flow, torch.autograd.grad(flow, leaves + [p[name]], dflow)


def test_backward_through_the_fp32_boundary_is_the_plain_graphs(params):
    """raft_forward under autograd (``_Fp32Backward``: its own graph,
    differentiated inside ``_fp32``) gives the plain graph's gradients bit
    for bit on the CPU, for both images and for a weight that takes one."""
    _, tp = params
    images = [torch.from_numpy(t) for t in _pair(9, h=32, w=40)]
    dflow = torch.randn((1, 2, 32, 40), generator=torch.Generator().manual_seed(9))
    name = "update_block.flow_head.conv2.weight"
    flow, got = _grads(tp, images, name, dflow, tr.raft_forward)
    assert type(flow.grad_fn).__name__ == "_Fp32BackwardBackward"
    _, want = _grads(tp, images, name, dflow,
                     lambda p, a, b, num_flow_updates: tr._raft_forward(p, a, b, num_flow_updates))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with torch.no_grad():  # no graph to keep: the plain forward
        assert tr.raft_forward(tp, *images, num_flow_updates=2).grad_fn is None

