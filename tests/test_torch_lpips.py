"""The port's LPIPS / perceptual loss against gen3c_tpu's on the CPU.

Shared seeded VGG16 weights (numpy, torchvision names) go into both; inputs
are numpy. fp32 on both sides: the feature maps and the losses agree to
rtol 1e-4 (13 stacked convolutions summed in other orders by XLA's and
PyTorch's CPU convolutions); the converters give the same tensors bit for
bit; the mask resize takes torch's floor(dst * in / out) rows and columns,
JAX's indices exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gen3c_tpu.training import lpips as jl
from gen3c_tpu_torch.training import lpips as tl

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-6


def _state_dict(seed=0):
    rng = np.random.RandomState(seed)
    sd = {}
    for idx, cin, cout in jl.VGG16_CONVS:
        sd[f"features.{idx}.weight"] = (rng.randn(cout, cin, 3, 3) * (2.0 / (cin * 9)) ** 0.5
                                        ).astype(np.float32)
        sd[f"features.{idx}.bias"] = (rng.randn(cout) * 0.05).astype(np.float32)
    sd["classifier.0.weight"] = rng.randn(4, 4).astype(np.float32)  # dropped by both
    sd["lin0.model.1.weight"] = rng.randn(1, 64, 1, 1).astype(np.float32)
    return sd


@pytest.fixture(scope="module")
def params():
    sd = _state_dict()
    return jl.convert_vgg16_state_dict(sd), tl.convert_vgg16_state_dict(sd)


def _imgs(seed, shape=(2, 3, 48, 40)):
    rng = np.random.RandomState(seed)
    return (rng.rand(*shape) * 2 - 1).astype(np.float32), (rng.rand(*shape) * 2 - 1).astype(
        np.float32)


def test_converter_matches_jax(params):
    jp, tp = params
    assert set(jp) == set(tp) and len(tp) == 26
    for k in jp:
        np.testing.assert_array_equal(np.asarray(jp[k]), tp[k].numpy())


def test_features_match_jax(params):
    jp, tp = params
    x, _ = _imgs(1)
    want = jl.vgg16_features(jp, jnp.asarray(x))
    got = tl.vgg16_features(tp, torch.from_numpy(x))
    assert len(got) == 5
    for a, b in zip(want, got):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=1e-5)


def test_lpips_and_video_match_jax(params):
    jp, tp = params
    x, y = _imgs(2)
    np.testing.assert_allclose(tl.lpips(tp, torch.from_numpy(x), torch.from_numpy(y)).numpy(),
                               np.asarray(jl.lpips(jp, jnp.asarray(x), jnp.asarray(y))),
                               rtol=RTOL, atol=ATOL)
    v, w = _imgs(3, (1, 3, 3, 32, 32))
    np.testing.assert_allclose(
        float(tl.lpips_video(tp, torch.from_numpy(v), torch.from_numpy(w))),
        float(jl.lpips_video(jp, jnp.asarray(v), jnp.asarray(w))), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("gram", [False, True])
def test_masked_perceptual_and_gram_match_jax(params, gram):
    """A mask whose size the feature maps do not divide (48 x 40 -> 24 x 20
    -> 12 x 10 -> 6 x 5 -> 3 x 2): the floor-rule indices matter."""
    jp, tp = params
    x, y = _imgs(4)
    mask = (np.random.RandomState(5).rand(2, 1, 48, 40) > 0.4).astype(np.float32)
    want = jl.perceptual_loss(jp, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask), gram=gram)
    got = tl.perceptual_loss(tp, torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(mask), gram=gram)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=RTOL, atol=ATOL)
    if gram:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=RTOL, atol=ATOL)
    else:
        assert got[1] is None and want[1] is None
    v, w = _imgs(6, (1, 3, 2, 24, 40))
    m = (np.random.RandomState(7).rand(1, 1, 2, 24, 40) > 0.5).astype(np.float32)
    jv = jl.perceptual_video(jp, jnp.asarray(v), jnp.asarray(w), jnp.asarray(m), gram=gram)
    tv = tl.perceptual_video(tp, torch.from_numpy(v), torch.from_numpy(w), torch.from_numpy(m),
                             gram=gram)
    np.testing.assert_allclose(float(tv[0]), float(jv[0]), rtol=RTOL, atol=ATOL)
    if gram:
        np.testing.assert_allclose(float(tv[1]), float(jv[1]), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hw", [(3, 2), (7, 5), (24, 20), (6, 11)])
def test_nearest_mask_indices_match_jax(hw):
    m = np.arange(48 * 40, dtype=np.float32).reshape(1, 1, 48, 40)
    H, W = 48, 40
    ri = np.floor(np.arange(hw[0], dtype=np.float32) * np.float32(H / hw[0])).astype(int)
    ci = np.floor(np.arange(hw[1], dtype=np.float32) * np.float32(W / hw[1])).astype(int)
    got = tl.nearest_torch(torch.from_numpy(m), hw).numpy()
    np.testing.assert_array_equal(got, m[..., ri[:, None], ci[None, :]])


def test_load_lpips_params_pth_and_npz(tmp_path):
    sd = _state_dict(9)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "vgg.pth")
    np.savez(tmp_path / "vgg.npz", **sd)
    for name in ("vgg.pth", "vgg.npz"):
        got = tl.load_lpips_params(str(tmp_path / name))
        want = jl.load_lpips_params(str(tmp_path / name))
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(FileNotFoundError, match="vgg16"):
        tl.load_lpips_params(str(tmp_path / "missing.pth"))


def test_init_vgg16_params_shapes_and_scale():
    p = tl.init_vgg16_params(torch.Generator().manual_seed(0))
    j = jl.init_vgg16_params(jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: tuple(v.shape) for k, v in j.items()}
    w = p["features.28.weight"]
    assert abs(float(w.std()) - (2.0 / (512 * 9)) ** 0.5) < 2e-3
    assert float(p["features.0.bias"].abs().sum()) == 0.0
