"""The port's MoGe (aux/moge.py, ops/resize.py, the depth estimators)
against gen3c_tpu's on the CPU.

MOGE_TINY with gen3c_tpu's ``init_moge_params`` weights (biases and
LayerScale randomised so that they matter) goes through both packages:
each function on its own, fp32 on both sides. Tolerances: the backbone's
taps and the head within 1e-5 of mean |out| ~0.8 and 0.08 (four fp32
blocks in different summation orders); ``jax.image.resize`` within 1e-4
(XLA's jitted CPU resize itself sits up to 3e-5 from a float64 evaluation
of the same weights, the port's within 4e-7); the recovered shift within one cell of
the search's last grid (1.6e-4) and the focal within 2e-4 relative on a
geometric point map (a grid search: on a flat residual two correct
searches may pick different cells, so ``moge_infer`` is compared with the
shift and focal JAX recovered handed to the port).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gen3c_tpu.aux import moge as jmoge
from gen3c_tpu.pipelines import depth as jdepth
from gen3c_tpu_torch.aux import moge as tmoge
from gen3c_tpu_torch.ops.resize import resize
from gen3c_tpu_torch.pipelines import depth as tdepth

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def params():
    """(JAX params, numpy state dict): gen3c_tpu's tiny init with its zero
    biases and unit LayerScale randomised, and a head whose mask logit
    and z channel sit well above 0 (every pixel valid, depth positive)."""
    rng = np.random.default_rng(0)
    sd = {k: np.asarray(v) for k, v in
          jmoge.init_moge_params(jax.random.PRNGKey(0), jmoge.MOGE_TINY).items()}
    for k in sd:
        if k.endswith(("bias", "gamma")):
            sd[k] = (rng.standard_normal(sd[k].shape) * 0.1).astype(np.float32)
    sd["head.out.bias"] = np.array([0.0, 0.0, 2.0, 4.0], np.float32)
    return {k: jnp.asarray(v) for k, v in sd.items()}, sd


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("shape_in,shape_out,method", [
    ((60, 90, 3), (42, 56, 3), "bilinear"),  # the input's antialiased downscale
    ((1, 37, 37, 16), (1, 27, 50, 16), "bicubic"),  # the pos-embed: one axis shrinks
    ((1, 4, 27, 50), (1, 4, 54, 100), "bilinear"),  # the head's x2
    ((1, 4, 108, 200), (1, 4, 378, 700), "bilinear"),  # the head's output, 704x1280
    ((42, 56), (60, 90), "nearest"),  # depth and mask back to the input
    ((378, 700), (704, 1280), "nearest"),
])
def test_resize_matches_jax(shape_in, shape_out, method):
    x = np.random.default_rng(1).standard_normal(shape_in).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), shape_out, method)
    got = resize(torch.from_numpy(x), shape_out, method)
    if method == "nearest":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _close(got, want, 1e-4)


def test_dinov2_and_head_match_jax(params):
    jp, sd = params
    tp = tmoge.convert_moge_state_dict(sd, tmoge.MOGE_TINY)
    img = np.random.default_rng(2).uniform(-1, 1, (2, 3, 56, 84)).astype(np.float32)
    want = jmoge.dinov2_forward(jp, jmoge.MOGE_TINY, jnp.asarray(img))
    got = tmoge.dinov2_forward(tp, tmoge.MOGE_TINY, torch.from_numpy(img))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == (2, 64, 4, 6)
        _close(g, w, 1e-5)
    head_in = [torch.from_numpy(np.array(w)) for w in want]
    _close(tmoge.moge_head(tp, tmoge.MOGE_TINY, head_in, (56, 84)),
           jmoge.moge_head(jp, jmoge.MOGE_TINY, want, (56, 84)), 1e-5)


def _pinhole_points(seed, H=40, W=60):
    """A point map of a pinhole camera (focal f0, shift t0) with noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                         indexing="ij")
    s = min(H, W) / 2
    f0, t0 = rng.uniform(0.8, 2.0), rng.uniform(0.5, 3.0)
    z = rng.uniform(1.0, 4.0) + 0.5 * np.sin(xx / 7 + seed)
    pts = np.stack([(xx - (W - 1) / 2) / s * z / f0, (yy - (H - 1) / 2) / s * z / f0, z - t0], -1)
    pts = pts + rng.normal(0, 1e-3, pts.shape)
    return pts.astype(np.float32), rng.uniform(size=(H, W)) > 0.1, f0, t0


# the last refinement's grid step: 9.99 / 63 * (2 / 63) ** 2
_FINAL_STEP = 9.99 / 63 * (2 / 63) ** 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_recover_focal_shift_matches_jax(seed):
    """Within one cell of the last refinement's grid: near the minimum the
    residual of a noisy point map is flat to within the sums' rounding, and
    a search in another summation order may take the neighbouring cell."""
    pts, mask, f0, t0 = _pinhole_points(seed)
    for m in (mask, np.zeros(mask.shape, bool)):  # a blank mask counts every pixel
        fj, tj = jax.jit(jmoge.recover_focal_shift)(jnp.asarray(pts), jnp.asarray(m))
        ft, tt = tmoge.recover_focal_shift(torch.from_numpy(pts), torch.from_numpy(m))
        assert abs(float(tt) - float(tj)) <= 1.01 * _FINAL_STEP
        np.testing.assert_allclose(float(ft), float(fj), rtol=2e-4)
        np.testing.assert_allclose(float(tt), t0, atol=2e-3)  # and both find the camera


def _shared_recovery(monkeypatch):
    """Record JAX's recovered (focal, shift) and hand them to the port."""
    recovered = []
    jax_fn = jmoge.recover_focal_shift

    def record(points, mask):
        f, t = jax_fn(points, mask)
        recovered.append((float(f), float(t)))
        return f, t

    monkeypatch.setattr(jmoge, "recover_focal_shift", record)
    monkeypatch.setattr(tmoge, "recover_focal_shift",
                        lambda points, mask: tuple(torch.tensor(v) for v in recovered.pop(0)))
    return recovered


def test_moge_infer_matches_jax(params, monkeypatch):
    """The whole inference at 60 x 90 (fit to 42 x 56), unjitted JAX so its
    recovered focal and shift can be handed over."""
    jp, sd = params
    tp = tmoge.convert_moge_state_dict(sd, tmoge.MOGE_TINY)
    recovered = _shared_recovery(monkeypatch)
    img = np.random.default_rng(3).uniform(0, 1, (60, 90, 3)).astype(np.float32)
    budget = 14 * 14 * 12
    assert tmoge._fit_resolution(60, 90, 14, budget) == jmoge._fit_resolution(60, 90, 14, budget)
    dj, kj, mj = jmoge.moge_infer(jp, jmoge.MOGE_TINY, jnp.asarray(img), max_pixels=budget)
    assert len(recovered) == 1
    dt, kt, mt = tmoge.moge_infer(tp, tmoge.MOGE_TINY, torch.from_numpy(img), max_pixels=budget)
    assert not recovered
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert mt.numpy().mean() > 0.9
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=1e-6)
    np.testing.assert_array_equal(np.isfinite(dt.numpy()), np.isfinite(np.asarray(dj)))
    ok = np.isfinite(np.asarray(dj))
    _close(dt.numpy()[ok], np.asarray(dj)[ok], 1e-5)
    assert tmoge._fit_resolution(704, 1280, 14, 518 * 518) == (378, 700)


def test_convert_is_strict(params):
    _, sd = params
    with pytest.raises(ValueError, match="unconsumed"):
        tmoge.convert_moge_state_dict({**sd, "head.extra": np.zeros(1)}, tmoge.MOGE_TINY)
    missing = dict(sd)
    del missing["head.out.bias"]
    with pytest.raises(KeyError, match="head.out.bias"):
        tmoge.convert_moge_state_dict(missing, tmoge.MOGE_TINY)
    assert set(tmoge.init_moge_params(torch.Generator().manual_seed(0), tmoge.MOGE_TINY)) == set(sd)


@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_native_estimator_matches_jax_estimator(params, tmp_path, monkeypatch, fmt):
    """The depth estimators of both packages on one checkpoint file
    (GEN3C_MOGE_CHECKPOINT), masked depth 1000, and ``auto`` choosing MoGe
    when the checkpoint is set."""
    _, sd = params
    path = str(tmp_path / f"moge.{fmt}")
    if fmt == "npz":
        np.savez(path, **sd)
    else:
        torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    monkeypatch.setenv("GEN3C_MOGE_CHECKPOINT", path)
    monkeypatch.setattr(jmoge, "MOGE_VITL", jmoge.MOGE_TINY)
    monkeypatch.setattr(tmoge, "MOGE_VITL", tmoge.MOGE_TINY)
    monkeypatch.setattr(jmoge, "recover_focal_shift", _fixed_recovery(jnp))
    monkeypatch.setattr(tmoge, "recover_focal_shift", _fixed_recovery(torch))
    want_est = jdepth.make_depth_estimator("auto")
    got_est = tdepth.make_depth_estimator("auto", device="cpu")
    assert isinstance(want_est, jdepth.MoGeJaxDepthEstimator)
    assert isinstance(got_est, tdepth.NativeMoGeDepthEstimator)
    assert isinstance(tdepth.make_depth_estimator("moge_jax", device="cpu"),
                      tdepth.NativeMoGeDepthEstimator)
    img = (np.random.default_rng(4).uniform(size=(56, 84, 3)) * 255).astype(np.uint8)
    (dj, kj, mj), (dt, kt, mt) = want_est(img), got_est(img)
    np.testing.assert_array_equal(mt, mj)
    assert np.isfinite(dt).all() and (dt[~mt] == 1000.0).all()
    np.testing.assert_allclose(kt, kj, rtol=1e-6)
    np.testing.assert_allclose(dt, dj, atol=1e-5, rtol=0)


def _fixed_recovery(xp):
    """A stand-in for the focal / shift search that both packages compute
    alike: focal 1, the shift that puts the nearest valid point at depth 1
    (JAX's search is jitted inside its estimator, so its choice cannot be
    handed over, and on an untrained head it is ill-conditioned)."""
    def recover(points, mask):
        z = points[..., 2]
        if xp is torch:
            z_min = torch.where(mask, z, torch.full_like(z, float("inf"))).min()
            return torch.tensor(1.0), 1.0 - z_min
        return jnp.float32(1.0), 1.0 - jnp.min(jnp.where(mask, z, jnp.inf))

    return recover


def test_estimator_sources_and_errors(monkeypatch):
    monkeypatch.delenv("GEN3C_MOGE_CHECKPOINT", raising=False)
    with pytest.raises(FileNotFoundError, match="GEN3C_MOGE_CHECKPOINT"):
        tdepth.make_depth_estimator("moge_jax", device="cpu")
    with pytest.raises(ImportError, match="moge"):  # the external package is not installed
        tdepth.make_depth_estimator("moge", device="cpu")
    assert isinstance(tdepth.make_depth_estimator("auto", device="cpu"),
                      tdepth.HeuristicDepthEstimator)
    with pytest.raises(ValueError, match="unknown depth source"):
        tdepth.make_depth_estimator("midas", device="cpu")
