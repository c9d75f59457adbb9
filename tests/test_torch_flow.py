"""The port's flow loss against gen3c_tpu's on the CPU.

Seeded numpy videos go into both. The Lucas-Kanade estimator agrees to
atol 1e-4 px (fp32; its normal equations divide by small determinants), the
bidirectional flow and the loss through it to 1e-4; through RAFT (shared
seeded weights, 2 updates) to atol 1e-3. The loss's gradient with respect to
the reconstruction is held to jax.grad's through both estimators to 1e-3 of
its largest element: the L1's sign flips where the two flows all but agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gen3c_tpu.aux import raft as jr
from gen3c_tpu.training import flow as jf
from gen3c_tpu_torch.aux import raft as tr
from gen3c_tpu_torch.training import flow as tf

torch.set_num_threads(2)


def _texture(n, c, h, w, seed):
    """Smooth random images (sums of sinusoids), the LK estimator's regime."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.zeros((n, c, h, w), np.float32)
    for i in range(6):
        fy, fx, ph = rng.uniform(0.05, 0.4), rng.uniform(0.05, 0.4), rng.uniform(0, 6)
        out += np.sin(fy * yy + fx * xx + ph)[None, None] * rng.uniform(0.2, 1.0, (n, c, 1, 1))
    return (out / 6).astype(np.float32)


def _video(seed, b=1, t=3, h=32, w=40):
    frames = _texture(b * t, 3, h + 4, w + 4, seed)
    v = frames.reshape(b, t, 3, h + 4, w + 4)
    shifted = np.stack([v[:, i, :, i:i + h, 2 * i // 2:2 * i // 2 + w] for i in range(t)], axis=1)
    return shifted.transpose(0, 2, 1, 3, 4).copy()  # (B, 3, T, H, W)


@pytest.mark.parametrize("shape", [(2, 3, 32, 40), (1, 1, 21, 27)])
def test_lucas_kanade_matches_jax(shape):
    a = _texture(*shape, seed=1)
    b = np.roll(a, (1, 2), axis=(2, 3)).copy()
    want = jf.lucas_kanade_flow(jnp.asarray(a), jnp.asarray(b))
    got = tf.lucas_kanade_flow(torch.from_numpy(a), torch.from_numpy(b))
    assert tuple(got.shape) == (shape[0], 2) + shape[2:]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_bidirectional_flow_matches_jax():
    v = _video(2, b=2, t=3).transpose(0, 2, 1, 3, 4).copy()  # (B, T, C, H, W)
    want = jf.bidirectional_flow(jnp.asarray(v), jf.lucas_kanade_flow, 2)
    got = tf.bidirectional_flow(torch.from_numpy(v), tf.lucas_kanade_flow, 2)
    assert tuple(got.shape) == (2, 2, 4, 32, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def _loss_and_grad_pair(video, recon, jfn, tfn):
    jval, jgrad = jax.value_and_grad(
        lambda r: jf.flow_loss(jnp.asarray(video), r, flow_fn=jfn, scale=2))(jnp.asarray(recon))
    r = torch.from_numpy(recon).requires_grad_(True)
    tval = tf.flow_loss(torch.from_numpy(video), r, flow_fn=tfn, scale=2)
    tval.backward()
    return float(jval), np.asarray(jgrad), tval.item(), r.grad.numpy()


def test_flow_loss_through_lk_matches_jax():
    video = _video(3)
    recon = (video + 0.05 * np.random.RandomState(4).randn(*video.shape)).astype(np.float32)
    jv, jg, tv, tg = _loss_and_grad_pair(video, recon, None, None)
    np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tg, jg, atol=1e-3 * np.abs(jg).max(), rtol=1e-2)
    assert float(tf.flow_loss(torch.from_numpy(video), torch.from_numpy(video))) == 0.0
    assert float(tf.flow_loss(torch.zeros(1, 3, 1, 8, 8), torch.ones(1, 3, 1, 8, 8))) == 0.0


def test_flow_loss_through_raft_matches_jax():
    rng = np.random.RandomState(5)
    sd = {}
    for name, shape in tr.raft_state_spec().items():
        if name.endswith("running_var") or (len(shape) == 1 and ".1." in name
                                            and name.endswith("weight")):
            sd[name] = np.ones(shape, np.float32)
        elif len(shape) == 1:
            sd[name] = np.zeros(shape, np.float32)
        else:
            sd[name] = (rng.randn(*shape) * (2.0 / np.prod(shape[1:])) ** 0.5).astype(np.float32)
    jfn = jr.make_raft_flow_fn(jr.convert_raft_state_dict(sd), num_flow_updates=2)
    tfn = tr.make_raft_flow_fn(tr.convert_raft_state_dict(sd), num_flow_updates=2)
    video = _video(6, t=3, h=32, w=32)
    recon = (video + 0.1 * rng.randn(*video.shape)).astype(np.float32)
    jv, jg, tv, tg = _loss_and_grad_pair(video, recon, jfn, tfn)
    np.testing.assert_allclose(tv, jv, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(tg, jg, atol=1e-3 * np.abs(jg).max(), rtol=1e-2)
    assert np.isfinite(tg).all()
