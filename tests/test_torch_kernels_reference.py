"""The plain PyTorch versions of the port's kernels against the JAX package.

attention_reference (K1/K2) against gen3c_tpu.models.dit.attention_op and
splat_reference (K5) against gen3c_tpu.ops.geometry.bilinear_splatting, on
the same numpy inputs. On the CPU attention_op takes its XLA path and
bilinear_splatting its scatter-add path; the CUDA kernels themselves are
held against these references on the card by chip_smoke.py.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gen3c_tpu.models.dit import attention_op
from gen3c_tpu.ops.geometry import bilinear_splatting
from gen3c_tpu_torch import kernels
from gen3c_tpu_torch.kernels.reference import attention_reference, splat_reference

torch.set_num_threads(2)


@pytest.mark.parametrize("lq,lk", [(40, 40), (37, 11)])
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_attention_reference_matches_jax(lq, lk, dtype, atol):
    rng = np.random.default_rng(0)
    b, h, d = 2, 3, 24
    q, k, v = (rng.standard_normal((b, n, h, d)).astype(np.float32) for n in (lq, lk, lk))
    jdt = getattr(jnp, dtype)
    want = np.asarray(attention_op(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                   jnp.asarray(v, jdt)).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = attention_reference(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)))
    assert got.dtype == tdt and got.shape == (b, lq, h, d)
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)


def test_attention_dispatch_uses_reference_on_cpu():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 9, 2, 8)).astype(np.float32))
               for _ in range(3))
    before = dict(kernels.launch_counts)
    np.testing.assert_array_equal(kernels.attention(q, k, v, kernel_id="K2").numpy(),
                                  attention_reference(q, k, v).numpy())
    assert kernels.launch_counts == before  # the CPU path launches no kernel


def _splat_inputs(rng, b, c, h, w, integer_flow=False, with_masks=True):
    frame = rng.uniform(-1, 1, (b, c, h, w)).astype(np.float32)
    if integer_flow:
        # whole-pixel shifts: floor == ceil at every target
        flow = rng.integers(-3, 4, (b, 2, h, w)).astype(np.float32)
    else:
        # reaches past every border, so some points fall off the grid
        flow = rng.uniform(-0.6 * w, 0.6 * w, (b, 2, h, w)).astype(np.float32)
    depth = rng.uniform(-0.5, 4.0, (b, 1, h, w)).astype(np.float32)  # some <= 0
    depth[0, 0, :2] = 0.0
    mask = (rng.uniform(size=(b, 1, h, w)) > 0.2).astype(np.float32) if with_masks else None
    fmask = (rng.uniform(size=(b, 1, h, w)) > 0.1).astype(np.float32) if with_masks else None
    return frame, mask, depth, flow, fmask


_SPLAT_CASES = ["integer", "off_grid", "two_buffers", "no_masks"]


@pytest.mark.parametrize("is_image", [True, False])
@pytest.mark.parametrize("case", _SPLAT_CASES)
def test_splat_reference_matches_jax(case, is_image):
    rng = np.random.default_rng(_SPLAT_CASES.index(case))
    b = 2 if case in ("two_buffers", "no_masks") else 1
    frame, mask, depth, flow, fmask = _splat_inputs(
        rng, b, 3, 12, 17, integer_flow=case == "integer", with_masks=case != "no_masks")
    if case == "two_buffers":
        depth[1] *= 5.0  # the second buffer sets the shared log-depth max
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    want_img, want_mask = bilinear_splatting(j(frame), j(mask), j(depth), j(flow), j(fmask),
                                             is_image=is_image)
    got_img, got_mask = splat_reference(t(frame), t(mask), t(depth), t(flow), t(fmask),
                                        is_image=is_image)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), atol=1e-5, rtol=0)
    # the dispatcher takes the same path for CPU tensors
    disp_img, _ = kernels.splat(t(frame), t(mask), t(depth), t(flow), t(fmask), is_image)
    np.testing.assert_array_equal(disp_img.numpy(), got_img.numpy())


def test_splat_groups_keep_their_own_depth_max():
    """Two targets splatted in one call with group=N equal two calls."""
    rng = np.random.default_rng(3)
    frame, mask, depth, flow, fmask = (torch.from_numpy(a) for a in _splat_inputs(rng, 4, 3, 10, 14))
    depth[2:] *= 7.0
    joint = splat_reference(frame, mask, depth, flow, fmask, is_image=True, group=2)
    for s in (0, 2):
        sl = slice(s, s + 2)
        alone = splat_reference(frame[sl], mask[sl], depth[sl], flow[sl], fmask[sl], is_image=True)
        np.testing.assert_array_equal(joint[0][sl].numpy(), alone[0].numpy())
        np.testing.assert_array_equal(joint[1][sl].numpy(), alone[1].numpy())


def test_kernels_import_without_nvcc_or_triton():
    code = (
        "import sys, gen3c_tpu_torch.kernels as k, gen3c_tpu_torch.kernels.cuda; "
        "assert 'triton' not in sys.modules; "
        "assert sorted(k.launch_counts) == ['K1', 'K2', 'K5']; print('ok')"
    )
    env = {"PATH": "/usr/bin:/bin", "CUDA_HOME": "/nonexistent"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
