"""The plain PyTorch versions of the port's kernels against the JAX package.

attention_reference (K1/K2) against gen3c_tpu.models.dit.attention_op and
splat_reference (K5) against gen3c_tpu.ops.geometry.bilinear_splatting, on
the same numpy inputs. On the CPU attention_op takes its XLA path and
bilinear_splatting its scatter-add path; mma_probe_reference (P1) is held
to the probe script's Pallas kernel in interpret mode. The fp32 forward's
arithmetic (csrc/attention_f32.cu: each operand split into two TF32 parts,
three TF32 products) is emulated here at MoGe's shape and held to
attention_op and attention_reference, beside one TF32 product, which misses
the fp32 tolerance. The CUDA kernels themselves are held against these
references on the card by chip_smoke.py.
"""

import math
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gen3c_tpu.models.dit import attention_op
from gen3c_tpu.ops.geometry import bilinear_splatting
from gen3c_tpu_torch import kernels
from gen3c_tpu_torch.kernels.reference import attention_reference, splat_reference
from torch_splat_cases import nonfinite_splat_inputs, splat_inputs as _splat_inputs

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


@pytest.mark.parametrize("is_image", [True, False])
@pytest.mark.parametrize("buffer", [0, 1], ids=["nan_depth", "inf_depth"])
def test_splat_reference_keeps_nonfinite_depth_as_jax(buffer, is_image):
    """jnp.maximum / jnp.minimum and jnp.max keep a NaN, as torch.clamp and
    amax do: a NaN depth makes the buffer's log-depth maximum NaN and every
    pixel it splats NaN; a +inf depth makes the maximum inf and its own
    pixel's weight inf / inf = NaN. The NaN pattern is the same, the finite
    values agree as in the finite cases, and the masks are equal."""
    sl = slice(buffer, buffer + 1)
    frame, mask, depth, flow, fmask = (a[sl] for a in nonfinite_splat_inputs())
    want_img, want_mask = (np.asarray(a) for a in bilinear_splatting(
        *(jnp.asarray(a) for a in (frame, mask, depth, flow, fmask)), is_image=is_image))
    got_img, got_mask = (a.numpy() for a in splat_reference(
        *(torch.from_numpy(a) for a in (frame, mask, depth, flow, fmask)), is_image=is_image))
    nan = np.isnan(want_img)
    assert nan.any() and (not nan.all() if buffer else nan[want_mask.repeat(3, 1) > 0].all())
    np.testing.assert_array_equal(np.isnan(got_img), nan)
    np.testing.assert_array_equal(got_mask, want_mask)
    np.testing.assert_allclose(got_img[~nan], want_img[~nan], atol=1e-5, rtol=0)


def test_kernels_import_without_nvcc_or_triton():
    code = (
        "import sys, gen3c_tpu_torch.kernels as k, gen3c_tpu_torch.kernels.cuda; "
        "assert 'triton' not in sys.modules; "
        "assert sorted(k.launch_counts) == ['K1', 'K1ag', 'K1cp', 'K1merge', 'K1ring', 'K1vit', 'K2', 'K3', "
        "'K3lse', 'K4', 'K4band', 'K5', 'K6', 'K7', 'K7q', 'K8', 'K8bwd', 'P1', 'P2']; print('ok')"
    )
    env = {"PATH": "/usr/bin:/bin", "CUDA_HOME": "/nonexistent"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _pallas_probe():
    """scripts/probe_int8_attention.py's Pallas kernel body (P1), loaded
    from its file (it is a script, not a module of the package)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                        "probe_int8_attention.py")
    spec = importlib.util.spec_from_file_location("probe_int8_attention", path)
    mod = importlib.util.module_from_spec(spec)
    env = dict(os.environ)
    try:
        spec.loader.exec_module(mod)
    finally:  # the script points JAX's compilation cache at the repo: undo it
        os.environ.clear()
        os.environ.update(env)
    return mod


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("m,k,n,reps", [(16, 32, 8, 3), (24, 64, 40, 4), (8, 128, 16, 1)])
def test_mma_probe_reference_matches_pallas_interpret(dtype, m, k, n, reps):
    """P1's plain version against the probe script's Pallas kernel run in
    interpret mode on the CPU: int8 exactly (a + 1 wraps in int8 on odd
    passes: a holds 127s), bf16 within 1e-5 of reps * (|a| + 1) @ |b|
    (the fp32 sums in another order)."""
    from functools import partial

    from jax.experimental import pallas as pl

    probe = _pallas_probe()
    rng = np.random.default_rng(m + k)
    if dtype == "int8":
        a = rng.integers(-100, 100, (m, k)).astype(np.int8)
        a[0, :3] = 127
        b = rng.integers(-100, 100, (k, n)).astype(np.int8)
        ja, jb, acc = jnp.asarray(a), jnp.asarray(b), jnp.int32
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    else:
        a32, b32 = (rng.standard_normal(s).astype(np.float32) for s in ((m, k), (k, n)))
        ja, jb, acc = jnp.asarray(a32, jnp.bfloat16), jnp.asarray(b32, jnp.bfloat16), jnp.float32
        ta, tb = torch.from_numpy(a32).to(torch.bfloat16), torch.from_numpy(b32).to(torch.bfloat16)
    want = np.asarray(pl.pallas_call(partial(probe._mm_loop_kernel, reps=reps, acc_dtype=acc),
                                     out_shape=jax.ShapeDtypeStruct((m, n), acc),
                                     interpret=True)(ja, jb))
    got = kernels.mma_probe(ta, tb, reps)  # a CPU tensor: the plain version
    if dtype == "int8":
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert got.dtype == torch.float32
        bound = reps * ((ta.float().abs() + 1) @ tb.float().abs()).numpy()
        assert (np.abs(got.numpy() - want) <= 1e-5 * bound).all()


ATTN_F32_TOL = 1e-4  # chip_smoke.py's: the fp32 forward against its plain version


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 (10 mantissa bits) in fp32's layout, rounded to nearest
    with ties away from zero: cvt.rna.tf32.f32 on the card."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_split(x: torch.Tensor):
    """x = big + small in TF32 parts (hopper.h's tf32_split)."""
    big = _tf32(x)
    return big, _tf32(x - big)


def test_tf32_split_rebuilds_fp32_within_2_pow_22():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(200_000) * 10.0 ** rng.uniform(-30, 30, 200_000)).astype(np.float32)
    x = torch.from_numpy(x)
    big, small = _tf32_split(x)
    for part in (big, small):
        assert ((part.view(torch.int32) & 0x1FFF) == 0).all()  # TF32 values
    rel = (big.double() + small.double() - x.double()).abs() / x.double().abs()
    assert rel.max().item() <= 2.0 ** -22
    # ties go away from zero; below the tie, to the nearer value
    one = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -11 - 2 ** -23], dtype=torch.float32)
    assert _tf32(one).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1.0]


def _tf32_attention(q, k, v, products: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v with each product on TF32 parts, summed in
    fp32 (a product of two TF32 values is exact in fp32): three products
    (small.big + big.small + big.big) as attention_f32.cu forms them, or
    one (big.big)."""
    B, L, H, D = q.shape
    out = torch.empty_like(q)

    def product(a, b):
        (ab, as_), (bb, bs) = _tf32_split(a), _tf32_split(b)
        return ab @ bb if products == 1 else as_ @ bb + ab @ bs + ab @ bb

    for b in range(B):
        for h in range(H):
            p = torch.softmax(product(q[b, :, h], k[b, :, h].T) / math.sqrt(D), dim=-1)
            out[b, :, h] = product(p, v[b, :, h])
    return out


@pytest.mark.parametrize("products,holds", [(3, True), (1, False)])
def test_three_tf32_products_hold_the_fp32_tolerance(products, holds):
    """At MoGe ViT-L's shape, (1, 1,351, 16, 64) fp32 as views of one qkv
    projection: three TF32 products stay within ATTN_F32_TOL of the plain
    version (and of attention_op), one does not: why K1vit splits."""
    rng = np.random.default_rng(0)
    qkv = rng.standard_normal((1, 1351, 3 * 1024)).astype(np.float32)
    q, k, v = (a.reshape(1, 1351, 16, 64) for a in np.split(qkv, 3, axis=-1))
    want = np.asarray(attention_op(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    tq, tk, tv = (torch.from_numpy(np.ascontiguousarray(a)) for a in (q, k, v))
    plain = attention_reference(tq, tk, tv)
    np.testing.assert_allclose(plain.numpy(), want, atol=1e-5, rtol=0)
    got = _tf32_attention(tq, tk, tv, products)
    for truth in (plain, torch.from_numpy(np.array(want))):
        err = (got - truth).abs().max().item()
        assert (err <= ATTN_F32_TOL) == holds, (products, err)
