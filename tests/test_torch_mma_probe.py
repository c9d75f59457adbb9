"""P1's work plan and its library yardstick, on the CPU.

``kernels.cuda.mma_probe_plan`` cuts P1's sum over R passes of (A + i % 2)
@ B into units of (an M tile, an N tile, a K chunk, an R slice), one CTA
each, whose partials a second kernel sums (``csrc/mma_probe.cu`` recomputes
the plan and refuses any other). Checked here for every instruction form
at the smoke's shape, the JAX sweep's shapes and ragged ones: every (M
tile, N tile, K chunk, pass) once, shared memory within a CTA's, the SMs
filled wherever the work allows, and ``mma_probe_reference`` summed over
the plan's units equal to the whole (int8 exactly, with 127s in A so that
A + 1 wraps; bf16 within 1e-5 of R * (|A| + 1) @ |B|, the fp32 sums in
another order). The stacked operands of P1's library column
(``mma_probe_stacked``: one product) give ``mma_probe_reference``'s sum
too: int8 exactly through ``int8_matmul_reference``, bf16 within the same
bound.
"""

import numpy as np
import pytest
import torch

from gen3c_tpu_torch.kernels import cuda as kcuda
from gen3c_tpu_torch.kernels.reference import (
    int8_matmul_reference,
    mma_probe_reference,
    mma_probe_stacked,
)
from gen3c_tpu_torch.scripts import probe_int8_attention as probe

SMS = 132  # an H100 SXM's
FORMS = [(dtype, form) for dtype, forms in kcuda.MMA_PROBE_FORMS.items() for form in forms]
# (M, K, N, R): the smoke's QK^T block, the PV block, the JAX sweep's squares
# at its R, and ragged shapes (K past 1,024, one pass, none)
PLAN_SHAPES = ([(1408, 128, 1024, 8000), (1408, 1024, 128, 1000)]
               + [(512, k, 512, probe.reps_for(k, True)) for k in probe.SQUARE_K]
               + [(200, 256, 130, 5), (333, 1056, 200, 9), (1, 32, 1, 5), (64, 128, 64, 1),
                  (100, 64, 70, 0), (4099, 2048, 4104, 3)])


def _operands(m, k, n, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        a = rng.integers(-100, 100, (m, k)).astype(np.int8)
        a[0, :3] = 127
        a[m // 2, -2:] = 127
        b = rng.integers(-100, 100, (k, n)).astype(np.int8)
        return torch.from_numpy(a), torch.from_numpy(b)
    return (torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16),
            torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(torch.bfloat16))


def _bound(a, b, reps):
    return 1e-5 * reps * ((a.float().abs() + 1) @ b.float().abs())


@pytest.mark.parametrize("dtype,form", FORMS)
@pytest.mark.parametrize("m,k,n,reps", PLAN_SHAPES)
def test_mma_probe_plan_covers_the_work_once(dtype, form, m, k, n, reps):
    plan = kcuda.mma_probe_plan(m, n, k, reps, dtype, form, SMS)
    units = [plan.unit(u) for u in range(plan.grid)]
    keys = {(u["m0"], u["n0"], u["chunk"], u["slice"]) for u in units}
    # never a duplicate: the units are the tiles x chunks x slices, each once
    assert len(keys) == plan.grid == plan.m_tiles * plan.n_tiles * plan.chunks * plan.slices
    assert {u["m0"] for u in units} == set(range(0, m, plan.rows))
    assert {u["n0"] for u in units} == set(range(0, n, plan.ni))
    # the K chunks cut [0, K) and the R slices [0, R), each piece once
    chunks = sorted({(u["k0"], u["k_len"]) for u in units})
    assert chunks[0][0] == 0 and sum(c[1] for c in chunks) == k
    assert all(c0 + l0 == c1 for (c0, l0), (c1, _) in zip(chunks, chunks[1:]))
    assert all(0 < c[1] and c[1] * plan.steps <= k * plan.chunk_steps for c in chunks)
    slices = sorted({(u["r0"], u["r1"]) for u in units})
    assert slices[0][0] == 0 and slices[-1][1] == reps
    assert all(s0[1] == s1[0] for s0, s1 in zip(slices, slices[1:]))
    assert all(r1 > r0 for r0, r1 in slices) or reps == 0
    # one CTA an SM, within a CTA's shared memory
    assert kcuda.MMA_PROBE_ONE_CTA <= plan.smem <= 232448
    if plan.rs:
        assert plan.chunk_steps <= kcuda.MMA_PROBE_RS_MAX_STEPS
    # the SMs filled wherever the work allows, in whole waves where the
    # search finds them
    base = plan.m_tiles * plan.n_tiles * plan.chunks
    if base * reps >= SMS:
        assert plan.grid >= SMS
    assert plan.scratch == plan.slices * plan.chunks * plan.m_tiles * plan.rows * plan.n_tiles * plan.ni


@pytest.mark.parametrize("dtype,form", FORMS)
@pytest.mark.parametrize("m,k,n,reps,sms", [(200, 256, 130, 5, SMS), (333, 1056, 200, 9, SMS),
                                            (130, 512, 70, 7, 8), (64, 96, 300, 4, 3)])
def test_mma_probe_plan_partials_sum_to_the_whole(dtype, form, m, k, n, reps, sms):
    """mma_probe_reference over each unit's tiles, K chunk and R slice (a
    slice that starts at an odd pass with an odd count as R + 1 passes
    less the first), summed: the whole sum."""
    a, b = _operands(m, k, n, dtype, seed=m + k + n)
    plan = kcuda.mma_probe_plan(m, n, k, reps, dtype, form, sms)
    acc = torch.int32 if dtype == "int8" else torch.float32
    out = torch.zeros((m, n), dtype=acc)
    for u in range(plan.grid):
        d = plan.unit(u)
        rows, cols = slice(d["m0"], d["m0"] + plan.rows), slice(d["n0"], d["n0"] + plan.ni)
        ks = slice(d["k0"], d["k0"] + d["k_len"])
        ab, bb, count = a[rows, ks], b[ks, cols], d["r1"] - d["r0"]
        if d["r0"] % 2 and count % 2:
            part = mma_probe_reference(ab, bb, count + 1) - mma_probe_reference(ab, bb, 1)
        else:
            part = mma_probe_reference(ab, bb, count)
        out[rows, cols] += part
    want = mma_probe_reference(a, b, reps)
    if dtype == "int8":
        assert torch.equal(out, want)
    else:
        assert ((out - want).abs() <= _bound(a, b, reps)).all()


@pytest.mark.parametrize("dtype,form", FORMS)
def test_mma_probe_plan_slices_start_at_odd_passes(dtype, form):
    """The smoke's ragged check of every form, (200, 256, 130) at R 5: one
    pass a slice, so slices start at odd passes (A + 1 first)."""
    plan = kcuda.mma_probe_plan(200, 130, 256, 5, dtype, form, SMS)
    assert plan.slices == 5
    assert sorted({plan.unit(u)["r0"] for u in range(plan.grid)}) == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("m,k,n,reps", [(16, 32, 8, 3), (24, 64, 40, 4), (40, 128, 24, 1),
                                        (17, 96, 33, 0)])
def test_mma_probe_stacked_product_is_the_sum(dtype, m, k, n, reps):
    """[A | A+1 | A | ...] @ [B; B; ...] in one product: P1's library
    column computes the plain version's sum."""
    a, b = _operands(m, k, n, dtype, seed=reps + k)
    a_st, bT_st = mma_probe_stacked(a, b, reps)
    assert a_st.shape == (m, reps * k) and bT_st.shape == (n, reps * k)
    assert a_st.dtype == bT_st.dtype == a.dtype
    want = mma_probe_reference(a, b, reps)
    if dtype == "int8":
        assert torch.equal(int8_matmul_reference(a_st, bT_st), want)
    else:
        got = a_st.float() @ bT_st.float().t()
        assert ((got - want).abs() <= _bound(a, b, reps)).all()


@pytest.mark.parametrize("n,dtype,form", [(1024, "bf16", "ss256"), (130, "int8", "ss256"),
                                          (128, "bf16", "ss128"), (128, "int8", "ss128"),
                                          (64, "bf16", "ss64"), (1, "int8", "ss128")])
def test_mma_probe_form_is_the_widest_the_n_tile_allows(n, dtype, form):
    assert kcuda.mma_probe_form(n, dtype) == form
    assert kcuda.mma_probe_form(n, torch.int8 if dtype == "int8" else torch.bfloat16) == form


def test_mma_probe_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="no 'rs128' form in int8"):
        kcuda.mma_probe_plan(64, 64, 64, 2, "int8", "rs128", SMS)
    with pytest.raises(ValueError, match="K % 32"):
        kcuda.mma_probe_plan(64, 64, 48, 2, "bf16", "ss64", SMS)
    with pytest.raises(TypeError, match="bf16 or int8"):
        kcuda.mma_probe_plan(64, 64, 64, 2, torch.float32, "ss64", SMS)


def test_mma_probe_plan_at_the_smokes_shape():
    """The QK^T block (1408, 128, 1024) at R 8,000: 11 x 4 tiles of n256 and
    one K chunk give 44 units, three R slices 132; partials 17.3 MB."""
    plan = kcuda.mma_probe_plan(1408, 1024, 128, 8000, "bf16", "ss256", SMS)
    assert (plan.m_tiles, plan.n_tiles, plan.chunks, plan.slices, plan.grid) == (11, 4, 1, 3, 132)
    assert plan.scratch * 4 == 3 * 1408 * 1024 * 4
    # the PV block at K = 1,024: chunks of 16 k steps, 44 units a slice
    pv = kcuda.mma_probe_plan(1408, 128, 1024, 1000, "bf16", "ss128", SMS)
    assert (pv.chunk_steps, pv.chunks, pv.slices, pv.grid) == (16, 4, 3, 132)
