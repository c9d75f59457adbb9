"""The AR transformer under tensor parallelism (``parallel.sharding.
ar_shard_dims`` / ``shard_ar_params``, ``ARTransformer`` with ``model.tp``)
against gen3c_tpu's on the CPU, and K7q's row-scale mode (a row-parallel
W8A8 input, its row split over tp) against JAX's ``w8a8_matmul``.

Two spawned ranks over gloo (``tests/torch_cp_ranks.py``) run the tiny AR
model (fp32, 4 / 2 heads, vocab 512) whole and cut to their tp shards;
JAX runs the replicated ``ar_forward`` on the same weights (the bridge).
Tolerances are gen3c_tpu's own tests' (tests/test_parallel.py:317: 2e-4;
tests/test_quantize.py:195, the quantized "q" and "q8" trees: 1e-4).
Against the port's own single rank the logits hold at 1e-5 and every
greedy generation (bf16 and int8 caches, bucketed, from embeddings)
token for token: the vocab-parallel lookup and the logits' gather are
exact, a row-parallel W8A8 product is exact (its int32 sums are added
over tp), and the row-parallel bf16 / fp32 sums are added in another order.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from gen3c_tpu.models import ar_transformer as jar
from gen3c_tpu.models import quantize as jq
from gen3c_tpu.parallel.sharding import ar_param_pspecs
from gen3c_tpu_torch.bridge import ar_state_from_jax
from gen3c_tpu_torch.kernels import reference
from gen3c_tpu_torch.models import ar_transformer as tar
from gen3c_tpu_torch.models import quantize as tq
from gen3c_tpu_torch.parallel import sharding
from tests import torch_cp_ranks

torch.set_num_threads(2)
CTX = dataclasses.replace(jar.AR_TINY, max_seq_len=64, rope_dim="3D", latent_shape=(4, 4, 4),
                          context_dim=32)


@pytest.fixture(scope="module")
def ranks():
    pool = torch_cp_ranks.Ranks(2)
    yield pool
    pool.close()


def _cfg_kw(jcfg, **over):
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    return {**kw, **over}


def _params(jcfg, quant=None):
    """JAX's seeded fp32 AR tree, quantized (jitted, every leaf: _MIN_SIZE 1)
    for "q" / "q8"."""
    params = jar.init_ar_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    if quant is not None:
        orig = jq._MIN_SIZE
        jq._MIN_SIZE = 1
        try:
            params = jax.jit(partial(jq.quantize_ar_params, act_quant=quant == "q8"))(params)
        finally:
            jq._MIN_SIZE = orig
    return params


def _state(params):
    return {k: v.numpy() for k, v in ar_state_from_jax(jax.tree.map(np.asarray, params)).items()}


@pytest.mark.parametrize("name,quant,tol", [("tiny_1d", None, 2e-4), ("tiny_1d", "q", 1e-4),
                                            ("tiny_1d", "q8", 1e-4), ("tiny_3d_ctx", None, 2e-4)])
def test_ar_tp_forward_matches_jax(ranks, name, quant, tol):
    """AR_TINY at tp 2 (and the 3D-RoPE, cross-attention variant) against
    JAX's replicated ``ar_forward`` (jitted, as the sharded one there), and
    against the port's single rank: each rank runs 2 of the 4 query heads
    and 1 of the 2 KV heads, and holds the whole fp32 logits."""
    jcfg = jar.AR_TINY if name == "tiny_1d" else CTX
    params = _params(jcfg, quant)
    tokens = np.random.RandomState(0).randint(0, 512, (2, 16)).astype(np.int32)
    ctx = None
    if jcfg.context_dim:
        ctx = np.random.RandomState(5).standard_normal((2, 7, 32)).astype(np.float32)
    rope = jar.rope_tables(jcfg)
    want, _ = jax.jit(lambda p, t, c: jar.ar_forward(p, jcfg, t, rope, context=c))(
        params, jnp.asarray(tokens), None if ctx is None else jnp.asarray(ctx))
    got = ranks.run("ar_tp", tp=2, cfg_kw=_cfg_kw(jcfg), state=_state(params), tokens=tokens,
                    quant=quant, context=ctx)
    for r in got:
        np.testing.assert_allclose(r["tp"]["logits"], np.asarray(want), rtol=tol, atol=tol)
        np.testing.assert_allclose(r["tp"]["logits"], r["whole"]["logits"], rtol=1e-5,
                                   atol=1e-5)
        assert r["q_rows"] == jcfg.n_heads // 2 * jcfg.head_dim and r["cache_heads"] == 1
    np.testing.assert_array_equal(got[0]["tp"]["logits"], got[1]["tp"]["logits"])
    if quant == "q8":  # the row-parallel W8A8 products are exact: the same bits as one rank
        np.testing.assert_array_equal(got[0]["tp"]["logits"], got[0]["whole"]["logits"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ar_tp_cached_decode_matches_one_rank(ranks, dtype):
    """Cached decoding on the sharded model (each rank's cache its KV
    heads), bf16 and int8 caches: a teacher-forced decode's logits at every
    step, and greedy generations (plain, left-padded buckets, an
    embedding-space prefill), against one rank. fp32: logits 1e-5, every
    token equal. bf16 rounds each rank's row-parallel partial sums before
    they are added (as GSPMD's bf16 all-reduce does), so there the logits
    hold at 2e-2 (test_torch_ar_transformer.py's bf16 bound) and each
    step's greedy token is held where one rank's best two logits are more
    than twice that apart (a nearer pair is a tie at bf16's resolution)."""
    params = _params(CTX)
    tokens = np.random.RandomState(1).randint(0, 512, (2, 16)).astype(np.int32)
    ctx = np.random.RandomState(6).standard_normal((2, 7, 32)).astype(np.float32)
    got = ranks.run("ar_tp", tp=2, cfg_kw=_cfg_kw(CTX, dtype=dtype), state=_state(params),
                    tokens=tokens, context=ctx, decode=True)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for r in got:
        for kv in (False, True):
            key = f"decode_int8={kv}"
            tp, one = r["tp"][key], r["whole"][key]
            assert tp.shape == (2, 7, 512)
            np.testing.assert_allclose(tp, one, rtol=tol, atol=tol, err_msg=key)
            top2 = np.sort(one, axis=-1)[..., -2:]
            clear = top2[..., 1] - top2[..., 0] > 2 * tol
            assert clear.mean() > 0.5, key
            np.testing.assert_array_equal(tp.argmax(-1)[clear], one.argmax(-1)[clear])
        if dtype == "float32":
            for key in ("generate_int8=False", "generate_int8=True", "bucketed", "embeddings"):
                np.testing.assert_array_equal(r["tp"][key], r["whole"][key], err_msg=key)
    assert got[0]["tp"]["generate_int8=False"].shape == (2, 22)
    for key in ("generate_int8=False", "generate_int8=True", "bucketed", "embeddings"):
        np.testing.assert_array_equal(got[0]["tp"][key], got[1]["tp"][key], err_msg=key)


def _coded_dims(tree, specs, port_keys):
    """The dimension of each port entry that varies after JAX's tp
    dimension of each leaf is coded with its index (the bridge transposes
    the linears)."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    flat = jax.tree_util.tree_leaves(specs, is_leaf=lambda s: isinstance(s, P))
    assert len(flat) == len(leaves)
    coded = []
    for leaf, spec in zip(leaves, flat):
        a = np.zeros(np.shape(leaf), np.float32)
        for d, axis in enumerate(spec):
            if axis == "tp":
                a = a + np.arange(1, a.shape[d] + 1, dtype=np.float32).reshape(
                    [-1 if i == d else 1 for i in range(a.ndim)])
        coded.append(a)
    port = ar_state_from_jax(jax.tree_util.tree_unflatten(treedef, coded))
    assert set(port) == set(port_keys)
    want = {}
    for k, v in port.items():
        v = v.numpy()
        varies = [d for d in range(v.ndim) if (v != v.take([0], axis=d)).any()]
        assert len(varies) <= 1, k
        want[k] = varies[0] if varies else None
    return want


@pytest.mark.parametrize("name,quant", [("tiny_1d", None), ("tiny_3d_ctx", None),
                                        ("tiny_1d", "q"), ("tiny_3d_ctx", "q8")])
def test_ar_shard_dims_match_jax_pspecs(name, quant):
    """``ar_shard_dims`` names, entry for entry, the dimension JAX's
    ``ar_param_pspecs`` shards over tp (tests/test_quantize.py:195): the
    column linears' rows (and a quantized one's per-row scales), the row
    linears' columns (their scales whole), the table's and the LM head's
    vocab rows."""
    jcfg = jar.AR_TINY if name == "tiny_1d" else CTX
    params = _params(jcfg, quant)
    model = tar.ARTransformer(tar.ARConfig(**_cfg_kw(jcfg, dtype=torch.float32)))
    if quant is not None:
        tq.quantize_ar_params(model, act_quant=quant == "q8", structure_only=True, min_size=1)
    got = sharding.ar_shard_dims(model)
    assert got == _coded_dims(params, ar_param_pspecs(params), model.state_dict())
    assert got["tok_embeddings.weight"] == 0 and got["output.weight"] == 0
    assert got["layers.0.attention.wq.weight"] == 0 and got["layers.0.attention.wo.weight"] == 1
    if quant is not None:
        assert got["layers.0.attention.wq.scale"] == 0 and got["layers.0.attention.wo.scale"] is None


def test_shard_ar_params_refuses_heads_that_do_not_split():
    """n_heads and n_kv_heads must divide tp (gen3c_tpu's docstring); a
    model cut for one tp size refuses another."""
    from gen3c_tpu_torch.parallel.mesh import Axis, Groups

    model = tar.ARTransformer(dataclasses.replace(tar.AR_TINY, n_kv_heads=1))
    with pytest.raises(ValueError, match="must divide tp=2"):
        sharding.shard_ar_params(model, Groups(tp=Axis(None, 0, 2)))
    assert sharding.shard_ar_params(model, Groups()) == {}


def test_row_scale_quantize_matches_jax_w8a8_on_a_split_row():
    """K7q's plain version with a row scale taken elsewhere: each half of
    x's columns quantized with the max of both halves' row absmax, K7's
    int32 products of the halves summed, then rescaled, is jitted JAX's
    ``w8a8_matmul`` on the whole row, bit for bit (and each half's codes
    and scale those of the whole row)."""
    rng = np.random.RandomState(3)
    x = rng.standard_normal((37, 96)).astype(np.float32) * np.linspace(0.1, 3, 96, dtype=np.float32)
    w = rng.standard_normal((96, 40)).astype(np.float32)
    entry = jax.jit(lambda w: jq.quantize_linear(w, act_quant=True))(jnp.asarray(w))
    want = np.asarray(jax.jit(lambda x, e: jq.w8a8_matmul(x, e, jnp.float32))(
        jnp.asarray(x), entry))
    wq = torch.from_numpy(np.asarray(entry["q8"]).T.copy())
    ws = torch.from_numpy(np.array(entry["scale"]).reshape(-1))
    xt = torch.from_numpy(x)
    halves = (slice(0, 40), slice(40, 96))  # an uneven split: the row scale is the max
    amax = torch.maximum(*(reference.row_absmax_reference(xt[:, h]) for h in halves))
    whole_codes, whole_scale = reference.quantize_rows_reference(xt)
    acc = torch.zeros((37, 40), dtype=torch.int32)
    for h in halves:
        codes, scale = reference.quantize_rows_reference(xt[:, h], amax)
        assert torch.equal(codes, whole_codes[:, h]) and torch.equal(scale, whole_scale)
        acc += reference.int8_matmul_reference(codes, wq[:, h])
    got = acc.float().mul_(whole_scale[:, None]).mul_(ws[None, :]).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        reference.w8a8_matmul_reference(xt, wq, ws, torch.float32).numpy(), want)
