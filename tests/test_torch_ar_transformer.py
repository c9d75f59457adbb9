"""The port's AR transformer against gen3c_tpu's on the CPU.

Weights go JAX -> port through ``bridge.ar_state_from_jax``; inputs are
numpy. RoPE tables must be bit-equal (both form them in float64 and cast).
Logits are held at atol 1e-5 (fp32 on both sides, summation order apart).
Wherever a scale is ``absmax / 127`` (the int8 KV cache, the quantized
weights) JAX is jitted, because XLA compiles that division into the fp32
reciprocal multiply the port reproduces. Generations are equal token for
token: greedy, and sampled with JAX's own Gumbel draws handed to the port
(step 0: the key; step i: ``split(fold_in(key, 1), n - 1)[i - 1]``).
K8's plain version is held to ``_gqa_attention`` for every mask form at
atol 1e-5 (fp32) and 2e-2 (bf16: both round the logits to bf16, in other
orders). The converters give the same tensors as JAX's on seeded state
dicts, bits equal.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gen3c_tpu.models import ar_transformer as jar
from gen3c_tpu.models import convert as jconv
from gen3c_tpu.models import quantize as jq
from gen3c_tpu_torch.bridge import ar_state_from_jax
from gen3c_tpu_torch.kernels import reference
from gen3c_tpu_torch.models import ar_transformer as tar
from gen3c_tpu_torch.models import convert as tconv
from gen3c_tpu_torch.models import quantize as tq

torch.set_num_threads(2)

ATOL = 1e-5

CTX_J = dataclasses.replace(jar.AR_TINY, max_seq_len=64, rope_dim="3D", latent_shape=(4, 4, 4),
                            context_dim=32)
CONFIGS = {"tiny_1d": (jar.AR_TINY, tar.AR_TINY),
           "tiny_3d_ctx": (CTX_J, dataclasses.replace(tar.AR_TINY, max_seq_len=64,
                                                      rope_dim="3D", latent_shape=(4, 4, 4),
                                                      context_dim=32))}


def _port_cfg(jcfg, **kw):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    return tar.ARConfig(**{**fields, **kw, "dtype": torch.float32})


_MODELS = {}


def _models(name):
    """(JAX params, port model, JAX cfg) on shared fp32 weights."""
    if name not in _MODELS:
        jcfg, tcfg = CONFIGS[name]
        params = jar.init_ar_params(jax.random.PRNGKey(0), jcfg)
        model = tar.ARTransformer(tcfg)
        model.load_state_dict(ar_state_from_jax(jax.tree.map(np.asarray, params)))
        _MODELS[name] = (params, model, jcfg)
    return _MODELS[name]


def _close(got, want, atol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol, rtol=0)


def _context(name, B, seed=5):
    jcfg = CONFIGS[name][0]
    if not jcfg.context_dim:
        return None
    return np.random.RandomState(seed).standard_normal((B, 7, jcfg.context_dim)).astype(np.float32)


def _tokens(B, L, vocab, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (B, L)).astype(np.int32)


# ------------------------------ rope ------------------------------

ROPE_CFGS = {
    "1d": jar.AR_TINY,
    "3d": dataclasses.replace(jar.AR_TINY, rope_dim="3D", latent_shape=(3, 5, 7), max_seq_len=120),
    "yarn_1d": dataclasses.replace(jar.AR_TINY, apply_yarn=True, yarn_scale=4.0,
                                   original_seq_len=64),
    "yarn_3d": dataclasses.replace(jar.AR_TINY, rope_dim="3D", latent_shape=(5, 8, 8),
                                   max_seq_len=320, apply_yarn=True, yarn_scale=2.0,
                                   original_latent_shape=(3, 4, 4)),
    "llama3": dataclasses.replace(jar.AR_TINY, rope_theta=500000.0,
                                  rope_scaling=(8.0, 1.0, 4.0, 64)),
}


@pytest.mark.parametrize("name", sorted(ROPE_CFGS))
def test_rope_tables_bit_equal(name):
    jcfg = ROPE_CFGS[name]
    jcos, jsin = jar.rope_tables(jcfg)
    tcos, tsin = tar.rope_tables(_port_cfg(jcfg))
    assert tcos.dtype == tsin.dtype == torch.float32
    np.testing.assert_array_equal(tcos.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(tsin.numpy(), np.asarray(jsin))


# ------------------------------ the forward ------------------------------


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("mode", ["prefill", "cache", "pad_lens", "embeddings"])
def test_forward_logits_match_jax(name, mode):
    """ar_forward's logits: a full causal prefill; a cache filled by a
    prefill then two decode steps; a left-padded prefill and decode step
    (pad_lens); an embedding-space prefill."""
    params, model, jcfg = _models(name)
    B, L = 2, 12
    toks = _tokens(B, L, jcfg.vocab_size)
    ctx = _context(name, B)
    jctx = None if ctx is None else jnp.asarray(ctx)
    tctx = None if ctx is None else torch.from_numpy(ctx)
    rope = jar.rope_tables(jcfg)
    if mode == "prefill":
        lj, _ = jar.ar_forward(params, jcfg, jnp.asarray(toks), rope, context=jctx)
        lt, _ = model(torch.from_numpy(toks), context=tctx)
        _close(lt, lj)
        return
    if mode == "embeddings":
        emb = np.random.RandomState(2).standard_normal((B, L, jcfg.dim)).astype(np.float32)
        cj = jar.init_kv_cache(jcfg, B, dtype=jnp.float32)
        lj, _ = jar.ar_forward(params, jcfg, None, rope, cj, jctx,
                               input_embeddings=jnp.asarray(emb))
        ct = tar.init_kv_cache(model.cfg, B, dtype=torch.float32)
        lt, ct = model(None, cache=ct, context=tctx, input_embeddings=torch.from_numpy(emb))
        _close(lt, lj)
        assert ct.pos == L
        return
    pads = np.array([0, 5], np.int32) if mode == "pad_lens" else None
    jpads = None if pads is None else jnp.asarray(pads)
    tpads = None if pads is None else torch.from_numpy(pads)
    cj = jar.init_kv_cache(jcfg, B, dtype=jnp.float32)
    ct = tar.init_kv_cache(model.cfg, B, dtype=torch.float32)
    lj, cj = jar.ar_forward(params, jcfg, jnp.asarray(toks), rope, cj, jctx, jpads)
    lt, ct = model(torch.from_numpy(toks), cache=ct, context=tctx, pad_lens=tpads)
    _close(lt, lj)
    for step in range(2):
        nxt = _tokens(B, 1, jcfg.vocab_size, seed=10 + step)
        lj, cj = jar.ar_forward(params, jcfg, jnp.asarray(nxt), rope, cj, jctx, jpads)
        lt, ct = model(torch.from_numpy(nxt), cache=ct, context=tctx, pad_lens=tpads)
        _close(lt, lj)
    assert ct.pos == int(cj.pos) == L + 2
    _close(ct.k, cj.k)
    _close(ct.v, cj.v)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_int8_kv_cache_matches_jitted_jax(name):
    """The int8 cache: codes equal and scales within fp32 rounding of jitted
    JAX's, and the logits of a prefill and two decode steps."""
    params, model, jcfg = _models(name)
    B, L = 2, 10
    ctx = _context(name, B)
    jctx = None if ctx is None else jnp.asarray(ctx)
    tctx = None if ctx is None else torch.from_numpy(ctx)
    rope = jar.rope_tables(jcfg)
    fwd = jax.jit(jar.ar_forward, static_argnums=(1,))
    cj = jar.init_kv_cache(jcfg, B, quantized=True)
    ct = tar.init_kv_cache(model.cfg, B, quantized=True)
    for step, toks in enumerate([_tokens(B, L, jcfg.vocab_size), _tokens(B, 1, 512, 3),
                                 _tokens(B, 1, 512, 4)]):
        lj, cj = fwd(params, jcfg, jnp.asarray(toks), rope, cj, jctx)
        lt, ct = model(torch.from_numpy(toks), cache=ct, context=tctx)
        _close(lt, lj)
    np.testing.assert_array_equal(ct.k.numpy(), np.asarray(cj.k))
    np.testing.assert_array_equal(ct.v.numpy(), np.asarray(cj.v))
    # the scales of k vectors that differ by fp32 rounding (the projections'
    # summation order) differ by as much
    np.testing.assert_allclose(ct.k_scale.numpy(), np.asarray(cj.k_scale), rtol=1e-6, atol=0)
    np.testing.assert_allclose(ct.v_scale.numpy(), np.asarray(cj.v_scale), rtol=1e-6, atol=0)


@pytest.mark.parametrize("act_quant", [False, True])
def test_quantized_weights_match_jitted_jax(monkeypatch, act_quant):
    """quantize_ar_params ("q" weight-only, "q8" W8A8): the same int8 codes
    and scales as jitted JAX (every linear and the token table: _MIN_SIZE
    lowered in both packages), then the same logits with a cache."""
    monkeypatch.setattr(jq, "_MIN_SIZE", 1)
    monkeypatch.setattr(tq, "_MIN_SIZE", 1)
    params, _, jcfg = _models("tiny_3d_ctx")
    qparams = jax.jit(partial(jq.quantize_ar_params, act_quant=act_quant))(params)
    model = tar.ARTransformer(CONFIGS["tiny_3d_ctx"][1])
    model.load_state_dict(ar_state_from_jax(jax.tree.map(np.asarray, params)))
    tq.quantize_ar_params(model, act_quant=act_quant)
    want = ar_state_from_jax(jax.tree.map(np.asarray, qparams))
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    assert isinstance(model.tok_embeddings, tq.QuantEmbedding)
    assert all(lin.act_quant == act_quant for lin in model.modules()
               if isinstance(lin, tq.QuantLinear))
    B = 2
    ctx = _context("tiny_3d_ctx", B)
    rope = jar.rope_tables(jcfg)
    fwd = jax.jit(jar.ar_forward, static_argnums=(1,))
    cj = jar.init_kv_cache(jcfg, B, dtype=jnp.float32)
    ct = tar.init_kv_cache(model.cfg, B, dtype=torch.float32)
    for toks in (_tokens(B, 9, 512), _tokens(B, 1, 512, 7)):
        lj, cj = fwd(qparams, jcfg, jnp.asarray(toks), rope, cj, jnp.asarray(ctx))
        lt, ct = model(torch.from_numpy(toks), cache=ct, context=torch.from_numpy(ctx))
        _close(lt, lj)


def test_quantized_state_loads_into_structure(monkeypatch):
    """A quantized JAX tree loads into structure_only quantized layers, and
    quantize_ar_params_transfer places the quantized layers on a device."""
    monkeypatch.setattr(jq, "_MIN_SIZE", 1 << 14)
    monkeypatch.setattr(tq, "_MIN_SIZE", 1 << 14)
    params, _, _ = _models("tiny_1d")
    qparams = jax.jit(jq.quantize_ar_params)(params)
    model = tar.ARTransformer(tar.AR_TINY)
    tq.quantize_ar_params(model, structure_only=True)
    model.load_state_dict(ar_state_from_jax(jax.tree.map(np.asarray, qparams)))
    kinds = {n: type(m).__name__ for n, m in model.named_modules()
             if n.endswith(("wq", "wk", "w1", "output", "tok_embeddings"))}
    # wk (128 x 64) is below 2^14 elements and stays a plain linear, as in JAX
    assert kinds["layers.0.attention.wq"] == "QuantLinear"
    assert kinds["layers.0.attention.wk"] == "Linear"
    assert kinds["tok_embeddings"] == "QuantEmbedding"
    moved = tar.ARTransformer(tar.AR_TINY)
    moved.load_state_dict(ar_state_from_jax(jax.tree.map(np.asarray, params)))
    moved = tq.quantize_ar_params_transfer(moved, device="cpu")
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(moved.state_dict()[k].numpy(), v.numpy())


def test_maybe_quantized_convert(monkeypatch):
    monkeypatch.setattr(tq, "_MIN_SIZE", 1 << 14)
    built = []

    def convert(device):
        built.append(str(device))
        return tar.ARTransformer(tar.AR_TINY, device=device)

    monkeypatch.delenv("GEN3C_QUANTIZE_LLM", raising=False)
    plain = tq.maybe_quantized_convert(convert, device="cpu")
    assert isinstance(plain.layers[0].attention.wq, torch.nn.Linear)
    monkeypatch.setenv("GEN3C_QUANTIZE_LLM", "1")
    quant = tq.maybe_quantized_convert(convert, device="cpu")
    assert isinstance(quant.layers[0].attention.wq, tq.QuantLinear)
    assert built == ["cpu", "cpu"]


# ------------------------------ sampling ------------------------------


def test_sample_logits_greedy_and_filters(monkeypatch):
    """Temperature 0 is the argmax; the logits top-k / top-p leave for the
    draw are JAX's (categorical patched to hand them back)."""
    logits = np.random.RandomState(0).standard_normal((3, 512)).astype(np.float32) * 3
    got = tar.sample_logits(torch.from_numpy(logits), temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.argmax(logits, -1))
    monkeypatch.setattr(jax.random, "categorical", lambda key, lg, axis=-1: lg)
    for temperature, top_k, top_p in ((1.0, 0, 0.0), (0.7, 20, 0.0), (1.0, 0, 0.8),
                                      (1.3, 50, 0.5)):
        want = jar.sample_logits(jax.random.PRNGKey(0), jnp.asarray(logits), temperature,
                                 top_k, top_p)
        got = tar.filter_logits(torch.from_numpy(logits), temperature, top_k, top_p)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
        assert ((got.numpy() == -1e30) == (np.asarray(want) == -1e30)).all()


def _jax_gumbel(key, n, shape):
    """The Gumbel noise JAX's generate draws at each of its n samples."""
    keys = [key] + list(jax.random.split(jax.random.fold_in(key, 1), n - 1))
    draws = [np.asarray(jax.random.gumbel(k, shape, jnp.float32)) for k in keys]
    return lambda step, shp, device: torch.tensor(draws[step], device=device)


SAMPLING = {"greedy": (0.0, 0, 0.0), "sampled": (1.0, 0, 0.9), "top_k": (0.8, 40, 0.0)}


@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("quantize_kv", [False, True])
def test_generate_token_for_token(sampling, quantize_kv):
    params, model, jcfg = _models("tiny_3d_ctx")
    temperature, top_k, top_p = SAMPLING[sampling]
    B, n = 2, 9
    toks = _tokens(B, 11, jcfg.vocab_size, 1)
    ctx = _context("tiny_3d_ctx", B)
    key = jax.random.PRNGKey(4)
    want = jar.generate(params, jcfg, jnp.asarray(toks), key, n, temperature, top_k, top_p,
                        jnp.asarray(ctx), quantize_kv)
    got = tar.generate(model, toks, n, temperature, top_k, top_p, torch.from_numpy(ctx),
                       quantize_kv, gumbel=_jax_gumbel(key, n, (B, jcfg.vocab_size)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
def test_generate_padded_and_bucketed(sampling):
    params, model, jcfg = _models("tiny_1d")
    temperature, top_k, top_p = SAMPLING[sampling]
    rows = [_tokens(1, 13, 512, 2)[0], _tokens(1, 6, 512, 3)[0]]
    n, key, bucket = 7, jax.random.PRNGKey(9), 16
    noise = _jax_gumbel(key, n, (2, jcfg.vocab_size))
    want = jar.generate_bucketed(params, jcfg, rows, key, n, temperature, top_k, top_p,
                                 bucket=bucket)
    got = tar.generate_bucketed(model, rows, n, temperature, top_k, top_p, bucket=bucket,
                                gumbel=noise)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    padded = np.asarray(want)[:, :bucket]
    pads = np.array([3, 10], np.int32)
    want = jar.generate_padded(params, jcfg, jnp.asarray(padded), jnp.asarray(pads), key, n,
                               temperature, top_k, top_p)
    got = tar.generate_padded(model, padded, pads, n, temperature, top_k, top_p, gumbel=noise)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bucketed", [False, True])
@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
def test_generate_with_embeddings(bucketed, sampling):
    params, model, jcfg = _models("tiny_1d")
    temperature, top_k, top_p = SAMPLING[sampling]
    emb = np.random.RandomState(6).standard_normal((2, 10, jcfg.dim)).astype(np.float32)
    n, key = 6, jax.random.PRNGKey(2)
    noise = _jax_gumbel(key, n, (2, jcfg.vocab_size))
    if bucketed:
        want = jar.generate_with_embeddings_bucketed(params, jcfg, jnp.asarray(emb), key, n,
                                                     temperature, top_k, top_p, bucket=16)
        got = tar.generate_with_embeddings_bucketed(model, torch.from_numpy(emb), n,
                                                    temperature, top_k, top_p, bucket=16,
                                                    gumbel=noise)
    else:
        want = jar.generate_with_embeddings(params, jcfg, jnp.asarray(emb), key, n, temperature,
                                            top_k, top_p)
        got = tar.generate_with_embeddings(model, torch.from_numpy(emb), n, temperature, top_k,
                                           top_p, gumbel=noise)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_default_gumbel_source_is_seeded():
    _, model, _ = _models("tiny_1d")
    toks = _tokens(1, 5, 512)
    a = tar.generate(model, toks, 6, temperature=1.0, seed=3)
    b = tar.generate(model, toks, 6, temperature=1.0, seed=3)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError):
        tar.sample_logits(torch.zeros(1, 8), temperature=1.0)


# ------------------------------ K8's plain version ------------------------------

GQA_CASES = {
    "prefill": dict(Lq=9, Lk=9, offset=0, start=None),
    "decode": dict(Lq=1, Lk=20, offset=13, start=None),
    "chunk_past_pads": dict(Lq=4, Lk=20, offset=6, start=(0, 8)),
    "cross": dict(Lq=5, Lk=7, offset=None, start=None),
    "cross_pads": dict(Lq=5, Lk=7, offset=None, start=(2, 0)),
}


@pytest.mark.parametrize("case", sorted(GQA_CASES))
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_plain_version_matches_jax(case, int8, dtype):
    c = GQA_CASES[case]
    rs = np.random.RandomState(0)
    B, Hq, Hkv, d = 2, 8, 2, 16
    q = rs.standard_normal((B, c["Lq"], Hq, d)).astype(np.float32)
    if int8:
        k, v = (rs.randint(-127, 128, (B, c["Lk"], Hkv, d)).astype(np.int8) for _ in range(2))
        ks, vs = (rs.uniform(1e-3, 2e-2, (B, c["Lk"], Hkv, 1)).astype(np.float32)
                  for _ in range(2))
    else:
        k, v = (rs.standard_normal((B, c["Lk"], Hkv, d)).astype(np.float32) for _ in range(2))
        ks = vs = None
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                          torch.float32)

    def jx(a, cast=True):
        return None if a is None else jnp.asarray(a, jdt if cast else None)

    def tt(a, cast=True):
        return None if a is None else (torch.from_numpy(a).to(tdt) if cast
                                       else torch.from_numpy(a))

    start = None if c["start"] is None else np.array(c["start"], np.int32)
    off = c["offset"]
    want = jar._gqa_attention(jx(q), jx(k, not int8), jx(v, not int8),
                              None if off is None else jnp.asarray(off),
                              None if start is None else jnp.asarray(start), jx(ks, False),
                              jx(vs, False))
    got = reference.gqa_attention_reference(tt(q), tt(k, not int8), tt(v, not int8), off,
                                            None if start is None else torch.from_numpy(start),
                                            tt(ks, False), tt(vs, False))
    assert got.dtype == tdt
    _close(got, np.asarray(want.astype(jnp.float32)), ATOL if dtype == "float32" else 2e-2)


# ------------------------------ converters and bridge ------------------------------


def _cosmos_state_dict(jcfg, seed=0):
    """A seeded Cosmos AR state dict (reference names, (out, in) linears)."""
    rs = np.random.RandomState(seed)
    hd = jcfg.head_dim
    sd = {"tok_embeddings.weight": rs.standard_normal((jcfg.vocab_size, jcfg.dim)),
          "norm.weight": rs.standard_normal((jcfg.dim,)),
          "output.weight": rs.standard_normal((jcfg.vocab_size, jcfg.dim))}
    for i in range(jcfg.n_layers):
        pre = f"layers.{i}"
        sd[f"{pre}.attention.wq.weight"] = rs.standard_normal((jcfg.n_heads * hd, jcfg.dim))
        sd[f"{pre}.attention.wk.weight"] = rs.standard_normal((jcfg.n_kv_heads * hd, jcfg.dim))
        sd[f"{pre}.attention.wv.weight"] = rs.standard_normal((jcfg.n_kv_heads * hd, jcfg.dim))
        sd[f"{pre}.attention.wo.weight"] = rs.standard_normal((jcfg.dim, jcfg.n_heads * hd))
        sd[f"{pre}.feed_forward.w1.weight"] = rs.standard_normal((jcfg.ffn_hidden_size, jcfg.dim))
        sd[f"{pre}.feed_forward.w2.weight"] = rs.standard_normal((jcfg.dim, jcfg.ffn_hidden_size))
        sd[f"{pre}.feed_forward.w3.weight"] = rs.standard_normal((jcfg.ffn_hidden_size, jcfg.dim))
        sd[f"{pre}.attention_norm.weight"] = rs.standard_normal((jcfg.dim,))
        sd[f"{pre}.ffn_norm.weight"] = rs.standard_normal((jcfg.dim,))
        if jcfg.use_qk_normalization:
            sd[f"{pre}.attention.q_norm.weight"] = rs.standard_normal((hd,))
            sd[f"{pre}.attention.k_norm.weight"] = rs.standard_normal((hd,))
        if jcfg.context_dim:
            c = jcfg.context_dim
            sd[f"{pre}.cross_attention_norm.weight"] = rs.standard_normal((jcfg.dim,))
            sd[f"{pre}.cross_attention.wq.weight"] = rs.standard_normal((jcfg.n_heads * hd,
                                                                         jcfg.dim))
            sd[f"{pre}.cross_attention.wk.weight"] = rs.standard_normal((jcfg.n_kv_heads * hd, c))
            sd[f"{pre}.cross_attention.wv.weight"] = rs.standard_normal((jcfg.n_kv_heads * hd, c))
            sd[f"{pre}.cross_attention.wo.weight"] = rs.standard_normal((jcfg.dim,
                                                                         jcfg.n_heads * hd))
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}


def _assert_state_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k].float().numpy(), v.float().numpy(), err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_convert_cosmos_ar_state_dict(name, dtype):
    jcfg, tcfg = CONFIGS[name]
    sd = _cosmos_state_dict(jcfg)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                          torch.float32)
    want = ar_state_from_jax(jax.tree.map(np.asarray, jconv.convert_cosmos_ar_state_dict(
        sd, jcfg, jdt)))
    got = tconv.convert_cosmos_ar_state_dict(sd, tcfg, tdt)
    _assert_state_equal(got, want)
    model = tar.ARTransformer(tcfg)
    model.load_state_dict(got)  # strict: every key the network has, and no other


@pytest.mark.parametrize("tied", [False, True])
def test_convert_hf_llama(tied):
    jcfg = dataclasses.replace(jar.AR_TINY, use_qk_normalization=False)
    tcfg = _port_cfg(jcfg)
    rs = np.random.RandomState(1)
    hd = jcfg.head_dim
    sd = {"model.embed_tokens.weight": rs.standard_normal((jcfg.vocab_size, jcfg.dim)),
          "model.norm.weight": rs.standard_normal((jcfg.dim,))}
    if not tied:
        sd["lm_head.weight"] = rs.standard_normal((jcfg.vocab_size, jcfg.dim))
    shapes = {"self_attn.q_proj": (jcfg.n_heads * hd, jcfg.dim),
              "self_attn.k_proj": (jcfg.n_kv_heads * hd, jcfg.dim),
              "self_attn.v_proj": (jcfg.n_kv_heads * hd, jcfg.dim),
              "self_attn.o_proj": (jcfg.dim, jcfg.n_heads * hd),
              "mlp.gate_proj": (jcfg.ffn_hidden_size, jcfg.dim),
              "mlp.down_proj": (jcfg.dim, jcfg.ffn_hidden_size),
              "mlp.up_proj": (jcfg.ffn_hidden_size, jcfg.dim),
              "input_layernorm": (jcfg.dim,), "post_attention_layernorm": (jcfg.dim,)}
    for i in range(jcfg.n_layers):
        for name, shape in shapes.items():
            sd[f"model.layers.{i}.{name}.weight"] = rs.standard_normal(shape)
    sd = {k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}
    want = ar_state_from_jax(jax.tree.map(np.asarray, jconv.convert_hf_llama(sd, jcfg)))
    got = tconv.convert_hf_llama(sd, tcfg)
    _assert_state_equal(got, want)
    tar.ARTransformer(tcfg).load_state_dict(got)


@pytest.mark.parametrize("prefix", ["", "model."])
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_shard_and_merge(prefix, tp):
    jcfg = dataclasses.replace(CTX_J, n_heads=8, n_kv_heads=4, dim=128)
    sd = {prefix + k: v for k, v in _cosmos_state_dict(jcfg, seed=2).items()}
    kw = dict(n_heads=jcfg.n_heads, n_kv_heads=jcfg.n_kv_heads, dim=jcfg.dim,
              context_dim=jcfg.context_dim)
    np_sd = {k: v.numpy() for k, v in sd.items()}
    shards = []
    for rank in range(tp):
        want = jconv.shard_ar_tp_state_dict(np_sd, tp, rank, **kw)
        got = tconv.shard_ar_tp_state_dict(sd, tp, rank, **kw)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
        shards.append(got)
    want = jconv.merge_ar_tp_state_dicts([{k: v.numpy() for k, v in s.items()} for s in shards],
                                         **kw)
    merged = tconv.merge_ar_tp_state_dicts(shards, **kw)
    for k in want:
        np.testing.assert_array_equal(merged[k].numpy(), want[k], err_msg=k)
        np.testing.assert_array_equal(merged[k].numpy(), sd[k].numpy(), err_msg=k)
    bad = [dict(s) for s in shards]
    bad[1][prefix + "norm.weight"] = bad[1][prefix + "norm.weight"] + 10.0
    with pytest.raises(ValueError):
        tconv.merge_ar_tp_state_dicts(bad, **kw)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_ar_state_from_jax_covers_the_module(name):
    """Every parameter of the port's network comes from the JAX tree, with
    the linears transposed and the norms as they are."""
    params, model, jcfg = _models(name)
    sd = ar_state_from_jax(jax.tree.map(np.asarray, params))
    assert set(sd) == set(model.state_dict())
    np.testing.assert_array_equal(sd["layers.1.attention.wq.weight"].numpy(),
                                  np.asarray(params["layers"][1]["wq"]).T)
    np.testing.assert_array_equal(sd["layers.0.attention_norm.weight"].numpy(),
                                  np.asarray(params["layers"][0]["attention_norm"]["scale"]))
    assert model.layers[0].attention_norm.weight.dtype == torch.float32
