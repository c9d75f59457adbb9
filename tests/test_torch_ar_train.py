"""The port's AR training against gen3c_tpu's on the CPU.

JAX's seeded AR weights go into the port through
``bridge.ar_state_from_jax``; tokens and contexts are numpy. fp32 on both
sides: ``ar_loss`` (label smoothing, z-loss, accuracy) to rtol 1e-5 and
every parameter's gradient to 1e-4 of its largest element (JAX jitted;
the port's loss sums its terms in token chunks and recomputes each layer).
K8bwd's plain version, ``gqa_attention_backward_reference``, is held to
jax.grad of ``_gqa_attention`` at atol 1e-5 for every mask form: causal,
causal with left padding (rows that see no key), the cross-attention's
``causal_offset=None`` with and without ``kv_valid_start``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gen3c_tpu.models import ar_transformer as jar
from gen3c_tpu.pipelines import autoregressive as jauto
from gen3c_tpu.training import ar_train as jtrain
from gen3c_tpu_torch import kernels
from gen3c_tpu_torch.bridge import ar_state_from_jax
from gen3c_tpu_torch.kernels import reference
from gen3c_tpu_torch.models import ar_transformer as tar
from gen3c_tpu_torch.training import ar_train as ttrain
from gen3c_tpu_torch.training.train_step import AdamW, trainable_params

torch.set_num_threads(2)

CTX_J = dataclasses.replace(jar.AR_TINY, max_seq_len=64, context_dim=24, n_layers=2)
CONFIGS = {"ar_tiny_1d": jar.AR_TINY, "ar_tiny_video": jauto.AR_TINY_VIDEO, "tiny_context": CTX_J}


def _port_cfg(jcfg):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    return tar.ARConfig(**{**fields, "dtype": torch.float32})


_MODELS = {}


def _models(name):
    if name not in _MODELS:
        jcfg = CONFIGS[name]
        params = jar.init_ar_params(jax.random.PRNGKey(0), jcfg)
        model = tar.ARTransformer(_port_cfg(jcfg))
        model.load_state_dict(ar_state_from_jax(jax.tree_util.tree_map(np.asarray, params)))
        _MODELS[name] = (params, model, jcfg)
    return _MODELS[name]


def _inputs(jcfg, seed, L=None):
    rng = np.random.RandomState(seed)
    L = L or min(jcfg.max_seq_len, 65)
    tokens = rng.randint(0, jcfg.vocab_size, (2, L)).astype(np.int32)
    ctx = (rng.randn(2, 7, jcfg.context_dim).astype(np.float32) if jcfg.context_dim else None)
    return tokens, ctx


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("smoothing,z", [(0.0, 1e-4), (0.1, 1e-3)])
def test_ar_loss_and_grads_match_jax(name, smoothing, z):
    params, model, jcfg = _models(name)
    tokens, ctx = _inputs(jcfg, 1)
    jctx = None if ctx is None else jnp.asarray(ctx)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jtrain.ar_loss(p, jcfg, jnp.asarray(tokens), jctx, smoothing, z),
        has_aux=True))(params)
    tparams = trainable_params(model)
    tloss, tm = ttrain.ar_loss(model, torch.from_numpy(tokens).long(),
                               None if ctx is None else torch.from_numpy(ctx), smoothing, z,
                               loss_chunk=24)
    grads = torch.autograd.grad(tloss, list(tparams.values()))
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(tm["accuracy"]), float(jm["accuracy"]), atol=1e-7)
    want = ar_state_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    assert set(want) == set(tparams)
    for (n, p), g in zip(tparams.items(), grads):
        w = want[n].numpy()
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max() + 1e-12, rtol=1e-3,
                                   err_msg=n)
    for p in tparams.values():
        p.requires_grad_(False)


def test_inference_forward_unchanged_by_the_training_path():
    """``train_hidden`` times the output matrix is the inference forward's
    logits, bit for bit."""
    params, model, jcfg = _models("tiny_context")
    tokens, ctx = _inputs(jcfg, 2, L=33)
    t, c = torch.from_numpy(tokens).long(), torch.from_numpy(ctx)
    want, _ = model(t, context=c)
    got = tar._mm(tar.train_hidden(model, t, c), model.output).float()
    assert torch.equal(got, want)


def test_ar_train_step_matches_optax_adamw():
    params, model0, jcfg = _models("ar_tiny_1d")
    model = tar.ARTransformer(model0.cfg)
    model.load_state_dict(model0.state_dict())
    opt_j = optax.adamw(1e-3)
    jp, js = params, opt_j.init(params)
    opt_t = AdamW(1e-3)
    tparams = trainable_params(model)
    ts = opt_t.init(tparams)
    for seed in (3, 4):
        tokens, _ = _inputs(jcfg, seed)
        jp, js, jm = jax.jit(lambda p, s, t: jtrain.ar_train_step(p, s, t, jcfg, opt_j))(
            jp, js, jnp.asarray(tokens))
        model, ts, tm = ttrain.ar_train_step(model, ts, torch.from_numpy(tokens).long(), opt_t)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    want = ar_state_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    got = np.concatenate([tparams[n].detach().numpy().ravel() for n in sorted(want)])
    ref = np.concatenate([want[n].numpy().ravel() for n in sorted(want)])
    off = np.abs(got - ref) > 1e-6 + 1e-4 * np.abs(ref)
    assert off.mean() < 0.01 and np.abs(got - ref).max() < 4e-3


SHORT = {"rep4_four_tokens": (dataclasses.replace(jar.AR_TINY, n_heads=8, n_kv_heads=2), 5),
         "rep4_one_token": (dataclasses.replace(jar.AR_TINY, n_heads=8, n_kv_heads=2), 2),
         "rep2_d36": (dataclasses.replace(jar.AR_TINY, dim=144, n_heads=4, n_kv_heads=2), 9)}


@pytest.mark.parametrize("name", sorted(SHORT))
def test_ar_train_step_at_short_and_padded_shapes_matches_jax_grad(name):
    """``ar_train_step`` where K8's training forward and K8bwd see a decode
    body's shape (4 query tokens, or 1, at rep 4: Lq * rep <= 16) or a head
    width off the multiple of 8 (d 36, padded to 40 on a card): the loss,
    every gradient (``jax.grad`` on shared weights) and the AdamW step agree
    with JAX's."""
    jcfg, L = SHORT[name]
    params = jar.init_ar_params(jax.random.PRNGKey(1), jcfg)
    model = tar.ARTransformer(_port_cfg(jcfg))
    model.load_state_dict(ar_state_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    tokens = np.random.RandomState(7).randint(0, jcfg.vocab_size, (2, L)).astype(np.int32)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jtrain.ar_loss(p, jcfg, jnp.asarray(tokens)), has_aux=True))(params)
    tparams = trainable_params(model)
    tloss, _ = ttrain.ar_loss(model, torch.from_numpy(tokens).long())
    grads = torch.autograd.grad(tloss, list(tparams.values()))
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    want = ar_state_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    for (n, _), g in zip(tparams.items(), grads):
        w = want[n].numpy()
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max() + 1e-12, rtol=1e-3,
                                   err_msg=n)
    opt_j = optax.adamw(1e-3)
    jp, _, jm = jax.jit(lambda p, s, t: jtrain.ar_train_step(p, s, t, jcfg, opt_j))(
        params, opt_j.init(params), jnp.asarray(tokens))
    opt_t = AdamW(1e-3)
    _, _, tm = ttrain.ar_train_step(model, opt_t.init(tparams), torch.from_numpy(tokens).long(),
                                    opt_t)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    want = ar_state_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    got = np.concatenate([tparams[n].detach().numpy().ravel() for n in sorted(want)])
    ref = np.concatenate([want[n].numpy().ravel() for n in sorted(want)])
    off = np.abs(got - ref) > 1e-6 + 1e-4 * np.abs(ref)
    assert off.mean() < 0.01 and np.abs(got - ref).max() < 4e-3


MASKS = {"causal": (0, None, 13), "causal_offset": (4, None, 9),
         "left_pad": (0, [0, 6], 13), "offset_left_pad": (4, [3, 9], 9),
         "cross": (None, None, 7), "cross_kv_start": (None, [2, 13], 7)}


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("rep", [1, 2])
def test_gqa_backward_reference_matches_jax_grad(mask, rep):
    causal, start, lq = MASKS[mask]
    rng = np.random.RandomState(5)
    B, Lk, Hkv, d = 2, 13, 2, 8
    q = rng.randn(B, lq, Hkv * rep, d).astype(np.float32)
    k, v = (rng.randn(B, Lk, Hkv, d).astype(np.float32) for _ in range(2))
    do = rng.randn(B, lq, Hkv * rep, d).astype(np.float32)
    jstart = None if start is None else jnp.asarray(start)

    def f(q, k, v):
        out = jar._gqa_attention(q, k, v, None if causal is None else jnp.asarray(causal), jstart)
        return jnp.sum(out * do)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    tstart = None if start is None else torch.tensor(start)
    got = reference.gqa_attention_backward_reference(
        *(torch.from_numpy(a) for a in (q, k, v, do)), causal, tstart)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=1e-5)
    # the autograd route on a CPU tensor: K8's plain forward, this backward
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    before = dict(kernels.launch_counts)
    (kernels.gqa_attention(qt, kt, vt, causal, tstart) * torch.from_numpy(do)).sum().backward()
    assert kernels.launch_counts == before
    for a, t in zip(want, (qt, kt, vt)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(a), atol=1e-5, rtol=1e-5)


def test_int8_cache_has_no_backward():
    q = torch.zeros(1, 2, 2, 8, requires_grad=True)
    k = torch.zeros(1, 2, 1, 8, dtype=torch.int8)
    s = torch.ones(1, 2, 1, 1)
    with pytest.raises(ValueError, match="int8"):
        kernels.gqa_attention(q, k, k, 0, None, s, s)
