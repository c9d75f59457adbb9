"""AR training under tensor parallelism (``training.ar_train.
make_sharded_ar_train_step``) against gen3c_tpu's jitted step on a (dp, tp)
mesh, on the CPU.

gen3c_tpu trains the AR model with one jitted ``ar_train_step`` on
parameters that ``shard_ar_params(make_mesh(dp, tp), params, fsdp_axis=)``
placed (gen3c_tpu/training/ar_train.py, parallel/sharding.py:99-152): GSPMD
differentiates the sharded forward. Here spawned gloo ranks
(``tests/torch_cp_ranks.py``) run the port's step on their shards
(``shard_ar_params``, and ``shard_fsdp`` for FSDP): tp 2, dp 2 x tp 2 and
FSDP dp 2 x tp 2 (and dp 2 alone, and the 3D-RoPE cross-attention
variant at tp 2), fp32, two AdamW steps with label smoothing and z-loss,
against JAX on the same mesh of the conftest's virtual CPU devices. The
tolerances are tests/test_torch_ar_train.py's: loss rtol 1e-5, accuracy
exact, grad norm rtol 1e-4; every gradient the first step's optimizer took,
gathered to the one-device form (``gather_to_host``), within 1e-4 of its
largest element; every parameter after the two steps within AdamW's noise
(that file's bound: an update of lr per element flips with a gradient's
sign near 0).

The accuracy's argmax runs over ranks: on a tie it keeps the lowest index,
as ``jnp.argmax``: held on tied logits over 2 and 4 ranks, and through a
whole step whose LM head repeats its rows in each rank's half.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gen3c_tpu.models import ar_transformer as jar
from gen3c_tpu.parallel.mesh import make_mesh
from gen3c_tpu.parallel.sharding import shard_ar_params
from gen3c_tpu.training import ar_train as jtrain
from gen3c_tpu_torch.bridge import ar_state_from_jax
from tests import torch_cp_ranks

torch.set_num_threads(2)
CTX = dataclasses.replace(jar.AR_TINY, max_seq_len=64, rope_dim="3D", latent_shape=(4, 4, 4),
                          context_dim=32)
LR = 1e-3
LOSS_KW = {"label_smoothing": 0.1, "z_loss": 1e-3}


@pytest.fixture(scope="module")
def ranks():
    pool = torch_cp_ranks.Ranks(4)
    yield pool
    pool.close()


def _cfg_kw(jcfg):
    return {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}


def _np(tree):
    return {k: v.numpy() for k, v in ar_state_from_jax(jax.tree.map(np.asarray, tree)).items()}


def _jax_steps(params, jcfg, batches, contexts, dp, tp, fsdp):
    """jax's ar_train_step (value_and_grad of ar_loss with LOSS_KW, then
    optax.adamw) jitted on params placed by shard_ar_params over a (dp, tp)
    mesh: per step the metrics and the gradients, and the final params."""
    mesh = make_mesh(dp=dp, cp=1, tp=tp, devices=jax.devices()[:dp * tp])
    p = shard_ar_params(mesh, params, fsdp_axis="dp" if fsdp else None)
    opt = optax.adamw(LR)
    s = opt.init(p)

    @jax.jit
    def step(p, s, t, c):
        (_, m), g = jax.value_and_grad(
            lambda q: jtrain.ar_loss(q, jcfg, t, c, **LOSS_KW), has_aux=True)(p)
        u, s = opt.update(g, s, p)
        m["grad_norm"] = optax.global_norm(g)
        return optax.apply_updates(p, u), s, m, g

    out = {"loss": [], "accuracy": [], "grad_norm": [], "grads": []}
    for t, c in zip(batches, contexts):
        p, s, m, g = step(p, s, jnp.asarray(t), None if c is None else jnp.asarray(c))
        for k in ("loss", "accuracy", "grad_norm"):
            out[k].append(float(m[k]))
        out["grads"].append(_np(g))
    out["params"] = _np(p)
    return out


def _batches(jcfg, seed, n=2, B=4, L=17):
    rng = np.random.RandomState(seed)
    tokens = [rng.randint(0, jcfg.vocab_size, (B, L)).astype(np.int32) for _ in range(n)]
    ctx = [rng.standard_normal((B, 7, jcfg.context_dim)).astype(np.float32)
           if jcfg.context_dim else None for _ in range(n)]
    return tokens, ctx


def _check(got, want, tp, dp, fsdp, jcfg):
    for r in got:
        for k, rtol in (("loss", 1e-5), ("grad_norm", 1e-4)):
            np.testing.assert_allclose(r[k], want[k], rtol=rtol, err_msg=k)
        np.testing.assert_allclose(r["accuracy"], want["accuracy"], atol=1e-7)
        assert r["q_heads"] == jcfg.n_heads // tp
        assert set(r["grads"]) == set(want["grads"][0]) == set(r["params"])
        for n, g in r["grads"].items():
            w = want["grads"][0][n]
            np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max() + 1e-12, rtol=1e-3,
                                       err_msg=n)
        names = sorted(want["params"])
        p = np.concatenate([r["params"][n].ravel() for n in names])
        ref = np.concatenate([want["params"][n].ravel() for n in names])
        off = np.abs(p - ref) > 1e-6 + 1e-4 * np.abs(ref)
        assert off.mean() < 0.01 and np.abs(p - ref).max() < 4e-3
    for r in got[1:]:  # every rank holds the same one-device state
        for n in got[0]["params"]:
            np.testing.assert_array_equal(r["params"][n], got[0]["params"][n], err_msg=n)
    total = sum(v.size for v in want["params"].values())
    if tp > 1:
        assert got[0]["sharded"] and got[0]["held"] < total
    if fsdp:
        assert got[0]["fsdp"]
        assert all(n.endswith(("wq.weight", "wk.weight", "wv.weight", "wo.weight", "w1.weight",
                               "w2.weight", "w3.weight")) for n in got[0]["fsdp"])


LAYOUTS = {"tp2": (1, 2, False), "dp2": (2, 1, False), "dp2_tp2": (2, 2, False),
           "fsdp_dp2_tp2": (2, 2, True), "fsdp_dp2": (2, 1, True)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_ar_tp_train_steps_match_jax(ranks, layout):
    dp, tp, fsdp = LAYOUTS[layout]
    jcfg = jar.AR_TINY
    params = jar.init_ar_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    batches, contexts = _batches(jcfg, 1)
    want = _jax_steps(params, jcfg, batches, contexts, dp, tp, fsdp)
    got = ranks.run("ar_tp_train", dp=dp, tp=tp, fsdp=fsdp, cfg_kw=_cfg_kw(jcfg),
                    state=_np(params), batches=batches, contexts=contexts, lr=LR,
                    loss_kw=LOSS_KW)
    _check(got, want, tp, dp, fsdp, jcfg)


@pytest.mark.parametrize("layout", ["tp2", "fsdp_dp2_tp2"])
def test_ar_tp_train_with_cross_attention_matches_jax(ranks, layout):
    """The 3D-RoPE, cross-attention variant: the cross-attention's
    column and row linears train on their shards too."""
    dp, tp, fsdp = LAYOUTS[layout]
    params = jar.init_ar_params(jax.random.PRNGKey(2), CTX, jnp.float32)
    batches, contexts = _batches(CTX, 3, L=33)
    want = _jax_steps(params, CTX, batches, contexts, dp, tp, fsdp)
    got = ranks.run("ar_tp_train", dp=dp, tp=tp, fsdp=fsdp, cfg_kw=_cfg_kw(CTX),
                    state=_np(params), batches=batches, contexts=contexts, lr=LR,
                    loss_kw=LOSS_KW)
    _check(got, want, tp, dp, fsdp, CTX)
    assert any("cross_attention.wq" in n for n in got[0]["sharded"])


@pytest.mark.parametrize("tp", [2, 4])
def test_vocab_parallel_argmax_keeps_the_lowest_index_on_ties(ranks, tp):
    """Logits of few distinct values (ties within and across the ranks'
    columns): the argmax over ranks is np.argmax's, on every rank."""
    logits = np.random.RandomState(tp).randint(0, 3, (64, 512)).astype(np.float32)
    logits[:8] = 1.0  # rows tied everywhere: index 0
    got = ranks.run("vocab_argmax", tp=tp, logits=logits)
    for r in got:
        assert r == np.argmax(logits, axis=-1).tolist()


def test_accuracy_on_tied_logits_matches_jax(ranks):
    """An LM head whose second half repeats its first (each logit tied with
    the one V/2 later, on the other tp rank) and tokens that follow JAX's
    argmax, or its tied twin at every third position: JAX counts the first
    and not the second; so must the step at tp 2 (accuracy 10/16; the
    highest index of a tie would give 6/16)."""
    jcfg = jar.AR_TINY
    params = jar.init_ar_params(jax.random.PRNGKey(4), jcfg, jnp.float32)
    out = np.asarray(params["output"])
    half = jcfg.vocab_size // 2
    out = np.concatenate([out[:, :half], out[:, :half]], axis=1)
    params = {**params, "output": jnp.asarray(out)}
    rope = jar.rope_tables(jcfg)
    fwd = jax.jit(lambda p, t: jar.ar_forward(p, jcfg, t, rope)[0])
    rng = np.random.RandomState(5)
    B, L = 4, 17
    tokens = rng.randint(0, half, (B, L)).astype(np.int32)
    for i in range(L - 1):  # token i + 1 from the prediction at i (causal: later ones ignored)
        best = np.asarray(fwd(params, jnp.asarray(tokens))[:, i]).argmax(-1)
        assert (best < half).all()
        tokens[:, i + 1] = best + (half if i % 3 == 0 else 0)
    want = _jax_steps(params, jcfg, [tokens], [None], 1, 2, False)
    assert want["accuracy"][0] == pytest.approx(10 / 16)  # the 10 positions not 0 mod 3
    got = ranks.run("ar_tp_train", dp=1, tp=2, fsdp=False, cfg_kw=_cfg_kw(jcfg),
                    state=_np(params), batches=[tokens], contexts=[None], lr=LR,
                    loss_kw=LOSS_KW)
    for r in got:
        np.testing.assert_allclose(r["accuracy"], want["accuracy"], atol=1e-7)
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-5)


def test_train_hidden_runs_a_tp_model_as_the_forward(ranks):
    """``train_hidden`` on a tp-cut model: its stream times the gathered LM
    head is the inference forward's logits (whole on every rank), and it
    no longer refuses the model."""
    jcfg = jar.AR_TINY
    params = jar.init_ar_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tokens = np.random.RandomState(0).randint(0, 512, (2, 16)).astype(np.int32)
    got = ranks.run("ar_tp_hidden", tp=2, cfg_kw=_cfg_kw(jcfg), state=_np(params),
                    tokens=tokens)
    for r in got:
        np.testing.assert_allclose(r["hidden_logits"], r["forward"], rtol=1e-5, atol=1e-5)
