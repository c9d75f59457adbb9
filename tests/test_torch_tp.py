"""The port's tensor and sequence parallelism against gen3c_tpu on the CPU.

Four spawned CPU ranks joined by gloo (``torch_cp_ranks``) run the port,
one process a rank, every test of this file on the same pool; 2-rank
layouts run as two replicas. JAX runs in this process on the host devices
that conftest.py sets up, under ``jax.shard_map`` (the cp x tp sampler) or
replicated (the forward), as tests/test_parallel.py runs it. Both sides get
the same numpy inputs and the same fp32 weights (gen3c_tpu's init with the
zero-init gates randomized, bridged into the port); each rank slices its
tp shards from them (``parallel.sharding.shard_params``).

Tolerances: rtol/atol 1e-4, as tests/test_parallel.py holds JAX's own
parallel runs to its single device and tests/test_torch_parallel.py the
port's cp runs; a net whose every sub-block stays whole (quantized) 1e-6
of one process (the same products, on another thread count).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_cp_ranks
from gen3c_tpu.models import dit as jdit
from gen3c_tpu.models import quantize as jquant
from gen3c_tpu.parallel.cp import cp_generate_samples as jax_cp_generate_samples
from gen3c_tpu.parallel.mesh import make_mesh
from gen3c_tpu.parallel.sharding import dit_param_pspecs
from gen3c_tpu_torch.bridge import dit_state_from_jax
from gen3c_tpu_torch.diffusion import sampler as tsampler
from gen3c_tpu_torch.models.quantize import quantize_dit_
from gen3c_tpu_torch.parallel import sharding
from gen3c_tpu_torch.pipelines import factory as tfactory
from test_torch_parallel import DIT_KW, JCFG, _port_net, _sample_arrays

torch.set_num_threads(2)

WORLD = 4
# the mixed quantization: cross-attention's k/v (1024 x 64) and the MLP (64
# x 256) reach it, self-attention's 64 x 64 linears do not
MIXED_MIN_SIZE = 1 << 14


@pytest.fixture(scope="module")
def ranks():
    pool = torch_cp_ranks.Ranks(WORLD)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def params():
    p = jdit.randomize_degenerate_inits(
        jdit.init_dit_params(jax.random.PRNGKey(0), JCFG, jnp.float32))
    state = {k: v.numpy() for k, v in dit_state_from_jax(jax.tree.map(np.asarray, p)).items()}
    return p, state


def _forward_inputs(seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, 81, 2, 8, 16)).astype(np.float32),
            np.asarray([0.3], np.float32), rng.standard_normal((1, 8, 1024)).astype(np.float32))


def _jax_forward(p, x, t, ctx, cfg=JCFG):
    return np.asarray(jax.jit(jdit.dit_forward, static_argnames=("cfg", "fps"))(
        p, cfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), fps=24.0))


def _by_cp(results, cp, tp):
    """The first replica's output shards in cp order (each tp rank of a cp
    shard returns the same output)."""
    first = results[:cp * tp]
    for r in first:
        np.testing.assert_array_equal(r["out"], first[r["cp_rank"] * tp]["out"])
    return np.concatenate([first[j * tp]["out"] for j in range(cp)], axis=2)


# ------------------------------ the forward ------------------------------

# (cp, tp, sp, cp_attn)
_FORWARD_CASES = [(1, 2, False, "allgather"), (1, 4, False, "allgather"), (1, 2, True, "allgather"),
                  (1, 4, True, "allgather"), (2, 2, False, "ulysses"), (2, 2, True, "ring")]


@pytest.mark.parametrize("cp,tp,sp,impl", _FORWARD_CASES,
                         ids=[f"cp{c}-tp{t}{'-sp' if s else ''}-{i}"
                              for c, t, s, i in _FORWARD_CASES])
def test_tp_forward_matches_jax(ranks, params, cp, tp, sp, impl):
    """GeneralDIT.forward(tp=, sp=) on each rank's shards against JAX's
    replicated forward (tests/test_parallel.py:208: Megatron sharding
    changes nothing numerically)."""
    x, t, ctx = _forward_inputs()
    ranks.submit("forward", cp=cp, tp=tp, sp=sp, dit_kw=dict(DIT_KW, cp_attn_impl=impl),
                 state=params[1], x=x, t=t, ctx=ctx)
    want = _jax_forward(params[0], x, t, ctx)
    results = ranks.collect()
    assert [(r["cp_rank"], r["tp_rank"]) for r in results[:cp * tp]] == [
        (j, k) for j in range(cp) for k in range(tp)]
    # every q/k/v/out and fc1/fc2 of both blocks is this rank's shard
    assert len(results[0]["sharded"]) == 2 * (2 * 4 + 2)
    np.testing.assert_allclose(_by_cp(results, cp, tp), want, rtol=1e-4, atol=1e-4)


def test_multiview_net_under_tp(ranks):
    """The multiview net runs tp through GeneralDIT's blocks, the
    cross-attention with the views folded into the batch included: the
    sharded forward equals the whole one (tests/test_torch_multiview_world.py
    holds the whole one to JAX's)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 16, 6, 8, 8)).astype(np.float32)  # 3 views x 2 frames
    ctx = rng.standard_normal((1, 12, 32)).astype(np.float32)  # 4 tokens a view
    for r in ranks.run("mv_forward", tp=2, x=x, t=np.asarray([0.5], np.float32), ctx=ctx):
        assert r["sharded"] == 2 * (2 * 4 + 2)
        assert np.abs(r["whole"]).max() > 0.1
        np.testing.assert_allclose(r["out"], r["whole"], rtol=1e-5, atol=1e-5)


def test_shard_dims_match_jax_pspecs(params):
    """``dit_shard_dims`` names, for every entry of the port's state dict,
    the dimension JAX's ``dit_param_pspecs`` shards over tp
    (tests/test_parallel.py:227): each JAX leaf is coded with its index
    along the tp dimension, the tree goes through the bridge (which
    transposes the linears), and the dimension a port entry varies along
    is its shard's."""
    p = params[0]
    leaves, treedef = jax.tree_util.tree_flatten(p)
    specs = jax.tree_util.tree_leaves(dit_param_pspecs(p), is_leaf=lambda s: isinstance(s, P))
    assert len(specs) == len(leaves)
    coded = []
    for leaf, spec in zip(leaves, specs):
        a = np.zeros(leaf.shape, np.float32)
        for d, axis in enumerate(spec):
            if axis == "tp":
                a = a + np.arange(1, leaf.shape[d] + 1, dtype=np.float32).reshape(
                    [-1 if i == d else 1 for i in range(leaf.ndim)])
        coded.append(a)
    port = dit_state_from_jax(jax.tree_util.tree_unflatten(treedef, coded))
    want = {}
    for k, v in port.items():
        v = v.numpy()
        varies = [d for d in range(v.ndim) if (v != v.take([0], axis=d)).any()]
        assert len(varies) <= 1, k
        want[k] = varies[0] if varies else None
    got = sharding.dit_shard_dims(_port_net(params[1]))
    assert got == want
    assert sum(d is not None for d in got.values()) == 2 * (2 * 4 + 2)
    blk = "blocks.block0.blocks"
    assert got[f"{blk}.0.block.attn.to_q.0.weight"] == 0  # JAX P(None, 'tp') on (in, out)
    assert got[f"{blk}.0.block.attn.to_out.0.weight"] == 1  # P('tp', None)
    assert got[f"{blk}.2.block.layer1.weight"] == 0 and got[f"{blk}.2.block.layer2.weight"] == 1
    assert got["affline_norm.weight"] is None
    # FSDP (tests/test_training.py:174): every entry's dp dimension beside its
    # tp one, JAX's dit_param_pspecs(fsdp_axis="dp") coded the same way
    fsdp_specs = jax.tree_util.tree_leaves(dit_param_pspecs(p, fsdp_axis="dp"),
                                           is_leaf=lambda s: isinstance(s, P))
    coded = []
    for leaf, spec in zip(leaves, fsdp_specs):
        a = np.zeros(leaf.shape, np.float32)
        for d, axis in enumerate(spec):
            if axis == "dp":
                a = a + np.arange(1, leaf.shape[d] + 1, dtype=np.float32).reshape(
                    [-1 if i == d else 1 for i in range(leaf.ndim)])
        coded.append(a)
    port = dit_state_from_jax(jax.tree_util.tree_unflatten(treedef, coded))
    fsdp = sharding.dit_shard_dims(_port_net(params[1]), fsdp_axis="dp")
    for k, v in port.items():
        v = v.numpy()
        varies = [d for d in range(v.ndim) if (v != v.take([0], axis=d)).any()]
        assert fsdp[k] == (want[k], varies[0] if varies else None), k
    assert fsdp[f"{blk}.0.block.attn.to_q.0.weight"] == (0, 1)  # JAX P('dp', 'tp')
    assert fsdp[f"{blk}.0.block.attn.to_out.0.weight"] == (1, 0)  # P('tp', 'dp')
    assert fsdp["affline_norm.weight"] == (None, None)
    # the 7B's large leaves outside the blocks' linears, as JAX's
    # test_fsdp_param_specs_shard_large_leaves has them: t_embedder's
    # linear_2 (4096, 12288) P(None, 'dp') and the final linear (4096, 64)
    # P('dp', None) in (in, out); a position table (T, D) its larger dim
    import dataclasses as dc

    from gen3c_tpu_torch.models.dit import GeneralDIT
    from gen3c_tpu_torch.pipelines.factory import GEN3C_7B_PRESET

    with torch.device("meta"):
        big = GeneralDIT(dc.replace(GEN3C_7B_PRESET.dit, num_blocks=1))
    dims = sharding.dit_shard_dims(big, fsdp_axis="dp")
    assert dims["t_embedder.1.linear_2.weight"] == (None, 0)
    assert dims["final_layer.linear.weight"] == (None, 1)
    assert dims["extra_pos_embedder.pos_emb_h"] == (None, 1)


# ------------------------------ the sampler ------------------------------

# (name, cfg, cp, tp, sp, cp_attn, steps, dit config, options)
_SAMPLER_CASES = [
    ("cp2tp2", 1, 2, 2, False, "allgather", 3, {}, dict(guidance=1.5)),
    ("cp1tp4", 1, 1, 4, False, "allgather", 3, {}, dict(guidance=1.5, cfg_rescale=0.5)),
    ("cp2tp2sp-ulysses", 1, 2, 2, True, "ulysses", 3, {}, dict(guidance=1.5)),
    ("cp1tp4sp", 1, 1, 4, True, "allgather", 3, {}, dict(guidance=1.5)),
    ("cfg2tp2", 2, 1, 2, False, "allgather", 3, {}, dict(guidance=1.5)),
    ("cp2tp2-empty-span", 1, 2, 2, False, "allgather", 4, {"cache_block_span": (1, 1)},
     dict(step_cache_interval=2)),
    ("cp2tp2sp-empty-span", 1, 2, 2, True, "allgather", 4, {"cache_block_span": (1, 1)},
     dict(step_cache_interval=2)),
]


@pytest.mark.parametrize("name,cfg,cp,tp,sp,impl,steps,over,opts", _SAMPLER_CASES,
                         ids=[c[0] for c in _SAMPLER_CASES])
def test_tp_generate_samples_matches_jax(ranks, params, name, cfg, cp, tp, sp, impl, steps,
                                         over, opts):
    """parallel.cp.cp_generate_samples over (cfg, cp, tp), with and without
    sequence parallelism, against JAX's cp_generate_samples on the same
    mesh (tests/test_parallel.py:448-606) and the port's single process;
    an empty span's skip path runs every block, so span caching under tp
    and sp equals the uncached single process. Every rank returns the
    whole latent."""
    arrays = _sample_arrays()
    kw = dict(DIT_KW, cp_attn_impl=impl, **over)
    ranks.submit("sample", cfg=cfg, cp=cp, tp=tp, sp=sp, dit_kw=kw, state=params[1],
                 arrays=arrays, opts=dict(num_steps=steps, **opts))
    mesh = make_mesh(dp=1, cfg=cfg, cp=cp, tp=tp, devices=jax.devices()[:cfg * cp * tp])
    want = np.asarray(jax_cp_generate_samples(
        mesh, params[0], dataclasses.replace(JCFG, cp_attn_impl=impl, **over), num_steps=steps,
        sequence_parallel=sp, **{k: jnp.asarray(v) for k, v in arrays.items()}, **opts))
    net = _port_net(params[1])
    single = tsampler.generate_samples(
        lambda x, t, c: net(x, t, c, fps=24.0),
        **{k: torch.from_numpy(v) for k, v in arrays.items()}, num_steps=steps,
        **{k: v for k, v in opts.items() if k != "step_cache_interval"}).numpy()
    got = ranks.collect()
    assert np.abs(want).max() > 0.5
    for r in got:
        np.testing.assert_array_equal(r, got[0])
    np.testing.assert_allclose(got[0], want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[0], single, rtol=1e-4, atol=1e-4)


def test_sequence_parallel_needs_tp(params):
    """As gen3c_tpu/parallel/cp.py:157-163: SP on a mesh with tp = 1 raises
    before any collective, in both packages."""
    from gen3c_tpu_torch.parallel.cp import cp_generate_samples
    from gen3c_tpu_torch.parallel.mesh import Axis, Groups

    arrays = _sample_arrays()
    mesh = make_mesh(dp=1, cp=2, tp=1, devices=jax.devices()[:2])
    msg = "sequence_parallel requires a 'tp' mesh axis of size > 1"
    with pytest.raises(ValueError, match=msg):
        jax_cp_generate_samples(mesh, None, JCFG, sequence_parallel=True,
                                **{k: jnp.asarray(v) for k, v in arrays.items()})
    with pytest.raises(ValueError, match=msg):
        cp_generate_samples(Groups(cp=Axis(None, 0, 2)), None, sequence_parallel=True,
                            **{k: torch.from_numpy(v) for k, v in arrays.items()})
    net = _port_net(params[1])
    x = torch.zeros((1, 81, 2, 8, 16))
    with pytest.raises(ValueError, match="sp requires a tp axis"):
        net(x, torch.zeros(1), torch.zeros((1, 8, 1024)), sp=True)
    heads = Axis(None, 0, 3)  # 4 heads over tp 2 leave 2, which cp 3 does not divide
    with pytest.raises(ValueError, match=r"\(H/tp\)/cp heads"):
        net(x, torch.zeros(1), torch.zeros((1, 8, 1024)), cp=heads, tp=Axis(None, 0, 2),
            cp_attn_impl="ulysses")


# ------------------------------ quantization ------------------------------


@pytest.mark.parametrize("min_size", [0, MIXED_MIN_SIZE], ids=["all-quantized", "mixed"])
def test_tp_with_quantize_equals_one_device(ranks, params, min_size):
    """``tp`` with quantize: a quantized linear stays whole on every rank
    (JAX's specs give {"q", "scale"} P()), and so does its sub-block; every
    sub-block whose linears are all plain is sharded. The result is the
    one-process quantized forward's."""
    x, t, ctx = _forward_inputs(4)
    ranks.submit("forward", cp=1, tp=4, dit_kw=DIT_KW, state=params[1], x=x, t=t, ctx=ctx,
                 min_size=min_size)
    net = quantize_dit_(_port_net(params[1]), min_size=min_size)
    with torch.no_grad():
        want = net(*(torch.from_numpy(a) for a in (x, t, ctx)), fps=24.0).numpy()
    results = ranks.collect()
    sharded = results[0]["sharded"]
    if min_size == 0:
        assert sharded == []
        tol = 1e-6
    else:  # the self-attentions alone
        assert sharded and all(".blocks.0.block.attn." in n for n in sharded)
        assert len(sharded) == 2 * 4
        tol = 1e-4
    for r in results:
        np.testing.assert_allclose(r["out"], want, rtol=tol, atol=tol)


def test_jax_cfg_tp_shard_map_with_quantize_is_off(params):
    """Why the port refuses cfg2[cpN]tpM with quantize: gen3c_tpu's
    shard_map TP path (cp.py's ``_cp_tp_net_fn``) takes the quantized
    entries whole (P()) and still sums the ranks' outputs over tp, so its
    forward is off the replicated one; the unquantized tree is not."""
    x, t, ctx = _forward_inputs(5)
    mesh = make_mesh(dp=1, cp=1, tp=2, devices=jax.devices()[:2])

    def sharded_forward(p):
        def body(p, x, t, ctx):
            return jdit.dit_forward(p, JCFG, x, t, ctx, fps=24.0, cp_axis="cp", tp_axis="tp")

        mapped = jax.jit(jax.shard_map(body, mesh=mesh,
                                       in_specs=(dit_param_pspecs(p), P(), P(), P()),
                                       out_specs=P(), check_vma=False))
        return np.asarray(mapped(p, *(jnp.asarray(a) for a in (x, t, ctx))))

    want = _jax_forward(params[0], x, t, ctx)
    np.testing.assert_allclose(sharded_forward(params[0]), want, rtol=1e-4, atol=1e-4)
    saved = jquant._MIN_SIZE
    jquant._MIN_SIZE = 0  # every linear quantized, as the issue's probe forced
    try:
        q = jquant.quantize_dit_params_inplace(jax.tree.map(jnp.array, params[0]))
    finally:
        jquant._MIN_SIZE = saved
    off = np.abs(sharded_forward(q) - _jax_forward(q, x, t, ctx)).max()
    assert off > 1e-2 * np.abs(want).max(), off


# ------------------------------ the strategies ------------------------------

# (strategy, (cfg, cp, tp), sp) on 4 ranks
_STRATEGIES = [("tp", (1, 1, 4), False), ("cp2tp2", (1, 2, 2), False),
               ("cp2tp2sp", (1, 2, 2), True), ("cp1tp4sp", (1, 1, 4), True),
               ("cfg2tp2", (2, 1, 2), False)]


@pytest.mark.parametrize("parallel,layout,sp", _STRATEGIES, ids=[s[0] for s in _STRATEGIES])
def test_tensor_parallel_strategies_build_as_jax(ranks, parallel, layout, sp):
    """build_gen3c_model(parallel=) on 4 ranks: the (cfg, cp, tp) groups and
    sequence parallelism of gen3c_tpu's factory for that name
    (factory.py:374-453: its mesh, or for "tp" its params sharded over
    every device), and the DiT cut to this rank's shards."""
    from gen3c_tpu.pipelines.factory import build_gen3c_model as jax_build

    ranks.submit("build", parallel=parallel)
    assert tfactory.parse_parallel(parallel)[3] is sp
    model, _ = jax_build("gen3c_tiny", num_devices=4, parallel=parallel)
    if model.mesh is None:  # "tp": GSPMD over a tp-only mesh
        spec = model.dit_params["blocks"][0]["fa"]["q"]["w"].sharding.spec
        assert spec == P(None, "tp") and layout == (1, 1, 4)
    else:
        assert tuple(model.mesh.shape[a] for a in ("cfg", "cp", "tp")) == layout
    assert model.sequence_parallel is sp
    for r in ranks.collect():
        assert (r["cfg"], r["cp"], r["tp"]) == layout and r["sp"] is sp
        assert r["q_rows"] == 96 // layout[2] and r["sharded"] == 2 * (2 * 4 + 2)


def test_parallelize_lays_a_built_model_out_again(ranks):
    """factory.parallelize, the step build_gen3c_model ends with, lays a
    model built for "cp" out by other strategies in turn, as a fresh build
    by each would be: a tp-1 layout leaves the net whole, the first tp 2
    layout cuts it, another at tp 2 keeps that cut; a layout at another tp
    size then raises, naming the cut."""
    out = ranks.run("relayout", strategies=["cfg2cp2", "cp2tp2", "cfg2tp2", "cp2tp2sp", "tp",
                                            "cp"])
    want = [(2, 2, 1, False, 96), (1, 2, 2, False, 48), (2, 1, 2, False, 48),
            (1, 2, 2, True, 48)]
    for r in out:
        for got, (cfg, cp, tp, sp, rows) in zip(r, want):
            assert "error" not in got, got
            assert (got["cfg"], got["cp"], got["tp"], got["sp"], got["q_rows"]) == (
                cfg, cp, tp, sp, rows) and got["as_fresh"], got
        assert "cut to tp=[2] shards, not tp=4" in r[4]["error"]
        assert "cut to tp=[2] shards, not tp=1" in r[5]["error"]


def test_parse_parallel_as_jax():
    for parallel, want in (("cp", (1, None, 1, False)), ("tp", (1, 1, None, False)),
                           ("cp4tp2", (1, 4, 2, False)), ("cp2tp2sp", (1, 2, 2, True)),
                           ("cfg2", (2, 1, 1, False)), ("cfg2cp2tp2", (2, 2, 2, False)),
                           ("cfg2tp2", (2, 1, 2, False))):
        assert tfactory.parse_parallel(parallel) == want


def test_strategy_refusals_as_jax():
    """gen3c_tpu's messages (tests/test_parallel.py:481, :612): a layout that
    needs more devices, the 'sp' suffix at tp 1, cpNtpM with quantize; and
    the port's departure, cfg2...tpM with quantize. Each raises before any
    process group is joined."""
    from gen3c_tpu.pipelines.factory import build_gen3c_model as jax_build

    build = tfactory.build_gen3c_model
    for parallel in ("cp4tp2", "cfg2cp2tp2"):
        with pytest.raises(ValueError, match="needs 8 devices"):
            build("gen3c_tiny", device="cpu", num_devices=4, parallel=parallel)
    with pytest.raises(ValueError, match="needs 8 devices"):
        jax_build("gen3c_tiny", num_devices=4, parallel="cp4tp2")
    with pytest.raises(ValueError, match="needs tp>=2"):
        build("gen3c_tiny", device="cpu", num_devices=4, parallel="cp4tp1sp")
    with pytest.raises(ValueError, match="cpNtpM serving is the bf16 multi-chip path"):
        build("gen3c_tiny", device="cpu", num_devices=4, parallel="cp2tp2", quantize="int8")
    for parallel in ("cfg2tp2", "cfg2cp2tp2"):
        with pytest.raises(ValueError, match="shard_map sums their whole outputs"):
            build("gen3c_tiny", device="cpu", num_devices=2 * (4 if "cp2" in parallel else 2),
                  parallel=parallel, quantize="w8a8")
