"""GPipe pipeline parallelism for the DiT (``parallel.pp``) and sharded
cache renders (``parallel.cache_sharding``) against gen3c_tpu's on the CPU.

A pool of 4 spawned ranks over gloo (``tests/torch_cp_ranks.py``): the
pipeline runs on 2 of them (S = 2 stages, one block each of the tiny GEN3C
DiT, M = 2 microbatches; two replicas), the render on all 4. Tolerances
are gen3c_tpu's own tests' (tests/test_parallel.py:364: the output 2e-4,
the gradient with respect to x 5e-3; :269: pixels 1e-4, masks 1e-5),
except where a splat lands within rounding of a pixel edge: the port and
JAX then pick other corners, the <= 0.1% tie fraction the port's render
parity allows everywhere (tests/test_torch_geometry_cache.py). Against
the port's own one-process forward and render: 1e-5, and bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from gen3c_tpu.cache import Cache3DBuffer as JaxCache3DBuffer
from gen3c_tpu.models import dit as jdit
from gen3c_tpu.parallel.cache_sharding import sharded_render_cache as jax_sharded_render
from gen3c_tpu.parallel.pp import pp_dit_forward as jax_pp_forward
from gen3c_tpu.parallel.pp import shard_pp_params as jax_shard_pp
from gen3c_tpu.parallel.pp import stack_block_params
from gen3c_tpu.pipelines.factory import GEN3C_TINY_PRESET as JAX_TINY
from gen3c_tpu_torch.bridge import train_params_from_jax
from tests import torch_cp_ranks
from tests.test_torch_geometry_cache import _scene

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ranks():
    pool = torch_cp_ranks.Ranks(4)
    yield pool
    pool.close()


def _pp_inputs():
    rng = np.random.RandomState(0)
    cfg = JAX_TINY.dit
    x = rng.standard_normal((4, cfg.in_channels, 2, 8, 12)).astype(np.float32)
    t = rng.rand(4).astype(np.float32)
    ctx = rng.standard_normal((4, 8, cfg.crossattn_emb_channels)).astype(np.float32)
    return x, t, ctx


@pytest.fixture(scope="module")
def pp_refs():
    """JAX's pp_dit_forward at S = 2, M = 2 on a 2-device ("pp",) mesh, the
    gradient of sum(out ** 2) through it with respect to x, and the
    weights in the port's names."""
    cfg = JAX_TINY.dit
    params = jdit.randomize_degenerate_inits(jdit.init_dit_params(jax.random.PRNGKey(0), cfg))
    x, t, ctx = _pp_inputs()
    mesh = Mesh(np.array(jax.devices()[:2]), ("pp",))
    stacked = jax_shard_pp(mesh, stack_block_params(params))

    def loss(xi):
        return jnp.sum(jax_pp_forward(mesh, stacked, cfg, xi, jnp.asarray(t), jnp.asarray(ctx),
                                      n_microbatches=2) ** 2)

    want = np.asarray(jax_pp_forward(mesh, stacked, cfg, jnp.asarray(x), jnp.asarray(t),
                                     jnp.asarray(ctx), n_microbatches=2))
    plain = np.asarray(jdit.dit_forward(params, cfg, jnp.asarray(x), jnp.asarray(t),
                                        jnp.asarray(ctx), fps=24.0))
    np.testing.assert_allclose(want, plain, rtol=2e-4, atol=2e-4)
    state = {k: v.numpy() for k, v in train_params_from_jax(
        jax.tree.map(np.asarray, params)).items()}
    return want, np.asarray(jax.grad(loss)(jnp.asarray(x))), state


@pytest.mark.parametrize("cut", [False, True], ids=["whole-net", "stage-blocks"])
def test_pp_forward_and_grad_match_jax(ranks, pp_refs, cut):
    """pp_dit_forward at S = 2, M = 2 against JAX's pp_dit_forward (and its
    plain dit_forward): the output on every rank, and the gradient of
    sum(out ** 2) with respect to x, which the pipeline's backward brings
    back to stage 0 (the loss is replicated: the last stage takes its own
    cotangent only, else it would be S times one device's); a net that
    keeps its stage's blocks only (``shard_pp_params``) gives the same."""
    cfg = JAX_TINY.dit
    want, want_grad, state = pp_refs
    x, t, ctx = _pp_inputs()
    got = ranks.run("pp_forward", pp=2, state=state, x=x, t=t, ctx=ctx, n_microbatches=2,
                    cut=cut)
    for r in got:
        np.testing.assert_allclose(r["out"], want, rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(r["out"], got[0]["out"])
        assert r["blocks"] == (cfg.num_blocks // 2 if cut else cfg.num_blocks)
        # each stage sends or receives its 2 microbatches' activations and
        # their gradients: 2 x 2 messages of (2, L, D) fp32 a rank
        assert r["p2p"]["calls"] == 4
    stage0 = [r for r in got if r["stage"] == 0]
    for r in stage0:
        np.testing.assert_allclose(r["grad_x"], want_grad, rtol=5e-3, atol=5e-3)
    for r in got:
        if r["stage"] == 1:  # x reaches the blocks through stage 0 only
            assert not r["grad_x"].any()
    if cut:
        assert sorted(tuple(r["kept"]) for r in got[:2]) == [(0, 1), (1, 2)]
    # the port's own single process, unpipelined
    net = torch_cp_ranks.train_module("gen3c", state, False)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = net(xt, torch.from_numpy(t), torch.from_numpy(ctx), fps=24.0)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(got[0]["out"], out.detach().numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(stage0[0]["grad_x"], xt.grad.numpy(), rtol=1e-4, atol=1e-4)


def _targets(k, n):
    """n target cameras rotating about y and moving in x and y: off-axis
    moves keep the splats off exact pixel rows (tests/test_cache3d.py)."""
    w2cs = []
    for i in range(n):
        th = 0.02 * i
        w2cs.append(np.array([[np.cos(th), 0, np.sin(th), 0.05 * i], [0, 1, 0, 0.03 * i],
                              [-np.sin(th), 0, np.cos(th), 0], [0, 0, 0, 1]], np.float32))
    return np.stack(w2cs)[None], np.stack([k] * n)[None].astype(np.float32)


def test_sharded_render_matches_jax_and_one_process(ranks):
    """sharded_render_cache of 6 targets over 4 ranks (padded to 8 with the
    last): every rank's pixels and masks against JAX's sharded render on a
    4-device cp mesh, and bit for bit the port's one-process
    ``render_cache``."""
    from gen3c_tpu.parallel.mesh import make_mesh

    image, depth, k = _scene(3)
    w2cs, ks = _targets(k, 6)
    w2c0 = np.eye(4, dtype=np.float32)
    jc = JaxCache3DBuffer(frame_buffer_max=2, input_image=jnp.asarray(image[None]),
                          input_depth=jnp.asarray(depth[None, None]),
                          input_w2c=jnp.asarray(w2c0[None]),
                          input_intrinsics=jnp.asarray(k[None]))
    mesh = make_mesh(dp=1, cp=4, tp=1, devices=jax.devices()[:4])
    jpx, jmk = (np.asarray(a) for a in jax_sharded_render(jc, mesh, w2cs, ks))
    got = ranks.run("sharded_render", n=4, image=image, depth=depth, k=k, w2cs=w2cs, ks=ks)
    for r in got:
        assert r["px"].shape == jpx.shape == (1, 6, 1, 3) + image.shape[1:]
        np.testing.assert_array_equal(r["px"], r["one_px"])
        np.testing.assert_array_equal(r["mk"], r["one_mk"])
        assert (np.abs(r["px"] - jpx) > 1e-4).mean() <= 1e-3
        assert (np.abs(r["mk"] - jmk) > 1e-5).mean() <= 1e-3
        np.testing.assert_array_equal(r["px"], got[0]["px"])
