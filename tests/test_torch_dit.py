"""The DiT port against gen3c_tpu.models.dit on the CPU.

The JAX package's tiny-preset parameters (random init with the zero-init
AdaLN gates and final layer randomized, so every block contributes) go
through bridge.dit_state_from_jax into the port's GeneralDIT. Both run the
full forward in fp32 on the same inputs, with cross-attention over 512
text tokens: rtol/atol 1e-4 (the sums run in another order; the softmax
and norms are fp32 on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gen3c_tpu.models import dit as jdit
from gen3c_tpu.models.convert import convert_dit_state_dict
from gen3c_tpu.pipelines.factory import GEN3C_TINY_PRESET as JAX_TINY
from gen3c_tpu_torch.bridge import dit_state_from_jax
from gen3c_tpu_torch.models import dit as tdit
from gen3c_tpu_torch.pipelines.factory import GEN3C_TINY_PRESET

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny_pair():
    jcfg = JAX_TINY.dit
    params = jdit.randomize_degenerate_inits(jdit.init_dit_params(jax.random.PRNGKey(0), jcfg))
    tree = jax.tree.map(np.asarray, params)
    net = tdit.GeneralDIT(GEN3C_TINY_PRESET.dit)
    net.load_state_dict(dit_state_from_jax(tree), strict=True)
    return params, tree, jcfg, net


def test_tiny_configs_agree():
    j, t = JAX_TINY.dit, GEN3C_TINY_PRESET.dit
    for f in ("in_channels", "model_channels", "num_blocks", "num_heads", "adaln_lora_dim",
              "crossattn_emb_channels", "patch_spatial", "patch_temporal", "max_frames",
              "max_img_h", "max_img_w", "rope_t_extrapolation_ratio", "concat_padding_mask"):
        assert getattr(j, f) == getattr(t, f), f
    assert t.head_dim == 24  # 96 / 4: the kernel pads it to the MMA depth


@pytest.mark.parametrize("fps", [24.0, None])
def test_dit_forward_matches_jax(tiny_pair, fps):
    params, _, jcfg, net = tiny_pair
    rng = np.random.default_rng(0)
    B, T, H, W = 2, 3, 12, 20
    x = rng.standard_normal((B, jcfg.in_channels, T, H, W)).astype(np.float32)
    t = rng.uniform(-2, 1, (B,)).astype(np.float32)
    ctx = rng.standard_normal((B, 512, 1024)).astype(np.float32)
    want = np.asarray(jax.jit(jdit.dit_forward, static_argnames=("cfg", "fps"))(
        params, jcfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), fps=fps))
    got = net(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), fps=fps).numpy()
    assert got.shape == want.shape == (B, 16, T, H, W)
    assert np.abs(want).max() > 1e-2  # the randomized gates make the output non-trivial
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_pieces_match_jax():
    cfg_t, cfg_j = GEN3C_TINY_PRESET.dit, JAX_TINY.dit
    tc, ts = tdit.rope_3d_table(cfg_t, 3, 6, 10, fps=24.0)
    jc, js = jdit.rope_3d_table(cfg_j, 3, 6, 10, fps=24.0)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    rng = np.random.default_rng(1)
    xq = rng.standard_normal((2, 180, 4, 24)).astype(np.float32)
    np.testing.assert_allclose(tdit.apply_rope(torch.from_numpy(xq), tc, ts).numpy(),
                               np.asarray(jdit.apply_rope(jnp.asarray(xq), jc, js)),
                               atol=1e-6, rtol=0)
    steps = rng.uniform(-3, 2, (5,)).astype(np.float32)
    np.testing.assert_allclose(tdit.timestep_sincos(torch.from_numpy(steps), 96).numpy(),
                               np.asarray(jdit.timestep_sincos(jnp.asarray(steps), 96)),
                               atol=1e-6, rtol=0)


def test_bridge_names_are_the_reference_names(tiny_pair):
    """JAX tree -> port state_dict -> convert_dit_state_dict (the reference
    checkpoint converter) gives back the JAX tree exactly."""
    _, tree, jcfg, net = tiny_pair
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    back = convert_dit_state_dict(sd, jcfg, strict=True)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_tree = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert len(flat_back) == len(flat_tree)
    for path, leaf in flat_back:
        np.testing.assert_array_equal(np.asarray(leaf), flat_tree[path], err_msg=str(path))
    # a reference checkpoint saved with the "net." prefix loads as well
    assert set(convert_dit_state_dict({f"net.{k}": v for k, v in sd.items()}, jcfg,
                                      strict=True)) == set(back)
