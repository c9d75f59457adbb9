"""The port's approximation error curve against gen3c_tpu on the CPU.

Row by row: JAX's ``approximation_quality_curve`` at a cut size (6 steps,
a 6 x 8 x 8 latent) against the port's ``quality_curve`` over the same
weights (JAX's init with its zero leaves drawn at 0.02, the recipe of
gen3c_tpu/diffusion/quality.py:129-141, bridged) and inputs (numpy's
RandomState, both packages drawing in one order). Each row is rounded as
JAX rounds it (rel_l2 to 5 digits, PSNR to 2), so a row may move by one
unit in its last digit: rel_l2 within 2e-5 and PSNR within 0.02 dB, or
both above 100 dB (band_w4 at 6 frames differs from exact by fp32
summation noise alone, ~125 dB).

Then the ordering gate of tests/test_quality_gate.py on the port's own
curve at its defaults (35 steps, a 16 x 16 x 16 latent, the port's seeded
init): wider band and denser refresh closer to exact, every knob nonzero
and bounded, the fast preset's composition between its worst knob's half
and twice the knobs' sum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gen3c_tpu.diffusion import quality as jquality
from gen3c_tpu.models.dit import init_dit_params
from gen3c_tpu_torch.bridge import dit_state_from_jax
from gen3c_tpu_torch.diffusion import quality as tquality
from gen3c_tpu_torch.models.dit import GeneralDIT

torch.set_num_threads(2)

CUT = dict(num_steps=6, lat_t=6, lat_hw=8)


def _jax_weights(seed: int = 0):
    """gen3c_tpu/diffusion/quality.py's weights for ``seed``."""
    params = init_dit_params(jax.random.PRNGKey(seed), jquality._tiny_cfg(), jnp.float32)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(leaves))
    leaves = [jax.random.normal(k, leaf.shape, leaf.dtype) * 0.02
              if float(jnp.sum(jnp.abs(leaf))) == 0 else leaf for k, leaf in zip(keys, leaves)]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def test_quality_rows_match_jax():
    want = jquality.approximation_quality_curve(**CUT)
    net = GeneralDIT(tquality.tiny_cfg())
    net.load_state_dict(dit_state_from_jax(jax.tree.map(np.asarray, _jax_weights())), strict=True)
    inputs = tquality.quality_inputs(0, CUT["lat_t"], CUT["lat_hw"], device="cpu")
    with torch.no_grad():
        got = tquality.quality_curve(net, inputs, num_steps=CUT["num_steps"])
    assert list(got) == list(want)
    assert want["band_w2"]["rel_l2"] > 1e-4  # the knobs do something at this size
    for name in want:
        g, w = got[name], want[name]
        assert abs(g["rel_l2"] - w["rel_l2"]) <= 2e-5, (name, g, w)
        if min(g["psnr_db"], w["psnr_db"]) > 100:  # both at fp32's noise floor
            continue
        assert abs(g["psnr_db"] - w["psnr_db"]) <= 0.02, (name, g, w)


def test_init_quality_net_draws_every_zero_leaf():
    a, b = (tquality.init_quality_net(0, "cpu") for _ in range(2))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert p.any(), name
        assert torch.equal(p, q), name
    assert tquality.tiny_cfg().dtype == torch.float32


@pytest.fixture(scope="module")
def curve():
    return tquality.approximation_quality_curve(device="cpu")


def test_band_error_monotone_in_window(curve):
    assert 0 < curve["band_w4"]["rel_l2"] <= curve["band_w2"]["rel_l2"]
    assert curve["band_w2"]["rel_l2"] <= curve["band_w1"]["rel_l2"]


def test_cache_error_monotone_in_interval(curve):
    assert 0 < curve["cache_i2"]["rel_l2"] <= curve["cache_i3"]["rel_l2"]


def test_guidance_interval_error_monotone_in_coverage(curve):
    assert 0 < curve["guidance_q0.75"]["rel_l2"] <= curve["guidance_q0.5"]["rel_l2"]


def test_fast_preset_composition(curve):
    comp = curve["fast_preset"]["rel_l2"]
    singles = [curve[k]["rel_l2"] for k in ("w8a8", "band_w2", "cache_i2", "guidance_q0.5")]
    assert comp >= max(singles) * 0.5, (comp, singles)
    assert comp <= 2.0 * sum(singles), (comp, singles)


def test_all_knobs_bounded(curve):
    assert len(curve) == 10
    for name, m in curve.items():
        assert 0 < m["rel_l2"] < 0.1, (name, m)
        assert m["psnr_db"] > 20, (name, m)
