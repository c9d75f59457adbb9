"""The text2world / video2world prompt-encoder flags (a deliberate departure).

The port's parser keeps ``--enable_prompt_encoder`` and ``--t5_backend``,
which gen3c_tpu's text2world parser lacks (its ``--disable_prompt_encoder``
defaults to True, so its T5 branch never runs from the command line). The
default must stay the zero encoder: no prompt encoder is built and the
prompt's embeddings are gen3c_tpu's zeros, bit for bit.
"""

import numpy as np

from gen3c_tpu.models.t5 import DummyT5TextEncoder as JDummy
from gen3c_tpu.pipelines import text2world as jt2w
from gen3c_tpu_torch.models.t5 import DummyT5TextEncoder as TDummy
from gen3c_tpu_torch.pipelines import factory
from gen3c_tpu_torch.pipelines import text2world as tt2w


def test_default_is_the_zero_encoder():
    argv = ["--prompt", "a red car on a bridge", "--negative_prompt", "blurry"]
    targs = tt2w.create_parser().parse_args(argv)
    jargs = jt2w.create_parser().parse_args(argv)
    assert targs.disable_prompt_encoder is True and jargs.disable_prompt_encoder is True
    assert factory.build_text_encoder(targs, "cpu") is None
    for prompt in (targs.prompt, targs.negative_prompt):
        got, got_mask = TDummy().encode_prompts(prompt)
        want, want_mask = JDummy().encode_prompts(prompt)
        assert got.shape == want.shape == (1, 512, 1024)
        np.testing.assert_array_equal(np.asarray(got), want)
        np.testing.assert_array_equal(np.asarray(got_mask), want_mask)


def test_enable_flag_is_the_only_way_to_t5():
    p = tt2w.create_parser()
    args = p.parse_args(["--prompt", "x", "--enable_prompt_encoder", "--t5_backend", "torch"])
    assert args.disable_prompt_encoder is False and args.t5_backend == "torch"
    jflags = {a.dest for a in jt2w.create_parser()._actions}
    assert {a.dest for a in p._actions} - jflags >= {"t5_backend", "device"}
