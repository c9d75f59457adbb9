"""The port's prompt upsamplers and Pixtral vision tower
(gen3c_tpu_torch.aux.{prompt_upsampler,vision_encoder}) against gen3c_tpu's
on the CPU.

Weights go JAX -> port through ``bridge.pixtral_vision_state_from_jax`` and
``bridge.ar_state_from_jax``; inputs are numpy. The fp32 tower and
``vision_encode`` are held at atol 1e-5 (sums in other orders), the bf16
tower at 3e-2 of the output's scale (bf16 rounds at other places in the
two; JAX's eager ops round each product). ``_prepare_frame`` (the bilinear
resize of ``jax.image.resize``, ops.resize in the port) at atol 2e-4: the
resize within test_torch_moge.py's 1e-4 for it (XLA's CPU resize sits up
to 3e-5 from float64), then divided by the CLIP std (0.26-0.28). The
VLM, its prepend and text-only paths and the text-only upsampler give
JAX's new ids exactly (fp32, greedy; a checkpoint loads in bf16 in both and
moves to fp32 on the same rounded values). The head_dim departure: JAX's
forward cannot take a checkpoint whose head width is not dim / heads
(``jax.eval_shape`` fails); the port's loaders raise a ValueError naming
it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gen3c_tpu.aux import prompt_upsampler as jp
from gen3c_tpu.aux import vision_encoder as jv
from gen3c_tpu.models import ar_transformer as jar
from gen3c_tpu_torch import bridge
from gen3c_tpu_torch.aux import prompt_upsampler as tp
from gen3c_tpu_torch.aux import vision_encoder as tv
from gen3c_tpu_torch.models import ar_transformer as tar

torch.set_num_threads(2)

VCFG = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64, patch_size=4,
            image_size=32, text_hidden_size=48)
TCFG = dict(dim=48, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=64, ffn_hidden_size=96,
            max_seq_len=512, use_qk_normalization=False)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _vision(dtype="float32", seed=1):
    jcfg = jv.VisionConfig(**VCFG, dtype=jnp.dtype(dtype))
    tcfg = tv.VisionConfig(**VCFG, dtype=getattr(torch, dtype))
    params = jv.init_vision_params(jax.random.PRNGKey(seed), jcfg)
    model = tv.VisionEncoder(tcfg, device="cpu")
    model.load_state_dict(bridge.pixtral_vision_state_from_jax(_np(params)))
    return params, jcfg, model


def _text(seed=0):
    jcfg = jar.ARConfig(**TCFG, dtype=jnp.float32)
    params = jar.init_ar_params(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    model = tar.ARTransformer(tar.ARConfig(**TCFG, dtype=torch.float32))
    model.load_state_dict(bridge.ar_state_from_jax(_np(params)))
    return params, jcfg, model


def _image(h, w, seed=0):
    return np.random.RandomState(seed).standard_normal((3, h, w)).astype(np.float32)


@pytest.mark.parametrize("hw", [(32, 32), (16, 28)])
def test_vision_tower_and_encode_match_jax(hw):
    params, jcfg, model = _vision()
    img = _image(*hw)
    want = np.asarray(jv.vision_tower_features(params, jcfg, jnp.asarray(img)))
    got = tv.vision_tower_features(model, torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    want = np.asarray(jv.vision_encode(params, jcfg, jnp.asarray(img)))
    got = tv.vision_encode(model, torch.from_numpy(img))
    assert got.shape == (hw[0] * hw[1] // 16, 48)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    cos, sin = tv.rope_2d_tables(model.cfg, hw[0] // 4, hw[1] // 4)
    jcos, jsin = jv.rope_2d_tables(jcfg, hw[0] // 4, hw[1] // 4)
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(sin.numpy(), np.asarray(jsin))


def test_vision_tower_bf16_matches_jax():
    params, jcfg, model = _vision("bfloat16")
    assert model.transformer.layers[0].attention.q_proj.weight.dtype == torch.bfloat16
    img = _image(32, 32, 3)
    want = np.asarray(jv.vision_encode(params, jcfg, jnp.asarray(img)).astype(jnp.float32))
    got = tv.vision_encode(model, torch.from_numpy(img)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-2 * np.abs(want).max())


def test_pixtral_converter_matches_bridge():
    from transformers import PixtralVisionConfig, PixtralVisionModel

    torch.manual_seed(0)
    hf = PixtralVisionModel(PixtralVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
        image_size=32, patch_size=4, head_dim=8)).eval()
    sd = hf.state_dict()
    proj = {"multi_modal_projector.linear_1.weight": torch.randn(48, 32),
            "multi_modal_projector.linear_1.bias": torch.randn(48),
            "multi_modal_projector.linear_2.weight": torch.randn(48, 48),
            "multi_modal_projector.linear_2.bias": torch.randn(48)}
    jcfg, tcfg = jv.VisionConfig(**VCFG), tv.VisionConfig(**VCFG)
    for layout in (dict(sd),  # bare, identity projector
                   {**{f"vision_tower.{k}": v for k, v in sd.items()}, **proj},
                   {**{f"model.vision_tower.{k}": v for k, v in sd.items()},
                    **{f"model.{k}": v for k, v in proj.items()}}):
        jlayout = {k[len("model."):] if k.startswith("model.") else k: v
                   for k, v in layout.items()}
        want = bridge.pixtral_vision_state_from_jax(_np(jv.convert_hf_pixtral_vision(jlayout,
                                                                                       jcfg)))
        got = tv.convert_hf_pixtral_vision(layout, tcfg)
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    # and transformers' own tower, at the JAX package's tolerance for it (its
    # RoPE tables are formed in fp32, the packages' in float64)
    model = tv.VisionEncoder(tcfg, device="cpu")
    model.load_state_dict(tv.convert_hf_pixtral_vision(sd, tcfg))
    img = _image(32, 32, 1)
    with torch.no_grad():
        ref = hf(torch.from_numpy(img)[None], image_sizes=[(32, 32)]).last_hidden_state[0]
    np.testing.assert_allclose(tv.vision_tower_features(model, torch.from_numpy(img)).numpy(),
                               ref.numpy(), rtol=2e-3, atol=2e-3)


class _StubTokenizer:
    """Deterministic char-level tokenizer; '[IMG]' -> image token 5 (the JAX
    package's test stub)."""

    eos_token_id = 1
    chat_template = None
    IMG_ID = 5

    def encode(self, text):
        ids, i = [], 0
        while i < len(text):
            if text[i:i + 5] == "[IMG]":
                ids.append(self.IMG_ID)
                i += 5
            else:
                ids.append(6 + (ord(text[i]) % 50))
                i += 1
        return ids

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(97 + int(i) % 26) for i in ids if int(i) > 5)


class _Recording(_StubTokenizer):
    def __init__(self):
        self.seen = []

    def decode(self, ids, skip_special_tokens=True):
        self.seen.append(np.asarray(ids).copy())
        return super().decode(ids, skip_special_tokens)


def _pair(max_new_tokens=6, image_token_id=5, image_max_size=32):
    tparams, tjcfg, tmodel = _text()
    vparams, vjcfg, vmodel = _vision()
    theirs = jp.VLMPromptUpsampler(tparams, tjcfg, vparams, vjcfg, _Recording(),
                                   image_token_id=image_token_id, max_new_tokens=max_new_tokens,
                                   image_max_size=image_max_size)
    ours = tp.VLMPromptUpsampler(tmodel, vmodel, _Recording(), image_token_id=image_token_id,
                                 max_new_tokens=max_new_tokens, image_max_size=image_max_size)
    return theirs, ours


@pytest.mark.parametrize("shape,max_size,patch", [((24, 32), 32, 4), ((37, 53), 32, 4),
                                                  ((704, 1280), 1024, 16), ((5, 3), 32, 4)])
def test_prepare_frame_matches_jax(shape, max_size, patch):
    theirs, ours = _pair(image_max_size=max_size)
    ours.vision_model.cfg = dataclasses.replace(ours.vision_model.cfg, patch_size=patch)
    theirs.vision_cfg = dataclasses.replace(theirs.vision_cfg, patch_size=patch)
    rng = np.random.RandomState(0)
    frames = (rng.rand(2, *shape, 3) * 255).astype(np.uint8)
    want = theirs._prepare_frame(frames)
    got = ours._prepare_frame(frames)
    assert got.shape == want.shape and got.shape[1] % patch == 0 and got.shape[2] % patch == 0
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    floats = rng.rand(*shape, 3).astype(np.float32)  # one float frame in [0, 1]
    np.testing.assert_allclose(ours._prepare_frame(floats), theirs._prepare_frame(floats),
                               rtol=0, atol=2e-4)


@pytest.mark.parametrize("image_token_id", [5, 999])  # spliced at [IMG]; prepended
def test_vlm_paths_give_jax_tokens(image_token_id):
    theirs, ours = _pair(image_token_id=image_token_id)
    rng = np.random.RandomState(0)
    clips = [(rng.rand(3, 24, 32, 3) * 255).astype(np.uint8), np.zeros((3, 24, 32, 3), np.uint8),
             (rng.rand(2, 37, 53, 3) * 255).astype(np.uint8)]
    for frames in clips + [None]:
        want = theirs.upsample("a red car", frames=frames)
        got = ours.upsample("a red car", frames=frames)
        np.testing.assert_array_equal(ours.tokenizer.seen[-1], theirs.tokenizer.seen[-1])
        assert got == want
    assert len({s.tobytes() for s in ours.tokenizer.seen}) >= 2  # the frames matter


def test_vlm_budget_raises():
    theirs, ours = _pair(max_new_tokens=6, image_max_size=32)
    ours.text_model.cfg = dataclasses.replace(ours.text_model.cfg, max_seq_len=64)
    frames = np.zeros((1, 32, 32, 3), np.uint8)
    with pytest.raises(ValueError, match="exceeds max_seq_len budget"):
        ours.upsample("a red car", frames=frames)


def _tiny_tokenizer(path):
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    from transformers import PreTrainedTokenizerFast

    vocab = {w: i for i, w in enumerate(
        ["<unk>", "a", "sunny", "beach", "video", "detailed", "[IMG]", "Your", "task"])}
    tok = Tokenizer(WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>", eos_token="<unk>")
    fast.chat_template = "{% for m in messages %}{{ m['content'] }} {% endfor %}"
    fast.save_pretrained(path)
    return len(vocab)


def test_text_upsampler_gives_jax_ids(tmp_path):
    from transformers import LlamaConfig, LlamaForCausalLM

    path = tmp_path / "Pixtral-12B"
    path.mkdir()
    vocab = _tiny_tokenizer(path)
    torch.manual_seed(0)
    LlamaForCausalLM(LlamaConfig(
        vocab_size=vocab, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=1, max_position_embeddings=128,
        rms_norm_eps=1e-5, tie_word_embeddings=False)).save_pretrained(path)
    theirs = jp.JaxPromptUpsampler(str(path), max_new_tokens=5, max_seq_len=24)
    theirs.cfg = dataclasses.replace(theirs.cfg, dtype=jnp.float32)
    theirs.params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), theirs.params)
    bf16 = tp.TorchPromptUpsampler.from_checkpoint(str(path), max_new_tokens=5, max_seq_len=24,
                                                   device="cpu")
    fp32 = tar.ARTransformer(dataclasses.replace(bf16.model.cfg, dtype=torch.float32))
    fp32.load_state_dict({k: v.float() for k, v in bf16.model.state_dict().items()})
    ours = tp.TorchPromptUpsampler(fp32, bf16.tokenizer, max_new_tokens=5)
    for prompt in ("a sunny beach", "a " * 30 + "beach"):  # the second is truncated
        assert ours.upsample(prompt) == theirs.upsample(prompt)
    # the factory: the port's loader raises on a Pixtral-12B directory with
    # no vision tower, on either device; transformers' model only when asked
    for device in ("cpu", "cuda"):
        with pytest.raises(ValueError, match="no vision tower"):
            tp.create_prompt_upsampler(str(tmp_path), enabled=True, device=device)
    hf = tp.create_prompt_upsampler(str(tmp_path), enabled=True, backend="hf", device="cpu")
    assert isinstance(hf, tp.HFPromptUpsampler) and hf.model.device.type == "cpu"
    assert isinstance(hf.upsample("a sunny beach"), str)
    with pytest.raises(ValueError, match="backend"):
        tp.create_prompt_upsampler(str(tmp_path), enabled=True, backend="jax")
    assert isinstance(tp.create_prompt_upsampler(None, enabled=True), tp.TemplateUpsampler)
    assert isinstance(tp.create_prompt_upsampler(str(tmp_path)), tp.PassthroughUpsampler)
    t = tp.TemplateUpsampler()
    assert t.upsample("a red car.") == jp.TemplateUpsampler().upsample("a red car.")
    assert t.upsample("  ") == jp.TemplateUpsampler().upsample("  ")


def _llava(path, text_head_dim):
    from transformers import (
        LlavaConfig,
        LlavaForConditionalGeneration,
        MistralConfig,
        PixtralVisionConfig,
    )

    vocab = _tiny_tokenizer(path)
    torch.manual_seed(0)
    cfg = LlavaConfig(
        vision_config=PixtralVisionConfig(hidden_size=32, intermediate_size=64,
                                          num_hidden_layers=1, num_attention_heads=4,
                                          image_size=32, patch_size=4, head_dim=8),
        text_config=MistralConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                  num_attention_heads=4, num_key_value_heads=2,
                                  vocab_size=vocab, head_dim=text_head_dim,
                                  max_position_embeddings=4400),
        image_token_index=6)
    model = LlavaForConditionalGeneration(cfg)
    model.save_pretrained(path)
    return model


def test_head_dim_departure(tmp_path):
    """A text model of 4 heads of 16 in a 32-wide model: JAX's ARConfig
    derives head_dim 8, its converted wq has 64 columns and its forward's
    reshape fails; the port's loader raises a ValueError naming it. The
    same checkpoint at 4 heads of 8 loads and upsamples."""
    from transformers import MistralConfig, MistralForCausalLM

    from gen3c_tpu.models.convert import convert_hf_llama

    torch.manual_seed(0)
    hf = MistralForCausalLM(MistralConfig(hidden_size=32, intermediate_size=64,
                                          num_hidden_layers=1, num_attention_heads=4,
                                          num_key_value_heads=2, vocab_size=16, head_dim=16))
    jcfg = jar.ARConfig(dim=32, n_layers=1, n_heads=4, n_kv_heads=2, vocab_size=16,
                        ffn_hidden_size=64, max_seq_len=16, use_qk_normalization=False,
                        dtype=jnp.float32)
    params = convert_hf_llama(hf.state_dict(), jcfg)
    assert params["layers"][0]["wq"].shape == (32, 64)
    with pytest.raises((TypeError, ValueError)):
        jax.eval_shape(lambda p, t: jar.ar_forward(p, jcfg, t, jar.rope_tables(jcfg)), params,
                       jax.ShapeDtypeStruct((1, 4), jnp.int32))
    bad = tmp_path / "bad"
    (bad / "Pixtral-12B").mkdir(parents=True)
    _llava(bad / "Pixtral-12B", text_head_dim=16)
    with pytest.raises(ValueError, match="heads of 16"):
        tp.VLMPromptUpsampler.from_pretrained(str(bad / "Pixtral-12B"), device="cpu")
    # the factory raises too, before anything reaches the card: no other
    # backend or device takes the checkpoint over
    for device in ("cpu", "cuda"):
        with pytest.raises(ValueError, match="heads of 16"):
            tp.create_prompt_upsampler(str(bad), enabled=True, device=device)
    good = tmp_path / "Pixtral-12B"
    good.mkdir()
    _llava(good, text_head_dim=8)
    up = tp.VLMPromptUpsampler.from_pretrained(str(good), max_new_tokens=3, device="cpu")
    assert up.image_token_id == 6 and up.vision_model.cfg.dtype == torch.bfloat16
    assert up.text_model.cfg.max_seq_len == 4300
    frames = (np.random.RandomState(0).rand(1, 32, 32, 3) * 255).astype(np.uint8)
    assert isinstance(up.upsample("a sunny beach", frames=frames), str)
    assert isinstance(up.upsample("a sunny beach"), str)
    assert isinstance(tp.create_prompt_upsampler(str(tmp_path), enabled=True, device="cpu"),
                      tp.VLMPromptUpsampler)
