"""The port's T5 encoder (models/t5.py) against gen3c_tpu's on the CPU.

A tiny transformers ``T5EncoderModel`` (2 layers, d_model 32, 4 heads x 8,
d_ff 64, 32 buckets up to distance 128) with seeded weights is converted
by both packages; the same ids with a padded mask go through
``t5_encoder_forward`` and ``T5Encoder``. Both multiply each weight, bf16
or fp32, by fp32 activations: outputs within 1e-5 of mean |out| ~0.8.
The text encoders run from a tokenizer and model written to a local
<checkpoint_dir>/google-t5/t5-11b; nothing is fetched.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gen3c_tpu.models.t5 import convert_hf_t5_encoder as jax_convert
from gen3c_tpu.models.t5 import t5_encoder_forward
from gen3c_tpu_torch.models import t5

torch.set_num_threads(2)

WORDS = ["<pad>", "</s>", "<unk>"] + "a cat dog on the hill red blue sky over house".split()


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    """Hold transformers and the hub to local files whatever the call says."""
    import huggingface_hub.constants
    import transformers.utils.hub

    monkeypatch.setattr(huggingface_hub.constants, "HF_HUB_OFFLINE", True)
    monkeypatch.setattr(transformers.utils.hub, "_is_offline_mode", True)


def _hf_model(seed=0, layers=2, d_model=32):
    from transformers import T5Config, T5EncoderModel

    torch.manual_seed(seed)
    cfg = T5Config(vocab_size=len(WORDS) + 3, d_model=d_model, d_kv=8, d_ff=64,
                   num_layers=layers, num_heads=4, relative_attention_num_buckets=32,
                   relative_attention_max_distance=128, feed_forward_proj="relu",
                   dropout_rate=0.0)
    return T5EncoderModel(cfg).eval()


def _ids(L=40):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, len(WORDS), (2, L)).astype(np.int32)
    mask = np.ones((2, L), np.int32)
    mask[1, 25:] = 0
    return ids, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_jax(dtype):
    model = _hf_model()
    sd = model.state_dict()
    ids, mask = _ids()
    want = np.asarray(t5_encoder_forward(jax_convert(sd, dtype=getattr(jnp, dtype)),
                                         jnp.asarray(ids), jnp.asarray(mask), num_heads=4))
    tdtype = getattr(torch, dtype)
    enc = t5.T5Encoder(t5.t5_config_from_hf(model.config, tdtype))
    enc.load_state_dict(t5.convert_hf_t5_encoder(sd, tdtype))
    assert enc.embed.dtype == tdtype
    got = enc(torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (2, 40, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    if dtype == "float32":  # and transformers' own encoder, in fp32
        hf = model(input_ids=torch.from_numpy(ids).long(),
                   attention_mask=torch.from_numpy(mask).long()).last_hidden_state
        np.testing.assert_allclose(got.numpy(), hf.detach().numpy(), atol=1e-5, rtol=0)


def test_relative_buckets_match_transformers():
    """Bidirectional buckets to distance 600 (past the logarithmic range),
    the float log truncated toward zero."""
    from transformers.models.t5.modeling_t5 import T5Attention

    pos = torch.arange(600)
    rel = pos[None, :] - pos[:, None]
    want = T5Attention._relative_position_bucket(rel, bidirectional=True, num_buckets=32,
                                                 max_distance=128)
    got = t5.relative_position_bucket(rel, 32, 128)
    torch.testing.assert_close(got.long(), want.long(), rtol=0, atol=0)


def _write_local_t5(root, model=None):
    """A tiny tokenizer and encoder (``model``, default ``_hf_model(seed=1)``)
    in <root>/google-t5/t5-11b."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors
    from transformers import T5TokenizerFast

    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(WORDS)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(single="$A </s>",
                                                       special_tokens=[("</s>", 1)])
    path = os.path.join(root, t5.T5_MODEL_NAME)
    T5TokenizerFast(tokenizer_object=tok, eos_token="</s>", unk_token="<unk>", pad_token="<pad>",
                    extra_ids=0).save_pretrained(path)
    model = _hf_model(seed=1) if model is None else model
    model.save_pretrained(path)
    return path, model


def test_text_encoders_from_a_local_directory(tmp_path):
    """make_t5_encoder's backends from <checkpoint_dir>/google-t5/t5-11b:
    "jax" (the native stack, bf16 weights) against ``t5_encoder_forward`` on
    the same tokens and bf16 weights, "torch" against transformers' model;
    both zero the embeddings past each prompt and return the mask."""
    path, model = _write_local_t5(str(tmp_path))
    prompts = ["a cat", "a red house over the hill zebra"]
    native = t5.make_t5_encoder("jax", checkpoint_dir=str(tmp_path), device="cpu")
    assert isinstance(native, t5.T5TextEncoder) and native.encoder.embed.dtype == torch.bfloat16
    emb, mask = native.encode_prompts(prompts, max_length=16)
    assert emb.shape == (2, 16, 32) and emb.dtype == np.float32
    np.testing.assert_array_equal(mask.sum(1), [3, 8])
    batch = native.tokenizer(prompts, padding="max_length", max_length=16, return_tensors="np")
    want = np.asarray(t5_encoder_forward(
        jax_convert(model.state_dict()), jnp.asarray(batch["input_ids"], jnp.int32),
        jnp.asarray(batch["attention_mask"], jnp.int32), num_heads=4))
    want = want * batch["attention_mask"][..., None]
    np.testing.assert_allclose(emb, want, atol=1e-5, rtol=0)
    assert (emb[0, 3:] == 0).all() and (emb[1, 8:] == 0).all()

    hf = t5.make_t5_encoder("torch", checkpoint_dir=str(tmp_path), device="cpu")
    assert isinstance(hf, t5.CosmosT5TextEncoder)
    emb_hf, mask_hf = hf.encode_prompts(prompts, max_length=16)
    np.testing.assert_array_equal(mask_hf, mask)
    ref = model(input_ids=torch.from_numpy(batch["input_ids"]),
                attention_mask=torch.from_numpy(batch["attention_mask"])).last_hidden_state
    ref = ref.detach().numpy() * batch["attention_mask"][..., None]
    np.testing.assert_allclose(emb_hf, ref, atol=1e-6, rtol=0)
    assert isinstance(t5.make_t5_encoder("dummy"), t5.DummyT5TextEncoder)


@pytest.mark.parametrize("backend", ["jax", "torch"])
def test_missing_files_name_what_is_missing(tmp_path, backend):
    with pytest.raises(FileNotFoundError, match="google-t5/t5-11b"):
        t5.make_t5_encoder(backend, checkpoint_dir=str(tmp_path), device="cpu")


def test_missing_transformers_names_it(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "transformers", None)  # import transformers -> ImportError
    with pytest.raises(ImportError, match="transformers"):
        t5.make_t5_encoder("jax", device="cpu")


def test_init_random_full_width_shapes():
    """t5-11b's encoder at full width, on the meta device: 4.86 B parameters."""
    with torch.device("meta"):
        enc = t5.T5Encoder(t5.T5_11B)
    n = sum(p.numel() for p in enc.parameters())
    assert 4.85e9 < n < 4.87e9, n
    assert enc.layers[0].wi.shape == (65536, 1024) and enc.rel_bias.shape == (32, 128)
