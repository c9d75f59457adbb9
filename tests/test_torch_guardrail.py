"""The port's guardrails (gen3c_tpu_torch.aux.guardrail) against gen3c_tpu's
on the CPU.

The blocklist is held to the JAX package's over the prompts and word lists
of tests/test_aux.py and more: the same verdicts and messages. LlamaGuard3
and Aegis load the same tiny checkpoints, which transformers writes under
tmp_path, in both packages (bf16: the same rounded weights); each guard is
then moved to fp32 on those values (JAX's cfg and params, the port's
network), so greedy generation must give the same new ids exactly (the
tokenizer's decode records JAX's). The PEFT
merge is held to JAX's merge on the same adapter at atol 1e-6 (fp32 sums
of rank-4 products). The pipeline hooks run the tiny preset.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gen3c_tpu.aux import guardrail as jg
from gen3c_tpu_torch.aux import guardrail as tg

torch.set_num_threads(2)

BLOCKLIST_CASES = [
    (dict(extra_words=["forbiddenword"]),
     ["a nice landscape", "a FORBIDDENWORD, with punctuation!", "forbiddenwords galore"]),
    (dict(extra_words=["weapon", "knife", "grenade launcher"]),
     ["a pile of weapons on the table", "several knives were found", "two grenade launchers",
      "the children ate apples with spoons", "a w3@p0n under the seat", "a We4Pon",
      "a wagon under the seat", "grenade   launcher!", "knife-edge", ""]),
    (dict(extra_words=["gas"]), ["toxic gases everywhere", "gasoline", "g@s"]),
    (dict(extra_words=["glassing"], whitelist_words=["glassing"]),
     ["glassing the window pane", "Glassing, again"]),
    (dict(exact_match_words=["forbidden phrase"]),
     ["contains the forbidden phrase here", "totally innocent text",
      "contains the forbiden phrase here"]),
    (dict(exact_match_words=["forbidden phrase"], guardrail_partial_match_letter_count=3),
     ["contains the forbiden phrase here", "forbidden, phrase", "for bidden phrase"]),
    (dict(extra_words=["x"]), ["", "x marks the spot", "café x", "über"]),
]


@pytest.mark.parametrize("case", range(len(BLOCKLIST_CASES)))
def test_blocklist_matches_jax(case):
    kw, prompts = BLOCKLIST_CASES[case]
    ours, theirs = tg.Blocklist(**kw), jg.Blocklist(**kw)
    for prompt in prompts:
        assert ours.is_safe(prompt) == theirs.is_safe(prompt), prompt
    runner, jrunner = tg.GuardrailRunner([ours]), jg.GuardrailRunner([theirs])
    for prompt in prompts:
        assert runner.run_safety_check(prompt) == jrunner.run_safety_check(prompt)


def test_blocklist_checkpoint_layout_matches_jax(tmp_path):
    root = tmp_path / "blocklist"
    for sub, text in (("custom", "badword\ntwo words\n"), ("whitelist", "goodword\n"),
                      ("exact_match", "exact bad phrase\n")):
        (root / sub).mkdir(parents=True)
        (root / sub / "a.txt").write_text(text)
    (root / "loose.txt").write_text("looseword\n")
    ours, theirs = tg.Blocklist(str(tmp_path)), jg.Blocklist(str(tmp_path))
    for attr in ("blocklist_words", "whitelist_words", "exact_match_words"):
        assert getattr(ours, attr) == getattr(theirs, attr)
    for prompt in ("a badword here", "the exact bad phrase appears", "a goodword here",
                   "two words", "a looseword", "harmless"):
        assert ours.is_safe(prompt) == theirs.is_safe(prompt), prompt


class _Fixed(tg.ContentSafetyGuardrail):
    def __init__(self, safe, msg="no"):
        self.safe, self.msg = safe, msg
        self.calls = 0

    def is_safe(self, x):
        self.calls += 1
        return self.safe, self.msg


class _AddOne(tg.PostprocessingGuardrail):
    def postprocess(self, frames):
        return frames + 1


def test_runner_contract():
    frames = np.zeros((2, 4, 4, 3), np.uint8)
    assert tg.GuardrailRunner().run("anything") is True
    np.testing.assert_array_equal(tg.GuardrailRunner().run(frames), frames)
    first, second = _Fixed(False, "bad"), _Fixed(True)
    runner = tg.GuardrailRunner([first, second], postprocessors=[_AddOne()])
    assert runner.run("p") is False and second.calls == 0
    assert runner.run(frames) is None
    assert runner.run_safety_check("p") == (False, "_FIXED: bad")
    assert tg.GuardrailRunner([first], generic_block_msg="no").run_safety_check("p") == (
        False, "no")
    passing = tg.GuardrailRunner([_Fixed(True)], postprocessors=[_AddOne(), _AddOne()])
    assert passing.run("p") is True
    np.testing.assert_array_equal(passing.run(frames), frames + 2)
    assert passing.run_safety_check("p") == (True, "Prompt is safe")


def test_factories_fall_back(tmp_path, monkeypatch):
    for prefer in ("", "aegis", "llamaguard3"):
        monkeypatch.setenv("GEN3C_GUARDRAIL", prefer)
        runner = tg.create_text_guardrail_runner(str(tmp_path), device="cpu")
        assert [type(m) for m in runner.safety_models] == [tg.Blocklist]
        assert runner.run("an innocent prompt") is True
    video = tg.create_video_guardrail_runner(None, device="cpu")
    frames = np.random.RandomState(0).randint(0, 255, (3, 8, 8, 3), np.uint8)
    np.testing.assert_array_equal(video.run(frames), frames)
    assert not video.safety_models and not video.postprocessors


# ------------------------------ the LLM guards ------------------------------


def _tokenizer(path, chat: bool):
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    from transformers import PreTrainedTokenizerFast

    vocab = {w: i for i, w in enumerate(
        ["<unk>", "hello", "world", "safe", "unsafe", "a", "b", "[INST]", "[/INST]", "User:",
         "O2", "unsafe\nO2"])}
    tok = Tokenizer(WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>", eos_token="<unk>")
    if chat:
        fast.chat_template = "{% for m in messages %}{{ m['content'] }} {% endfor %}"
    fast.save_pretrained(path)
    return len(vocab)


def _llama(path, vocab, kv_heads, rope_scaling=None, seed=0):
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(seed)
    model = LlamaForCausalLM(LlamaConfig(
        vocab_size=vocab, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=kv_heads, max_position_embeddings=256,
        rms_norm_eps=1e-5, tie_word_embeddings=False, rope_theta=500000.0,
        rope_scaling=rope_scaling))
    model.save_pretrained(path)
    return model


def _jax_fp32(guard):
    """The JAX guard with its cfg and params in fp32."""
    guard.cfg = dataclasses.replace(guard.cfg, dtype=jnp.float32)
    guard.params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), guard.params)
    return guard


def _fp32(model):
    """An fp32 ARTransformer with a bf16 one's values."""
    return tg._build_ar(dataclasses.replace(model.cfg, dtype=torch.float32), "cpu",
                        {k: v.float() for k, v in model.state_dict().items()})


def _record_decodes(guard):
    seen = []
    decode = guard.tokenizer.decode

    def recording(ids, **kw):
        seen.append(np.asarray(ids).copy())
        return decode(ids, **kw)

    guard.tokenizer.decode = recording
    return seen


PROMPTS = ["hello world a b", "a " * 40 + "unsafe world", "b"]


def test_llamaguard3_gives_jax_ids(tmp_path):
    path = tmp_path / "meta-llama" / "Llama-Guard-3-8B"
    path.mkdir(parents=True)
    vocab = _tokenizer(path, chat=True)
    _llama(path, vocab, kv_heads=1, rope_scaling={
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
        "original_max_position_embeddings": 32})
    theirs = _jax_fp32(jg.LlamaGuard3(str(tmp_path), max_seq_len=48))
    bf16 = tg.LlamaGuard3.from_checkpoint(str(tmp_path), max_seq_len=48, device="cpu")
    assert bf16.model.tok_embeddings.weight.dtype == torch.bfloat16
    assert isinstance(bf16.is_safe(PROMPTS[0])[0], bool)
    ours = tg.LlamaGuard3(_fp32(bf16.model), bf16.tokenizer)
    assert ours.cfg.rope_scaling == theirs.cfg.rope_scaling == (8.0, 1.0, 4.0, 32)
    seen = _record_decodes(theirs)
    for prompt in PROMPTS:  # the second passes max_seq_len - 16: head + tail
        want = theirs.is_safe(prompt)
        ids, text = ours.moderate(prompt)
        np.testing.assert_array_equal(ids, seen[-1])
        assert ours.is_safe(prompt) == want


def _adapter(tmp_path, base, targets, r, alpha, flat: bool):
    from peft import LoraConfig, get_peft_model

    model = get_peft_model(base, LoraConfig(r=r, lora_alpha=alpha, target_modules=targets))
    with torch.no_grad():
        gen = torch.Generator().manual_seed(3)
        for n, p in model.named_parameters():
            if "lora_B" in n:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    adapter_dir = tmp_path / "nvidia" / "Aegis-AI-Content-Safety-LlamaGuard-Defensive-1.0"
    adapter_dir.mkdir(parents=True)
    model.save_pretrained(adapter_dir)
    if flat and not (adapter_dir / "adapter_config.json").exists():
        sub = next(d for d in adapter_dir.iterdir() if d.is_dir())
        for f in sub.iterdir():
            shutil.move(str(f), adapter_dir / f.name)
    return adapter_dir


def test_peft_merge_matches_jax(tmp_path):
    from gen3c_tpu.models.ar_transformer import ARConfig as JConfig
    from gen3c_tpu.models.convert import convert_hf_llama as jconvert
    from gen3c_tpu_torch.models.ar_transformer import ARConfig
    from gen3c_tpu_torch.models.convert import convert_hf_llama

    base = _llama(tmp_path / "base", 32, kv_heads=2)
    base_sd = {k: v.clone() for k, v in base.state_dict().items()}
    targets = ["q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"]
    adir = _adapter(tmp_path, base, targets, r=4, alpha=8, flat=True)
    jcfg = JConfig(dim=32, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=32,
                   ffn_hidden_size=64, max_seq_len=32, use_qk_normalization=False,
                   dtype=jnp.float32)
    params = jconvert(base_sd, jcfg, dtype=jnp.float32)
    assert jg.merge_peft_lora_into_llama(params, jg.load_peft_adapter_state(str(adir)), jcfg,
                                         alpha=8, r=4) == 14
    cfg = ARConfig(dim=32, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=32,
                   ffn_hidden_size=64, max_seq_len=32, use_qk_normalization=False,
                   dtype=torch.float32)
    model = tg._build_ar(cfg, "cpu", convert_hf_llama(base_sd, cfg))
    assert tg.merge_peft_lora_into_llama(model, tg.load_peft_adapter_state(str(adir)),
                                         alpha=8, r=4) == 14
    names = {"wq": "attention.wq", "wk": "attention.wk", "wv": "attention.wv",
             "wo": "attention.wo", "w1": "feed_forward.w1", "w2": "feed_forward.w2",
             "w3": "feed_forward.w3"}
    for li in range(2):
        for k, ours in names.items():
            np.testing.assert_allclose(
                model.layers[li].get_submodule(ours).weight.numpy(),
                np.asarray(params["layers"][li][k]).T, rtol=0, atol=1e-6,
                err_msg=f"layer {li} {k}")


def test_aegis_gives_jax_ids(tmp_path):
    base_dir = tmp_path / "meta-llama" / "LlamaGuard-7b"
    base_dir.mkdir(parents=True)
    vocab = _tokenizer(base_dir, chat=False)
    base = _llama(base_dir, vocab, kv_heads=4, seed=1)  # multi-head, as LlamaGuard-7b
    _adapter(tmp_path, base, ["q_proj", "v_proj", "down_proj"], r=2, alpha=4, flat=True)
    theirs = _jax_fp32(jg.Aegis(str(tmp_path), max_seq_len=256))
    bf16 = tg.Aegis.from_checkpoint(str(tmp_path), max_seq_len=256, device="cpu")
    ours = tg.Aegis(_fp32(bf16.model), bf16.tokenizer)
    assert ours.cfg.n_heads == ours.cfg.n_kv_heads == 4
    seen = _record_decodes(theirs)
    for prompt in ("hello world", "a b " * 30):
        want = theirs.is_safe(prompt)
        ids, _ = ours.moderate(prompt)
        assert ids.shape == (100,)
        np.testing.assert_array_equal(ids, seen[-1])
        assert ours.is_safe(prompt) == want
    np.testing.assert_array_equal(ours.prompt_ids("hello"), np.asarray(theirs.tokenizer(
        [theirs.get_moderation_prompt("hello")], add_special_tokens=False,
        return_tensors="np")["input_ids"]))
    for out in ("unsafe\nO2", "unsafe", "unsafe\nO99", "safe", "unsafe\nO13, O1"):
        assert tg.Aegis.block_message(out) == jg.Aegis.block_message(out)
    assert tg.Aegis.get_moderation_prompt("x") == theirs.get_moderation_prompt("x")
    assert tg.AEGIS_CATEGORIES == jg.AEGIS_CATEGORIES


def test_aegis_without_adapter_matrices_raises(tmp_path):
    base_dir = tmp_path / "meta-llama" / "LlamaGuard-7b"
    base_dir.mkdir(parents=True)
    vocab = _tokenizer(base_dir, chat=False)
    base = _llama(base_dir, vocab, kv_heads=4)
    adir = _adapter(tmp_path, base, ["q_proj"], r=2, alpha=4, flat=True)
    from safetensors.torch import save_file

    (adir / "adapter_model.safetensors").unlink()
    save_file({"unrelated.weight": torch.zeros(2)}, str(adir / "adapter_model.safetensors"))
    with pytest.raises(ValueError, match="no LoRA matrices"):
        tg.Aegis.from_checkpoint(str(tmp_path), device="cpu")


def test_text_factory_prefers_aegis(tmp_path, monkeypatch):
    guard_dir = tmp_path / "meta-llama" / "Llama-Guard-3-8B"
    guard_dir.mkdir(parents=True)
    _llama(guard_dir, _tokenizer(guard_dir, chat=True), kv_heads=1)
    base_dir = tmp_path / "meta-llama" / "LlamaGuard-7b"
    base_dir.mkdir(parents=True)
    base = _llama(base_dir, _tokenizer(base_dir, chat=False), kv_heads=4)
    _adapter(tmp_path, base, ["q_proj"], r=2, alpha=4, flat=True)
    for prefer, kind in (("", tg.Aegis), ("llamaguard3", tg.LlamaGuard3), ("aegis", tg.Aegis)):
        monkeypatch.setenv("GEN3C_GUARDRAIL", prefer)
        runner = tg.create_text_guardrail_runner(str(tmp_path), device="cpu")
        assert [type(m) for m in runner.safety_models] == [tg.Blocklist, kind]


# ------------------------------ the pipeline hooks ------------------------------


def _tiny_inputs(p, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (1, 3, 1, p.height, p.width)).astype(np.float32),
            torch.zeros(1, p.chunk_size, 1, 3, p.height, p.width),
            torch.ones(1, p.chunk_size, 1, 1, p.height, p.width))


def test_pipeline_guard_hooks(monkeypatch):
    from gen3c_tpu_torch.pipelines.factory import build_gen3c_model
    from gen3c_tpu_torch.pipelines.gen3c_pipeline import Gen3cPipeline

    model, p = build_gen3c_model("gen3c_tiny", device="cpu", seed=0)
    inputs = _tiny_inputs(p)
    free, _ = Gen3cPipeline(model=model, num_steps=1).generate("a prompt", *inputs)
    # a blocked prompt: None before any encode
    blocker = tg.GuardrailRunner([tg.Blocklist(extra_words=["forbiddenword"])])

    def no_encode(*a, **k):
        raise AssertionError("encoded a blocked prompt")

    pipe = Gen3cPipeline(model=model, num_steps=1, text_guardrail=blocker)
    monkeypatch.setattr(model, "create_condition_latent_from_input_frames", no_encode)
    assert pipe.generate("a forbiddenword prompt", *inputs) is None
    monkeypatch.undo()
    out, prompt = pipe.generate("a prompt", *inputs)
    np.testing.assert_array_equal(out, free)
    # a blocked video: None after the decode; a passing one post-processed
    blocked = Gen3cPipeline(model=model, num_steps=1,
                            video_guardrail=tg.GuardrailRunner([_Fixed(False)]))
    assert blocked.generate("a prompt", *inputs) is None
    assert blocked.last_timings["decode"] > 0
    passing = Gen3cPipeline(model=model, num_steps=1, video_guardrail=tg.GuardrailRunner(
        [_Fixed(True)], postprocessors=[_AddOne()]))
    out, _ = passing.generate("a prompt", *inputs)
    np.testing.assert_array_equal(out, free + 1)


def test_chunked_generation_raises_on_a_blocked_chunk():
    from gen3c_tpu_torch.cache import Cache3DBuffer
    from gen3c_tpu_torch.ops.camera import generate_camera_trajectory
    from gen3c_tpu_torch.pipelines.chunked import run_chunked_generation
    from gen3c_tpu_torch.pipelines.depth import default_intrinsics
    from gen3c_tpu_torch.pipelines.factory import build_gen3c_model
    from gen3c_tpu_torch.pipelines.gen3c_pipeline import Gen3cPipeline

    model, p = build_gen3c_model("gen3c_tiny", device="cpu", seed=0)
    h, w = p.height, p.width
    image = _tiny_inputs(p)[0]
    k = default_intrinsics(h, w)
    w2c0 = np.eye(4, dtype=np.float32)
    cache = Cache3DBuffer(frame_buffer_max=1, input_image=torch.from_numpy(image[:, :, 0]),
                          input_depth=torch.full((1, 1, h, w), 2.0),
                          input_w2c=torch.from_numpy(w2c0[None]),
                          input_intrinsics=torch.from_numpy(k[None]), device="cpu")
    w2cs, ks = generate_camera_trajectory("left", w2c0, k, p.chunk_size, 0.3, "center_facing",
                                          1.0)
    for guard in ({"text_guardrail": tg.GuardrailRunner([_Fixed(False)])},
                  {"video_guardrail": tg.GuardrailRunner([_Fixed(False)])}):
        pipe = Gen3cPipeline(model=model, num_steps=1, **guard)
        with pytest.raises(RuntimeError, match="Generation blocked by guardrail"):
            run_chunked_generation(pipe, cache, w2cs, ks, seed_frames=image, prompt="p")
