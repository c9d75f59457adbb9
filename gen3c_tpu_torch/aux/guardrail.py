"""Content-safety guardrails (port of gen3c_tpu/aux/guardrail.py).

  * ``GuardrailRunner`` chains safety models and post-processors; ``run``
    takes a prompt (-> bool) or uint8 frames (-> the post-processed frames,
    None when blocked).
  * ``Blocklist``: the word-list text filter (leet variants, whitelist
    uncensor, a WordNet-noun lemmatized second pass, exact and partial
    matches), pure Python, a copy of the JAX package's.
  * ``LlamaGuard3`` (Llama-Guard-3-8B) and ``Aegis`` (LlamaGuard-7b with the
    Aegis LoRA adapter merged into its weights) on the port's
    ``ARTransformer``: greedy generation through ``generate_bucketed``, its
    attention K8 (``kernels.gqa_attention``).
  * ``VideoContentSafetyFilter``: SigLIP so400m features and the 7-class
    head (``aux/siglip.py``); ``RetinaFaceFilter``: face detection and
    pixelation (``aux/retinaface.py``).

Each model-backed class is built from its parts (the network, the
tokenizer); ``from_checkpoint`` loads those parts from a checkpoint
directory under the JAX class's signature, reading Hugging Face files
through ``transformers``, which only that path imports. The networks run
on ``device`` ("cuda" unless the caller asks for the CPU).
"""

from __future__ import annotations

import json
import os
import re
import string
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from gen3c_tpu_torch.utils import log


class ContentSafetyGuardrail:
    def is_safe(self, x: Any) -> Tuple[bool, str]:
        raise NotImplementedError


class PostprocessingGuardrail:
    def postprocess(self, frames: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class GuardrailRunner:
    """Safety models in order, the first refusal wins; then the
    post-processors over frames that passed."""

    def __init__(
        self,
        safety_models: Optional[List[ContentSafetyGuardrail]] = None,
        generic_block_msg: str = "",
        generic_safe_msg: str = "",
        postprocessors: Optional[List[PostprocessingGuardrail]] = None,
    ):
        self.safety_models = safety_models
        self.generic_block_msg = generic_block_msg
        self.generic_safe_msg = generic_safe_msg or "Prompt is safe"
        self.postprocessors = postprocessors

    def run_safety_check(self, x: Any) -> Tuple[bool, str]:
        if not self.safety_models:
            log.warning("No safety models found, returning safe")
            return True, self.generic_safe_msg
        for guardrail in self.safety_models:
            name = type(guardrail).__name__.upper()
            safe, message = guardrail.is_safe(x)
            if not safe:
                return False, self.generic_block_msg or f"{name}: {message}"
        return True, self.generic_safe_msg

    def postprocess(self, frames: np.ndarray) -> np.ndarray:
        if not self.postprocessors:
            return frames
        for pp in self.postprocessors:
            frames = pp.postprocess(frames)
        return frames

    def run(self, x: Any):
        """A prompt: True when safe, else False. Frames: the post-processed
        frames when safe, else None."""
        is_safe, msg = self.run_safety_check(x)
        if not is_safe:
            log.error(f"GUARDRAIL BLOCKED: {msg}")
            return None if not isinstance(x, str) else False
        if isinstance(x, str):
            return True
        return self.postprocess(x)


# better_profanity-equivalent leetspeak character variants: a censor
# word matches a prompt token when every character of the token is one
# of the word character's variants (VaryingString equality semantics)
_CHARS_MAPPING = {
    "a": ("a", "@", "*", "4"),
    "i": ("i", "*", "l", "1"),
    "o": ("o", "*", "0", "@"),
    "u": ("u", "*", "v"),
    "v": ("v", "*", "u"),
    "l": ("l", "1"),
    "e": ("e", "*", "3"),
    "s": ("s", "$", "5"),
    "t": ("t", "7"),
}
# characters that can be part of a word during censoring (everything
# else is a separator): letters, digits, and the leet variant chars
_WORD_CHARS = (
    set(string.ascii_letters) | set(string.digits) | {"@", "$", "*", "'"}
)


def _to_ascii(prompt: str) -> str:
    """blocklist/utils.py:44-46 parity."""
    return re.sub(r"[^\x00-\x7F]+", " ", prompt)


def _variant_match(word: str, token: str) -> bool:
    """True when `token` is a leetspeak variant of censor word `word`."""
    if len(word) != len(token):
        return False
    return all(
        t in _CHARS_MAPPING.get(w, (w,)) for w, t in zip(word, token)
    )


class _FuzzyCensor:
    """Word/phrase censor with leet variants (the better_profanity role
    in blocklist/blocklist.py:23,52,80: whole-word case-insensitive
    match, multi-word phrases, each hit replaced by censor_char*4)."""

    def __init__(self, words: List[str], whitelist: List[str]):
        wl = {w.strip().lower() for w in whitelist}
        self.phrases = [
            tuple(w.lower().split())
            for w in words
            if w.strip() and w.strip().lower() not in wl
        ]
        self.max_len = max((len(p) for p in self.phrases), default=1)

    def censor(self, text: str, censor_char: str = "*") -> str:
        # tokenize into (start, end, lowered word) runs of word chars
        tokens, i, n = [], 0, len(text)
        while i < n:
            if text[i] in _WORD_CHARS:
                j = i
                while j < n and text[j] in _WORD_CHARS:
                    j += 1
                tokens.append((i, j, text[i:j].lower()))
                i = j
            else:
                i += 1
        out, pos, t = [], 0, 0
        while t < len(tokens):
            matched_span = None
            for plen in range(min(self.max_len, len(tokens) - t), 0, -1):
                window = tokens[t:t + plen]
                for phrase in self.phrases:
                    if len(phrase) != plen:
                        continue
                    if all(
                        _variant_match(pw, tok[2])
                        for pw, tok in zip(phrase, window)
                    ):
                        matched_span = (window[0][0], window[-1][1], plen)
                        break
                if matched_span:
                    break
            if matched_span:
                start, end, plen = matched_span
                out.append(text[pos:start])
                out.append(censor_char * 4)
                pos = end
                t += plen
            else:
                t += 1
        out.append(text[pos:])
        return "".join(out)


# WordNet noun morphology (nltk MORPHOLOGICAL_SUBSTITUTIONS['n'] — the
# default pos the reference's lemmatizer.lemmatize(token) uses)
_NOUN_RULES = (
    ("s", ""), ("ses", "s"), ("ves", "f"), ("xes", "x"), ("zes", "z"),
    ("ches", "ch"), ("shes", "sh"), ("men", "man"), ("ies", "y"),
)
# common noun.exc irregulars (WordNet exception-list role)
_NOUN_EXCEPTIONS = {
    "men": "man", "women": "woman", "children": "child", "feet": "foot",
    "teeth": "tooth", "geese": "goose", "mice": "mouse", "lice": "louse",
    "oxen": "ox", "dice": "die", "knives": "knife", "wives": "wife",
    "lives": "life", "leaves": "leaf", "loaves": "loaf",
    "thieves": "thief", "selves": "self", "elves": "elf",
    "halves": "half", "calves": "calf", "shelves": "shelf",
    "scarves": "scarf", "hooves": "hoof", "wolves": "wolf",
    "corpora": "corpus", "analyses": "analysis", "crises": "crisis",
}


class _NounLemmatizer:
    """WordNet-morphy noun lemmatization against a provided lexicon
    (the nltk.WordNetLemmatizer role in blocklist/blocklist.py:42,173-175
    — the reference calls lemmatize(token) with the default pos='n').

    morphy validates rule outputs against the WordNet lexicon; without
    nltk data the lexicon here is the loaded word lists themselves —
    exactly the vocabulary whose inflected forms must fold back onto
    blocklist entries for the censor's second pass to behave like the
    reference's. Unknown words pass through unchanged, as in morphy.
    """

    def __init__(self, lexicon):
        self.lexicon = set(lexicon) | set(_NOUN_EXCEPTIONS.values())

    def lemmatize(self, form: str) -> str:
        word = form.lower()
        if word in _NOUN_EXCEPTIONS:
            return _NOUN_EXCEPTIONS[word]

        def apply_rules(forms):
            return [
                f[: -len(old)] + new
                for f in forms
                for old, new in _NOUN_RULES
                if f.endswith(old)
            ]

        forms = apply_rules([word])
        valid = [f for f in [word] + forms if f in self.lexicon]
        if valid:
            return min(valid, key=len)
        while forms:
            forms = apply_rules(forms)
            valid = [f for f in forms if f in self.lexicon]
            if valid:
                return min(valid, key=len)
        return form


class Blocklist(ContentSafetyGuardrail):
    """Word-blocklist text filter (blocklist/blocklist.py:32-192 parity):
    leet-variant fuzzy censoring with whitelist uncensor, a lemmatized
    second pass (WordNet noun morphy, lexicon = the word lists), and the
    exact-match list with SequenceMatcher partial matching. Word lists
    load from <checkpoint_dir>/blocklist/{custom,whitelist,exact_match}/
    (reference checkpoint layout); loose *.txt under blocklist/ are
    treated as custom words."""

    CENSOR = "*"

    def __init__(self, checkpoint_dir: Optional[str] = None,
                 extra_words: Optional[List[str]] = None,
                 whitelist_words: Optional[List[str]] = None,
                 exact_match_words: Optional[List[str]] = None,
                 guardrail_partial_match_min_chars: int = 6,
                 guardrail_partial_match_letter_count: float = 0.4):
        self.guardrail_partial_match_min_chars = (
            guardrail_partial_match_min_chars
        )
        self.guardrail_partial_match_letter_count = (
            guardrail_partial_match_letter_count
        )
        self.blocklist_words = [w.lower() for w in (extra_words or [])]
        self.whitelist_words = [w.lower() for w in (whitelist_words or [])]
        self.exact_match_words = [
            w.lower() for w in (exact_match_words or [])
        ]
        if checkpoint_dir:
            bl_dir = os.path.join(checkpoint_dir, "blocklist")
            if os.path.isdir(bl_dir):
                for root, _, files in os.walk(bl_dir):
                    sub = os.path.relpath(root, bl_dir).split(os.sep)[0]
                    target = {
                        "whitelist": self.whitelist_words,
                        "exact_match": self.exact_match_words,
                    }.get(sub, self.blocklist_words)
                    for f in sorted(files):
                        if f.endswith(".txt"):
                            with open(os.path.join(root, f)) as fh:
                                target.extend(
                                    line.strip().lower()
                                    for line in fh if line.strip()
                                )
        self._censor = _FuzzyCensor(self.blocklist_words,
                                    self.whitelist_words)
        lexicon = {
            part
            for w in (self.blocklist_words + self.whitelist_words
                      + self.exact_match_words)
            for part in w.split()
        }
        self.lemmatizer = _NounLemmatizer(lexicon)
        # back-compat alias (pre-round-3 API)
        self.words = set(self.blocklist_words)

    def uncensor_whitelist(self, input_prompt: str,
                           censored_prompt: str) -> str:
        """Restore whitelisted tokens (blocklist.py:57-66)."""
        input_words = input_prompt.split()
        censored_words = censored_prompt.split()
        whitelist = set(self.whitelist_words)
        for i, token in enumerate(input_words):
            if i < len(censored_words) and (
                token.strip(string.punctuation).lower() in whitelist
            ):
                censored_words[i] = token
        return " ".join(censored_words)

    def censor_prompt(self, input_prompt: str) -> Tuple[bool, str]:
        """Fuzzy censor + whitelist uncensor (blocklist.py:68-84)."""
        censored = self._censor.censor(input_prompt, self.CENSOR)
        censored = self.uncensor_whitelist(input_prompt, censored)
        if self.CENSOR in censored:
            return True, (
                "Prompt blocked by censorship: "
                f"Censored Prompt: {censored}"
            )
        return False, ""

    @staticmethod
    def check_partial_match(
        normalized_prompt: str, normalized_word: str,
        guardrail_partial_match_letter_count: float,
    ) -> Tuple[bool, str]:
        """SequenceMatcher partial match (blocklist.py:86-117)."""
        from difflib import SequenceMatcher

        prompt_words = normalized_prompt.split()
        word_length = len(normalized_word.split())
        max_ratio = (
            len(normalized_word) - float(
                guardrail_partial_match_letter_count
            )
        ) / float(len(normalized_word))
        for i in range(len(prompt_words) - word_length + 1):
            substring = " ".join(prompt_words[i:i + word_length])
            if SequenceMatcher(
                None, substring, normalized_word
            ).ratio() >= max_ratio:
                return True, (
                    "Prompt blocked by partial match blocklist: "
                    f"Prompt: {normalized_prompt}, "
                    f"Partial Match Word: {normalized_word}"
                )
        return False, ""

    def check_against_whole_word_blocklist(
        self, prompt: str, blocklist: List[str],
    ) -> Tuple[bool, str]:
        """Whole-word + partial exact-match pass (blocklist.py:119-158)."""
        normalized_prompt = re.sub(r"\s+", " ", prompt).strip().lower()
        for word in blocklist:
            normalized_word = re.sub(r"\s+", " ", word).strip().lower()
            if re.search(
                r"\b" + re.escape(normalized_word) + r"\b",
                normalized_prompt,
            ):
                return True, (
                    "Prompt blocked by exact match blocklist: "
                    f"Prompt: {prompt}, Exact Match Word: {word}"
                )
            if len(normalized_word) >= (
                self.guardrail_partial_match_min_chars
            ):
                match, message = self.check_partial_match(
                    normalized_prompt, normalized_word,
                    self.guardrail_partial_match_letter_count,
                )
                if match:
                    return True, message
        return False, ""

    def is_safe(self, prompt: str = "") -> Tuple[bool, str]:
        """Full reference check order (blocklist.py:160-192)."""
        if not prompt:
            return False, "Input is empty"
        prompt = _to_ascii(prompt)

        censored, message = self.censor_prompt(prompt)
        if censored:
            return False, message

        # lemmatized second pass catches inflected blocklist words
        # (token class keeps interior @/*/$ like nltk's treebank
        # tokenizer, so leet-variant words survive as single tokens)
        tokens = re.findall(r"[A-Za-z0-9'@*$]+|[^\sA-Za-z0-9'@*$]", prompt)
        lemmatized = " ".join(
            self.lemmatizer.lemmatize(tok) for tok in tokens
        )
        censored, message = self.censor_prompt(lemmatized)
        if censored:
            return False, message

        censored, message = self.check_against_whole_word_blocklist(
            prompt, self.exact_match_words
        )
        if censored:
            return False, message

        return True, "Input is safe"


# ------------------------------ LLM guards ------------------------------


def _hf_ar_config(hf, max_seq_len: int, rope_scaling):
    """The bf16 ARConfig of a Hugging Face llama config (no qk-norm)."""
    from gen3c_tpu_torch.models.ar_transformer import ARConfig

    return ARConfig(dim=hf.hidden_size, n_layers=hf.num_hidden_layers,
                    n_heads=hf.num_attention_heads, n_kv_heads=hf.num_key_value_heads,
                    vocab_size=hf.vocab_size, ffn_hidden_size=hf.intermediate_size,
                    norm_eps=hf.rms_norm_eps, rope_theta=hf.rope_theta, max_seq_len=max_seq_len,
                    use_qk_normalization=False, rope_scaling=rope_scaling,
                    dtype=torch.bfloat16)


def _build_ar(cfg, device, state_dict=None):
    """An ARTransformer on ``device``, allocated there without an init, then
    loaded from ``state_dict`` when one is given."""
    from gen3c_tpu_torch.models.ar_transformer import ARTransformer

    with torch.device("meta"):
        model = ARTransformer(cfg)
    model = model.to_empty(device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model


def _head_and_tail(ids: np.ndarray, limit: int) -> np.ndarray:
    """The first limit // 2 and the last limit - limit // 2 ids of a row
    longer than ``limit``: the guards' templates put their instruction at
    the end, which must survive."""
    if ids.shape[1] <= limit:
        return ids
    head = limit // 2
    return np.concatenate([ids[:, :head], ids[:, -(limit - head):]], axis=1)


class _LLMGuard(ContentSafetyGuardrail):
    """A guard that generates ``NEW_TOKENS`` greedy tokens from the
    tokenized moderation prompt (truncated to head + tail at max_seq_len -
    NEW_TOKENS) and reads its verdict in their text."""

    NEW_TOKENS = 16

    def __init__(self, model, tokenizer):
        self.model = model
        self.tokenizer = tokenizer

    @property
    def cfg(self):
        return self.model.cfg

    def prompt_ids(self, prompt: str) -> np.ndarray:
        raise NotImplementedError

    def moderate(self, prompt: str) -> Tuple[np.ndarray, str]:
        """(the NEW_TOKENS new ids, their text without special tokens)."""
        from gen3c_tpu_torch.models.ar_transformer import generate_bucketed

        ids = _head_and_tail(self.prompt_ids(prompt), self.cfg.max_seq_len - self.NEW_TOKENS)
        out = generate_bucketed(self.model, ids, max_new_tokens=self.NEW_TOKENS, temperature=0.0,
                                pad_id=int(self.tokenizer.eos_token_id or 0))
        new = out[0, out.shape[1] - self.NEW_TOKENS:].cpu().numpy()
        return new, self.tokenizer.decode(new, skip_special_tokens=True)


class LlamaGuard3(_LLMGuard):
    """The Llama-Guard-3-8B text classifier: the chat-templated prompt, 16
    greedy tokens, unsafe when their text says "unsafe"."""

    PATH = "meta-llama/Llama-Guard-3-8B"

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str, max_seq_len: int = 4096,
                        device="cuda") -> "LlamaGuard3":
        """<checkpoint_dir>/meta-llama/Llama-Guard-3-8B through transformers
        (Llama 3.1's rope_scaling kept); GEN3C_QUANTIZE_LLM=1: int8
        weight-only (``maybe_quantized_convert``)."""
        path = os.path.join(checkpoint_dir, cls.PATH)
        if not os.path.isdir(path):
            raise FileNotFoundError(f"LlamaGuard3 checkpoint not found at {path}; run with "
                                    "blocklist-only guardrails or download the checkpoint")
        from transformers import AutoConfig, AutoModelForCausalLM, AutoTokenizer

        from gen3c_tpu_torch.models.convert import convert_hf_llama
        from gen3c_tpu_torch.models.quantize import maybe_quantized_convert

        tokenizer = AutoTokenizer.from_pretrained(path)
        hf = AutoConfig.from_pretrained(path)
        rs = getattr(hf, "rope_scaling", None)
        cfg = _hf_ar_config(hf, max_seq_len, (rs["factor"], rs["low_freq_factor"],
                                              rs["high_freq_factor"],
                                              rs["original_max_position_embeddings"])
                            if rs else None)
        sd = AutoModelForCausalLM.from_pretrained(path).state_dict()
        model = maybe_quantized_convert(
            lambda dev: _build_ar(cfg, dev, convert_hf_llama(sd, cfg)), device=device)
        return cls(model, tokenizer)

    def prompt_ids(self, prompt: str) -> np.ndarray:
        chat = [{"role": "user", "content": prompt}]
        return np.asarray(self.tokenizer.apply_chat_template(chat, return_tensors="np"))

    def is_safe(self, prompt: str) -> Tuple[bool, str]:
        _, text = self.moderate(prompt)
        safe = "unsafe" not in text.lower()
        return safe, "" if safe else f"LlamaGuard3 verdict: {text.strip()}"


# Aegis 1.0/2.0 content-safety taxonomy (aegis/categories.py ids): the
# adapter answers "unsafe\nO<k>"; k indexes this table.
AEGIS_CATEGORIES = (
    ("violence", "violent content"),
    ("sexual", "sexually explicit content"),
    ("criminal_planning", "criminal planning or confessions"),
    ("weapons", "guns and illegal weapons"),
    ("substance_abuse", "controlled or regulated substances"),
    ("suicide_and_self_harm", "suicide or self-harm"),
    ("sexual_minor", "sexual content involving minors"),
    ("hate_identity_hate", "hate or identity-based hate"),
    ("pii", "personal identifying information or privacy violations"),
    ("harassment", "harassment"),
    ("threat", "threats"),
    ("profanity", "profanity"),
    ("needs_caution", "content that needs caution"),
)

_LORA_TARGETS = {
    "q_proj": "attention.wq", "k_proj": "attention.wk", "v_proj": "attention.wv",
    "o_proj": "attention.wo", "gate_proj": "feed_forward.w1", "down_proj": "feed_forward.w2",
    "up_proj": "feed_forward.w3",
}


@torch.no_grad()
def merge_peft_lora_into_llama(model, adapter_state, alpha: float, r: int) -> int:
    """Merge a PEFT LoRA adapter into an ``ARTransformer`` in place: W <- W
    + (alpha / r) * (B @ A) on each targeted projection, (B @ A) formed in
    fp32 on the weight's device and cast to its dtype before the add (as
    the JAX package adds it). adapter_state keys follow peft naming
    (``base_model.model.model.layers.{i}.self_attn.q_proj.lora_A.weight``),
    values tensors or arrays. Returns the number of matrices merged."""
    scale = float(alpha) / float(r)
    pat = re.compile(r"layers\.(\d+)\.(?:self_attn|mlp)\.(\w+)\.lora_A\.weight$")
    merged = 0
    for key_a, a in adapter_state.items():
        m = pat.search(key_a)
        if not m:
            continue
        li, proj = int(m.group(1)), m.group(2)
        ours = _LORA_TARGETS.get(proj)
        if ours is None or li >= len(model.layers):
            continue
        w = model.layers[li].get_submodule(ours).weight
        b = adapter_state[key_a.replace("lora_A", "lora_B")]
        a, b = (torch.as_tensor(np.asarray(t)) if not isinstance(t, torch.Tensor) else t
                for t in (a, b))
        delta = (b.to(w.device, torch.float32) @ a.to(w.device, torch.float32)) * scale
        w.add_(delta.to(w.dtype))
        merged += 1
    return merged


def load_peft_adapter_state(adapter_dir: str) -> dict:
    """A PEFT adapter's tensors (safetensors first, else the torch .bin)
    without peft."""
    st_path = os.path.join(adapter_dir, "adapter_model.safetensors")
    if os.path.exists(st_path):
        from safetensors.torch import load_file

        return load_file(st_path)
    bin_path = os.path.join(adapter_dir, "adapter_model.bin")
    if os.path.exists(bin_path):
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no adapter weights under {adapter_dir}")


class Aegis(_LLMGuard):
    """The Aegis content-safety classifier: LlamaGuard-7b with the Aegis
    LoRA adapter merged into its weights, the O1..O13 moderation prompt, 100
    greedy tokens, and "unsafe\\nO<k>" mapped to the category's message."""

    BASE = "meta-llama/LlamaGuard-7b"
    ADAPTER = "nvidia/Aegis-AI-Content-Safety-LlamaGuard-Defensive-1.0"
    NEW_TOKENS = 100

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str, max_seq_len: int = 4096,
                        device="cuda") -> "Aegis":
        """The base and the adapter under <checkpoint_dir>, the adapter
        merged before any quantization (GEN3C_QUANTIZE_LLM=1)."""
        base_dir = os.path.join(checkpoint_dir, cls.BASE)
        adapter_dir = os.path.join(checkpoint_dir, cls.ADAPTER)
        for d in (base_dir, adapter_dir):
            if not os.path.isdir(d):
                raise FileNotFoundError(f"Aegis checkpoint not found at {d}")
        from transformers import AutoConfig, AutoModelForCausalLM, AutoTokenizer

        from gen3c_tpu_torch.models.convert import convert_hf_llama
        from gen3c_tpu_torch.models.quantize import maybe_quantized_convert

        tokenizer = AutoTokenizer.from_pretrained(base_dir)
        cfg = _hf_ar_config(AutoConfig.from_pretrained(base_dir), max_seq_len, None)
        sd = AutoModelForCausalLM.from_pretrained(base_dir).state_dict()
        adapter_state = load_peft_adapter_state(adapter_dir)
        with open(os.path.join(adapter_dir, "adapter_config.json")) as f:
            acfg = json.load(f)
        merged = {"n": 0}

        def convert_and_merge(dev):
            model = _build_ar(cfg, dev, convert_hf_llama(sd, cfg))
            merged["n"] = merge_peft_lora_into_llama(model, adapter_state,
                                                     alpha=acfg.get("lora_alpha", 32),
                                                     r=acfg.get("r", 16))
            return model

        model = maybe_quantized_convert(convert_and_merge, device=device)
        if merged["n"] == 0:
            raise ValueError(f"no LoRA matrices merged from {adapter_dir}")
        log.info(f"Aegis: merged {merged['n']} LoRA matrices into the base model")
        return cls(model, tokenizer)

    @staticmethod
    def get_moderation_prompt(user_prompt: str) -> str:
        cats = "\n".join(f"O{i + 1}: {name.replace('_', ' ').title()}."
                         for i, (name, _) in enumerate(AEGIS_CATEGORIES))
        return (
            "[INST] Task: Check if there is unsafe content in 'User' "
            "messages in conversations according our safety policy with "
            "the below categories.\n"
            "<BEGIN UNSAFE CONTENT CATEGORIES>\n"
            f"{cats}\n"
            "<END UNSAFE CONTENT CATEGORIES>\n"
            "<BEGIN CONVERSATION>\n"
            f"User: {user_prompt}\n\n"
            "<END CONVERSATION>\n\n"
            "Provide your safety assessment for User in the above "
            "conversation:\n"
            "- First line must read 'safe' or 'unsafe'.\n"
            "- If unsafe, a second line must include a comma-separated "
            "list of violated categories. [/INST]"
        )

    @staticmethod
    def block_message(moderation_output: str) -> str:
        """'unsafe\\nO3' -> the category's block reason."""
        msg = "Prompt blocked by Aegis."
        lines = moderation_output.strip().split("\n")
        if len(lines) >= 2:
            m = re.search(r"O(\d+)", lines[1])
            if m:
                idx = int(m.group(1)) - 1
                if 0 <= idx < len(AEGIS_CATEGORIES):
                    name, reason = AEGIS_CATEGORIES[idx]
                    msg = f"{name}: this prompt is blocked due to {reason}."
        return msg

    def prompt_ids(self, prompt: str) -> np.ndarray:
        return np.asarray(self.tokenizer([self.get_moderation_prompt(prompt)],
                                         add_special_tokens=False,
                                         return_tensors="np")["input_ids"])

    def is_safe(self, prompt: str) -> Tuple[bool, str]:
        _, text = self.moderate(prompt)
        if "unsafe" in text.lower():
            return False, self.block_message(text)
        return True, ""


# ------------------------------ video guards ------------------------------

_SAFETY_CLASS_NAMES = {
    0: "Safe", 1: "Sexual_Content", 2: "Violence", 3: "Drugs",
    4: "Child_Abuse", 5: "Hate_and_Harassment", 6: "Self-Harm",
}


class VideoContentSafetyFilter(ContentSafetyGuardrail):
    """The frame-safety classifier: SigLIP so400m image features,
    L2-normalised, through the 7-class head; unsafe at the first frame
    whose class is not "Safe". Frames go through in batches of
    ``batch_size``, and the first unsafe frame by index is reported, as the
    frame-by-frame loop reports it."""

    PATH = os.path.join("nvidia/Cosmos-Guardrail1", "video_content_safety_filter")
    batch_size = 16

    def __init__(self, encoder, head):
        self.encoder = encoder
        self.head = head

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str,
                        siglip_name: str = "google/siglip-so400m-patch14-384",
                        device="cuda") -> "VideoContentSafetyFilter":
        """safety_filter.pt and the SigLIP model cached under
        <checkpoint_dir>/nvidia/Cosmos-Guardrail1/video_content_safety_filter
        (``siglip_name`` may also be a local directory)."""
        from gen3c_tpu_torch.aux import siglip as S

        path = os.path.join(checkpoint_dir, cls.PATH)
        head_path = os.path.join(path, "safety_filter.pt")
        if not os.path.isfile(head_path):
            raise FileNotFoundError(f"Video content safety checkpoint not found at {head_path}")
        from transformers import SiglipModel

        hf = SiglipModel.from_pretrained(siglip_name, cache_dir=path, local_files_only=True)
        vc = hf.config.vision_config
        cfg = S.SiglipVisionConfig(hidden_size=vc.hidden_size,
                                   intermediate_size=vc.intermediate_size,
                                   num_hidden_layers=vc.num_hidden_layers,
                                   num_attention_heads=vc.num_attention_heads,
                                   image_size=vc.image_size, patch_size=vc.patch_size,
                                   layer_norm_eps=vc.layer_norm_eps)
        encoder = S.SiglipVisionModel(cfg, device=device)
        encoder.load_state_dict(S.convert_hf_siglip_vision(hf.vision_model.state_dict(), cfg))
        ckpt = torch.load(head_path, map_location="cpu", weights_only=True)
        head = S.SafetyClassifier(cfg.hidden_size, device=device)
        head.load_state_dict(S.convert_safety_classifier(ckpt["model"]))
        return cls(encoder, head)

    def _batches(self, frames):
        """(index of the batch's first frame, its frames' classes on the
        CPU) for each batch of ``batch_size`` uint8 (H, W, 3) frames."""
        from gen3c_tpu_torch.aux.siglip import preprocess_frame

        size = self.encoder.cfg.image_size
        for s in range(0, len(frames), self.batch_size):
            pixels = np.stack([preprocess_frame(np.asarray(f), size)
                               for f in frames[s:s + self.batch_size]])
            feats = self.encoder(torch.from_numpy(pixels).to(self.encoder.device))
            feats = feats / torch.linalg.norm(feats, dim=-1, keepdim=True)
            yield s, torch.argmax(self.head(feats), dim=-1).cpu()

    @torch.no_grad()
    def is_safe(self, frames) -> Tuple[bool, str]:
        for s, classes in self._batches(frames):
            unsafe = torch.nonzero(classes != 0)
            if len(unsafe):
                i = int(unsafe[0, 0])
                name = _SAFETY_CLASS_NAMES.get(int(classes[i]), "Unknown")
                return False, f"unsafe frames detected (frame {s + i}: {name})"
        return True, "safe frames detected"


class RetinaFaceFilter(PostprocessingGuardrail):
    """Face blur: RetinaFace (ResNet-50) detections pixelated in place of
    the faces (``retinaface.blur_faces_in_frames``)."""

    PATH = os.path.join("nvidia/Cosmos-Guardrail1", "face_blur_filter", "Resnet50_Final.pth")

    def __init__(self, net, confidence_threshold: float = 0.7):
        self.net = net
        self.confidence_threshold = confidence_threshold

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str, confidence_threshold: float = 0.7,
                        device="cuda") -> "RetinaFaceFilter":
        from gen3c_tpu_torch.aux import retinaface as R

        path = os.path.join(checkpoint_dir, cls.PATH)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"RetinaFace checkpoint not found at {path}")
        net = R.RetinaFace(device=device)
        net.load_state_dict(R.convert_retinaface(
            torch.load(path, map_location="cpu", weights_only=True)))
        return cls(net, confidence_threshold)

    def postprocess(self, frames: np.ndarray) -> np.ndarray:
        from gen3c_tpu_torch.aux.retinaface import blur_faces_in_frames

        return blur_faces_in_frames(self.net, np.asarray(frames),
                                    confidence_threshold=self.confidence_threshold)


def create_text_guardrail_runner(checkpoint_dir: Optional[str] = None,
                                 device="cuda") -> GuardrailRunner:
    """The blocklist, then Aegis or else LlamaGuard3, whichever loads first
    (GEN3C_GUARDRAIL=aegis|llamaguard3 prefers or forces one); the
    blocklist alone when neither checkpoint is present."""
    models: List[ContentSafetyGuardrail] = [Blocklist(checkpoint_dir)]
    prefer = os.environ.get("GEN3C_GUARDRAIL", "").lower()
    ckpt = checkpoint_dir or "checkpoints"
    tried = []
    order = [Aegis, LlamaGuard3] if prefer != "llamaguard3" else [LlamaGuard3, Aegis]
    if prefer == "aegis":
        order = [Aegis]
    for cls in order:
        try:
            models.append(cls.from_checkpoint(ckpt, device=device))
            break
        except (FileNotFoundError, OSError, ImportError, ValueError) as e:
            tried.append(f"{cls.__name__}: {e}")
    else:
        log.warning(f"LLM guardrail unavailable ({'; '.join(tried)}); blocklist-only")
    return GuardrailRunner(safety_models=models)


def create_video_guardrail_runner(checkpoint_dir: Optional[str] = None,
                                  device="cuda") -> GuardrailRunner:
    """The video safety filter and the face blur; a pass-through runner when
    their checkpoints are absent."""
    try:
        return GuardrailRunner(
            safety_models=[VideoContentSafetyFilter.from_checkpoint(checkpoint_dir or "",
                                                                    device=device)],
            postprocessors=[RetinaFaceFilter.from_checkpoint(checkpoint_dir or "",
                                                             device=device)],
        )
    except (FileNotFoundError, OSError, NotImplementedError) as e:
        log.warning(f"Video guardrail unavailable ({e}); pass-through")
        return GuardrailRunner()
