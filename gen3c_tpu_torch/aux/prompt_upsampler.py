"""Prompt upsamplers (port of gen3c_tpu/aux/prompt_upsampler.py; Pixtral-12B
in the reference): a VLM rewrites a short prompt into a detailed one,
conditioned on a frame (video2world) or on the text alone (text2world).

  * PromptUpsampler: the interface
  * PassthroughUpsampler: identity (the default, disabled behaviour)
  * TemplateUpsampler: a dependency-free heuristic enrichment
  * HFPromptUpsampler: any Hugging Face causal LM, through transformers'
    own torch model
  * TorchPromptUpsampler (the JAX package's JaxPromptUpsampler): a
    llama / mistral-architecture chat LM on the port's ``ARTransformer``
  * VLMPromptUpsampler: the frame-conditioned path: the last frame through
    the Pixtral vision tower and projector (``aux/vision_encoder.py``), its
    tokens spliced into the chat stream at the [IMG] placeholder, greedy
    generation from the spliced embeddings (K8 over the KV cache)

Each model-backed upsampler is built from its parts (the networks, the
tokenizer); ``from_checkpoint`` / ``from_pretrained`` read Hugging Face
files through ``transformers``, which only those paths import. The port's
``ARTransformer``, like the JAX package's, derives head_dim = dim // heads:
a checkpoint whose attention has another head width (Pixtral-12B's
Mistral-NeMo text model: 5,120 wide, 32 heads of 128) cannot load, and the
loaders raise a ValueError that says so.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch



class PromptUpsampler:
    def upsample(self, prompt: str, frames=None) -> str:
        raise NotImplementedError


class PassthroughUpsampler(PromptUpsampler):
    def upsample(self, prompt: str, frames=None) -> str:
        return prompt


class TemplateUpsampler(PromptUpsampler):
    """Heuristic enrichment (keeps CLI flows exercisable w/o a 12B VLM)."""

    TEMPLATE = (
        "{prompt}. The video is photorealistic with natural lighting, "
        "consistent geometry and smooth, stable camera motion."
    )

    def upsample(self, prompt: str, frames=None) -> str:
        prompt = prompt.strip().rstrip(".")
        if not prompt:
            return "A photorealistic scene with natural lighting."
        return self.TEMPLATE.format(prompt=prompt)


class HFPromptUpsampler(PromptUpsampler):
    """Causal-LM-based upsampling via transformers (chat-completion
    pattern of run_chat_completion, text2world_prompt_upsampler_
    inference.py:26-149)."""

    SYSTEM = (
        "You are a prompt engineer. Expand the user's short video prompt "
        "into one detailed, photorealistic description. Reply with the "
        "expanded prompt only."
    )

    def __init__(self, model_path: str, max_new_tokens: int = 256, device="cuda"):
        from transformers import AutoModelForCausalLM, AutoTokenizer

        self.tokenizer = AutoTokenizer.from_pretrained(model_path)
        self.model = AutoModelForCausalLM.from_pretrained(model_path).to(device)
        self.device = torch.device(device)
        self.max_new_tokens = max_new_tokens

    def upsample(self, prompt: str, frames=None) -> str:
        chat = [
            {"role": "system", "content": self.SYSTEM},
            {"role": "user", "content": prompt},
        ]
        ids = self.tokenizer.apply_chat_template(
            chat, return_tensors="pt", add_generation_prompt=True
        ).to(self.device)
        with torch.no_grad():
            out = self.model.generate(
                ids,
                max_new_tokens=self.max_new_tokens,
                do_sample=False,
                pad_token_id=self.tokenizer.eos_token_id,
            )
        return self.tokenizer.decode(
            out[0][ids.shape[-1]:], skip_special_tokens=True
        ).strip()


def _check_head_dim(text_sd, n_heads: int, dim: int) -> None:
    """Raise when the checkpoint's q_proj rows are not ``dim``: the
    ARTransformer's head_dim is dim // n_heads."""
    rows = text_sd["model.layers.0.self_attn.q_proj.weight"].shape[0]
    if rows != dim:
        raise ValueError(
            f"the text model's attention is {n_heads} heads of {rows // n_heads} ({rows} "
            f"q_proj rows) in a {dim}-wide model, but ARTransformer derives head_dim = dim // "
            f"heads = {dim // n_heads} (as the JAX package's ARConfig does): this checkpoint "
            "cannot load (Pixtral-12B's Mistral-NeMo text model is 5,120 wide with 32 heads "
            "of 128)")


def _load_text_model(text_hf, text_sd, max_seq_len: int, rope_scaling, device):
    """The text model's bf16 ARTransformer on ``device`` from an HF llama /
    mistral config and state dict; GEN3C_QUANTIZE_LLM=1: int8 weights."""
    from gen3c_tpu_torch.aux.guardrail import _build_ar, _hf_ar_config
    from gen3c_tpu_torch.models.convert import convert_hf_llama
    from gen3c_tpu_torch.models.quantize import maybe_quantized_convert

    cfg = _hf_ar_config(text_hf, max_seq_len, rope_scaling)
    _check_head_dim(text_sd, cfg.n_heads, cfg.dim)
    return maybe_quantized_convert(lambda dev: _build_ar(cfg, dev, convert_hf_llama(text_sd, cfg)),
                                   device=device)


class TorchPromptUpsampler(PromptUpsampler):
    """The text-only upsampler on the port's ``ARTransformer`` (the JAX
    package's ``JaxPromptUpsampler``): HFPromptUpsampler's chat, head +
    tail truncation at max_seq_len - max_new_tokens, greedy
    ``generate_bucketed``."""

    SYSTEM = HFPromptUpsampler.SYSTEM

    def __init__(self, model, tokenizer, max_new_tokens: int = 256):
        self.model = model
        self.tokenizer = tokenizer
        self.max_new_tokens = max_new_tokens

    @classmethod
    def from_checkpoint(cls, model_path: str, max_new_tokens: int = 256,
                        max_seq_len: int = 1024, device="cuda") -> "TorchPromptUpsampler":
        """A llama / mistral chat checkpoint (or a multimodal one's text
        model) through transformers; llama3 rope scaling kept."""
        from transformers import AutoConfig, AutoModelForCausalLM, AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model_path)
        hf = AutoConfig.from_pretrained(model_path)
        hf = getattr(hf, "text_config", hf)
        rs = getattr(hf, "rope_scaling", None)
        rope_scaling = ((rs["factor"], rs["low_freq_factor"], rs["high_freq_factor"],
                         rs["original_max_position_embeddings"])
                        if isinstance(rs, dict) and rs.get("rope_type") == "llama3" else None)
        sd = AutoModelForCausalLM.from_pretrained(model_path).state_dict()
        return cls(_load_text_model(hf, sd, max_seq_len, rope_scaling, device), tokenizer,
                   max_new_tokens)

    def upsample(self, prompt: str, frames=None) -> str:
        from gen3c_tpu_torch.aux.guardrail import _head_and_tail
        from gen3c_tpu_torch.models.ar_transformer import generate_bucketed

        chat = [{"role": "system", "content": self.SYSTEM}, {"role": "user", "content": prompt}]
        ids = np.asarray(self.tokenizer.apply_chat_template(chat, return_tensors="np",
                                                            add_generation_prompt=True))
        ids = _head_and_tail(ids, self.model.cfg.max_seq_len - self.max_new_tokens)
        out = generate_bucketed(self.model, ids, max_new_tokens=self.max_new_tokens,
                                temperature=0.0, pad_id=int(self.tokenizer.eos_token_id or 0))
        new = out[0, out.shape[1] - self.max_new_tokens:].cpu().numpy()
        text = self.tokenizer.decode(new, skip_special_tokens=True).strip()
        return text or prompt


class VLMPromptUpsampler(PromptUpsampler):
    """The frame-conditioned (video2world) upsampler: the LAST frame resized
    (longest side <= image_max_size, sides multiples of the patch), encoded
    by the Pixtral tower and projector, its tokens in place of the [IMG]
    placeholder of the chat stream (prepended where the tokenizer has no
    such id), greedy generation from the spliced embeddings. Without
    frames the placeholder is dropped and the text alone generates."""

    INSTRUCTION = (
        "Your task is to transform a given prompt into a refined and "
        "concise video description, no more than 150 words. Focus only "
        "on the content, no filler words or descriptions on the style. "
        "Never mention things outside the video."
    )
    # HF Pixtral processor normalization (OpenAI-CLIP statistics)
    IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
    IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)

    def __init__(self, text_model, vision_model, tokenizer, image_token_id: int,
                 max_new_tokens: int = 400, image_max_size: int = 1024):
        self.text_model = text_model
        self.vision_model = vision_model
        self.tokenizer = tokenizer
        self.image_token_id = int(image_token_id)
        self.max_new_tokens = max_new_tokens
        self.image_max_size = image_max_size

    def _prepare_frame(self, frames) -> np.ndarray:
        """Last frame -> (3, H, W) normalized fp32, H and W multiples of the
        patch size, the longest side <= image_max_size; the bilinear resize
        is ``jax.image.resize``'s (``ops.resize``)."""
        from gen3c_tpu_torch.ops.resize import resize

        fr = np.asarray(frames)
        if fr.ndim == 4:  # (T, H, W, 3): condition on the LAST frame
            fr = fr[-1]
        if fr.dtype == np.uint8:
            fr = fr.astype(np.float32) / 255.0
        h, w = fr.shape[:2]
        ratio = max(h / self.image_max_size, w / self.image_max_size, 1.0)
        P = self.vision_model.cfg.patch_size
        nh = max(P, int(round(h / ratio / P)) * P)
        nw = max(P, int(round(w / ratio / P)) * P)
        if (nh, nw) != (h, w):
            fr = resize(torch.from_numpy(np.ascontiguousarray(fr)), (nh, nw, 3),
                        "bilinear").numpy()
        mean = np.asarray(self.IMAGE_MEAN, np.float32)
        std = np.asarray(self.IMAGE_STD, np.float32)
        fr = (fr - mean) / std
        return np.ascontiguousarray(fr.transpose(2, 0, 1))

    def _chat_ids(self, prompt: str) -> np.ndarray:
        user = "[IMG]\n" + self.INSTRUCTION + "\n" + prompt
        tok = self.tokenizer
        if getattr(tok, "chat_template", None):
            ids = tok.apply_chat_template([{"role": "user", "content": user}],
                                          return_tensors="np", add_generation_prompt=True)
            return np.asarray(ids).reshape(-1)
        return np.asarray(tok.encode(user), np.int32).reshape(-1)

    def _token_embeddings(self, ids: np.ndarray) -> torch.Tensor:
        """(L, dim) fp32 rows of the text model's token table (an int8 table
        dequantized)."""
        from gen3c_tpu_torch.models.quantize import QuantEmbedding

        table = self.text_model.tok_embeddings
        t = torch.from_numpy(ids.astype(np.int64)).to(self.text_model.device)
        if isinstance(table, QuantEmbedding):
            return table(t, torch.float32)
        return table.weight[t].float()

    @torch.no_grad()
    def upsample(self, prompt: str, frames=None) -> str:
        from gen3c_tpu_torch.aux.vision_encoder import vision_encode
        from gen3c_tpu_torch.models.ar_transformer import (
            generate_bucketed,
            generate_with_embeddings_bucketed,
        )

        ids = self._chat_ids(prompt)
        if frames is None:
            ids = ids[ids != self.image_token_id]
            out = generate_bucketed(self.text_model, ids[None], self.max_new_tokens,
                                    temperature=0.0,
                                    pad_id=int(getattr(self.tokenizer, "eos_token_id", 0) or 0))
            new = out[0, out.shape[1] - self.max_new_tokens:].cpu().numpy()
        else:
            frame = torch.from_numpy(self._prepare_frame(frames)).to(self.vision_model.device)
            img_emb = vision_encode(self.vision_model, frame)  # (Lv, D_text)
            tok_emb = self._token_embeddings(ids)
            where = np.nonzero(ids == self.image_token_id)[0]
            img_emb = img_emb.to(tok_emb)
            if where.size:
                pos = int(where[0])
                parts = [tok_emb[:pos], img_emb, tok_emb[pos + 1:]]
            else:
                # no placeholder id: PREPEND the image tokens, never drop a real token
                parts = [img_emb, tok_emb]
            spliced = torch.cat(parts, dim=0)[None]
            budget = self.text_model.cfg.max_seq_len - self.max_new_tokens
            if spliced.shape[1] > budget:
                raise ValueError(f"spliced prompt {spliced.shape[1]} tokens exceeds max_seq_len "
                                 f"budget {budget}; resize the image down")
            new = generate_with_embeddings_bucketed(self.text_model, spliced, self.max_new_tokens,
                                                    temperature=0.0)[0].cpu().numpy()
        eos = getattr(self.tokenizer, "eos_token_id", None)
        if eos is not None:
            stop = np.nonzero(new == eos)[0]
            if stop.size:
                new = new[: stop[0]]
        return self.tokenizer.decode(new.tolist(), skip_special_tokens=True).strip() or prompt

    @classmethod
    def from_pretrained(cls, model_path: str, max_new_tokens: int = 400,
                        device="cuda") -> "VLMPromptUpsampler":
        """An HF Llava-style Pixtral checkpoint: the language model through
        ``convert_hf_llama`` (max_seq_len 4,300, the reference's), the
        vision tower and projector through ``convert_hf_pixtral_vision``,
        both bf16. Raises ValueError where the text model's head width is
        not dim / heads (Pixtral-12B's is not)."""
        from transformers import AutoConfig, AutoModelForImageTextToText, AutoTokenizer

        from gen3c_tpu_torch.aux.vision_encoder import (
            VisionConfig,
            VisionEncoder,
            convert_hf_pixtral_vision,
        )

        tokenizer = AutoTokenizer.from_pretrained(model_path)
        hf = AutoConfig.from_pretrained(model_path)
        text_hf = getattr(hf, "text_config", hf)
        vis_hf = getattr(hf, "vision_config", None)
        if vis_hf is None:
            raise ValueError(f"{model_path} has no vision tower")
        sd = AutoModelForImageTextToText.from_pretrained(model_path).state_dict()
        text_sd = {}
        for k, v in sd.items():  # transformers' older and newer Llava names
            if k.startswith("language_model."):
                text_sd[k[len("language_model."):]] = v
            elif k.startswith("model.language_model."):
                text_sd["model." + k[len("model.language_model."):]] = v
            elif k == "lm_head.weight":
                text_sd[k] = v
        text_model = _load_text_model(text_hf, text_sd, 4300, None, device)
        vision_cfg = VisionConfig(
            hidden_size=vis_hf.hidden_size, num_layers=vis_hf.num_hidden_layers,
            num_heads=vis_hf.num_attention_heads, intermediate_size=vis_hf.intermediate_size,
            patch_size=vis_hf.patch_size, image_size=vis_hf.image_size,
            rope_theta=getattr(vis_hf, "rope_theta", 10000.0),
            text_hidden_size=text_hf.hidden_size, dtype=torch.bfloat16)
        vision = VisionEncoder(vision_cfg, device=device)
        vision.load_state_dict(convert_hf_pixtral_vision(sd, vision_cfg))
        return cls(text_model, vision, tokenizer,
                   image_token_id=getattr(hf, "image_token_index", 10),
                   max_new_tokens=max_new_tokens)


def create_prompt_upsampler(
    checkpoint_dir: Optional[str] = None, enabled: bool = False,
    backend: str = "torch", device="cuda",
) -> PromptUpsampler:
    """Passthrough when disabled; the template without
    <checkpoint_dir>/Pixtral-12B; with it, backend "torch" the port's VLM
    path and backend "hf" transformers' own model, both on ``device``. The
    port's loader raises where it cannot load the checkpoint (Pixtral-12B's
    own text model among them, see the module's docstring): no other
    backend or device takes its place."""
    if backend not in ("torch", "hf"):
        raise ValueError(f"unknown prompt upsampler backend {backend!r}: 'torch' or 'hf'")
    if not enabled:
        return PassthroughUpsampler()
    if checkpoint_dir:
        path = os.path.join(checkpoint_dir, "Pixtral-12B")
        if os.path.isdir(path):
            if backend == "hf":
                return HFPromptUpsampler(path, device=device)
            return VLMPromptUpsampler.from_pretrained(path, device=device)
    return TemplateUpsampler()
