"""The multiview (view-consistent) GeneralDIT of the Sample-AV Cosmos models.

Port of gen3c_tpu/models/dit_multiview.py: one diffusion pass over V
synchronized camera views stacked on the latent-T axis.

  * a learnable per-view embedding (``view_condition_dim`` channels), plus
    the optional per-view "repeat frame" scalar embedding, is broadcast
    over (T, H, W) and concatenated after the padding mask, before the
    patch embedding: the channel order is [x | padding_mask | view_emb];
  * RoPE and the per-block absolute position embedding (the sincos
    variant, built in float64 numpy) are made for one view (each view
    restarts its temporal index) and tiled over the views; the learnable
    extra position embedding of the single-stream net has no place here;
  * self-attention (K1) runs over all V*T*H*W tokens, cross-attention (K2)
    with the views folded into the batch, each view against its own slice
    of the context (``VideoAttn(n_views=)``);
  * the timestep embedding has no augment-sigma term.

The blocks, patch embedding, timestep MLP and final layer are
``GeneralDIT``'s, under the reference's parameter names, so a converted
Sample-AV state dict (``models.convert.convert_multiview_dit_state_dict``
for gen3c_tpu's tree, ``dit_state_for_net`` for the port's net) loads.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from gen3c_tpu_torch.models.dit import DiTConfig, GeneralDIT


@dataclasses.dataclass(frozen=True)
class MultiviewDiTConfig(DiTConfig):
    n_views: int = 6
    view_condition_dim: int = 6
    concat_view_embedding: bool = True
    add_repeat_frame_embedding: bool = False
    # the per-block sincos position embedding's extrapolation ratios
    extra_h_extrapolation_ratio: float = 1.0
    extra_w_extrapolation_ratio: float = 1.0
    extra_t_extrapolation_ratio: float = 1.0

    @property
    def patch_in_dim(self) -> int:
        c = self.in_channels + (1 if self.concat_padding_mask else 0)
        if self.concat_view_embedding:
            c += self.view_condition_dim
        return c * self.patch_spatial * self.patch_spatial * self.patch_temporal


# the Sample-AV 7B: the GEN3C 7B's trunk with 6 views and the repeat-frame embedding
FADITV2_MULTIVIEW_7B = MultiviewDiTConfig(n_views=6, view_condition_dim=6,
                                          add_repeat_frame_embedding=True)


def _sincos_axis_emb(n: int, d: int, extrapolation: float = 1.0) -> np.ndarray:
    """A 1-D sincos table (n, d), float64: [sin | cos] halves, positions
    divided by the extrapolation ratio."""
    omega = np.arange(d // 2, dtype=np.float64) / (d / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.outer(np.arange(n, dtype=np.float64) / extrapolation, omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def _multiview_sincos_extra(D: int, Tp: int, Hp: int, Wp: int, rt: float = 1.0,
                            rh: float = 1.0, rw: float = 1.0) -> np.ndarray:
    """One view's extra position embedding (Tp*Hp*Wp, D), float64: the
    per-axis sincos tables concatenated [t | h | w] over channels split
    D - 2*(D//6*2) / D//6*2 / D//6*2 and broadcast over the grid."""
    dim_h = D // 6 * 2
    dim_w = dim_h
    dim_t = D - 2 * dim_h
    emb_t = _sincos_axis_emb(Tp, dim_t, rt)
    emb_h = _sincos_axis_emb(Hp, dim_h, rh)
    emb_w = _sincos_axis_emb(Wp, dim_w, rw)
    out = np.concatenate([
        np.broadcast_to(emb_t[:, None, None, :], (Tp, Hp, Wp, dim_t)),
        np.broadcast_to(emb_h[None, :, None, :], (Tp, Hp, Wp, dim_h)),
        np.broadcast_to(emb_w[None, None, :, :], (Tp, Hp, Wp, dim_w)),
    ], axis=-1)
    return out.reshape(Tp * Hp * Wp, D)


class MultiviewGeneralDIT(GeneralDIT):
    """The denoiser: (B, C, V*T, H, W) latent (views on the frame axis) +
    timesteps + (B, V*M, 1024) per-view text -> (B, 16, V*T, H, W)."""

    def __init__(self, cfg: MultiviewDiTConfig, device=None):
        super().__init__(cfg, device)
        del self.extra_pos_embedder  # the sincos table takes its place
        dt = cfg.dtype
        vc = cfg.view_condition_dim
        self.view_embeddings = nn.Embedding(cfg.n_views, vc, device=device, dtype=dt)
        if cfg.add_repeat_frame_embedding:
            self.repeat_frame_embedding = nn.Linear(1, vc, device=device, dtype=dt)
        self.requires_grad_(False)
        self._tables = {}

    def position_tables(self, Tp: int, Hp: int, Wp: int, fps: Optional[float], device):
        """(rope, extra) of all V views: one view's RoPE (cos, sin) tiled V
        times, and the sincos extra embedding (1, V*Tp*Hp*Wp, D) in the
        model dtype (float64 numpy, then fp32, tiled, then the dtype);
        cached per shape, fps and device."""
        key = (Tp, Hp, Wp, fps, str(device))
        if key not in self._tables:
            cfg = self.cfg
            V = cfg.n_views
            cos1, sin1 = self.rope(Tp, Hp, Wp, fps, device)
            one = _multiview_sincos_extra(cfg.model_channels, Tp, Hp, Wp,
                                          cfg.extra_t_extrapolation_ratio,
                                          cfg.extra_h_extrapolation_ratio,
                                          cfg.extra_w_extrapolation_ratio)
            extra = torch.from_numpy(one.astype(np.float32)).repeat(V, 1)[None]
            self._tables = {key: ((cos1.repeat(V, 1), sin1.repeat(V, 1)),
                                  extra.to(device=device, dtype=cfg.dtype))}
        return self._tables[key]

    def view_channels(self, B: int, T: int, H: int, W: int,
                      frame_repeat: Optional[torch.Tensor], device) -> torch.Tensor:
        """(B, vc, V*T, H, W) view-condition channels in the model dtype: the
        view embedding plus, with the repeat-frame embedding, frame_repeat
        (B, V) (zeros if None) through its Linear(1, vc)."""
        cfg = self.cfg
        dtype = cfg.dtype
        V = cfg.n_views
        view_emb = self.view_embeddings.weight.to(dtype)
        if cfg.add_repeat_frame_embedding:
            fr = (torch.zeros((B, V), dtype=dtype, device=device) if frame_repeat is None
                  else frame_repeat.to(device=device, dtype=dtype))
            lin = self.repeat_frame_embedding
            rep = fr[..., None] @ lin.weight.to(dtype).T + lin.bias.to(dtype)  # (B, V, vc)
            view_cond = view_emb[None] + rep
        else:
            view_cond = view_emb[None].expand(B, V, view_emb.shape[1])
        view_ch = view_cond.repeat_interleave(T, dim=1)  # (B, V*T, vc)
        return view_ch.transpose(1, 2)[..., None, None].expand(B, view_cond.shape[2], V * T, H, W)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, crossattn_emb: torch.Tensor,
                fps: Optional[float] = None, padding_mask: Optional[torch.Tensor] = None,
                frame_repeat: Optional[torch.Tensor] = None, remat: bool = False,
                tp=None):
        """x (B, C, V*T, H, W); crossattn_emb (B, V*M, D_ctx), each view's
        prompt in turn; frame_repeat (B, V). remat=True recomputes each
        block in the backward (per block; gen3c_tpu remats the whole
        multiview net, the same arithmetic). tp: the tensor-parallel axis
        of a net ``parallel.sharding.shard_params`` sliced, run through
        GeneralDIT's blocks (no sequence parallelism: gen3c_tpu's multiview
        forward has no hook for it, train_step.py:287-291)."""
        cfg = self.cfg
        dtype = cfg.dtype
        V = cfg.n_views
        B, _, VT, H, W = x.shape
        T = VT // V
        view_ch = (self.view_channels(B, T, H, W, frame_repeat, x.device)
                   if cfg.concat_view_embedding else None)
        tokens = self.patchify(x.to(dtype), padding_mask, view_ch)
        _, Tp_all, Hp, Wp, D = tokens.shape
        Tp = Tp_all // V
        tokens = tokens.reshape(B, Tp_all * Hp * Wp, D)
        rope, extra = self.position_tables(Tp, Hp, Wp, fps, x.device)
        emb, lora = self.time_embedding(timesteps)
        ctx = crossattn_emb.to(dtype)
        if ctx.shape[1] % V:
            raise ValueError(
                f"multiview context of {ctx.shape[1]} tokens does not split into {V} views' "
                f"prompts (B, V*M, D_ctx): it cannot fold into the batch for cross-attention")
        for blk in self.blocks.values():
            if remat and torch.is_grad_enabled():
                tokens = checkpoint(blk, tokens, emb, lora, extra, ctx, rope, n_views=V, tp=tp,
                                    use_reentrant=False)
            else:
                tokens = blk(tokens, emb, lora, extra, ctx, rope, n_views=V, tp=tp)
        return self.unpatchify(self.final(tokens, emb, lora).reshape(B, Tp_all, Hp, Wp, -1),
                               VT, H, W)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> "MultiviewGeneralDIT":
        """GeneralDIT's init for the shared trunk, then the view embedding
        from 0.02 * N(0, 1) and a zero repeat-frame Linear (gen3c_tpu's
        ``init_multiview_dit_params``), all from ``generator``."""
        super().init_random(generator)
        w = self.view_embeddings.weight
        w.copy_(0.02 * torch.randn(w.shape, generator=generator, device=w.device))
        if self.cfg.add_repeat_frame_embedding:
            self.repeat_frame_embedding.weight.zero_()
            self.repeat_frame_embedding.bias.zero_()
        return self

