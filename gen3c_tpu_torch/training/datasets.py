"""Training data: GEN3C RGBD clips -> diffusion training batches (port of
gen3c_tpu/training/datasets.py :27-142 and its ``PrefetchIterator``).

A packaged clip (``pipelines.data_loaders``) becomes one batch in the
train_step format, on the model's device:

  x0             (B, 16, T', H', W')   clean video latent (sigma_data-scaled)
  crossattn_emb  (B, 512, 1024)        T5 embedding (or zeros)
  extra_channels (B, 65, T', H', W')   [condition mask | pose latents]

The clip's first frame seeds a ``Cache3DBuffer``, the clip's own cameras
render the warp buffers (K5), and the VAE encodes the clip and the buffers.

``VideoClipDataset`` (text/video-to-world: mp4 or npz videos, no cache;
zero or one condition-mask channel) and ``MultiviewClipDataset`` (V views
of a clip, their latents stacked on latent T) port gen3c_tpu's :145-283.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, List, Optional

import numpy as np
import torch

from gen3c_tpu_torch.utils import log


def _to_signed_range(video: np.ndarray, path: str) -> np.ndarray:
    """Pixels to [-1, 1]: [0, 255] is scaled, [0, 1] shifted (with a
    warning: a half-range feed to the VAE would corrupt training), signed
    data passes through."""
    if video.max() > 1.5:
        return video / 127.5 - 1.0
    if video.min() >= 0.0 and video.max() <= 1.0:
        log.warning(f"{path}: frames look [0, 1]-normalized; mapping to [-1, 1]")
        return video * 2.0 - 1.0
    return video


@torch.no_grad()
def build_gen3c_train_batch(
    model,
    image: np.ndarray,  # (F, 3, H, W) in [-1, 1]
    depth: np.ndarray,  # (F, 1, H, W)
    w2c: np.ndarray,  # (F, 4, 4)
    intrinsics: np.ndarray,  # (F, 3, 3)
    t5_embedding: Optional[np.ndarray] = None,  # (512, 1024)
    mask: Optional[np.ndarray] = None,
    num_condition_t: int = 1,
    seed: int = 0,
) -> dict:
    """One training sample from an RGBD clip of ``model.chunk_size`` frames
    (a models.gen3c.Gen3CModel: only its VAE is used): the first frame
    seeds the cache, the clip's cameras render the warps, everything is
    VAE-encoded. Tensors on the model's device, fp32, batch 1."""
    from gen3c_tpu_torch.cache.cache3d import Cache3DBuffer

    F = image.shape[0]
    if F != model.chunk_size:
        raise ValueError(f"a clip of {F} frames; the model takes {model.chunk_size}")
    dev = model.device
    cache = Cache3DBuffer(
        frame_buffer_max=model.frame_buffer_max, seed=seed,
        input_image=torch.from_numpy(image[:1]), input_depth=torch.from_numpy(depth[:1]),
        input_mask=torch.from_numpy(mask[:1]) if mask is not None else None,
        input_w2c=torch.from_numpy(w2c[:1]), input_intrinsics=torch.from_numpy(intrinsics[:1]),
        device=dev)
    warp_images, warp_masks = cache.render_cache(torch.from_numpy(w2c[None]),
                                                 torch.from_numpy(intrinsics[None]))
    video = torch.from_numpy(np.ascontiguousarray(image.transpose(1, 0, 2, 3)[None])).to(dev)
    x0 = model.encode(video)
    del video
    pose_latent = model.encode_warped_frames(warp_images, warp_masks)
    _, _, T, Hl, Wl = x0.shape
    indicator = torch.zeros((1, 1, T, 1, 1), dtype=x0.dtype, device=dev)
    indicator[:, :, :num_condition_t] = 1.0
    extra = torch.cat([indicator.expand(1, 1, T, Hl, Wl), pose_latent.to(x0.dtype)], dim=1)
    if t5_embedding is None:
        t5_embedding = np.zeros((512, 1024), np.float32)
    return {"x0": x0.float(),
            "crossattn_emb": torch.from_numpy(np.asarray(t5_embedding, np.float32)[None]).to(dev),
            "extra_channels": extra.float()}


class Gen3CClipDataset:
    """Training batches over a directory of packaged clips, for ever.

    Layout: <root>/*.npz or *.pt (``data_loaders.load_data_packaged_format``),
    each with an optional sibling <clip>.t5.npy embedding (the precompute
    pattern of scripts/get_t5_embeddings.py). Each sample is a random clip
    and a random window of ``model.chunk_size`` frames in it, from a numpy
    RandomState(seed), as gen3c_tpu draws them."""

    def __init__(self, root: str, model, batch_size: int = 1, seed: int = 0):
        self.root = root
        self.model = model
        self.batch_size = batch_size
        self.clips: List[str] = sorted(os.path.join(root, f) for f in os.listdir(root)
                                       if f.endswith((".npz", ".pt")))
        if not self.clips:
            raise FileNotFoundError(f"no clips (*.npz, *.pt) under {root}")
        self.rng = np.random.RandomState(seed)
        log.info(f"Gen3CClipDataset: {len(self.clips)} clips in {root}")

    def _load_sample(self, path: str) -> dict:
        from gen3c_tpu_torch.pipelines.data_loaders import load_data_packaged_format

        image, depth, mask, w2c, k = load_data_packaged_format(path)
        t5_path = os.path.splitext(path)[0] + ".t5.npy"
        t5 = np.load(t5_path) if os.path.exists(t5_path) else None
        chunk = self.model.chunk_size
        if image.shape[0] < chunk:
            raise ValueError(f"{path}: {image.shape[0]} frames, fewer than the chunk's {chunk}")
        start = self.rng.randint(0, image.shape[0] - chunk + 1)
        sl = slice(start, start + chunk)
        return build_gen3c_train_batch(
            self.model, image[sl], depth[sl], w2c[sl], k[sl], t5_embedding=t5,
            mask=mask[sl] if mask is not None else None,
            seed=int(self.rng.randint(0, 2 ** 31)))

    def __iter__(self) -> Iterator[dict]:
        return _batches(self._load_sample, self.clips, self.rng, self.batch_size)


def _t5_or_zeros(path: str) -> np.ndarray:
    """The clip's sibling <clip>.t5.npy embedding, else zeros (512, 1024)."""
    t5_path = os.path.splitext(path)[0] + ".t5.npy"
    return np.load(t5_path) if os.path.exists(t5_path) else np.zeros((512, 1024), np.float32)


def _batches(sample, clips: List[str], rng: np.random.RandomState, batch_size: int
             ) -> Iterator[dict]:
    """Batches of ``batch_size`` samples of random clips, for ever."""
    while True:
        picks = rng.choice(len(clips), batch_size)
        samples = [sample(clips[i]) for i in picks]
        yield {k: torch.cat([s[k] for s in samples], dim=0) for k in samples[0]}


class VideoClipDataset:
    """Text/video-to-world training clips (gen3c_tpu's ``VideoClipDataset``).

    Layout: <root>/*.mp4 or *.npz ("video": (F, 3, H, W) or (F, H, W, 3))
    with an optional sibling <clip>.t5.npy. num_condition_t = 0 gives t2w
    batches (no condition channels), > 0 v2w batches (one condition-mask
    channel over the first num_condition_t latent frames). A sample is a
    random clip and a random window of ``model.chunk_size`` frames, from a
    numpy RandomState(seed), as gen3c_tpu draws them."""

    def __init__(self, root: str, model, batch_size: int = 1, seed: int = 0,
                 num_condition_t: int = 0):
        self.root = root
        self.model = model
        self.batch_size = batch_size
        self.num_condition_t = num_condition_t
        self.clips: List[str] = sorted(os.path.join(root, f) for f in os.listdir(root)
                                       if f.endswith((".mp4", ".npz")))
        if not self.clips:
            raise FileNotFoundError(f"no clips (*.mp4, *.npz) under {root}")
        self.rng = np.random.RandomState(seed)
        log.info(f"VideoClipDataset: {len(self.clips)} clips in {root}")

    def _load_video(self, path: str) -> np.ndarray:
        """(F, 3, H, W) in [-1, 1]."""
        if path.endswith(".npz"):
            video = np.load(path)["video"].astype(np.float32)
            if video.shape[-1] == 3:
                video = video.transpose(0, 3, 1, 2)
            return _to_signed_range(video, path)
        from gen3c_tpu_torch.utils.io import read_video_bcthw

        video, _ = read_video_bcthw(path)
        return video[0].transpose(1, 0, 2, 3)

    @torch.no_grad()
    def _sample(self, path: str) -> dict:
        video = self._load_video(path)
        chunk = self.model.chunk_size
        if video.shape[0] < chunk:
            raise ValueError(f"{path}: {video.shape[0]} frames, fewer than the chunk's {chunk}")
        start = self.rng.randint(0, video.shape[0] - chunk + 1)
        clip = np.ascontiguousarray(video[start:start + chunk].transpose(1, 0, 2, 3)[None])
        x0 = self.model.encode(torch.from_numpy(clip).to(self.model.device)).float()
        _, _, T, Hl, Wl = x0.shape
        extra = torch.zeros((1, 1 if self.num_condition_t > 0 else 0, T, Hl, Wl),
                            dtype=torch.float32, device=x0.device)
        extra[:, :, :self.num_condition_t] = 1.0
        return {"x0": x0,
                "crossattn_emb": torch.from_numpy(
                    np.asarray(_t5_or_zeros(path), np.float32)[None]).to(x0.device),
                "extra_channels": extra}

    def __iter__(self) -> Iterator[dict]:
        return _batches(self._sample, self.clips, self.rng, self.batch_size)


class MultiviewClipDataset:
    """Multiview training clips (gen3c_tpu's ``MultiviewClipDataset``): V
    synchronized views of a clip, each encoded on its own, their latents
    stacked on latent T ((B, 16, V*T', H', W'), the multiview DiT's
    layout), with no condition channels.

    Layout: <root>/*.npz with "videos" (V, F, 3, H, W) or (V, F, H, W, 3)
    and an optional sibling .t5.npy, the views' embeddings concatenated.
    Without one the context is zeros (1, 512, 1024), as gen3c_tpu yields
    it: not V x 512 tokens, so the multiview forward refuses it at any V
    that does not divide 512 (gen3c_tpu fails there too)."""

    def __init__(self, root: str, model, n_views: int, batch_size: int = 1, seed: int = 0):
        self.root = root
        self.model = model
        self.n_views = n_views
        self.batch_size = batch_size
        self.clips: List[str] = sorted(os.path.join(root, f) for f in os.listdir(root)
                                       if f.endswith(".npz"))
        if not self.clips:
            raise FileNotFoundError(f"no clips (*.npz) under {root}")
        self.rng = np.random.RandomState(seed)
        log.info(f"MultiviewClipDataset: {len(self.clips)} clips in {root}")

    @torch.no_grad()
    def _sample(self, path: str) -> dict:
        videos = np.load(path)["videos"].astype(np.float32)
        if videos.shape[-1] == 3:
            videos = videos.transpose(0, 1, 4, 2, 3)
        videos = _to_signed_range(videos, path)
        V, chunk = self.n_views, self.model.chunk_size
        if videos.shape[0] < V or videos.shape[1] < chunk:
            raise ValueError(f"{path}: videos {videos.shape[:2]}, need {V} views of {chunk} "
                             f"frames")
        start = self.rng.randint(0, videos.shape[1] - chunk + 1)
        dev = self.model.device
        x0 = torch.cat([self.model.encode(torch.from_numpy(np.ascontiguousarray(
            videos[v, start:start + chunk].transpose(1, 0, 2, 3)[None])).to(dev))
            for v in range(V)], dim=2).float()
        _, _, T, Hl, Wl = x0.shape
        return {"x0": x0,
                "crossattn_emb": torch.from_numpy(
                    np.asarray(_t5_or_zeros(path), np.float32)[None]).to(dev),
                "extra_channels": torch.zeros((1, 0, T, Hl, Wl), dtype=torch.float32,
                                              device=dev)}

    def __iter__(self) -> Iterator[dict]:
        return _batches(self._sample, self.clips, self.rng, self.batch_size)


class PrefetchIterator:
    """Background-thread batch prefetcher: the wrapped iterator runs in a
    worker thread while the training step executes, behind a bounded queue
    (double buffering by default). Exceptions reach the consumer. close()
    stops the worker and waits for the batch it is building (the Trainer
    calls it when training ends: a worker left inside a torch op when the
    interpreter exits aborts the process); garbage collection stops it
    without waiting."""

    _SENTINEL = object()

    def __init__(self, iterable, prefetch: int = 2):
        self._q = queue.Queue(maxsize=max(1, prefetch))
        self._err = None
        self._stop = threading.Event()

        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for item in iterable:
                    if not put(item):
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised in __next__
                self._err = e
            finally:
                put(self._SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self, wait: bool = True):
        self._stop.set()
        if wait and self._thread is not threading.current_thread():
            self._thread.join()

    def __del__(self):
        self.close(wait=False)
