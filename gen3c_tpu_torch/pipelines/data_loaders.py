"""Input loaders for dynamic-scene and multiview generation and for training
clips (port of gen3c_tpu/pipelines/data_loaders.py).

  * packaged single file: an ``.npz`` with the arrays "image" (F, 3, H, W)
    in [-1, 1], "depth" (F, 1, H, W), optionally "mask" (F, 1, H, W), "w2c"
    (F, 4, 4) and "intrinsics" (F, 3, 3); or the reference's ``.pt``, a
    tuple of those five tensors (the mask may be None);
  * distributed directory: rgb.mp4 + depth.npz + mask.npz + camera.npz;
  * ViPE output: rgb mp4, depth EXR zip, pose and intrinsics npz, resized
    (720, 1280) and centre-cropped to (704, 1280) with the intrinsics moved
    to match;
  * multiview npz: posed RGBD key frames and the full target trajectory.

Every clip loader returns float32 numpy (image (F, 3, H, W) in [-1, 1],
depth (F, 1, H, W), mask (F, 1, H, W) or None, w2c (F, 4, 4), intrinsics
(F, 3, 3)). Reading an mp4 needs ``imageio`` and the ViPE resize needs
``PIL``; both are imported only when such a file is read.
"""

from __future__ import annotations

import io
import zipfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

Clip = Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], np.ndarray, np.ndarray]


def adjust_intrinsics_for_resize_and_crop(
    k: np.ndarray,
    src_hw: Tuple[int, int],
    resize_hw: Tuple[int, int],
    crop_hw: Tuple[int, int],
) -> np.ndarray:
    """Scale fx, fy, cx, cy for a resize, then shift the principal point for
    a centre crop."""
    src_h, src_w = src_hw
    rh, rw = resize_hw
    ch, cw = crop_hw
    out = k.copy()
    sx, sy = rw / float(src_w), rh / float(src_h)
    out[0, 0] *= sx
    out[1, 1] *= sy
    out[0, 2] *= sx
    out[1, 2] *= sy
    out[0, 2] -= max((rw - cw) // 2, 0)
    out[1, 2] -= max((rh - ch) // 2, 0)
    return out


def _read_video_frames(path: str) -> np.ndarray:
    """(T, H, W, 3) uint8."""
    import imageio

    reader = imageio.get_reader(path)
    frames = [np.asarray(f)[..., :3] for f in reader]
    reader.close()
    return np.stack(frames)


def load_data_distributed_format(data_dir: str) -> Clip:
    """rgb.mp4 + depth.npz["depth"] + mask.npz["mask"] + camera.npz {"w2c",
    "intrinsics"}."""
    p = Path(data_dir)
    frames = _read_video_frames(str(p / "rgb.mp4"))
    image = frames.astype(np.float32).transpose(0, 3, 1, 2) / 127.5 - 1.0
    depth = np.load(p / "depth.npz")["depth"].astype(np.float32)[:, None]
    mask = np.load(p / "mask.npz")["mask"].astype(np.float32)[:, None]
    cam = np.load(p / "camera.npz")
    return image, depth, mask, cam["w2c"].astype(np.float32), cam["intrinsics"].astype(np.float32)


def load_data_packaged_format(path: str) -> Clip:
    """(image, depth, mask or None, w2c, intrinsics) of a packaged clip."""
    if path.endswith(".npz"):
        d = np.load(path)
        return (d["image"].astype(np.float32), d["depth"].astype(np.float32),
                d["mask"].astype(np.float32) if "mask" in d else None,
                d["w2c"].astype(np.float32), d["intrinsics"].astype(np.float32))
    import torch

    data = torch.load(path, map_location="cpu", weights_only=False)
    if len(data) != 5:
        raise ValueError(f"Expected 5 tensors in pt file, got {len(data)}")
    return tuple(None if t is None else np.asarray(t, dtype=np.float32) for t in data)


def load_data_auto_detect(input_path: str) -> Clip:
    """A packaged ``.pt``/``.npz`` file or a distributed directory."""
    p = Path(input_path)
    if p.is_file() and p.suffix in (".pt", ".npz"):
        return load_data_packaged_format(str(p))
    if p.is_dir():
        return load_data_distributed_format(str(p))
    raise ValueError(f"Invalid input path: {input_path}")


def _read_depth_from_zip(zip_path: str, frame_idx: int) -> np.ndarray:
    """Frame ``frame_idx`` (in name order) of a ViPE depth zip: an ``.exr``
    (read by ``utils/exr.py``) or an ``.npy`` entry."""
    with zipfile.ZipFile(zip_path) as zf:
        name = sorted(zf.namelist())[frame_idx]
        data = zf.read(name)
    if name.endswith(".npy"):
        return np.load(io.BytesIO(data)).astype(np.float32)
    if name.endswith(".exr"):
        from gen3c_tpu_torch.utils.exr import read_exr_depth

        return read_exr_depth(data)
    raise ValueError(f"Unsupported depth entry {name}")


def _load_indexed_npz(path: str, frame_idx: int) -> np.ndarray:
    """The row of a ViPE pose/intrinsics npz ("inds" + "data") for a frame."""
    d = np.load(path)
    inds, arr = d["inds"], d["data"]
    pos = int(np.searchsorted(inds, frame_idx))
    if not (0 <= pos < len(inds)) or int(inds[pos]) != int(frame_idx):
        raise FileNotFoundError(f"Frame {frame_idx} not found in {path}")
    return arr[pos]


def _resize_center_crop(img: np.ndarray, resize_hw, crop_hw) -> np.ndarray:
    """(H, W, C) or (H, W) -> bilinear resize (PIL), then centre crop."""
    from PIL import Image

    rh, rw = resize_hw
    ch, cw = crop_hw
    pil = Image.fromarray(img if img.dtype == np.uint8 else img.astype(np.float32))
    resized = np.asarray(pil.resize((rw, rh), Image.BILINEAR))
    oy, ox = max((rh - ch) // 2, 0), max((rw - cw) // 2, 0)
    return resized[oy:oy + ch, ox:ox + cw]


def load_vipe_data(
    vipe_root_or_mp4: str,
    starting_frame_idx: int = 0,
    resize_hw: Tuple[int, int] = (720, 1280),
    crop_hw: Tuple[int, int] = (704, 1280),
    num_frames: int = 121,
) -> Clip:
    """A ViPE clip: <root>/rgb/<clip>.mp4, <root>/depth/<clip>.zip,
    <root>/pose/<clip>.npz (camera-to-world), <root>/intrinsics/<clip>.npz
    (fx, fy, cx, cy). ``num_frames`` from ``starting_frame_idx``, the last
    frame repeated past the end; the mask is all ones."""
    root = Path(vipe_root_or_mp4)
    if root.suffix == ".mp4":
        clip = root.stem
        root = root.parent.parent
    else:
        clips = sorted(p.stem for p in (root / "rgb").glob("*.mp4"))
        if not clips:
            raise FileNotFoundError(f"no mp4 clips under {root / 'rgb'}")
        clip = clips[0]
    frames = _read_video_frames(str(root / "rgb" / f"{clip}.mp4"))
    total = len(frames)
    start = min(starting_frame_idx, max(0, total - 1))
    idxs = list(range(start, min(start + num_frames, total)))
    idxs += [total - 1] * (num_frames - len(idxs))
    src_hw = frames.shape[1:3]

    images, depths, w2cs, ks = [], [], [], []
    for fi in idxs:
        images.append(_resize_center_crop(frames[fi], resize_hw, crop_hw).astype(np.float32)
                      / 127.5 - 1.0)
        d = _read_depth_from_zip(str(root / "depth" / f"{clip}.zip"), fi)
        depths.append(_resize_center_crop(d, resize_hw, crop_hw))
        c2w = _load_indexed_npz(str(root / "pose" / f"{clip}.npz"), fi)
        if c2w.shape == (16,):
            c2w = c2w.reshape(4, 4)
        w2cs.append(np.linalg.inv(c2w).astype(np.float32))
        fx, fy, cx, cy = _load_indexed_npz(str(root / "intrinsics" / f"{clip}.npz"), fi)[:4]
        k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
        ks.append(adjust_intrinsics_for_resize_and_crop(k, src_hw, resize_hw, crop_hw))
    image = np.stack(images).transpose(0, 3, 1, 2)
    depth = np.stack(depths)[:, None]
    return image, depth, np.ones_like(depth), np.stack(w2cs), np.stack(ks)


def load_multiview_npz(path: str) -> dict:
    """Multiview key frames: {"images", "depths", "masks" (or None), "ks",
    "w2cs"} of the key frames and the target trajectory {"w2cs_all",
    "ks_all"}, from the keys images_key_frames, depth_key_frames,
    mask_key_frames, K_key_frames, w2cs_key_frames, w2cs_all and Ks_all."""
    d = np.load(path)
    return {
        "images": d["images_key_frames"].astype(np.float32),
        "depths": d["depth_key_frames"].astype(np.float32),
        "masks": d["mask_key_frames"].astype(np.float32) if "mask_key_frames" in d else None,
        "ks": d["K_key_frames"].astype(np.float32),
        "w2cs": d["w2cs_key_frames"].astype(np.float32),
        "w2cs_all": d["w2cs_all"].astype(np.float32),
        "ks_all": d["Ks_all"].astype(np.float32),
    }
