"""Media IO for the CLI: video save, image and prompt reading.

The port's own copy of what it uses of gen3c_tpu/utils/io.py (the JAX
package stays the reference; the port imports nothing of it): ``save_video``
writes an mp4 through imageio's ffmpeg or, where that is unavailable (no
imageio, or no ffmpeg), the MJPEG AVI of ``utils.mjpeg_avi`` beside it, or
as a last resort PNG frames; ``read_image_bcthw`` and
``read_prompts_from_file`` read the CLI's inputs. The bytes written are
those of gen3c_tpu's functions on the same inputs.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np


def save_video(video: np.ndarray, fps: int, filepath: str, quality: int = 5) -> str:
    """Save (T, H, W, 3) uint8 frames as an mp4; returns the path written
    (an .avi beside it, or a PNG-frame directory, when ffmpeg is missing)."""
    os.makedirs(os.path.dirname(os.path.abspath(filepath)), exist_ok=True)
    try:
        import imageio

        imageio.mimsave(filepath, video, "FFMPEG", fps=fps, quality=quality,
                        macro_block_size=1,
                        ffmpeg_params=["-s", f"{video.shape[2]}x{video.shape[1]}"],
                        output_params=["-f", "mp4"])
        return filepath
    except Exception:  # noqa: BLE001 - no imageio or no ffmpeg: the AVI below
        pass
    try:
        from gen3c_tpu_torch.utils.mjpeg_avi import write_mjpeg_avi

        avi_path = os.path.splitext(filepath)[0] + ".avi"
        # imageio-ffmpeg quality 0-10 -> JPEG quality
        write_mjpeg_avi(avi_path, video, fps=fps, quality=min(95, 50 + 5 * quality))
        return avi_path
    except Exception:  # noqa: BLE001 - last resort: per-frame PNGs
        from PIL import Image

        base = os.path.splitext(filepath)[0]
        os.makedirs(base, exist_ok=True)
        for i, frame in enumerate(video):
            Image.fromarray(frame).save(os.path.join(base, f"{i:05d}.png"))
        with open(os.path.join(base, "fps.txt"), "w") as f:
            f.write(str(fps))
        return base


def read_prompts_from_file(prompt_file: str) -> List[dict]:
    """One JSON dict per non-empty line, with key "prompt"."""
    with open(prompt_file, "r") as f:
        return [json.loads(line) for line in (raw.strip() for raw in f) if line]


def read_image_bcthw(path: str, h: Optional[int] = None, w: Optional[int] = None) -> np.ndarray:
    """An image as float32 (1, 3, 1, H, W) in [-1, 1]; RGBA is composited
    over white, and the image is resized (bicubic) to (h, w) if given."""
    from PIL import Image

    img = Image.open(path)
    if img.mode == "RGBA":
        img = Image.alpha_composite(Image.new("RGBA", img.size, (255, 255, 255, 255)), img)
    img = img.convert("RGB")
    if h is not None and w is not None and img.size != (w, h):
        img = img.resize((w, h), Image.BICUBIC)
    arr = np.asarray(img).astype(np.float32) / 127.5 - 1.0
    return arr.transpose(2, 0, 1)[None, :, None]
