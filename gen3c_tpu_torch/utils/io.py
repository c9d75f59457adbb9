"""Media IO for the CLI: video save, image and prompt reading.

The port's own copy of what it uses of gen3c_tpu/utils/io.py (the JAX
package stays the reference; the port imports nothing of it): ``save_video``
writes an mp4 through imageio's ffmpeg or, where that is unavailable (no
imageio, or no ffmpeg), the MJPEG AVI of ``utils.mjpeg_avi`` beside it, or
as a last resort PNG frames; ``IncrementalVideoSaver`` writes the same
file from JPEGs encoded chunk by chunk while later chunks denoise;
``read_image_bcthw``, ``read_video_bcthw`` and ``read_prompts_from_file``
read the inputs of the CLIs and the serving client.
The bytes written are those of gen3c_tpu's functions on the same inputs.
"""

from __future__ import annotations

import json
import os
import threading
import zlib
from typing import List, Optional, Tuple

import numpy as np

from gen3c_tpu_torch.utils import log


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


class IncrementalVideoSaver:
    """``save_video``'s MJPEG AVI, its frames JPEG-encoded as the AR loop
    finishes each chunk, so that only the last chunk's encode is left after
    generation.

    The CLIs pass each finished chunk's video to ``update`` (through
    ``run_chunked_generation(on_chunk=...)``): one worker thread, each
    update's thread joining the one before, encodes the frames beyond the
    last update while the next chunk denoises. ``save`` assembles the file
    from the encoded frames, checking each output frame against its cache
    key (shape and two checksums, ``_frame_key``) and encoding again any
    frame that differs (a trimmed or composed video). The file is the one
    ``save_video`` writes, byte for byte. Where ffmpeg is available (an mp4
    is written), or with ``GEN3C_INCREMENTAL_SAVE=0``, ``update`` does
    nothing and ``save`` is ``save_video``; so too, inside ``save``, after
    an encode or assembly error: the output-format fallback of
    ``save_video`` itself.
    """

    def __init__(self, fps: int, quality: int = 5):
        self.fps = fps
        self.jpeg_quality = min(95, 50 + 5 * quality)  # save_video's mapping
        self.quality = quality
        self._cache: List[tuple] = []  # (frame key, JPEG bytes), in frame order
        self._scheduled = 0
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._enabled = (os.environ.get("GEN3C_INCREMENTAL_SAVE", "1") != "0"
                         and not _ffmpeg_available())

    def update(self, video_so_far: np.ndarray) -> None:
        """Start encoding the frames beyond the last update's; returns at
        once."""
        if not self._enabled or self._error is not None:
            return
        frames = np.asarray(video_so_far)[self._scheduled:]
        if frames.size == 0:
            return
        self._scheduled += len(frames)
        prev = self._thread

        def work():
            if prev is not None:
                prev.join()
            try:
                from gen3c_tpu_torch.utils.mjpeg_avi import encode_jpeg_frame

                for fr in frames:
                    fr = np.ascontiguousarray(fr)
                    self._cache.append((_frame_key(fr), encode_jpeg_frame(fr, self.jpeg_quality)))
            except BaseException as e:  # noqa: BLE001 - save() writes through save_video
                self._error = e

        self._thread = threading.Thread(target=work, name="gen3c-jpeg-encode", daemon=True)
        self._thread.start()

    def save(self, video: np.ndarray, filepath: str) -> str:
        """``save_video(video, fps, filepath, quality)``'s file and return
        value, reusing each encoded frame whose bytes still match."""
        if self._thread is not None:
            self._thread.join()
        if not self._enabled or self._error is not None:
            return save_video(video, self.fps, filepath, self.quality)
        avi_path = os.path.splitext(filepath)[0] + ".avi"
        try:
            from gen3c_tpu_torch.utils.mjpeg_avi import encode_jpeg_frame, write_mjpeg_avi

            reused = 0
            jpegs = []
            for i, frame in enumerate(video):
                frame = np.ascontiguousarray(frame)
                if i < len(self._cache) and self._cache[i][0] == _frame_key(frame):
                    jpegs.append(self._cache[i][1])
                    reused += 1
                else:
                    jpegs.append(encode_jpeg_frame(frame, self.jpeg_quality))
            os.makedirs(os.path.dirname(os.path.abspath(avi_path)), exist_ok=True)
            write_mjpeg_avi(avi_path, None, fps=self.fps, jpegs=jpegs,
                            frame_shape=(video.shape[1], video.shape[2]))
            log.info(f"incremental save: reused {reused}/{len(video)} pre-encoded frames")
            return avi_path
        except Exception as e:  # noqa: BLE001 - save_video's own chain of formats
            log.warning(f"incremental save failed ({e!r}); re-encoding")
            try:  # no truncated .avi beside what save_video writes
                if os.path.exists(avi_path):
                    os.remove(avi_path)
            except OSError:
                pass
            return save_video(video, self.fps, filepath, self.quality)


def _frame_key(frame: np.ndarray) -> tuple:
    """A uint8 frame's cache key: its shape and two independent 32-bit
    checksums (adler32, crc32) of its bytes, so that reusing a stale JPEG
    needs both to collide."""
    b = frame.tobytes()
    return frame.shape, zlib.adler32(b), zlib.crc32(b)


def _ffmpeg_available() -> bool:
    """Whether imageio's ffmpeg binary is present (then save_video writes
    an mp4, and there is nothing to encode ahead)."""
    try:
        import imageio_ffmpeg

        imageio_ffmpeg.get_ffmpeg_exe()
        return True
    except Exception:  # noqa: BLE001 - no package, or no binary
        return False


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


def read_video_bcthw(path: str, h: Optional[int] = None,
                     w: Optional[int] = None) -> Tuple[np.ndarray, float]:
    """A video as float32 (1, 3, T, H, W) in [-1, 1], and its fps: a
    directory of frame images (``save_video``'s last resort, fps from its
    fps.txt, else 24), an MJPEG AVI, or any file imageio reads. Frames are
    resized (bicubic) to (h, w) if given."""
    from PIL import Image

    def resized(img):
        img = img.convert("RGB")
        if h is not None and w is not None and img.size != (w, h):
            img = img.resize((w, h), Image.BICUBIC)
        return np.asarray(img)

    if os.path.isdir(path):
        names = sorted(n for n in os.listdir(path)
                       if n.lower().endswith((".png", ".jpg", ".jpeg")))
        if not names:
            raise FileNotFoundError(f"no frame images in directory {path}")
        frames = [resized(Image.open(os.path.join(path, n))) for n in names]
        fps = 24.0
        fps_file = os.path.join(path, "fps.txt")
        if os.path.exists(fps_file):
            with open(fps_file) as f:
                fps = float(f.read().strip())
    else:
        with open(path, "rb") as f:
            magic = f.read(12)
        if magic[:4] == b"RIFF" and magic[8:12] == b"AVI ":
            from gen3c_tpu_torch.utils.mjpeg_avi import read_mjpeg_avi

            frames_u8, fps = read_mjpeg_avi(path)
            frames = [resized(Image.fromarray(fr)) for fr in frames_u8]
        else:
            import imageio

            reader = imageio.get_reader(path)
            fps = float(reader.get_meta_data().get("fps", 24))
            frames = [resized(Image.fromarray(fr)) for fr in reader]
            reader.close()
    video = np.stack(frames).astype(np.float32) / 127.5 - 1.0  # (T, H, W, 3)
    return video.transpose(3, 0, 1, 2)[None], fps
