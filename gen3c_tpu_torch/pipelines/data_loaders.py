"""Input clip loaders (port of the packaged format of
gen3c_tpu/pipelines/data_loaders.py, ``load_data_packaged_format``, :74-95).

A packaged clip is one file: an ``.npz`` with the arrays "image" (F, 3, H,
W) in [-1, 1], "depth" (F, 1, H, W), optionally "mask" (F, 1, H, W), "w2c"
(F, 4, 4) and "intrinsics" (F, 3, 3); or the reference's ``.pt``, a tuple
of those five tensors (the mask may be None). Every array comes back as
float32 numpy. The distributed, ViPE and multiview formats wait for the
dynamic and multiview slices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

Clip = Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], np.ndarray, np.ndarray]


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
