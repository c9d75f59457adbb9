"""Allowlisted JSON (+ base64 ndarray) API message serialization.

Parity: gui/api/api_serialization.py:58-237 — messages are JSON objects
with a "__type__" tag restricted to the known API dataclasses, ndarrays
encoded as {"__ndarray__": base64, "dtype": ..., "shape": ...}
(optionally zlib-compressed).
"""

from __future__ import annotations

import base64
import dataclasses
import json
import zlib
from typing import Any, Dict, Type

import numpy as np

from gen3c_tpu_torch.serving import api_types

API_MEDIA_TYPE = "application/json"

ALLOWED_TYPES: Dict[str, Type] = {
    cls.__name__: cls
    for cls in (
        api_types.SeedingRequest,
        api_types.SeedingResult,
        api_types.InferenceRequest,
        api_types.InferenceResult,
        api_types.CompressedSeedingRequest,
        api_types.CompressedInferenceResult,
    )
}


class APIMessageError(ValueError):
    pass


def _encode_value(v: Any, compress: bool) -> Any:
    from gen3c_tpu_torch.serving.encoding import CompressionFormat

    if isinstance(v, CompressionFormat):
        return {"__format__": v.value}
    if isinstance(v, (bytes, bytearray)):
        return {"__bytes__": base64.b64encode(bytes(v)).decode("ascii")}
    if isinstance(v, list) and v and isinstance(v[0], (bytes, bytearray)):
        return [
            {"__bytes__": base64.b64encode(bytes(b)).decode("ascii")}
            for b in v
        ]
    if isinstance(v, np.ndarray):
        raw = np.ascontiguousarray(v).tobytes()
        if compress:
            raw = zlib.compress(raw, level=1)
        return {
            "__ndarray__": base64.b64encode(raw).decode("ascii"),
            "dtype": str(v.dtype),
            "shape": list(v.shape),
            "zlib": compress,
        }
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v


def _decode_value(v: Any) -> Any:
    if isinstance(v, dict) and "__format__" in v:
        from gen3c_tpu_torch.serving.encoding import CompressionFormat

        return CompressionFormat(v["__format__"])
    if isinstance(v, dict) and "__bytes__" in v:
        return base64.b64decode(v["__bytes__"])
    if isinstance(v, list):
        return [_decode_value(x) for x in v]
    if isinstance(v, dict) and "__ndarray__" in v:
        raw = base64.b64decode(v["__ndarray__"])
        if v.get("zlib"):
            raw = zlib.decompress(raw)
        return np.frombuffer(raw, dtype=np.dtype(v["dtype"])).reshape(
            v["shape"]
        ).copy()
    return v


def dumps_api_message(msg: Any, compress: bool = False) -> bytes:
    cls_name = type(msg).__name__
    if cls_name not in ALLOWED_TYPES:
        raise APIMessageError(f"Not an API message type: {cls_name}")
    payload = {"__type__": cls_name}
    for f in dataclasses.fields(msg):
        payload[f.name] = _encode_value(getattr(msg, f.name), compress)
    return json.dumps(payload).encode("utf-8")


def loads_api_message(data: bytes, allowed_types=None) -> Any:
    try:
        payload = json.loads(data.decode("utf-8"))
    except Exception as e:  # noqa: BLE001
        raise APIMessageError(f"Invalid JSON: {e}") from e
    tname = payload.pop("__type__", None)
    if tname not in ALLOWED_TYPES:
        raise APIMessageError(f"Unknown message type: {tname}")
    cls = ALLOWED_TYPES[tname]
    if allowed_types is not None and not issubclass(
        cls, tuple(allowed_types)
    ):
        raise APIMessageError(f"Type {tname} not allowed here")
    kwargs = {k: _decode_value(v) for k, v in payload.items()}
    field_names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {k: v for k, v in kwargs.items() if k in field_names}
    return cls(**kwargs)
