"""GEN3C inference HTTP server on the standard library's http.server (port
of gen3c_tpu/serving/server.py).

Endpoints:
  POST /seed-model          (synchronous; returns a SeedingResult)
  POST /request-inference   (a queued job; ?sync=1 runs it synchronously)
  GET  /inference-result?request_id=...  (503 until ready; &partial=1
                            returns 206 and the frames of the finished AR
                            chunks; &format=jpg|png|npz|avi compresses)
  GET  /job-status?request_id=...        (state and chunk progress)
  POST /cancel-inference?request_id=...  (cancels between AR chunks)
  POST /render-preview      (the seeded cache along a path, no diffusion)
  POST /interpolate-path, /camera-path/save, /camera-path/load
                            (the native camera-path engine)
  POST /clear-cache
  GET  /, /viewer, /point-cloud, /trajectory, /image?format=jpg|png|pickle,
       /metadata
Settings come from GEN3C_* environment variables (GEN3C_API_DEBUG=1 serves
the DebugInferenceModel; GEN3C_API_HOST/PORT, GEN3C_MODEL_PRESET,
GEN3C_CHECKPOINT_DIR, GEN3C_NUM_STEPS, GEN3C_GUIDANCE, GEN3C_RESULT_CACHE_SIZE,
... : ``build_model_from_env``).

Inference requests run on one worker thread, since the model's device is a
serial resource; results land in a bounded LRU cache.

    python -m gen3c_tpu_torch.serving.server [--host H] [--port P] [--device cuda]

Over several cards, one process per rank: rank 0 serves, the others follow
its calls (``serving.models.Gen3cPersistentModel``):

    GEN3C_NUM_DEVICES=2 GEN3C_PARALLEL=cp GEN3C_CP_ATTN=ulysses \
        torchrun --nproc_per_node 2 -m gen3c_tpu_torch.serving.server
"""

from __future__ import annotations

import io
import json
import os
import pickle
import queue
import threading
import traceback
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from gen3c_tpu_torch.pipelines.chunked import GenerationCancelled
from gen3c_tpu_torch.serving.api_types import InferenceRequest, InferenceResult, SeedingRequest
from gen3c_tpu_torch.serving.serialization import (
    API_MEDIA_TYPE,
    APIMessageError,
    dumps_api_message,
    loads_api_message,
)
from gen3c_tpu_torch.utils import log


class InferenceService:
    """Job queue and result cache around an InferenceModel: per-job status
    (pending, running, done, error, cancelled) with chunk-level progress,
    cancellation between AR chunks, and partial results (the frames of the
    finished chunks, before the job ends)."""

    def __init__(self, model, result_cache_size: int = 8):
        self.model = model
        self.results: "OrderedDict[str, object]" = OrderedDict()
        self.errors = {}
        self.status = {}  # request_id -> {state, progress, frames_done}
        self.partials = {}  # request_id -> np.ndarray frames so far
        self.requests = {}  # request_id -> InferenceRequest (for partials)
        self.cancel_events = {}  # request_id -> threading.Event
        self.lock = threading.Lock()
        self.jobs: "queue.Queue" = queue.Queue()
        self.result_cache_size = result_cache_size
        self.worker = threading.Thread(target=self._run, daemon=True)
        self.worker.start()

    def _set_status(self, rid: str, **kw):
        with self.lock:
            self.status.setdefault(
                rid, {"state": "pending", "progress": 0.0, "frames_done": 0}
            ).update(kw)
            # bound terminal-state bookkeeping (status + error strings):
            # evict oldest finished jobs beyond 8x the result cache
            limit = 8 * self.result_cache_size
            if len(self.status) > limit:
                for old in list(self.status):
                    if len(self.status) <= limit:
                        break
                    if (
                        self.status[old]["state"]
                        in ("done", "error", "cancelled")
                        and old != rid
                        and old not in self.results
                    ):
                        self.status.pop(old, None)
                        self.errors.pop(old, None)

    def _run(self):
        while True:
            req = self.jobs.get()
            if req is None:
                return
            rid = req.request_id
            with self.lock:
                cancelled = self.status.get(rid, {}).get("state") == "cancelled"
                event = self.cancel_events.setdefault(rid, threading.Event())
            if cancelled:
                with self.lock:
                    self.partials.pop(rid, None)
                    self.requests.pop(rid, None)
                    self.cancel_events.pop(rid, None)
                continue
            self._set_status(rid, state="running")

            def on_chunk(done, total, video, rid=rid):
                with self.lock:
                    self.partials[rid] = video
                self._set_status(
                    rid, progress=done / total, frames_done=int(len(video))
                )

            try:
                result = self.model.run_inference(
                    req, on_chunk=on_chunk, cancel_event=event
                )
                with self.lock:
                    self.results[rid] = result
                    while len(self.results) > self.result_cache_size:
                        evicted, _ = self.results.popitem(last=False)
                        self.status.pop(evicted, None)
                self._set_status(rid, state="done", progress=1.0)
            except GenerationCancelled:
                log.info(f"inference {rid} cancelled")
                self._set_status(rid, state="cancelled")
            except Exception as e:  # noqa: BLE001
                log.error(f"inference failed: {e}\n{traceback.format_exc()}")
                with self.lock:
                    self.errors[rid] = str(e)
                self._set_status(rid, state="error", error=str(e))
            finally:
                with self.lock:
                    self.partials.pop(rid, None)
                    self.requests.pop(rid, None)
                    self.cancel_events.pop(rid, None)

    def submit(self, req: InferenceRequest):
        self._set_status(req.request_id, state="pending")
        with self.lock:
            self.requests[req.request_id] = req
        self.jobs.put(req)

    def cancel(self, request_id: str) -> bool:
        """Cancel a pending or running job. Returns False if unknown or
        already finished."""
        with self.lock:
            st = self.status.get(request_id)
            if st is None or st["state"] in ("done", "error", "cancelled"):
                return False
            if st["state"] == "pending":
                st["state"] = "cancelled"
                return True
            self.cancel_events.setdefault(
                request_id, threading.Event()
            ).set()
            return True

    def job_status(self, request_id: str) -> Optional[dict]:
        with self.lock:
            st = self.status.get(request_id)
            return dict(st) if st is not None else None

    def partial_or_none(self, request_id: str):
        """InferenceResult of completed-chunk frames, or None."""
        with self.lock:
            frames = self.partials.get(request_id)
            req = self.requests.get(request_id)
            if frames is None or req is None:
                return None
            frames = frames.copy()
        n = min(len(frames), len(req))
        return InferenceResult(
            request_id=request_id,
            cameras_to_world=req.cameras_to_world[:n],
            focal_lengths=req.focal_lengths[:n],
            principal_points=req.principal_points[:n],
            resolutions=req.resolutions[:n],
            images=frames[:n],
        )

    def result_or_none(self, request_id: str):
        with self.lock:
            if request_id in self.errors:
                raise RuntimeError(self.errors.pop(request_id))
            return self.results.get(request_id)

    def shutdown(self):
        self.jobs.put(None)


def _trajectory_response(model, qs) -> bytes:
    """A preset camera trajectory from the seeded pose (or a default
    camera) as JSON c2ws and focal lengths for the web viewer."""
    from gen3c_tpu_torch.ops.camera import generate_camera_trajectory

    traj = qs.get("type", ["left"])[0]
    n = int(qs.get("n", ["121"])[0])
    distance = float(qs.get("distance", ["0.3"])[0])
    rotation = qs.get("rotation", ["center_facing"])[0]
    center_depth = float(qs.get("center_depth", ["2.0"])[0])
    meta = model.metadata()
    w, h = meta.get("inference_resolution", [1280, 704])
    seed_req = getattr(model, "seeding_request", None)
    if seed_req is not None:
        w2c0 = seed_req.world_to_cameras().astype(np.float32)[0]
        k0 = seed_req.intrinsics_matrix().astype(np.float32)[0]
    else:
        w2c0 = np.eye(4, dtype=np.float32)
        k0 = np.array(
            [[0.8 * w, 0, w / 2], [0, 0.8 * w, h / 2], [0, 0, 1]], np.float32
        )
    w2cs, ks = generate_camera_trajectory(
        traj, w2c0, k0, n, distance, rotation, center_depth
    )
    w2cs = np.asarray(w2cs).reshape(-1, 4, 4)
    ks = np.asarray(ks).reshape(-1, 3, 3)
    c2ws = np.linalg.inv(w2cs)[:, :3, :4]
    return json.dumps(
        {
            "c2ws": c2ws.tolist(),
            "focal_lengths": ks[:, [0, 1], [0, 1]].tolist(),
            "resolution": [int(w), int(h)],
        }
    ).encode()


def parse_guidance_interval_env(value: str):
    """Parse GEN3C_GUIDANCE_INTERVAL="lo,hi" -> (lo, hi) or None.

    Raises ValueError with the offending text on malformed input so a
    typo fails the server at startup instead of silently running full
    CFG."""
    if not value or not value.strip():
        return None
    parts = [p.strip() for p in value.split(",")]
    if len(parts) != 2:
        raise ValueError(
            f"GEN3C_GUIDANCE_INTERVAL must be 'lo,hi', got {value!r}"
        )
    lo, hi = float(parts[0]), float(parts[1])
    if not (0.0 <= lo <= hi):
        raise ValueError(
            f"GEN3C_GUIDANCE_INTERVAL needs 0 <= lo <= hi, got {value!r}"
        )
    return (lo, hi)


def build_model_from_env(device: str = "cuda"):
    """The serving model the GEN3C_* environment describes, on ``device``."""
    if os.environ.get("GEN3C_API_DEBUG", "0") == "1":
        from gen3c_tpu_torch.serving.models import DebugInferenceModel

        return DebugInferenceModel()
    from gen3c_tpu_torch.serving.models import Gen3cPersistentModel

    return Gen3cPersistentModel(
        model_preset=os.environ.get("GEN3C_MODEL_PRESET", "gen3c_7b"),
        checkpoint_dir=os.environ.get("GEN3C_CHECKPOINT_DIR", "checkpoints"),
        num_steps=int(os.environ.get("GEN3C_NUM_STEPS", "35")),
        guidance=float(os.environ.get("GEN3C_GUIDANCE", "1.0")),
        seed=int(os.environ.get("GEN3C_SEED", "0")),
        depth_source=os.environ.get("GEN3C_DEPTH_SOURCE", "auto"),
        quantize=os.environ.get("GEN3C_QUANTIZE", "") or False,
        step_cache_interval=int(
            os.environ.get("GEN3C_STEP_CACHE_INTERVAL", "1")
        ),
        step_cache_threshold=float(
            os.environ.get("GEN3C_STEP_CACHE_THRESHOLD", "0")
        ),
        num_devices=int(os.environ.get("GEN3C_NUM_DEVICES", "1")),
        # opt-in temporal-band attention (kernel K3)
        attn_temporal_window=(
            int(os.environ["GEN3C_ATTN_WINDOW"])
            if os.environ.get("GEN3C_ATTN_WINDOW", "").strip() else None
        ),
        cp_attn=os.environ.get("GEN3C_CP_ATTN") or None,
        # GEN3C_GUIDANCE_INTERVAL="lo,hi": CFG only on steps with sigma
        # inside [lo, hi] (arXiv:2404.07724), condition-only forwards outside
        guidance_interval=parse_guidance_interval_env(
            os.environ.get("GEN3C_GUIDANCE_INTERVAL", "")
        ),
        cfg_rescale=float(os.environ.get("GEN3C_CFG_RESCALE", "0")),
        parallel=os.environ.get("GEN3C_PARALLEL", "cp"),
        # accepted, and ignored: the DiT stays on the device
        offload_dit=(
            os.environ["GEN3C_OFFLOAD_DIT"].strip().lower()
            in ("1", "true", "yes", "on")
            if os.environ.get("GEN3C_OFFLOAD_DIT", "").strip() else None
        ),
        device=device,
        # over several cards: the DiT's collectives' backend (default NCCL on
        # CUDA; gloo for ranks that share a card)
        dist_backend=os.environ.get("GEN3C_DIST_BACKEND") or None,
    )


def make_handler(service: InferenceService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through our logger
            log.debug(fmt % args)

        def _send(self, code: int, body: bytes, ctype: str = "text/plain"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            # write big payloads (multi-MB frame stacks) in 1 MiB pieces:
            # keeps socket buffering bounded and lets the client start
            # consuming immediately
            mv = memoryview(body)
            for off in range(0, len(mv), 1 << 20):
                self.wfile.write(mv[off : off + (1 << 20)])

        def _read_body(self) -> bytes:
            n = int(self.headers.get("Content-Length", "0"))
            return self.rfile.read(n)

        def do_GET(self):  # noqa: N802
            url = urlparse(self.path)
            qs = parse_qs(url.query)
            if url.path in ("/", "/viewer"):
                html_path = os.path.join(
                    os.path.dirname(os.path.abspath(__file__)), "viewer.html"
                )
                try:
                    with open(html_path, "rb") as f:
                        self._send(200, f.read(), "text/html; charset=utf-8")
                except OSError:
                    self._send(404, b"viewer.html missing")
            elif url.path == "/point-cloud":
                max_points = int(qs.get("max_points", ["200000"])[0])
                try:
                    points, colors = service.model.get_point_cloud(max_points)
                except (AssertionError, NotImplementedError) as e:
                    self._send(400, str(e).encode())
                    return
                from gen3c_tpu_torch.serving.serialization import _encode_value

                body = json.dumps(
                    {
                        "points": _encode_value(
                            np.ascontiguousarray(points, np.float32), False
                        ),
                        "colors": _encode_value(
                            np.ascontiguousarray(colors, np.uint8), False
                        ),
                    }
                ).encode()
                self._send(200, body, "application/json")
            elif url.path == "/trajectory":
                try:
                    body = _trajectory_response(service.model, qs)
                except Exception as e:  # noqa: BLE001
                    self._send(400, str(e).encode())
                    return
                self._send(200, body, "application/json")
            elif url.path == "/metadata":
                self._send(
                    200,
                    json.dumps(service.model.metadata()).encode(),
                    "application/json",
                )
            elif url.path == "/inference-result":
                request_id = qs.get("request_id", [""])[0]
                partial_ok = qs.get("partial", ["0"])[0] in ("1", "true")
                # ?format=jpg|png: per-frame compressed result payload
                # (CompressedInferenceResult — much smaller than raw
                # base64 frames for browser/remote clients)
                fmt = qs.get("format", [None])[0]

                def _maybe_compress(res):
                    if fmt is None:
                        return res
                    from gen3c_tpu_torch.serving.encoding import CompressionFormat

                    return res.compress(format_rgb=CompressionFormat(fmt))

                if fmt is not None:
                    from gen3c_tpu_torch.serving.encoding import CompressionFormat

                    try:
                        rgb_fmt = CompressionFormat(fmt)
                    except ValueError:
                        self._send(400, f"unknown format {fmt}".encode())
                        return
                    if rgb_fmt is CompressionFormat.EXR:
                        # EXR is the float-depth wire format; the result
                        # RGB payload must use jpg/png/npz/avi.
                        self._send(
                            400, b"exr is depth-only; use jpg/png/npz/avi"
                        )
                        return
                try:
                    result = service.result_or_none(request_id)
                except Exception as e:  # noqa: BLE001
                    self._send(500, str(e).encode())
                    return
                if result is not None:
                    self._send(
                        200, dumps_api_message(_maybe_compress(result)),
                        API_MEDIA_TYPE,
                    )
                    return
                if partial_ok:
                    part = service.partial_or_none(request_id)
                    if part is not None:
                        # 206 Partial Content: frames of completed chunks
                        self._send(
                            206, dumps_api_message(_maybe_compress(part)),
                            API_MEDIA_TYPE,
                        )
                        return
                self._send(503, b"Result not ready")
            elif url.path == "/job-status":
                request_id = qs.get("request_id", [""])[0]
                st = service.job_status(request_id)
                if st is None:
                    self._send(404, b"Unknown request_id")
                else:
                    self._send(
                        200, json.dumps(st).encode(), "application/json"
                    )
            elif url.path == "/image":
                fmt = qs.get("format", ["jpg"])[0]
                image = service.model.get_latest_rgb()
                if image is None:
                    self._send(404, b"No image available yet.")
                    return
                if fmt == "pickle":
                    self._send(
                        200,
                        pickle.dumps({"image": image}),
                        "application/octet-stream",
                    )
                elif fmt in ("jpg", "png"):
                    from PIL import Image

                    buf = io.BytesIO()
                    img = np.asarray(image)
                    if img.dtype != np.uint8:
                        img = (img * 255).clip(0, 255).astype(np.uint8)
                    Image.fromarray(img).save(
                        buf, format="JPEG" if fmt == "jpg" else "PNG"
                    )
                    self._send(200, buf.getvalue(), f"image/{fmt}")
                else:
                    self._send(400, f"Unsupported format {fmt}".encode())
            else:
                self._send(404, b"Not found")

        def do_POST(self):  # noqa: N802
            url = urlparse(self.path)
            qs = parse_qs(url.query)
            sync = qs.get("sync", ["0"])[0] in ("1", "true", "True")
            body = self._read_body()
            if url.path == "/seed-model":
                try:
                    req = loads_api_message(body, (SeedingRequest,))
                except APIMessageError as e:
                    self._send(400, str(e).encode())
                    return
                try:
                    # compressed variant: restore raw buffers first
                    # (server_base.py handles CompressedSeedingRequest
                    # the same way)
                    if hasattr(req, "decompress"):
                        req.decompress()
                    result = service.model.seed_model(req)
                except Exception as e:  # noqa: BLE001
                    log.error(f"seeding failed: {e}\n{traceback.format_exc()}")
                    self._send(400, str(e).encode())
                    return
                self._send(200, dumps_api_message(result), API_MEDIA_TYPE)
            elif url.path == "/request-inference":
                try:
                    req = loads_api_message(body, (InferenceRequest,))
                except APIMessageError as e:
                    self._send(400, str(e).encode())
                    return
                if sync:
                    try:
                        result = service.model.run_inference(req)
                    except Exception as e:  # noqa: BLE001
                        self._send(400, str(e).encode())
                        return
                    self._send(200, dumps_api_message(result), API_MEDIA_TYPE)
                else:
                    service.submit(req)
                    self._send(202, b"Request accepted.")
            elif url.path == "/render-preview":
                try:
                    req = loads_api_message(body, (InferenceRequest,))
                    result = service.model.render_preview(req)
                except APIMessageError as e:
                    self._send(400, str(e).encode())
                    return
                except (AssertionError, AttributeError) as e:
                    self._send(400, str(e).encode())
                    return
                self._send(200, dumps_api_message(result), API_MEDIA_TYPE)
            elif url.path == "/interpolate-path":
                # keyframed spline via the native C++ camera-path engine
                # (camera_path.cu parity): body {keyframes: [{c2w: 12
                # floats row-major (3,4), fov?}], n: int}
                try:
                    payload = json.loads(body.decode("utf-8"))
                    kfs = payload["keyframes"]
                    n = int(payload.get("n", 121))
                    assert 1 <= n <= 10000 and len(kfs) >= 1
                    from gen3c_tpu_torch.native.camera_path import CameraPath

                    path = CameraPath()
                    for i, kf in enumerate(kfs):
                        c2w = np.asarray(kf["c2w"], np.float32).reshape(3, 4)
                        path.add_keyframe_from_c2w(
                            c2w, fov=float(kf.get("fov", 50.0)),
                            timestamp=float(kf.get("t", i)),
                        )
                    c2ws, fovs = path.sample(n)
                    out = json.dumps(
                        {"c2ws": c2ws.tolist(), "fovs": fovs.tolist()}
                    ).encode()
                except Exception as e:  # noqa: BLE001
                    self._send(400, str(e).encode())
                    return
                self._send(200, out, "application/json")
            elif url.path == "/camera-path/save":
                # keyframes -> reference-GUI camera-path JSON
                # (gui/src/camera_path.cu:124-133 schema, shareable with
                # the reference viewer). body {keyframes: [{c2w, fov?,
                # t?}]}
                import tempfile

                fd, tmp = tempfile.mkstemp(suffix=".json")
                os.close(fd)
                try:
                    payload = json.loads(body.decode("utf-8"))
                    from gen3c_tpu_torch.native.camera_path import CameraPath

                    path = CameraPath()
                    for i, kf in enumerate(payload["keyframes"]):
                        path.add_keyframe_from_c2w(
                            np.asarray(kf["c2w"], np.float32).reshape(3, 4),
                            fov=float(kf.get("fov", 50.0)),
                            timestamp=float(kf.get("t", i)),
                        )
                    path.save(tmp)
                    with open(tmp) as f:
                        out = f.read().encode()
                except Exception as e:  # noqa: BLE001
                    self._send(400, str(e).encode())
                    return
                finally:
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass
                self._send(200, out, "application/json")
            elif url.path == "/camera-path/load":
                # reference-GUI camera-path JSON -> keyframes (c2w/fov/t)
                import tempfile

                fd, tmp = tempfile.mkstemp(suffix=".json")
                try:
                    with os.fdopen(fd, "wb") as f:
                        f.write(body)
                    from gen3c_tpu_torch.native.camera_path import CameraPath

                    path = CameraPath()
                    path.load(tmp)
                    kfs = [
                        {"c2w": c2w.tolist(), "fov": fov, "t": ts}
                        for c2w, fov, ts in path.keyframes()
                    ]
                    out = json.dumps({"keyframes": kfs}).encode()
                except Exception as e:  # noqa: BLE001
                    self._send(400, str(e).encode())
                    return
                finally:
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass
                self._send(200, out, "application/json")
            elif url.path == "/cancel-inference":
                request_id = qs.get("request_id", [""])[0]
                if service.cancel(request_id):
                    self._send(200, b"Cancellation requested.")
                else:
                    self._send(404, b"Unknown or finished request_id")
            elif url.path == "/clear-cache":
                service.model.clear_cache()
                self._send(200, b"Cache cleared.")
            else:
                self._send(404, b"Not found")

    return Handler


def serve(host: Optional[str] = None, port: Optional[int] = None, model=None,
          device: str = "cuda"):
    """(ThreadingHTTPServer, InferenceService) for ``model``, or the model
    of ``build_model_from_env(device)``; the caller runs
    ``serve_forever``."""
    host = host or os.environ.get("GEN3C_API_HOST", "127.0.0.1")
    if port is None:  # note: port=0 means "any free port"
        port = int(os.environ.get("GEN3C_API_PORT", "8000"))
    model = model or build_model_from_env(device)
    service = InferenceService(
        model,
        result_cache_size=int(os.environ.get("GEN3C_RESULT_CACHE_SIZE", "8")),
    )
    server = ThreadingHTTPServer((host, port), make_handler(service))
    log.info(f"GEN3C inference server on http://{host}:{port}")
    return server, service


def main():
    """Serve the model the environment describes. Over several cards
    (GEN3C_NUM_DEVICES=N under ``torchrun --nproc_per_node N``) every rank
    builds it; rank 0 serves and the others follow rank 0's calls until
    the server stops."""
    import argparse

    p = argparse.ArgumentParser(description="GEN3C inference server (PyTorch/CUDA)")
    p.add_argument("--host", default=None,
                   help="bind host (default: GEN3C_API_HOST or 127.0.0.1)")
    p.add_argument("--port", type=int, default=None,
                   help="bind port (default: GEN3C_API_PORT or 8000)")
    p.add_argument("--device", default="cuda", help="torch device of the model")
    args = p.parse_args()
    model = build_model_from_env(args.device)
    if not getattr(model, "leads", True):
        model.follow()
        return
    server, service = serve(host=args.host, port=args.port, model=model)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        service.shutdown()
        server.server_close()
        model.shutdown()


if __name__ == "__main__":
    main()
