"""GEN3C inference client: seeding upload, camera-path authoring,
inference requests, result download (port of gen3c_tpu/serving/client.py).

The reference GUI client's duties, headless: seeding from an image or a
directory of posed RGBD frames, authoring a camera path (the native
keyframe spline or a preset trajectory), submitting InferenceRequests,
polling and saving results. Transport is httpx, imported when a client is
made.

CLI:
  python -m gen3c_tpu_torch.serving.client --server http://127.0.0.1:8000 \
      --image seed.png --trajectory left --num_frames 17 --output out/
"""

from __future__ import annotations

import argparse
import time
import uuid
from typing import Optional, Tuple

import numpy as np

from gen3c_tpu_torch.serving.api_types import (
    InferenceRequest,
    InferenceResult,
    SeedingRequest,
    SeedingResult,
)
from gen3c_tpu_torch.serving.serialization import dumps_api_message, loads_api_message
from gen3c_tpu_torch.utils import log


class Gen3cClient:
    def __init__(self, base_url: str, timeout: float = 600.0):
        import httpx

        self.base_url = base_url.rstrip("/")
        self.http = httpx.Client(base_url=self.base_url, timeout=timeout)

    # -- server info --

    def metadata(self) -> dict:
        r = self.http.get("/metadata")
        r.raise_for_status()
        return r.json()

    # -- seeding --

    def seed_from_image(
        self,
        image: np.ndarray,  # (H, W, 3) uint8
        c2w: Optional[np.ndarray] = None,  # (3, 4) or (4, 4)
        focal_length: Optional[float] = None,
        depth: Optional[np.ndarray] = None,
    ) -> SeedingResult:
        h, w = image.shape[:2]
        if c2w is None:
            c2w = np.eye(4, dtype=np.float32)
        c2w = np.asarray(c2w, np.float32)[:3, :4][None]
        fl = focal_length or 0.8 * w
        req = SeedingRequest(
            request_id=str(uuid.uuid4()),
            cameras_to_world=c2w,
            focal_lengths=np.full((1, 2), fl, np.float32),
            principal_points=np.full((1, 2), 0.5, np.float32),
            images=image[None],
            depths=None if depth is None else depth[None],
        )
        r = self.http.post("/seed-model", content=dumps_api_message(req))
        r.raise_for_status()
        return loads_api_message(r.content)

    def seed_from_directory(
        self, data_directory: str, max_frames: Optional[int] = None,
        frames_stride: int = 1,
    ) -> SeedingResult:
        """Multi-frame (v2v) seeding from a reference-format data
        directory (gui/api/v2v_utils.py:44-125 load_gen3c_seeding_data)."""
        req = load_seeding_directory(
            data_directory, max_frames=max_frames,
            frames_stride=frames_stride,
        )
        r = self.http.post("/seed-model", content=dumps_api_message(req))
        r.raise_for_status()
        return loads_api_message(r.content)

    # -- inference --

    def request_inference(
        self,
        c2ws: np.ndarray,  # (N, 3, 4) camera-to-world
        resolution: Tuple[int, int],  # (width, height)
        focal_lengths: Optional[np.ndarray] = None,
        fovs_deg: Optional[np.ndarray] = None,
        prompt: str = "",
        framerate: float = 24.0,
        return_depths: bool = False,
        sync: bool = False,
    ) -> str | InferenceResult:
        n = len(c2ws)
        w, h = resolution
        if focal_lengths is None:
            if fovs_deg is not None:
                f = 0.5 * w / np.tan(np.radians(fovs_deg) / 2)
                focal_lengths = np.stack([f, f], axis=-1).astype(np.float32)
            else:
                focal_lengths = np.full((n, 2), 0.8 * w, np.float32)
        req = InferenceRequest(
            request_id=str(uuid.uuid4()),
            cameras_to_world=np.asarray(c2ws, np.float32),
            focal_lengths=focal_lengths,
            principal_points=np.full((n, 2), 0.5, np.float32),
            resolutions=np.tile([[w, h]], (n, 1)),
            prompt=prompt,
            framerate=framerate,
            return_depths=return_depths,
        )
        url = "/request-inference" + ("?sync=1" if sync else "")
        r = self.http.post(url, content=dumps_api_message(req))
        r.raise_for_status()
        if sync:
            return loads_api_message(r.content)
        return req.request_id

    def wait_for_result(
        self,
        request_id: str,
        poll_s: float = 1.0,
        timeout_s: float = 3600.0,
        on_progress=None,  # callback(status_dict) per poll
        # "jpg"/"png": per-frame compressed wire; "avi": whole result in
        # ONE MJPEG-AVI buffer (measured 5.2x smaller than png on
        # natural frames) — decompress() handles all of them
        wire_format: Optional[str] = None,
    ) -> InferenceResult:
        t0 = time.monotonic()
        params = {"request_id": request_id}
        if wire_format:
            params["format"] = wire_format
        while True:
            if on_progress is not None:
                st = self.job_status(request_id)
                if st is not None:
                    on_progress(st)
            r = self.http.get("/inference-result", params=params)
            if r.status_code == 200:
                result = loads_api_message(r.content)
                if hasattr(result, "decompress"):
                    result.decompress()
                    if result.images is not None and (
                        result.images.dtype != np.uint8
                    ):
                        # keep the client contract (uint8 frames) across
                        # raw and compressed wire formats
                        result.images = (
                            result.images * 255.0 + 0.5
                        ).astype(np.uint8)
                return result
            if r.status_code != 503:
                r.raise_for_status()
            if time.monotonic() - t0 > timeout_s:
                raise TimeoutError(f"result {request_id} not ready")
            time.sleep(poll_s)

    def job_status(self, request_id: str) -> Optional[dict]:
        r = self.http.get("/job-status", params={"request_id": request_id})
        if r.status_code == 404:
            return None
        r.raise_for_status()
        return r.json()

    def partial_result(self, request_id: str) -> Optional[InferenceResult]:
        """Frames of completed AR chunks (206), the final result (200), or
        None if nothing is available yet."""
        r = self.http.get(
            "/inference-result",
            params={"request_id": request_id, "partial": "1"},
        )
        if r.status_code in (200, 206):
            return loads_api_message(r.content)
        if r.status_code == 503:
            return None
        r.raise_for_status()
        return None

    def cancel_inference(self, request_id: str) -> bool:
        r = self.http.post(
            "/cancel-inference", params={"request_id": request_id}
        )
        return r.status_code == 200

    def render_preview(
        self,
        c2ws: np.ndarray,
        resolution: Tuple[int, int],
        focal_lengths: Optional[np.ndarray] = None,
    ) -> InferenceResult:
        """Instant (no-diffusion) point-cloud preview along a path."""
        n = len(c2ws)
        w, h = resolution
        if focal_lengths is None:
            focal_lengths = np.full((n, 2), 0.8 * w, np.float32)
        req = InferenceRequest(
            request_id=str(uuid.uuid4()),
            cameras_to_world=np.asarray(c2ws, np.float32),
            focal_lengths=focal_lengths,
            principal_points=np.full((n, 2), 0.5, np.float32),
            resolutions=np.tile([[w, h]], (n, 1)),
        )
        r = self.http.post("/render-preview", content=dumps_api_message(req))
        r.raise_for_status()
        return loads_api_message(r.content)

    def latest_image(self) -> Optional[np.ndarray]:
        import io

        from PIL import Image

        r = self.http.get("/image", params={"format": "png"})
        if r.status_code == 404:
            return None
        r.raise_for_status()
        return np.asarray(Image.open(io.BytesIO(r.content)))


def load_seeding_directory(
    data_directory: str,
    max_frames: Optional[int] = None,
    frames_stride: int = 1,
) -> SeedingRequest:
    """Build a multi-frame SeedingRequest from a reference-format v2v
    data directory (gui/api/v2v_utils.py:44-125):

        camera.npz   'intrinsics' (N,3,3), 'w2c' (N,4,4)
        depth.npz    'depth' (N,H,W)
        mask.npz     'mask'  (N,H,W)            [optional here]
        rgb.mp4 / rgb.avi / rgb/ (frame dir)    (any read_video format)
        metadata.json                           [ignored, like reference]
    """
    import os

    from gen3c_tpu_torch.utils import io as io_utils

    depths = np.load(os.path.join(data_directory, "depth.npz"))["depth"]
    assert depths.ndim == 3, depths.shape
    cam = np.load(os.path.join(data_directory, "camera.npz"))
    intrinsics = np.asarray(cam["intrinsics"], np.float32)
    w2c = np.asarray(cam["w2c"], np.float32)

    rgb_path = None
    for cand in ("rgb.mp4", "rgb.avi", "rgb"):
        p = os.path.join(data_directory, cand)
        if os.path.exists(p):
            rgb_path = p
            break
    if rgb_path is None:
        raise FileNotFoundError(f"no rgb video in {data_directory}")
    video, _ = io_utils.read_video_bcthw(rgb_path)  # (1,3,T,H,W) [-1,1]
    images = (
        (video[0].transpose(1, 2, 3, 0) + 1.0) * 127.5
    ).clip(0, 255).astype(np.uint8)  # (T,H,W,3)

    masks = None
    mask_file = os.path.join(data_directory, "mask.npz")
    if os.path.exists(mask_file):
        masks = np.load(mask_file)["mask"]

    n = min(len(depths), len(images), len(intrinsics), len(w2c))
    sel = np.arange(0, n, frames_stride)
    if max_frames is not None:
        sel = sel[:max_frames]
    depths = depths.astype(np.float32)[sel]
    images = images[sel]
    intrinsics = intrinsics[sel]
    w2c = w2c[sel]
    if masks is not None:
        masks = masks[sel].astype(np.float32)

    resolutions = np.tile(
        [[depths.shape[2], depths.shape[1]]], (len(sel), 1)
    )
    focal_lengths = np.stack(
        [intrinsics[:, 0, 0], intrinsics[:, 1, 1]], axis=1
    )
    principal_points = (
        intrinsics[:, :2, 2] / resolutions
    ).astype(np.float32)
    cameras_to_world = np.linalg.inv(w2c)[:, :3, :].astype(np.float32)

    return SeedingRequest(
        request_id=str(uuid.uuid4()),
        cameras_to_world=cameras_to_world,
        focal_lengths=focal_lengths.astype(np.float32),
        principal_points=principal_points,
        resolutions=resolutions,
        images=images,
        depths=depths,
        masks=masks,
    )


def camera_path_from_trajectory(
    trajectory: str, n_frames: int, movement_distance: float = 0.3,
    camera_rotation: str = "center_facing", center_depth: float = 2.0,
) -> np.ndarray:
    """Author a (N, 3, 4) c2w path from a preset trajectory, smoothed
    through the native keyframe spline (the GUI authoring flow)."""
    from gen3c_tpu_torch.native.camera_path import CameraPath
    from gen3c_tpu_torch.ops.camera import generate_camera_trajectory

    w2cs, _ = generate_camera_trajectory(
        trajectory,
        np.eye(4, dtype=np.float32),
        np.array([[100.0, 0, 50], [0, 100.0, 50], [0, 0, 1]], np.float32),
        num_frames=max(4, n_frames // 4),  # sparse keyframes
        movement_distance=movement_distance,
        camera_rotation=camera_rotation,
        center_depth=center_depth,
    )
    path = CameraPath()
    for w2c in np.asarray(w2cs[0]):
        c2w = np.linalg.inv(w2c)
        path.add_keyframe_from_c2w(c2w[:3])
    c2ws, _ = path.sample(n_frames)
    return c2ws


def orbit_c2w(target, dist: float, yaw: float, pitch: float) -> np.ndarray:
    """(3, 4) OpenCV c2w (x right, y down, z forward) from orbit params —
    the exact math of viewer.html's orbitC2W (serving/viewer.html:150-159),
    ported so the web viewer's camera authoring has a tested Python twin."""
    target = np.asarray(target, np.float64)
    eye = target + dist * np.array(
        [
            np.sin(yaw) * np.cos(pitch),
            np.sin(pitch),
            -np.cos(yaw) * np.cos(pitch),
        ]
    )
    z = target - eye
    z = z / (np.linalg.norm(z) or 1.0)
    down = np.array([0.0, 1.0, 0.0])
    x = np.cross(down, z)
    x = x / (np.linalg.norm(x) or 1.0)
    y = np.cross(z, x)
    return np.stack([x, y, z, eye], axis=1).astype(np.float32)  # (3, 4)


class ViewerSession:
    """Python port of viewer.html's critical path: orbit
    camera -> keyframe authoring -> reference-GUI camera-path JSON
    export/import -> native spline path -> InferenceRequest. Each method
    mirrors a viewer UI action (the cited viewer.html lines) and talks to
    the same server endpoints the JS calls, so the server/viewer contract
    stays covered by tests even without a browser."""

    def __init__(self, client: Gen3cClient):
        self.client = client
        self.keyframes: list = []  # [{c2w: 12 floats, fov, t}]
        self.path_c2ws: Optional[np.ndarray] = None  # (N, 3, 4)
        self.cam = {"target": [0.0, 0.0, 2.0], "dist": 3.0,
                    "yaw": 0.0, "pitch": 0.0}  # viewer.html:206

    def add_keyframe(self, fov: float = 50.0) -> None:
        """kfbtn.onclick (viewer.html:401-405)."""
        m = orbit_c2w(self.cam["target"], self.cam["dist"],
                      self.cam["yaw"], self.cam["pitch"])
        self.keyframes.append(
            {"c2w": [float(v) for v in m.reshape(-1)], "fov": fov,
             "t": len(self.keyframes)}
        )

    def clear_keyframes(self) -> None:
        """kfclearbtn.onclick (viewer.html:406-409)."""
        self.keyframes = []

    def export_camera_path(self) -> str:
        """kfexport.onclick (viewer.html:410-420): keyframes ->
        reference-GUI camera-path JSON text via /camera-path/save."""
        import json

        r = self.client.http.post(
            "/camera-path/save",
            content=json.dumps({"keyframes": self.keyframes}),
        )
        r.raise_for_status()
        return r.text

    def import_camera_path(self, json_text: str) -> int:
        """kfimport.onchange (viewer.html:421-432): reference-format
        JSON -> keyframes via /camera-path/load."""
        r = self.client.http.post("/camera-path/load", content=json_text)
        r.raise_for_status()
        kfs = r.json()["keyframes"]
        self.keyframes = [
            {
                "c2w": list(np.asarray(kf["c2w"], np.float32).reshape(-1)
                            .astype(float)),
                "fov": kf.get("fov", 50.0),
                "t": kf.get("t", i),
            }
            for i, kf in enumerate(kfs)
        ]
        return len(self.keyframes)

    def build_spline_path(self, n: int) -> np.ndarray:
        """kfbuildbtn.onclick (viewer.html:433-441): keyframes -> (n,3,4)
        spline path via /interpolate-path."""
        import json

        r = self.client.http.post(
            "/interpolate-path",
            content=json.dumps({"keyframes": self.keyframes, "n": n}),
        )
        r.raise_for_status()
        self.path_c2ws = np.asarray(r.json()["c2ws"], np.float32)
        return self.path_c2ws

    def request_inference(self, resolution=(1280, 704), prompt: str = "",
                          sync: bool = False):
        """Run button: buildInferenceRequest (viewer.html:443-467) —
        focal 0.8*W, principal 0.5, resolutions tiled — then POST
        /request-inference (same construction as Gen3cClient)."""
        assert self.path_c2ws is not None, "build_spline_path first"
        return self.client.request_inference(
            self.path_c2ws, resolution, prompt=prompt, sync=sync
        )


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="GEN3C client")
    p.add_argument("--server", default="http://127.0.0.1:8000")
    p.add_argument("--image", default=None)
    p.add_argument("--seed_dir", default=None,
                   help="multi-frame (v2v) seeding from a reference-format"
                        " data directory (camera/depth/mask npz + rgb)")
    p.add_argument("--seed_max_frames", type=int, default=None)
    p.add_argument("--seed_stride", type=int, default=1)
    p.add_argument("--trajectory", default="left")
    p.add_argument("--camera_path_json", default=None,
                   help="load a saved keyframe path instead of a preset")
    p.add_argument("--num_frames", type=int, default=17)
    p.add_argument("--movement_distance", type=float, default=0.3)
    p.add_argument("--prompt", default="")
    p.add_argument("--output", default="outputs/client")
    args = p.parse_args(argv)

    from PIL import Image

    if (args.image is None) == (args.seed_dir is None):
        p.error("exactly one of --image / --seed_dir is required")

    client = Gen3cClient(args.server)
    log.info(f"server metadata: {client.metadata()}")

    if args.seed_dir:
        seed_res = client.seed_from_directory(
            args.seed_dir, max_frames=args.seed_max_frames,
            frames_stride=args.seed_stride,
        )
        log.info(f"seeded from {len(seed_res)} posed frames")
    else:
        image = np.asarray(Image.open(args.image).convert("RGB"))
        seed_res = client.seed_from_image(image)
        log.info(
            "seeded; estimated depth range "
            f"{None if seed_res.depths is None else (float(seed_res.depths.min()), float(seed_res.depths.max()))}"
        )

    if args.camera_path_json:
        from gen3c_tpu_torch.native.camera_path import CameraPath

        path = CameraPath()
        path.load(args.camera_path_json)
        c2ws, _ = path.sample(args.num_frames)
    else:
        c2ws = camera_path_from_trajectory(
            args.trajectory, args.num_frames, args.movement_distance
        )

    meta = client.metadata()
    w, h = meta.get("inference_resolution", [image.shape[1], image.shape[0]])
    request_id = client.request_inference(
        c2ws, (w, h), prompt=args.prompt
    )
    log.info(f"inference request {request_id} submitted; polling...")
    result = client.wait_for_result(request_id)
    log.info(f"got {len(result.images)} frames ({result.runtime_ms:.0f} ms)")
    result.save_images(args.output)
    log.info(f"saved frames to {args.output}")


if __name__ == "__main__":
    main()
