"""The port's serving path (gen3c_tpu_torch.serving) against gen3c_tpu's on
the CPU.

Both packages' ``Gen3cPersistentModel`` load one checkpoint directory
(dit.npz and vae.npz written from gen3c_tpu's seeded tiny weights, JAX
built in fp32 as the port's tiny preset keeps its weights), are seeded
with one image and run a two-chunk inference: frames as uint8, |delta| <= 1
on at least 99.9% of the values (tests/test_torch_pipeline.py). As in that
file's chain test, the non-rigid depth fit is shared and the port's second
chunk starts from JAX's last frame. The AR loop's hooks (``on_chunk``,
``cancel_event`` and ``GenerationCancelled``) must give JAX's calls. The
debug server is driven over HTTP through every endpoint, job states,
partial results and cancellation, as tests/test_serving.py drives
gen3c_tpu's; the deterministic endpoints must answer as gen3c_tpu's debug
server does, byte for byte, and a wire message dumped by either package
must load in the other and dump to the same bytes.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gen3c_tpu.pipelines import factory as jfactory
from gen3c_tpu.pipelines.chunked import GenerationCancelled as JaxCancelled
from gen3c_tpu.serving import api_types as japi
from gen3c_tpu.serving.encoding import CompressionFormat as JaxFormat
from gen3c_tpu.serving import models as jmodels
from gen3c_tpu.serving import serialization as jser
from gen3c_tpu.serving import server as jserver
from gen3c_tpu.utils import checkpoint as jckpt
from gen3c_tpu_torch.pipelines.chunked import GenerationCancelled
from gen3c_tpu_torch.serving import api_types as tapi
from gen3c_tpu_torch.serving import models as tmodels
from gen3c_tpu_torch.serving import serialization as tser
from gen3c_tpu_torch.serving import server as tserver
from gen3c_tpu_torch.serving.encoding import CompressionFormat
from tests.test_torch_checkpoint import weights  # noqa: F401
from tests.test_torch_pipeline import _assert_frames_close, shared_scale_map  # noqa: F401

torch.set_num_threads(2)


def _cameras(n, h, w, start=0.0):
    c2w = np.tile(np.eye(4, dtype=np.float32)[:3], (n, 1, 1))
    c2w[:, 0, 3] = np.linspace(start, start + 0.1, n)
    c2w[:, 1, 3] = np.linspace(start / 2, start / 2 + 0.05, n)
    fl = np.full((n, 2), 0.8 * w, np.float32)
    pp = np.full((n, 2), 0.5, np.float32)
    res = np.tile([[w, h]], (n, 1))
    return c2w, fl, pp, res


def _seed_request(api, h, w, seed=0, depths=None, rid="s"):
    c2w, fl, pp, _ = _cameras(1, h, w)
    rng = np.random.RandomState(seed)
    return api.SeedingRequest(request_id=rid, cameras_to_world=c2w, focal_lengths=fl,
                              principal_points=pp,
                              images=(rng.rand(1, h, w, 3) * 255).astype(np.uint8),
                              depths=depths)


def _inference_request(api, n, h, w, rid="i", start=0.0):
    """A request moving along x and y; ``start`` > 0 keeps every target
    camera off the seed's, where each point lands on an exact pixel and
    rounding decides the splat's corners."""
    c2w, fl, pp, res = _cameras(n, h, w, start)
    return api.InferenceRequest(request_id=rid, cameras_to_world=c2w, focal_lengths=fl,
                                principal_points=pp, resolutions=res)


@pytest.fixture(scope="module")
def models(weights, tmp_path_factory):  # noqa: F811
    """(JAX model, port model): gen3c_tiny, 2 steps, heuristic depth, both
    from one checkpoint directory."""
    tree, vae = weights
    ckpt = tmp_path_factory.mktemp("ckpt")
    jckpt.save_params_npz(str(ckpt / "gen3c_tpu" / "dit.npz"), tree)
    np.savez(ckpt / "gen3c_tpu" / "vae.npz", **vae)
    kw = dict(model_preset="gen3c_tiny", checkpoint_dir=str(ckpt), num_steps=2,
              depth_source="heuristic")
    real_build = jfactory.build_gen3c_model
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfactory, "build_gen3c_model",
                   lambda *a, **k: real_build(*a, param_dtype=jnp.float32, **k))
        jmodel = jmodels.Gen3cPersistentModel(**kw)
    return jmodel, tmodels.Gen3cPersistentModel(device="cpu", **kw)


def _align_second_chunk(monkeypatch, pipeline, want):
    """Give the port's second chunk JAX's seed frame (frame 8); returns the
    list that receives the port's own first chunk."""
    generate = pipeline.generate
    chunk1 = []

    def generate_then_align(*args, **kwargs):
        video, prompt = generate(*args, **kwargs)
        if not chunk1:
            chunk1.append(video.copy())
            video[-1] = want[8]
        return video, prompt

    monkeypatch.setattr(pipeline, "generate", generate_then_align)
    return chunk1


def test_persistent_model_two_chunk_inference_matches_jax(models, shared_scale_map,  # noqa: F811
                                                          monkeypatch):
    """Seed, then a 15-frame request (padded to 17 = two 9-frame chunks,
    trimmed back): the seed result, every on_chunk call, and the frames."""
    jm, tm = models
    h, w = tm.preset.height, tm.preset.width
    jseed = jm.seed_model(_seed_request(japi, h, w))
    tseed = tm.seed_model(_seed_request(tapi, h, w))
    np.testing.assert_allclose(tseed.depths, jseed.depths, rtol=1e-6)
    np.testing.assert_array_equal(tseed.resolutions, jseed.resolutions)
    jprog, tprog = [], []
    want = jm.run_inference(_inference_request(japi, 15, h, w),
                            on_chunk=lambda d, t, v: jprog.append((d, t, v.shape)))
    assert len(shared_scale_map) == 1  # chunk 2's update ran the non-rigid fit
    chunk1 = _align_second_chunk(monkeypatch, tm.pipeline, want.images)
    got = tm.run_inference(_inference_request(tapi, 15, h, w),
                           on_chunk=lambda d, t, v: tprog.append((d, t, v.shape)))
    assert not shared_scale_map
    assert tprog == jprog == [(1, 2, (9, h, w, 3)), (2, 2, (17, h, w, 3))]
    assert got.images.shape == want.images.shape == (15, h, w, 3)
    _assert_frames_close(chunk1[0], want.images[:9])
    _assert_frames_close(got.images[9:], want.images[9:])
    np.testing.assert_array_equal(got.cameras_to_world, want.cameras_to_world)
    np.testing.assert_array_equal(tm.get_latest_rgb(), got.images[-1])
    meta, jmeta = tm.metadata(), jm.metadata()
    assert meta["seeded"] and meta["chunk_size"] == 9
    assert meta["perf"]["solver"] == tm.pipeline.solver == jmeta["perf"]["solver"] == "euler"
    assert set(meta) == set(jmeta) and set(meta["perf"]) == set(jmeta["perf"])


def test_metadata_reports_the_pipeline_solver(models, monkeypatch):
    """/metadata's perf.solver is the pipeline's (serving/models.py:545),
    here a res2ab pipeline in both packages."""
    jm, tm = models
    monkeypatch.setattr(jm.pipeline, "solver", "res2ab")
    monkeypatch.setattr(tm.pipeline, "solver", "res2ab")
    assert tm.metadata()["perf"]["solver"] == jm.metadata()["perf"]["solver"] == "res2ab"


def test_render_preview_matches_jax(models):
    """/render-preview's frames: the seeded cache splatted along the path
    (K5's plain version here)."""
    jm, tm = models
    h, w = tm.preset.height, tm.preset.width
    jm.seed_model(_seed_request(japi, h, w, seed=4))
    tm.seed_model(_seed_request(tapi, h, w, seed=4))
    want = jm.render_preview(_inference_request(japi, 5, h, w, start=0.0137)).images
    got = tm.render_preview(_inference_request(tapi, 5, h, w, start=0.0137)).images
    _assert_frames_close(got, want)
    jpts, jcols = jm.get_point_cloud(3000)
    tpts, tcols = tm.get_point_cloud(3000)
    np.testing.assert_allclose(tpts, jpts, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tcols, jcols)


@pytest.mark.parametrize("native", [False, True])
def test_native_preview_matches_jax(models, monkeypatch, native):
    """GEN3C_PREVIEW_NATIVE=1: the host rasterizer (with 2 jittered samples
    accumulated) gives JAX's frames."""
    monkeypatch.setenv("GEN3C_PREVIEW_NATIVE", "1")
    monkeypatch.setenv("GEN3C_PREVIEW_SPP", "2" if native else "1")
    jm, tm = models
    h, w = tm.preset.height, tm.preset.width
    jm.seed_model(_seed_request(japi, h, w, seed=5))
    tm.seed_model(_seed_request(tapi, h, w, seed=5))
    want = jm.render_preview(_inference_request(japi, 3, h, w, start=0.0137)).images
    got = tm.render_preview(_inference_request(tapi, 3, h, w, start=0.0137)).images
    assert got.shape == (3, h, w, 3)
    _assert_frames_close(got, want)


def test_persistent_model_seeds_at_native_resolution(models):
    """A seed at the image's native resolution, with depths, is resized to
    the inference resolution (bicubic image, bilinear depth) and its K
    scaled, as gen3c_tpu does; the cache then serves a request."""
    jm, tm = models
    h, w = tm.preset.height, tm.preset.width
    nh, nw = 2 * h + 8, 2 * w + 16
    depths = (1.5 + np.random.RandomState(1).rand(1, nh, nw)).astype(np.float32)
    jres = jm.seed_model(_seed_request(japi, nh, nw, depths=depths))
    tres = tm.seed_model(_seed_request(tapi, nh, nw, depths=depths))
    assert tuple(tres.resolutions[0]) == tuple(jres.resolutions[0]) == (w, h)
    assert tm.cache.input_image.shape[-2:] == (h, w)
    np.testing.assert_array_equal(tm.cache.input_image.numpy(), np.asarray(jm.cache.input_image))
    np.testing.assert_allclose(tm.cache.input_points.numpy(), np.asarray(jm.cache.input_points),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tm._seed_frame, jm._seed_frame)
    result = tm.run_inference(_inference_request(tapi, 3, h, w))
    assert result.images.shape == (3, h, w, 3) and result.images.dtype == np.uint8


def test_seed_from_posed_frames_builds_cache4d(models, tmp_path):
    """Several posed RGBD frames with masks (a v2v directory through the
    client's loader) seed a Cache4D at the inference resolution, as in
    gen3c_tpu."""
    from PIL import Image

    from gen3c_tpu_torch.serving.client import load_seeding_directory

    jm, tm = models
    n, h, w = 3, 40, 64
    rng = np.random.RandomState(0)
    intr = np.tile(np.array([[0.9 * w, 0, w / 2], [0, 0.9 * w, h / 2], [0, 0, 1]], np.float32),
                   (n, 1, 1))
    w2c = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    w2c[:, 0, 3] = np.linspace(0, 0.2, n)
    np.savez(tmp_path / "depth.npz", depth=(1.5 + rng.rand(n, h, w)).astype(np.float16))
    np.savez(tmp_path / "mask.npz", mask=rng.rand(n, h, w) > 0.3)
    np.savez(tmp_path / "camera.npz", intrinsics=intr, w2c=w2c)
    (tmp_path / "rgb").mkdir()
    for i in range(n):
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
            tmp_path / "rgb" / f"{i:03d}.png")
    req = load_seeding_directory(str(tmp_path))
    assert req.images.shape == (n, h, w, 3) and req.masks.shape == (n, h, w)
    np.testing.assert_allclose(req.cameras_to_world[:, 0, 3], -w2c[:, 0, 3], atol=1e-6)
    tm.seed_model(req)
    jm.seed_model(jser.loads_api_message(tser.dumps_api_message(req)))
    assert type(tm.cache).__name__ == "Cache4D" and tm.cache.input_mask is not None
    np.testing.assert_array_equal(tm.cache.input_mask.numpy(), np.asarray(jm.cache.input_mask))
    np.testing.assert_array_equal(tm.cache.input_image.numpy(), np.asarray(jm.cache.input_image))


@pytest.mark.parametrize("when", ["before", "after_first_chunk"])
def test_cancel_hooks_match_jax(models, when):
    """A cancel_event set before the request, or by the first on_chunk
    call, raises GenerationCancelled in both packages after the same
    on_chunk calls."""
    jm, tm = models
    h, w = tm.preset.height, tm.preset.width
    calls = {}
    for name, m, api, cancelled in (("jax", jm, japi, JaxCancelled),
                                    ("port", tm, tapi, GenerationCancelled)):
        m.seed_model(_seed_request(api, h, w, seed=2))
        ev = threading.Event()
        if when == "before":
            ev.set()
        calls[name] = []

        def on_chunk(done, total, video, got=calls[name], ev=ev):
            got.append((done, total, len(video)))
            ev.set()

        with pytest.raises(cancelled):
            m.run_inference(_inference_request(api, 17, h, w), on_chunk=on_chunk,
                            cancel_event=ev)
    assert calls["port"] == calls["jax"] == ([] if when == "before" else [(1, 2, 9)])


# ---------------------------------------------------------------- the server


def _start(model, module=tserver):
    server, service = module.serve(host="127.0.0.1", port=0, model=model)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, service, f"http://127.0.0.1:{server.server_address[1]}"


def _stop(server, service):
    server.shutdown()
    server.server_close()
    service.shutdown()


@pytest.fixture(scope="module")
def debug_servers():
    """(port base URL, JAX base URL): each package's debug model served."""
    port = _start(tmodels.DebugInferenceModel())
    jax_ = _start(jmodels.DebugInferenceModel(), jserver)
    yield port[2], jax_[2]
    _stop(*port[:2])
    _stop(*jax_[:2])


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get(url):
    try:
        with urllib.request.urlopen(url) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _wait_result(base, rid, tries=200):
    for _ in range(tries):
        status, body = _get(f"{base}/inference-result?request_id={rid}")
        if status == 200:
            return body
        assert status == 503
        time.sleep(0.02)
    raise AssertionError(f"no result for {rid}")


def test_metadata_endpoint(debug_servers):
    status, body = _get(f"{debug_servers[0]}/metadata")
    assert status == 200 and json.loads(body)["model"] == "DebugInferenceModel"


def test_seed_and_infer_roundtrip(debug_servers):
    base = debug_servers[0]
    h, w = 32, 48
    status, body = _post(f"{base}/seed-model",
                         tser.dumps_api_message(_seed_request(tapi, h, w, rid="seed-1")))
    assert status == 200 and tser.loads_api_message(body).depths.shape == (1, h, w)
    status, _ = _post(f"{base}/request-inference",
                      tser.dumps_api_message(_inference_request(tapi, 5, h, w, "job-1")))
    assert status == 202
    result = tser.loads_api_message(_wait_result(base, "job-1"))
    assert result.images.shape == (5, h, w, 3)
    status, body = _get(f"{base}/image?format=png")
    assert status == 200 and body[:4] == b"\x89PNG"
    status, body = _get(f"{base}/image?format=jpg")
    assert status == 200 and body[:2] == b"\xff\xd8"
    status, body = _get(f"{base}/image?format=pickle")
    assert status == 200 and body[:1] == b"\x80"  # a pickle of {"image": frame}
    assert _get(f"{base}/image?format=bmp")[0] == 400


def test_sync_inference(debug_servers):
    status, body = _post(f"{debug_servers[0]}/request-inference?sync=1",
                         tser.dumps_api_message(_inference_request(tapi, 3, 32, 48, "job-sync")))
    assert status == 200 and tser.loads_api_message(body).images.shape == (3, 32, 48, 3)


def test_bad_message_rejected(debug_servers):
    base = debug_servers[0]
    assert _post(f"{base}/seed-model", b"not json")[0] == 400
    assert _post(f"{base}/seed-model", json.dumps({"__type__": "EvilType"}).encode())[0] == 400
    assert _post(f"{base}/request-inference", b"{}")[0] == 400
    assert _get(f"{base}/nowhere")[0] == 404
    assert _post(f"{base}/nowhere", b"")[0] == 404
    assert _get(f"{base}/job-status?request_id=unknown")[0] == 404


@pytest.mark.parametrize("fmt", ["jpg", "png", "npz", "avi"])
def test_inference_result_formats(debug_servers, fmt):
    """?format= compresses the result's frames; they decompress to the
    frames within the format's loss (floats in [0, 1]; npz gives back the
    uint8 frames). exr, depth only, and unknown formats are refused."""
    base = debug_servers[0]
    rid = f"job-{fmt}"
    _post(f"{base}/request-inference", tser.dumps_api_message(_inference_request(tapi, 8, 32, 48,
                                                                                 rid)))
    raw = tser.loads_api_message(_wait_result(base, rid))
    status, body = _get(f"{base}/inference-result?request_id={rid}&format={fmt}")
    assert status == 200
    result = tser.loads_api_message(body)
    assert result.images_format == CompressionFormat(fmt)
    result.decompress()
    if fmt == "npz":  # lossless, and decoded as the uint8 it carries
        np.testing.assert_array_equal(result.images, raw.images)
    err = np.abs(result.images.astype(np.float32) / (255.0 if fmt == "npz" else 1.0)
                 - raw.images.astype(np.float32) / 255.0)
    assert result.images.shape == raw.images.shape and err.mean() < 0.02, err.mean()
    assert _get(f"{base}/inference-result?request_id={rid}&format=exr")[0] == 400
    assert _get(f"{base}/inference-result?request_id={rid}&format=gif")[0] == 400


def test_viewer_and_geometry_endpoints(debug_servers):
    base = debug_servers[0]
    code, body = _get(f"{base}/viewer")
    assert code == 200 and b"GEN3C" in body and b"<html>" in body
    assert _get(f"{base}/")[0] == 200
    code, body = _get(f"{base}/point-cloud?max_points=1000")
    assert code == 200
    pc = json.loads(body)
    pts, cols = tser._decode_value(pc["points"]), tser._decode_value(pc["colors"])
    assert pts.shape == (1000, 3) and cols.shape == (1000, 3)
    np.testing.assert_allclose(np.linalg.norm(pts, axis=1), 1.0, atol=1e-5)
    code, body = _get(f"{base}/trajectory?type=left&n=9")
    assert code == 200
    t = json.loads(body)
    assert len(t["c2ws"]) == 9 and len(t["c2ws"][0]) == 3 and len(t["focal_lengths"]) == 9
    assert _get(f"{base}/trajectory?type=sideways")[0] == 400
    kfs = {"keyframes": [{"c2w": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0], "t": 0},
                         {"c2w": [1, 0, 0, 1.0, 0, 1, 0, 0, 0, 0, 1, 0], "t": 1}], "n": 5}
    code, body = _post(f"{base}/interpolate-path", json.dumps(kfs).encode())
    assert code == 200
    xs = [c[0][3] for c in json.loads(body)["c2ws"]]
    assert len(xs) == 5 and xs[0] <= xs[-1] and abs(xs[-1] - 1.0) < 0.3
    assert _post(f"{base}/interpolate-path", b"garbage")[0] == 400
    code, saved = _post(f"{base}/camera-path/save", json.dumps(kfs).encode())
    assert code == 200
    code, body = _post(f"{base}/camera-path/load", saved)
    assert code == 200
    loaded = json.loads(body)["keyframes"]
    assert len(loaded) == 2
    np.testing.assert_allclose(np.asarray(loaded[1]["c2w"]).reshape(-1), kfs["keyframes"][1]["c2w"],
                               atol=1e-5)
    assert _post(f"{base}/camera-path/load", b"{")[0] == 400


def test_render_preview_endpoint_needs_a_seed(debug_servers, models):
    """/render-preview: 400 on a model without it (the debug model) and on
    a bad message; /clear-cache answers."""
    base = debug_servers[0]
    body = tser.dumps_api_message(_inference_request(tapi, 3, 32, 48, "pv"))
    assert _post(f"{base}/render-preview", body)[0] == 400
    assert _post(f"{base}/render-preview", b"junk")[0] == 400
    assert _post(f"{base}/clear-cache", b"")[0] == 200
    tm = models[1]
    tm.seed_model(_seed_request(tapi, tm.preset.height, tm.preset.width, seed=6))
    server, service, url = _start(tm)
    try:
        h, w = tm.preset.height, tm.preset.width
        status, got = _post(f"{url}/render-preview",
                            tser.dumps_api_message(_inference_request(tapi, 4, h, w, "pv")))
        assert status == 200 and tser.loads_api_message(got).images.shape == (4, h, w, 3)
        assert _post(f"{url}/clear-cache", b"")[0] == 200
        assert _post(f"{url}/render-preview",
                     tser.dumps_api_message(_inference_request(tapi, 4, h, w, "pv")))[0] == 400
        assert json.loads(_get(f"{url}/metadata")[1])["seeded"] is False
    finally:
        _stop(server, service)


@pytest.mark.parametrize("path,body", [
    ("GET /point-cloud?max_points=500", None),
    ("GET /trajectory?type=left&n=9&distance=0.2", None),
    ("GET /trajectory?type=clockwise&n=5", None),
    ("GET /viewer", None),
    ("POST /interpolate-path", {"keyframes": [
        {"c2w": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0], "t": 0, "fov": 40},
        {"c2w": [0.96, 0, 0.28, 1.0, 0, 1, 0, 0.1, -0.28, 0, 0.96, 0.3], "t": 1},
        {"c2w": [1, 0, 0, 2.0, 0, 1, 0, 0, 0, 0, 1, 0.5], "t": 2.5}], "n": 11}),
    ("POST /camera-path/save", {"keyframes": [
        {"c2w": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0]},
        {"c2w": [1, 0, 0, 1.0, 0, 1, 0, 0, 0, 0, 1, 0], "fov": 60}]}),
    ("POST /seed-model", "seed"),
    ("POST /request-inference?sync=1", "infer"),
])
def test_endpoints_answer_as_jax(debug_servers, path, body):
    """The deterministic endpoints of both debug servers: the same status
    and the same bytes (the viewer page names its own package)."""
    method, route = path.split(" ")
    if body == "seed":
        data = [tser.dumps_api_message(_seed_request(tapi, 24, 40, rid="x"))] * 2
    elif body == "infer":
        data = [tser.dumps_api_message(_inference_request(tapi, 4, 24, 40, "sync-x"))] * 2
    else:
        data = [None if body is None else json.dumps(body).encode()] * 2
    answers = [(_get(base + route) if method == "GET" else _post(base + route, d))
               for base, d in zip(debug_servers, data)]
    assert answers[0][0] == answers[1][0] == 200
    assert answers[0][1] == answers[1][1].replace(b"gen3c_tpu.", b"gen3c_tpu_torch.")


class _SlowChunkedModel(tmodels.DebugInferenceModel):
    """Emits frames chunk by chunk with a delay: progress, partial results
    and cancellation."""

    def __init__(self, n_chunks=4, chunk_delay_s=0.15, **kw):
        super().__init__(**kw)
        self.n_chunks = n_chunks
        self.chunk_delay_s = chunk_delay_s
        self.ran = []

    def run_inference(self, req, on_chunk=None, cancel_event=None):
        self.ran.append(req.request_id)
        result = super().run_inference(req)
        n = len(result.images)
        per = max(1, n // self.n_chunks)
        for c in range(self.n_chunks):
            if cancel_event is not None and cancel_event.is_set():
                raise GenerationCancelled()
            time.sleep(self.chunk_delay_s)
            done = min(n, (c + 1) * per) if c < self.n_chunks - 1 else n
            if on_chunk is not None:
                on_chunk(c + 1, self.n_chunks, result.images[:done])
        return result


@pytest.fixture()
def slow_server():
    model = _SlowChunkedModel()
    server, service, url = _start(model)
    yield url, model
    _stop(server, service)


def _submit(base, rid, n=8):
    status, _ = _post(f"{base}/request-inference",
                      tser.dumps_api_message(_inference_request(tapi, n, 32, 48, rid)))
    assert status == 202


def _state(base, rid):
    status, body = _get(f"{base}/job-status?request_id={rid}")
    assert status == 200
    return json.loads(body)


def test_job_status_and_partial_results(slow_server):
    base, _ = slow_server
    _submit(base, "prog-1")
    saw_running = saw_partial = False
    for _ in range(200):
        st = _state(base, "prog-1")
        if st["state"] == "running" and 0 < st["progress"] < 1:
            saw_running = True
            code, body = _get(f"{base}/inference-result?request_id=prog-1&partial=1")
            if code == 206:
                part = tser.loads_api_message(body)
                assert 0 < len(part.images) <= 8
                assert len(part.cameras_to_world) == len(part.images)
                saw_partial = True
        if st["state"] == "done":
            break
        time.sleep(0.02)
    assert st["state"] == "done" and st["progress"] == 1.0
    assert saw_running and saw_partial
    assert len(tser.loads_api_message(_wait_result(base, "prog-1")).images) == 8
    # a finished job has no partial: the whole result answers
    assert _get(f"{base}/inference-result?request_id=prog-1&partial=1")[0] == 200


def test_cancel_running_job(slow_server):
    base, _ = slow_server
    _submit(base, "cancel-1")
    for _ in range(100):
        if _state(base, "cancel-1")["state"] == "running":
            break
        time.sleep(0.02)
    assert _post(f"{base}/cancel-inference?request_id=cancel-1", b"")[0] == 200
    for _ in range(200):
        st = _state(base, "cancel-1")
        if st["state"] == "cancelled":
            break
        time.sleep(0.02)
    assert st["state"] == "cancelled"
    assert _get(f"{base}/inference-result?request_id=cancel-1")[0] == 503
    assert _get(f"{base}/inference-result?request_id=cancel-1&partial=1")[0] == 503
    assert _post(f"{base}/cancel-inference?request_id=cancel-1", b"")[0] == 404
    assert _post(f"{base}/cancel-inference?request_id=nope", b"")[0] == 404


def test_cancel_pending_job(slow_server):
    base, model = slow_server
    _submit(base, "run-first")
    _submit(base, "queued")  # waits behind run-first
    assert _post(f"{base}/cancel-inference?request_id=queued", b"")[0] == 200
    for _ in range(300):
        if _state(base, "run-first")["state"] == "done":
            break
        time.sleep(0.02)
    assert _state(base, "queued")["state"] == "cancelled"
    _submit(base, "after")  # the worker goes on to the next job
    _wait_result(base, "after", tries=300)
    assert model.ran == ["run-first", "after"]  # the cancelled job never ran


def test_failed_job_reports_its_error():
    class _Failing(tmodels.DebugInferenceModel):
        def run_inference(self, req, on_chunk=None, cancel_event=None):
            raise RuntimeError("boom")

    server, service, base = _start(_Failing())
    try:
        _submit(base, "bad")
        for _ in range(100):
            st = _state(base, "bad")
            if st["state"] == "error":
                break
            time.sleep(0.02)
        assert st["state"] == "error" and st["error"] == "boom"
        code, body = _get(f"{base}/inference-result?request_id=bad")
        assert code == 500 and body == b"boom"
    finally:
        _stop(server, service)


def test_parse_guidance_interval_env():
    parse = tserver.parse_guidance_interval_env
    for value in ("", "  ", "1.75,81", " 0.1 , 2.0 "):
        assert parse(value) == jserver.parse_guidance_interval_env(value)
    assert parse("1.75,81") == (1.75, 81.0)
    with pytest.raises(ValueError, match="lo,hi"):
        parse("1.75")
    with pytest.raises(ValueError, match="0 <= lo <= hi"):
        parse("5,1")


def test_build_model_from_env(monkeypatch):
    monkeypatch.setenv("GEN3C_API_DEBUG", "1")
    assert isinstance(tserver.build_model_from_env(), tmodels.DebugInferenceModel)
    monkeypatch.setenv("GEN3C_API_DEBUG", "0")
    for key, value in (("GEN3C_MODEL_PRESET", "gen3c_tiny"), ("GEN3C_CHECKPOINT_DIR", ""),
                       ("GEN3C_NUM_STEPS", "3"), ("GEN3C_DEPTH_SOURCE", "heuristic"),
                       ("GEN3C_GUIDANCE_INTERVAL", "1.75,81"), ("GEN3C_ATTN_WINDOW", "1"),
                       ("GEN3C_STEP_CACHE_INTERVAL", "2"), ("GEN3C_OFFLOAD_DIT", "1")):
        monkeypatch.setenv(key, value)
    model = tserver.build_model_from_env(device="cpu")
    assert isinstance(model, tmodels.Gen3cPersistentModel) and model.device.type == "cpu"
    perf = model.metadata()["perf"]
    assert perf["attn_temporal_window"] == 1 and perf["guidance_interval"] == [1.75, 81.0]
    assert perf["step_cache_interval"] == 2 and model.pipeline.num_steps == 3


# ------------------------------------------------------------ the wire format


def _messages(api):
    h, w = 12, 20
    rng = np.random.RandomState(3)
    c2w, fl, pp, res = _cameras(3, h, w)
    images = (rng.rand(3, h, w, 3) * 255).astype(np.uint8)
    depths = (1 + rng.rand(3, h, w)).astype(np.float32)
    seed = api.SeedingRequest(request_id="w1", cameras_to_world=c2w, focal_lengths=fl,
                              principal_points=pp, resolutions=res, images=images,
                              depths=depths, masks=(depths > 1.5).astype(np.float32))
    inf = api.InferenceRequest(request_id="w2", cameras_to_world=c2w, focal_lengths=fl,
                               principal_points=pp, resolutions=res, prompt="a hill",
                               return_depths=True)
    result = api.InferenceResult(request_id="w2", cameras_to_world=c2w, focal_lengths=fl,
                                 principal_points=pp, resolutions=res, images=images,
                                 depths=depths, runtime_ms=12.5)
    return {"seed": seed, "seed_result": api.SeedingResult.from_request(seed, None),
            "inference": inf, "result": result, "result_png": "png", "result_avi": "avi",
            "result_npz": "npz"}


@pytest.mark.parametrize("kind", ["seed", "seed_result", "inference", "result", "result_png",
                                  "result_avi", "result_npz"])
def test_wire_messages_cross_load(kind):
    """A message dumped by either package loads in the other, and both
    packages dump it to the same bytes."""
    ours, theirs = _messages(tapi)[kind], _messages(japi)[kind]
    if isinstance(ours, str):  # a compressed result
        fmt = ours
        ours = _messages(tapi)["result"].compress(format_rgb=CompressionFormat(fmt))
        theirs = _messages(japi)["result"].compress(format_rgb=JaxFormat(fmt))
    got, want = tser.dumps_api_message(ours), jser.dumps_api_message(theirs)
    assert got == want
    back_in_jax = jser.loads_api_message(got)
    back_in_port = tser.loads_api_message(want)
    assert type(back_in_jax).__name__ == type(back_in_port).__name__ == type(ours).__name__
    assert tser.dumps_api_message(back_in_port) == jser.dumps_api_message(back_in_jax) == got
