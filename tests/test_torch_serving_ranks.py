"""The served GEN3C model over several ranks (``serving.models.
Gen3cPersistentModel(num_devices=2)``) against gen3c_tpu's on the CPU.

gen3c_tpu serves over several devices from one SPMD process
(``Gen3cPersistentModel(num_devices=2)``, tests/test_serving.py:609); the
port runs one process per rank: rank 0 serves, rank 1 follows its calls
over the model's gloo channel. Two spawned gloo ranks
(``tests/torch_cp_ranks.py``) load the checkpoint directory that JAX's
model loads (gen3c_tiny, fp32, 2 steps, heuristic depth) and serve it with
``parallel`` "cp" (Ulysses) and "tp". The frames (uint8) of a seeded
two-chunk request must be within |delta| <= 1 on 99.9% of the values
(tests/test_torch_pipeline.py's bound) of JAX's two-device model's and of
the port's one process's, on both ranks; as there, the non-rigid depth fit
is shared and the second chunk starts from JAX's last frame of the first.
A cancel set by the first chunk stops both ranks after it, and the next
request runs; a cleared cache refuses a request until a reseed; the HTTP
server on rank 0 answers a whole round trip through its worker thread and
its shutdown returns rank 1 from ``follow()``.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gen3c_tpu.pipelines import factory as jfactory
from gen3c_tpu.serving import api_types as japi
from gen3c_tpu.serving import models as jmodels
from gen3c_tpu.utils import checkpoint as jckpt
from gen3c_tpu_torch.pipelines.factory import GEN3C_TINY_PRESET
from gen3c_tpu_torch.serving import api_types as tapi
from gen3c_tpu_torch.serving import models as tmodels
from gen3c_tpu_torch.serving.serialization import dumps_api_message
from tests import torch_cp_ranks
from tests.test_torch_checkpoint import weights  # noqa: F401
from tests.test_torch_pipeline import _assert_frames_close
from tests.test_torch_serving import _inference_request, _seed_request

torch.set_num_threads(2)
H, W = GEN3C_TINY_PRESET.height, GEN3C_TINY_PRESET.width


@pytest.fixture(scope="module")
def ranks():
    pool = torch_cp_ranks.Ranks(2)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def ckpt(weights, tmp_path_factory):  # noqa: F811
    tree, vae = weights
    path = tmp_path_factory.mktemp("ckpt")
    jckpt.save_params_npz(str(path / "gen3c_tpu" / "dit.npz"), tree)
    np.savez(path / "gen3c_tpu" / "vae.npz", **vae)
    return str(path)


KW = dict(model_preset="gen3c_tiny", num_steps=2, depth_source="heuristic")


@pytest.fixture(scope="module")
def one_process(ckpt):
    return tmodels.Gen3cPersistentModel(device="cpu", checkpoint_dir=ckpt, **KW)


def _jax_run(ckpt, parallel, monkeypatch):
    """JAX's two-device model: the seed's depths, the 15-frame request's
    frames and its non-rigid fits."""
    import gen3c_tpu.ops.camera as jcam

    real_build = jfactory.build_gen3c_model
    monkeypatch.setattr(jfactory, "build_gen3c_model",
                        lambda *a, **k: real_build(*a, param_dtype=jnp.float32, **k))
    model = jmodels.Gen3cPersistentModel(checkpoint_dir=ckpt, num_devices=2, parallel=parallel,
                                         cp_attn="ulysses" if parallel == "cp" else None, **KW)
    fits = []
    fit = jcam._nonrigid_scale_map

    def record(*args):
        out = fit(*args)
        fits.append(np.asarray(out))
        return out

    monkeypatch.setattr(jcam, "_nonrigid_scale_map", record)
    seeded = model.seed_model(_seed_request(japi, H, W))
    frames = model.run_inference(_inference_request(japi, 15, H, W)).images
    assert len(fits) == 1
    return seeded.depths, frames, fits


def _one_process_run(model, want, fits, monkeypatch):
    """The port's one process on the same alignment: (first chunk, frames)."""
    import gen3c_tpu_torch.ops.camera as tcam

    queue = [torch.from_numpy(np.array(f)) for f in fits]
    monkeypatch.setattr(tcam, "_nonrigid_scale_map", lambda *args: queue.pop(0))
    generate = model.pipeline.generate
    first = []

    def aligned(*args, **kwargs):
        video, prompt = generate(*args, **kwargs)
        if not first:
            first.append(video.copy())
            video[-1] = want[8]
        return video, prompt

    monkeypatch.setattr(model.pipeline, "generate", aligned)
    model.seed_model(_seed_request(tapi, H, W))
    frames = model.run_inference(_inference_request(tapi, 15, H, W)).images
    return first[0], frames


@pytest.mark.parametrize("parallel", ["cp", "tp"])
def test_served_ranks_match_jax_and_one_process(ranks, ckpt, one_process, monkeypatch,
                                                parallel):
    depths, want, fits = _jax_run(ckpt, parallel, monkeypatch)
    one_first, one = _one_process_run(one_process, want, fits, monkeypatch)
    got = ranks.run("serving_session", parallel=parallel, ckpt=ckpt,
                    seed_req=_seed_request(tapi, H, W), req=_inference_request(tapi, 15, H, W),
                    cancel_req=_inference_request(tapi, 17, H, W, rid="c"),
                    next_req=_inference_request(tapi, 9, H, W, rid="n", start=0.0137),
                    align=[want[8]], scale_maps=fits)
    lead, follower = got
    assert lead["leads"] and not follower["leads"]
    np.testing.assert_allclose(lead["seed_depths"], depths, rtol=1e-6)
    assert lead["progress"] == [(1, 2, 9), (2, 2, 17)]
    for r in got:
        frames = r["outcomes"][0]["frames"]
        assert frames.shape == (15, H, W, 3) and r["outcomes"][0]["chunks"] == 2
        _assert_frames_close(r["first_chunk"], want[:9])
        _assert_frames_close(frames[9:], want[9:])
        _assert_frames_close(r["first_chunk"], one_first)
        _assert_frames_close(frames, one)
    # the cancel: set by rank 0's first chunk, both ranks stop after it
    assert lead["cancel"] == "GenerationCancelled" and lead["cancelled_after"] == [1]
    for r in got:
        assert r["outcomes"][1] == {"error": "GenerationCancelled", "chunks": 1}
        assert [o["frames"].shape for o in r["outcomes"][2:]] == [(9, H, W, 3)] * 2
        assert len(r["outcomes"]) == 4  # the request after clear_cache ran nowhere
    assert lead["after_clear"] == "refused"
    assert follower["calls"] == 7  # seed, 3 runs, clear, seed, run
    for a, b in zip(lead["outcomes"], follower["outcomes"]):
        if "frames" in a:
            np.testing.assert_array_equal(a["frames"], b["frames"])


@pytest.mark.parametrize("parallel", ["cp", "tp"])
def test_http_round_trip_over_two_ranks(ranks, ckpt, parallel):
    seed = dumps_api_message(_seed_request(tapi, H, W, seed=3))
    req = dumps_api_message(_inference_request(tapi, 9, H, W, rid="http", start=0.0137))
    lead, follower = ranks.run("serving_http", parallel=parallel, ckpt=ckpt, seed_wire=seed,
                               req_wire=req)
    assert lead["state"] == "done" and lead["seeded"] and lead["cache_after_clear"]
    assert lead["codes"] == {"seed": 200, "submit": 202, "result": 200, "preview": 200,
                             "clear": 200}
    assert lead["frames"].shape == (9, H, W, 3) and lead["frames"].dtype == np.uint8
    assert follower["calls"] == 3  # seed, the job, clear (the preview stays on rank 0)


def test_one_process_leads_and_follows_nothing(one_process):
    """One process: it leads, has no channel, refuses to follow; its
    shutdown does nothing."""
    assert one_process.leads and one_process.channel is None
    with pytest.raises(RuntimeError, match="leads"):
        one_process.follow()
    one_process.shutdown()
    meta = json.loads(json.dumps(one_process.metadata()))
    assert meta["model"] == "Gen3cPersistentModel"
