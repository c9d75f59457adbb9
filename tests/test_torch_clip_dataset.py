"""The port's packaged-clip dataset and the training CLI's --data_root
against gen3c_tpu on the CPU, at gen3c_tiny.

The JAX factory's tiny VAE (fp32) is bridged into the port. The 3D cache
of a training batch adds no noise (``noise_aug_strength`` is 0 in both
packages' ``build_gen3c_train_batch``), so there is no jax.random draw to
inject. Tolerances: loaders and the clip picks exactly; x0 (the VAE
latent of the clip) atol 1e-5; extra_channels (the VAE latents of the
splatted warps) atol 1e-4 except at splat ties, where a target on an exact
pixel boundary may fall to either side: at most 0.1% of the elements, as
tests/test_torch_geometry_cache.py allows for the renders (without a
mask; with one, see test_build_gen3c_train_batch_matches_jax).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gen3c_tpu.pipelines import data_loaders as jloaders
from gen3c_tpu.pipelines import factory as jfactory
from gen3c_tpu.training import datasets as jds
from gen3c_tpu_torch.bridge import vae_state_from_jax
from gen3c_tpu_torch.ops.camera import generate_camera_trajectory
from gen3c_tpu_torch.pipelines import data_loaders as tloaders
from gen3c_tpu_torch.pipelines import factory as tfactory
from gen3c_tpu_torch.pipelines.depth import default_intrinsics
from gen3c_tpu_torch.training import datasets as tds

torch.set_num_threads(2)


def _clip(frames, h, w, seed, mask=False):
    """A seeded RGBD clip along a camera trajectory: (image, depth, mask,
    w2c, intrinsics) as a packaged clip holds them."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    image = rng.uniform(-1, 1, (frames, 3, h, w)).astype(np.float32)
    depth = np.repeat((2.5 - 0.8 * yy + 0.3 * np.sin(6 * xx))[None, None], frames, 0)
    depth = (depth * rng.uniform(0.9, 1.1, (frames, 1, 1, 1))).astype(np.float32)
    k = default_intrinsics(h, w)
    w2c, ks = generate_camera_trajectory("left", np.eye(4, dtype=np.float32), k, frames, 0.3,
                                         "center_facing", 1.0)
    m = (rng.uniform(size=(frames, 1, h, w)) > 0.1).astype(np.float32) if mask else None
    return (image, depth, m, np.asarray(w2c, np.float32).reshape(frames, 4, 4),
            np.asarray(ks, np.float32).reshape(frames, 3, 3))


def _write_npz(path, clip):
    image, depth, mask, w2c, k = clip
    arrays = dict(image=image, depth=depth, w2c=w2c, intrinsics=k)
    if mask is not None:
        arrays["mask"] = mask
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def models():
    jmodel, preset = jfactory.build_gen3c_model("gen3c_tiny", checkpoint_dir=None, seed=0,
                                                param_dtype=jnp.float32)
    tmodel, _ = tfactory.build_gen3c_model("gen3c_tiny", device="cpu", seed=0)
    tmodel.tokenizer.vae.load_state_dict(
        vae_state_from_jax({k: np.asarray(v) for k, v in jmodel.tokenizer.params.items()}))
    return jmodel, tmodel, preset


@pytest.mark.parametrize("fmt,mask", [("npz", False), ("npz", True), ("pt", True), ("pt", False)])
def test_packaged_loader_matches_jax(tmp_path, fmt, mask):
    clip = _clip(5, 16, 24, seed=1, mask=mask)
    path = str(tmp_path / f"clip.{fmt}")
    if fmt == "npz":
        _write_npz(path, clip)
    else:
        torch.save(tuple(None if a is None else torch.from_numpy(a) for a in clip), path)
    got, want = tloaders.load_data_packaged_format(path), jloaders.load_data_packaged_format(path)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)


def test_packaged_pt_needs_five_tensors(tmp_path):
    path = str(tmp_path / "bad.pt")
    torch.save((torch.zeros(1),) * 4, path)
    with pytest.raises(ValueError, match="5 tensors"):
        tloaders.load_data_packaged_format(path)


@pytest.mark.parametrize("lo,hi", [(0.0, 255.0), (0.0, 1.0), (-1.0, 1.0), (-0.5, 0.9)])
def test_to_signed_range_matches_jax(lo, hi):
    video = np.random.default_rng(2).uniform(lo, hi, (3, 3, 4, 5)).astype(np.float32)
    np.testing.assert_array_equal(tds._to_signed_range(video, "x"),
                                  jds._to_signed_range(video, "x"))


@pytest.mark.parametrize("mask,t5,cond", [(False, False, 1), (True, True, 2)])
def test_build_gen3c_train_batch_matches_jax(models, monkeypatch, mask, t5, cond):
    """The batch of one clip: cache from frame 0, warps along the clip's own
    cameras, the clip and the warps VAE-encoded, the condition mask.

    With a mask, frame 0 renders into its own camera, where every splat
    target lies within rounding of a pixel and a masked pixel's only weight
    may be a ~1e-6 spill from its neighbour: the two packages then disagree
    on whether it is known (0.3% of the rendered mask), and the random VAE
    spreads each such pixel over every warp latent. So with a mask the
    caches' inputs are held equal and the warp latents are compared only
    without one."""
    import gen3c_tpu.cache as jcache_mod
    import gen3c_tpu_torch.cache.cache3d as tcache_mod

    caches = {}
    for tag, mod in (("jax", jcache_mod), ("torch", tcache_mod)):
        class Recorded(mod.Cache3DBuffer):
            def __init__(self, *args, _tag=tag, **kw):
                super().__init__(*args, **kw)
                caches[_tag] = self

        monkeypatch.setattr(mod, "Cache3DBuffer", Recorded)
    jmodel, tmodel, preset = models
    image, depth, m, w2c, k = _clip(preset.chunk_size, preset.height, preset.width, seed=3,
                                    mask=mask)
    emb = np.random.default_rng(4).standard_normal((512, 1024)).astype(np.float32) if t5 else None
    want = jds.build_gen3c_train_batch(jmodel, image, depth, w2c, k, t5_embedding=emb, mask=m,
                                       num_condition_t=cond, seed=5)
    got = tds.build_gen3c_train_batch(tmodel, image, depth, w2c, k, t5_embedding=emb, mask=m,
                                      num_condition_t=cond, seed=5)
    assert set(got) == set(want) == {"x0", "crossattn_emb", "extra_channels"}
    for key in want:
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32, key
    np.testing.assert_allclose(got["x0"].numpy(), np.asarray(want["x0"]), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["crossattn_emb"].numpy(), np.asarray(want["crossattn_emb"]))
    tc, jc = caches["torch"], caches["jax"]
    assert tc.frame_buffer_max == jc.frame_buffer_max == 2
    np.testing.assert_allclose(tc.input_points.numpy(), np.asarray(jc.input_points), atol=1e-5)
    if mask:
        np.testing.assert_array_equal(tc.input_mask.numpy(), np.asarray(jc.input_mask))
        np.testing.assert_array_equal(got["extra_channels"][:, :1].numpy(),
                                      np.asarray(want["extra_channels"])[:, :1])
    else:
        assert tc.input_mask is None and jc.input_mask is None
        d = np.abs(got["extra_channels"].numpy() - np.asarray(want["extra_channels"]))
        assert (d > 1e-4).mean() <= 1e-3, ((d > 1e-4).mean(), d.max())
    ind = got["extra_channels"][0, 0, :, 0, 0]
    assert ind.tolist() == [1.0] * cond + [0.0] * (ind.numel() - cond)
    with pytest.raises(ValueError):
        tds.build_gen3c_train_batch(tmodel, image[:-1], depth[:-1], w2c[:-1], k[:-1])


def test_clip_dataset_picks_as_jax(models, tmp_path, monkeypatch):
    """Gen3CClipDataset draws the same clips, windows and cache seeds as
    gen3c_tpu's from the same seed (both numpy RandomState), reads the .t5.npy
    beside a clip, and stacks a batch of 2."""
    jmodel, tmodel, preset = models
    for i, frames in enumerate((12, 9, 15)):
        _write_npz(tmp_path / f"c{i}.npz", _clip(frames, 16, 24, seed=10 + i, mask=i == 1))
    np.save(tmp_path / "c2.t5.npy", np.full((512, 1024), 0.5, np.float32))
    calls = {"jax": [], "torch": []}

    def recorder(tag):
        def build(model, image, depth, w2c, k, t5_embedding=None, mask=None, seed=0, **kw):
            calls[tag].append((image.copy(), w2c.copy(), None if t5_embedding is None else
                               float(t5_embedding.mean()), mask is not None, seed))
            xp = np if tag == "jax" else torch  # what each package's iterator concatenates
            return {"x0": xp.full((1, 1), float(seed)), "crossattn_emb": xp.zeros((1, 1)),
                    "extra_channels": xp.zeros((1, 1))}
        return build

    monkeypatch.setattr(jds, "build_gen3c_train_batch", recorder("jax"))
    monkeypatch.setattr(tds, "build_gen3c_train_batch", recorder("torch"))
    jit = iter(jds.Gen3CClipDataset(str(tmp_path), jmodel, batch_size=2, seed=7))
    for _ in range(4):
        next(jit)
    tit = iter(tds.Gen3CClipDataset(str(tmp_path), tmodel, batch_size=2, seed=7))
    batches = [next(tit) for _ in range(4)]
    assert len(calls["torch"]) == len(calls["jax"]) == 8
    for (gi, gw, gt, gm, gs), (wi, ww, wt, wm, ws) in zip(calls["torch"], calls["jax"]):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gw, ww)
        assert (gt, gm, gs) == (wt, wm, ws)
    assert any(t == 0.5 for _, _, t, _, _ in calls["torch"])
    assert all(b["x0"].shape == (2, 1) for b in batches)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        tds.Gen3CClipDataset(str(tmp_path / "empty"), tmodel)


def test_cli_data_root_trains_on_packaged_clips(tmp_path):
    """--data_root --device cpu with the band (dit.attn_temporal_window=1):
    two steps on a packaged clip through Gen3CClipDataset, the trained DiT
    being the GEN3C model's own (one DiT)."""
    from gen3c_tpu_torch.training import train

    preset = tfactory.PRESETS["gen3c_tiny"]
    data = tmp_path / "clips"
    data.mkdir()
    _write_npz(data / "a.npz", _clip(preset.chunk_size + 2, preset.height, preset.width, seed=20))
    trainer = train.main(["--data_root", str(data), "--device", "cpu", "--remat",
                          "experiment=gen3c_tiny", "dit.attn_temporal_window=1",
                          "trainer.max_iter=2", "trainer.warmup_steps=1",
                          "trainer.prefetch_batches=0", f"trainer.job_dir={tmp_path / 'job'}"])
    assert trainer.state.step == 2 and trainer.dit_cfg.attn_temporal_window == 1
    assert trainer.state.params.cfg.attn_temporal_window == 1
    assert trainer.checkpointer.steps() == [2]


def test_cli_targets_the_card_by_default(tmp_path):
    """No --device: the CLI trains on cuda, and without a card it raises
    instead of falling back to the CPU."""
    from gen3c_tpu_torch.training import train

    args = ["--synthetic", "experiment=gen3c_tiny", "trainer.max_iter=1",
            f"trainer.job_dir={tmp_path / 'j'}"]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device trains there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(args)
    assert not (tmp_path / "j").exists()


def test_prefetch_close_waits_for_the_worker():
    """close() stops the prefetch worker and waits for the batch it is
    building, so no worker is left inside a torch op when the interpreter
    exits (the Trainer closes it when training ends)."""
    import threading
    import time

    started = threading.Event()

    def slow():
        for i in range(100):
            started.set()
            time.sleep(0.05)
            yield torch.full((2,), float(i))

    it = tds.PrefetchIterator(slow(), prefetch=2)
    assert torch.equal(next(it), torch.zeros(2))
    assert started.wait(timeout=10)
    it.close()
    assert not it._thread.is_alive()


def test_prefetch_passes_errors_and_the_end():
    def bad():
        yield torch.ones(1)
        raise OSError("disk gone")

    it = tds.PrefetchIterator(bad())
    assert torch.equal(next(it), torch.ones(1))
    with pytest.raises(OSError, match="disk gone"):
        next(it)
    assert list(tds.PrefetchIterator(iter([1, 2, 3]))) == [1, 2, 3]
