"""The single-image CLI launched as the reference launches it on several
devices, on the CPU: ``torchrun --nproc_per_node 2 -m
gen3c_tpu_torch.pipelines.gen3c_single_image --device cpu --num_gpus 2 ...``
(two ranks over gloo), against the same CLI in one process.

The tiny preset's 9-frame chunk has 2 latent frames, one per rank. Frames
are compared as uint8 as tests/test_torch_pipeline.py compares the port
with JAX (|delta| <= 1 on >= 99.9% of values): the ranks run the same fp32
operations on half of the tokens, and the sums of attention and of the
all-reduced statistics run in another order. Rank 0 alone writes the video.
The runs see a stand-in ``imageio`` whose ``mimsave`` stores the frames
losslessly (np.save) where the mp4 would go: the lossy codecs (the mp4, or
the MJPEG AVI written without imageio) turn a one-level change of a pixel
into changes of up to ~20 levels across its 8x8 block. A stand-in
``imageio_ffmpeg`` names an ffmpeg, so that the CLI's incremental saver,
as with a real ffmpeg, leaves the save to ``save_video``'s mp4.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_image(path):
    from PIL import Image

    Image.fromarray((np.random.default_rng(0).uniform(size=(96, 160, 3)) * 255)
                    .astype(np.uint8)).save(path)


_LOSSLESS_IMAGEIO = """import numpy as np


def mimsave(path, video, *args, **kwargs):
    with open(path, "wb") as f:
        np.save(f, np.asarray(video))
"""


_FFMPEG_PRESENT = """def get_ffmpeg_exe():
    return "ffmpeg"
"""


def _run(tmp_path, name, frames, ranks=1, flags=()):
    """One CLI run; returns (frames as uint8 (F, H, W, 3), its log)."""
    img = tmp_path / "in.png"
    if not img.exists():
        _tiny_image(img)
        (tmp_path / "stub").mkdir()
        (tmp_path / "stub" / "imageio.py").write_text(_LOSSLESS_IMAGEIO)
        (tmp_path / "stub" / "imageio_ffmpeg.py").write_text(_FFMPEG_PRESENT)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path / "stub"), REPO]))
    out = tmp_path / name
    launch = [sys.executable, "-m"]
    if ranks > 1:
        launch += ["torch.distributed.run", "--standalone", "--nproc_per_node", str(ranks), "-m"]
    proc = subprocess.run(
        launch + ["gen3c_tpu_torch.pipelines.gen3c_single_image", "--device", "cpu",
                  "--model_preset", "gen3c_tiny", "--num_steps", "2", "--guidance", "2.0",
                  "--depth_source", "heuristic", "--num_video_frames", str(frames),
                  "--input_image_path", str(img), "--video_save_folder", str(out),
                  "--checkpoint_dir", str(tmp_path / "none"), *flags],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log[-3000:]
    assert os.listdir(out) == ["output.mp4"]  # rank 0 alone writes
    return np.load(out / "output.mp4"), log


def _assert_frames_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert (diff <= 1).mean() >= 0.999, (diff.max(), (diff > 1).mean())


@pytest.mark.parametrize("frames,flags", [
    (9, ["--num_gpus", "2", "--cp_attn", "ulysses"]),
    (9, ["--num_gpus", "2", "--parallel", "cfg2"]),
    (17, ["--num_gpus", "2", "--parallel", "cp", "--cp_attn", "ring"]),
], ids=["ulysses-9", "cfg2-9", "ring-17-two-chunks"])
def test_torchrun_cli_matches_single_process(tmp_path, frames, flags):
    want, _ = _run(tmp_path, "single", frames)
    got, log = _run(tmp_path, "ranks", frames, ranks=2, flags=flags)
    assert "parallel denoising over 2 ranks" in log
    _assert_frames_close(got, want)


def test_offload_flags_are_no_ops(tmp_path):
    """--offload_diffusion_transformer and --offload_tokenizer are accepted,
    say so, and change nothing: the frames equal a run without them."""
    want, _ = _run(tmp_path, "plain", 9)
    got, log = _run(tmp_path, "offload", 9,
                    flags=["--offload_diffusion_transformer", "--offload_tokenizer"])
    np.testing.assert_array_equal(got, want)
    assert "--offload_diffusion_transformer: ignored" in log
    assert "--offload_tokenizer: ignored" in log


@pytest.mark.parametrize("cli,argv", [
    ("gen3c_single_image", ["--input_image_path", "x.png"]),
    ("gen3c_dynamic", ["--input_video_path", "clip.npz"]),
    ("gen3c_multiview", ["--npz_path", "mv.npz"]),
])
def test_every_cli_accepts_the_offload_flags(tmp_path, cli, argv):
    import importlib
    import logging

    from gen3c_tpu_torch.pipelines import factory
    from gen3c_tpu_torch.utils import log

    module = importlib.import_module(f"gen3c_tpu_torch.pipelines.{cli}")
    args = module.create_parser().parse_args(
        argv + ["--device", "cpu", "--model_preset", "gen3c_tiny", "--checkpoint_dir",
                str(tmp_path / "none"), "--offload_diffusion_transformer", "--offload_tokenizer"])
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = log.get_logger()  # configured before the handler joins it
    logger.addHandler(handler)
    try:
        model, _ = factory.build_from_args(args)
    finally:
        logger.removeHandler(handler)
    assert args.device == "cpu" and model.groups is None
    said = [r.getMessage() for r in records]
    assert any(m.startswith("--offload_diffusion_transformer: ignored") for m in said), said
    assert any(m.startswith("--offload_tokenizer: ignored") for m in said), said
