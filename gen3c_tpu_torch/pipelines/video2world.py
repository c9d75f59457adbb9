"""Video-to-world generation, PyTorch/CUDA CLI (port of
gen3c_tpu/pipelines/video2world.py).

A thin entry point over ``pipelines.text2world`` in video2world mode: a
seed image or video conditions the first latent frames of the
``cosmos_v2w_*`` presets.

Usage:
  python -m gen3c_tpu_torch.pipelines.video2world \
      --input_image_path img.png --prompt "..." [--num_input_frames 1]
"""

from __future__ import annotations

from gen3c_tpu_torch.pipelines.text2world import create_parser, demo


def main(argv=None) -> str:
    parser = create_parser()
    parser.set_defaults(mode="video2world")
    args = parser.parse_args(argv)
    args.mode = "video2world"
    return demo(args)


if __name__ == "__main__":
    main()
