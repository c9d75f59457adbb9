"""Two versions of the render kernels (K6, K5) side by side, on one card.

A change to ``kernels/csrc/raycast.cu`` or ``splat.cu`` (a new body) is held
to the version before it:

    python -m gen3c_tpu_torch.scripts.compare_render_builds ptx OLD.cu NEW.cu
        ``compare_attention_builds``' ptx mode: both sources compiled with
        kernels/build.py's flags; per kernel entry whether its PTX is the
        same, and its registers, stack and spill bytes in each version.

    PYTHONPATH=<checkout> python gen3c_tpu_torch/scripts/compare_render_builds.py run TAG
        runs the K6 and K5 of the gen3c_tpu_torch found first on the path
        on chip_smoke.py's scenes and prints one JSON line:
          K6 on the 901,120 pixel rays of a 704x1280 camera against the
          boundary mesh of chip_smoke's depth (~19k triangles) and of its
          dense scene (K6_DENSE_SCENE, ~112k): a hash of the output, the
          call's milliseconds, and apart its per-mesh setup (torch before
          the redesign, a setup kernel after) and its hit kernel;
          K5 at 2 x 3 x 704x1280 on the smooth flow of chip_smoke's render
          case and on uniformly random targets: the call's milliseconds and
          its parts (before the redesign: max_logd, zero-fill, accumulate,
          normalise; after: prepare, accumulate, finish), its largest
          error against ``splat_reference``;
          the renders of chip_smoke's dynamic clip (121 frames, without and
          with foreground masking: 121 K6) and multiview scene: seconds,
          the culled fraction and launches.
        Times: CUDA events around LAUNCHES back-to-back calls queued behind
        a device sleep, median of REPS after a warm-up (the renders: host
        clock, median of 3 after the run that counts the launches). Each run saves its outputs under
        outputs/render_builds/ and compares them with every run saved there
        before it: K6's bits must be equal, K5 is held within chip_smoke's
        SPLAT_TOL and SPLAT_MASK_AGREE (its atomics reorder the sums).

Run ``run`` for the old and the new checkout in one call, in the order old,
new, new, old.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

OUT_DIR = Path("outputs") / "render_builds"
REPS = 5  # samples, the median kept
LAUNCHES = 10  # back-to-back calls a sample
SLEEP_CYCLES = 40_000_000  # ~20 ms of the card asleep while a sample is queued
RENDER_REPS = 3


def chip_smoke():
    """chip_smoke.py of the tree this script belongs to (its scenes and
    tolerances), whichever gen3c_tpu_torch the path holds."""
    path = Path(__file__).resolve().parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _ms(fn) -> float:
    """Milliseconds of one call of fn on the card (compare_w8a8_builds'
    timing: LAUNCHES calls behind a device sleep, median of REPS)."""
    import torch

    fn()
    times = []
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(LAUNCHES):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / LAUNCHES)
    return sorted(times)[REPS // 2]


def _host_s(fn) -> float:
    """Median host seconds of fn() to a synchronised card (the caller has
    run it once)."""
    import torch

    times = []
    for _ in range(RENDER_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[RENDER_REPS // 2]


def _k6(cs, res: dict, saved: dict) -> None:
    import torch

    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.kernels import cuda, reference
    from gen3c_tpu_torch.scripts.compare_attention_builds import _hash

    for name, scene in (("mesh", {}), ("dense", cs.K6_DENSE_SCENE)):
        rays, v0, v1, v2 = cs.k6_mesh(**scene)
        R, T = rays.shape[0], v0.shape[0]
        got = kernels.ray_triangle_depth(rays, v0, v1, v2)
        saved[f"k6_{name}"] = got.cpu()
        res[f"k6_{name}"] = row = {"triangles": T, "hash": _hash(got),
                                   "ms": _ms(lambda: kernels.ray_triangle_depth(rays, v0, v1, v2))}
        out = torch.empty(R, device="cuda")
        if hasattr(cuda, "ray_triangle_hits"):  # the culled body: setup kernel, hit kernel
            mesh = cuda.ray_triangle_setup_and_bounds(v0, v1, v2)
            row["setup_ms"] = _ms(lambda: cuda.ray_triangle_setup_and_bounds(v0, v1, v2))
            row["kernel_ms"] = _ms(lambda: cuda.ray_triangle_hits(rays, *mesh))
        else:  # the all-pairs body: setup rows, then the launch alone
            tris = reference.ray_triangle_setup(v0, v1, v2)
            row["setup_ms"] = _ms(lambda: reference.ray_triangle_setup(v0, v1, v2))
            lib, stream = cuda.library(), torch.cuda.current_stream().cuda_stream
            row["kernel_ms"] = _ms(lambda: lib.gen3c_ray_triangle_depth(
                rays.data_ptr(), tris.data_ptr(), R, T, out.data_ptr(), stream))
        del rays, v0, v1, v2, got, out
        torch.cuda.empty_cache()


def _k5(cs, res: dict, saved: dict) -> None:
    import torch

    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.kernels import cuda, reference

    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, random_flow in (("smooth", False), ("random", True)):
        frame, mask, tdepth, flow = cs.splat_inputs(gen, random_flow=random_flow)
        b, c, h, w = frame.shape
        out, m = kernels.splat(frame, mask, tdepth, flow, None, True)
        ref, m_ref = reference.splat_reference(frame, mask, tdepth, flow, None, True)
        both = (m > 0) & (m_ref > 0)
        saved[f"k5_{name}"] = (out.cpu(), m.cpu())
        row = {"max_abs_err": ((out - ref).abs() * both).max().item(),
               "mask_agree": (m == m_ref).float().mean().item(),
               "ms": _ms(lambda: kernels.splat(frame, mask, tdepth, flow, None, True))}
        if hasattr(cuda, "splat_accumulate"):  # four passes: torch, torch, kernel, torch
            max_logd = reference.splat_max_logd(tdepth)
            acc = torch.zeros((b, (h + 2) * (w + 2), c + 1), device="cuda")
            lib, stream = cuda.library(), torch.cuda.current_stream().cuda_stream
            row["parts_ms"] = {
                "max_logd": _ms(lambda: reference.splat_max_logd(tdepth)),
                "zero_fill": _ms(lambda: torch.zeros((b, (h + 2) * (w + 2), c + 1),
                                                     device="cuda")),
                "accumulate": _ms(lambda: lib.gen3c_splat(
                    frame.data_ptr(), mask.data_ptr(), tdepth.data_ptr(), flow.data_ptr(),
                    None, max_logd.data_ptr(), acc.data_ptr(), b, c, h, w, 50.0, stream)),
                "normalize": _ms(lambda: reference.splat_normalize(acc, c, h, w, True))}
        else:  # one call of three kernels
            parts = []
            for _ in range(REPS):
                cuda.splat(frame, mask, tdepth, flow, None, True, part_ms=parts)
            row["parts_ms"] = {key: sorted(parts[i::3])[REPS // 2]
                               for i, key in enumerate(("prepare", "accumulate", "finish"))}
            counts = torch.zeros(2, dtype=torch.int32, device="cuda")
            cuda.splat(frame, mask, tdepth, flow, None, True, counts=counts)
            row["corner_atomics"], row["corners_merged"] = counts.tolist()
        res[f"k5_{name}"] = row
        del frame, mask, tdepth, flow, out, m, ref, m_ref
        torch.cuda.empty_cache()


def _renders(cs, res: dict) -> None:
    import torch

    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.pipelines import gen3c_dynamic, gen3c_multiview
    from gen3c_tpu_torch.pipelines.factory import PRESETS

    preset, dev = PRESETS["gen3c_7b"], torch.device("cuda")
    os.makedirs("outputs", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="outputs") as root:
        clip = os.path.join(root, "clip.npz")
        cs._dynamic_clip(clip, preset)
        argv = ["--input_video_path", clip, "--model_preset", preset.name,
                "--num_video_frames", str(preset.chunk_size), "--trajectory", "left",
                "--device", "cuda"]
        known = {}
        for masking in (False, True):
            args = gen3c_dynamic.create_parser().parse_args(
                argv + (["--foreground_masking"] if masking else []))
            cache, w2cs, ks, _ = gen3c_dynamic.load_scene(args, preset, dev)
            kernels.reset_launch_counts()
            _, masks = cache.render_cache(w2cs, ks, start_frame_idx=0)
            known[masking] = masks > 0
            res[f"dynamic_k6_launches_{masking}"] = kernels.launch_counts["K6"]
            key = "dynamic_render_masked_s" if masking else "dynamic_render_unmasked_s"
            res[key] = _host_s(lambda: cache.render_cache(w2cs, ks, start_frame_idx=0))
            del cache, masks
        res["dynamic_culled_fraction"] = (
            (known[False] & ~known[True]).sum() / known[False].sum()).item()
        del known
        npz = os.path.join(root, "mv.npz")
        cs._multiview_npz(npz, preset)
        args = gen3c_multiview.create_parser().parse_args(
            ["--npz_path", npz, "--model_preset", preset.name, "--num_video_frames",
             str(preset.chunk_size), "--frame_buffer_max", "2", "--foreground_masking",
             "--device", "cuda"])
        cache, w2cs, ks, _ = gen3c_multiview.load_scene(args, dev)
        kernels.reset_launch_counts()
        cache.render_cache(w2cs, ks)
        res["multiview_k6_launches"] = kernels.launch_counts["K6"]
        res["multiview_render_s"] = _host_s(lambda: cache.render_cache(w2cs, ks))
        del cache
    torch.cuda.empty_cache()


def _compare(cs, tag: str, saved: dict) -> list:
    """saved against every run saved in OUT_DIR before this one."""
    import torch

    rows = []
    for path in sorted(OUT_DIR.glob("*.pt")):
        other = torch.load(path)
        row = {"against": path.stem}
        for key in ("k6_mesh", "k6_dense"):
            row[f"{key}_equal"] = bool(torch.equal(saved[key], other[key]))
        for key in ("k5_smooth", "k5_random"):
            (out, m), (out_o, m_o) = saved[key], other[key]
            both = (m > 0) & (m_o > 0)
            err = ((out - out_o).abs() * both).max().item()
            agree = (m == m_o).float().mean().item()
            row[f"{key}_max_abs_diff"], row[f"{key}_mask_agree"] = err, agree
            row[f"{key}_within_tol"] = err <= cs.SPLAT_TOL and agree >= cs.SPLAT_MASK_AGREE
        rows.append(row)
    return rows


def run(tag: str) -> dict:
    import torch

    import gen3c_tpu_torch

    if not torch.cuda.is_available():
        raise SystemExit("compare_render_builds run needs a CUDA card")
    cs = chip_smoke()
    res = {"tag": tag, "package": str(Path(gen3c_tpu_torch.__file__).parent),
           "device": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi_line()}
    saved = {}
    _k6(cs, res, saved)
    _k5(cs, res, saved)
    _renders(cs, res)
    res["compared"] = _compare(cs, tag, saved)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    torch.save(saved, OUT_DIR / f"{tag}.pt")
    print(json.dumps(res), flush=True)
    return res


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) == 3 and argv[0] == "ptx":
        from gen3c_tpu_torch.scripts.compare_attention_builds import compare_ptx

        return 0 if compare_ptx(argv[1], argv[2]) else 1
    if len(argv) == 2 and argv[0] == "run":
        run(argv[1])
        return 0
    raise SystemExit(__doc__)


if __name__ == "__main__":
    sys.exit(main())
