"""The offline tools of ``gen3c_tpu_torch/scripts/`` against the JAX
package's ``scripts/`` on the CPU, at the tiny presets.

Each port CLI runs in a subprocess with ``--device cpu`` (``python -m
gen3c_tpu_torch.scripts.<name>``'s module, run by runpy) that fails if it
imported jax, jaxlib or gen3c_tpu, each JAX script in a subprocess as it
is in ``scripts/`` (from the repo root, ``JAX_PLATFORMS=cpu``), on the
same locally written inputs; nothing is fetched (the Hugging Face offline
flags are set). The files must agree:

  persist_quantized_dit, convert_checkpoints, ar_tp_checkpoints (shard,
    then merge): key for key and bit for bit;
  get_t5_embeddings: within the T5 parity tests' 1e-5 (both through
    transformers' encoder in fp32);
  make_random_checkpoint: the same names, shapes and dtypes as JAX's tree
    (the values are torch's draws), and the same bits in two runs;
  cache_quality_gate: the same rows and refresh costs (the weights are
    each package's own seeded init, so the PSNRs differ).

At the tiny width no linear reaches the quantizers' 2^20 elements; the
quantized files are therefore also written with both packages' _MIN_SIZE
set to 2^13 before the unmodified script runs (``runpy``), so that every
q / k / v / out / fc1 / fc2 is quantized.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_MIN = 1 << 13


def _env():
    env = dict(os.environ, JAX_PLATFORMS="cpu", HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="2")
    env.pop("CUDA_VISIBLE_DEVICES", None)
    return env


def _run(argv, timeout=300, **env):
    res = subprocess.run([sys.executable, *argv], cwd=ROOT, env={**_env(), **env},
                         capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stderr[-3000:]
    return res


def jax_script(name, *args, min_size=None):
    """scripts/<name>.py as it is; min_size patches gen3c_tpu's _MIN_SIZE first."""
    if min_size is None:
        return _run([f"scripts/{name}.py", *args])
    code = ("import sys, runpy; import gen3c_tpu.models.quantize as q; "
            f"q._MIN_SIZE = {min_size}; sys.argv = sys.argv[1:]; "
            f"runpy.run_path('scripts/{name}.py', run_name='__main__')")
    return _run(["-c", code, f"scripts/{name}.py", *args])


def port_tool(name, *args, min_size=None):
    """``python -m gen3c_tpu_torch.scripts.<name> ... --device cpu`` (through
    runpy, min_size patching the port's _MIN_SIZE first), failing if the run
    imported jax, jaxlib or any gen3c_tpu module."""
    patch = "" if min_size is None else (
        f"import gen3c_tpu_torch.models.quantize as q; q._MIN_SIZE = {min_size}; ")
    code = ("import sys, runpy; " + patch + "sys.argv = sys.argv[1:]; "
            f"runpy.run_module('gen3c_tpu_torch.scripts.{name}', run_name='__main__', "
            "alter_sys=True); "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'gen3c_tpu')]; "
            "assert not bad, f'the port imported {bad[:5]}'")
    # transformers probes for flax, which imports jax.version, unless told not to
    return _run(["-c", code, name, *args, "--device", "cpu"], USE_FLAX="0", USE_TF="0")


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def assert_same_npz(a, b):
    fa, fb = _npz(a), _npz(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        assert fa[k].tobytes() == fb[k].tobytes(), k


@pytest.fixture(scope="module")
def jax_random_dir(tmp_path_factory):
    """JAX's seeded tiny dit.npz, written once by scripts/make_random_checkpoint.py."""
    d = tmp_path_factory.mktemp("jax_random")
    jax_script("make_random_checkpoint", "--checkpoint_dir", str(d), "--preset", "gen3c_tiny",
               "--seed", "3")
    return d


def test_make_random_checkpoint_has_jax_tree_and_repeats(jax_random_dir, tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    for d in (a, b):
        port_tool("make_random_checkpoint", "--checkpoint_dir", str(d), "--preset",
                  "gen3c_tiny", "--seed", "3", "--quantize", "w8a8")
    want = _npz(jax_random_dir / "gen3c_tpu" / "dit.npz")
    got = _npz(a / "gen3c_tpu" / "dit.npz")
    assert sorted(got) == sorted(want) and all(k.endswith("::bf16") for k in got)
    for k, v in want.items():
        assert (got[k].dtype, got[k].shape) == (v.dtype, v.shape), k
    for name in ("dit.npz", "dit_w8a8.npz"):
        assert_same_npz(a / "gen3c_tpu" / name, b / "gen3c_tpu" / name)
    bits = np.concatenate([v.ravel() for v in got.values()]).view(np.int16)
    values = torch.from_numpy(bits).view(torch.bfloat16).float()
    assert abs(float(values.std()) - 0.02) < 1e-3 and abs(float(values.mean())) < 1e-3
    c = tmp_path / "c"
    port_tool("make_random_checkpoint", "--checkpoint_dir", str(c), "--preset", "gen3c_tiny",
              "--seed", "4", "--skip_bf16", "--quantize", "int8")
    assert os.listdir(c / "gen3c_tpu") == ["dit_int8.npz"]


@pytest.mark.parametrize("mode,min_size", [("w8a8", SMALL_MIN), ("int8", SMALL_MIN),
                                           ("w8a8", None)])
def test_persist_quantized_dit_writes_jax_file(jax_random_dir, tmp_path, mode, min_size):
    import shutil

    dirs = {}
    for who in ("jax", "port"):
        d = tmp_path / who / "gen3c_tpu"
        d.mkdir(parents=True)
        shutil.copy(jax_random_dir / "gen3c_tpu" / "dit.npz", d / "dit.npz")
        dirs[who] = d
    args = ("--checkpoint_dir", str(tmp_path / "jax"), "--mode", mode, "--preset", "gen3c_tiny")
    jax_script("persist_quantized_dit", *args, min_size=min_size)
    args = ("--checkpoint_dir", str(tmp_path / "port"), "--mode", mode, "--preset", "gen3c_tiny")
    port_tool("persist_quantized_dit", *args, min_size=min_size)
    name = f"dit_{mode}.npz"
    assert_same_npz(dirs["jax"] / name, dirs["port"] / name)
    keys = _npz(dirs["port"] / name)
    quantized = [k for k in keys if k.endswith(("['q']", "['q8']"))]
    assert bool(quantized) == (min_size is not None)
    if quantized:  # and the factory loads it as the pre-quantized DiT
        # a block's fa and ca q / k / v / out and mlp fc1 / fc2, twice, x_embedder
        # and the timestep MLP's two linears (the final linear is under 2^13)
        assert len(quantized) == 2 * 10 + 3
        from gen3c_tpu_torch.models import quantize as tq
        from gen3c_tpu_torch.pipelines.factory import build_gen3c_model

        old, tq._MIN_SIZE = tq._MIN_SIZE, SMALL_MIN
        try:
            model, _ = build_gen3c_model("gen3c_tiny", device="cpu",
                                         checkpoint_dir=str(tmp_path / "port"), quantize=mode)
        finally:
            tq._MIN_SIZE = old
        lin = model.net.blocks["block0"].blocks[2].block.layer1
        assert isinstance(lin, tq.QuantLinear) and lin.act_quant == (mode == "w8a8")
        code = keys["['blocks']/[0]/['mlp']/['fc1']/['" + ("q8" if mode == "w8a8" else "q")
                    + "']"]
        assert torch.equal(lin.weight, torch.from_numpy(code).T)


def test_convert_checkpoints_writes_jax_files(tmp_path):
    """A reference model.pt (wrappers, TE _extra_state, logvar, RoPE
    buffers) and a TorchScript tokenizer with mean_std.pt, from seeded
    weights, converted by both scripts: dit.npz, vae.npz and
    vae_mean_std.npz key for key and bit for bit."""
    import jax
    import jax.numpy as jnp

    from gen3c_tpu.models import dit as jdit
    from gen3c_tpu.pipelines import factory as jfactory
    from gen3c_tpu_torch.bridge import vae_state_from_jax
    from gen3c_tpu_torch.models.vae import CausalVAE
    from gen3c_tpu_torch.pipelines import factory as tfactory
    from tests.test_torch_checkpoint import _Part, _reference_checkpoint

    tree = jax.tree.map(np.asarray, jdit.randomize_degenerate_inits(jdit.init_dit_params(
        jax.random.PRNGKey(5), jfactory.GEN3C_TINY_PRESET.dit, jnp.float32)))
    src = tmp_path / "src"
    (src / "GEN3C-Cosmos-7B").mkdir(parents=True)
    torch.save(_reference_checkpoint(tree, legacy_patch=True),
               src / "GEN3C-Cosmos-7B" / "model.pt")
    vae = CausalVAE(tfactory.GEN3C_TINY_PRESET.vae)
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for p in vae.parameters():
            p.copy_(0.05 * torch.randn(p.shape, generator=g))
    d = src / "Cosmos-Tokenize1-CV8x8x8-720p"
    d.mkdir()
    children = [n for n, _ in vae.named_children()]
    enc_names = [n for n in children if "decoder" not in n and n != "post_quant_conv"]
    video = torch.zeros((1, 3, 9, 96, 160))
    with torch.no_grad():
        enc = torch.jit.trace(_Part(vae, enc_names, True), video, check_trace=False)
        dec = torch.jit.trace(_Part(vae, [n for n in children if n not in enc_names], False),
                              vae.encode(video), check_trace=False)
    torch.jit.save(enc, str(d / "encoder.jit"))
    torch.jit.save(dec, str(d / "decoder.jit"))
    torch.save((torch.randn(48, generator=g), torch.rand(48, generator=g) + 0.5),
               d / "mean_std.pt")
    import shutil

    shutil.copytree(src, tmp_path / "port")
    jax_script("convert_checkpoints", "--checkpoint_dir", str(src), "--preset", "gen3c_tiny")
    port_tool("convert_checkpoints", "--checkpoint_dir", str(tmp_path / "port"), "--preset",
              "gen3c_tiny")
    names = sorted(os.listdir(src / "gen3c_tpu"))
    assert names == ["dit.npz", "vae.npz", "vae_mean_std.npz"]
    assert sorted(os.listdir(tmp_path / "port" / "gen3c_tpu")) == names
    for name in names:
        assert_same_npz(src / "gen3c_tpu" / name, tmp_path / "port" / "gen3c_tpu" / name)
    assert set(_npz(src / "gen3c_tpu" / "vae.npz")) == set(vae_state_from_jax(
        {k: v for k, v in vae.state_dict().items()}))


def test_ar_tp_checkpoints_shard_then_merge_as_jax(tmp_path):
    """A seeded Cosmos AR state dict ({"model": ...}, 2 layers, 4 heads / 2
    KV heads of 32) sharded 2 ways and merged back by both scripts: every
    shard and the merged file key for key and bit for bit, and the merge
    gives the original weights back."""
    from gen3c_tpu_torch.models import ar_transformer as tar

    cfg = tar.ARConfig(dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=512,
                       ffn_hidden_size=256, max_seq_len=64, dtype=torch.float32)
    g = torch.Generator().manual_seed(7)
    sd = {k: torch.randn(v.shape, generator=g) for k, v in tar.ARTransformer(cfg).state_dict().items()}
    paths = {}
    for who in ("jax", "port"):
        (tmp_path / who).mkdir()
        paths[who] = tmp_path / who / "model.pt"
        torch.save({"model": sd}, paths[who])
    common = ("-t", "2", "--n_heads", "4", "--n_kv_heads", "2", "--dim", "128")
    jax_script("ar_tp_checkpoints", "shard", "-c", str(paths["jax"]), *common)
    port_tool("ar_tp_checkpoints", "shard", "-c", str(paths["port"]), *common)
    for r in range(2):
        a = torch.load(tmp_path / "jax" / f"model_model_mp_{r}.pt")
        b = torch.load(tmp_path / "port" / f"model_model_mp_{r}.pt")
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    jax_script("ar_tp_checkpoints", "merge", "-c", str(paths["jax"]), *common)
    port_tool("ar_tp_checkpoints", "merge", "-c", str(paths["port"]), *common)
    a = torch.load(tmp_path / "jax" / "model_merged.pt")
    b = torch.load(tmp_path / "port" / "model_merged.pt")
    assert list(a) == list(b) == list(sd)
    for k in a:
        assert torch.equal(a[k].view(torch.int32), b[k].view(torch.int32)), k
        if "norm" not in k:
            assert torch.equal(b[k], sd[k]), k


def test_get_t5_embeddings_matches_jax(tmp_path):
    """Two prompts, one unnamed, through a tiny seeded T5 written to a local
    directory: the port's .t5.npy files against the JAX script's (both
    transformers' fp32 encoder) within the T5 parity tests' 1e-5. The files
    load through ``training.datasets``'s reader as their clips' embeddings."""
    from tests.test_torch_t5 import _write_local_t5

    path, _ = _write_local_t5(str(tmp_path / "ckpt"))
    prompts = tmp_path / "p.jsonl"
    prompts.write_text(json.dumps({"prompt": "a cat on the hill", "name": "clip_a"}) + "\n\n"
                       + json.dumps({"prompt": "a red house"}) + "\n")
    jax_script("get_t5_embeddings", "--prompts", str(prompts), "--output_dir",
               str(tmp_path / "jax"), "--model", path, "--max_length", "16")
    port_tool("get_t5_embeddings", "--prompts", str(prompts), "--output_dir",
              str(tmp_path / "port"), "--model", path, "--max_length", "16")
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["000002.t5.npy", "clip_a.t5.npy"]
    assert sorted(os.listdir(tmp_path / "port")) == names
    from gen3c_tpu_torch.training.datasets import _t5_or_zeros

    for name in names:
        want = np.load(tmp_path / "jax" / name)
        got = np.load(tmp_path / "port" / name)
        assert got.shape == want.shape == (16, 32) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        clip = str(tmp_path / "port" / name.replace(".t5.npy", ".npz"))  # its clip's sibling
        assert np.array_equal(_t5_or_zeros(clip), got)


def test_cache_quality_gate_rows_match_jax():
    jax_rows = json.loads(jax_script("cache_quality_gate", "--preset", "gen3c_tiny",
                                     "--num_steps", "6").stdout.strip().splitlines()[-1])
    rows = json.loads(port_tool("cache_quality_gate", "--preset", "gen3c_tiny",
                                "--num_steps", "6").stdout.strip().splitlines()[-1])
    assert [r["policy"] for r in rows] == [r["policy"] for r in jax_rows]
    assert [r["relative_cost"] for r in rows] == [r["relative_cost"] for r in jax_rows]
    for r in rows:
        assert r["psnr_vs_uncached"] is not None and r["psnr_vs_uncached"] > 0
