"""The port's measurement scripts on the CPU: what they parse and count.

The scripts themselves run on a card; here their parsing and bookkeeping
are held to hand-made inputs, and their entry points to refusing to run
without a card.
"""

import json
import os
import tempfile
from types import SimpleNamespace

import pytest
import torch

from gen3c_tpu_torch.scripts import compare_attention_builds as cab
from gen3c_tpu_torch.scripts import compare_gqa_builds as cgb
from gen3c_tpu_torch.scripts import compare_render_builds as crb
from gen3c_tpu_torch.scripts import compare_w8a8_builds as cwb
from gen3c_tpu_torch.kernels import cuda as kcuda
from gen3c_tpu_torch.scripts import probe_int8_attention as probe
from gen3c_tpu_torch.scripts import profile_lora_step as prof
from gen3c_tpu_torch.scripts import sweep_attention as sweep
from gen3c_tpu_torch.scripts import time_main_path as tmp

NS_A = "_GLOBAL__N__ee55c35c_16_attention_bwd_cu_87cbb326"
NS_B = "_GLOBAL__N__0123abcd_16_attention_bwd_cu_deadbeef"


def _ptx(ns: str, loc: int, body: str) -> str:
    return f"""//
// Generated by NVIDIA NVVM Compiler
.version 8.8
.visible .entry _ZN{len(ns)}{ns}4fwdEv(
\t.param .u64 p
)
{{
\t.loc\t1 {loc} 3
\tmov.u32 \t%r1, %ctaid.x;
\t{body}
\tret;
}}
.entry _ZN{len(ns)}{ns}4bwdEv(
)
{{
\tret;
}}
"""


def test_ptx_entries_ignore_line_info_and_namespace_hash():
    a = cab._ptx_entries(_ptx(NS_A, 10, "add.s32 %r2, %r1, 1;"))
    b = cab._ptx_entries(_ptx(NS_B, 99, "add.s32 %r2, %r1, 1;"))
    c = cab._ptx_entries(_ptx(NS_B, 10, "add.s32 %r2, %r1, 2;"))
    assert list(a) == ["_ZN49NS4fwdEv", "_ZN49NS4bwdEv"]
    assert a == b
    assert a["_ZN49NS4fwdEv"] != c["_ZN49NS4fwdEv"] and a["_ZN49NS4bwdEv"] == c["_ZN49NS4bwdEv"]


def test_ptx_entries_ignore_the_module_numbers_of_block_labels():
    """A kernel added or removed before an entry renumbers the entry's block
    labels ($L__BB<function>_<block>); a branch to another block is still
    a change."""
    def branchy(fn, block):
        return _ptx(NS_A, 10, f"@%p1 bra $L__BB{fn}_{block};\n$L__BB{fn}_{block}:")

    a, b, c = (cab._ptx_entries(branchy(fn, block)) for fn, block in ((0, 2), (7, 2), (0, 3)))
    assert a == b
    assert a["_ZN49NS4fwdEv"] != c["_ZN49NS4fwdEv"]


def test_ptx_entries_leave_out_the_debug_sections():
    """-lineinfo appends .section .debug_str to the last entry's text,
    spelling the anonymous namespace's hash as bytes."""
    def with_debug(ns):
        spelled = ",".join(str(ord(c)) for c in ns)
        return _ptx(ns, 10, "add.s32 %r2, %r1, 1;") + (
            f"\t.section\t.debug_str\n\t{{\n$L__info_string0:\n.b8 {spelled}\n\t}}\n")

    a, b = cab._ptx_entries(with_debug(NS_A)), cab._ptx_entries(with_debug(NS_B))
    assert a == b == cab._ptx_entries(_ptx(NS_A, 10, "add.s32 %r2, %r1, 1;"))


def test_ptxas_counts_per_entry():
    log = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN{NS_A}4fwdEv' for 'sm_90a'
ptxas info    : Function properties for _ZN{NS_A}4fwdEv
    64 bytes stack frame, 116 bytes spill stores, 100 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN{NS_B}4bwdEv' for 'sm_90a'
ptxas info    : Function properties for _ZN{NS_B}4bwdEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 166 registers, used 1 barriers
"""
    assert cab._ptxas_counts(log) == {"_ZNNS4fwdEv": (128, 64, 116, 100),
                                      "_ZNNS4bwdEv": (166, 0, 0, 0)}


def test_compare_attention_builds_usage_without_arguments():
    with pytest.raises(SystemExit, match="side by side"):
        cab.main([])


def test_compare_w8a8_builds_usage_and_shapes():
    """The four GEN3C-7B linear shapes at the CFG batch's 112,640 tokens (and
    the text's 1,024), a ragged one whose K is not a 16-byte multiple (read
    from 1,024-byte rows), and both activation widths of K7q."""
    with pytest.raises(SystemExit, match="side by side"):
        cwb.main([])
    shapes = {name: (m, k, n) for name, m, k, n in cwb.GEMM_SHAPES}
    assert shapes == {"qkv_out": (112640, 4096, 4096), "fc1": (112640, 4096, 16384),
                      "fc2": (112640, 16384, 4096), "cross_kv": (1024, 1024, 4096),
                      "ragged": (4099, 1000, 4104)}
    assert cwb.QUANT_WIDTHS == (4096, 16384)


def test_compare_render_builds_usage_and_scenes():
    """ptx takes two sources and run one tag; anything else prints the usage.
    The scenes are chip_smoke.py's (this tree's, loaded by path whichever
    package the path holds): its ~19k-triangle mesh and the dense one
    whose boundary covers the frame, and its tolerances for K5."""
    for argv in ([], ["ptx", "a.cu"], ["run"], ["run", "a", "b"], ["diff", "a"]):
        with pytest.raises(SystemExit, match="side by side"):
            crb.main(argv)
    cs = crb.chip_smoke()
    assert cs.K6_DENSE_SCENE == {"discs": 64, "bars": 128, "bar_top": 0.0}
    assert (cs.SPLAT_TOL, cs.SPLAT_MASK_AGREE) == (1e-4, 0.999)
    assert callable(cs.k6_mesh) and callable(cs.splat_inputs)
    assert crb.OUT_DIR.parts == ("outputs", "render_builds")


def test_compare_render_builds_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        crb.main(["run", "cpu"])


def test_compare_gqa_builds_usage_and_cases():
    """ptx takes two sources and run one tag; anything else prints the usage.
    The cases are chip_smoke.py's K8 shapes: decode at pos 5,120 and 12,799
    (and at pos 0, the fixed cost) and the 5,120-token prefill, bf16 and
    int8, on the 4B's cache layer."""
    for argv in ([], ["ptx", "a.cu"], ["run"], ["run", "a", "b"], ["diff", "a"]):
        with pytest.raises(SystemExit, match="side by side"):
            cgb.main(argv)
    assert cgb.CACHE == (1, 12800, 8, 128) and cgb.HQ == 32
    assert {(lq, pos, int8) for _, lq, pos, int8 in cgb.CASES} == {
        (1, 0, False), (1, 0, True), (1, 5120, False), (1, 12799, False), (1, 5120, True),
        (1, 12799, True), (5120, 0, False), (5120, 0, True)}
    assert callable(cgb.card().device_ms) and callable(cgb.card().host_us)


@pytest.mark.parametrize("lost", [0, 1, 2, 3])
def test_device_ms_counts_a_call_from_the_records_kept(lost):
    """card.records_a_call on hand-made profiles of 20 and 40 calls of two
    kernels (8 and 2 µs, one of each a call): each name's count a call and
    its mean kept duration give the time whichever records the profiler
    lost, up to LOST_RECORDS of a name; more lost, a name missing from a
    profile or a count that is not whole is refused."""
    from gen3c_tpu_torch.scripts import card

    calls = 20
    short, long = ([("k", 8.0), ("m", 2.0)] * n for n in (calls, 2 * calls))
    got = card.records_a_call([short[2 * lost:], long], calls)  # lose `lost` of each name
    if lost <= card.LOST_RECORDS:
        assert got == (10.0, {"k": 1, "m": 1}, 2 * lost)
    else:
        assert got is None
    assert card.records_a_call([short, [r for r in long if r[0] == "k"]], calls) is None
    assert card.records_a_call([short + [("k", 8.0)] * calls, long], calls) is None
    assert card.records_a_call([[], []], calls) is None


def test_compare_gqa_builds_runs_the_smokes_k8bwd_cases():
    """``run`` times K8bwd at chip_smoke.py's K8BWD_CASES (this tree's): the
    4B's causal training shape, the left-padded batch, the cross-attention's
    512 keys, rep 1 at d 32 and ar_tiny's fp32; ``ptx`` takes pairs of
    sources."""
    cases = {c[0]: c[1:] for c in cgb.chip_smoke().K8BWD_CASES}
    assert cases == {
        "K8bwd 4B causal bf16": (1, 12800, 12800, 32, 8, 128, "bfloat16", 0, None, 1),
        "K8bwd left-padded bf16": (2, 2048, 2048, 32, 8, 128, "bfloat16", 0, [0, 700], None),
        "K8bwd cross-attention bf16": (1, 12800, 512, 32, 8, 128, "bfloat16", None, None, None),
        "K8bwd short rep 1 d 32 bf16": (1, 200, 200, 4, 4, 32, "bfloat16", 0, None, None),
        "K8bwd ar_tiny fp32": (1, 255, 255, 4, 2, 32, "float32", 0, None, None)}
    for argv in (["ptx", "a.cu", "b.cu", "c.cu"], ["ptx"]):
        with pytest.raises(SystemExit, match="side by side"):
            cgb.main(argv)


def test_ar_train_trace_reads_k8_whole_when_other_records_are_lost():
    """chip_smoke.read_ar_train_trace on hand-made profiles of one and two
    4B steps (K8bwd's three kernels 16 times a step, K8's forward 32 times,
    an elementwise pass 1,000 times): K8bwd's and K8's seconds a step are
    exact although the elementwise pass lost 20 records of each profile
    (the step's kernel time is then a lower bound, flagged) or K8bwd's dK/dV
    and K8 lost 2 (card.LOST_RECORDS) of the one-step profile's; 3 lost of
    one name, or a name missing, or another kernel count, reads None."""
    cs = cgb.chip_smoke()
    dkdv = "void (anonymous namespace)::attn_bwd_dkdv_wgmma<128, false, true>(CUtensorMap_st)"
    dq = "void (anonymous namespace)::attn_bwd_dq_wgmma<128, false, true>(CUtensorMap_st)"
    delta = "void (anonymous namespace)::attn_bwd_delta_wgmma((anonymous namespace)::BwdParams)"
    fwd = "void (anonymous namespace)::attn_fwd_wgmma<128, false, true, true>(CUtensorMap_st)"
    ew = "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>"
    step = ([(dkdv, 9000.0), (dq, 4000.0), (delta, 100.0)] * 16 + [(fwd, 3000.0)] * 32
            + [(ew, 50.0)] * 1000)
    def read(one, two):  # 16 K8bwd launches of 3 kernels, 32 K8 forwards a step
        return cs.read_ar_train_trace([one, two], 1.5, 16, 3, 32)

    whole = read(step, step * 2)
    assert whole["all_records_kept"] and whole["k8_records_lost"] == 0
    lossy = read(step[:-20], step * 2)
    assert not lossy["all_records_kept"]

    def drop(records, name, n):  # the first n records of name lost
        idx = [i for i, r in enumerate(records) if r[0] == name][:n]
        return [r for i, r in enumerate(records) if i not in idx]

    two_lost = read(drop(drop(step, dkdv, 2), fwd, 2), step * 2)
    assert two_lost["k8_records_lost"] == 4
    for r in (whole, lossy, two_lost):
        assert (r["k8bwd_kernels_a_step"], r["k8_kernels_a_step"]) == (48, 32)
        assert abs(r["k8bwd_s"] - 16 * 13100e-6) < 1e-9 and abs(r["k8_s"] - 32 * 3000e-6) < 1e-9
        assert abs(r["k8bwd_share_of_step"] - 16 * 13100e-6 / 1.5) < 1e-9
    assert abs(whole["kernel_s"] - (16 * 13100 + 32 * 3000 + 1000 * 50) * 1e-6) < 1e-9
    assert read(drop(step, dkdv, 3), step * 2) is None
    assert read([r for r in step if r[0] != fwd], step * 2) is None
    assert cs.read_ar_train_trace([step, step * 2], 1.5, 16, 4, 32) is None


def test_entry_key_pairs_a_kernel_that_gained_a_false_flag():
    """compare_*_builds' ptx pairs an entry whose template gained a bool flag
    (and a parameter) at the flag's false value with the entry it was; the
    flag's true value stays apart, and other names stay as they are."""
    from gen3c_tpu_torch.scripts.compare_attention_builds import entry_key

    old = "_ZN71NS19attn_bwd_dkdv_wgmmaILi128ELb1EEEv14CUtensorMap_stS1_S1_S1_NS_9BwdParamsENS_4BandE"
    new = ("_ZN71NS19attn_bwd_dkdv_wgmmaILi128ELb1ELb0EEEv14CUtensorMap_stS1_S1_S1_NS_9BwdParams"
           "ENS_4BandENS_6GqaBwdE")
    assert entry_key(old) == entry_key(new) == "attn_bwd_dkdv_wgmma<128,1>"
    assert entry_key(new.replace("ILi128ELb1ELb0E", "ILi64ELb0ELb1E")) == \
        "attn_bwd_dkdv_wgmma<64,0,1>"
    assert entry_key("_ZN71NS17attn_bwd_dq_wgmmaILi64ELb0EEEv") == "attn_bwd_dq_wgmma<64>"
    # the length of the source name may follow the namespace hash's digits
    assert entry_key("_ZN4_cu_123456714attn_fwd_wgmmaILi128ELb0ELb1ELb1EEEv") == \
        "attn_fwd_wgmma<128,0,1,1>"
    for name in ("_ZN71NS20attn_bwd_delta_wgmmaENS_9BwdParamsE", "gqa_bwd_reduce"):
        assert entry_key(name) == name


def test_compare_gqa_builds_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        cgb.main(["run", "cpu"])


def test_time_fast_chunk_usage():
    with pytest.raises(SystemExit, match="single-image main path"):
        tmp.main([])


@pytest.mark.parametrize("flags,frames", [(["--perf_preset", "fast"], 9), ([], 17)])
def test_time_fast_chunk_records_a_cpu_rehearsal(tmp_path, monkeypatch, flags, frames):
    """The main-path timer (scripts/time_main_path.py) through the CLI's
    entry point on the CPU (tiny preset, 4 steps): one fast 9-frame chunk
    and a two-chunk exact AR run, MoGe (the tiny config behind auto) for
    the seed frame and between the chunks; each chunk's step kinds and
    counts, the CLI's ``--timings_json`` file beside it, and its temporary
    files gone."""
    from gen3c_tpu_torch.aux import moge

    scratch = tmp_path / "tmp"
    scratch.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(scratch))
    monkeypatch.delenv("GEN3C_MOGE_CHECKPOINT", raising=False)
    written = tmp_path / "timings.json"
    calls = []
    infer = moge.moge_infer
    monkeypatch.setattr(moge, "moge_infer", lambda *a, **k: (calls.append(1), infer(*a, **k))[1])
    rec = tmp.run("cpu", ["--device", "cpu", "--model_preset", "gen3c_tiny", "--num_steps", "4",
                          "--num_video_frames", str(frames), "--timings_json", str(written)]
                  + flags)
    chunks = rec["chunks"]
    assert rec["device"] == "cpu" and rec["build_s"] > 0 and rec["frames"] == frames
    assert len(chunks) == len(calls) == (frames - 1) // 8  # MoGe: the seed, then between chunks
    assert moge.MOGE_VITL.width == 1024 and "GEN3C_MOGE_CHECKPOINT" not in os.environ
    if flags:  # the fast preset at 4 steps: guidance over the first two, no step cached
        assert ([(s["cfg"], s["refresh"]) for s in chunks[0]["steps"]]
                == [(True, True)] * 2 + [(False, True)] * 2)
        assert chunks[0]["cfg_refresh_s"]["n"] == 2 and chunks[0]["cond_refresh_s"]["n"] == 2
    else:
        assert [c["cfg_refresh_s"]["n"] for c in chunks] == [4, 4]
        assert chunks[0]["depth_s"] is None and chunks[1]["depth_s"] > 0
        assert chunks[1]["update_s"] > 0 and chunks[1]["render_s"] > 0
    assert all(c["cached_steps"] == 0 and c["peak_gib"] is None for c in chunks)
    assert rec["launches"]["K7"] == 0 and rec["peak_gib"] is None
    assert rec["entry_point_s"] > rec["build_s"] + rec["chunked_generation_s"] - 1e-6
    got = json.loads(written.read_text())
    assert got["build"] == rec["build_s"] and got["chunked_generation"] == rec["chunked_generation_s"]
    assert ([s["seconds"] for s in got["pipeline"][-1]["denoise_steps"]]
            == [s["s"] for s in chunks[-1]["steps"]])
    # its image, checkpoint and video are gone (torch.optim's first import of
    # torch._dynamo, in the depth alignment's Adam, leaves its cache directory)
    assert [p for p in scratch.iterdir() if not p.name.startswith("torchinductor")] == []


def _row(key, us, device=False, shapes=(), annotation=False, total=0.0):
    return SimpleNamespace(key=key, self_device_time_total=us, device_time_total=total,
                           device_type="DeviceType.CUDA" if device else "DeviceType.CPU",
                           is_user_annotation=annotation, input_shapes=list(shapes))


def test_profile_split_by_kind():
    tokens = (56320, 512)
    rows = [
        _row("void (anonymous namespace)::attn_bwd_dkdv_bf16_band<128, true>(P, B)", 6000.0, True),
        _row("void (anonymous namespace)::attn_fwd_lse_bf16_band<128, true>(P, B)", 3000.0, True),
        _row("nvjet_tst_192x192_64x4_2x1_v_bz_coopB_TNN", 2500.0, True),
        _row("void at::native::elementwise_kernel<128, 2>(...)", 700.0, True),
        _row("lora_merge", 300.0, True, annotation=True),  # the range's device side
        _row("lora_merge", 0.0, total=90.0),
        _row("aten::mm", 30.0, shapes=[[4096, 16], [16, 4096]]),  # A @ B
        _row("aten::mm", 400.0, shapes=[[4096, 56320], [56320, 4096]]),  # dense dW
        _row("aten::mm", 20.0, shapes=[[4096, 512], [512, 1024]]),  # cross k/v dW
        _row("aten::addmm", 2050.0, shapes=[[4096], [56320, 4096], [4096, 4096]]),
        _row("aten::mm", 0.0, shapes=[[1, 4096], [4096, 256]]),  # no device time
    ]
    got = prof.split(SimpleNamespace(key_averages=lambda group_by_input_shape: rows), tokens)
    assert got["kernel_ms"] == pytest.approx(12.2)
    assert got["attention_ms"] == {"attn_bwd_dkdv_bf16_band": 6.0, "attn_fwd_lse_bf16_band": 3.0}
    assert got["by_kind_ms"] == pytest.approx({
        "attention": 9.0, "gemm_merge": 0.03, "gemm_dense_dw": 0.42, "gemm_other": 2.05,
        "other": 12.2 - 9.0 - 2.5})
    assert got["lora_merge_range_ms"] == pytest.approx(0.09)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
@pytest.mark.parametrize("main", [probe.main, lambda: prof.main([]), lambda: sweep.main([])],
                         ids=["probe", "profile", "sweep"])
def test_scripts_refuse_to_run_without_a_card(main):
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        main()


def test_probe_sweeps_the_jax_scripts_cases():
    """P1's sweep: the JAX script's shapes at its R, each dtype's headline
    form (the widest the N tile allows) first, and at the block shapes the
    port's own forms no wider than the N tile."""
    assert probe.SQUARE_K == (128, 256, 512, 1024)
    assert [s[:3] for s in probe.BLOCK_SHAPES] == [(1408, 128, 1024), (1408, 1024, 128)]
    cases = probe.cases()
    forms = {}
    for c in cases:
        forms.setdefault((c["case"], c["dtype"]), []).append((c["form"], c["headline"]))
    reps = {c["case"]: c["reps"] for c in cases}
    assert reps == {"square K=128": 20000, "square K=256": 10000, "square K=512": 5000,
                    "square K=1024": 2500, "QK^T": 8000, "PV": 1000, "K1 S tile": 64000,
                    "K1 PV tile": 64000}
    for k in probe.SQUARE_K:
        for dtype in ("bf16", "int8"):
            assert forms[f"square K={k}", dtype] == [("ss256", True)]
    assert forms["QK^T", "bf16"] == [("ss256", True), ("ss64", False), ("ss128", False),
                                     ("rs128", False)]
    assert forms["QK^T", "int8"] == [("ss256", True), ("ss128", False)]
    assert forms["PV", "bf16"] == [("ss128", True), ("ss64", False), ("rs128", False)]
    assert forms["PV", "int8"] == [("ss128", True)]
    # K1's tiles: S (1408, 128) x (128, 64) and P V (1408, 64) x (64, 128), bf16
    assert forms["K1 S tile", "bf16"] == [("ss64", True)]
    assert forms["K1 PV tile", "bf16"] == [("ss128", True), ("rs128", False)]
    assert ("K1 S tile", "int8") not in forms
    tiles = {c["case"]: (c["M"], c["K"], c["N"]) for c in cases if c["case"].startswith("K1")}
    assert tiles == {"K1 S tile": (1408, 128, 64), "K1 PV tile": (1408, 64, 128)}
    assert all(c["form"] in kcuda.MMA_PROBE_FORMS[c["dtype"]] for c in cases)


def test_probe_ratios_pair_each_width_across_dtypes():
    rows = [{"case": "QK^T", "dtype": d, "form": f, "rate": r, "sustained": {"rate": r / 2}}
            for d, f, r in (("bf16", "ss256", 800.0), ("int8", "ss256", 1600.0),
                            ("bf16", "ss128", 700.0), ("int8", "ss128", 1050.0),
                            ("bf16", "ss64", 500.0))]
    rows.append({"case": "PV", "dtype": "bf16", "form": "ss128", "rate": 600.0})
    rows.append({"case": "PV", "dtype": "int8", "form": "ss128", "rate": 900.0})
    got = probe.ratios(rows)
    assert got == [
        {"case": "QK^T", "form": "ss128", "int8_over_bf16": 1.5, "basis": "sustained"},
        {"case": "QK^T", "form": "ss256", "int8_over_bf16": 2.0, "basis": "sustained"},
        {"case": "PV", "form": "ss128", "int8_over_bf16": 1.5, "basis": "median"}]


def test_sweep_configs_fit_shared_memory_and_warp_rows():
    """P2's points: (consumer warpgroups 2 or 3 of 64 query rows, 64 or 128
    keys a tile, 2-4 stages), each whose CTA fits 232,448 bytes of shared
    memory (attention_wgmma.cu's FwdSmem) and whose setmaxnreg split fits
    ptxas's register budget; K1's own point first, and the one point also
    read from the (B, H, L, D) layout."""
    grid = [(wg, bn, st) for wg in (2, 3) for bn in (64, 128) for st in (2, 3, 4)]
    pts = sweep.points()
    assert pts[0] == kcuda.K1_POINT == (2, 64, 4)
    assert set(pts) == {p for p in grid if kcuda.fwd_point_smem_bytes(p) <= kcuda.SMEM_LIMIT}
    assert len(pts) == len(set(pts)) == 9
    for wg, bn, st in pts:
        threads = 128 * (wg + 1)
        producer, consumer = kcuda.FWD_REGS[wg]
        assert kcuda.fwd_point_fits((wg, bn, st))
        assert 128 * producer + 128 * wg * consumer <= threads * (65536 // threads // 8 * 8)
        assert producer % 8 == consumer % 8 == 0 and 24 <= producer < consumer <= 256
    # the worked cases: K1's point, the widest 128-key point, one that does not fit
    assert kcuda.fwd_point_smem_bytes((2, 64, 4)) == 1024 + 32768 + 4 * 32768 + 72
    assert kcuda.fwd_point_smem_bytes((2, 128, 3)) == 230456 <= kcuda.SMEM_LIMIT
    assert not kcuda.fwd_point_fits((3, 128, 3))
    got = sweep.configs()
    assert got == [(p, "blhd") for p in pts] + [((2, 64, 4), "bhld")]
    assert sweep.configs(quick=True) == got[:-1]
    assert sweep.tag(((3, 64, 4), "blhd")) == "wg=3 bm=192 bn=64 stages=4 layout=blhd"
    assert sweep.FLOPS == 4.0 * 2 * 32 * 56320 ** 2 * 128


def test_sweep_points_build_apart_with_distinct_flags():
    """K1's point is the kernel library's own forward (no -D flag); every
    other point builds attention_wgmma.cu's forward alone with flags of its
    own, into a directory of its own, and the register split K1 uses is the
    source's default."""
    from gen3c_tpu_torch.kernels import build

    pts = sweep.points()
    assert kcuda.fwd_point_defines(kcuda.K1_POINT) == ()
    flags = [kcuda.fwd_point_defines(p) for p in pts[1:]]
    assert all(f and all(x.startswith("-DGEN3C_FWD_") for x in f) for f in flags)
    assert len(set(flags)) == len(flags)
    dirs = {build.build_dir(**build.forward_only(f)) for f in flags} | {build.build_dir()}
    assert len(dirs) == len(flags) + 1 and all(d.parent == build.BUILD_ROOT for d in dirs)
    assert build.forward_only(flags[0])["sources"] == (build.CSRC / "attention_wgmma.cu",)
    assert "-DGEN3C_FWD_WARPGROUPS=3" in kcuda.fwd_point_defines((3, 64, 4))
    assert "-DGEN3C_FWD_CONSUMER_REGS=160" in kcuda.fwd_point_defines((3, 64, 4))
    src = (build.CSRC / "attention_wgmma.cu").read_text()
    for name, value in (("WARPGROUPS", 2), ("BLOCK_N", 64), ("STAGES", 4),
                        ("PRODUCER_REGS", kcuda.FWD_REGS[2][0]),
                        ("CONSUMER_REGS", kcuda.FWD_REGS[2][1])):
        assert f"#define GEN3C_FWD_{name} {value}\n" in src

    class Built:  # what a build exports: its shape and its shared memory
        def __init__(self, point, regs, smem):
            self.shape, self.smem = (*point, *regs), smem

        def gen3c_attention_wgmma_fwd_point(self, out):
            out[:] = self.shape

        def gen3c_attention_wgmma_smem(self, dp, out):
            out[0] = self.smem[dp]

    for point in pts:
        smem = {d: kcuda.fwd_point_smem_bytes(point, d) for d in (64, 128)}
        kcuda._check_point(Built(point, kcuda.FWD_REGS[point[0]], smem), point)
        with pytest.raises(RuntimeError):  # another split in the source than cuda.py's
            kcuda._check_point(Built(point, (32, 224), smem), point)
        with pytest.raises(RuntimeError):  # a shared-memory layout the formula missed
            kcuda._check_point(Built(point, kcuda.FWD_REGS[point[0]],
                                     {d: b + 8 for d, b in smem.items()}), point)
