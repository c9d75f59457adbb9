"""FSDP for the DiT trainer (``parallel.sharding.shard_fsdp``,
``make_sharded_train_step(fsdp_axis="dp")``, ``Trainer(fsdp=True)``,
``train.py --fsdp``) against JAX's one-device ``train_step`` and the
port's one-rank step, on CPU ranks over gloo.

A pool of 8 spawned ranks (``tests/torch_cp_ranks.py``) runs each (dp, cp,
tp) layout, smaller ones as replicas; the setup and tolerances are
tests/test_torch_cp_train.py's (the tiny GEN3C DiT, fp32, 2 steps with the
logvar head, video-extend, text dropout, warmup 2 and an active clip).
gen3c_tpu's own FSDP tests (tests/test_training.py:108, :148) hold its
FSDP + remat and SP + remat + FSDP steps on dp 2 x cp 2 x tp 2 to its
plain step (loss rtol 1e-5, q weight rtol 1e-4 / atol 1e-6): here the
loss and the grad norm hold at 1e-5 to the port's one rank, and each
parameter and first moment, gathered from the shards, as in
test_torch_cp_train.py. Each rank holds exactly its share of the leaves'
elements: params, first moments and EMA.
"""

import numpy as np
import pytest

from tests import torch_cp_ranks
from tests.test_torch_cp_train import _assert_matches, _references
from tests.test_torch_cp_train import KW as TRAIN_KW

WORLD = 8


@pytest.fixture(scope="module")
def ranks():
    pool = torch_cp_ranks.Ranks(WORLD)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def refs():
    return _references("gen3c", TRAIN_KW)


def _held(job, dims, tp_dims, dp, tp):
    """The elements one rank holds of the state's params: each FSDP leaf's
    1/dp (and 1/tp of a tp leaf), the rest whole."""
    total = 0
    for n, w in job.items():
        share = 1
        share *= dp if n in dims else 1
        share *= tp if n in tp_dims else 1
        assert w.size % share == 0, n
        total += w.size // share
    return total


# (dp, cp, tp, sequence parallelism, remat)
_LAYOUTS = [(2, 1, 1, False, False), (2, 2, 1, False, True), (2, 1, 2, False, False),
            (2, 2, 2, False, True), (2, 2, 2, True, True)]


@pytest.mark.parametrize("dp,cp,tp,sp,remat", _LAYOUTS,
                         ids=[f"dp{d}-cp{c}-tp{t}{'-sp' if s else ''}{'-remat' if r else ''}"
                              for d, c, t, s, r in _LAYOUTS])
def test_fsdp_steps_match_jax_and_one_rank(ranks, refs, dp, cp, tp, sp, remat):
    """FSDP beside cp, tp and SP, with and without remat (the recompute
    gathers each block's leaves again): the loss and grad norm of every
    step, and every parameter and first moment after 2 steps, gathered,
    against JAX's one-device step and the port's one rank; the leaves cut
    over dp are JAX's (``dit_param_pspecs(fsdp_axis="dp")``: every q/k/v/
    out and fc1/fc2 at this width), and each rank holds exactly its share
    of the params, moments and EMA."""
    job, jax_out, one = refs
    job = dict(job, step_kw=dict(job["step_kw"], sequence_parallel=sp, remat=remat))
    results = ranks.run("train", dp=dp, cp=cp, tp=tp, fsdp=True, **job)
    n = dp * cp * tp
    places = [(r["dp_rank"], r["cp_rank"], r["tp_rank"]) for r in results[:n]]
    assert places == [(d, c, k) for d in range(dp) for c in range(cp) for k in range(tp)]
    _assert_matches(results, jax_out, one)
    cut = set(results[0]["fsdp"])
    assert len(cut) == 2 * (2 * 4 + 2) and cut >= set(results[0]["sharded"])
    tp_cut = set(results[0]["sharded"])
    want = _held(one["params"], cut, tp_cut, dp, tp)
    for r in results:
        assert r["held"] == {"params": want, "mu": want, "ema": want}, r["held"]
        for n, w in one["mu"].items():  # the first moments, gathered from the shards
            scale = max(np.abs(w).max(), 1e-12)
            assert np.abs(r["mu"][n] - w).max() <= 1e-4 * scale, n


def test_fsdp_at_dp1_is_a_no_op(ranks, refs):
    """At dp 1 FSDP cuts nothing and the step is the plain one (gen3c_tpu's
    dp-1 mesh runs its FSDP specs the same way)."""
    job, jax_out, one = refs
    results = ranks.run("train", dp=1, cp=2, tp=1, fsdp=True, **job)
    assert results[0]["fsdp"] == []
    _assert_matches(results, jax_out, one)


def test_fsdp_save_gathers_one_tensor_at_a_time(ranks):
    """The checkpoint gather of an FSDP state (dp 2 x tp 2): over dp, then
    tp, a tensor at a time; rank 0's host state equals the one-device
    state bit for bit."""
    out = ranks.run("save_gather", dp=2, tp=2, fsdp=True)
    for r, o in enumerate(out):
        assert o["alive_at_gather"] <= 1, o  # a leaf cut on both axes: its dp gather feeds tp's
        assert o["fsdp"] == 2 * (2 * 4 + 2), o
        assert o["host_none"] == (r % 4 != 0), o  # a replica's first rank writes
    for o in out[::4]:
        assert o["equal"] is True and o["on_host"] is True


def test_trainer_fsdp_checkpoints_cross_layouts(ranks, tmp_path):
    """A checkpoint written with FSDP over dp 2 x tp 2 restores on one
    device, which trains a step and writes its own; that one restores with
    FSDP again, every rank slicing its shards back; the parameters follow
    the one-device run."""
    from gen3c_tpu_torch.training.train import build_net
    from gen3c_tpu_torch.training.trainer import Trainer

    job = str(tmp_path / "job")
    cut = ranks.run("trainer_run", dp=2, tp=2, job_dir=job, max_iter=2, fsdp=True)
    assert [r["step"] for r in cut] == [2] * WORLD and cut[0]["fsdp"] == 2 * (2 * 4 + 2)
    cfg = torch_cp_ranks.train_cfg("gen3c")
    one = Trainer(torch_cp_ranks.trainer_config(job, 3), cfg, build_net(cfg, "cpu", 0))
    assert one.maybe_resume() == 2
    for n, p in one.state.params.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), cut[0]["params"][n])
    state = one.train(torch_cp_ranks.trainer_data())
    import shutil

    shutil.copytree(tmp_path / "job", tmp_path / "job_replica1", dirs_exist_ok=True)
    back = ranks.run("trainer_run", dp=2, tp=2, job_dir=job, max_iter=3, fsdp=True)
    for r in back:
        assert r["step"] == 3
        for n, p in state.params.named_parameters():
            np.testing.assert_array_equal(r["params"][n], p.detach().numpy())
