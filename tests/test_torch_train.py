"""The port's training path against the JAX package's, then the trainer's
own cases on the port.

Against the reference, on the same inputs: ``SyntheticLM`` batches (byte
for byte), ``make_train_step`` (1 and 2 microbatches) and the 10-step
in-proc 2-rank ``sgdm`` event-driven trainer from the reference's own init
(``jax.random.PRNGKey(0)``, carried over by the bridge).  Both compute in
float32 and differ by summation order only; SGD-momentum is linear in the
gradients, so that noise stays at its own size through the run: losses and
parameters are held within 1e-5.

Then, on the port alone, the cases of ``tests/test_trainer.py`` (replicas,
loss, 1 rank vs 2, async quorum, int8 grads, checkpoint and restart,
elastic recovery from ``kill_rank``, heartbeat suspicion), with that file's
tolerances.  Fault injection goes through the shared tests/_chaos.py
harness.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs files in parallel workers
torch.set_num_threads(1)

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

import _chaos as chaos                                       # noqa: E402
from repro.data import DataCfg as JDataCfg                   # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM           # noqa: E402
from repro.models import ModelCfg as JModelCfg               # noqa: E402
from repro.models import build_model as jbuild               # noqa: E402
from repro.optim import OptCfg as JOptCfg                    # noqa: E402
from repro.optim import make_optimizer as jmake_opt          # noqa: E402
from repro.runtime_dist import EventDrivenTrainer as JTrainer  # noqa: E402
from repro.runtime_dist import TrainerCfg as JTrainerCfg     # noqa: E402
from repro.train.step import make_train_step as jmake_step   # noqa: E402
from repro_torch.checkpoint import latest_step               # noqa: E402
from repro_torch.data import DataCfg, SyntheticLM            # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfa   # noqa: E402
from repro_torch.models import ModelCfg, build_model         # noqa: E402
from repro_torch.optim import OptCfg, make_optimizer         # noqa: E402
from repro_torch.tree import tree_map                       # noqa: E402
from repro_torch.runtime_dist import (EventDrivenTrainer,    # noqa: E402
                                      TrainerCfg, flatten_params)
from repro_torch.train import make_train_step, value_and_grad  # noqa: E402

TOL = 1e-5
_TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=4, head_dim=16, d_ff=128, vocab=128,
             dtype="float32", remat="none", max_target_length=64)
_DATA = dict(vocab=128, seq=32, global_batch=12, seed=7)
_OPT = dict(name="adamw", peak_lr=3e-2, warmup=5, total_steps=200,
            clip_norm=1.0)
_SGD = dict(name="sgdm", peak_lr=1e-2, warmup=5, total_steps=200)
TINY, DATA, OPT = ModelCfg(**_TINY), DataCfg(**_DATA), OptCfg(**_OPT)


@pytest.fixture(scope="module")
def jparams():
    """The reference's init of TINY, as host numpy."""
    return jax.tree.map(np.asarray,
                        jbuild(JModelCfg(**_TINY)).init(jax.random.PRNGKey(0)))


def make_trainer(**kw):
    opt = kw.pop("opt", OPT)
    params = kw.pop("params", None)
    tc = TrainerCfg(steps=kw.pop("steps", 12), n_ranks=kw.pop("n_ranks", 2),
                    **kw)
    return EventDrivenTrainer(build_model(TINY), DATA, opt, tc,
                              device="cpu", params=params)


def _leaves(p):
    flat = flatten_params(p)
    return [flat[k] for k in sorted(flat)]


def _assert_trees_close(a, b, rtol, atol):
    fa, fb = flatten_params(a), flatten_params(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_allclose(fa[k], fb[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def _losses(hist):
    return {(m["rank"], m["step"]): m["loss"] for m in hist}


# ------------------------------------------------------------ against JAX
@pytest.mark.parametrize("step,shard,n_shards",
                         [(0, 0, 1), (3, 1, 2), (9, 2, 3), (11, 3, 4)])
def test_synthetic_batches_byte_equal(step, shard, n_shards):
    jb = JSyntheticLM(JDataCfg(**_DATA)).batch(step, shard, n_shards)
    tb = SyntheticLM(DataCfg(**_DATA)).batch(step, shard, n_shards)
    assert sorted(jb) == sorted(tb)
    for k in jb:
        assert jb[k].dtype == tb[k].dtype
        assert jb[k].tobytes() == tb[k].tobytes()
    jf = JSyntheticLM(JDataCfg(**_DATA)).frontend_batch(
        step, shard, n_shards, 16, 4, "patch_embeds")
    tf = SyntheticLM(DataCfg(**_DATA)).frontend_batch(
        step, shard, n_shards, 16, 4, "patch_embeds")
    assert jf["patch_embeds"].tobytes() == tf["patch_embeds"].tobytes()


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches(jparams, microbatches):
    """Two steps of make_train_step (sgdm) from the same params on the
    same batches: loss, grad norm and params."""
    jm = jbuild(JModelCfg(**_TINY))
    jstep = jax.jit(jmake_step(jm, jmake_opt(JOptCfg(**_SGD)),
                               microbatches=microbatches))
    tm = build_model(TINY)
    topt = make_optimizer(OptCfg(**_SGD))
    tstep = make_train_step(tm, topt, microbatches=microbatches)
    data = SyntheticLM(DATA)
    jp = jax.tree.map(jnp.asarray, jparams)
    js = jmake_opt(JOptCfg(**_SGD)).init(jp)
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)), jparams)
    ts = topt.init(tp)
    for step in range(2):
        batch = data.batch(step)
        jp, js, jmet = jstep(jp, js, {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                             jnp.asarray(step))
        tp, ts, tmet = tstep(tp, ts, {k: torch.from_numpy(v).long()
                                      for k, v in batch.items()}, step)
        for key in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       rtol=TOL, atol=TOL, err_msg=key)
    _assert_trees_close(tp, jp, rtol=TOL, atol=TOL)


def test_train_step_rejects_uneven_microbatches(jparams):
    tm = build_model(TINY)
    topt = make_optimizer(OptCfg(**_SGD))
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)), jparams)
    batch = {k: torch.from_numpy(v).long()
             for k, v in SyntheticLM(DATA).batch(0).items()}
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(tm, topt, microbatches=5)(tp, topt.init(tp), batch,
                                                   0)


def test_grads_count_the_forward_and_backward_of_each_layer(jparams):
    """On the CPU the kernel path's attention is the plain version: a
    training step counts one plain call and one backward recompute a
    layer, and launches nothing."""
    tm = build_model(TINY)
    assert tm.cfg.attn_impl == "kernel"
    params = tree_map(lambda a: torch.from_numpy(np.array(a)), jparams)
    batch = {k: torch.from_numpy(v).long()
             for k, v in SyntheticLM(DATA).batch(0).items()}
    before = (tfa.kernel_launches, tfa.plain_calls, tfa.backward_recomputes)
    (loss, _), grads = value_and_grad(tm, params, batch)
    after = (tfa.kernel_launches, tfa.plain_calls, tfa.backward_recomputes)
    n = TINY.n_layers
    assert tuple(a - b for a, b in zip(after, before)) == (0, n, n)
    assert tm.params is None          # the model only lent its config
    assert not loss.requires_grad
    assert [g.shape for g in _leaves(grads)] == [
        p.shape for p in _leaves(params)]


def test_trainer_matches_jax_trainer(jparams):
    """10 in-proc steps, 2 ranks, sgdm, the reference's init on both:
    loss history and every rank's final params."""
    jout = JTrainer(jbuild(JModelCfg(**_TINY)), JDataCfg(**_DATA),
                    JOptCfg(**_SGD),
                    JTrainerCfg(steps=10, n_ranks=2)).run()
    tout = make_trainer(steps=10, n_ranks=2, opt=OptCfg(**_SGD),
                        params=jparams).run()
    jl, tl = _losses(jout["history"]), _losses(tout["history"])
    assert sorted(jl) == sorted(tl) and len(tl) == 20
    for k in jl:
        np.testing.assert_allclose(tl[k], jl[k], rtol=TOL, atol=TOL,
                                   err_msg=str(k))
    for r in range(2):
        _assert_trees_close(tout["final_params"][r],
                            jax.tree.map(np.asarray,
                                         jout["final_params"][r]),
                            rtol=TOL, atol=TOL)
    # what the final events carried equals the live trees
    for r in range(2):
        _assert_trees_close(tout["final_by_rank"][r],
                            tout["final_params"][r], rtol=0, atol=0)


# ------------------------------------------------- the port's own trainer
def test_sync_dp_replicas_stay_identical_and_loss_decreases():
    tr = make_trainer(steps=25, n_ranks=2)
    out = tr.run()
    hist = out["history"]
    assert len(hist) >= 25
    first = np.mean([m["loss"] for m in hist if m["step"] <= 3])
    last = np.mean([m["loss"] for m in hist if m["step"] >= 23])
    assert last < first - 0.2, (first, last)
    p0, p1 = out["final_params"]
    for a, b in zip(_leaves(p0), _leaves(p1)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_sync_dp_matches_single_rank_half_batch():
    """2-rank sync DP with grad averaging == 1 rank on the full batch
    (sgdm: updates linear in the gradients; see tests/test_trainer.py)."""
    sgd = OptCfg(**_SGD)
    out2 = make_trainer(steps=6, n_ranks=2, opt=sgd).run()
    out1 = make_trainer(steps=6, n_ranks=1, opt=sgd).run()
    for a, b in zip(_leaves(out2["final_params"][0]),
                    _leaves(out1["final_params"][0])):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-5)


def test_async_quorum_makes_progress():
    tr = make_trainer(steps=20, n_ranks=3, quorum=0.5, collect_timeout=2.0)
    out = tr.run()
    hist = out["history"]
    assert max(m["step"] for m in hist) >= 20
    first = np.mean([m["loss"] for m in hist if m["step"] <= 3])
    last = np.mean([m["loss"] for m in hist if m["step"] >= 18])
    assert last < first


def test_int8_gradient_compression_converges():
    tr = make_trainer(steps=25, n_ranks=2, compress="int8")
    out = tr.run()
    hist = out["history"]
    first = np.mean([m["loss"] for m in hist if m["step"] <= 3])
    last = np.mean([m["loss"] for m in hist if m["step"] >= 23])
    assert last < first - 0.15, (first, last)


def test_async_checkpoint_and_restart(tmp_path):
    ckdir = str(tmp_path / "ck")
    tr = make_trainer(steps=10, n_ranks=2, ckpt_dir=ckdir, ckpt_every=5)
    out = tr.run()
    assert out["ckpt_writes"] >= 2
    assert latest_step(ckdir) == 10

    # restart from the checkpoint and keep training: loss continues down
    tr2 = make_trainer(steps=16, n_ranks=2, ckpt_dir=ckdir, ckpt_every=100,
                       start_step=10)
    out2 = tr2.run()
    assert max(m["step"] for m in out2["history"]) >= 16
    # exact resume: a fresh run to 16 equals ckpt-resume to 16
    out3 = make_trainer(steps=16, n_ranks=2).run()
    for a, b in zip(_leaves(out2["final_params"][0]),
                    _leaves(out3["final_params"][0])):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


def test_node_failure_recovery_elastic(tmp_path):
    """Kill a rank mid-run: survivors roll back to the last checkpoint,
    re-shard data, and finish training."""
    ckdir = str(tmp_path / "ck")
    tr = make_trainer(steps=30, n_ranks=3, ckpt_dir=ckdir, ckpt_every=5,
                      collect_timeout=1.0)
    # kill only once a real (non-initial) checkpoint exists — the
    # rollback anchor the survivors need
    sab = chaos.Saboteur(lambda: tr.runtime.kill_rank(2),
                         pred=lambda: (latest_step(ckdir) or 0) >= 5,
                         delay=0.3).start()
    out = tr.run(timeout=240)
    sab.join()
    hist = out["history"]
    assert max(m["step"] for m in hist) >= 30
    assert out["recoveries"]
    p0, p1 = out["final_params"][0], out["final_params"][1]
    for a, b in zip(_leaves(p0), _leaves(p1)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    # late metrics should show 2-rank quorums after the failure
    late = [m for m in hist if m["step"] >= 28]
    assert all(m["n_grads"] <= 2 for m in late)


def test_heartbeat_suspects_hung_rank(tmp_path):
    """A rank that hangs (but is not dead) stops heartbeating; the timer-
    driven monitor suspects it, survivors roll back and re-shard, and the
    suspect fences itself on waking (fail-stop enforcement)."""
    ckdir = str(tmp_path / "ck")
    tr = make_trainer(steps=24, n_ranks=3, ckpt_dir=ckdir, ckpt_every=4,
                      collect_timeout=0.8, hb_interval=0.25, hb_timeout=1.2,
                      stall=chaos.stall_spec(2, at_step=6, seconds=4.0))
    out = tr.run(timeout=240)
    hist = out["history"]
    assert max(m["step"] for m in hist) >= 24
    # after the suspicion, quorums are 2-rank
    late = [m for m in hist if m["step"] >= 22]
    assert late and all(m["n_grads"] <= 2 for m in late)
    assert all(m["rank"] != 2 for m in late)   # the suspect stayed fenced
    p0, p1 = out["final_params"][0], out["final_params"][1]
    for a, b in zip(_leaves(p0), _leaves(p1)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
