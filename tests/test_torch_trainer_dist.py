"""The port's elastic trainer running *distributed* through the v2 Session
API: spawned OS processes, two ranks per process, gradient exchange over
the coalescing SocketTransport — and SIGKILL-grade fault tolerance.

The cases of ``tests/test_trainer_dist.py`` on ``repro_torch``, on the CPU
(``device="cpu"``, resolved in this process and handed to the spawned ones
as a ``torch.device``):

* 4 ranks across 2 processes train to completion and every rank's final
  parameters equal an in-proc (threads-as-ranks) run of the same config;
* SIGKILL one process mid-run: the two ranks of the other process detect
  the failure via the transport heartbeat, roll back to the last durable
  checkpoint, re-shard, finish, and match an uninterrupted in-proc run of
  the same elastic schedule (4 ranks to the recovery step, then 2).

The quorum folds gradients in rank order, data shards are pure functions
of (step, shard, n_shards), and replicas share the seed, so the runs are
numerically interchangeable: the reference file's tolerances hold.  Every
process computes with one intra-op thread (``OMP_NUM_THREADS=1``, which the
spawned processes inherit), as this one does.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import _chaos as chaos                                       # noqa: E402
from repro_torch import edat                                 # noqa: E402
from repro_torch.checkpoint import latest_step               # noqa: E402
from repro_torch.data import DataCfg                         # noqa: E402
from repro_torch.models import ModelCfg, build_model         # noqa: E402
from repro_torch.optim import OptCfg                         # noqa: E402
from repro_torch.runtime_dist import (EventDrivenTrainer,    # noqa: E402
                                      TrainerCfg, flatten_params,
                                      trainer_program)

pytestmark = pytest.mark.timeout(600)

TINY = ModelCfg(
    name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=128, vocab=128,
    dtype="float32", remat="none", max_target_length=64,
)
DATA = DataCfg(vocab=128, seq=32, global_batch=12, seed=7)
OPT = OptCfg(name="adamw", peak_lr=3e-2, warmup=5, total_steps=200,
             clip_norm=1.0)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _inproc(**kw):
    tc = TrainerCfg(steps=kw.pop("steps", 12), n_ranks=kw.pop("n_ranks", 2),
                    **kw)
    return EventDrivenTrainer(build_model(TINY), DATA, OPT, tc, device=CPU)


def _assert_params_close(flat_a, flat_b, rtol=1e-5, atol=1e-6):
    assert sorted(flat_a) == sorted(flat_b)
    for k in flat_a:
        np.testing.assert_allclose(flat_a[k], flat_b[k], rtol=rtol,
                                   atol=atol, err_msg=k)


def test_distributed_trainer_matches_inproc(tmp_path):
    """No faults: 4 ranks / 2 processes over sockets == 4 threads-as-ranks
    in one process, final params compared rank by rank."""
    steps = 6
    cfg = TrainerCfg(steps=steps, n_ranks=4, collect_timeout=60.0)
    with edat.Session(4, procs=2, transport="socket", timeout=300.0,
                      workers_per_rank=cfg.workers_per_rank,
                      unconsumed="ignore") as s:
        s.run(edat.deferred(trainer_program, TINY, DATA, OPT, cfg,
                            device=CPU))
        res = s.gather()
        wire = s.stats["transport"]
    assert sorted(res["final_params"]) == [0, 1, 2, 3]
    assert max(m["step"] for m in res["history"]) >= steps
    # sync quorum: every recorded step consumed all 4 replicas' grads
    assert all(m["n_grads"] == 4 for m in res["history"])
    assert wire["wire_events_sent"] > 0      # grads really crossed sockets

    out = _inproc(steps=steps, n_ranks=4, collect_timeout=60.0).run()
    ref = flatten_params(out["final_params"][0])
    for r in range(4):
        _assert_params_close(res["final_params"][r], ref)


def test_distributed_sigkill_recovery_matches_inproc_elastic(tmp_path):
    """4 ranks / 2 processes, SIGKILL the process hosting ranks 2+3 once a
    real checkpoint exists.  The co-located survivors recover from the
    shared on-disk checkpoint and finish — and match an uninterrupted
    in-proc run of the same elastic schedule (4 ranks to the recovery step
    R, 2 ranks from R)."""
    steps, every = 12, 3
    ckdir = str(tmp_path / "ck")
    cfg = TrainerCfg(steps=steps, n_ranks=4, ckpt_dir=ckdir,
                     ckpt_every=every, collect_timeout=30.0)
    with edat.Session(4, procs=2, transport="socket", timeout=300.0,
                      workers_per_rank=cfg.workers_per_rank,
                      unconsumed="ignore", hb_interval=0.2,
                      hb_timeout=1.5) as s:
        s.start(edat.deferred(trainer_program, TINY, DATA, OPT, cfg,
                              device=CPU))
        chaos.wait_for(lambda: (latest_step(ckdir) or 0) >= every, 240,
                       desc="first periodic checkpoint")
        s.kill(3)
        s.wait(300, check=False)
        codes = s.exitcodes()
        res = s.gather()
    assert codes[2] != 0 and codes[3] != 0        # the victim pair
    assert codes[0] == 0 and codes[1] == 0        # survivors finished

    hist = res["history"]
    assert max(m["step"] for m in hist) >= steps
    # exactly one coordinated recovery per survivor
    recs = res["recoveries"]
    assert sorted(r["rank"] for r in recs) == [0, 1], recs
    assert len({(r["step"], r["epoch"]) for r in recs}) == 1, recs
    R = recs[0]["step"]
    assert R >= every and R % every == 0
    # survivors re-sharded: the elastic tail ran on 2-rank quorums
    tail = [m for m in hist if m["step"] > steps - 2]
    assert tail and all(m["n_grads"] == 2 for m in tail)
    assert sorted(res["final_params"]) == [0, 1]  # the dead never report

    # ---- uninterrupted in-proc reference of the same elastic schedule
    refck = str(tmp_path / "refck")
    _inproc(steps=R, n_ranks=4, ckpt_dir=refck, ckpt_every=every,
            collect_timeout=30.0).run()
    assert latest_step(refck) == R
    out_b = _inproc(steps=steps, n_ranks=2, ckpt_dir=refck,
                    start_step=R, ckpt_every=10_000,
                    collect_timeout=30.0).run()
    assert max(m["step"] for m in out_b["history"]) >= steps
    ref = flatten_params(out_b["final_params"][0])
    for r in (0, 1):
        _assert_params_close(res["final_params"][r], ref)
