"""The port's event-driven trainer on reduced mamba2-370m against the JAX
package's, and the SSD wrapper's counts under autograd.

Reduced mamba2-370m (``reduce_cfg``: 2 SSD layers, d_model 128, 16 heads
of 16, state 16, chunk 32, float32).  Both trainers start from the
reference's init (``jax.random.PRNGKey(0)``), carried over as host numpy
as :mod:`repro_torch.bridge` carries it, and run 2 in-proc ranks of
``sgdm``.  The reference's model takes ``attn_impl="pallas"``, so its
interpreted SSD kernel and that kernel's ``custom_vjp`` (the plain scan
recomputed in the backward) run; the port's takes ``"kernel"``, whose
wrapper answers with its plain version on the CPU and recomputes it in the
backward.  Both compute in float32 and differ by summation order only, so
loss histories and every rank's final parameters are held within 1e-5, as
``tests/test_torch_train.py`` holds the dense ``TINY``.  At a T ragged
against the chunk the reference's Pallas route raises, so that case is
held to its ``attn_impl="ref"``.

Then the wrapper's counts (``ops.backward_recomputes`` beside the forward's
``plain_calls``) and the planted fault that ``chip_smoke.py``'s phase 43
must reject, on the reduced plain path's loss.
"""
import math
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs files in parallel workers
torch.set_num_threads(1)

import jax                                                   # noqa: E402

from repro.configs import ARCHS as JARCHS                    # noqa: E402
from repro.configs import reduce_cfg as jreduce              # noqa: E402
from repro.core import EdatTaskError                         # noqa: E402
from repro.data import DataCfg as JDataCfg                   # noqa: E402
from repro.models import build_model as jbuild               # noqa: E402
from repro.optim import OptCfg as JOptCfg                    # noqa: E402
from repro.runtime_dist import EventDrivenTrainer as JTrainer  # noqa: E402
from repro.runtime_dist import TrainerCfg as JTrainerCfg     # noqa: E402
from repro_torch import bridge                               # noqa: E402
from repro_torch.configs import ARCHS, reduce_cfg            # noqa: E402
from repro_torch.data import DataCfg, SyntheticLM            # noqa: E402
from repro_torch.kernels.ssd import ops as tssd              # noqa: E402
from repro_torch.models import build_model                   # noqa: E402
from repro_torch.optim import OptCfg                         # noqa: E402
from repro_torch.runtime_dist import (EventDrivenTrainer,    # noqa: E402
                                      TrainerCfg, flatten_params)

sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
import chip_smoke                                            # noqa: E402

pytestmark = pytest.mark.timeout(300)

ARCH = "mamba2-370m"
TOL = 1e-5
STEPS = 4
_SGD = dict(name="sgdm", peak_lr=1e-2, warmup=5, total_steps=200)
SEQ = 64                  # 2 chunks of 32
RAGGED_SEQ = 48           # 1.5 chunks


def _cfgs(remat="none"):
    """(reference config, port config) of reduced mamba2-370m."""
    return (jreduce(JARCHS[ARCH].cfg).replace(remat=remat),
            reduce_cfg(ARCHS[ARCH].cfg).replace(remat=remat))


@pytest.fixture(scope="module")
def jparams():
    """The reference's init of reduced mamba2-370m, as host numpy."""
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))


def _data(cfg, seq):
    return dict(vocab=cfg.vocab, seq=seq, global_batch=4, seed=7)


def _losses(hist):
    return {(m["rank"], m["step"]): m["loss"] for m in hist}


@pytest.mark.parametrize("remat,seq,jimpl", [("none", SEQ, "pallas"),
                                             ("full", SEQ, "pallas"),
                                             ("none", RAGGED_SEQ, "ref")])
def test_trainer_matches_jax_trainer(jparams, remat, seq, jimpl):
    """STEPS in-proc steps, 2 ranks, sgdm, the reference's init on both:
    loss history and every rank's final params within TOL."""
    jcfg, cfg = _cfgs(remat)
    assert cfg.attn_impl == "kernel"
    data = _data(cfg, seq)
    jout = JTrainer(jbuild(jcfg.replace(attn_impl=jimpl)), JDataCfg(**data),
                    JOptCfg(**_SGD),
                    JTrainerCfg(steps=STEPS, n_ranks=2)).run()
    before = (tssd.plain_calls, tssd.backward_recomputes)
    tout = EventDrivenTrainer(build_model(cfg), DataCfg(**data),
                              OptCfg(**_SGD),
                              TrainerCfg(steps=STEPS, n_ranks=2),
                              device="cpu", params=jparams).run()
    # each rank-step: a forward a layer, again in the remat recompute, and
    # one recompute of the plain scan a layer in the backward
    rank_layers = 2 * STEPS * cfg.n_layers
    assert (tssd.plain_calls - before[0],
            tssd.backward_recomputes - before[1]) == (
        rank_layers * (2 if remat == "full" else 1), rank_layers)
    jl, tl = _losses(jout["history"]), _losses(tout["history"])
    assert sorted(jl) == sorted(tl) and len(tl) == 2 * STEPS
    for k in jl:
        np.testing.assert_allclose(tl[k], jl[k], rtol=TOL, atol=TOL,
                                   err_msg=str(k))
    for r in range(2):
        got = flatten_params(tout["final_params"][r])
        want = flatten_params(jax.tree.map(np.asarray,
                                           jout["final_params"][r]))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                       err_msg=f"rank {r} {k}")


def test_pallas_route_raises_at_a_ragged_length(jparams):
    """The reference's Pallas route takes T % chunk == 0 only: why the
    ragged case is held to its plain route."""
    jcfg, cfg = _cfgs()
    with pytest.raises(EdatTaskError, match="reshape"):
        JTrainer(jbuild(jcfg.replace(attn_impl="pallas")),
                 JDataCfg(**_data(cfg, RAGGED_SEQ)), JOptCfg(**_SGD),
                 JTrainerCfg(steps=1, n_ranks=1)).run()


def _model(jparams, remat="none", impl="kernel"):
    _, cfg = _cfgs(remat)
    tm = build_model(cfg.replace(attn_impl=impl))
    bridge.params_from_jax_numpy(jparams, tm, "cpu")
    return tm


def _batch(cfg, seq=SEQ):
    return {k: torch.from_numpy(v).long() for k, v in SyntheticLM(
        DataCfg(**_data(cfg, seq))).batch(0).items()}


@pytest.mark.parametrize("remat,grad", [("none", True), ("full", True),
                                        ("none", False)])
def test_backward_counts_one_recompute_a_layer(jparams, remat, grad):
    """One loss and its backward count a plain call a layer (two under
    remat "full": the recompute) and one backward recompute a layer; a
    forward under no_grad counts no recompute.  ``reset_counts`` zeroes
    the recomputes with the rest."""
    tm = _model(jparams, remat)
    n = tm.cfg.n_layers
    tssd.reset_counts()
    if grad:
        loss, _ = tm.loss(_batch(tm.cfg))
        loss.backward()
    else:
        with torch.no_grad():
            tm.loss(_batch(tm.cfg))
    assert (tssd.kernel_launches, tssd.plain_calls,
            tssd.backward_recomputes) == (
        0, n * (2 if remat == "full" and grad else 1), n if grad else 0)
    tssd.reset_counts()
    assert (tssd.plain_calls, tssd.backward_recomputes) == (0, 0)


@pytest.mark.parametrize("fault", [chip_smoke.SSD_CONTROL,
                                   chip_smoke.SSD_TRAIN_FAULT])
def test_planted_fault_moves_the_loss_past_the_parity_gate(jparams, fault):
    """At Mamba-2's init of a_log and dt_bias the reduced plain path's
    loss over 4 chunks moves past phase 43's parity gate (TRAIN_LOSS_RTOL
    of the loss) with the term between chunks dropped, and stays within
    it under the chunk-by-chunk control."""
    tm = _model(jparams, impl="ref")
    chip_smoke._mamba2_init(tm.params.to_dict())
    batch = _batch(tm.cfg, seq=4 * tm.cfg.ssm.chunk)
    with torch.no_grad():
        sound = float(tm.loss(batch)[0])
        with chip_smoke._train_fault(fault):
            planted = float(tm.loss(batch)[0])
    assert math.isfinite(sound) and math.isfinite(planted)
    moved = abs(planted - sound) > chip_smoke.TRAIN_LOSS_RTOL * abs(sound)
    assert moved == (fault != chip_smoke.SSD_CONTROL), (sound, planted)
