"""The port's serving subsystem against the JAX package's, same weights.

Weights are the JAX engine's own seeded init, carried to the port as numpy
(``params=``).  The port's engine must emit the reference engine's greedy
tokens, including when a slot is reused, and the port's event-driven
server (its copy of the EDAT runtime, in-proc) must emit the reference's
sequential baseline tokens request for request.
"""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs files in parallel workers, and
# oversubscribed cores starve the socket tests' heartbeat threads
torch.set_num_threads(1)

import jax                                                   # noqa: E402
import numpy as np                                           # noqa: E402

from repro.configs import ARCHS as JARCHS                    # noqa: E402
from repro.configs import reduce_cfg as jreduce              # noqa: E402
from repro.serve import ServeEngine as JServeEngine          # noqa: E402
from repro.serve import all_requests as jall_requests        # noqa: E402
from repro.serve import run_sequential as jrun_sequential    # noqa: E402
from repro_torch.configs import ARCHS, reduce_cfg            # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfa   # noqa: E402
from repro_torch.serve import (LoadSpec, ServeEngine,        # noqa: E402
                               all_requests, run_serve)

pytestmark = pytest.mark.timeout(600)

ARCH = "gemma3-1b"
MAX_LEN = 48


@pytest.fixture(scope="module")
def cfgs():
    return reduce_cfg(ARCHS[ARCH].cfg), jreduce(JARCHS[ARCH].cfg)


@pytest.fixture(scope="module")
def jax_params(cfgs):
    eng = JServeEngine(cfgs[1], slots=1, max_len=MAX_LEN)
    return jax.tree.map(np.asarray, eng.params)


def _serve(e, prompt, n):
    first, pc = e.prefill(prompt)
    e.attach(0, len(prompt), first, pc)
    out = [first]
    for _ in range(n - 1):
        out.append(int(e.step([0])[0]))
    return out


def test_engine_tokens_match_reference_with_slot_reuse(cfgs, jax_params):
    """Request A dirties slot 0, then B reuses it: both engines emit the
    same tokens for A and for B (the reference's slot-reuse regression)."""
    cfg, jcfg = cfgs
    rng = np.random.default_rng(7)
    pa = rng.integers(0, cfg.vocab, size=8).tolist()
    pb = rng.integers(0, cfg.vocab, size=12).tolist()
    jeng = JServeEngine(jcfg, slots=1, max_len=MAX_LEN)
    teng = ServeEngine(cfg, slots=1, max_len=MAX_LEN, device="cpu",
                       params=jax_params)
    before = tfa.plain_calls
    got = [_serve(teng, pa, 10), _serve(teng, pb, 10)]
    assert tfa.plain_calls == before + 2 * cfg.n_layers
    assert got == [_serve(jeng, pa, 10), _serve(jeng, pb, 10)]


def test_engine_dead_slot_pos_pinned(cfgs):
    eng = ServeEngine(cfgs[0], slots=2, max_len=MAX_LEN, device="cpu")
    prompt = list(range(1, 9))
    first, pc = eng.prefill(prompt)
    eng.attach(0, len(prompt), first, pc)
    for _ in range(5):
        eng.step([0])
    assert int(eng.pos[0, 0]) == len(prompt) + 5
    assert int(eng.pos[1, 0]) == 0              # dead slot pinned


def test_run_serve_matches_reference_sequential(cfgs, jax_params):
    """2 slots for 7 requests forces slot reuse; the port's in-proc
    Session(ranks=3) server answers every request with the reference's
    sequential tokens, from one decode chain."""
    cfg, jcfg = cfgs
    load = LoadSpec(rps=50.0, requests=7, prompt_lens=(4, 8, 12),
                    max_new_lo=3, max_new_hi=8, seed=2)
    out = run_serve(arch=ARCH, clients=2, slots=2, max_len=MAX_LEN,
                    load=load, transport="inproc", device="cpu",
                    params=jax_params)
    res = out["result"]
    assert res["served"] == 7 and res["slots_leaked"] == 0
    assert res["queue_left"] == 0
    assert res["tick_execs"] == res["steps"]
    assert all_requests(load, 2, cfg.vocab) == jall_requests(load, 2,
                                                             jcfg.vocab)
    recs = jrun_sequential(jcfg, jall_requests(load, 2, jcfg.vocab),
                           max_len=MAX_LEN, realtime=False)
    got = {r["id"]: r["tokens"] for r in res["records"]}
    assert got == {r["id"]: r["tokens"] for r in recs}


def test_run_serve_refuses_socket_transport():
    with pytest.raises(NotImplementedError, match="socket"):
        run_serve(arch=ARCH, transport="socket", procs=2, device="cpu")
