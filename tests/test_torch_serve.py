"""The port's serving subsystem against the JAX package's, same weights.

Weights are the JAX engine's own seeded init, carried to the port as numpy
(``params=``).  The port's engine must emit the reference engine's greedy
tokens, including when a slot is reused, and the port's event-driven
server (its copy of the EDAT runtime, in-proc and over sockets with the
server in its own process) must emit the reference's sequential baseline
tokens request for request.  Over sockets the server also drains cleanly
when a client process is SIGKILLed, and its clients surface
``RankDiedError`` when the server's is.
"""
import os
import sys

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs files in parallel workers, and
# oversubscribed cores starve the socket tests' heartbeat threads
torch.set_num_threads(1)

import jax                                                   # noqa: E402
import numpy as np                                           # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
import _chaos as chaos                                       # noqa: E402
import chip_smoke                                            # noqa: E402

from repro.configs import ARCHS as JARCHS                    # noqa: E402
from repro.configs import reduce_cfg as jreduce              # noqa: E402
from repro.serve import ServeEngine as JServeEngine          # noqa: E402
from repro.serve import all_requests as jall_requests        # noqa: E402
from repro.serve import run_sequential as jrun_sequential    # noqa: E402
from repro_torch import edat                                 # noqa: E402
from repro_torch.configs import ARCHS, reduce_cfg            # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfa   # noqa: E402
from repro_torch.net.socket_transport import SocketTransport  # noqa: E402
from repro_torch.serve import (LoadSpec, ServeEngine,        # noqa: E402
                               all_requests, client_schedule, run_serve,
                               serve_program)

pytestmark = pytest.mark.timeout(600)

ARCH = "gemma3-1b"
GRANITE = "granite-moe-1b-a400m"
GEMMA2 = "gemma2-2b"
STABLELM = "stablelm-1.6b"
STARCODER2 = "starcoder2-15b"
DEEPSEEK = "deepseek-v3-671b"
MAX_LEN = 48


@pytest.fixture(scope="module")
def cfgs():
    return reduce_cfg(ARCHS[ARCH].cfg), jreduce(JARCHS[ARCH].cfg)


@pytest.fixture(scope="module")
def jax_params(cfgs):
    eng = JServeEngine(cfgs[1], slots=1, max_len=MAX_LEN)
    return jax.tree.map(np.asarray, eng.params)


@pytest.fixture(scope="module")
def granite():
    """Reduced granite-moe-1b-a400m (E=8, k=2, capacity 8: no assignment
    is dropped, so no token depends on the batch): (port cfg, reference
    cfg) and the reference engine's weights."""
    jcfg = jreduce(JARCHS[GRANITE].cfg)
    eng = JServeEngine(jcfg, slots=1, max_len=MAX_LEN)
    return ((reduce_cfg(ARCHS[GRANITE].cfg), jcfg),
            jax.tree.map(np.asarray, eng.params))


@pytest.fixture(scope="module")
def gemma2():
    """Reduced gemma2-2b (a local and a global layer, attention softcap
    50, final softcap 30): (port cfg, reference cfg) and the reference
    engine's weights."""
    jcfg = jreduce(JARCHS[GEMMA2].cfg)
    eng = JServeEngine(jcfg, slots=1, max_len=MAX_LEN)
    return ((reduce_cfg(ARCHS[GEMMA2].cfg), jcfg),
            jax.tree.map(np.asarray, eng.params))


@pytest.fixture(scope="module")
def stablelm():
    """Reduced stablelm-1.6b (two MHA layers of 4 heads, layernorm with a
    bias, 8 of 32 dims rotated, an untied ``lm_head``): (port cfg,
    reference cfg) and the reference engine's weights."""
    jcfg = jreduce(JARCHS[STABLELM].cfg)
    eng = JServeEngine(jcfg, slots=1, max_len=MAX_LEN)
    return ((reduce_cfg(ARCHS[STABLELM].cfg), jcfg),
            jax.tree.map(np.asarray, eng.params))


@pytest.fixture(scope="module")
def starcoder2():
    """Reduced starcoder2-15b (two local layers of 4 heads and 2 KV heads,
    window 64, layernorm, biases, the plain GELU MLP, an untied
    ``lm_head``): (port cfg, reference cfg) and the reference engine's
    weights."""
    jcfg = jreduce(JARCHS[STARCODER2].cfg)
    eng = JServeEngine(jcfg, slots=1, max_len=MAX_LEN)
    return ((reduce_cfg(ARCHS[STARCODER2].cfg), jcfg),
            jax.tree.map(np.asarray, eng.params))


@pytest.fixture(scope="module")
def deepseek():
    """Reduced deepseek-v3-671b (3 MLA layers of 4 heads, a dense layer
    then two MoE layers of 8 experts top-2 with the sigmoid router and a
    shared expert, capacity 8, an untied ``lm_head``, the MTP head, which
    serving never reads): (port cfg, reference cfg) and the reference
    engine's weights."""
    jcfg = jreduce(JARCHS[DEEPSEEK].cfg)
    eng = JServeEngine(jcfg, slots=1, max_len=MAX_LEN)
    return ((reduce_cfg(ARCHS[DEEPSEEK].cfg), jcfg),
            jax.tree.map(np.asarray, eng.params))


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


def _serve_matches_reference(cfgs, jax_params, transport, procs,
                             arch=ARCH):
    cfg, jcfg = cfgs
    load = LoadSpec(rps=50.0, requests=7, prompt_lens=(4, 8, 12),
                    max_new_lo=3, max_new_hi=8, seed=2)
    out = run_serve(arch=arch, clients=2, slots=2, max_len=MAX_LEN,
                    load=load, transport=transport, procs=procs,
                    device="cpu", params=jax_params)
    res = out["result"]
    assert res["served"] == 7 and res["slots_leaked"] == 0
    assert res["queue_left"] == 0
    assert res["tick_execs"] == res["steps"]
    assert res["kernel_launches"] == {"flash_attention_fwd": 0,
                                      "ssd_fwd": 0, "rglru_fwd": 0,
                                      "kronecker_gen": 0}
    assert res["plain_calls"] == {
        "flash_attention_fwd": res["prefills"] * cfg.n_layers,
        "ssd_fwd": 0, "rglru_fwd": 0, "kronecker_gen": 0}
    assert res["launches_by_variant"] == {
        "flash_attention_fwd": {"mma_bf16": 0, "simt": 0},
        "ssd_fwd": {"mma_bf16": 0, "simt": 0}}
    assert all_requests(load, 2, cfg.vocab) == jall_requests(load, 2,
                                                             jcfg.vocab)
    recs = jrun_sequential(jcfg, jall_requests(load, 2, jcfg.vocab),
                           max_len=MAX_LEN, realtime=False)
    got = {r["id"]: r["tokens"] for r in res["records"]}
    assert got == {r["id"]: r["tokens"] for r in recs}


def test_run_serve_matches_reference_sequential(cfgs, jax_params):
    """2 slots for 7 requests forces slot reuse; the port's in-proc
    Session(ranks=3) server answers every request with the reference's
    sequential tokens, from one decode chain."""
    _serve_matches_reference(cfgs, jax_params, "inproc", None)


def test_run_serve_over_sockets_matches_reference_sequential(cfgs,
                                                             jax_params):
    """The same over sockets, the server alone in its process (ranks
    (0,) and (1, 2)): the same tokens, and the server's process counts
    every prefill's attention layers as plain calls and no launch."""
    _serve_matches_reference(cfgs, jax_params, "socket", 2)


def test_run_serve_granite_matches_reference_sequential(granite):
    """Reduced granite-moe-1b-a400m served in-proc (MoE layers, flash
    route in every prefill) answers every request with the reference's
    sequential tokens."""
    cfgs, params = granite
    _serve_matches_reference(cfgs, params, "inproc", None, arch=GRANITE)


def test_run_serve_gemma2_matches_reference_sequential(gemma2):
    """Reduced gemma2-2b served in-proc (softcapped attention through the
    flash route in every prefill, softcapped decode attention over the
    caches, the final softcap on every step's logits) answers every
    request with the reference's sequential tokens."""
    cfgs, params = gemma2
    assert cfgs[0].n_layers == 2
    _serve_matches_reference(cfgs, params, "inproc", None, arch=GEMMA2)


def test_run_serve_stablelm_matches_reference_sequential(stablelm):
    """Reduced stablelm-1.6b served in-proc (MHA with partial rotary
    through the flash route in every prefill, layernorm, untied logits)
    answers every request with the reference's sequential tokens."""
    cfgs, params = stablelm
    assert cfgs[0].n_layers == 2
    assert cfgs[0].n_heads == cfgs[0].n_kv_heads == 4
    assert "lm_head" in params
    _serve_matches_reference(cfgs, params, "inproc", None, arch=STABLELM)


def test_run_serve_starcoder2_matches_reference_sequential(starcoder2):
    """Reduced starcoder2-15b served in-proc (GQA at group 2 through the
    flash route in every prefill, a ring-buffered window cache in every
    layer, biases, the plain GELU MLP, untied logits) answers every
    request with the reference's sequential tokens."""
    cfgs, params = starcoder2
    assert cfgs[0].n_layers == 2 and cfgs[0].pattern == ("local",)
    assert cfgs[0].n_heads == 2 * cfgs[0].n_kv_heads
    mix = params["seg0"]["u0"]["mix"]
    assert {"bq", "bk", "bv", "bo"} <= set(mix)
    assert {"b1", "b2"} <= set(params["seg0"]["u0"]["mlp"])
    assert "lm_head" in params
    _serve_matches_reference(cfgs, params, "inproc", None, arch=STARCODER2)


def test_run_serve_deepseek_matches_reference_sequential(deepseek):
    """Reduced deepseek-v3-671b served in-proc (MLA through the flash
    route at head dims (48, 32) in every prefill, the absorbed form over
    the latent cache at every decode step, the sigmoid-routed MoE with a
    shared expert) answers every request with the reference's sequential
    tokens; at capacity 8 the 2-slot decode batch drops no assignment."""
    cfgs, params = deepseek
    assert cfgs[0].n_layers == 3 and cfgs[0].pattern == ("mla",)
    assert cfgs[0].moe.capacity_factor == 8 and "mtp" in params
    _serve_matches_reference(cfgs, params, "inproc", None, arch=DEEPSEEK)


def test_run_serve_takes_a_depth_cut():
    """``run_serve(overrides=...)`` serves the config with those fields
    replaced, as the card serves deepseek-v3-671b cut to 4 layers and no
    MTP head: here reduced deepseek-v3 cut to 2 layers runs the flash
    route twice a prefill."""
    load = LoadSpec(rps=50.0, requests=3, prompt_lens=(4, 8), max_new_lo=2,
                    max_new_hi=4, seed=3)
    out = run_serve(arch=DEEPSEEK, clients=1, slots=2, max_len=MAX_LEN,
                    load=load, device="cpu",
                    overrides={"n_layers": 2, "mtp_depth": 0})
    res = out["result"]
    assert res["served"] == 3 and res["queue_left"] == 0
    assert res["plain_calls"]["flash_attention_fwd"] == 2 * res["prefills"]
    prog = serve_program(arch=DEEPSEEK, dtype="float64",
                         overrides={"n_layers": 2, "mtp_depth": 0},
                         device="cpu")
    assert (prog.cfg.n_layers, prog.cfg.mtp_depth, prog.cfg.dtype) == (
        2, 0, "float64")


def test_engines_drawn_as_rescale_their_own_params():
    """``chip_smoke._engines_drawn_as`` (the float32 weight sets of phases
    16, 22 and 34, with no host copy): an engine built from its seeded
    init while it is open
    holds that init rescaled as ``_layer_fan_in`` rescales it, bit for
    bit; an engine given ``params`` keeps them as given."""
    from repro_torch import bridge
    cfg = reduce_cfg(ARCHS[STARCODER2].cfg)
    seeded = ServeEngine(cfg, slots=1, max_len=MAX_LEN, device="cpu")
    given = bridge.params_to_numpy(seeded.model)
    with chip_smoke._engines_drawn_as("layer_fan_in"):
        drawn = ServeEngine(cfg, slots=1, max_len=MAX_LEN, device="cpu")
        kept = ServeEngine(cfg, slots=1, max_len=MAX_LEN, device="cpu",
                           params=given)
    chip_smoke._layer_fan_in(seeded.model)
    want = jax.tree.leaves(bridge.params_to_numpy(seeded.model))
    got = jax.tree.leaves(bridge.params_to_numpy(drawn.model))
    assert any((a != b).any() for a, b in zip(want, jax.tree.leaves(given)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(bridge.params_to_numpy(kept.model)),
                    jax.tree.leaves(given)):
        np.testing.assert_array_equal(a, b)


def test_recorded_calls_rebuild_tokens_and_replay(granite):
    """``chip_smoke.record_engine_calls`` records an in-proc server's
    engine calls in order: they rebuild every request's tokens, and
    replayed (``chip_smoke.replay_engine_calls``) through a fresh engine
    with the same weights every served token is the replay's greedy
    token; with a fault planted in the replay's MoE router
    (``chip_smoke.moe_fault``), some are not."""
    (cfg, _), params = granite
    load = LoadSpec(rps=50.0, requests=7, prompt_lens=(4, 8, 12),
                    max_new_lo=1, max_new_hi=8, seed=3)
    with chip_smoke.record_engine_calls() as calls:
        res = run_serve(arch=GRANITE, clients=2, slots=2, max_len=MAX_LEN,
                        load=load, device="cpu", params=params)["result"]
    kinds = [c[0] for c in calls]
    assert kinds.count("prefill") == kinds.count("attach") == 7
    assert kinds.count("step") == res["steps"]
    # rebuild each request's tokens: an attach opens its slot's request,
    # a step appends to each live slot's
    open_, rebuilt = {}, []
    for call in calls:
        if call[0] == "attach":
            if call[1] in open_:
                rebuilt.append(open_.pop(call[1]))
            open_[call[1]] = [call[3]]
        elif call[0] == "step":
            for s in call[1]:
                open_[s].append(call[2][s])
    rebuilt += open_.values()
    assert sorted(rebuilt) == sorted(r["tokens"] for r in res["records"])

    def replay():
        eng = ServeEngine(cfg, slots=2, max_len=MAX_LEN, device="cpu",
                          params=params)
        return [r for _, rows in chip_smoke.replay_engine_calls(eng, calls)
                for r in rows]

    rows = replay()
    assert len(rows) == 7 + sum(len(c[1]) for c in calls if c[0] == "step")
    assert all(r["served"] == r["replayed"] for r in rows)
    with chip_smoke.moe_fault("unnormalised_weights"):
        assert any(r["served"] != r["replayed"] for r in replay())


def test_served_payloads_are_host_objects(monkeypatch):
    """Every payload the serving program fires is one the socket
    transport proves picklable without pickling (numbers, strings, numpy
    arrays, containers of those): no tensor rides an event, so no client
    process unpickles one, let alone a CUDA one."""
    fired = []
    monkeypatch.setattr(edat.InProcTransport, "validate_payload",
                        lambda self, data: fired.append(data))
    load = LoadSpec(rps=1000.0, requests=6, prompt_lens=(4, 8),
                    max_new_lo=2, max_new_hi=4, seed=5)
    out = run_serve(arch=ARCH, clients=2, slots=1, max_len=MAX_LEN,
                    load=load, queue_bound=1, device="cpu")
    assert out["result"]["served"] == 6
    bad = [d for d in fired if not SocketTransport._quick_picklable(d)]
    assert not bad, bad
    keys = {frozenset(d) for d in fired if isinstance(d, dict)}
    for channel_keys in ({"id", "prompt", "max_new", "t_sched", "t_send",
                          "throttled_s"},                      # request
                         {"id", "tokens", "t_first", "t_done"},  # response
                         {"on", "depth"},                      # backpressure
                         {"slot", "req"}):                     # admit
        assert frozenset(channel_keys) in keys, channel_keys
    assert None in fired                                       # ready, tick


def _chaos_session(victim, tmp_path):
    """Serve a 2-client load over sockets, one process a rank, and
    SIGKILL the process of ``victim`` once the server has admitted its
    first request; returns (exit codes, gathered result, child reports)."""
    ready = str(tmp_path / "ready")
    load = LoadSpec(rps=10.0, requests=12, prompt_lens=(4, 8),
                    max_new_lo=4, max_new_hi=8, seed=4)
    with edat.Session(3, procs=3, transport="socket", timeout=120,
                      workers_per_rank=2, unconsumed="ignore",
                      hb_interval=0.2, hb_timeout=10.0) as s:
        s.start(edat.deferred(serve_program, arch=ARCH, slots=2,
                              max_len=MAX_LEN, load=load, device="cpu",
                              ready_file=ready, ready_after=1))
        chaos.sigkill_when_ready(s, victim, ready, timeout=120, settle=0.2)
        s.wait(180, check=False)
        return s.exitcodes(), s.gather(), s._last_pg.child_reports, load


def test_client_sigkill_drains_cleanly(cfgs, tmp_path):
    """SIGKILL one of two client processes once the server has admitted
    its first request.  The server's RANK_FAILED task purges the dead
    client's queue; its live slots drain; the survivor's whole schedule
    is served; the round terminates with no leaked slots."""
    codes, res, _, load = _chaos_session(2, tmp_path)
    assert codes[2] not in (None, 0)            # the victim died by kill
    assert codes[0] == 0 and codes[1] == 0      # server + survivor: clean
    assert res["dead"] == [2]
    assert res["slots_leaked"] == 0 and res["queue_left"] == 0
    # the surviving client (rank 1 == loadgen client 0) got everything
    survivor_ids = {r["id"] for r in client_schedule(load, 0, 2,
                                                     cfgs[0].vocab)}
    assert survivor_ids <= {r["id"] for r in res["records"]}


def test_server_sigkill_clients_surface_rankdied(tmp_path):
    """SIGKILL the server's process (rank 0, the termination
    coordinator) once it has admitted its first request: each client
    raises ``RankDiedError`` naming rank 0, reported as an orderly child
    outcome (exit code 0), and no result is gathered."""
    codes, res, reports, _ = _chaos_session(0, tmp_path)
    assert codes[0] not in (None, 0)            # the server died by kill
    assert codes[1] == 0 and codes[2] == 0      # clients: orderly exit
    assert res is None                          # rank 0 never finalized
    died = sorted(r for r in reports if r[0] == "rankdied")
    assert [r[1] for r in died] == [1, 2]       # both clients reported
    for r in died:
        assert "rank 0" in r[2] and "termination coordinator" in r[2]
