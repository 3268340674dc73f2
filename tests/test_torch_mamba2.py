"""The port's Mamba-2 against the JAX package's, with the same weights.

Reduced mamba2-370m (2 SSD layers in one stacked segment, d_model 64, 8
heads of 16, state 16, chunk 32, float32).  Weights come from the
reference's own init (``jax.random.PRNGKey(0)``), carried to the port
through :mod:`repro_torch.bridge`.  On the CPU the port's scan wrapper
answers with its plain version; prompts of 39 and 70 steps are ragged
against the chunk.  Held to the reference: the block with and without a
cache (prefill continuing from a cached state, then decode steps), the LM's
loss, gradients, prefill and decode, and the served tokens.
"""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs files in parallel workers, and
# oversubscribed cores starve the socket tests' heartbeat threads
torch.set_num_threads(1)

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402

from repro.configs import ARCHS as JARCHS                    # noqa: E402
from repro.configs import reduce_cfg as jreduce              # noqa: E402
from repro.models import build_model as jbuild               # noqa: E402
from repro.models import mamba2 as jm2                       # noqa: E402
from repro.serve import ServeEngine as JServeEngine          # noqa: E402
from repro.serve import all_requests as jall_requests        # noqa: E402
from repro.serve import run_sequential as jrun_sequential    # noqa: E402
from repro_torch import bridge                               # noqa: E402
from repro_torch.configs import ARCHS, reduce_cfg            # noqa: E402
from repro_torch.kernels.ssd import ops as tssd              # noqa: E402
from repro_torch.models import build_model                   # noqa: E402
from repro_torch.models import mamba2 as tm2                 # noqa: E402
from repro_torch.serve import (LoadSpec, ServeEngine,        # noqa: E402
                               all_requests, run_sequential, run_serve)

pytestmark = pytest.mark.timeout(600)

ARCH = "mamba2-370m"
# float32 on both sides: summation order only
TOL = 1e-4
MAX_LEN = 128
PROMPTS = [39, 70]        # ragged against chunk 32: 2 and 3 chunks
DECODE_STEPS = 5


@pytest.fixture(scope="module")
def models():
    jcfg = jreduce(JARCHS[ARCH].cfg)
    cfg = reduce_cfg(ARCHS[ARCH].cfg)
    jm = jbuild(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg)
    bridge.params_from_jax_numpy(jax.tree.map(np.asarray, jparams), tm,
                                 "cpu")
    return jm, jparams, tm


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(a, b, tol=TOL):
    """|a - b| <= tol * (|b| + max|b|) elementwise.  Block outputs reach
    ~36 and SSM states ~40 here, sums of products that cancel in places,
    so float32 rounding scales with the largest magnitude: against a
    float64 evaluation of the block the reference is off by 2.7e-4 and the
    port by 1.5e-4 at max|y| = 36."""
    a, b = _np(a), _np(b)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale)


def _layer(jparams, i):
    """Layer ``i``'s mixer params: (jax tree, torch tree)."""
    jp = jax.tree.map(lambda a: a[i], jparams["seg0"]["u0"]["mix"])
    tp = {k: bridge.tensor_from_numpy(np.asarray(v), "cpu")
          for k, v in jp.items()}
    return jp, tp


def _cache(cfg, B, rng, random):
    """A mamba2 layer cache, zeros or random: (jax dict, torch dict)."""
    s, d_in, nh, d_xbc = tm2._dims(cfg)
    shapes = {"conv": (B, s.d_conv - 1, d_xbc),
              "state": (B, nh, s.d_state, s.head_dim)}
    arrs = {k: (rng.standard_normal(v, dtype=np.float32) if random
                else np.zeros(v, np.float32)) for k, v in shapes.items()}
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v.copy()) for k, v in arrs.items()})


def test_segments_and_specs_match(models):
    jm, jparams, tm = models
    assert tm.segments == jm.segments == [((("ssd", "none"),), 2)]
    assert set(tm.params["seg0"]["u0"].keys()) == {"ln1", "mix"}


def test_bridge_round_trips_exactly(models):
    _, jparams, tm = models
    back = bridge.params_to_numpy(tm)
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat_j:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


def test_bf16_bridge_keeps_dtypes():
    """In a bf16 model every parameter (a_log, dt_bias, d_skip included)
    and the conv cache are bf16 on both sides, and the SSM state stays
    float32; the bridge carries each leaf in its own dtype."""
    jcfg = jreduce(JARCHS[ARCH].cfg).replace(dtype="bfloat16")
    cfg = reduce_cfg(ARCHS[ARCH].cfg).replace(dtype="bfloat16")
    jm, tm = jbuild(jcfg), build_model(cfg)
    jparams = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    bridge.params_from_jax_numpy(jparams, tm, "cpu")
    mix = tm.params["seg0"]["u0"]["mix"]
    for key in ("a_log", "dt_bias", "d_skip", "in_proj", "conv_w"):
        assert mix[key].dtype == torch.bfloat16, key
    jc = jax.tree.map(np.asarray, jm.init_cache(2, 16))
    tc = bridge.cache_from_jax_numpy(jc, "cpu")
    ref = tm.init_cache(2, 16)
    for got, want in zip(jax.tree.leaves(tc), jax.tree.leaves(ref)):
        assert got.dtype == want.dtype and got.shape == want.shape
    assert tc[0][0]["state"].dtype == torch.float32
    assert tc[0][0]["conv"].dtype == torch.bfloat16
    for a, b in zip(jax.tree.leaves(bridge.cache_to_numpy(tc)),
                    jax.tree.leaves(jc)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


@pytest.mark.parametrize("impl", ["kernel", "ref"])
@pytest.mark.parametrize("T", [64, 70])
def test_block_without_cache_matches(models, T, impl):
    """The training forward: the scan through the wrapper (``kernel``) or
    the plain version (``ref``) equals the reference's padded scan."""
    jm, jparams, tm = models
    cfg = tm.cfg.replace(attn_impl=impl)
    jp, tp = _layer(jparams, 1)
    x = np.random.default_rng(T).standard_normal((2, T, cfg.d_model),
                                                 dtype=np.float32)
    yj, _ = jm2.mamba2_apply(jp, jnp.asarray(x), cfg=jm.cfg)
    before = tssd.plain_calls
    yt, cache = tm2.mamba2_apply(tp, torch.from_numpy(x), cfg=cfg)
    assert tssd.plain_calls == before + (impl == "kernel")
    assert cache is None
    _close(yt, yj)


@pytest.mark.parametrize("init", ["zeros", "random"])
@pytest.mark.parametrize("T", PROMPTS)
def test_block_prefill_then_decode_matches(models, T, init):
    """Prefill with a cache continues from the cached conv tail and state
    and writes both back (through the wrapper, ragged T); then one-step
    decodes update them; outputs and cache leaves match at every step."""
    jm, jparams, tm = models
    jp, tp = _layer(jparams, 0)
    rng = np.random.default_rng(T)
    jc, tc = _cache(tm.cfg, 2, rng, init == "random")
    x = rng.standard_normal((2, T, tm.cfg.d_model), dtype=np.float32)
    yj, jc = jm2.mamba2_apply(jp, jnp.asarray(x), cfg=jm.cfg, cache=jc)
    before = tssd.plain_calls
    yt, tc2 = tm2.mamba2_apply(tp, torch.from_numpy(x), cfg=tm.cfg,
                               cache=tc)
    assert tssd.plain_calls == before + 1
    assert tc2 is tc                                   # written in place
    _close(yt, yj)
    for key in ("conv", "state"):
        _close(tc[key], jc[key])
    assert tc["state"].dtype == torch.float32
    for _ in range(DECODE_STEPS):
        x1 = rng.standard_normal((2, 1, tm.cfg.d_model), dtype=np.float32)
        yj, jc = jm2.mamba2_apply(jp, jnp.asarray(x1), cfg=jm.cfg, cache=jc)
        before = tssd.plain_calls
        yt, _ = tm2.mamba2_apply(tp, torch.from_numpy(x1), cfg=tm.cfg,
                                 cache=tc)
        assert tssd.plain_calls == before              # decode: plain ops
        _close(yt, yj)
        for key in ("conv", "state"):
            _close(tc[key], jc[key])


def test_loss_and_grad_match(models):
    """Loss and gradients through the wrapper's autograd.Function equal
    the reference's, leaf for leaf."""
    jm, jparams, tm = models
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tm.cfg.vocab, size=(2, 40)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jl, _ = jm.loss(jparams, jbatch)
    jg = jax.grad(lambda p: jm.loss(p, jbatch)[0])(jparams)
    tm.zero_grad(set_to_none=True)
    tl, _ = tm.loss({"tokens": torch.from_numpy(toks).long(),
                     "labels": torch.from_numpy(labels).long()})
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=TOL,
                               atol=TOL)
    tg = jax.tree.map(lambda p: p.grad, tm.params.to_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(jg):
        node = tg
        for k in path:
            node = node[k.key]
        assert node is not None, path
        np.testing.assert_allclose(node.numpy(), np.asarray(leaf),
                                   rtol=TOL, atol=TOL, err_msg=str(path))


@pytest.mark.parametrize("S", PROMPTS)
def test_lm_prefill_and_decode_logits_match(models, S):
    jm, jparams, tm = models
    B = 2
    rng = np.random.default_rng(S)
    toks = rng.integers(0, tm.cfg.vocab, size=(B, S)).astype(np.int32)
    jlog, jcache = jm.prefill(jparams, jnp.asarray(toks),
                              jm.init_cache(B, MAX_LEN))
    before = tssd.plain_calls
    with torch.inference_mode():
        tcache = tm.init_cache(B, MAX_LEN)
        tlog, tcache = tm.prefill(torch.from_numpy(toks).long(), tcache)
    assert tssd.plain_calls == before + tm.cfg.n_layers   # the kernel route
    _close(tlog, jlog)
    for a, b in zip(jax.tree.leaves(bridge.cache_to_numpy(tcache)),
                    jax.tree.leaves(jcache)):
        _close(a, b)
    jdecode = jax.jit(jm.decode_step)
    for i in range(DECODE_STEPS):
        tok = np.argmax(np.asarray(jlog[:, -1]), -1)[:, None].astype(np.int32)
        np.testing.assert_array_equal(
            torch.argmax(tlog[:, -1], -1)[:, None].numpy(), tok)
        pos = np.full((B, 1), S + i, np.int32)
        jlog, jcache = jdecode(jparams, jcache, jnp.asarray(tok),
                               jnp.asarray(pos))
        with torch.inference_mode():
            tlog, tcache = tm.decode_step(tcache, torch.from_numpy(tok).long(),
                                          torch.from_numpy(pos))
        _close(tlog, jlog)
    for a, b in zip(jax.tree.leaves(bridge.cache_to_numpy(tcache)),
                    jax.tree.leaves(jcache)):
        _close(a, b)


def test_prefill_continues_from_a_used_cache(models):
    """With no attention cache there is nothing to check: a second prefill
    continues from the cached state, as the reference's does."""
    jm, jparams, tm = models
    rng = np.random.default_rng(5)
    a, b = (rng.integers(0, tm.cfg.vocab, size=(1, n)).astype(np.int32)
            for n in (20, 45))
    jcache = jm.init_cache(1, MAX_LEN)
    _, jcache = jm.prefill(jparams, jnp.asarray(a), jcache)
    jlog, jcache = jm.prefill(jparams, jnp.asarray(b), jcache)
    with torch.inference_mode():
        tcache = tm.init_cache(1, MAX_LEN)
        tm.prefill(torch.from_numpy(a).long(), tcache)
        tlog, tcache = tm.prefill(torch.from_numpy(b).long(), tcache)
    _close(tlog, jlog)


# ------------------------------------------------------------------ serving
@pytest.fixture(scope="module")
def serve_cfgs():
    return reduce_cfg(ARCHS[ARCH].cfg), jreduce(JARCHS[ARCH].cfg)


@pytest.fixture(scope="module")
def jax_params(serve_cfgs):
    eng = JServeEngine(serve_cfgs[1], slots=2, max_len=MAX_LEN)
    return jax.tree.map(np.asarray, eng.params)


def _serve(e, slot, prompt, n):
    first, pc = e.prefill(prompt)
    e.attach(slot, len(prompt), first, pc)
    out = [first]
    for _ in range(n - 1):
        out.append(int(e.step([slot])[slot]))
    return out


def test_engine_tokens_match_reference_with_slot_reuse(serve_cfgs,
                                                       jax_params):
    """Prompt 1..39 then a 70-step prompt reusing slot 0 of 2: both engines
    emit the same tokens (the second request sees no state of the first:
    attach overwrites the slot's conv tail and state)."""
    cfg, jcfg = serve_cfgs
    pa = list(range(1, 40))
    pb = np.random.default_rng(9).integers(0, cfg.vocab, size=70).tolist()
    jeng = JServeEngine(jcfg, slots=2, max_len=MAX_LEN)
    teng = ServeEngine(cfg, slots=2, max_len=MAX_LEN, device="cpu",
                       params=jax_params)
    before = tssd.plain_calls
    got = [_serve(teng, 0, pa, 6), _serve(teng, 0, pb, 6)]
    assert tssd.plain_calls == before + 2 * cfg.n_layers
    want = [_serve(jeng, 0, pa, 6), _serve(jeng, 0, pb, 6)]
    assert got == want
    assert got[0][:3] == [50, 482, 390]


def test_run_serve_and_run_sequential_match_reference(serve_cfgs,
                                                      jax_params):
    """2 slots for 7 requests forces slot reuse; the port's in-proc
    Session(ranks=3) server and its sequential baseline both answer every
    request with the reference's sequential tokens, from one decode
    chain."""
    cfg, jcfg = serve_cfgs
    load = LoadSpec(rps=50.0, requests=7, prompt_lens=(12, 39, 70),
                    max_new_lo=3, max_new_hi=8, seed=2)
    reqs = all_requests(load, 2, cfg.vocab)
    assert reqs == jall_requests(load, 2, jcfg.vocab)
    want = {r["id"]: r["tokens"] for r in jrun_sequential(
        jcfg, jall_requests(load, 2, jcfg.vocab), max_len=MAX_LEN,
        realtime=False)}
    out = run_serve(arch=ARCH, clients=2, slots=2, max_len=MAX_LEN,
                    load=load, transport="inproc", device="cpu",
                    params=jax_params)
    res = out["result"]
    assert res["served"] == 7 and res["slots_leaked"] == 0
    assert res["queue_left"] == 0
    assert res["tick_execs"] == res["steps"]
    assert {r["id"]: r["tokens"] for r in res["records"]} == want
    seq = run_sequential(cfg, reqs, max_len=MAX_LEN, realtime=False,
                         device="cpu", params=jax_params)
    assert {r["id"]: r["tokens"] for r in seq} == want
