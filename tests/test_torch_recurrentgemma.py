"""The port's RecurrentGemma against the JAX package's, with the same weights.

Reduced recurrentgemma-9b at 11 layers (d_model 128, RG-LRU width 128,
4 query heads and 1 KV head of 32, window 64, float32), which factors into
the same segments as the full 38 layers: ``((rglru, rglru, local), 3)``
then ``((rglru,), 2)``, both stacked.  Every test runs with dense gates and
again with block-diagonal ones (``block_heads = 4``).  Weights come from
the reference's own init (``jax.random.PRNGKey(0)``), carried to the port
through :mod:`repro_torch.bridge`.

That init takes a leaf's fan-in from its first axis, which on a stacked
leaf is the layers axis (3 or 2 here), so stacked weights come out 6-8x
wider than one layer's, the RG-LRU gates saturate (r ~ 0, so a ~ 1), and
there ``1 - exp(2 log_a)`` is a few float32 ulps: the result is rounding
noise, 1e-3-2e-2 in the logits, in the reference and the port alike.  So
the parity tests run on the reference's init with each stacked leaf drawn
at one layer's fan-in (``_per_layer_fan_in``; at 3 or 8 layers, where
nothing is stacked, that is the reference's init unchanged), and one test
holds the port to the reference's init as it is, within that noise.  The
block tests also draw Griffin's init of lam (a = exp(-8 softplus(lam))
uniform in [0.9, 0.999]), under which the state carries far enough for a
fault in it to show.  On the CPU the port's RG-LRU and flash wrappers
answer with their plain versions.  The reference's serving prefill runs
its plain scan from the cached state (its TPU kernel takes no h0), so that
is what the port's prefill is held to.  Prompts stay within the window:
the port refuses a longer one.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs files in parallel workers, and
# oversubscribed cores starve the socket tests' heartbeat threads
torch.set_num_threads(1)

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402

import repro_torch.configs                                   # noqa: E402
from repro.configs import ARCHS as JARCHS                    # noqa: E402
from repro.configs import reduce_cfg as jreduce              # noqa: E402
from repro.models import build_model as jbuild               # noqa: E402
from repro.models import rglru as jrg                        # noqa: E402
from repro.serve import SequentialEngine as JSequentialEngine  # noqa: E402
from repro.serve import ServeEngine as JServeEngine          # noqa: E402
from repro.serve import all_requests as jall_requests        # noqa: E402
from repro_torch import bridge                               # noqa: E402
from repro_torch.configs import ARCHS, reduce_cfg            # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfa   # noqa: E402
from repro_torch.kernels.rglru import ops as trg_ops         # noqa: E402
from repro_torch.kernels.rglru import ref as tref            # noqa: E402
from repro_torch.models import build_model                   # noqa: E402
from repro_torch.models import rglru as trg                  # noqa: E402
from repro_torch.serve import (LoadSpec, ServeEngine,        # noqa: E402
                               all_requests, run_sequential, run_serve)

pytestmark = pytest.mark.timeout(900)

ARCH = "recurrentgemma-9b"
N_LAYERS = 11
GATES = {"dense": 0, "block4": 4}
N_RGLRU, N_LOCAL = 8, 3       # of the 11 layers
# float32 on both sides: summation order only
TOL = 1e-4
MAX_LEN = 128                 # local caches hold min(window 64, 128) = 64
PROMPTS = [39, 64]            # 64 fills the local cache exactly
DECODE_STEPS = 5


def _cfgs(block_heads, dtype="float32"):
    """(port cfg, reference cfg): reduced, 11 layers, ``block_heads``."""
    t = reduce_cfg(ARCHS[ARCH].cfg)
    j = jreduce(JARCHS[ARCH].cfg)
    t = t.replace(n_layers=N_LAYERS, dtype=dtype,
                  rglru=dataclasses.replace(t.rglru, block_heads=block_heads))
    j = j.replace(n_layers=N_LAYERS, dtype=dtype,
                  rglru=dataclasses.replace(j.rglru, block_heads=block_heads))
    return t, j


def _per_layer_fan_in(jm, jparams):
    """The reference's init with every stacked leaf that it draws at its
    fan-in (``normal``, no scale) redrawn at one layer's: scaled by
    sqrt(layers) / sqrt(the layer's fan-in)."""
    specs = jm.param_specs()
    out = dict(jparams)
    for si, (_, reps) in enumerate(jm.segments):
        if reps == 1:
            continue

        def fix(spec, leaf):
            if spec.init != "normal" or spec.scale is not None:
                return leaf
            layer = spec.shape[1:]
            fan_in = layer[0] if len(layer) >= 2 else max(layer[-1], 1)
            return leaf * np.float32(np.sqrt(reps / fan_in))

        out[f"seg{si}"] = jax.tree.map(fix, specs[f"seg{si}"],
                                       jparams[f"seg{si}"])
    return out


def _pair(block_heads, weights):
    """(reference model, its params, port model with the same weights)."""
    cfg, jcfg = _cfgs(block_heads)
    jm = jbuild(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    if weights == "per_layer_fan_in":
        jparams = _per_layer_fan_in(jm, jparams)
    tm = build_model(cfg)
    bridge.params_from_jax_numpy(jax.tree.map(np.asarray, jparams), tm,
                                 "cpu")
    return jm, jparams, tm


@pytest.fixture(scope="module", params=sorted(GATES))
def models(request):
    return _pair(GATES[request.param], "per_layer_fan_in")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _layer(jparams, rep, lam):
    """Mixer params of the first rglru layer of repeat ``rep`` of segment
    0, with the reference's lam or Griffin's: (jax tree, torch tree)."""
    jp = jax.tree.map(lambda a: a[rep], jparams["seg0"]["u0"]["mix"])
    if lam == "griffin":
        u = np.random.default_rng(rep).uniform(0.9, 0.999,
                                               jp["lam"].shape)
        jp = dict(jp, lam=jnp.asarray(np.log(np.expm1(-np.log(u) / 8)),
                                      jnp.float32))
    tp = {k: bridge.tensor_from_numpy(np.asarray(v), "cpu")
          for k, v in jp.items()}
    return jp, tp


def _cache(cfg, B, rng, random):
    """An rglru layer cache, zeros or random: (jax dict, torch dict)."""
    w, K = cfg.rglru.lru_width, cfg.rglru.conv_size
    shapes = {"conv": (B, K - 1, w), "h": (B, w)}
    arrs = {k: (rng.standard_normal(v, dtype=np.float32) if random
                else np.zeros(v, np.float32)) for k, v in shapes.items()}
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v.copy()) for k, v in arrs.items()})


def test_segments_and_specs_match(models):
    jm, jparams, tm = models
    unit = (("rglru", "gated_gelu"), ("rglru", "gated_gelu"),
            ("local", "gated_gelu"))
    assert tm.segments == jm.segments == [(unit, 3),
                                          ((("rglru", "gated_gelu"),), 2)]
    bh = tm.cfg.rglru.block_heads
    wa = tm.params["seg1"]["u0"]["mix"]["wa"]
    assert tuple(wa.shape) == ((2, bh, 128 // bh, 128 // bh) if bh
                               else (2, 128, 128))


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


@pytest.mark.parametrize("gates", sorted(GATES))
def test_bf16_bridge_keeps_dtypes(gates):
    """In a bf16 model every parameter (lam, gates and conv included) and
    the conv cache are bf16 on both sides, and h stays float32; the bridge
    carries each leaf in its own dtype."""
    cfg, jcfg = _cfgs(GATES[gates], "bfloat16")
    jm, tm = jbuild(jcfg), build_model(cfg)
    jparams = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    bridge.params_from_jax_numpy(jparams, tm, "cpu")
    for seg, unit in (("seg0", "u0"), ("seg0", "u1"), ("seg1", "u0")):
        mix = tm.params[seg][unit]["mix"]
        for key in ("lam", "wa", "wi", "conv_w", "wx", "wo"):
            assert mix[key].dtype == torch.bfloat16, (seg, unit, key)
    jc = jax.tree.map(np.asarray, jm.init_cache(2, 16))
    tc = bridge.cache_from_jax_numpy(jc, "cpu")
    ref = tm.init_cache(2, 16)
    for got, want in zip(jax.tree.leaves(tc), jax.tree.leaves(ref)):
        assert got.dtype == want.dtype and got.shape == want.shape
    assert tc[0][0]["h"].dtype == torch.float32
    assert tc[1][0]["h"].dtype == torch.float32
    assert tc[0][0]["conv"].dtype == torch.bfloat16
    assert tc[0][2]["k"].dtype == torch.bfloat16
    for a, b in zip(jax.tree.leaves(bridge.cache_to_numpy(tc)),
                    jax.tree.leaves(jc)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_block_without_cache_matches(models, impl):
    """The training forward: the scan through the wrapper (``kernel``) or
    the plain version (``ref``) equals the reference's."""
    jm, jparams, tm = models
    cfg = tm.cfg.replace(attn_impl=impl)
    jp, tp = _layer(jparams, 1, "griffin")
    x = np.random.default_rng(1).standard_normal((2, 70, cfg.d_model),
                                                 dtype=np.float32)
    yj, _ = jrg.rglru_apply(jp, jnp.asarray(x), cfg=jm.cfg)
    before = trg_ops.plain_calls
    yt, cache = trg.rglru_apply(tp, torch.from_numpy(x), cfg=cfg)
    assert trg_ops.plain_calls == before + (impl == "kernel")
    assert cache is None
    _close(yt, yj)


@pytest.mark.parametrize("lam", ["init", "griffin"])
@pytest.mark.parametrize("init", ["zeros", "random"])
def test_block_prefill_then_decode_matches(models, init, lam):
    """Prefill with a cache continues from the cached conv tail and h
    (through the wrapper) and writes both back; then one-step decodes
    update them; outputs and cache leaves match at every step."""
    jm, jparams, tm = models
    jp, tp = _layer(jparams, 0, lam)
    rng = np.random.default_rng(2)
    jc, tc = _cache(tm.cfg, 2, rng, init == "random")
    x = rng.standard_normal((2, 39, tm.cfg.d_model), dtype=np.float32)
    yj, jc = jrg.rglru_apply(jp, jnp.asarray(x), cfg=jm.cfg, cache=jc)
    before = trg_ops.plain_calls
    yt, tc2 = trg.rglru_apply(tp, torch.from_numpy(x), cfg=tm.cfg, cache=tc)
    assert trg_ops.plain_calls == before + 1
    assert tc2 is tc                                   # written in place
    _close(yt, yj)
    for key in ("conv", "h"):
        _close(tc[key], jc[key])
    assert tc["h"].dtype == torch.float32
    for _ in range(DECODE_STEPS):
        x1 = rng.standard_normal((2, 1, tm.cfg.d_model), dtype=np.float32)
        yj, jc = jrg.rglru_apply(jp, jnp.asarray(x1), cfg=jm.cfg, cache=jc)
        before = trg_ops.plain_calls
        yt, _ = trg.rglru_apply(tp, torch.from_numpy(x1), cfg=tm.cfg,
                                cache=tc)
        assert trg_ops.plain_calls == before            # decode: plain ops
        _close(yt, yj)
        for key in ("conv", "h"):
            _close(tc[key], jc[key])


def test_block_prefill_continues_from_a_used_cache(models):
    """A second prefill continues from the conv tail and h the first left,
    as the reference's does."""
    jm, jparams, tm = models
    jp, tp = _layer(jparams, 2, "griffin")
    rng = np.random.default_rng(3)
    jc, tc = _cache(tm.cfg, 1, rng, False)
    for T in (20, 45):
        x = rng.standard_normal((1, T, tm.cfg.d_model), dtype=np.float32)
        yj, jc = jrg.rglru_apply(jp, jnp.asarray(x), cfg=jm.cfg, cache=jc)
        yt, _ = trg.rglru_apply(tp, torch.from_numpy(x), cfg=tm.cfg,
                                cache=tc)
    _close(yt, yj)
    _close(tc["h"], jc["h"])


def test_loss_and_grad_match(models):
    """Loss and gradients through the wrappers' autograd.Functions equal
    the reference's, leaf for leaf."""
    jm, jparams, tm = models
    rng = np.random.default_rng(4)
    toks = rng.integers(0, tm.cfg.vocab, size=(2, 40)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jl, jg = jax.value_and_grad(lambda p: jm.loss(p, jbatch)[0])(jparams)
    tm.zero_grad(set_to_none=True)
    before = trg_ops.plain_calls
    tl, _ = tm.loss({"tokens": torch.from_numpy(toks).long(),
                     "labels": torch.from_numpy(labels).long()})
    assert trg_ops.plain_calls == before + N_RGLRU
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
                                   rtol=1e-3, atol=1e-3, err_msg=str(path))


@pytest.mark.parametrize("S", PROMPTS)
def test_lm_prefill_and_decode_logits_match(models, S):
    jm, jparams, tm = models
    B = 2
    rng = np.random.default_rng(S)
    toks = rng.integers(0, tm.cfg.vocab, size=(B, S)).astype(np.int32)
    jlog, jcache = jm.prefill(jparams, jnp.asarray(toks),
                              jm.init_cache(B, MAX_LEN))
    before = (trg_ops.plain_calls, tfa.plain_calls)
    with torch.inference_mode():
        tcache = tm.init_cache(B, MAX_LEN)
        tlog, tcache = tm.prefill(torch.from_numpy(toks).long(), tcache)
    # the kernel routes: one scan per rglru layer, one flash call per local
    assert (trg_ops.plain_calls - before[0],
            tfa.plain_calls - before[1]) == (N_RGLRU, N_LOCAL)
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


@pytest.mark.parametrize("case", ["used_cache", "over_window"])
def test_prefill_refuses_and_writes_nothing(models, case):
    """Prefill into a used cache (its local layers hold K/V) or of a prompt
    longer than the local caches (65 > 64) raises ValueError before any
    layer writes its cache: the rglru states stay as they were."""
    _, _, tm = models
    rng = np.random.default_rng(6)
    with torch.inference_mode():
        cache = tm.init_cache(1, MAX_LEN)
        if case == "used_cache":
            tm.prefill(torch.from_numpy(
                rng.integers(0, tm.cfg.vocab, size=(1, 10))).long(), cache)
        before = [t.clone() for t in jax.tree.leaves(cache)]
        n = 10 if case == "used_cache" else tm.cfg.window + 1
        toks = torch.from_numpy(rng.integers(0, tm.cfg.vocab, size=(1, n)))
        with pytest.raises(ValueError,
                           match="empty caches" if case == "used_cache"
                           else "do not fit"):
            tm.prefill(toks.long(), cache)
        for a, b in zip(jax.tree.leaves(cache), before):
            assert torch.equal(a, b)


_sound_coeffs = tref.rglru_coeffs


def _variant_coeffs(x, r, i, lam):
    """``rglru_coeffs`` with ``1 - exp(2 log_a)`` taken as ``1 - a * a``:
    the same function, rounded otherwise in float32."""
    a, _ = _sound_coeffs(x, r, i, lam)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) \
        * (i.float() * x.float())
    return a, b


@pytest.mark.parametrize("gates", sorted(GATES))
def test_reference_init_logits_within_float32_noise(gates, monkeypatch):
    """At the reference's init as it is, the saturated gates leave the
    logits to float32 rounding: an exact reformulation of the scan's
    coefficients moves the port's own prefill logits by ``floor``.  The
    port stays within 4 such floors of the reference, and the floor is
    what limits the comparison (the per-layer fan-in weights above agree
    within 1e-5)."""
    jm, jparams, tm = _pair(GATES[gates], "reference_init")
    for S in PROMPTS:
        toks = np.random.default_rng(S).integers(
            0, tm.cfg.vocab, size=(2, S)).astype(np.int32)
        jlog, _ = jm.prefill(jparams, jnp.asarray(toks),
                             jm.init_cache(2, MAX_LEN))
        with torch.inference_mode():
            tlog, _ = tm.prefill(torch.from_numpy(toks).long(),
                                 tm.init_cache(2, MAX_LEN))
            with monkeypatch.context() as m:
                m.setattr(tref, "rglru_coeffs", _variant_coeffs)
                vlog, _ = tm.prefill(torch.from_numpy(toks).long(),
                                     tm.init_cache(2, MAX_LEN))
        floor = float((tlog - vlog).abs().max())
        diff = float(np.abs(_np(tlog) - _np(jlog)).max())
        assert floor > 10 * TOL, (S, floor)
        assert diff <= 4 * floor, (S, diff, floor)


# ------------------------------------------------------------------ serving
@pytest.fixture(scope="module")
def jax_params():
    """Dense gates, the reference's init at one layer's fan-in (numpy)."""
    _, jparams, _ = _pair(0, "per_layer_fan_in")
    return jax.tree.map(np.asarray, jparams)


def _jax_engine(jax_params, slots):
    """The reference's engine serving ``jax_params``."""
    _, jcfg = _cfgs(0)
    eng = JServeEngine(jcfg, slots=slots, max_len=MAX_LEN)
    eng.params = jax.tree.map(jnp.asarray, jax_params)
    return eng


def _serve(e, slot, prompt, n):
    first, pc = e.prefill(prompt)
    e.attach(slot, len(prompt), first, pc)
    out = [first]
    for _ in range(n - 1):
        out.append(int(e.step([slot])[slot]))
    return out


def test_engine_tokens_match_reference_with_slot_reuse(jax_params):
    """Prompt 1..39 then a 60-token prompt reusing slot 0 of 2, decoding
    past the 64-long window: both engines emit the same tokens (the second
    request sees no state of the first: attach overwrites the slot's conv
    tails, h, K/V and positions)."""
    cfg, _ = _cfgs(0)
    pa = list(range(1, 40))
    pb = np.random.default_rng(9).integers(0, cfg.vocab, size=60).tolist()
    jeng = _jax_engine(jax_params, 2)
    teng = ServeEngine(cfg, slots=2, max_len=MAX_LEN, device="cpu",
                       params=jax_params)
    before = (trg_ops.plain_calls, tfa.plain_calls)
    got = [_serve(teng, 0, pa, 8), _serve(teng, 0, pb, 8)]
    assert (trg_ops.plain_calls - before[0],
            tfa.plain_calls - before[1]) == (2 * N_RGLRU, 2 * N_LOCAL)
    want = [_serve(jeng, 0, pa, 8), _serve(jeng, 0, pb, 8)]
    assert got == want


def test_run_serve_and_run_sequential_match_reference(jax_params,
                                                      monkeypatch):
    """2 slots for 7 requests forces slot reuse; the port's in-proc
    Session(ranks=3) server and its sequential baseline both answer every
    request with the reference's sequential tokens, from one decode
    chain.  ``serve_program`` reduces the arch at 11 layers here (it reads
    ``repro_torch.configs.reduce_cfg`` when called); the reference's
    baseline is its ``SequentialEngine`` serving the same weights."""
    cfg, jcfg = _cfgs(0)
    monkeypatch.setattr(repro_torch.configs, "reduce_cfg",
                        lambda c: cfg if c.name == ARCH else reduce_cfg(c))
    load = LoadSpec(rps=50.0, requests=7, prompt_lens=(12, 39, 60),
                    max_new_lo=3, max_new_hi=8, seed=2)
    reqs = all_requests(load, 2, cfg.vocab)
    assert reqs == jall_requests(load, 2, jcfg.vocab)
    jseq = JSequentialEngine(jcfg, max_len=MAX_LEN)
    jseq._eng.params = jax.tree.map(jnp.asarray, jax_params)
    want = {r["id"]: jseq.serve_one(r["prompt"], r["max_new"])[0]
            for r in reqs}
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
