"""The port's TransformerLM against the JAX package's, with the same weights.

Weights come from the reference's own init (``jax.random.PRNGKey(0)``) and
are carried to the port through :mod:`repro_torch.bridge`.  Reduced
gemma3-1b is one unstacked 6-layer segment; with 12 layers it becomes a
stacked segment (leading ``layers`` axis), the layout the full model uses.
Reduced granite-moe-1b-a400m (E=8, k=2) is a stacked pair of MoE layers:
at capacity 8 (no drops), at capacity 1.25 (its 4-row decode batch drops
assignments) and with a leading ``dense_big`` layer before the pair.
Reduced gemma2-2b at 4 layers is the unit (local, attn) stacked twice,
with attention softcap 50, final softcap 30 and window 64.  Reduced
stablelm-1.6b at 4 layers is one stacked segment of 4 MHA layers (4 heads,
4 KV heads of 32, 8 of them rotated), layernorm with a bias, an untied
``lm_head``.  Reduced starcoder2-15b at 4 layers is one stacked segment of
4 local layers (4 heads, 2 KV heads of 32, window 64), layernorm, biases
on q, k, v, o and both products of its plain GELU MLP, an untied
``lm_head``.  Reduced deepseek-v3-671b at 3 layers is one unstacked unit
of 3 (a dense layer, then 2 MoE layers of 8 experts top-2 with a sigmoid
router, a selection bias and a shared expert), every layer MLA (4 heads,
q_lora 64, kv_lora 32, rope 16, nope 32, v 32, so the flash wrapper sees
head dims (48, 32)), an untied ``lm_head`` and the MTP head (depth 1),
whose loss term joins the loss.
"""
import dataclasses
import os
import sys

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
from repro_torch import bridge                               # noqa: E402
from repro_torch.configs import ARCHS, reduce_cfg            # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfa   # noqa: E402
from repro_torch.models import build_model                  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
import chip_smoke                                            # noqa: E402

# float32 on both sides through ~12 layers: summation order only
TOL = 1e-4
GRANITE = "granite-moe-1b-a400m"
# The leaves whose absolute limit scales with the leaf's largest magnitude
# (``_atol``), where the reference's init draws a stacked leaf at the fan-in
# of its layers axis (2 reps here) and float32 rounding alone moves them
# past TOL (the port against itself in float64).  granite-moe-1b-a400m:
# its grads reach ~12 (activations run to the hundreds) and its embedding
# grad moves by 3.5e-4 (JAX's float32 by 6.6e-4).  gemma2-2b: ``wq``/``wk``
# /``wv`` drawn at 2 reps, not d_model 128, put the pre-cap attention
# logits at an rms of ~65 (the softcap of 50 bends) and the K/V caches at
# ~36, moved by up to 3.7e-4, and its embedding grad (largest 1.96) by
# 8.2e-5 (JAX's float32 by 1.7e-4).  stablelm-1.6b: ``wq``/``wk`` drawn
# at 4 reps, not d_model 128, put the attention logits at an rms of ~30
# with no cap and no qk-norm, so the softmax is near one-hot and its
# gradient turns on float32 rounding: over six token draws the port's
# float32 grads sit up to 2.5x that scaled limit from its own float64 run
# (embed, ln1), JAX's float32 up to 3.3x, the two packages up to 4.4x
# apart; its grads are held at 10x the scaled limit.  Logits and losses
# stay within TOL.
GRADS, CACHES = {"grads": 1}, {"grads": 1, "caches": 1}
# The weights of a case: "reference", the reference's init as it is, or
# "layer_fan_in", that init with every stacked leaf it draws at its fan-in
# scaled to one layer's (``chip_smoke._layer_fan_in``, phase 32's gated
# float32 set), the same arrays in both packages.  starcoder2-15b takes the
# second: at the reference's init its float32 logits are rounding noise past
# TOL (``test_starcoder2_reference_init_within_float32_noise``).
# id: (arch, layers, MoE overrides, decode batch, stacked segment, the
# leaves whose limit scales, each with the factor on its scaled limit,
# weights)
MODELS = {
    "L6": ("gemma3-1b", 6, {}, 2, False, (), "reference"),
    "L12": ("gemma3-1b", 12, {}, 2, True, (), "reference"),
    "granite": (GRANITE, 2, {}, 4, True, GRADS, "reference"),
    "granite-cap1.25": (GRANITE, 2, {"capacity_factor": 1.25}, 4, True,
                        GRADS, "reference"),
    "granite-dense1": (GRANITE, 3, {"first_dense": 1}, 4, False, GRADS,
                       "reference"),
    "gemma2": ("gemma2-2b", 4, {}, 2, True, CACHES, "reference"),
    "stablelm": ("stablelm-1.6b", 4, {}, 2, True, {"grads": 10},
                 "reference"),
    "starcoder2": ("starcoder2-15b", 4, {}, 2, True, (), "layer_fan_in"),
    "deepseek": ("deepseek-v3-671b", 3, {}, 2, False, (), "reference"),
}


def _atol(spec, leaves, leaf):
    """The absolute limit for ``leaf``, one of ``leaves`` ("grads" or
    "caches"): TOL, scaled by the leaf's largest magnitude (at least 1)
    and by the case's factor where the case's spec says so."""
    if leaves not in spec[5]:
        return TOL
    return TOL * spec[5][leaves] * max(1.0,
                                       float(np.abs(np.asarray(leaf)).max()))


def _models(name):
    arch, n_layers, over = MODELS[name][:3]
    jcfg = jreduce(JARCHS[arch].cfg).replace(n_layers=n_layers)
    cfg = reduce_cfg(ARCHS[arch].cfg).replace(n_layers=n_layers)
    if over:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **over))
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **over))
    jm = jbuild(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg)
    bridge.params_from_jax_numpy(jax.tree.map(np.asarray, jparams), tm,
                                 "cpu")
    if MODELS[name][6] == "layer_fan_in":
        chip_smoke._layer_fan_in(tm)
        jparams = jax.tree.map(jnp.asarray, bridge.params_to_numpy(tm))
    return jm, jparams, tm, MODELS[name]


@pytest.fixture(scope="module", params=list(MODELS))
def models(request):
    return _models(request.param)


def test_segments_match(models):
    jm, _, tm, spec = models
    assert tm.segments == jm.segments
    assert tm.descs == jm.descs
    stacked = any(r > 1 for _, r in tm.segments)
    assert stacked == spec[4]


def test_bridge_round_trips_exactly(models):
    _, jparams, tm, _ = models
    back = bridge.params_to_numpy(tm)
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat_j:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


def test_loss_matches(models):
    """The loss (the MoE layers' aux loss and the MTP term included) and
    its aux and MTP terms; the flash wrapper runs once a layer and once in
    the MTP layer."""
    jm, jparams, tm, _ = models
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tm.cfg.vocab, size=(2, 48)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    jl, jmet = jax.jit(jm.loss)(jparams, {"tokens": jnp.asarray(toks),
                                          "labels": jnp.asarray(labels)})
    before = tfa.plain_calls
    with torch.no_grad():
        tl, tmet = tm.loss({"tokens": torch.from_numpy(toks).long(),
                            "labels": torch.from_numpy(labels).long()})
    assert tfa.plain_calls == before + tm.cfg.n_layers + tm.cfg.mtp_depth
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL, atol=TOL)
    assert set(tmet) == set(jmet)
    for key in tmet:
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)
    assert (float(jmet["aux"]) > 0) == (tm.cfg.moe is not None)
    assert ("mtp" in tmet) == bool(tm.cfg.mtp_depth)


def test_loss_grad_matches(models):
    """Gradients through the port (the flash wrapper's autograd.Function
    included) equal the reference's, leaf for leaf — also after a forward
    without autograd has run (cached per-layer views must not cut the
    stacked parameters off the graph)."""
    jm, jparams, tm, spec = models
    rng = np.random.default_rng(2)
    toks = rng.integers(0, tm.cfg.vocab, size=(2, 24)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    with torch.inference_mode():
        tm.prefill(torch.from_numpy(toks).long(), tm.init_cache(2, 64))
    tm.zero_grad(set_to_none=True)
    tl, _ = tm.loss({"tokens": torch.from_numpy(toks).long(),
                     "labels": torch.from_numpy(labels).long()})
    tl.backward()
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jg = jax.jit(jax.grad(lambda p: jm.loss(p, jbatch)[0]))(jparams)
    tg = jax.tree.map(lambda p: p.grad, tm.params.to_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(jg):
        node = tg
        for k in path:
            node = node[k.key]
        if node is None:
            # a leaf no gradient reaches (deepseek's ``router_bias`` only
            # picks the top-k): autograd leaves it None, JAX gives zeros
            assert not np.asarray(leaf).any(), path
            continue
        # granite's and gemma2-2b's limits scale (see MODELS);
        # gemma3-1b's stays TOL
        np.testing.assert_allclose(node.numpy(), np.asarray(leaf),
                                   rtol=TOL,
                                   atol=_atol(spec, "grads", leaf),
                                   err_msg=str(path))


@pytest.fixture
def drops():
    """The assignments every MoE dispatch drops (a list of ints), counted
    by ``chip_smoke.moe_drops``."""
    with chip_smoke.moe_drops() as counts:
        yield counts


def test_prefill_and_greedy_decode_match(models, drops):
    """A prefill and 8 greedy decode steps of a batch; for granite a
    4-row batch, which drops assignments at capacity 1.25."""
    jm, jparams, tm, spec = models
    B, S, L, steps = spec[3], 20, 64, 8
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tm.cfg.vocab, size=(B, S)).astype(np.int32)
    jcache = jm.init_cache(B, L)
    jprefill, jdecode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    jlog, jcache = jprefill(jparams, jnp.asarray(toks), jcache)
    before = tfa.plain_calls
    with torch.inference_mode():
        tcache = tm.init_cache(B, L)
        tlog, tcache = tm.prefill(torch.from_numpy(toks).long(), tcache)
    assert tfa.plain_calls == before + tm.cfg.n_layers   # the flash route
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=TOL,
                               atol=TOL)
    for leaf_t, leaf_j in zip(jax.tree.leaves(bridge.cache_to_numpy(tcache)),
                              jax.tree.leaves(jcache)):
        np.testing.assert_allclose(leaf_t, np.asarray(leaf_j), rtol=TOL,
                                   atol=_atol(spec, "caches", leaf_j))
    jtok = jnp.argmax(jlog[:, -1], -1)[:, None].astype(jnp.int32)
    ttok = torch.argmax(tlog[:, -1], -1)[:, None]
    for i in range(steps):
        pos = np.full((B, 1), S + i, np.int32)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jlog, jcache = jdecode(jparams, jcache, jtok, jnp.asarray(pos))
        with torch.inference_mode():
            tlog, tcache = tm.decode_step(tcache, ttok,
                                          torch.from_numpy(pos))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=TOL,
                                   atol=TOL)
        jtok = jnp.argmax(jlog[:, -1], -1)[:, None].astype(jnp.int32)
        ttok = torch.argmax(tlog[:, -1], -1)[:, None]
    moe_layers = sum(d[1] == "moe" for d in tm.descs)
    assert len(drops) == moe_layers * (1 + steps)
    assert (sum(drops) > 0) == (tm.cfg.moe is not None
                                and tm.cfg.moe.capacity_factor < 8)


# the reduced configs cut the window to 64 (``configs/base.py``): a
# sequence past 65 tokens is where a local layer's window masks keys
WINDOWED = [n for n, spec in MODELS.items()
            if "local" in reduce_cfg(ARCHS[spec[0]].cfg).pattern]
LONG = 80


@pytest.mark.parametrize("models", WINDOWED, indirect=True)
def test_window_masks_keys_past_its_length(models):
    """80 tokens, past the window of 64: the loss matches the reference's
    (the mask bites: widening the window past the sequence moves the
    logits from position 64 on, and no earlier one), and so do a prefill
    of the first 64 tokens and 16 teacher-forced decode steps to position
    79, over which the local caches wrap their ring buffers."""
    jm, jparams, tm, _ = models
    W = tm.cfg.window
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tm.cfg.vocab, size=(2, LONG)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    jl, _ = jax.jit(jm.loss)(jparams, {"tokens": jnp.asarray(toks),
                                       "labels": jnp.asarray(labels)})
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()}
    wide = build_model(tm.cfg.replace(window=2 * LONG)).set_params(
        tm.params.to_dict())
    with torch.no_grad():
        tl, _ = tm.loss(batch)
        lg, lw = (m.logits(m.forward(m.embed(batch["tokens"]),
                                     positions=m._positions(
                                         batch["tokens"]))[0])
                  for m in (tm, wide))
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL, atol=TOL)
    # the window changes no position before W and moves the later ones
    assert torch.equal(lg[:, :W], lw[:, :W])
    assert float((lg[:, W:] - lw[:, W:]).abs().max()) > 100 * TOL
    jcache = jm.init_cache(2, LONG)
    jlog, jcache = jax.jit(jm.prefill)(jparams, jnp.asarray(toks[:, :W]),
                                       jcache)
    with torch.inference_mode():
        tlog, tcache = tm.prefill(torch.from_numpy(toks[:, :W]).long(),
                                  tm.init_cache(2, LONG))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=TOL,
                               atol=TOL)
    jdecode = jax.jit(jm.decode_step)
    for p in range(W, LONG):
        pos = np.full((2, 1), p, np.int32)
        tok = toks[:, p:p + 1]
        jlog, jcache = jdecode(jparams, jcache, jnp.asarray(tok),
                               jnp.asarray(pos))
        with torch.inference_mode():
            tlog, tcache = tm.decode_step(tcache, torch.from_numpy(tok).long(),
                                          torch.from_numpy(pos))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=TOL,
                                   atol=TOL, err_msg=f"position {p}")


def _planted_faults(tm, control, faults):
    """The last logits of ``tm``'s plain path (a 40-token prefill) with
    each of ``control`` and ``faults`` planted by
    ``chip_smoke.attention_fault``: {fault: max distance from the sound
    plain path}, after holding the kernel route to the sound plain path
    within TOL; and the plain path's attention logits of its first and
    last layer (``chip_smoke._precap_logits``), which must leave the
    logits bit-equal."""
    plain = build_model(tm.cfg.replace(attn_impl="ref")).set_params(
        tm.params.to_dict())
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, tm.cfg.vocab, size=(1, 40)))

    def last(m):
        with torch.inference_mode():
            lg, _ = m.prefill(toks, m.init_cache(1, 64))
        return lg[0, -1]
    want = last(plain)
    np.testing.assert_allclose(last(tm).numpy(), want.numpy(), rtol=TOL,
                               atol=TOL)
    diffs = {}
    for fault in (control,) + faults:
        with chip_smoke.attention_fault(fault):
            diffs[fault] = float((last(plain) - want).abs().max())
    layers = (0, tm.cfg.n_layers - 1)
    with chip_smoke._precap_logits(layers) as precap:
        torch.testing.assert_close(last(plain), want, rtol=0, atol=0)
    assert sorted(precap) == list(layers)
    return diffs, precap


@pytest.mark.parametrize("models", ["gemma2"], indirect=True)
def test_gemma2_planted_faults_move_the_plain_path(models):
    """The faults that ``chip_smoke`` plants in gemma2-2b's plain attention
    path (``attention_fault``) each move its last logits past the chip
    check's float32 gate, while its control (K/V expanded to the query
    heads by the right map) and the kernel route stay within TOL of the
    sound plain path; ``_precap_logits`` reads the logits that the plain
    attention then softcaps, over the pairs its masks keep."""
    _, _, tm, _ = models
    diffs, precap = _planted_faults(tm, chip_smoke.GEMMA2_CONTROL,
                                    chip_smoke.GEMMA2_FAULTS)
    for fault, diff in diffs.items():
        assert (diff > chip_smoke.LOGIT_TOL) == (
            fault != chip_smoke.GEMMA2_CONTROL), (fault, diff)
    # the reference's init drives the pre-cap logits past the bend
    for st in precap.values():
        assert st["max_abs"] >= st["rms"] > chip_smoke.SOFTCAP_BEND
        assert 0 < st["share_past_bend"] < 1


@pytest.mark.parametrize("models", ["stablelm"], indirect=True)
def test_stablelm_planted_faults_move_the_plain_path(models):
    """The faults that ``chip_smoke`` plants in stablelm-1.6b's plain path
    for MHA (the next KV head, one key past the causal bound, the rotary
    on every dim) each move its last logits past the chip check's float32
    gate, while its control (K/V expanded by the identity map) stays
    within TOL; its attention has no cap, so ``_precap_logits`` reads its
    pre-softmax logits and reports no share past a bend."""
    _, _, tm, _ = models
    assert tm.cfg.n_heads == tm.cfg.n_kv_heads
    assert int(tm.cfg.hd * tm.cfg.rope_fraction) < tm.cfg.hd
    diffs, precap = _planted_faults(tm, chip_smoke.STABLELM_CONTROL,
                                    chip_smoke.STABLELM_FAULTS)
    assert diffs[chip_smoke.STABLELM_CONTROL] <= TOL, diffs
    for fault in chip_smoke.STABLELM_FAULTS:
        assert diffs[fault] > chip_smoke.LOGIT_TOL, (fault, diffs)
    # the reference's init puts the softmax near one-hot
    for st in precap.values():
        assert "share_past_bend" not in st
        assert st["max_abs"] >= st["rms"] > 10


@pytest.mark.parametrize("models", ["starcoder2"], indirect=True)
def test_starcoder2_planted_faults_move_the_plain_path(models):
    """The faults that ``chip_smoke`` plants in starcoder2-15b's plain path
    (query head h reading KV head h % KH, the next KV head, one key past
    the causal bound) each move its last logits past the chip check's
    float32 gate, while its control (K/V expanded by the right map) stays
    within TOL, at the case's weights (one layer's fan-in, phase 32's
    gated set).  Then phase 32's window check at this size: a cache-free
    forward of 80 tokens, past the window of 64, through the kernel route
    and the plain path (``chip_smoke.tail_logits``) agree within TOL over
    the positions whose window masks keys, and the window dropped from the
    plain attention (``no_window``) moves them past the gate while the
    control does not."""
    _, _, tm, _ = models
    H, KH, W = tm.cfg.n_heads, tm.cfg.n_kv_heads, tm.cfg.window
    assert H > KH > 1 and tm.cfg.pattern == ("local",)
    diffs, precap = _planted_faults(tm, chip_smoke.STARCODER2_CONTROL,
                                    chip_smoke.STARCODER2_FAULTS)
    assert diffs[chip_smoke.STARCODER2_CONTROL] <= TOL, diffs
    for fault in chip_smoke.STARCODER2_FAULTS:
        assert diffs[fault] > chip_smoke.LOGIT_TOL, (fault, diffs)
    # at one layer's fan-in the attention logits have an rms near 1
    for st in precap.values():
        assert "share_past_bend" not in st
        assert st["max_abs"] >= st["rms"] and 0.3 < st["rms"] < 3
    plain = build_model(tm.cfg.replace(attn_impl="ref")).set_params(
        tm.params.to_dict())
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(0, tm.cfg.vocab, size=(1, LONG)))
    want = chip_smoke.tail_logits(plain, toks, LONG - W)
    assert want.shape == (1, LONG - W, tm.cfg.vocab)
    before = tfa.plain_calls
    got = chip_smoke.tail_logits(tm, toks, LONG - W)
    assert tfa.plain_calls == before + tm.cfg.n_layers   # the flash route
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                               atol=TOL)
    moved = {}
    for fault in (chip_smoke.STARCODER2_CONTROL, chip_smoke.WINDOW_FAULT):
        with chip_smoke.attention_fault(fault):
            moved[fault] = float((chip_smoke.tail_logits(
                plain, toks, LONG - W) - want).abs().max())
    assert moved[chip_smoke.STARCODER2_CONTROL] <= TOL, moved
    assert moved[chip_smoke.WINDOW_FAULT] > chip_smoke.LOGIT_TOL, moved


def test_starcoder2_reference_init_within_float32_noise(monkeypatch):
    """At the reference's init as it is, reduced starcoder2-15b's float32
    logits are rounding noise past TOL: ``wq``/``wk`` drawn at 4 reps, not
    d_model 128, put the attention logits at an rms near 30 with no cap,
    and the near one-hot softmax amplifies every rounding.  Over the window
    test's draw (a prefill of 64 tokens, then 16 teacher-forced decode
    steps past the window) the port's float32 logits sit ``floor`` from its
    own float64 run (every ``.float()`` cast made float64), above TOL, and
    the reference's float32 logits sit further still (3.6x the port's on
    this draw).  Both stay within the chip check's float32 gate
    (LOGIT_TOL) of that float64 run, and the loss over all 80 tokens
    within TOL of the reference's; at one layer's fan-in (the
    ``starcoder2`` case) every LM test holds at TOL."""
    arch = "starcoder2-15b"
    jcfg = jreduce(JARCHS[arch].cfg).replace(n_layers=4)
    cfg = reduce_cfg(ARCHS[arch].cfg).replace(n_layers=4)
    jm = jbuild(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    tm, t64 = build_model(cfg), build_model(cfg.replace(dtype="float64"))
    bridge.params_from_jax_numpy(tree, tm, "cpu")
    bridge.params_from_jax_numpy(
        jax.tree.map(lambda a: a.astype(np.float64), tree), t64, "cpu")
    W = cfg.window
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab, size=(2, LONG)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    jl, _ = jax.jit(jm.loss)(jparams, {"tokens": jnp.asarray(toks),
                                       "labels": jnp.asarray(labels)})
    with torch.no_grad():
        tl, _ = tm.loss({"tokens": torch.from_numpy(toks).long(),
                         "labels": torch.from_numpy(labels).long()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL, atol=TOL)

    def run(m):
        """The prefill's logits, then each decode step's, float64."""
        with torch.inference_mode():
            lg, cache = m.prefill(torch.from_numpy(toks[:, :W]).long(),
                                  m.init_cache(2, LONG))
            out = [lg.double()]
            for p in range(W, LONG):
                lg, cache = m.decode_step(
                    cache, torch.from_numpy(toks[:, p:p + 1]).long(),
                    torch.from_numpy(np.full((2, 1), p, np.int32)))
                out.append(lg.double())
        return torch.cat(out, dim=1)
    got = run(tm)
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "float", torch.Tensor.double)
        f64 = run(t64)
    jlog, jcache = jax.jit(jm.prefill)(jparams, jnp.asarray(toks[:, :W]),
                                       jm.init_cache(2, LONG))
    want = [np.asarray(jlog)]
    jdecode = jax.jit(jm.decode_step)
    for p in range(W, LONG):
        jlog, jcache = jdecode(jparams, jcache, jnp.asarray(toks[:, p:p + 1]),
                               jnp.asarray(np.full((2, 1), p, np.int32)))
        want.append(np.asarray(jlog))
    want = torch.from_numpy(np.concatenate(want, axis=1)).double()
    floor = float((got - f64).abs().max())
    noise = float((want - f64).abs().max())
    assert floor > TOL, floor
    assert max(floor, noise) <= chip_smoke.LOGIT_TOL, (floor, noise)


def test_f64_attention_computes_in_float64():
    """``chip_smoke._f64_attention`` (the plain path's float32 floor in
    phases 20, 24, 28 and 32) runs the whole plain attention in float64:
    on float32 inputs whose logits reach ~100, as the port's init gives
    them, its output is the float64 result rounded once (here against
    SDPA in float64).  The plain attention's own ``.float()`` once rounded
    q and k back to float32, leaving only p.v in float64 and an error of
    ~1e-5 of the output's scale."""
    from repro_torch.models import attention
    rng = np.random.default_rng(8)
    B, S, H, KH, D = 1, 48, 4, 2, 32
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, h, D))
                                .astype(np.float32) * scale)
               for h, scale in ((H, 6.0), (KH, 6.0), (KH, 1.0)))
    pos = torch.arange(S)[None]
    with chip_smoke._f64_attention():
        got = attention.ref_attention(q, k, v, scale=D ** -0.5, q_pos=pos,
                                      k_pos=pos, window=None, cap=None)
    assert got.dtype == torch.float32
    want = torch.nn.functional.scaled_dot_product_attention(
        *(t.double().transpose(1, 2) for t in (q, k.repeat_interleave(
            H // KH, 2), v.repeat_interleave(H // KH, 2))),
        is_causal=True, scale=D ** -0.5).transpose(1, 2).float()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


# the leaves that ``test_redrawn_norms_match`` redraws in each case: every
# layernorm, and every bias
NORMS = [("final_norm",), ("seg0", "u0", "ln1"), ("seg0", "u0", "ln2")]
REDRAWN = {
    "stablelm": NORMS,
    "starcoder2": sorted(NORMS + [("seg0", "u0", "mix", b)
                                  for b in ("bq", "bk", "bv", "bo")]
                         + [("seg0", "u0", "mlp", b) for b in ("b1", "b2")]),
}
BIASES = ("bq", "bk", "bv", "bo", "b1", "b2")


@pytest.mark.parametrize("models", list(REDRAWN), indirect=True)
def test_redrawn_norms_match(models):
    """Every layernorm's ``w`` redrawn as 1 + 0.1 N and its ``b`` as 0.1 N,
    and every bias of the attention and the MLP (``bq``, ``bk``, ``bv``,
    ``bo``, ``b1``, ``b2``) as 0.1 N (numpy seeded), the same arrays
    written into both packages' trees: the loss, a prefill's logits and
    greedy decode steps' logits match the reference's within TOL, and the
    redraw moves the logits.  The other leaves are the reference's init as
    it is, whatever the case's weights.  At that init (``w`` = 1, every
    bias 0) a port that dropped a bias, put it after the GELU or swapped
    ``w`` and ``b`` would pass every other test."""
    jm, _, tm, spec = models
    base = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    redrawn = []

    def redraw(t, path):
        if set(t) == {"w", "b"}:                 # a layernorm
            redrawn.append(path)
            return {"w": 1 + 0.1 * rng.standard_normal(t["w"].shape),
                    "b": 0.1 * rng.standard_normal(t["b"].shape)}
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = redraw(v, path + (k,))
            elif k in BIASES:
                redrawn.append(path + (k,))
                out[k] = 0.1 * rng.standard_normal(v.shape)
            else:
                out[k] = v
        return out
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        redraw(base, ()))
    case = next(n for n, s in MODELS.items() if s == spec)
    assert sorted(redrawn) == REDRAWN[case]
    jp = jax.tree.map(jnp.asarray, tree)
    rm, sm = build_model(tm.cfg), build_model(tm.cfg)
    bridge.params_from_jax_numpy(tree, rm, "cpu")
    bridge.params_from_jax_numpy(base, sm, "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tm.cfg.vocab, size=(2, 24)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    jl, _ = jax.jit(jm.loss)(jp, {"tokens": jnp.asarray(toks),
                                  "labels": jnp.asarray(labels)})
    with torch.no_grad():
        tl, _ = rm.loss({"tokens": torch.from_numpy(toks).long(),
                         "labels": torch.from_numpy(labels).long()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL, atol=TOL)
    B, S, L = 2, 20, 64
    jcache = jm.init_cache(B, L)
    jlog, jcache = jax.jit(jm.prefill)(jp, jnp.asarray(toks[:, :S]), jcache)
    with torch.inference_mode():
        tlog, tcache = rm.prefill(torch.from_numpy(toks[:, :S]).long(),
                                  rm.init_cache(B, L))
        slog, _ = sm.prefill(torch.from_numpy(toks[:, :S]).long(),
                             sm.init_cache(B, L))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=TOL,
                               atol=TOL)
    assert float((tlog - slog).abs().max()) > 100 * TOL
    jdecode = jax.jit(jm.decode_step)
    for i in range(4):
        tok = np.array(jnp.argmax(jlog[:, -1], -1)[:, None], np.int32)
        np.testing.assert_array_equal(
            torch.argmax(tlog[:, -1], -1)[:, None].numpy(), tok)
        pos = np.full((B, 1), S + i, np.int32)
        jlog, jcache = jdecode(jp, jcache, jnp.asarray(tok),
                               jnp.asarray(pos))
        with torch.inference_mode():
            tlog, tcache = rm.decode_step(tcache, torch.from_numpy(tok).long(),
                                          torch.from_numpy(pos))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=TOL,
                                   atol=TOL, err_msg=f"step {i}")


def test_prefill_refuses_used_cache(models):
    _, _, tm, _ = models
    with torch.inference_mode():
        cache = tm.init_cache(1, 16)
        tm.prefill(torch.zeros(1, 4, dtype=torch.long), cache)
        with pytest.raises(ValueError, match="empty caches"):
            tm.prefill(torch.zeros(1, 4, dtype=torch.long), cache)


def test_cache_bridge_matches_reference_layout(models):
    jm, _, tm, _ = models
    jc = jax.tree.map(np.asarray, jm.init_cache(3, 32))
    tc = bridge.cache_from_jax_numpy(jc, "cpu")
    ref = tm.init_cache(3, 32)
    for a, b in zip(jax.tree.leaves(bridge.cache_to_numpy(tc)),
                    jax.tree.leaves(bridge.cache_to_numpy(ref))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("models", ["deepseek"], indirect=True)
def test_deepseek_planted_faults_move_the_plain_path(models):
    """The faults that ``chip_smoke`` plants in deepseek-v3's plain path,
    the reference's absorbed MLA (the logits scaled by v's head dim, k_rope
    cached unrotated, one key past the causal bound), each move its last
    logits past the chip check's float32 gate, while the control (the same
    attention un-absorbed, per-head K and V from the latent through the
    plain GQA attention) stays within TOL of the sound plain path; the
    kernel route (K and V materialised, the flash wrapper at (48, 32))
    stays within TOL too, and ``_precap_logits`` reads the absorbed
    path's pre-softmax logits of the first and last layer, near an rms of
    1 (``q_norm`` and ``kv_norm`` normalise both latents)."""
    _, _, tm, _ = models
    m = tm.cfg.mla
    assert m.v_dim != m.nope_dim + m.rope_dim
    diffs, precap = _planted_faults(tm, chip_smoke.DEEPSEEK_CONTROL,
                                    chip_smoke.DEEPSEEK_FAULTS)
    assert diffs[chip_smoke.DEEPSEEK_CONTROL] <= TOL, diffs
    for fault in chip_smoke.DEEPSEEK_FAULTS:
        assert diffs[fault] > chip_smoke.LOGIT_TOL, (fault, diffs)
    for st in precap.values():
        assert "share_past_bend" not in st
        assert st["max_abs"] >= st["rms"] and 0.3 < st["rms"] < 3


def test_deepseek_f64_floor_covers_the_absorbed_attention():
    """``chip_smoke._f64_attention`` (phase 36's float32 floor) runs MLA's
    absorbed attention in float64 too, its W_uk and W_uv einsums
    included: on float32 inputs its output is the float64 result rounded
    once (here written out in float64 einsums), where the float32 path's
    own rounding sits further off."""
    from repro_torch.models import attention
    rng = np.random.default_rng(9)
    B, S, H, L, R, N, V = 1, 24, 4, 32, 16, 32, 32
    q_nope, q_rope, c_kv, k_rope, wk_b, wv_b = (
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        for shape in ((B, S, H, N), (B, S, H, R), (B, S, L), (B, S, R),
                      (L, H, N), (L, H, V)))
    pos = torch.arange(S)[None]
    scale = (N + R) ** -0.5
    kw = dict(wk_b=wk_b, wv_b=wv_b, scale=scale, q_pos=pos, k_pos=pos)
    with chip_smoke._f64_attention():
        got = attention.mla_absorbed(q_nope, q_rope, c_kv, k_rope, **kw)
    f32 = attention.mla_absorbed(q_nope, q_rope, c_kv, k_rope, **kw)
    d = [t.double() for t in (q_nope, q_rope, c_kv, k_rope, wk_b, wv_b)]
    logits = (torch.einsum("bshl,btl->bhst",
                           torch.einsum("bshk,lhk->bshl", d[0], d[4]), d[2])
              + torch.einsum("bshr,btr->bhst", d[1], d[3])) * scale
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    probs = torch.softmax(logits.masked_fill(~causal, float("-inf")), -1)
    want = torch.einsum("bshl,lhk->bshk",
                        torch.einsum("bhst,btl->bshl", probs, d[2]),
                        d[5]).float()
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    assert float((f32 - want).abs().max()) > 10 * float(
        (got - want).abs().max())


# ------------------------------------------------------------------ remat
# The reference checkpoints each unit (``jax.checkpoint`` of ``_unit_body``)
# unless ``remat == "none"``; the reduced configs set "none".  Remat changes
# no value: the port's "full" and "dots" recompute the same ops in the same
# order, so on the CPU they equal its "none" run bit for bit.
REMATS = ("full", "dots")


def _remat_batch(cfg, seed=5, S=24):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(2, S)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _port_grads(tm, remat, toks, labels):
    """Loss and grads (one per parameter, None where none reaches it) of a
    copy of ``tm`` at ``remat``, and the plain attention calls it made."""
    m = build_model(tm.cfg.replace(remat=remat)).set_params(
        tm.params.to_dict())
    leaves = list(m.params.parameters())
    before = tfa.plain_calls
    loss, _ = m.loss({"tokens": torch.from_numpy(toks).long(),
                      "labels": torch.from_numpy(labels).long()})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), grads, tfa.plain_calls - before, m


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("models", ["L6", "L12"], indirect=True)
def test_remat_matches_reference(models, remat):
    """Reduced gemma3-1b (one 6-layer unit, and two stacked) at remat
    "full" and "dots" in both packages: the loss and every grad against
    the reference's ``jax.value_and_grad`` at the same remat, at TOL."""
    jm, jparams, tm, spec = models
    toks, labels = _remat_batch(tm.cfg)
    jrm = jbuild(jm.cfg.replace(remat=remat))
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jrm.loss(p, jbatch)[0]))(jparams)
    tl, grads, _, m = _port_grads(tm, remat, toks, labels)
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL, atol=TOL)
    tg = dict(zip((id(p) for p in m.params.parameters()), grads))
    tree = jax.tree.map(lambda p: tg[id(p)], m.params.to_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(jg):
        node = tree
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node.numpy(), np.asarray(leaf), rtol=TOL,
                                   atol=_atol(spec, "grads", leaf),
                                   err_msg=str(path))


@pytest.mark.parametrize("remat", REMATS)
def test_remat_equals_none_bit_for_bit(models, remat):
    """Every family case of MODELS at remat "full" and "dots" against its
    own "none" run: loss and grads equal bit for bit (the MoE aux loss and
    the MTP term included), and every attention layer's plain call runs
    twice, forward and recompute (the MTP layer, outside the units, once).
    """
    tm = models[2]
    toks, labels = _remat_batch(tm.cfg)
    l0, g0, n0, _ = _port_grads(tm, "none", toks, labels)
    l1, g1, n1, _ = _port_grads(tm, remat, toks, labels)
    assert torch.equal(l0, l1)
    assert len(g0) == len(g1)
    for a, b in zip(g0, g1):
        assert (a is None and b is None) or torch.equal(a, b)
    attn = sum(d[0] in ("attn", "local", "mla") for d in tm.descs)
    assert (n0, n1) == (attn + tm.cfg.mtp_depth,
                        2 * attn + tm.cfg.mtp_depth)


@pytest.mark.parametrize("models", ["L12"], indirect=True)
def test_remat_only_under_autograd_without_caches(models):
    """Without autograd (a forward under no_grad, a prefill, a decode
    step) remat "full" runs each attention layer once, as "none" does."""
    tm = models[2]
    m = build_model(tm.cfg.replace(remat="full")).set_params(
        tm.params.to_dict())
    toks, labels = _remat_batch(tm.cfg)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()}
    for run in (lambda: m.loss(batch),
                lambda: m.prefill(batch["tokens"], m.init_cache(2, 64))):
        before = tfa.plain_calls
        with torch.no_grad():
            run()
        assert tfa.plain_calls - before == tm.cfg.n_layers


def _held_bytes(m, batch):
    """(bytes left allocated by the forward, which is what its graph holds
    for the backward: the CPU profiler's memory events summed; bytes of
    the activations autograd saves through ``saved_tensors_hooks``,
    parameters aside)."""
    from torch.profiler import ProfilerActivity, profile
    params = {p.untyped_storage().data_ptr() for p in m.parameters()}
    saved = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in params:
            saved[st.data_ptr()] = st.nbytes()
        return t
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = m.loss(batch)
    held = sum(e.self_cpu_memory_usage for e in prof.key_averages())
    return held, sum(saved.values()), loss


@pytest.mark.parametrize("models", ["L12"], indirect=True)
def test_remat_saved_bytes_order(models):
    """Reduced gemma3-1b at 12 layers (two units of 6), S=64: the bytes
    the forward leaves for the backward order "full" < "dots" < "none".
    ``saved_tensors_hooks`` see what autograd saves outside the units
    alone under remat (a checkpoint's own hooks are innermost inside a
    unit, and "dots" keeps its products in the selective checkpoint's
    cache, not as saved tensors), so they read equal for "full" and
    "dots" and far below "none"; the bytes left allocated (the CPU
    profiler's memory events) count the cache too."""
    tm = models[2]
    toks, labels = _remat_batch(tm.cfg, S=64)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()}
    held, saved = {}, {}
    for remat in ("none", "dots", "full"):
        m = build_model(tm.cfg.replace(remat=remat)).set_params(
            tm.params.to_dict())
        held[remat], saved[remat], loss = _held_bytes(m, batch)
        del loss
    assert held["full"] < held["dots"] < held["none"], held
    assert saved["full"] == saved["dots"] < saved["none"] / 4, saved


def test_vision_loss_raises():
    """Reduced internvl2-76b: ``loss`` prepends ``batch["patch_embeds"]``,
    as the reference's does, so without them it raises KeyError (as the
    reference's does) rather than run the text alone; with them it runs
    (held to the reference in ``test_torch_encdec.py``)."""
    cfg = reduce_cfg(ARCHS["internvl2-76b"].cfg)
    assert cfg.frontend == "vision"
    m = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((2, 16), dtype=torch.long)
    with pytest.raises(KeyError, match="patch_embeds"):
        m.loss({"tokens": toks, "labels": toks})
    with torch.no_grad():
        loss, _ = m.loss({"tokens": toks, "labels": toks,
                          "patch_embeds": torch.zeros((2, 4, cfg.d_model))})
    assert torch.isfinite(loss)
