"""The port's TransformerLM against the JAX package's, with the same weights.

Weights come from the reference's own init (``jax.random.PRNGKey(0)``) and
are carried to the port through :mod:`repro_torch.bridge`.  Reduced
gemma3-1b is one unstacked 6-layer segment; with 12 layers it becomes a
stacked segment (leading ``layers`` axis), the layout the full model uses.
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
from repro_torch import bridge                               # noqa: E402
from repro_torch.configs import ARCHS, reduce_cfg            # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfa   # noqa: E402
from repro_torch.models import build_model                   # noqa: E402

# float32 on both sides through ~12 layers: summation order only
TOL = 1e-4
LAYERS = [6, 12]          # 6: one unstacked segment; 12: stacked (6, 2)


def _models(n_layers):
    jcfg = jreduce(JARCHS["gemma3-1b"].cfg).replace(n_layers=n_layers)
    cfg = reduce_cfg(ARCHS["gemma3-1b"].cfg).replace(n_layers=n_layers)
    jm = jbuild(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg)
    bridge.params_from_jax_numpy(jax.tree.map(np.asarray, jparams), tm,
                                 "cpu")
    return jm, jparams, tm


@pytest.fixture(scope="module", params=LAYERS, ids=lambda n: f"L{n}")
def models(request):
    return _models(request.param)


def test_segments_match(models):
    jm, _, tm = models
    assert tm.segments == jm.segments
    stacked = any(r > 1 for _, r in tm.segments)
    assert stacked == (tm.cfg.n_layers == 12)


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


def test_loss_matches(models):
    jm, jparams, tm = models
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tm.cfg.vocab, size=(2, 48)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    jl, _ = jax.jit(jm.loss)(jparams, {"tokens": jnp.asarray(toks),
                                       "labels": jnp.asarray(labels)})
    before = tfa.plain_calls
    with torch.no_grad():
        tl, _ = tm.loss({"tokens": torch.from_numpy(toks).long(),
                         "labels": torch.from_numpy(labels).long()})
    assert tfa.plain_calls == before + tm.cfg.n_layers
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL, atol=TOL)


def test_loss_grad_matches(models):
    """Gradients through the port (the flash wrapper's autograd.Function
    included) equal the reference's, leaf for leaf — also after a forward
    without autograd has run (cached per-layer views must not cut the
    stacked parameters off the graph)."""
    jm, jparams, tm = models
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
        assert node is not None, path
        np.testing.assert_allclose(node.numpy(), np.asarray(leaf),
                                   rtol=TOL, atol=TOL, err_msg=str(path))


def test_prefill_and_greedy_decode_match(models):
    jm, jparams, tm = models
    B, S, L, steps = 2, 20, 64, 8
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
                                   atol=TOL)
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


def test_prefill_refuses_used_cache(models):
    _, _, tm = models
    with torch.inference_mode():
        cache = tm.init_cache(1, 16)
        tm.prefill(torch.zeros(1, 4, dtype=torch.long), cache)
        with pytest.raises(ValueError, match="empty caches"):
            tm.prefill(torch.zeros(1, 4, dtype=torch.long), cache)


def test_cache_bridge_matches_reference_layout(models):
    jm, _, tm = models
    jc = jax.tree.map(np.asarray, jm.init_cache(3, 32))
    tc = bridge.cache_from_jax_numpy(jc, "cpu")
    ref = tm.init_cache(3, 32)
    for a, b in zip(jax.tree.leaves(bridge.cache_to_numpy(tc)),
                    jax.tree.leaves(bridge.cache_to_numpy(ref))):
        np.testing.assert_array_equal(a, b)
