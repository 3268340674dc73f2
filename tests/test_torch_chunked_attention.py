"""The port's chunked attention against the JAX package's, on the same inputs.

``repro_torch.models.attention.chunked_attention`` against
``repro.models.attention.chunked_attention``: the output, and the grads of
q, k and v (``torch.autograd`` through the port's q-chunk-at-a-time
backward against ``jax.vjp`` of the reference's scan) on numpy-seeded
float32 inputs.  Then the two routes that take it past the threshold: the
port's plain ``_train_attention`` and the flash wrapper's backward, held
to the reference's ``_train_attention``, with ``CHUNKED_THRESHOLD``
lowered on both sides (the port keeps it beside its chunked version in
``kernels/flash_attention/ref.py``; each side reads it at call time; the
reference's flash backward keeps its own literal 8192, so the wrapper is
held to the reference's plain route).

Tolerance: 1e-5, absolute and relative, on the output and every grad.
Both sides compute in float32 from the same inputs; they differ in the
order of sums only (the port skips the kv chunks that mask every pair,
which is exact, and sums dk and dv over q chunks where the reference's one
vjp sums them inside its scan).
"""
import os
import sys

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs files in parallel workers
torch.set_num_threads(1)

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402

from repro.configs import ARCHS as JARCHS                    # noqa: E402
from repro.configs import reduce_cfg as jreduce              # noqa: E402
from repro.models import attention as jattn                  # noqa: E402
from repro_torch.configs import ARCHS, reduce_cfg            # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfa   # noqa: E402
from repro_torch.kernels.flash_attention import ref as tref  # noqa: E402
from repro_torch.models import attention as tattn           # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
import chip_smoke                                            # noqa: E402

TOL = 1e-5
S, H, KH, D = 512, 4, 2, 32
GEMMA = "gemma3-1b"


def _inputs(S, Dv, B=2, seed=0, heads=(H, KH)):
    rng = np.random.default_rng(seed)
    h, kh = heads
    return [rng.standard_normal((B, S, n, d), dtype=np.float32)
            for n, d in ((h, D), (kh, D), (kh, Dv), (h, Dv))]


def _jax_vjp(fn, q, k, v, g):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(out)] + [np.asarray(t) for t in vjp(jnp.asarray(g))]


def _torch_vjp(fn, q, k, v, g):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fn(tq, tk, tv)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    return [out.detach().numpy()] + [t.numpy() for t in grads]


def _close(got, want, what):
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, (what, name)
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL,
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("Dv", [32, 16])
@pytest.mark.parametrize("cap", [None, 50.0])
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_chunk,kv_chunk", [(128, 128), (128, 64)])
def test_chunked_matches_reference(q_chunk, kv_chunk, causal, window, cap,
                                   Dv):
    """Output and grads at S=512 over 4 q chunks, GQA H=4 over KH=2, D=32
    with v's head dim 32 or 16."""
    q, k, v, g = _inputs(S, Dv)
    kw = dict(scale=D ** -0.5, window=window, cap=cap, causal=causal,
              q_chunk=q_chunk, kv_chunk=kv_chunk)
    want = _jax_vjp(lambda *a: jattn.chunked_attention(*a, **kw), q, k, v, g)
    got = _torch_vjp(lambda *a: tattn.chunked_attention(*a, **kw), q, k, v,
                     g)
    _close(got, want, str(kw))


def test_chunked_refuses_a_length_off_its_chunks():
    q, k, v, _ = _inputs(S, D)
    with pytest.raises(ValueError, match="chunks of 96"):
        tattn.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                scale=1.0, window=None, cap=None,
                                q_chunk=96)


@pytest.mark.parametrize("S_,want", [(4096, False), (8192, True),
                                     (8192 + 128, False), (10240, True),
                                     (16384, True)])
def test_use_chunked_is_the_reference_rule(S_, want):
    """S >= 8192 and a multiple of 2048 (``attention.py:187`` of the
    reference)."""
    assert tattn.use_chunked(S_) is want


# past the threshold: S=4096 (two chunks of 2048 a side) with the threshold
# lowered to it on both sides; 2 heads over 1 KV head, as gemma3-1b's MQA
LONG_S, LONG_HEADS = 4096, (2, 1)


@pytest.fixture
def lowered(monkeypatch):
    monkeypatch.setattr(jattn, "CHUNKED_THRESHOLD", LONG_S)
    monkeypatch.setattr(tref, "CHUNKED_THRESHOLD", LONG_S)
    calls = []
    chunked = tattn.chunked_attention
    monkeypatch.setattr(tattn, "chunked_attention",
                        lambda *a, **kw: calls.append(1) or chunked(*a, **kw))
    return calls


def _routes(window, cap):
    jcfg = jreduce(JARCHS[GEMMA].cfg).replace(attn_impl="ref",
                                              attn_softcap=cap)
    tcfg = reduce_cfg(ARCHS[GEMMA].cfg).replace(attn_softcap=cap)
    pos = np.broadcast_to(np.arange(LONG_S, dtype=np.int32), (1, LONG_S))
    kw = dict(scale=D ** -0.5, window=window)

    def ref(q, k, v):
        return jattn._train_attention(q, k, v, positions=jnp.asarray(pos),
                                      cfg=jcfg, **kw)

    def port(impl):
        return lambda q, k, v: tattn._train_attention(
            q, k, v, positions=torch.from_numpy(pos.copy()),
            cfg=tcfg.replace(attn_impl=impl), **kw)
    return ref, port


@pytest.mark.parametrize("Dv", [32, 16])
@pytest.mark.parametrize("window,cap", [(None, None), (64, None),
                                        (None, 50.0)])
def test_plain_train_attention_goes_chunked(lowered, window, cap, Dv):
    """``attn_impl="ref"`` at the threshold: the port's plain training
    attention calls ``chunked_attention``, and output and grads match the
    reference's ``_train_attention``, which takes its own."""
    q, k, v, g = _inputs(LONG_S, Dv, B=1, seed=1, heads=LONG_HEADS)
    ref, port = _routes(window, cap)
    want = _jax_vjp(ref, q, k, v, g)
    got = _torch_vjp(port("ref"), q, k, v, g)
    assert len(lowered) == 1
    _close(got, want, f"plain, window {window}, cap {cap}, Dv {Dv}")


@pytest.mark.parametrize("Dv", [32, 16])
@pytest.mark.parametrize("window,cap", [(None, None), (64, None),
                                        (None, 50.0)])
def test_flash_backward_goes_chunked(lowered, window, cap, Dv):
    """``attn_impl="kernel"`` at the threshold: the flash wrapper's
    backward recomputes through the chunked vjp (counted in
    ``backward_by_path["chunked"]``), and its grads match the reference's
    ``_train_attention``."""
    q, k, v, g = _inputs(LONG_S, Dv, B=1, seed=2, heads=LONG_HEADS)
    ref, port = _routes(window, cap)
    want = _jax_vjp(ref, q, k, v, g)
    before = dict(tfa.backward_by_path)
    got = _torch_vjp(port("kernel"), q, k, v, g)
    assert tfa.backward_by_path["chunked"] == before["chunked"] + 1
    assert tfa.backward_by_path["dense"] == before["dense"]
    assert not lowered          # the forward was the wrapper's, not chunked
    _close(got, want, f"flash, window {window}, cap {cap}, Dv {Dv}")


def test_flash_backward_stays_dense_below_the_threshold():
    q, k, v, g = _inputs(S, D, B=1)
    before = dict(tfa.backward_by_path)
    _torch_vjp(lambda *a: tfa.flash_attention(*a, scale=D ** -0.5), q, k, v,
               g)
    assert tfa.backward_by_path["dense"] == before["dense"] + 1
    assert tfa.backward_by_path["chunked"] == before["chunked"]


@pytest.mark.parametrize("causal", [True, False])
def test_planted_window_fault_moves_the_chunked_path(causal):
    """``chip_smoke.chunked_fault`` (the window mask off by one inside the
    chunked path, planted in phase 40's plain run) moves the output and
    the grads past TOL; outside it the path is the reference's again."""
    q, k, v, g = _inputs(S, D)
    kw = dict(scale=D ** -0.5, window=64, cap=None, causal=causal,
              q_chunk=128, kv_chunk=128)
    fn = lambda *a: tattn.chunked_attention(*a, **kw)  # noqa: E731
    want = _torch_vjp(fn, q, k, v, g)
    with chip_smoke.chunked_fault():
        faulty = _torch_vjp(fn, q, k, v, g)
    for a, b in zip(faulty, want):
        assert np.abs(a - b).max() > 100 * TOL
    _close(_torch_vjp(fn, q, k, v, g), want, "after the fault")


def test_reset_counts_clears_backward_by_path():
    q, k, v, g = _inputs(S, D, B=1)
    _torch_vjp(lambda *a: tfa.flash_attention(*a, scale=D ** -0.5), q, k, v,
               g)
    assert tfa.backward_by_path["dense"] > 0
    tfa.reset_counts()
    assert tfa.backward_by_path == {"dense": 0, "chunked": 0}
    assert tfa.backward_recomputes == 0
