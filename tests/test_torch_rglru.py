"""The port's RG-LRU scan against the JAX package's, on the same inputs.

On the CPU the port's wrapper answers with its plain version, so these
tests hold that plain version (and the autograd.Function around it) to the
reference: its oracle ``_rglru_scan`` on every kernel test case, with an
initial and a final state, at ragged T, with long memory, the Pallas kernel
itself in interpret mode on two cases, and the gradient.  The CUDA kernel
is held to the plain version by ``test_torch_kernels_gpu.py`` (skipped
without a card) and by ``chip_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs files in parallel workers, and
# oversubscribed cores starve the socket tests' heartbeat threads
torch.set_num_threads(1)

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402

from repro.kernels.rglru import ops as jrg                   # noqa: E402
from repro.kernels.rglru.ref import rglru_ref as jref        # noqa: E402
from repro.models.rglru import _rglru_scan as jscan          # noqa: E402
from repro_torch.kernels.rglru import ops as trg             # noqa: E402
from repro_torch.kernels.rglru import ref as tref            # noqa: E402

# the reference's RG_CASES (tests/test_kernels.py): (T, W), drawn at B=2
RG_CASES = [(128, 128), (256, 256), (128, 512), (512, 128)]
# the reference's kernel-test tolerance (rtol = atol): float32 on both
# sides, the scans differ in the order of their products only
TOL = 2e-4


def _inputs(T, W, B=2, seed=0, h0=False, lam="test"):
    """numpy-seeded float32 inputs as (jax arrays, torch tensors): x normal,
    r and i sigmoids of normals, lam as the reference's kernel test draws
    it (|normal| + 0.2, short memory) or, for ``lam="griffin"``, as
    Griffin's init does (a = exp(-8 softplus(lam)) uniform in
    [0.9, 0.999], long memory); h0 normal if asked for."""
    rng = np.random.default_rng(seed)
    sig = lambda a: 1.0 / (1.0 + np.exp(-a))             # noqa: E731
    x = rng.standard_normal((B, T, W), dtype=np.float32)
    r = sig(rng.standard_normal((B, T, W), dtype=np.float32))
    i = sig(rng.standard_normal((B, T, W), dtype=np.float32))
    if lam == "griffin":
        u = rng.uniform(0.9, 0.999, W)
        lv = np.log(np.expm1(-np.log(u) / 8)).astype(np.float32)
    else:
        lv = np.abs(rng.standard_normal(W, dtype=np.float32)) + 0.2
    arrs = [x, r, i, lv]
    if h0:
        arrs.append(rng.standard_normal((B, W), dtype=np.float32))
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(out, ref, tol=TOL):
    np.testing.assert_allclose(_np(out), _np(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("T,W", RG_CASES)
def test_plain_matches_jax_oracle(T, W):
    jx, tx = _inputs(T, W)
    h, fin = tref.rglru_reference(*tx)
    assert h.dtype == torch.float32 and h.shape == (2, T, W)
    _close(h, jscan(*jx))
    np.testing.assert_array_equal(_np(fin), _np(h[:, -1]))


@pytest.mark.parametrize("T,W", RG_CASES)
def test_wrapper_matches_jax_oracle(T, W):
    """The wrapper answers CPU tensors with the plain version, once."""
    jx, tx = _inputs(T, W, seed=1)
    before = trg.plain_calls
    out = trg.rglru(*tx)
    assert trg.plain_calls == before + 1
    assert out.dtype == torch.float32
    _close(out, jref(*jx))


@pytest.mark.parametrize("lam", ["test", "griffin"])
@pytest.mark.parametrize("T,W", RG_CASES[:2])
def test_init_and_final_state_match_jax(T, W, lam):
    """An initial state h0 and the final state, against
    ``_rglru_scan(h0=)``; with Griffin's lam h0 reaches every step."""
    jx, tx = _inputs(T, W, seed=2, h0=True, lam=lam)
    want = jscan(*jx[:4], h0=jx[4])
    h, fin = trg.rglru(*tx[:4], h0=tx[4], return_final_state=True)
    _close(h, want)
    _close(fin, want[:, -1])
    if lam == "griffin":   # long memory: h0 still shows at the last step
        cold = jscan(*jx[:4])
        assert float(jnp.abs(want[:, -1] - cold[:, -1]).max()) > 100 * TOL


# T either side of a segment's length and of one and two spans of the CUDA
# kernel's segmented scan (16 steps and 256 a span past T = 128), and
# across four spans: the plain version is what the kernel is held to there
@pytest.mark.parametrize("T", [1, 39, 100, 15, 16, 17, 255, 256, 257, 511,
                               512, 513, 1100])
def test_ragged_T_matches_jax(T):
    """Any T, with an initial state: the reference's scan at that T."""
    jx, tx = _inputs(T, 96, seed=3, h0=True, lam="griffin")
    want = jscan(*jx[:4], h0=jx[4])
    h, fin = trg.rglru(*tx[:4], h0=tx[4], return_final_state=True)
    assert h.shape == (2, T, 96)
    _close(h, want)
    _close(fin, want[:, -1])


def test_plain_matches_a_float64_step_loop():
    """The log-depth scan is the recurrence h_t = a_t h_{t-1} + b_t, step
    by step, to float32 rounding (a float64 loop on the same inputs)."""
    _, tx = _inputs(77, 64, seed=4, h0=True, lam="griffin")
    a, b = (t.double() for t in tref.rglru_coeffs(*tx[:4]))
    h, steps = tx[4].double(), []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        steps.append(h)
    got, fin = tref.rglru_reference(*tx[:4], h0=tx[4])
    _close(got, torch.stack(steps, dim=1), 1e-5)
    _close(fin, h, 1e-5)


@pytest.mark.parametrize("case", [RG_CASES[0], RG_CASES[2]],
                         ids=["128x128", "128x512"])
def test_wrapper_matches_interpreted_pallas_kernel(case):
    """The reference's TPU kernel, interpreted on the CPU, where it runs:
    no h0, T and W multiples of 128."""
    T, W = case
    jx, tx = _inputs(T, W, B=1, seed=5)
    assert jrg.supported(T, W)
    _close(trg.rglru(*tx), jrg.rglru(*jx))


def test_grad_matches_jax():
    """Gradients of the wrapper (backward through the plain version) equal
    ``jax.vjp`` of the reference oracle, for x, r, i and lam."""
    jx, tx = _inputs(64, 32, B=1, seed=6)
    g = np.random.default_rng(7).standard_normal((1, 64, 32),
                                                 dtype=np.float32)
    _, vjp = jax.vjp(jref, *jx)
    gj = vjp(jnp.asarray(g))
    tx = [t.requires_grad_() for t in tx]
    trg.rglru(*tx).backward(torch.from_numpy(g))
    for t, want in zip(tx, gj):
        _close(t.grad, want, 1e-3)


def test_grad_through_states_matches_jax():
    """With h0, a ragged T, Griffin's lam and the final state in the loss,
    every gradient (h0's too) equals the reference oracle's."""
    jx, tx = _inputs(45, 32, B=2, seed=8, h0=True, lam="griffin")

    def f(x, r, i, lam, h0):
        h = jscan(x, r, i, lam, h0=h0)
        return jnp.sum(h ** 2) + jnp.sum(jnp.sin(h[:, -1]))

    gj = jax.grad(f, argnums=tuple(range(5)))(*jx)
    tx = [t.requires_grad_() for t in tx]
    h, fin = trg.rglru(*tx[:4], h0=tx[4], return_final_state=True)
    (torch.sum(h ** 2) + torch.sum(torch.sin(fin))).backward()
    for t, want in zip(tx, gj):
        _close(t.grad, want, 1e-3)


def test_kernel_entry_refuses_cpu_tensors():
    """The launch function never falls back: CPU tensors are refused."""
    _, tx = _inputs(16, 32, B=1)
    before = trg.kernel_launches
    with pytest.raises(ValueError, match="CUDA"):
        trg.rglru_fwd(*tx)
    assert trg.kernel_launches == before


def test_launch_counter_loses_no_update_under_threads():
    """Prefill tasks call the wrapper from several EDAT worker threads at
    once; its counters must count every call."""
    import sys
    import threading
    _, tx = _inputs(8, 16, B=1)
    n_threads, n_calls = 16, 10
    before = trg.plain_calls
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            trg.rglru(*tx) for _ in range(n_calls)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert trg.plain_calls == before + n_threads * n_calls
