"""The port's SSD scan against the JAX package's, on the same inputs.

On the CPU the port's wrapper answers with its plain version, so these
tests hold that plain version (and the autograd.Function around it) to the
reference: its oracle on every kernel test case, with an initial and a
final state, at ragged T, the Pallas kernel itself in interpret mode on two
cases, and the gradient.  The CUDA kernel is held to the plain version by
``test_torch_kernels_gpu.py`` (skipped without a card) and by
``chip_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs files in parallel workers, and
# oversubscribed cores starve the socket tests' heartbeat threads
torch.set_num_threads(1)

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402

from repro.kernels.ssd import ops as jssd                    # noqa: E402
from repro.models.mamba2 import ssd_reference as jref        # noqa: E402
from repro_torch.kernels.ssd import ops as tssd              # noqa: E402
from repro_torch.kernels.ssd import ref as tref              # noqa: E402

# the reference's SSD_CASES (tests/test_kernels.py):
# (T, H, G, N, P, chunk, dtype name)
SSD_CASES = [
    (256, 4, 1, 32, 32, 64, "float32"),
    (256, 8, 2, 64, 64, 128, "float32"),
    (128, 2, 2, 16, 64, 32, "float32"),
    (256, 4, 1, 128, 64, 128, "bfloat16"),      # mamba2-370m shapes
]
# float32: summation order only; bf16: inputs rounded to bf16
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _close(out, ref, tol):
    """|out - ref| <= tol * (|ref| + max|ref|) elementwise.  A y element is
    a float32 sum of up to a chunk of products as large as ~50 that cancel
    to near 0 in places, so its rounding error scales with the output's
    magnitude, not its own: on SSD_CASES both packages' float32 oracles lie
    within 4.1e-6 * max|y| of a float64 evaluation, and differ from each
    other by up to 6e-6 * max|y| (1.06e-3 at max|y| = 177)."""
    out, ref = _np(out), _np(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol * scale)


def _inputs(T, H, G, N, P, dtype, B=2, seed=0, init=False):
    """numpy-seeded inputs as (jax arrays, torch tensors): x, b, c in
    ``dtype``; dt (softplus of a normal), a_log and init_state float32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H), dtype=np.float32)))
    a_log = rng.standard_normal(H, dtype=np.float32) * 0.5
    b = rng.standard_normal((B, T, G, N), dtype=np.float32)
    c = rng.standard_normal((B, T, G, N), dtype=np.float32)
    s0 = (rng.standard_normal((B, H, N, P), dtype=np.float32)
          if init else None)
    jx = [jnp.asarray(x).astype(getattr(jnp, dtype)), jnp.asarray(dt),
          jnp.asarray(a_log), jnp.asarray(b).astype(getattr(jnp, dtype)),
          jnp.asarray(c).astype(getattr(jnp, dtype))]
    tx = [torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(dt),
          torch.from_numpy(a_log), torch.from_numpy(b).to(getattr(torch, dtype)),
          torch.from_numpy(c).to(getattr(torch, dtype))]
    if init:
        return jx, tx, jnp.asarray(s0), torch.from_numpy(s0)
    return jx, tx


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("T,H,G,N,P,chunk,dtype", SSD_CASES)
def test_plain_matches_jax_oracle(T, H, G, N, P, chunk, dtype):
    """The port's ssd_reference against the reference's, same dtype in."""
    jx, tx = _inputs(T, H, G, N, P, dtype)
    ref = jref(*jx, chunk=chunk)
    out = tref.ssd_reference(*tx, chunk=chunk)
    assert out.dtype == torch.float32 and out.shape == (2, T, H, P)
    _close(out, ref, TOL["float32"])


@pytest.mark.parametrize("T,H,G,N,P,chunk,dtype", SSD_CASES)
def test_wrapper_matches_jax_oracle_in_float32(T, H, G, N, P, chunk, dtype):
    """As the reference's own kernel test: the wrapper on ``dtype`` inputs
    against the oracle on their float32 casts."""
    jx, tx = _inputs(T, H, G, N, P, dtype, seed=1)
    x, dt, a_log, b, c = jx
    ref = jref(x.astype(jnp.float32), dt, a_log, b.astype(jnp.float32),
               c.astype(jnp.float32), chunk=chunk)
    before = tssd.plain_calls
    out = tssd.ssd(*tx, chunk=chunk)
    assert tssd.plain_calls == before + 1
    assert out.dtype == torch.float32
    _close(out, ref, TOL[dtype])


@pytest.mark.parametrize("T,H,G,N,P,chunk,dtype",
                         [SSD_CASES[0], SSD_CASES[2], SSD_CASES[3]],
                         ids=["f32-g1", "f32-g2", "bf16-path"])
def test_init_and_final_state_match_jax(T, H, G, N, P, chunk, dtype):
    jx, tx, js0, ts0 = _inputs(T, H, G, N, P, dtype, seed=2, init=True)
    yj, sj = jref(*jx, chunk=chunk, init_state=js0, return_final_state=True)
    yt, st = tref.ssd_reference(*tx, chunk=chunk, init_state=ts0,
                                return_final_state=True)
    _close(yt, yj, TOL["float32"])
    _close(st, sj, TOL["float32"])
    yw, sw = tssd.ssd(*tx, chunk=chunk, init_state=ts0,
                      return_final_state=True)
    np.testing.assert_array_equal(_np(yw), _np(yt))
    np.testing.assert_array_equal(_np(sw), _np(st))


def test_chunk_invariance():
    """The chunked algorithm is exact: the chunk size cannot change y."""
    _, tx = _inputs(128, 2, 1, 16, 16, "float32", B=1, seed=3)
    y32 = tref.ssd_reference(*tx, chunk=32)
    y128 = tref.ssd_reference(*tx, chunk=128)
    _close(y32, y128, TOL["float32"])


@pytest.mark.parametrize("T", [1, 39, 70, 100])
def test_ragged_T_matches_jax_on_zero_padded_input(T):
    """At any T the wrapper equals the reference's scan of the zero-padded
    input (dt = 0 past T), outputs and final state, as mamba2 prefill pads
    it."""
    chunk = 32
    jx, tx, js0, ts0 = _inputs(T, 4, 2, 16, 16, "float32", seed=4,
                               init=True)
    pad = (-T) % chunk
    x, dt, a_log, b, c = jx
    padded = [jnp.pad(x, ((0, 0), (0, pad), (0, 0), (0, 0))),
              jnp.pad(dt, ((0, 0), (0, pad), (0, 0))), a_log,
              jnp.pad(b, ((0, 0), (0, pad), (0, 0), (0, 0))),
              jnp.pad(c, ((0, 0), (0, pad), (0, 0), (0, 0)))]
    yj, sj = jref(*padded, chunk=chunk, init_state=js0,
                  return_final_state=True)
    yt, st = tssd.ssd(*tx, chunk=chunk, init_state=ts0,
                      return_final_state=True)
    assert yt.shape == (2, T, 4, 16)
    _close(yt, yj[:, :T], TOL["float32"])
    _close(st, sj, TOL["float32"])


@pytest.mark.parametrize("case", [SSD_CASES[0], SSD_CASES[2]],
                         ids=["g1", "g2-heads"])
def test_wrapper_matches_interpreted_pallas_kernel(case):
    T, H, G, N, P, chunk, dtype = case
    jx, tx = _inputs(T, H, G, N, P, dtype, B=1, seed=5)
    ref = jssd.ssd(*jx, chunk=chunk)
    out = tssd.ssd(*tx, chunk=chunk)
    _close(out, ref, TOL[dtype])


def test_grad_matches_jax():
    """Gradients of the wrapper (backward through the plain version) equal
    the reference wrapper's (custom_vjp through its oracle), for every
    input."""
    B, T, H, G, N, P, chunk = 1, 64, 2, 1, 16, 16, 32
    jx, tx = _inputs(T, H, G, N, P, "float32", B=B, seed=6)
    gj = jax.grad(lambda *a: jnp.sum(jssd.ssd(*a, chunk=chunk) ** 2),
                  argnums=(0, 1, 2, 3, 4))(*jx)
    tx = [t.requires_grad_() for t in tx]
    torch.sum(tssd.ssd(*tx, chunk=chunk) ** 2).backward()
    for t, g in zip(tx, gj):
        _close(t.grad, g, 1e-3)


def test_grad_through_states_matches_jax():
    """With an initial state, a ragged T and the final state in the loss,
    the gradients (init_state's too) equal the reference oracle's on the
    zero-padded input."""
    T, chunk = 50, 32
    jx, tx, js0, ts0 = _inputs(T, 2, 1, 16, 16, "float32", B=1, seed=7,
                               init=True)
    pad = (-T) % chunk

    def f(x, dt, a_log, b, c, s0):
        p4 = ((0, 0), (0, pad), (0, 0), (0, 0))
        y, s = jref(jnp.pad(x, p4), jnp.pad(dt, ((0, 0), (0, pad), (0, 0))),
                    a_log, jnp.pad(b, p4), jnp.pad(c, p4), chunk=chunk,
                    init_state=s0, return_final_state=True)
        return jnp.sum(y[:, :T] ** 2) + jnp.sum(jnp.sin(s))

    gj = jax.grad(f, argnums=tuple(range(6)))(*jx, js0)
    ins = [t.requires_grad_() for t in tx + [ts0]]
    y, s = tssd.ssd(*ins[:5], chunk=chunk, init_state=ins[5],
                    return_final_state=True)
    (torch.sum(y ** 2) + torch.sum(torch.sin(s))).backward()
    for t, g in zip(ins, gj):
        _close(t.grad, g, 1e-3)


def test_kernel_entry_refuses_cpu_tensors():
    """The launch function never falls back: CPU tensors are refused."""
    _, tx = _inputs(32, 2, 1, 16, 16, "float32", B=1)
    before = tssd.kernel_launches
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_fwd(*tx, chunk=32)
    assert tssd.kernel_launches == before


def test_launch_counter_loses_no_update_under_threads():
    """Prefill tasks call the wrapper from several EDAT worker threads at
    once; its counters must count every call."""
    import sys
    import threading
    _, tx = _inputs(8, 2, 1, 8, 4, "float32", B=1)
    n_threads, n_calls = 16, 10
    before = tssd.plain_calls
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            tssd.ssd(*tx, chunk=32) for _ in range(n_calls)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert tssd.plain_calls == before + n_threads * n_calls
