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


# ---------------------------------------------- the tensor-core variant
# The CUDA kernel ``ssd_mma_bf16_kernel`` runs its four products on bf16
# tensor cores with float32 sums.  x, b and c are bf16 inputs, exact there;
# att, S_prev and w * x are float32, and each enters as hi = bf16(v) plus
# lo = bf16(v - hi).  _mma_emulation repeats that rounding in plain torch
# (bf16 products are exact in float32), so these tests hold the design's
# numerics to the kernel gate of chip_smoke.py (1e-4 * max|y|, and
# max|state|) here.  They check the rounding argument, not the kernel: what
# holds the kernel is the card-only test_ssd_mma_bf16_matches_plain in
# test_torch_kernels_gpu.py and chip_smoke.py's phase 8.
MMA_TOL = 1e-4


def _hilo(v, split):
    hi = v.bfloat16().float()
    return hi, ((v - hi).bfloat16().float() if split
                else torch.zeros_like(v))


def _mma_emulation(x, dt, a_log, b, c, *, chunk, init_state=None,
                   split=True):
    """(y, final state) as the tensor-core kernel rounds them: ``split``
    False rounds each float32 operand once to bf16 instead."""
    B, T, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    pad = (-T) % chunk
    x, b, c = (torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad))
               for t in (x, b, c))
    dt = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad))
    b, c = (torch.repeat_interleave(t, H // G, dim=2) for t in (b, c))
    A = -torch.exp(a_log.float())
    s = (init_state.float() if init_state is not None
         else torch.zeros((B, H, N, P)))
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    ys = []
    for t0 in range(0, T + pad, chunk):
        xc, bc, cc, dc = (t[:, t0:t0 + chunk] for t in (x, b, c, dt))
        cum = torch.cumsum(dc * A, dim=1)                      # (B, Q, H)
        g = torch.einsum("bihn,bjhn->bhij", cc, bc)
        seg = (cum[:, :, None, :] - cum[:, None, :, :]).permute(0, 3, 1, 2)
        att = torch.where(mask, g * torch.exp(torch.where(mask, seg, 0.0))
                          * dc.permute(0, 2, 1)[:, :, None, :], 0.0)
        y = sum(torch.einsum("bhij,bjhp->bihp", a, xc)
                for a in _hilo(att, split))
        inter = sum(torch.einsum("bihn,bhnp->bihp", cc, sp)
                    for sp in _hilo(s, split))
        ys.append(y + torch.exp(cum)[..., None] * inter)
        w = torch.exp(cum[:, -1:] - cum) * dc                  # (B, Q, H)
        s = torch.exp(cum[:, -1])[:, :, None, None] * s + sum(
            torch.einsum("bjhn,bjhp->bhnp", bc, wx)
            for wx in _hilo(w[..., None] * xc, split))
    return torch.cat(ys, dim=1)[:, :T], s


def _gate_ratio(out, ref):
    """max|out - ref| over the gate's limit MMA_TOL * max|ref|."""
    limit = MMA_TOL * max(1.0, float(ref.abs().max()))
    return float((out - ref).abs().max()) / limit


def _mma_inputs(T, H, G, N, P, *, init, dt_shift=0.0, seed=0, B=1):
    """numpy-seeded bf16 x, b, c, softplus dt (shifted by ``dt_shift``: at
    -4 dt ~ 0.02 and the state carries across chunks), a_log and an
    optional initial state."""
    rng = np.random.default_rng(seed)
    bf = lambda a: torch.from_numpy(a).bfloat16()             # noqa: E731
    x = bf(rng.standard_normal((B, T, H, P), dtype=np.float32))
    b = bf(rng.standard_normal((B, T, G, N), dtype=np.float32))
    c = bf(rng.standard_normal((B, T, G, N), dtype=np.float32))
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((B, T, H), dtype=np.float32)) + dt_shift)
    a_log = torch.from_numpy(rng.standard_normal(H, dtype=np.float32) * 0.5)
    s0 = (torch.from_numpy(rng.standard_normal((B, H, N, P),
                                               dtype=np.float32))
          if init else None)
    return x, dt, a_log, b, c, s0


# (T, H, G, N, P, chunk, init, dt_shift); the serving path's widths are
# N=128, P=64, chunk 128
MMA_CASES = [
    (1, 4, 1, 128, 64, 128, True, 0.0),
    (100, 4, 2, 64, 32, 64, False, 0.0),
    (100, 4, 1, 128, 64, 128, True, 0.0),
    (300, 4, 1, 128, 64, 128, True, 0.0),
    (300, 4, 1, 128, 64, 128, False, 0.0),
    (300, 4, 2, 32, 16, 64, True, 0.0),
    (300, 2, 2, 64, 64, 64, False, 0.0),
    (300, 4, 1, 128, 64, 128, True, -4.0),
]


@pytest.mark.parametrize("T,H,G,N,P,chunk,init,dt_shift", MMA_CASES)
def test_split_emulation_within_kernel_gate(T, H, G, N, P, chunk, init,
                                            dt_shift):
    """The hi/lo split keeps the tensor-core variant's y and final state
    within 1e-4 * max|.| of the plain version on the same bf16 inputs."""
    x, dt, a_log, b, c, s0 = _mma_inputs(T, H, G, N, P, init=init,
                                         dt_shift=dt_shift,
                                         seed=T + N + init)
    yr, fr = tref.ssd_padded_reference(x, dt, a_log, b, c, chunk=chunk,
                                       init_state=s0)
    ye, fe = _mma_emulation(x, dt, a_log, b, c, chunk=chunk, init_state=s0)
    assert ye.shape == yr.shape and fe.shape == fr.shape
    assert _gate_ratio(ye, yr) <= 1.0
    assert _gate_ratio(fe, fr) <= 1.0


@pytest.mark.parametrize("dt_shift", [0.0, -4.0])
def test_single_bf16_rounding_fails_kernel_gate(dt_shift):
    """The control: att, S_prev and w * x each rounded once to bf16 put y
    past the same gate at the serving widths (N=128, P=64, chunk 128), so
    the split is what keeps the kernel within it."""
    x, dt, a_log, b, c, s0 = _mma_inputs(300, 4, 1, 128, 64, init=True,
                                         dt_shift=dt_shift, seed=11)
    yr, _ = tref.ssd_padded_reference(x, dt, a_log, b, c, chunk=128,
                                      init_state=s0)
    ye, _ = _mma_emulation(x, dt, a_log, b, c, chunk=128, init_state=s0,
                           split=False)
    assert _gate_ratio(ye, yr) > 1.0


def _xbc_views(T, H, G, N, P, dtype, *, offset=0, extra=0):
    """x, b, c as views of one (1, T, offset + H*P + 2*G*N + extra)
    buffer, as the model slices its conv output."""
    width = offset + H * P + 2 * G * N + extra
    buf = torch.zeros((1, T, width), dtype=dtype)
    o = offset
    x = buf[..., o:o + H * P].reshape(1, T, H, P)
    b = buf[..., o + H * P:o + H * P + G * N].reshape(1, T, G, N)
    c = buf[..., o + H * P + G * N:o + H * P + 2 * G * N].reshape(1, T, G, N)
    return x, b, c


def test_variant_by_dtype_and_shape():
    """bf16 with N and P multiples of 16 and the chunk a multiple of 32 (the
    C entry's own rule) takes the tensor cores; float32, and other sizes,
    take the SIMT kernel."""
    assert tssd.variant(torch.bfloat16, 128, 64, 128, True) == "mma_bf16"
    assert tssd.variant(torch.bfloat16, 16, 16, 32, True) == "mma_bf16"
    assert tssd.variant(torch.float32, 128, 64, 128, True) == "simt"
    assert tssd.variant(torch.bfloat16, 24, 64, 128, True) == "simt"
    assert tssd.variant(torch.bfloat16, 128, 8, 128, True) == "simt"
    assert tssd.variant(torch.bfloat16, 128, 40, 128, True) == "simt"
    assert tssd.variant(torch.bfloat16, 128, 64, 24, True) == "simt"
    assert tssd.variant(torch.bfloat16, 128, 64, 96, True) == "mma_bf16"
    assert tssd.variant(torch.bfloat16, 128, 64, 48, True) == "simt"
    assert all(q % tssd.MMA_CHUNK_MULTIPLE == 0 for q in tssd.CHUNKS)
    assert tssd.variant(torch.bfloat16, 128, 64, 128, False) == "simt"


def test_variant_by_alignment_of_views():
    """The serving path's views of one (B, T, 2304) bf16 buffer are
    aligned; a view shifted by one element, or a row stride that is not a
    multiple of 16 bytes, is not, and takes the SIMT kernel."""
    x, b, c = _xbc_views(8, 32, 1, 128, 64, torch.bfloat16)
    assert x.stride(1) * 2 == 4608
    assert tssd.aligned(x, b, c)
    assert tssd.variant(x.dtype, 128, 64, 128,
                        tssd.aligned(x, b, c)) == "mma_bf16"
    x, b, c = _xbc_views(8, 32, 1, 128, 64, torch.bfloat16, offset=1)
    assert not tssd.aligned(x, b, c)
    assert not tssd.aligned(b) and not tssd.aligned(c)
    x, b, c = _xbc_views(8, 32, 1, 128, 64, torch.bfloat16, extra=4)
    assert x.data_ptr() % 16 == 0 and not tssd.aligned(x)
    assert tssd.variant(x.dtype, 128, 64, 128,
                        tssd.aligned(x, b, c)) == "simt"


def test_reset_counts_zeroes_every_variant():
    with tssd._count_lock:
        tssd.launches_by_variant["simt"] += 1
    tssd.reset_counts()
    assert tssd.launches_by_variant == {"mma_bf16": 0, "simt": 0}
    assert tssd.kernel_launches == 0 and tssd.plain_calls == 0
