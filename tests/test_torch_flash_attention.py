"""The port's flash attention against the JAX package's, on the same inputs.

On the CPU the port's wrapper answers with its plain version, so these
tests hold that plain version (and the autograd.Function around it) to the
reference: its oracle on every kernel test case, the Pallas kernel itself
in interpret mode on two cases, ragged tails the TPU kernel does not take,
and the gradient.  The CUDA kernel is held to the plain version by
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

from repro.kernels.flash_attention import ops as jfa         # noqa: E402
from repro.kernels.flash_attention import ref as jref        # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfa   # noqa: E402

# the reference's FA_CASES (tests/test_kernels.py): (S, H, KH, D, window,
# softcap, dtype name)
FA_CASES = [
    (256, 4, 4, 64, None, None, "float32"),
    (256, 4, 1, 64, None, None, "float32"),     # MQA
    (512, 8, 2, 64, None, None, "bfloat16"),    # GQA bf16
    (512, 4, 4, 128, 128, None, "float32"),     # sliding window
    (256, 4, 2, 128, None, 50.0, "float32"),    # softcap (gemma2)
    (384, 6, 6, 64, None, None, "float32"),     # non-128 block tail (S=384)
    (512, 2, 1, 256, 256, None, "bfloat16"),    # gemma3-like hd 256
]
# ragged tails the port's kernel takes and the TPU kernel does not
TAIL_CASES = [
    (100, 4, 2, 32, None, None, "float32"),
    (300, 4, 1, 32, 64, None, "float32"),
]
# fp32 agrees to rounding; bf16 inputs and p cast to bf16 before p.v
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(S, H, KH, D, dtype, B=2, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, h, D), dtype=np.float32)
            for h in (H, KH, KH)]
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("S,H,KH,D,window,softcap,dtype", FA_CASES)
def test_plain_matches_jax_oracle(S, H, KH, D, window, softcap, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(S, H, KH, D, dtype)
    kw = dict(scale=D ** -0.5, window=window, softcap=softcap)
    ref = jfa.attention_ref(jq, jk, jv, **kw)
    before = tfa.plain_calls
    out = tfa.flash_attention(q, k, v, **kw)
    assert tfa.plain_calls == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    np.testing.assert_allclose(_np(out), _np(ref), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("case", [FA_CASES[1], FA_CASES[6]],
                         ids=["mqa-fp32", "hd256-bf16"])
def test_plain_matches_interpreted_pallas_kernel(case):
    S, H, KH, D, window, softcap, dtype = case
    (jq, jk, jv), (q, k, v) = _inputs(S, H, KH, D, dtype, B=1, seed=1)
    kw = dict(scale=D ** -0.5, window=window, softcap=softcap)
    ref = jfa.flash_attention(jq, jk, jv, **kw)
    out = tfa.flash_attention(q, k, v, **kw)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("S,H,KH,D,window,softcap,dtype", TAIL_CASES)
def test_ragged_tails_match_jax_oracle(S, H, KH, D, window, softcap, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(S, H, KH, D, dtype, seed=2)
    kw = dict(scale=D ** -0.5, window=window, softcap=softcap)
    # the reference's oracle in its own (B, H, S, D) layout
    ref = jref.attention_ref(*(jnp.swapaxes(t, 1, 2) for t in (jq, jk, jv)),
                             **kw)
    out = tfa.flash_attention(q, k, v, **kw)
    np.testing.assert_allclose(_np(out.transpose(1, 2)), _np(ref),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_grad_matches_jax():
    B, S, H, KH, D = 1, 256, 2, 1, 64
    (jq, jk, jv), (q, k, v) = _inputs(S, H, KH, D, "float32", B=B, seed=3)
    scale = D ** -0.5
    gj = jax.grad(lambda q, k, v: jnp.sum(
        jfa.flash_attention(q, k, v, scale=scale) ** 2),
        argnums=(0, 1, 2))(jq, jk, jv)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    torch.sum(tfa.flash_attention(q, k, v, scale=scale) ** 2).backward()
    for a, b in zip((q.grad, k.grad, v.grad), gj):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-4)


def test_kernel_entry_refuses_cpu_tensors():
    """The launch function never falls back: CPU tensors are refused."""
    q = torch.zeros(1, 2, 8, 32)
    before = tfa.kernel_launches
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(q, q[:, :1], q[:, :1], scale=1.0)
    assert tfa.kernel_launches == before


def test_launch_counter_loses_no_update_under_threads():
    """Prefill tasks call the wrapper from several EDAT worker threads at
    once; its counters must count every call."""
    import sys
    import threading
    q = torch.zeros(1, 4, 2, 32)
    k = torch.zeros(1, 4, 1, 32)
    n_threads, n_calls = 16, 25
    before = tfa.plain_calls
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            tfa.flash_attention(q, k, k, scale=1.0) for _ in range(n_calls)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert tfa.plain_calls == before + n_threads * n_calls
