"""The port's flash attention against the JAX package's, on the same inputs.

On the CPU the port's wrapper answers with its plain version, so these
tests hold that plain version (and the autograd.Function around it) to the
reference: its oracle on every kernel test case, the Pallas kernel itself
in interpret mode on two cases, ragged tails the TPU kernel does not take,
and the gradient.  The CUDA kernel is held to the plain version by
``test_torch_kernels_gpu.py`` (skipped without a card) and by
``chip_smoke.py``.
"""
import re
from pathlib import Path

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
from repro_torch.configs import ARCHS, reduce_cfg            # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfa   # noqa: E402

DEEPSEEK = "deepseek-v3-671b"

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


def _inputs(S, H, KH, D, dtype, B=2, seed=0, Dv=None):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, h, d), dtype=np.float32)
            for h, d in ((H, D), (KH, D), (KH, Dv or D))]
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


# ------------------------------------------------- the kernel's two variants
def test_head_dim_pairs():
    """Both kernels are built for the equal widths the served and trained
    paths take and for MLA's q/k and v head dims: full-width deepseek-v3's
    (128 + 64, 128) and its reduced config's (32 + 16, 32)."""
    assert tfa.HEAD_DIM_PAIRS == ((32, 32), (64, 64), (128, 128), (256, 256),
                                  (192, 128), (48, 32))
    for cfg, want in ((ARCHS[DEEPSEEK].cfg, (192, 128)),
                      (reduce_cfg(ARCHS[DEEPSEEK].cfg), (48, 32))):
        m = cfg.mla
        assert (m.nope_dim + m.rope_dim, m.v_dim) == want


def test_head_dim_pairs_match_the_cuda_source():
    """HEAD_DIM_PAIRS is the pair table ``FA_PAIRS`` of the CUDA source
    instantiates both kernels from, pair for pair and in order: a pair
    added to one and not the other fails here, not first on the card."""
    src = (Path(tfa.__file__).resolve().parents[2] / "csrc"
           / "flash_attention_fwd.cu").read_text()
    table = re.search(r"#define FA_PAIRS\(X\)((?:[^\n]*\\\n)*[^\n]*)",
                      src).group(1)
    pairs = tuple((int(d), int(dv))
                  for d, dv in re.findall(r"X\((\d+),\s*(\d+)\)", table))
    assert pairs == tfa.HEAD_DIM_PAIRS


@pytest.mark.parametrize("dtype,D,Dv,aligned,want", [
    (torch.bfloat16, D, Dv, True, "mma_bf16")
    for D, Dv in tfa.HEAD_DIM_PAIRS] + [
    (torch.float32, 256, 256, True, "simt"),
    (torch.float32, 64, 64, True, "simt"),
    (torch.float32, 192, 128, True, "simt"),
    (torch.bfloat16, 256, 256, False, "simt"),
    (torch.bfloat16, 64, 64, False, "simt"),
    (torch.bfloat16, 192, 128, False, "simt"),
    (torch.bfloat16, 48, 48, True, "simt"),
    (torch.bfloat16, 192, 192, True, "simt"),
    (torch.bfloat16, 128, 192, True, "simt"),
])
def test_variant_rule(dtype, D, Dv, aligned, want):
    assert tfa.variant(dtype, D, Dv, aligned) == want


@pytest.mark.parametrize("D,Dv", [(48, 48), (192, 192), (128, 192),
                                  (256, 128), (96, 64)])
def test_unlisted_head_dim_pair_raises(D, Dv):
    """A (D, Dv) pair outside HEAD_DIM_PAIRS raises before any launch,
    whatever the device; a listed pair on the CPU is refused for its
    device."""
    q = torch.zeros(1, 2, 8, D, dtype=torch.bfloat16)
    v = torch.zeros(1, 2, 8, Dv, dtype=torch.bfloat16)
    before = dict(tfa.launches_by_variant)
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_attention_fwd(q, q, v, scale=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(q[..., :48], q[..., :48], v[..., :32],
                                scale=1.0)
    assert tfa.launches_by_variant == before


def test_aligned_reads_model_layout_views():
    """The model hands (B, S, H, D) tensors over as transposed views: their
    (b, h, s) strides are read, whatever the memory order."""
    for D, Dv in tfa.HEAD_DIM_PAIRS:
        x = torch.zeros(2, 17, 4, D, dtype=torch.bfloat16)
        view = x.transpose(1, 2)                 # (B, H, S, D), strided
        assert not view.is_contiguous() and tfa.aligned(view)
        assert tfa.variant(view.dtype, D, Dv,
                           tfa.aligned(view)) == "mma_bf16"
        # a head slice of a wider projection keeps 16-byte rows
        wide = torch.zeros(2, 17, 12, D, dtype=torch.bfloat16)
        assert tfa.aligned(wide[:, :, 4:8].transpose(1, 2))
    # rows of 68 bf16 values (136 bytes) are not 16-byte aligned
    padded = torch.zeros(1, 9, 2, 68, dtype=torch.bfloat16)[..., :64]
    assert not tfa.aligned(padded.transpose(1, 2))
    assert tfa.variant(torch.bfloat16, 64, 64,
                       tfa.aligned(padded.transpose(1, 2))) == "simt"
    # a pointer 2 bytes past a 16-byte boundary
    buf = torch.zeros(2 * 8 * 2 * 64 + 1, dtype=torch.bfloat16)
    shifted = buf[1:].view(2, 8, 2, 64).transpose(1, 2)
    assert not tfa.aligned(shifted)
    # float32 rows of 36 values (144 bytes) are aligned; the rule's dtype
    # still sends them to the SIMT kernel
    f32 = torch.zeros(1, 5, 2, 36).transpose(1, 2)
    assert tfa.aligned(f32) and tfa.variant(f32.dtype, 36, 36, True) == "simt"


def test_no_public_variant_keyword():
    """The variant follows from the inputs alone: neither public entry
    takes a keyword that names one."""
    import inspect
    for fn in (tfa.flash_attention_fwd, tfa.flash_attention):
        params = set(inspect.signature(fn).parameters)
        assert params == {"q", "k", "v", "scale", "causal", "window",
                          "softcap"} | ({"out"} if fn is
                                        tfa.flash_attention_fwd else set())


def test_reset_counts_clears_launches_by_variant():
    tfa._count("mma_bf16")
    tfa._count("simt")
    assert tfa.launches_by_variant["mma_bf16"] >= 1
    tfa.reset_counts()
    assert tfa.launches_by_variant == {"mma_bf16": 0, "simt": 0}
    assert tfa.kernel_launches == 0 and tfa.plain_calls == 0


def _mma_bf16_emulated(q, k, v, *, scale, window=None, softcap=None,
                       tile=64):
    """The tensor-core kernel's arithmetic in plain torch, q and k
    (B, H|KH, S, D), v (B, KH, S, Dv), bf16 in: 64-row q and kv tiles,
    float32 logits and running max m, p added into l in float32 and then
    rounded to bf16 for p.v, float32 accumulation, acc / max(l, 1e-30)
    rounded to bf16.  Dead tiles are skipped as the kernel skips them."""
    B, H, S, D = q.shape
    Dv = v.shape[-1]
    g = H // k.shape[1]
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    out = torch.empty((B, H, S, Dv), dtype=q.dtype)
    for q0 in range(0, S, tile):
        rows = torch.arange(q0, min(q0 + tile, S))
        qf = q[:, :, rows].float()
        m = torch.full((B, H, len(rows), 1), -1e30)
        l = torch.zeros((B, H, len(rows), 1))
        acc = torch.zeros((B, H, len(rows), Dv))
        kt_lo = max(0, q0 - window + 1) // tile if window else 0
        for k0 in range(kt_lo * tile, rows[-1].item() + 1, tile):
            keys = torch.arange(k0, min(k0 + tile, S))
            s = qf @ kf[:, :, keys].transpose(-1, -2) * scale
            if softcap is not None:
                s = torch.tanh(s / softcap) * softcap
            ok = keys[None, :] <= rows[:, None]
            if window is not None:
                ok &= (rows[:, None] - keys[None, :]) < window
            s = torch.where(ok, s, float("-inf"))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p.to(torch.bfloat16).float() @ vf[:, :, keys]
            m = m_new
        out[:, :, rows] = (acc / l.clamp_min(1e-30)).to(q.dtype)
    return out


# (S, H, KH, D, Dv, window, softcap): the bf16 kernel's tiles at every
# head dim pair, ragged tails, and the served and trained paths' shapes
# (gemma3-1b's H=4, KH=1, D=256, window 512 or none; recurrentgemma-9b's
# H=16, window 2048; granite-moe-1b-a400m's H=16, KH=8, D=64;
# deepseek-v3-671b's MLA, KH = H, D=192, Dv=128, and its reduced config's
# (48, 32)), cut to B=1 and fewer heads where large
EMU_CASES = [
    (1, 4, 1, 256, 256, 512, None), (17, 2, 1, 32, 32, None, None),
    (65, 4, 2, 64, 64, None, None), (100, 2, 1, 128, 128, None, None),
    (130, 2, 1, 256, 256, 64, 50.0), (511, 4, 1, 256, 256, 512, None),
    (511, 4, 1, 256, 256, None, None), (300, 16, 1, 256, 256, 2048, None),
    (300, 16, 8, 64, 64, None, None),
    (65, 4, 4, 48, 32, None, None), (100, 4, 4, 48, 32, None, None),
    (1, 8, 8, 192, 128, None, None), (130, 8, 8, 192, 128, None, None),
    (511, 8, 8, 192, 128, None, None),
]


@pytest.mark.parametrize("S,H,KH,D,Dv,window,softcap", EMU_CASES)
def test_mma_bf16_rounding_within_kernel_gate(S, H, KH, D, Dv, window,
                                              softcap):
    """The tensor-core kernel rounds p to bf16 before it is normalised
    (as the TPU kernel does), the plain version after: the emulated
    kernel must sit within the card's bf16 gate, 2e-2 * (1 + |plain|), of
    the reference's oracle on the same inputs, v at its own head dim."""
    (jq, jk, jv), _ = _inputs(S, H, KH, D, "bfloat16", B=1, seed=S + D,
                              Dv=Dv)
    kw = dict(scale=D ** -0.5, window=window, softcap=softcap)
    want = jref.attention_ref(*(jnp.swapaxes(t, 1, 2) for t in (jq, jk, jv)),
                              **kw)
    q, k, v = (torch.from_numpy(np.array(jnp.swapaxes(t, 1, 2)
                                         .astype(jnp.float32)))
               .to(torch.bfloat16) for t in (jq, jk, jv))
    got = _mma_bf16_emulated(q, k, v, **kw)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL["bfloat16"],
                               atol=TOL["bfloat16"])
