"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and skip without one: a CUDA kernel has no
CPU mode.  They import no jax, so they run where the card is::

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as tfa   # noqa: E402
from repro_torch.kernels.ssd import ops as tssd              # noqa: E402
from repro_torch.kernels.ssd import ref as tssd_ref          # noqa: E402

# (S, H, KH, D, window, softcap, dtype): the reference's FA_CASES, ragged
# tails, and the serving paths' shapes (gemma3-1b: 4 heads, 1 KV head,
# head dim 256, window 512 on local layers; granite-moe-1b-a400m: 16 heads,
# 8 KV heads of 64, no window)
CASES = [
    (256, 4, 4, 64, None, None, "float32"),
    (256, 4, 1, 64, None, None, "float32"),
    (512, 8, 2, 64, None, None, "bfloat16"),
    (512, 4, 4, 128, 128, None, "float32"),
    (256, 4, 2, 128, None, 50.0, "float32"),
    (384, 6, 6, 64, None, None, "float32"),
    (512, 2, 1, 256, 256, None, "bfloat16"),
    (100, 4, 2, 32, None, None, "float32"),
    (300, 4, 1, 32, 64, None, "float32"),
    (1, 4, 1, 256, 512, None, "bfloat16"),
    (511, 4, 1, 256, 512, None, "bfloat16"),
    (511, 4, 1, 256, None, None, "bfloat16"),
    (100, 16, 8, 64, None, None, "bfloat16"),
    (511, 16, 8, 64, None, None, "bfloat16"),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("S,H,KH,D,window,softcap,dtype", CASES)
def test_flash_kernel_matches_plain(cuda, S, H, KH, D, window, softcap,
                                    dtype):
    rng = np.random.default_rng(S * 7 + D)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, S, h, D),
                                                    dtype=np.float32))
               .to(device=cuda, dtype=getattr(torch, dtype))
               for h in (H, KH, KH))
    kw = dict(scale=D ** -0.5, window=window, softcap=softcap)
    before = tfa.kernel_launches
    by_variant = dict(tfa.launches_by_variant)
    out = tfa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tfa.kernel_launches == before + 1
    # bf16 takes the tensor-core kernel, float32 the SIMT one
    launched = "mma_bf16" if dtype == "bfloat16" else "simt"
    assert tfa.launches_by_variant == dict(
        by_variant, **{launched: by_variant[launched] + 1})
    ref = tfa.attention_ref(q, k, v, **kw)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])


# the tensor-core kernel at every head dim it takes, around its 16-row warp
# tiles and 64-row block tiles, with and without a window; softcap 50 at
# D=256 (gemma2's); and the SIMT kernel on the same bf16 inputs
MMA_S = (1, 15, 16, 17, 63, 64, 65, 100, 511)
MMA_CASES = ([(D, S, w, None) for D, Dv in tfa.HEAD_DIM_PAIRS if D == Dv
              for S in MMA_S for w in (512, None)]
             + [(256, S, None, 50.0) for S in MMA_S])


# gemma2-2b's prefill shape: B=1, 8 heads, 4 KV heads (GQA group 2), head
# dim 256, softcap 50; window 4096 on its local layers, none on its global
GEMMA2_CASES = [(S, w) for S in (1, 65, 100, 511) for w in (4096, None)]
# stablelm-1.6b's prefill shape: B=1, 32 heads, 32 KV heads (MHA: GQA
# group 1), head dim 64, no window, no softcap
STABLELM_CASES = (1, 65, 100, 511)
# starcoder2-15b's prefill shape: B=1, 48 heads, 4 KV heads (GQA group 12),
# head dim 128, no softcap; its window 4096 at the served lengths, 128 at
# S=511 (where the window masks keys at this shape), and 4096 at S=4608,
# where the window masks keys for the last 512 queries
STARCODER2_CASES = ([(S, 4096) for S in (1, 65, 100, 511)]
                    + [(511, 128), (4608, 4096)])
# MLA's head dims, v's its own: deepseek-v3-671b's prefill shape (B=1, 128
# heads, K and V per head, so KH = H, D=192, Dv=128, no window) and its
# reduced config's (4 heads, D=48, Dv=32, here with B=2 and a window too)
MLA_CASES = ([(1, 128, 128, 192, 128, None, S) for S in MMA_S]
             + [(2, 4, 4, 48, 32, w, S) for S in MMA_S for w in (64, None)])


@pytest.mark.gpu
@pytest.mark.parametrize("D,S,window,softcap", MMA_CASES)
def test_flash_variants_match_plain_on_bf16(cuda, D, S, window, softcap):
    _variants_match_plain(cuda, 2, S, 4, 2, D, window, softcap,
                          seed=S * 11 + D)


@pytest.mark.gpu
@pytest.mark.parametrize("S,window", GEMMA2_CASES)
def test_flash_variants_match_plain_at_gemma2_shape(cuda, S, window):
    _variants_match_plain(cuda, 1, S, 8, 4, 256, window, 50.0,
                          seed=S * 13 + 256)


@pytest.mark.gpu
@pytest.mark.parametrize("S", STABLELM_CASES)
def test_flash_variants_match_plain_at_stablelm_shape(cuda, S):
    _variants_match_plain(cuda, 1, S, 32, 32, 64, None, None,
                          seed=S * 17 + 64)


@pytest.mark.gpu
@pytest.mark.parametrize("S,window", STARCODER2_CASES)
def test_flash_variants_match_plain_at_starcoder2_shape(cuda, S, window):
    _variants_match_plain(cuda, 1, S, 48, 4, 128, window, None,
                          seed=S * 19 + 128)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,KH,D,Dv,window,S", MLA_CASES)
def test_flash_variants_match_plain_at_mla_head_dims(cuda, B, H, KH, D, Dv,
                                                     window, S):
    _variants_match_plain(cuda, B, S, H, KH, D, window, None,
                          seed=S * 23 + D, Dv=Dv)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,KH,D,Dv,window,S", [
    c for c in MLA_CASES if c[-1] in (1, 17, 100, 511)])
def test_flash_kernel_matches_plain_at_mla_head_dims_float32(
        cuda, B, H, KH, D, Dv, window, S):
    """float32 at MLA's head dims takes the SIMT kernel through the
    public wrapper, in the model's layout, within 2e-5 of the plain
    version; the output has v's head dim."""
    rng = np.random.default_rng(S * 29 + D)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, h, d),
                                                    dtype=np.float32))
               .to(cuda) for h, d in ((H, D), (KH, D), (KH, Dv)))
    kw = dict(scale=D ** -0.5, window=window)
    before = dict(tfa.launches_by_variant)
    out = tfa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tfa.launches_by_variant == dict(before,
                                           simt=before["simt"] + 1)
    assert out.shape == (B, S, H, Dv)
    np.testing.assert_allclose(out.cpu().numpy(),
                               tfa.attention_ref(q, k, v, **kw).cpu().numpy(),
                               rtol=TOL["float32"], atol=TOL["float32"])


def _variants_match_plain(cuda, B, S, H, KH, D, window, softcap, seed,
                          Dv=None):
    """Both flash variants through the private ``_launch`` on bf16 inputs
    in the model's layout (transposed views of (B, S, H, D), v's head dim
    Dv, D where None), each held to the plain version at the bf16
    tolerance."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, h, d),
                                                    dtype=np.float32))
               .to(device=cuda, dtype=torch.bfloat16).transpose(1, 2)
               for h, d in ((H, D), (KH, D), (KH, Dv or D)))
    kw = dict(scale=D ** -0.5, causal=True, window=window, softcap=softcap)
    ref = tfa.attention_ref(*(t.transpose(1, 2) for t in (q, k, v)),
                            **kw).transpose(1, 2).float().cpu().numpy()
    for kind in tfa.VARIANTS:
        before = dict(tfa.launches_by_variant)
        out = tfa._launch(kind, q, k, v, out=None, **kw)
        torch.cuda.synchronize()
        assert tfa.launches_by_variant[kind] == before[kind] + 1
        np.testing.assert_allclose(out.float().cpu().numpy(), ref,
                                   rtol=TOL["bfloat16"],
                                   atol=TOL["bfloat16"], err_msg=kind)


# whisper-tiny's encoder: not causal, B=1, 6 heads, 6 KV heads of 64, at
# 100, 1,500 (its frames; a ragged tail of 28 rows) and 4,096 tokens
NONCAUSAL_S = (100, 1500, 4096)


@pytest.mark.gpu
@pytest.mark.parametrize("S", NONCAUSAL_S)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_non_causal_matches_plain(cuda, S, dtype):
    """Non-causal calls at whisper's encoder shape, in the model's layout:
    bf16 through both variants (the private ``_launch``), float32 through
    the public wrapper (the SIMT kernel), each within its dtype's
    tolerance times max|plain| of the plain version with ``causal=False``
    (the outputs average over S keys, ~sqrt(e / S) in size), and each
    outside that limit of the plain version with a causal mask planted
    and of the one with the last key dropped."""
    rng = np.random.default_rng(S * 41)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, S, 6, 64),
                                                    dtype=np.float32))
               .to(device=cuda, dtype=getattr(torch, dtype))
               for _ in range(3))
    kw = dict(scale=64 ** -0.5, causal=False)
    want = tfa.attention_ref(q, k, v, **kw).float().cpu().numpy()
    qf, kf, vf = (t.float().cpu() for t in (q, k, v))
    dropped = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(
        torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, :-1]) * kw["scale"], -1),
        vf[:, :-1]).numpy()
    faults = (tfa.attention_ref(q, k, v, scale=kw["scale"],
                                causal=True).float().cpu().numpy(), dropped)
    tol = TOL[dtype]
    kinds = tfa.VARIANTS if dtype == "bfloat16" else ("simt",)
    for kind in kinds:
        before = dict(tfa.launches_by_variant)
        masks = dict(tfa.launches_by_mask)
        if dtype == "bfloat16":
            out = tfa._launch(kind, *(t.transpose(1, 2) for t in (q, k, v)),
                              window=None, softcap=None, out=None,
                              **kw).transpose(1, 2)
        else:
            out = tfa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert tfa.launches_by_variant[kind] == before[kind] + 1
        assert tfa.launches_by_mask == dict(
            masks, noncausal=masks["noncausal"] + 1)
        got = out.float().cpu().numpy()
        assert np.abs(got - want).max() <= tol * np.abs(want).max(), kind
        for fault in faults:
            assert np.abs(got - fault).max() > tol * np.abs(fault).max()


@pytest.mark.gpu
def test_flash_mma_refuses_float32_and_misaligned_rows(cuda):
    q = torch.zeros(1, 2, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="does not take"):
        tfa._launch("mma_bf16", q, q[:, :1], q[:, :1], scale=1.0,
                    causal=True, window=None, softcap=None, out=None)
    # rows of 68 bf16 values: not 16-byte aligned, so the SIMT kernel runs
    x = torch.zeros(1, 8, 2, 68, device=cuda, dtype=torch.bfloat16)
    qv = x[..., :64].transpose(1, 2)
    assert tfa.variant(qv.dtype, 64, 64, tfa.aligned(qv)) == "simt"
    before = dict(tfa.launches_by_variant)
    tfa.flash_attention_fwd(qv, qv[:, :1], qv[:, :1], scale=1.0)
    torch.cuda.synchronize()
    assert tfa.launches_by_variant["simt"] == before["simt"] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("D,Dv", [(48, 48), (192, 192), (128, 192),
                                  (256, 128)])
def test_flash_kernel_refuses_unsupported_head_dim(cuda, D, Dv):
    """A (D, Dv) pair outside HEAD_DIM_PAIRS raises on the card, in
    either dtype, and launches nothing."""
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros(1, 2, 8, D, device=cuda, dtype=dtype)
        v = torch.zeros(1, 1, 8, Dv, device=cuda, dtype=dtype)
        before = tfa.kernel_launches
        with pytest.raises(ValueError, match="head dim"):
            tfa.flash_attention_fwd(q, q[:, :1].contiguous(), v, scale=1.0)
        assert tfa.kernel_launches == before


# (B, T, H, G, N, P, chunk, dtype, init_state): the reference's SSD_CASES,
# ragged tails, an initial state, and the serving path's shapes
# (mamba2-370m prefill: B=1, 32 heads of 64, 1 group, state 128, chunk 128)
SSD_CASES = [
    (2, 256, 4, 1, 32, 32, 64, "float32", False),
    (2, 256, 8, 2, 64, 64, 128, "float32", False),
    (2, 128, 2, 2, 16, 64, 32, "float32", False),
    (2, 256, 4, 1, 128, 64, 128, "bfloat16", False),
    (2, 100, 4, 2, 32, 32, 128, "float32", True),
    (2, 300, 4, 2, 32, 32, 128, "float32", True),
    (1, 39, 8, 1, 16, 16, 32, "float32", True),
    (1, 100, 32, 1, 128, 64, 128, "bfloat16", True),
    (1, 511, 32, 1, 128, 64, 128, "bfloat16", False),
]
# bf16 inputs too: kernel and plain version read the same values and both
# compute in float32, so no bf16 rounding separates them
SSD_TOL = 1e-4


def _ssd_inputs(B, T, H, G, N, P, dtype, init, device):
    """numpy-seeded inputs; x, b and c are views of one (B, T, H*P + 2*G*N)
    buffer, as the model hands them over."""
    rng = np.random.default_rng(T * 31 + N)
    dt_ = getattr(torch, dtype)
    xbc = torch.from_numpy(rng.standard_normal(
        (B, T, H * P + 2 * G * N), dtype=np.float32)).to(device, dt_)
    x = xbc[..., :H * P].reshape(B, T, H, P)
    b = xbc[..., H * P:H * P + G * N].reshape(B, T, G, N)
    c = xbc[..., H * P + G * N:].reshape(B, T, G, N)
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal(
        (B, T, H), dtype=np.float32)))).to(device)
    a_log = torch.from_numpy(rng.standard_normal(H, dtype=np.float32)
                             * 0.5).to(device)
    s0 = (torch.from_numpy(rng.standard_normal((B, H, N, P),
                                                dtype=np.float32)).to(device)
          if init else None)
    return x, dt, a_log, b, c, s0


def _close_scaled(out, ref, tol):
    """Every element within tol * max|ref|: float32 sums of a chunk of
    products cancel in places, so their rounding scales with the output's
    largest magnitude."""
    out, ref = out.float().cpu().numpy(), ref.float().cpu().numpy()
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H,G,N,P,chunk,dtype,init", SSD_CASES)
def test_ssd_kernel_matches_plain(cuda, B, T, H, G, N, P, chunk, dtype,
                                  init):
    x, dt, a_log, b, c, s0 = _ssd_inputs(B, T, H, G, N, P, dtype, init,
                                         cuda)
    before = tssd.kernel_launches
    y, fin = tssd.ssd_fwd(x, dt, a_log, b, c, chunk=chunk, init_state=s0)
    torch.cuda.synchronize()
    assert tssd.kernel_launches == before + 1
    yr, fr = tssd_ref.ssd_padded_reference(x, dt, a_log, b, c, chunk=chunk,
                                           init_state=s0)
    assert y.dtype == torch.float32 and y.shape == (B, T, H, P)
    _close_scaled(y, yr, SSD_TOL)
    _close_scaled(fin, fr, SSD_TOL)


@pytest.mark.gpu
def test_ssd_kernel_matches_plain_long_memory(cuda):
    """The path shape with dt ~ 0.02: the state carries across chunks, so
    the initial state and the term between chunks reach every output."""
    x, dt, a_log, b, c, s0 = _ssd_inputs(1, 511, 32, 1, 128, 64, "bfloat16",
                                         True, cuda)
    dt = dt * 0.02
    y, fin = tssd.ssd_fwd(x, dt, a_log, b, c, chunk=128, init_state=s0)
    yr, fr = tssd_ref.ssd_padded_reference(x, dt, a_log, b, c, chunk=128,
                                           init_state=s0)
    _close_scaled(y, yr, SSD_TOL)
    _close_scaled(fin, fr, SSD_TOL)


@pytest.mark.gpu
def test_ssd_kernel_refuses_unsupported_shapes(cuda):
    x, dt, a_log, b, c, _ = _ssd_inputs(1, 64, 2, 1, 16, 16, "float32",
                                        False, cuda)
    with pytest.raises(ValueError, match="chunk"):
        tssd.ssd_fwd(x, dt, a_log, b, c, chunk=48)
    with pytest.raises(ValueError, match="head dim"):
        wide = torch.zeros(1, 64, 2, 72, device=cuda)
        tssd.ssd_fwd(wide, dt, a_log, b, c, chunk=32)


# the tensor-core variant on bf16 inputs, B=2: (T, H, G, N, P, chunk,
# init_state), covering T in {1, 17, 129, 511}, P in {16, 32, 64}, N in
# {16, 64, 128}, every chunk, one and two groups, with and without an
# initial state; held to the plain version at the same SSD_TOL
MMA_CASES = [
    (1, 4, 1, 128, 64, 128, True),
    (1, 2, 1, 64, 16, 32, False),
    (17, 4, 2, 16, 16, 32, False),
    (17, 2, 1, 64, 64, 64, True),
    (129, 4, 1, 64, 32, 64, True),
    (129, 4, 2, 128, 32, 96, False),
    (129, 2, 2, 16, 64, 128, True),
    (511, 4, 2, 128, 64, 128, False),
    (511, 2, 1, 64, 16, 96, True),
    (511, 4, 1, 16, 32, 32, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("T,H,G,N,P,chunk,init", MMA_CASES)
def test_ssd_mma_bf16_matches_plain(cuda, T, H, G, N, P, chunk, init):
    x, dt, a_log, b, c, s0 = _ssd_inputs(2, T, H, G, N, P, "bfloat16", init,
                                         cuda)
    assert tssd.variant(x.dtype, N, P, chunk,
                        tssd.aligned(x, b, c)) == "mma_bf16"
    before = tssd.launches_by_variant["mma_bf16"]
    y, fin = tssd.ssd_fwd(x, dt, a_log, b, c, chunk=chunk, init_state=s0)
    torch.cuda.synchronize()
    assert tssd.launches_by_variant["mma_bf16"] == before + 1
    yr, fr = tssd_ref.ssd_padded_reference(x, dt, a_log, b, c, chunk=chunk,
                                           init_state=s0)
    _close_scaled(y, yr, SSD_TOL)
    _close_scaled(fin, fr, SSD_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("T,H,G,N,P,chunk,init",
                         [MMA_CASES[0], MMA_CASES[5], MMA_CASES[7]])
def test_ssd_float32_launches_simt(cuda, T, H, G, N, P, chunk, init):
    x, dt, a_log, b, c, s0 = _ssd_inputs(2, T, H, G, N, P, "float32", init,
                                         cuda)
    before = dict(tssd.launches_by_variant)
    y, fin = tssd.ssd_fwd(x, dt, a_log, b, c, chunk=chunk, init_state=s0)
    torch.cuda.synchronize()
    assert tssd.launches_by_variant == dict(before,
                                            simt=before["simt"] + 1)
    yr, fr = tssd_ref.ssd_padded_reference(x, dt, a_log, b, c, chunk=chunk,
                                           init_state=s0)
    _close_scaled(y, yr, SSD_TOL)
    _close_scaled(fin, fr, SSD_TOL)


# the SSD gradient at the training path's shapes (mamba2-370m, B=2
# sequences a rank, 32 heads of 64, state 128, chunk 128, no initial
# state): the grads of sum(w * y), w seeded, through ``ops.ssd`` (the
# kernel forward, the plain scan recomputed under autograd in the
# backward) against the plain scan's own autograd.  Both get the same
# upstream w and run the same plain scan on the same inputs, so each grad
# equals its plain grad bit for bit: this holds the backward's wiring, not
# the kernel, whose output the grads never see


def _ssd_grads(scan, x, dt, a_log, b, c, w):
    ins = [t.detach().requires_grad_() for t in (x, dt, a_log, b, c)]
    return torch.autograd.grad((scan(*ins) * w).sum(), ins)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [512, 4096])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ssd_grad_through_kernel_matches_plain(cuda, T, dtype):
    x, dt, a_log, b, c, _ = _ssd_inputs(2, T, 32, 1, 128, 64, dtype, False,
                                        cuda)
    w = torch.from_numpy(np.random.default_rng(T).standard_normal(
        x.shape, dtype=np.float32)).to(cuda)
    variant = "mma_bf16" if dtype == "bfloat16" else "simt"
    before = (dict(tssd.launches_by_variant), tssd.backward_recomputes)
    got = _ssd_grads(lambda *a: tssd.ssd(*a, chunk=128), x, dt, a_log, b,
                     c, w)
    torch.cuda.synchronize()
    assert tssd.launches_by_variant == dict(
        before[0], **{variant: before[0][variant] + 1})
    assert tssd.backward_recomputes == before[1] + 1
    want = _ssd_grads(
        lambda *a: tssd_ref.ssd_padded_reference(*a, chunk=128)[0],
        x, dt, a_log, b, c, w)
    for name, g, e in zip(("x", "dt", "a_log", "b", "c"), got, want):
        assert g.dtype == e.dtype, name
        assert torch.equal(g, e), (name, float((g.float() - e.float())
                                               .abs().max()))


@pytest.mark.gpu
def test_ssd_named_variant(cuda):
    """``kernel="simt"`` runs the SIMT kernel on bf16 inputs the tensor
    cores would take; ``"mma_bf16"`` on float32 inputs raises."""
    x, dt, a_log, b, c, s0 = _ssd_inputs(1, 129, 4, 1, 64, 32, "bfloat16",
                                         True, cuda)
    before = tssd.launches_by_variant["simt"]
    y, fin = tssd.ssd_fwd(x, dt, a_log, b, c, chunk=64, init_state=s0,
                          kernel="simt")
    assert tssd.launches_by_variant["simt"] == before + 1
    yr, fr = tssd_ref.ssd_padded_reference(x, dt, a_log, b, c, chunk=64,
                                           init_state=s0)
    _close_scaled(y, yr, SSD_TOL)
    _close_scaled(fin, fr, SSD_TOL)
    with pytest.raises(ValueError, match="kernel"):
        tssd.ssd_fwd(x.float(), dt, a_log, b.float(), c.float(), chunk=64,
                     kernel="mma_bf16")

# (B, T, W, h0, lam): the reference's RG_CASES (drawn at B=2), ragged T,
# an initial state, and the serving path's shapes (recurrentgemma-9b
# prefill: B=1, width 4096); lam as the reference's kernel test draws it,
# or as Griffin's init does (long memory: a = exp(-8 softplus(lam)) in
# [0.9, 0.999]), under which h0 and every carry reach the last step
RG_CASES = [
    (2, 128, 128, False, "test"),
    (2, 256, 256, False, "test"),
    (2, 128, 512, False, "test"),
    (2, 512, 128, False, "test"),
    (2, 1, 96, True, "test"),
    (2, 39, 96, True, "griffin"),
    (2, 100, 200, True, "griffin"),
    (1, 100, 4096, True, "test"),
    (1, 511, 4096, True, "test"),
    (1, 511, 4096, True, "griffin"),
]
# the reference's RG-LRU tolerance: |kernel - plain| <= 2e-4 (1 + |plain|)
RG_TOL = 2e-4


def _rg_inputs(B, T, W, h0, lam, device):
    rng = np.random.default_rng(T * 13 + W)
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
    out = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
           for a in arrs]
    return out if h0 else out + [None]


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,W,h0,lam", RG_CASES)
def test_rglru_kernel_matches_plain(cuda, B, T, W, h0, lam):
    from repro_torch.kernels.rglru import ops as trg
    from repro_torch.kernels.rglru.ref import rglru_reference
    x, r, i, lv, s0 = _rg_inputs(B, T, W, h0, lam, cuda)
    before = trg.kernel_launches
    h, fin = trg.rglru_fwd(x, r, i, lv, h0=s0)
    torch.cuda.synchronize()
    assert trg.kernel_launches == before + 1
    hr, fr = rglru_reference(x, r, i, lv, h0=s0)
    assert h.dtype == torch.float32 and h.shape == (B, T, W)
    for got, want in ((h, hr), (fin, fr)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=RG_TOL, atol=RG_TOL)


# the segmented scan's boundaries: T either side of a segment's length L
# (8 steps where one span of 16 L covers T, else 16) and of one and two
# spans (128; 256, 512), and T = 1100 across four span boundaries; at a
# ragged width with strided inputs, h0 and long memory, and at one tile's
# width
RG_BOUNDARY_T = (7, 8, 9, 31, 32, 33, 127, 128, 129, 255, 256, 257, 511,
                 512, 513, 1100)
RG_BOUNDARY_SETS = [(100, True, "griffin", True), (32, False, "test", False)]


def _strided(t):
    """``t`` as a view of a larger NaN-filled tensor: its own batch and
    step strides and an offset, the last axis still unit-stride."""
    B, T, W = t.shape
    big = torch.full((B, T + 3, W + 7), float("nan"), device=t.device)
    big[:, 2:T + 2, 5:W + 5] = t
    return big[:, 2:T + 2, 5:W + 5]


@pytest.mark.gpu
@pytest.mark.parametrize("W,h0,lam,strided", RG_BOUNDARY_SETS,
                         ids=["W100-strided-h0-griffin", "W32"])
@pytest.mark.parametrize("T", RG_BOUNDARY_T)
def test_rglru_kernel_at_segment_and_span_boundaries(cuda, T, W, h0, lam,
                                                     strided):
    from repro_torch.kernels.rglru import ops as trg
    from repro_torch.kernels.rglru.ref import rglru_reference
    x, r, i, lv, s0 = _rg_inputs(2, T, W, h0, lam, cuda)
    if strided:
        x, r, i = (_strided(t) for t in (x, r, i))
        assert not x.is_contiguous()
    h, fin = trg.rglru_fwd(x, r, i, lv, h0=s0)
    torch.cuda.synchronize()
    hr, fr = rglru_reference(x, r, i, lv, h0=s0)
    for got, want in ((h, hr), (fin, fr)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=RG_TOL, atol=RG_TOL)
    # the composed carry after the last span is the last step's state
    assert torch.equal(fin, h[:, -1])


@pytest.mark.gpu
def test_rglru_launch_shape(cuda):
    """At the serving path's widest prefill the grid fills 128 SMs with
    16 warps each; L is 8 where one span of 16 L steps covers T, else 16."""
    from repro_torch.kernels.rglru import ops as trg
    assert trg.launch_shape(1, 511, 4096) == dict(
        blocks=128, threads_per_block=512, segment_steps=16, segments=16,
        spans=2)
    for T, L, spans in ((1, 8, 1), (128, 8, 1), (129, 16, 1), (256, 16, 1),
                        (257, 16, 2), (512, 16, 2), (513, 16, 3),
                        (1100, 16, 5)):
        shape = trg.launch_shape(2, T, 100)
        assert (shape["blocks"], shape["segment_steps"],
                shape["spans"]) == (8, L, spans)
    with pytest.raises(ValueError, match="not taken"):
        trg.launch_shape(1, 0, 4096)


@pytest.mark.gpu
def test_rglru_kernel_refuses_unsupported_inputs(cuda):
    from repro_torch.kernels.rglru import ops as trg
    x, r, i, lv, s0 = _rg_inputs(1, 16, 64, True, "test", cuda)
    with pytest.raises(TypeError, match="float32"):
        trg.rglru_fwd(x.bfloat16(), r, i, lv)
    with pytest.raises(ValueError, match="stride 1"):
        trg.rglru_fwd(x.transpose(1, 2), r.transpose(1, 2),
                      i.transpose(1, 2), torch.zeros(16, device=cuda))
    with pytest.raises(ValueError, match="h0"):
        trg.rglru_fwd(x, r, i, lv, h0=s0[:, :32])


# one event-driven training step at small depth: reduced gemma3-1b (6
# layers, head dim 32, window 64), float32, 2 ranks, sgdm; the kernel path
# against the plain path from the same seeded weights.  Only the attention
# forward differs (the kernel against the plain version, 2e-5 a case), so
# the losses and the updated weights agree to float32 rounding
TRAIN_TOL = 1e-5


@pytest.mark.gpu
def test_trainer_step_kernel_path_matches_plain(cuda):
    from repro_torch.configs import ARCHS, reduce_cfg
    from repro_torch.data import DataCfg
    from repro_torch.models import build_model
    from repro_torch.optim import OptCfg
    from repro_torch.runtime_dist import (EventDrivenTrainer, TrainerCfg,
                                          flatten_params)
    cfg = reduce_cfg(ARCHS["gemma3-1b"].cfg)
    data = DataCfg(vocab=cfg.vocab, seq=128, global_batch=4, seed=7)
    opt = OptCfg(name="sgdm", peak_lr=1e-2, warmup=1, total_steps=10)
    out = {}
    for impl in ("kernel", "ref"):
        tfa.reset_counts()
        tr = EventDrivenTrainer(build_model(cfg.replace(attn_impl=impl)),
                                data, opt, TrainerCfg(steps=1, n_ranks=2),
                                device=cuda)
        res = tr.run(timeout=120)
        torch.cuda.synchronize()
        out[impl] = (res, (tfa.kernel_launches, tfa.plain_calls,
                           tfa.backward_recomputes))
    (kres, kcounts), (rres, rcounts) = out["kernel"], out["ref"]
    n = cfg.n_layers * 2
    assert kcounts == (n, 0, n)
    assert rcounts == (0, 0, 0)
    kl = {(m["rank"], m["step"]): m["loss"] for m in kres["history"]}
    rl = {(m["rank"], m["step"]): m["loss"] for m in rres["history"]}
    assert sorted(kl) == sorted(rl) == [(0, 1), (1, 1)]
    for k in kl:
        np.testing.assert_allclose(kl[k], rl[k], rtol=TRAIN_TOL)
    kp = flatten_params(kres["final_params"][0])
    rp = flatten_params(rres["final_params"][0])
    for key in kp:
        np.testing.assert_allclose(kp[key], rp[key], rtol=TRAIN_TOL,
                                   atol=TRAIN_TOL, err_msg=key)
    for key, v in flatten_params(kres["final_params"][1]).items():
        np.testing.assert_array_equal(v, kp[key], err_msg=key)


def _granite_moe(dtype, device):
    """granite-moe-1b-a400m's MoE layer at full width (E=32, k=8, d_model
    1024, d_expert 512), seeded parameters on ``device``."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import moe
    from repro_torch.models.common import init_tree
    cfg = ARCHS["granite-moe-1b-a400m"].cfg.replace(dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    p = init_tree(moe.moe_specs(cfg), gen, getattr(torch, dtype), "cpu")
    return cfg, {k: v.to(device) for k, v in p.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("B,S", [(1, 511), (4, 1)], ids=["prefill",
                                                          "decode_b4"])
def test_moe_on_card_matches_cpu_and_repeats_bit_for_bit(cuda, B, S):
    """The MoE layer on the card at granite's width, at a prefill's and a
    4-slot decode step's T: float32 expert choices, dispatch table and
    kept mask equal the CPU's and the output agrees within 1e-5 of its
    scale; in bf16 two calls give the same bits (the combine adds in a
    fixed order, no atomics)."""
    from repro_torch.models import moe
    rng = np.random.default_rng(B * 1000 + S)
    x = torch.from_numpy(rng.standard_normal((B, S, 1024),
                                             dtype=np.float32))
    cfg, p = _granite_moe("float32", cuda)
    _, pc = _granite_moe("float32", "cpu")
    m = cfg.moe
    got = {}
    for dev, params in ((cuda, p), ("cpu", pc)):
        xd = x.to(dev)
        with torch.no_grad():
            w, gidx, _ = moe.route(params, xd.reshape(B * S, -1), cfg)
            C = moe.capacity(B * S, m.top_k, m.n_experts, m.capacity_factor)
            _, disp = moe.dispatch(xd.reshape(B * S, -1), gidx, w, C,
                                   m.n_experts)
            out, _ = moe.moe_apply(params, xd, cfg=cfg)
        got[str(dev)] = (gidx.cpu(), disp.table.cpu(), disp.keep.cpu(),
                         out.cpu())
    (g1, t1, k1, o1), (g2, t2, k2, o2) = got["cuda"], got["cpu"]
    assert torch.equal(g1, g2) and torch.equal(t1, t2)
    assert torch.equal(k1, k2)
    scale = max(1.0, float(o2.abs().max()))
    assert float((o1 - o2).abs().max()) <= 1e-5 * scale
    cfg16, p16 = _granite_moe("bfloat16", cuda)
    xb = x.to(cuda, torch.bfloat16)
    with torch.no_grad():
        a, _ = moe.moe_apply(p16, xb, cfg=cfg16)
        b, _ = moe.moe_apply(p16, xb, cfg=cfg16)
    torch.cuda.synchronize()
    assert torch.isfinite(a.float()).all()
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.gpu
def test_insitu_analytics_on_card(cuda):
    """The EDAT in-situ analytics program with every item's arithmetic on
    the card (n_analytics 2, 64 items of 4,096 float64 values a
    producer): every ``_analyse`` call on cuda, and the totals pass phase
    44's gate against the host's numpy recompute, which rejects both
    planted faults."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke
    from repro_torch.analytics import EdatAnalytics, InsituCfg, insitu
    cfg = InsituCfg(n_analytics=2, items_per_producer=64, field_elems=4096,
                    n_fields=2)
    insitu.reset_counts()
    prog = EdatAnalytics(cfg, device=cuda)
    res = prog.run()
    assert res["results"] == cfg.items_per_producer
    assert insitu.calls_by_device == {"cuda": 2 * cfg.items_per_producer}
    assert prog.summary["calls_by_device"] == insitu.calls_by_device
    got = [total for total, _ in prog.results]
    gates = {k: chip_smoke.insitu_gate(got, want)
             for k, want in chip_smoke.insitu_host_totals(cfg).items()}
    assert gates["control"]["ok"], gates["control"]
    for fault in chip_smoke.INSITU_FAULTS:
        assert not gates[fault]["ok"], (fault, gates[fault])
