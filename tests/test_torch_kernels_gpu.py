"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and skip without one: a CUDA kernel has no
CPU mode.  They import no jax, so they run where the card is::

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as tfa   # noqa: E402

# (S, H, KH, D, window, softcap, dtype): the reference's FA_CASES, ragged
# tails, and the serving path's shapes (gemma3-1b: 4 heads, 1 KV head,
# head dim 256, window 512 on local layers)
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
    out = tfa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tfa.kernel_launches == before + 1
    ref = tfa.attention_ref(q, k, v, **kw)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.gpu
def test_flash_kernel_refuses_unsupported_head_dim(cuda):
    q = torch.zeros(1, 2, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention_fwd(q, q[:, :1].contiguous(),
                                q[:, :1].contiguous(), scale=1.0)
