"""The port's MLA mixer and MTP loss against the JAX package's, same inputs.

DeepSeek-V3's Multi-head Latent Attention at reduced deepseek-v3's widths
(d_model 128, 4 heads, q_lora 64, kv_lora 32, rope 16, nope 32, v 32, so
the flash kernel sees head dims (48, 32)): ``mla_apply`` without a cache
(training), at prefill into an empty cache and at a decode step, each
against the reference's; the kernel route of a fresh-cache prefill (K and V
materialised from the latent, the flash wrapper at D != Dv) against the
reference's absorbed form; the port's plain flash at (48, 32) and at
full-width MLA's (192, 128) against the JAX Pallas kernel run in interpret
mode; and the MTP loss term.  Inputs and weights are drawn with numpy from
a seed and written into both packages.
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
from repro.kernels.flash_attention import ops as jfa         # noqa: E402
from repro.models import attention as jattn                  # noqa: E402
from repro.models import build_model as jbuild               # noqa: E402
from repro_torch import bridge                               # noqa: E402
from repro_torch.configs import ARCHS, reduce_cfg            # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfa   # noqa: E402
from repro_torch.models import attention as tattn            # noqa: E402
from repro_torch.models import build_model                  # noqa: E402

ARCH = "deepseek-v3-671b"
# float32 on both sides, one layer: summation order only
TOL = 1e-5
# the flash tolerances of test_torch_flash_attention.py
FA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _cfgs():
    return reduce_cfg(ARCHS[ARCH].cfg), jreduce(JARCHS[ARCH].cfg)


def _weights(cfg, seed):
    """numpy weights of one MLA layer at each leaf's own fan-in (the norms
    drawn near 1, so that a swapped or dropped one shows)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in tattn.mla_specs(cfg).items():
        if spec.init == "ones":
            out[name] = 1 + 0.1 * rng.standard_normal(spec.shape)
        else:
            fan_in = (np.prod(spec.shape[:-1]) if name == "wo"
                      else spec.shape[0])
            out[name] = rng.standard_normal(spec.shape) / np.sqrt(fan_in)
    return {k: v.astype(np.float32) for k, v in out.items()}


def _both(w):
    return ({k: jnp.asarray(v) for k, v in w.items()},
            {k: torch.from_numpy(v) for k, v in w.items()})


def _close(got, want, tol=TOL, err_msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=err_msg)


def _cache_np(c):
    return {k: np.asarray(v) for k, v in c.items()}


@pytest.mark.parametrize("attn_impl", ["ref", "kernel"])
def test_mla_without_cache_matches_reference(attn_impl):
    """The training path (no cache): per-head K/V from the latent, causal
    attention through the flash wrapper (its plain version here) or the
    plain attention, against the reference's."""
    cfg, jcfg = _cfgs()
    cfg = cfg.replace(attn_impl=attn_impl)
    jp, tp = _both(_weights(cfg, 0))
    B, S = 2, 24
    x = np.random.default_rng(1).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want, _ = jattn.mla_apply(jp, jnp.asarray(x), cfg=jcfg,
                              positions=jnp.asarray(pos))
    before = tfa.plain_calls
    got, cache = tattn.mla_apply(tp, torch.from_numpy(x), cfg=cfg,
                                 positions=torch.from_numpy(pos.copy()))
    assert cache is None
    assert tfa.plain_calls == before + (attn_impl == "kernel")
    assert got.shape == (B, S, cfg.d_model)
    _close(got.detach(), want)


def test_mla_prefill_and_decode_with_cache_match_reference():
    """The plain path (``attn_impl="ref"``) with a cache: a prefill of 20
    tokens into an empty cache of 32 slots and two decode steps, each
    through the reference's absorbed form; outputs and the cache
    (``c_kv``, ``k_rope``, ``pos``) against the reference's."""
    cfg, jcfg = _cfgs()
    cfg = cfg.replace(attn_impl="ref")
    jp, tp = _both(_weights(cfg, 2))
    B, S, L = 2, 20, 32
    rng = np.random.default_rng(3)
    jcache = jattn.init_cache_pos(
        {k: jnp.zeros(s.shape, s.dtype or jnp.float32)
         for k, s in jattn.mla_cache_spec(jcfg, B, L).items()})
    tcache = tattn.init_cache_pos(
        {k: torch.zeros(s.shape, dtype=s.dtype or torch.float32)
         for k, s in tattn.mla_cache_spec(cfg, B, L).items()})
    for step, n in enumerate((S, 1, 1)):
        p0 = S + step - 1 if step else 0
        x = rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(p0, p0 + n, dtype=np.int32), (B, n))
        want, jcache = jattn.mla_apply(jp, jnp.asarray(x), cfg=jcfg,
                                       positions=jnp.asarray(pos),
                                       cache=jcache)
        with torch.inference_mode():
            got, tcache = tattn.mla_apply(
                tp, torch.from_numpy(x), cfg=cfg,
                positions=torch.from_numpy(pos.copy()), cache=tcache)
        _close(got, want, err_msg=f"call {step}")
        for k, v in _cache_np(jcache).items():
            _close(tcache[k].numpy(), v, err_msg=f"call {step}: {k}")


def test_mla_kernel_route_prefill_matches_absorbed_form():
    """A fresh-cache prefill under ``attn_impl="kernel"`` goes through the
    flash wrapper at head dims (nope + rope, v) = (48, 32): its output
    matches the reference's absorbed form over the same empty cache, and
    it writes the same cache."""
    cfg, jcfg = _cfgs()
    jp, tp = _both(_weights(cfg, 4))
    B, S, L = 2, 40, 48
    x = np.random.default_rng(5).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jcache = jattn.init_cache_pos(
        {k: jnp.zeros(s.shape, s.dtype or jnp.float32)
         for k, s in jattn.mla_cache_spec(jcfg, B, L).items()})
    want, jcache = jattn.mla_apply(jp, jnp.asarray(x), cfg=jcfg,
                                   positions=jnp.asarray(pos), cache=jcache)
    tcache = tattn.init_cache_pos(
        {k: torch.zeros(s.shape, dtype=s.dtype or torch.float32)
         for k, s in tattn.mla_cache_spec(cfg, B, L).items()})
    seen = []
    flash = tfa.flash_attention

    def recorded(q, k, v, **kw):
        seen.append((q.shape[-1], v.shape[-1]))
        return flash(q, k, v, **kw)
    tfa.flash_attention = recorded
    try:
        with torch.inference_mode():
            got, tcache = tattn.mla_apply(
                tp, torch.from_numpy(x), cfg=cfg.replace(attn_impl="kernel"),
                positions=torch.from_numpy(pos.copy()), cache=tcache,
                fresh_cache=True)
    finally:
        tfa.flash_attention = flash
    m = cfg.mla
    assert seen == [(m.nope_dim + m.rope_dim, m.v_dim)] == [(48, 32)]
    _close(got, want)
    for k, v in _cache_np(jcache).items():
        _close(tcache[k].numpy(), v, err_msg=k)


# (D, Dv, H, KH, S, dtype): reduced MLA's head dims and full-width MLA's,
# at the lengths the Pallas wrapper takes (S a multiple of min(128, S))
PAIR_CASES = [(D, Dv, H, KH, S, dt)
              for (D, Dv, H, KH) in ((48, 32, 4, 4), (192, 128, 2, 2))
              for S in (64, 128, 256)
              for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("D,Dv,H,KH,S,dtype", PAIR_CASES)
def test_plain_flash_at_mla_head_dims_matches_pallas_kernel(D, Dv, H, KH, S,
                                                           dtype):
    """The port's flash wrapper (its plain version on the CPU) at D != Dv
    against the JAX Pallas kernel in interpret mode on the same inputs:
    the output takes v's head dim."""
    rng = np.random.default_rng(S + D)
    arrs = [rng.standard_normal((1, S, h, d), dtype=np.float32)
            for h, d in ((H, D), (KH, D), (KH, Dv))]
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    want = jfa.flash_attention(*jx, scale=D ** -0.5)
    got = tfa.flash_attention(*tx, scale=D ** -0.5)
    assert got.shape == (1, S, H, Dv) and got.dtype == tx[0].dtype
    _close(got.float(), np.asarray(want.astype(jnp.float32)),
           tol=FA_TOL[dtype])


def test_flash_grad_at_mla_head_dims_matches_reference():
    """The wrapper's backward (a recompute of the plain version) at
    (48, 32): gradients of q, k and v, v's at its own head dim."""
    B, S, H, D, Dv = 1, 64, 4, 48, 32
    rng = np.random.default_rng(6)
    arrs = [rng.standard_normal((B, S, H, d), dtype=np.float32)
            for d in (D, D, Dv)]
    scale = D ** -0.5
    gj = jax.grad(lambda q, k, v: jnp.sum(
        jfa.flash_attention(q, k, v, scale=scale) ** 2),
        argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrs))
    tx = [torch.from_numpy(a).requires_grad_() for a in arrs]
    torch.sum(tfa.flash_attention(*tx, scale=scale) ** 2).backward()
    for a, b in zip(tx, gj):
        assert a.grad.shape == a.shape
        _close(a.grad, b, tol=1e-4)


def test_mtp_loss_matches_reference():
    """The MTP term alone (``_mtp_loss``) on the same trunk state, tokens
    and labels, with the reference's weights carried across: one layer of
    the last layer's kind (MLA and the MoE) over the trunk's state joined
    with the next token's embedding, scored two tokens ahead."""
    cfg, jcfg = _cfgs()
    jm = jbuild(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = bridge.params_from_jax_numpy(jax.tree.map(np.asarray, jparams),
                                      build_model(cfg), "cpu")
    rng = np.random.default_rng(7)
    B, S = 2, 24
    h = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    want = jm._mtp_loss(jparams, jnp.asarray(h), jnp.asarray(toks),
                        jnp.asarray(labels))
    with torch.no_grad():
        got = tm._mtp_loss(torch.from_numpy(h), torch.from_numpy(toks).long(),
                           torch.from_numpy(labels).long())
    assert np.isfinite(float(got))
    _close(float(got), float(want), tol=1e-4)
