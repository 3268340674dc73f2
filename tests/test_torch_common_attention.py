"""The port's shared numerics and GQA mixer against the JAX package's.

Inputs are made with numpy from a seed and fed to both packages in
float32; the attention weights are the same numpy arrays on both sides.
"""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs files in parallel workers, and
# oversubscribed cores starve the socket tests' heartbeat threads
torch.set_num_threads(1)

import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402

from repro.configs import ARCHS as JARCHS                    # noqa: E402
from repro.configs import reduce_cfg as jreduce              # noqa: E402
from repro.models import attention as jattn                  # noqa: E402
from repro.models import common as jcommon                   # noqa: E402
from repro_torch.configs import ARCHS, reduce_cfg            # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfa   # noqa: E402
from repro_torch.models import attention as tattn            # noqa: E402
from repro_torch.models import common as tcommon             # noqa: E402

# float32 against float32: the two frameworks differ only in summation
# order and in the last ulp of pow/cos/sin
TOL = 1e-5


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            .astype(np.float32) * scale)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a.detach() if hasattr(a, "detach")
                                          else a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm(plus_one):
    x, w = _rand(0, (2, 5, 64)), _rand(1, (64,), 0.1)
    _close(tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                            plus_one=plus_one),
           jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w),
                            plus_one=plus_one))


@pytest.mark.parametrize("fraction", [1.0, 0.25])
def test_rotary(fraction):
    x = _rand(2, (2, 40, 4, 32))
    pos = np.tile(np.arange(40, dtype=np.int32), (2, 1)) + 7
    _close(tcommon.rotary(torch.from_numpy(x), torch.from_numpy(pos),
                          theta=10000.0, fraction=fraction),
           jcommon.rotary(jnp.asarray(x), jnp.asarray(pos), theta=10000.0,
                          fraction=fraction))


def test_gelu_and_softcap():
    x = _rand(3, (4, 33), 3.0)
    _close(tcommon.gelu(torch.from_numpy(x)), jcommon.gelu(jnp.asarray(x)))
    _close(tcommon.softcap(torch.from_numpy(x), 2.5),
           jcommon.softcap(jnp.asarray(x), 2.5))
    assert tcommon.softcap(torch.from_numpy(x), None) is not None


# (spec, std): a stacked leaf (the init takes its fan-in from the layers
# axis), an embedding leaf (its own scale) and a zeros leaf (no draw)
INIT_LEAVES = {
    "stacked": (tcommon.P((4, 16, 8), ("layers", "embed", "mlp")),
                4 ** -0.5),
    "embed": (tcommon.P((64, 16), ("vocab", "embed_tbl"), "embed",
                        scale=16 ** -0.5), 16 ** -0.5),
    "zeros": (tcommon.P((8,), ("embed",), "zeros"), None),
}
_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


@pytest.mark.parametrize("kind", list(INIT_LEAVES))
def test_init_param_is_randn_times_std(kind):
    """``init_param`` scales its float32 draw in place: bit for bit
    ``torch.randn(shape, generator=g) * std`` from the same seed, cast to
    the model dtype (zeros for a zeros leaf)."""
    spec, std = INIT_LEAVES[kind]
    for dtype in _BITS:
        got = tcommon.init_param(spec, torch.Generator().manual_seed(3),
                                 dtype, "cpu")
        if std is None:
            want = torch.zeros(spec.shape, dtype=dtype)
        else:
            want = (torch.randn(spec.shape,
                                generator=torch.Generator().manual_seed(3))
                    * std).to(dtype)
        assert got.dtype == dtype and got.shape == spec.shape
        assert torch.equal(got.view(_BITS[dtype]), want.view(_BITS[dtype]))


def test_layer_norm():
    x, w, b = _rand(4, (3, 48)), _rand(5, (48,)), _rand(6, (48,))
    _close(tcommon.layer_norm(*map(torch.from_numpy, (x, w, b))),
           jcommon.layer_norm(*map(jnp.asarray, (x, w, b))))


def _gqa_setup(S):
    cfg = reduce_cfg(ARCHS["gemma3-1b"].cfg)
    jcfg = jreduce(JARCHS["gemma3-1b"].cfg)
    specs = tattn.gqa_specs(cfg)
    p = {k: _rand(10 + i, s.shape, 0.2) for i, (k, s) in
         enumerate(sorted(specs.items()))}
    x = _rand(30, (2, S, cfg.d_model))
    pos = np.tile(np.arange(S, dtype=np.int32), (2, 1))
    return cfg, jcfg, p, x, pos


@pytest.mark.parametrize("kind", ["local", "attn"])
def test_gqa_no_cache(kind):
    cfg, jcfg, p, x, pos = _gqa_setup(80)
    out, c = tattn.gqa_apply({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), cfg=cfg, kind=kind,
                             positions=torch.from_numpy(pos))
    ref, _ = jattn.gqa_apply({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), cfg=jcfg, kind=kind,
                             positions=jnp.asarray(pos))
    assert c is None
    _close(out, ref)


@pytest.mark.parametrize("kind", ["local", "attn"])
def test_gqa_fresh_cache_goes_through_flash(kind):
    """Prefill into an empty cache: the port attends through the flash
    wrapper and writes the same cache the reference writes."""
    cfg, jcfg, p, x, pos = _gqa_setup(40)
    L = 64
    jspec = jattn.gqa_cache_spec(jcfg, kind, 2, L)
    jcache = jattn.init_cache_pos(
        {k: jnp.zeros(s.shape, s.dtype or jnp.float32)
         for k, s in jspec.items()})
    tspec = tattn.gqa_cache_spec(cfg, kind, 2, L)
    tcache = tattn.init_cache_pos(
        {k: torch.zeros(s.shape, dtype=s.dtype or torch.float32)
         for k, s in tspec.items()})
    before = tfa.plain_calls
    out, tc = tattn.gqa_apply({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(x), cfg=cfg, kind=kind,
                              positions=torch.from_numpy(pos), cache=tcache,
                              fresh_cache=True)
    assert tfa.plain_calls == before + 1
    ref, jc = jattn.gqa_apply({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), cfg=jcfg, kind=kind,
                              positions=jnp.asarray(pos), cache=jcache)
    _close(out, ref)
    for key in ("k", "v", "pos"):
        _close(tc[key], jc[key])
    # the same step over the cache without the kernel route agrees too
    tcache2 = tattn.init_cache_pos({k: torch.zeros_like(v)
                                    for k, v in tc.items()})
    out2, _ = tattn.gqa_apply({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(x), cfg=cfg, kind=kind,
                              positions=torch.from_numpy(pos), cache=tcache2)
    _close(out2, ref)


def test_gqa_refuses_prompt_longer_than_cache():
    cfg, _, p, x, pos = _gqa_setup(40)
    spec = tattn.gqa_cache_spec(cfg, "local", 2, 32)
    cache = tattn.init_cache_pos(
        {k: torch.zeros(s.shape, dtype=s.dtype or torch.float32)
         for k, s in spec.items()})
    with pytest.raises(ValueError, match="do not fit"):
        tattn.gqa_apply({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), cfg=cfg, kind="local",
                        positions=torch.from_numpy(pos), cache=cache,
                        fresh_cache=True)
