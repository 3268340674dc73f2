"""The port's optimizers and schedules against the JAX package's.

The same numpy-seeded float32 parameters and gradients go through both
packages' ``make_optimizer(cfg).update`` for 20 steps.  Both compute every
update in float32 with the same cast points, so they differ only where a
transcendental (``pow``, ``sqrt``, ``rsqrt``, ``cos``) rounds its last bit
differently: params and states are held within 1e-6.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402

from repro.optim import OptCfg as JOptCfg                    # noqa: E402
from repro.optim import make_optimizer as jmake              # noqa: E402
from repro.optim import optimizers as jopt                   # noqa: E402
from repro.optim import schedules as jsched                  # noqa: E402
from repro_torch.optim import OptCfg, make_optimizer         # noqa: E402
from repro_torch.optim import optimizers as topt             # noqa: E402
from repro_torch.optim import schedules as tsched            # noqa: E402

TOL = 1e-6
STEPS = 20
# leaves of every rank the optimizers treat differently: a bias (no decay,
# Adafactor's unfactored v), a matrix, a stacked 3-D leaf (factored over
# its last two axes)
SHAPES = {"b": (16,), "w": (16, 24), "seg": {"wq": (3, 8, 12)}}
NAMES = ("adamw", "adamw8", "sgdm", "adafactor")


def _tree(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _assert_close(j, t, path=""):
    """A JAX tree against the port's tree of the same structure."""
    if isinstance(j, dict):
        assert sorted(j) == sorted(t), path
        for k in j:
            _assert_close(j[k], t[k], f"{path}/{k}")
        return
    a, b = np.asarray(j), t.cpu().numpy()
    assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
    np.testing.assert_allclose(b.astype(np.float64), a.astype(np.float64),
                               rtol=TOL, atol=TOL, err_msg=path)


def _cfg(name, **kw):
    base = dict(name=name, peak_lr=3e-2, warmup=5, total_steps=40,
                clip_norm=1.0)
    base.update(kw)
    return JOptCfg(**base), OptCfg(**base)


def _run(name, **kw):
    """Both optimizers through STEPS updates on identical grads; grads are
    large enough on odd steps that clipping engages."""
    jcfg, tcfg = _cfg(name, **kw)
    jo, to = jmake(jcfg), make_optimizer(tcfg)
    rng = np.random.default_rng(0)
    p0 = _tree(rng, SHAPES)
    jp = _map(jnp.asarray, p0)
    tp = _map(torch.from_numpy, p0)
    js, ts = jo.init(jp), to.init(tp)
    jupd = jax.jit(jo.update)
    norms = []
    for step in range(STEPS):
        g = _tree(rng, SHAPES, scale=0.3 if step % 2 else 0.01)
        jp, js, jm = jupd(_map(jnp.asarray, g), js, jp, jnp.asarray(step))
        tp, ts, tm = to.update(_map(torch.from_numpy, g), ts, tp, step)
        norms.append((float(jm["grad_norm"]), float(tm["grad_norm"]),
                      float(jm["lr"]), float(tm["lr"])))
    return (jp, js), (tp, ts), norms


@pytest.mark.parametrize("name", NAMES)
def test_twenty_updates_match(name):
    (jp, js), (tp, ts), norms = _run(name)
    _assert_close(jp, tp)
    _assert_close(js, ts)
    for jn, tn, jl, tl in norms:
        np.testing.assert_allclose(tn, jn, rtol=TOL)
        np.testing.assert_allclose(tl, jl, rtol=TOL)
    # clipping engaged on the large steps and not on the small ones
    assert any(n[0] > 1.0 for n in norms) and any(n[0] < 1.0 for n in norms)


def test_master_fp32_matches():
    (jp, js), (tp, ts), _ = _run("adamw", master_fp32=True)
    _assert_close(jp, tp)
    _assert_close(js, ts)
    assert "master" in ts["mu"]["w"]


def test_state_paths_match_the_reference():
    """The state trees have the reference's paths, so a checkpoint's
    paths match path for path."""
    rng = np.random.default_rng(1)
    p = _tree(rng, SHAPES)
    for name in NAMES:
        jcfg, tcfg = _cfg(name)
        js = jmake(jcfg).init(_map(jnp.asarray, p))
        ts = make_optimizer(tcfg).init(_map(torch.from_numpy, p))
        jpaths = [jax.tree_util.keystr(k) for k, _ in
                  jax.tree_util.tree_leaves_with_path(js)]
        tpaths = []

        def walk(t, pre):
            if isinstance(t, dict):
                for k in sorted(t):
                    walk(t[k], f"{pre}[{k!r}]")
            else:
                tpaths.append(pre)
        walk(ts, "")
        assert tpaths == jpaths, name


@pytest.mark.parametrize("warmup,total", [(5, 40), (1, 10), (100, 1000)])
def test_schedules_match(warmup, total):
    for step in range(0, total + 10):
        jc = jsched.cosine_schedule(jnp.asarray(step, jnp.int32), peak=3e-2,
                                    warmup=warmup, total=total)
        tc = tsched.cosine_schedule(step, peak=3e-2, warmup=warmup,
                                    total=total)
        jw = jsched.linear_warmup(jnp.asarray(step, jnp.int32), peak=3e-2,
                                  warmup=warmup)
        tw = tsched.linear_warmup(step, peak=3e-2, warmup=warmup)
        assert tc.dtype == torch.float32 and tw.dtype == torch.float32
        np.testing.assert_allclose(float(tc), float(jc), rtol=TOL)
        np.testing.assert_allclose(float(tw), float(jw), rtol=TOL)


def test_clipping_norm_matches():
    rng = np.random.default_rng(2)
    g = _tree(rng, SHAPES, scale=0.5)
    jcfg, tcfg = _cfg("adamw")
    jg, jn = jopt._clipped(jcfg, _map(jnp.asarray, g))
    tg, tn = topt._clipped(tcfg, _map(torch.from_numpy, g))
    np.testing.assert_allclose(float(tn), float(jn), rtol=TOL)
    assert float(tn) > 1.0
    _assert_close(jg, tg)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError):
        make_optimizer(OptCfg(name="lion"))
