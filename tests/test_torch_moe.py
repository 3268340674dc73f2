"""The port's MoE layer against the JAX package's, same weights and inputs.

Weights come from the reference's own init (``init_tree`` of its
``moe_specs``), inputs from numpy seeds.  The reference's expert choices,
dispatch table and kept mask are read off its own graph: its
``moe_apply`` is traced to a jaxpr and evaluated equation by equation,
keeping the outputs of its ``top_k``, of its integer scatter (the table,
before the drop bin is sliced off) and of its ``pos_in_e < C`` compare.
The port's must be equal; its output must agree within 1e-5 of the
output's largest magnitude (float32 sums of the expert products round at
the scale of their terms, and the reference's init makes outputs of ~30)
and its aux loss within 1e-6 (float32, summation order only).
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402

from repro.configs import ARCHS as JARCHS                    # noqa: E402
from repro.configs import reduce_cfg as jreduce              # noqa: E402
from repro.models import moe as jmoe                         # noqa: E402
from repro.models.common import init_tree as jinit_tree      # noqa: E402
from repro_torch import bridge                               # noqa: E402
from repro_torch.configs import ARCHS, reduce_cfg            # noqa: E402
from repro_torch.models import moe                           # noqa: E402

ARCH = "granite-moe-1b-a400m"
OUT_TOL = 1e-5
AUX_TOL = 1e-6
# bf16 outputs against the reference: both round the expert products, the
# activation and each add of the combine to bf16 (8 bits), at places that
# may differ by one rounding
BF16_TOL = 2e-2


def _cfgs(**moe_kw):
    jcfg, cfg = jreduce(JARCHS[ARCH].cfg), reduce_cfg(ARCHS[ARCH].cfg)
    if moe_kw:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe_kw))
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw))
    return jcfg, cfg


def _reference(p, x, cfg):
    """The reference's (out, aux) and its gidx, table and keep, read off
    its jaxpr (see the module docstring)."""
    closed = jax.make_jaxpr(functools.partial(jmoe.moe_apply, cfg=cfg))(p, x)
    jaxpr, env, seen = closed.jaxpr, {}, {}

    def read(v):
        return v.val if hasattr(v, "val") else env[v]

    for v, val in zip(jaxpr.constvars, closed.consts):
        env[v] = val
    for v, val in zip(jaxpr.invars, jax.tree.leaves((p, x))):
        env[v] = val
    for eqn in jaxpr.eqns:
        outs = eqn.primitive.bind(*map(read, eqn.invars), **eqn.params)
        if not eqn.primitive.multiple_results:
            outs = [outs]
        for v, o in zip(eqn.outvars, outs):
            env[v] = o
        name = eqn.primitive.name
        if name == "top_k":
            seen.setdefault("gidx", []).append(outs[1])
        elif name == "scatter" and outs[0].dtype == jnp.int32:
            seen.setdefault("table", []).append(outs[0])
        elif (name == "lt" and hasattr(eqn.invars[1], "val")
              and int(eqn.invars[1].val) != 0):   # 0: index normalising
            seen.setdefault("keep", []).append(outs[0])
    assert {k: len(v) for k, v in seen.items()} == {
        "gidx": 1, "table": 1, "keep": 1}, seen.keys()
    out, aux = (read(v) for v in jaxpr.outvars)
    table = np.asarray(seen["table"][0])[:-1]      # the drop bin sliced off
    return (np.asarray(out), float(aux), np.asarray(seen["gidx"][0]), table,
            np.asarray(seen["keep"][0]))


def _port(tp, xt, cfg):
    """The port's (out, aux, gidx, table, keep) through its steps; checks
    that its combine reads each token's slots in ascending order, as the
    table assigns them (E*C, the zero row, for a dropped assignment)."""
    m = cfg.moe
    T, d = xt.shape[0] * xt.shape[1], xt.shape[2]
    xf = xt.reshape(T, d)
    weights, gidx, _ = moe.route(tp, xf, cfg)
    C = moe.capacity(T, m.top_k, m.n_experts, m.capacity_factor)
    _, disp = moe.dispatch(xf, gidx, weights, C, m.n_experts)
    table = disp.table.numpy()
    want = np.full((T, m.top_k), m.n_experts * C)
    for t in range(T):
        mine = np.flatnonzero(table == t)
        want[t, :len(mine)] = mine
    np.testing.assert_array_equal(disp.token_slots.numpy(), want)
    out, aux = moe.moe_apply(tp, xt, cfg=cfg)
    return out, float(aux), gidx.numpy(), table, disp.keep.numpy()


def _inputs(jcfg, B, S, seed, dtype=jnp.float32, integer=False):
    """Reference params (its init) and x, as jax arrays and as tensors."""
    p = jinit_tree(jmoe.moe_specs(jcfg), jax.random.PRNGKey(seed), dtype)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    if integer:
        # integer logits, exact in any summation order: many exact ties
        x = rng.integers(-2, 3, size=x.shape).astype(np.float32)
        p = dict(p, router=jnp.asarray(rng.integers(
            -1, 2, size=p["router"].shape), dtype))
        x[:, :2] = 0.0        # every expert tied for these tokens
    if "router_bias" in p:
        p = dict(p, router_bias=jnp.asarray(
            rng.standard_normal(p["router_bias"].shape) * 0.5, jnp.float32))
    xj = jnp.asarray(x, dtype)
    tp = {k: bridge.tensor_from_numpy(np.asarray(v), "cpu")
          for k, v in p.items()}
    return p, xj, tp, bridge.tensor_from_numpy(np.asarray(xj), "cpu")


CASES = {
    # (moe overrides, B, S, integer inputs): reduced granite, E=8, k=2,
    # capacity 8 (no drops)
    "reduced": ({}, 2, 16, False),
    # full granite's routing (E=32, k=8, capacity 1.25) at a 4-slot decode
    # step and at T=64: both drop assignments, as every case at capacity
    # 1.25 here does
    "E32_k8_T4": (dict(n_experts=32, top_k=8, capacity_factor=1.25), 4, 1,
                  False),
    "E32_k8_T64": (dict(n_experts=32, top_k=8, capacity_factor=1.25), 2, 32,
                   False),
    # exact ties in the router: gidx must be lax.top_k's, ties to the
    # lower expert id
    "ties": (dict(n_experts=8, top_k=3, capacity_factor=1.25), 2, 16, True),
    # DeepSeek-V3's router: sigmoid affinities, a nonzero selection bias,
    # one shared expert
    "sigmoid_bias_shared": (dict(router_scale=True, n_shared=1,
                                 capacity_factor=1.25), 2, 16, False),
}



@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_matches_reference(case):
    over, B, S, integer = CASES[case]
    jcfg, cfg = _cfgs(**over)
    p, xj, tp, xt = _inputs(jcfg, B, S, seed=1, integer=integer)
    out_j, aux_j, gidx_j, table_j, keep_j = _reference(p, xj, jcfg)
    with torch.no_grad():
        out_t, aux_t, gidx_t, table_t, keep_t = _port(tp, xt, cfg)
    np.testing.assert_array_equal(gidx_t, gidx_j)
    np.testing.assert_array_equal(table_t, table_j)
    np.testing.assert_array_equal(keep_t, keep_j)
    assert keep_t.all() == (cfg.moe.capacity_factor == 8.0)   # drops
    if integer:
        assert (gidx_t[0] == np.arange(cfg.moe.top_k)).all()  # all tied
    err = float(np.abs(out_t.numpy() - out_j).max())
    assert err <= OUT_TOL * max(1.0, float(np.abs(out_j).max())), err
    assert abs(aux_t - aux_j) <= AUX_TOL


def test_moe_bf16_matches_reference_and_repeats_bit_for_bit():
    """bf16 at granite's routing with drops: the same choices, table and
    kept mask as the reference, the output within BF16_TOL of its scale,
    and two calls of the port give the same bits (the combine adds in a
    fixed order, no atomics)."""
    jcfg, cfg = _cfgs(n_experts=32, top_k=8, capacity_factor=1.25)
    cfg = cfg.replace(dtype="bfloat16")
    p, xj, tp, xt = _inputs(jcfg, 2, 32, seed=5, dtype=jnp.bfloat16)
    out_j, aux_j, gidx_j, table_j, keep_j = _reference(p, xj, jcfg)
    with torch.no_grad():
        out_t, aux_t, gidx_t, table_t, keep_t = _port(tp, xt, cfg)
        again, aux_again = moe.moe_apply(tp, xt, cfg=cfg)
    assert out_t.dtype == torch.bfloat16
    assert torch.equal(out_t.view(torch.int16), again.view(torch.int16))
    assert aux_t == float(aux_again)
    np.testing.assert_array_equal(gidx_t, gidx_j)
    np.testing.assert_array_equal(table_t, table_j)
    np.testing.assert_array_equal(keep_t, keep_j)
    assert not keep_t.all()
    scale = float(np.abs(out_j.astype(np.float32)).max())
    np.testing.assert_allclose(out_t.float().numpy(),
                               out_j.astype(np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL * scale)
    assert abs(aux_t - aux_j) <= AUX_TOL


def test_top_k_breaks_ties_to_the_lower_index():
    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0], [0.0, 0.0, 0.0, 0.0, 0.0]],
                 np.float32)
    vals, idx = moe.top_k(torch.from_numpy(x), 3)
    jvals, jidx = jax.lax.top_k(jnp.asarray(x), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_specs_match_reference():
    """Paths, shapes and scales of every variant's leaves."""
    for over in (c[0] for c in CASES.values()):
        jcfg, cfg = _cfgs(**over)
        js, ts = jmoe.moe_specs(jcfg), moe.moe_specs(cfg)
        assert sorted(js) == sorted(ts)
        for k in js:
            assert (ts[k].shape, ts[k].axes, ts[k].init, ts[k].scale) == (
                js[k].shape, js[k].axes, js[k].init, js[k].scale), k


def test_combine_adds_in_ascending_slot_order():
    """A token's contributions are added one at a time in slot order, in
    the expert output's dtype: bf16 rounds after each add."""
    E, C, d = 3, 2, 1
    ye = torch.tensor([[[1.0], [0.0]], [[2.0 ** -8], [0.0]],
                       [[2.0 ** -8], [0.0]]], dtype=torch.bfloat16)
    # token 0 holds slots 0, 2 and 4 (experts 0, 1, 2), weight 1 each
    disp = moe.Dispatch(table=torch.tensor([0, 1, 0, 1, 0, 1]),
                        weights=torch.tensor([1.0, 0, 1.0, 0, 1.0, 0]),
                        keep=torch.ones(3, dtype=torch.bool),
                        token_slots=torch.tensor([[0, 2, 4]]))
    out = moe.combine(ye, disp)
    # ((1 + 2^-8) + 2^-8) in bf16: each add rounds back to 1
    assert out.dtype == torch.bfloat16 and float(out[0, 0]) == 1.0
