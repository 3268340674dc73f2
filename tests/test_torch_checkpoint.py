"""Checkpoints cross between the port and the JAX package, both ways.

A checkpoint is ``step_N/arrays.npz`` + ``meta.msgpack`` + ``LATEST``.  The
tree is the ``TINY`` model's parameters (the reference's init) plus its
AdamW state after a few updates.  Values must come back bit for bit: a
checkpoint copies bytes, so the tolerance is 0.  The port writes
``meta.msgpack`` with its own codec, held byte-equal to ``msgpack.packb``.
"""
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import ml_dtypes                                             # noqa: E402
import msgpack                                               # noqa: E402
import numpy as np                                           # noqa: E402

from repro import checkpoint as jckpt                        # noqa: E402
from repro.models import ModelCfg as JModelCfg               # noqa: E402
from repro.models import build_model as jbuild               # noqa: E402
from repro.optim import OptCfg as JOptCfg                    # noqa: E402
from repro.optim import make_optimizer as jmake              # noqa: E402
from repro_torch import checkpoint as tckpt                  # noqa: E402
from repro_torch.checkpoint import store as tstore           # noqa: E402
from repro_torch.optim import OptCfg, make_optimizer         # noqa: E402
from repro_torch.tree import tree_map                       # noqa: E402

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=4, head_dim=16, d_ff=128, vocab=128,
            dtype="float32", remat="none", max_target_length=64)
OPT = dict(name="adamw", peak_lr=3e-2, warmup=5, total_steps=200,
           clip_norm=1.0)


@pytest.fixture(scope="module")
def jax_state():
    """TINY's params (the reference's init) and its AdamW state after 3
    updates, as host numpy trees."""
    params = jbuild(JModelCfg(**TINY)).init(jax.random.PRNGKey(0))
    opt = jmake(JOptCfg(**OPT))
    state = opt.init(params)
    rng = np.random.default_rng(0)
    for step in range(3):
        grads = jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32)), params)
        params, state, _ = opt.update(grads, state, params,
                                      jnp.asarray(step))
    return jax.tree.map(np.asarray, {"params": params, "opt": state})


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_equal(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}/{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                       b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=path)


def test_port_save_restores_in_the_reference(jax_state, tmp_path):
    d = str(tmp_path / "ck")
    tckpt.save(d, 7, _to_torch(jax_state), extra={"cursor": 3})
    assert jckpt.latest_step(d) == 7
    step, tree, extra = jckpt.restore(d, jax_state)
    assert step == 7 and extra == {"cursor": 3}
    _assert_equal(tree, jax_state)


def test_reference_save_restores_in_the_port(jax_state, tmp_path):
    d = str(tmp_path / "ck")
    jckpt.save(d, 4, jax_state, extra={"cursor": 9})
    jckpt.save(d, 8, jax_state)
    assert tckpt.latest_step(d) == 8
    proto = _to_torch(jax_state)
    step, tree, extra = tckpt.restore(d, proto, step=4)
    assert step == 4 and extra == {"cursor": 9}
    _assert_equal(tree, jax_state)
    # as the trainer installs them: tensors in the prototype's dtypes
    tens = tree_map(lambda a, p: tstore.to_tensor(a, "cpu", p.dtype), tree,
                    proto)
    _assert_equal(tree_map(lambda t: t.numpy(), tens), jax_state)


def test_port_state_saved_by_the_port_restores_in_the_reference(tmp_path):
    """The port's own AdamW state tree (not one converted from JAX) has
    the reference's paths: the reference restores it into its own
    prototype."""
    jparams = jbuild(JModelCfg(**TINY)).init(jax.random.PRNGKey(0))
    jstate = jmake(JOptCfg(**OPT)).init(jparams)
    tparams = _to_torch(jax.tree.map(np.asarray, jparams))
    tstate = make_optimizer(OptCfg(**OPT)).init(tparams)
    d = str(tmp_path / "ck")
    tckpt.save(d, 1, {"params": tparams, "opt": tstate})
    _, tree, _ = jckpt.restore(d, {"params": jparams, "opt": jstate})
    _assert_equal(tree, jax.tree.map(np.asarray,
                                     {"params": jparams, "opt": jstate}))


META = [
    {"step": 0, "extra": {}},
    {"step": 123456, "extra": {"cursor": 3, "name": "run", "lr": 3e-4}},
    {"step": 2 ** 40, "extra": {"neg": [-1, -33, -129, -40000, -2 ** 40],
                                "big": [200, 70000, 5_000_000_000],
                                "flags": [True, False, None],
                                "s": ["x" * 31, "x" * 32, "y" * 300,
                                      "z" * 70000, "é"],
                                "nested": {str(i): [i, float(i)]
                                           for i in range(20)},
                                "seq": list(range(20))}},
]


@pytest.mark.parametrize("meta", META, ids=range(len(META)))
def test_meta_codec_matches_msgpack(meta):
    packed = tstore.packb(meta)
    assert packed == msgpack.packb(meta)
    assert tstore.unpackb(packed) == msgpack.unpackb(packed)


def test_meta_codec_refuses_other_types():
    with pytest.raises(TypeError):
        tstore.packb({"a": np.zeros(3)})
    with pytest.raises(ValueError):
        tstore.unpackb(msgpack.packb(b"raw bytes"))


def test_bf16_leaf_round_trips_through_the_port(tmp_path):
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)
                         ).to(torch.bfloat16)
    d = str(tmp_path / "ck")
    tckpt.save(d, 2, {"w": w, "b": torch.zeros(3)})
    with np.load(os.path.join(d, "step_00000002", "arrays.npz")) as z:
        assert z["w"].dtype == np.dtype("V2")   # the reference's records
    _, tree, _ = tckpt.restore(d, {"w": w, "b": 0})
    assert tree["b"].dtype == np.float32
    back = tstore.to_tensor(tree["w"])
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), w.view(torch.int16))


def test_reference_bf16_checkpoint_restores_in_the_port(tmp_path):
    """The reference writes an ``ml_dtypes.bfloat16`` leaf as ``|V2``
    records and restores it so (its trainer's ``jnp.asarray`` then
    refuses it: ROADMAP Queue 3); the port reads the records as bf16."""
    rng = np.random.default_rng(4)
    w32 = rng.standard_normal((4, 6)).astype(np.float32)
    d = str(tmp_path / "ck")
    jckpt.save(d, 1, {"w": jnp.asarray(w32, jnp.bfloat16)})
    _, jtree, _ = jckpt.restore(d, {"w": 0})
    assert jtree["w"].dtype == np.dtype("V2")
    _, tree, _ = tckpt.restore(d, {"w": 0})
    got = tstore.to_tensor(tree["w"])
    want = w32.astype(ml_dtypes.bfloat16).astype(np.float32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_restore_without_checkpoint_raises(tmp_path):
    assert tckpt.latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        tckpt.restore(str(tmp_path), {"w": 0})
