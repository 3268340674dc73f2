"""The port's sharding rules (``repro_torch.sharding``) against the
reference's (``repro.sharding``).

The rule sets are compared dict for dict.  ``resolve`` is held to the
reference's, called on a ``jax.sharding.AbstractMesh`` of the same sizes
and names (it reads only ``shape`` and ``axis_names``, so no device is
needed), for every leaf of every arch's parameters, optimizer states and
caches, under every rule set the cell builder picks, on four meshes.
``placements`` and ``local_shape`` are held to DTensor's own split on a
(4, 4) ``DeviceMesh`` over a fake process group.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.optim import OptCfg as RefOptCfg  # noqa: E402
from repro.optim import make_optimizer as ref_make_optimizer  # noqa: E402
from repro.sharding import rules as R  # noqa: E402

from repro_torch.configs import ARCHS, reduce_cfg  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import axes_tree  # noqa: E402
from repro_torch.optim import OptCfg, make_optimizer  # noqa: E402
from repro_torch import sharding as S  # noqa: E402
from repro_torch.launch.cells import (_cross_kv_abstract,  # noqa: E402
                                      _cross_kv_axes)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x4": ((4, 4), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}


def _rule_sets(mod):
    """Every rule set ``build_cell`` picks (the reference's module or the
    port's)."""
    serve = mod.serve_rules()
    return {"long": mod.sp_rules(serve), "train": mod.fsdp_rules(),
            "train_tp_sp": mod.tp_sp_rules(), "decode": serve,
            "decode_cache_len": dict(serve, cache="model", kv_heads=None)}


def _leaves(shapes, axes):
    """(shape, axes) of each leaf: a tree of tensors beside its tree of
    axis tuples (dicts, lists, and tuples of trees)."""
    if isinstance(axes, tuple) and all(isinstance(a, (str, type(None)))
                                       for a in axes):
        return [(tuple(shapes.shape), axes)]
    if isinstance(axes, dict):
        return [x for k in axes for x in _leaves(shapes[k], axes[k])]
    return [x for s, a in zip(shapes, axes) for x in _leaves(s, a)]


def _arch_leaves(arch):
    """Every leaf the cells shard: parameters, each optimizer's state and
    the decode caches (an encoder-decoder's cross K/V too), with the
    trees' axes checked equal to the reference's first."""
    cfg = ARCHS[arch].cfg
    model = build_model(cfg)
    ref = ref_build_model(REF_ARCHS[arch].cfg)
    assert model.param_axes() == ref.param_axes()
    aparams, paxes = model.abstract_params(), model.param_axes()
    out = _leaves(aparams, paxes)
    for name in ("adamw", "adamw8", "adafactor", "sgdm"):
        opt = make_optimizer(OptCfg(name=name))
        st_axes = opt.state_axes(paxes)
        assert st_axes == ref_make_optimizer(RefOptCfg(name=name)).state_axes(
            ref.param_axes())
        out += _leaves(opt.abstract_state(aparams), st_axes)
    cache_axes = axes_tree(model.cache_specs(128, 32768))
    assert cache_axes == jax.tree.map(
        lambda s: s.axes, ref.cache_specs(128, 32768),
        is_leaf=lambda x: hasattr(x, "axes"))
    out += _leaves(model.abstract_cache(128, 32768), cache_axes)
    if cfg.encdec:
        out += _leaves(_cross_kv_abstract(model, 128), _cross_kv_axes(model))
    return out


@pytest.mark.parametrize("name", ["DEFAULT_RULES", "fsdp_rules", "sp_rules",
                                  "tp_sp_rules", "serve_rules",
                                  "with_updates"])
def test_rule_sets_equal_the_reference(name):
    if name == "DEFAULT_RULES":
        assert S.DEFAULT_RULES == R.DEFAULT_RULES
    elif name == "with_updates":
        assert (S.with_updates(S.DEFAULT_RULES, embed="model", seq="data")
                == R.with_updates(R.DEFAULT_RULES, embed="model",
                                  seq="data"))
        assert S.sp_rules(S.serve_rules()) == R.sp_rules(R.serve_rules())
    else:
        assert getattr(S, name)() == getattr(R, name)()
    assert _rule_sets(S) == _rule_sets(R)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_resolve_equals_the_reference_on_every_leaf(arch, mesh):
    dims, names = MESHES[mesh]
    port_mesh = S.MeshShape(dims, names)
    ref_mesh = AbstractMesh(dims, names)
    leaves = _arch_leaves(arch)
    assert len(leaves) > 10
    ours, theirs = _rule_sets(S), _rule_sets(R)
    for key in ours:
        for shape, axes in leaves:
            got = S.resolve(shape, axes, port_mesh, ours[key])
            want = R.resolve(shape, axes, ref_mesh, theirs[key])
            assert tuple(got) == tuple(want), (key, shape, axes)


# test_substrate.py's four resolve tests, each also on a mesh that splits
RESOLVE_CASES = {
    "divisibility_fallback": (((1,), ("model",)), (8, 64), ("heads", "embed"),
                              {}, (None, None)),
    "divisibility_fallback_4": (((4,), ("model",)), (6, 64),
                                ("heads", "mlp"), {}, (None, "model")),
    "conflict_drops_second": (((4,), ("model",)), (16, 16), ("embed", "mlp"),
                              dict(embed="model", mlp="model"),
                              ("model", None)),
    "never_overshards": (((4,), ("model",)), (9, 20), ("heads", "mlp"), {},
                         (None, "model")),
    "suffix_fallback": (((1, 1), ("data", "model")), (32, 8, 8),
                        ("expert", "embed", "moe_mlp"),
                        dict(expert=("data", "model")), (None, None, None)),
    "suffix_fallback_16x16": (((16, 16), ("data", "model")), (32, 8, 8),
                              ("expert", "embed", "moe_mlp"),
                              dict(expert=("data", "model")),
                              ("model", None, None)),
}


@pytest.mark.parametrize("case", sorted(RESOLVE_CASES))
def test_resolve_cases(case):
    (dims, names), shape, axes, upd, want = RESOLVE_CASES[case]
    got = S.resolve(shape, axes, S.MeshShape(dims, names),
                    dict(S.DEFAULT_RULES, **upd))
    ref = R.resolve(shape, axes, AbstractMesh(dims, names),
                    dict(R.DEFAULT_RULES, **upd))
    assert tuple(got) == want == tuple(ref)
    assert isinstance(got, S.PartitionSpec) and len(got) == len(shape)


def test_mesh_shape_and_mesh_axes():
    m = S.MeshShape((2, 16, 16))
    assert m.axis_names == ("pod", "data", "model")
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    assert (m.size, m.tag) == (512, "2x16x16")
    assert S.MeshShape((16, 16)).axis_names == ("data", "model")
    assert S.mesh_axes(AbstractMesh((4, 4), ("data", "model"))) == {
        "data": 4, "model": 4}
    with pytest.raises(ValueError):
        S.MeshShape((2, 2), ("data",))


@pytest.fixture(scope="module")
def fake_mesh():
    """A (4, 4) DeviceMesh over a fake 16-rank process group, rank 0."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
    try:
        yield init_device_mesh("cpu", (4, 4), mesh_dim_names=("data",
                                                              "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_placements_and_local_shape_match_dtensor(arch, fake_mesh):
    from torch.distributed.tensor import Shard, distribute_tensor
    model = build_model(reduce_cfg(ARCHS[arch].cfg))
    leaves = _leaves(model.abstract_params(), model.param_axes())
    rules = S.with_updates(S.fsdp_rules(), batch=("data", "model"))
    for shape, axes in leaves + [((16, 8), ("batch", "seq"))]:
        spec = S.resolve(shape, axes, fake_mesh, rules)
        assert spec == S.resolve(shape, axes, S.MeshShape((4, 4)), rules)
        pl = S.placements(spec, fake_mesh)
        t = distribute_tensor(torch.zeros(shape), fake_mesh, pl)
        assert tuple(t.to_local().shape) == S.local_shape(shape, spec,
                                                          fake_mesh)
        assert S.local_shape(shape, spec, fake_mesh) == S.local_shape(
            shape, spec, S.MeshShape((4, 4)))
    # a dimension over both mesh axes shards on both, in mesh order
    assert S.placements(S.PartitionSpec(("data", "model"), None),
                        fake_mesh) == (Shard(0), Shard(0))
    assert S.local_shape((32, 3), (("data", "model"), None),
                         fake_mesh) == (2, 3)
    with pytest.raises(ValueError):
        S.placements(S.PartitionSpec(("model", "data")), fake_mesh)


def test_constrain(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    x = torch.randn(8, 4, 16)
    axes = ("batch", "seq", "mlp")
    assert S.current() is None
    assert S.constrain(x, axes) is x
    with S.use_sharding(S.MeshShape((4, 4)), S.DEFAULT_RULES):
        assert S.current()[0] == S.MeshShape((4, 4))
        assert S.constrain(x, axes) is x
        meta = torch.empty(8, 4, 16, device="meta")
        assert S.constrain(meta, axes) is meta
    with S.use_sharding(fake_mesh, S.DEFAULT_RULES):
        assert S.constrain(x, axes) is x
        d = distribute_tensor(x, fake_mesh, (Replicate(), Replicate()))
        y = S.constrain(d, axes)
        assert y.placements == (Shard(0), Shard(2))
        assert tuple(y.to_local().shape) == (2, 4, 4)
    assert S.current() is None
    assert S.constrain(d, axes) is d
