"""Cell builder: (architecture x input shape x mesh) -> a step on meta
tensors.

The counterpart of ``repro.launch.cells``.  A *cell* packages the step
function, its abstract inputs (meta tensors: nothing is allocated) and the
spec trees of its inputs and outputs (``sharding.rules.PartitionSpec``
leaves, keyed by the reference's parameter paths) for one dry-run entry.
The rules are chosen by shape as the reference chooses them, the train
step's microbatches clamped to the data-parallel extent as there.

The port's kernels are calls into compiled CUDA that cannot take meta
tensors, so every cell sets ``attn_impl="ref"`` and records it in
``meta``: a cell runs, and counts, the plain path (masked attention tiles
included).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple, Union

import torch

from ..configs import ARCHS, SHAPES, ArchSpec, ShapeCfg
from ..models import build_model
from ..models.common import axes_tree
from ..optim import OptCfg, make_optimizer
from ..sharding import (PartitionSpec, fsdp_rules, mesh_axes, resolve,
                        serve_rules, sp_rules, tp_sp_rules, tree_shardings,
                        use_sharding)
from ..train.step import make_prefill_step, make_serve_step, make_train_step
from ..tree import tree_leaves

WHISPER_CROSS_LEN = 1500  # encoder frames for enc-dec decode cells
ATTN_IMPL = "ref"         # the plain path: the kernels take no meta tensor


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    fn: Callable
    args: Tuple[Any, ...]
    in_shardings: Any
    out_shardings: Any
    mesh: Any
    rules: dict
    meta: dict


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_abstract(spec: ArchSpec, shape: ShapeCfg):
    cfg = spec.cfg
    B, S = shape.global_batch, shape.seq
    batch = {}
    axes = {}
    if cfg.frontend == "vision":
        s_text = S - cfg.n_frontend_tokens
        batch["tokens"] = _meta((B, s_text), torch.int32)
        batch["labels"] = _meta((B, s_text), torch.int32)
        batch["patch_embeds"] = _meta((B, cfg.n_frontend_tokens,
                                       cfg.d_model), torch.float32)
        axes["patch_embeds"] = ("batch", "seq", "embed")
    elif cfg.frontend == "audio":
        batch["tokens"] = _meta((B, S), torch.int32)
        batch["labels"] = _meta((B, S), torch.int32)
        batch["frame_embeds"] = _meta((B, S, cfg.d_model), torch.float32)
        axes["frame_embeds"] = ("batch", "seq", "embed")
    else:
        batch["tokens"] = _meta((B, S), torch.int32)
        batch["labels"] = _meta((B, S), torch.int32)
    axes.setdefault("tokens", ("batch", "seq"))
    axes.setdefault("labels", ("batch", "seq"))
    return batch, axes


def opt_for(spec: ArchSpec) -> OptCfg:
    name = getattr(spec, "optimizer", None) or (
        "adamw8" if spec.published_params and spec.published_params > 1e11
        else "adamw")
    return OptCfg(name=name)


def build_cell(arch: str, shape_name: Union[str, ShapeCfg], mesh, *,
               rules: Optional[dict] = None,
               microbatches: Optional[int] = None,
               remat: Optional[str] = None,
               acc_dtype: str = "float32",
               optimizer: Optional[str] = None,
               rg_block_heads: Optional[int] = None,
               tp_sp: bool = False) -> Cell:
    """``shape_name``: a key of ``SHAPES``, or a ``ShapeCfg`` of one's own
    (a training run's batch and length, say)."""
    spec = ARCHS[arch]
    shape = (shape_name if isinstance(shape_name, ShapeCfg)
             else SHAPES[shape_name])
    sizes = mesh_axes(mesh)
    cfg = spec.cfg.replace(attn_impl=ATTN_IMPL)
    if rg_block_heads and cfg.rglru is not None:
        cfg = cfg.replace(rglru=dataclasses.replace(
            cfg.rglru, block_heads=rg_block_heads))
    if shape.kind == "decode":
        cfg = cfg.replace(max_target_length=max(shape.seq + 8,
                                                cfg.max_target_length))
    if remat is not None:
        cfg = cfg.replace(remat=remat)
    if shape.kind != "train":
        cfg = cfg.replace(remat="none")
    model = build_model(cfg)
    params_abs = model.abstract_params()
    params_axes = model.param_axes()

    if rules is None:
        if shape.name.startswith("long"):
            rules = sp_rules(serve_rules())
        elif shape.kind == "train":
            rules = tp_sp_rules() if tp_sp else fsdp_rules()
        elif shape.kind == "prefill":
            # prefill is compute-shaped like training: FSDP weight
            # gathers per layer beat replicated-weight serving rules
            rules = fsdp_rules()
        else:
            rules = serve_rules()
            # kv-heads that cannot split the model axis: shard the cache
            # *length* over 'model' instead (keeps the cache in HBM bounds)
            if (not cfg.encdec and cfg.mla is None and cfg.ssm is None
                    and cfg.n_kv_heads % sizes.get("model", 1) != 0):
                rules = dict(rules, cache="model", kv_heads=None)

    p_shard = tree_shardings(params_axes, params_abs, mesh, rules)
    meta = dict(kind=shape.kind, seq=shape.seq,
                global_batch=shape.global_batch,
                n_params=sum(x.numel() for x in tree_leaves(params_abs)),
                attn_impl=cfg.attn_impl)

    if shape.kind == "train":
        mb = microbatches
        if mb is None:
            mb = (spec.microbatches or {}).get(shape.name, 1)
            # never slice the per-microbatch batch below the
            # data-parallel extent, or the whole step replicates across
            # 'data'.  An explicit count overrides.
            dp = 1
            for ax in ("pod", "data"):
                dp *= sizes.get(ax, 1)
            while mb > 1 and shape.global_batch // mb < dp:
                mb //= 2
        ocfg = opt_for(spec)
        if optimizer:
            ocfg = OptCfg(name=optimizer)
        opt = make_optimizer(ocfg)
        opt_abs = opt.abstract_state(params_abs)
        opt_axes = opt.state_axes(params_axes)
        o_shard = tree_shardings(opt_axes, opt_abs, mesh, rules)
        batch_abs, batch_axes = _batch_abstract(spec, shape)
        b_shard = tree_shardings(batch_axes, batch_abs, mesh, rules)
        step_abs = _meta((), torch.int32)
        raw_step = make_train_step(model, opt, microbatches=mb,
                                   acc_dtype=getattr(torch, acc_dtype))

        def fn(params, opt_state, batch, step):
            with use_sharding(mesh, rules):
                return raw_step(params, opt_state, batch, step)

        repl = PartitionSpec()
        meta["microbatches"] = mb
        meta["optimizer"] = ocfg.name
        return Cell(arch, shape.name, fn,
                    (params_abs, opt_abs, batch_abs, step_abs),
                    (p_shard, o_shard, b_shard, repl),
                    (p_shard, o_shard, None), mesh, rules, meta)

    if shape.kind == "prefill":
        batch_abs, batch_axes = _batch_abstract(spec, shape)
        b_shard = tree_shardings(batch_axes, batch_abs, mesh, rules)
        batch_abs.pop("labels")
        b_shard.pop("labels")
        raw = make_prefill_step(model)

        def fn(params, batch):
            model.set_params(params)
            extra = {k: v for k, v in batch.items() if k != "tokens"}
            with use_sharding(mesh, rules), torch.no_grad():
                return raw(batch["tokens"], **extra)

        return Cell(arch, shape.name, fn, (params_abs, batch_abs),
                    (p_shard, b_shard), None, mesh, rules, meta)

    # decode: serve_step over a pre-existing cache of length seq
    B, S = shape.global_batch, shape.seq
    if cfg.encdec:
        cache_abs = (model.abstract_cache(B, S), _cross_kv_abstract(model, B))
        cache_axes = (axes_tree(model.cache_specs(B, S)),
                      _cross_kv_axes(model))
    else:
        cache_abs = model.abstract_cache(B, S)
        cache_axes = axes_tree(model.cache_specs(B, S))
    c_shard = tree_shardings(cache_axes, cache_abs, mesh, rules)
    tok_abs = _meta((B, 1), torch.int32)
    pos_abs = _meta((B, 1), torch.int32)
    t_shard = resolve((B, 1), ("batch", "seq"), mesh, rules)
    raw = make_serve_step(model)

    def fn(params, caches, tokens, pos):
        model.set_params(params)
        with use_sharding(mesh, rules), torch.no_grad():
            return raw(caches, tokens, pos)

    return Cell(arch, shape.name, fn,
                (params_abs, cache_abs, tok_abs, pos_abs),
                (p_shard, c_shard, t_shard, t_shard),
                (t_shard, c_shard), mesh, rules, meta)


def _cross_kv_abstract(model, B):
    cfg = model.cfg
    sh = (cfg.n_layers, B, WHISPER_CROSS_LEN, cfg.n_kv_heads, cfg.hd)
    return (_meta(sh, model.dtype), _meta(sh, model.dtype))


def _cross_kv_axes(model):
    ax = ("layers", "batch", "cache", "kv_heads", "head_dim")
    return (ax, ax)
