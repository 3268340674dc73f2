"""Dry-run: build every (architecture x input shape) cell on the production
meshes, run its step on meta tensors, record memory and cost.

The counterpart of ``repro.launch.dryrun``.  No compiler runs and nothing
is allocated: a cell's step runs on meta tensors, so no XLA flag, no fake
devices and no subprocess are needed, and the mesh is a shape
(``launch.mesh.make_production_mesh``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all          # 16x16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \
      --shape train_4k

Results land in ``experiments/dryrun_torch/<mesh>/<arch>__<shape>.json``:

* ``meta`` (parameters, microbatches, kind, length, global batch, the
  attention route ``attn_impl``: always the plain path, "ref");
* ``params``: the parameter count against ``published_params``, its
  relative error gated by ``param_tolerance`` (a cell past it fails);
* ``memory.argument_size_in_bytes``: the local shard bytes (rank 0's) of
  every argument (parameters, optimizer state, batch or caches) under the
  cell's specs at the mesh.  The reference's output, temp and
  generated-code sizes come from its compiler and have no counterpart;
* ``analysis``: ``launch.cost.analyze`` of the step, counted over the
  whole step on every device (global), not per device as the reference's.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

from ..configs import ARCHS, SHAPES
from ..sharding import PartitionSpec, local_shape
from .cells import build_cell
from .cost import analyze
from .mesh import make_production_mesh


def argument_bytes(args, specs, mesh):
    """(bytes, tensors) of ``args``' local shards under the spec tree
    ``specs`` (its structure; ``PartitionSpec`` leaves) at ``mesh``."""
    if isinstance(specs, PartitionSpec):
        shard = local_shape(args.shape, specs, mesh)
        return math.prod(shard) * args.element_size(), 1
    if isinstance(specs, dict):
        pairs = [(args[k], s) for k, s in specs.items()]
    else:
        pairs = list(zip(args, specs))
    total = n = 0
    for a, s in pairs:
        b, k = argument_bytes(a, s, mesh)
        total, n = total + b, n + k
    return total, n


def run_cell(arch: str, shape: str, multi_pod: bool, outdir: str,
             verbose: bool = True, variant: str = "", mesh=None,
             **cell_kw) -> dict:
    """One cell's record; ``mesh`` overrides the production mesh."""
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    res = {"arch": arch, "shape": shape, "variant": variant,
           "mesh": mesh.tag, "n_devices": mesh.size,
           "cell_kw": repr(cell_kw)}
    t0 = time.time()
    try:
        cell = build_cell(arch, shape, mesh, **cell_kw)
        res["meta"] = dict(cell.meta)
        spec = ARCHS[arch]
        n = cell.meta["n_params"]
        rel = (abs(n - spec.published_params) / spec.published_params
               if spec.published_params else None)
        res["params"] = {"n_params": n,
                         "published_params": spec.published_params,
                         "rel_err": rel, "tolerance": spec.param_tolerance,
                         "ok": rel is None or rel < spec.param_tolerance}
        nbytes, ntensors = argument_bytes(cell.args, cell.in_shardings, mesh)
        res["memory"] = {"argument_size_in_bytes": nbytes,
                         "argument_tensors": ntensors}
        t1 = time.time()
        res["build_s"] = round(t1 - t0, 2)
        res["analysis"] = analyze(cell.fn, *cell.args)
        res["run_s"] = round(time.time() - t1, 2)
        res["ok"] = res["params"]["ok"]
        if not res["ok"]:
            res["error"] = (f"{n} parameters, {rel:.1%} from the published "
                            f"{spec.published_params:.3g}")
        if verbose:
            a = res["analysis"]
            print(f"  memory: {res['memory']}")
            print(f"  rollup (global): dot_flops={a['dot_flops']:.3e} "
                  f"flops={a['flops']:.3e} mem_bytes={a['mem_bytes']:.3e}")
    except Exception as e:  # noqa: BLE001 - recorded in the cell's JSON
        res["ok"] = False
        res["error"] = f"{type(e).__name__}: {e}"
        res["traceback"] = traceback.format_exc()[-4000:]
    res["total_s"] = round(time.time() - t0, 2)

    if outdir:
        os.makedirs(outdir, exist_ok=True)
        tag = f"__{variant}" if variant else ""
        path = os.path.join(outdir, f"{arch}__{shape}{tag}.json")
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
    return res


def iter_cells():
    for arch, spec in sorted(ARCHS.items()):
        for shape in SHAPES:
            if shape in spec.skip_shapes:
                continue
            yield arch, shape


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--outdir", default=None)
    # perf-iteration knobs; results tagged --variant
    ap.add_argument("--variant", default="")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--acc-dtype", default="float32")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--optimizer", default=None)
    ap.add_argument("--rg-blockheads", type=int, default=None)
    ap.add_argument("--tp-sp", action="store_true")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("--all, or --arch and --shape")

    mesh_tag = "pod2x16x16" if args.multi_pod else "pod16x16"
    outdir = args.outdir or os.path.join("experiments", "dryrun_torch",
                                         mesh_tag)
    cell_kw = dict(microbatches=args.microbatches,
                   acc_dtype=args.acc_dtype, remat=args.remat,
                   optimizer=args.optimizer,
                   rg_block_heads=args.rg_blockheads,
                   tp_sp=args.tp_sp)

    cells = list(iter_cells()) if args.all else [(args.arch, args.shape)]
    failures = 0
    for arch, shape in cells:
        print(f"[dryrun {mesh_tag}] {arch} x {shape} ...", flush=True)
        res = run_cell(arch, shape, args.multi_pod, outdir,
                       variant=args.variant, **cell_kw)
        status = "OK" if res["ok"] else f"FAIL: {res.get('error')}"
        print(f"[dryrun {mesh_tag}] {arch} x {shape}: {status} "
              f"({res['total_s']}s)", flush=True)
        failures += 0 if res["ok"] else 1
    print(f"[dryrun {mesh_tag}] done, {failures} failure(s) "
          f"of {len(cells)} cells")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
