"""The port stands alone: importing any of it loads neither jax nor the
JAX package, and its entry points never carry on on the CPU unasked."""
import os
import subprocess
import sys
import warnings

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analytics import (BespokeAnalytics,         # noqa: E402
                                   EdatAnalytics, InsituCfg,
                                   distributed_insitu, insitu_program)
from repro_torch.configs import ARCHS, reduce_cfg            # noqa: E402
from repro_torch.data import DataCfg                         # noqa: E402
from repro_torch.models import build_model                   # noqa: E402
from repro_torch.net.launch import ProcessGroup              # noqa: E402
from repro_torch.optim import OptCfg                         # noqa: E402
from repro_torch.runtime_dist import trainer as rtrainer     # noqa: E402
from repro_torch.serve import (LoadSpec, SequentialEngine,   # noqa: E402
                               ServeEngine, run_sequential, run_serve,
                               serve_program)

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")

_CHECK = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
assert not bad, bad
for name in ("repro_torch.models.mamba2", "repro_torch.models.moe",
             "repro_torch.kernels.ssd.ops",
             "repro_torch.kernels.ssd.ref", "repro_torch.models.rglru",
             "repro_torch.kernels.rglru.ops",
             "repro_torch.kernels.rglru.ref", "repro_torch.net",
             "repro_torch.net.frames", "repro_torch.net.socket_transport",
             "repro_torch.net.bootstrap", "repro_torch.net.launch",
             "repro_torch.data", "repro_torch.data.synthetic",
             "repro_torch.optim", "repro_torch.optim.optimizers",
             "repro_torch.optim.schedules", "repro_torch.checkpoint",
             "repro_torch.checkpoint.store", "repro_torch.runtime_dist",
             "repro_torch.runtime_dist.trainer", "repro_torch.train.step",
             "repro_torch.tree", "repro_torch.analytics",
             "repro_torch.analytics.insitu", "repro_torch.insights",
             "repro_torch.configs.edat_paper", "repro_torch.core.device"):
    assert name in names, name
"""


def test_importing_every_module_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _CHECK], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    # configs, runtime, net, models, kernels, serve, data, optim,
    # checkpoint, train, runtime_dist, analytics, insights
    assert n_modules >= 57


CFG = reduce_cfg(ARCHS["gemma3-1b"].cfg)
DATA = DataCfg(vocab=CFG.vocab, seq=16, global_batch=2)
TRAINER = rtrainer.TrainerCfg(steps=1)


def _deprecated(fn):
    """Call a deprecated v1 helper (its warning is not under test)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn()

ENTRY_POINTS = {
    "ServeEngine": lambda: ServeEngine(CFG, slots=1),
    "SequentialEngine": lambda: SequentialEngine(CFG),
    "serve_program": lambda: serve_program("gemma3-1b"),
    "run_serve": lambda: run_serve(load=LoadSpec(requests=1)),
    "run_serve_socket": lambda: run_serve(transport="socket", procs=2,
                                          load=LoadSpec(requests=1)),
    "run_serve_mamba2": lambda: run_serve(arch="mamba2-370m", reduced=False,
                                          load=LoadSpec(requests=1)),
    "run_serve_recurrentgemma": lambda: run_serve(
        arch="recurrentgemma-9b", reduced=False, load=LoadSpec(requests=1)),
    "run_serve_granite": lambda: run_serve(
        arch="granite-moe-1b-a400m", reduced=False,
        load=LoadSpec(requests=1)),
    "run_sequential": lambda: run_sequential(CFG, []),
    "EventDrivenTrainer": lambda: rtrainer.EventDrivenTrainer(
        build_model(CFG), DATA, OptCfg(), TRAINER),
    "trainer_program": lambda: rtrainer.trainer_program(
        CFG, DATA, OptCfg(), TRAINER),
    "distributed_train": lambda: _deprecated(
        lambda: rtrainer.distributed_train(2, CFG, DATA, OptCfg(), TRAINER,
                                           n_procs=2)),
    "trainer_cli": lambda: rtrainer._cli(["--steps", "1"]),
    "EdatAnalytics": lambda: EdatAnalytics(InsituCfg()).run(),
    "BespokeAnalytics": lambda: BespokeAnalytics(InsituCfg()).run(),
    "insitu_program": lambda: insitu_program({}),
    "distributed_insitu": lambda: _deprecated(
        lambda: distributed_insitu(InsituCfg(), n_procs=2)),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_gpu_raises(name, monkeypatch):
    """device=None means the card: without one, raise, never fall back,
    and spawn no rank process first."""
    def spawn(self):
        raise AssertionError("spawned rank processes without a card")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(ProcessGroup, "start", spawn)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()
