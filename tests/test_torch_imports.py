"""The port stands alone: importing any of it loads neither jax nor the
JAX package, and its entry points never carry on on the CPU unasked."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, reduce_cfg            # noqa: E402
from repro_torch.net.launch import ProcessGroup              # noqa: E402
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
for name in ("repro_torch.models.mamba2", "repro_torch.kernels.ssd.ops",
             "repro_torch.kernels.ssd.ref", "repro_torch.models.rglru",
             "repro_torch.kernels.rglru.ops",
             "repro_torch.kernels.rglru.ref", "repro_torch.net",
             "repro_torch.net.frames", "repro_torch.net.socket_transport",
             "repro_torch.net.bootstrap", "repro_torch.net.launch"):
    assert name in names, name
"""


def test_importing_every_module_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _CHECK], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 42      # configs, runtime, net, models, kernels, serve


CFG = reduce_cfg(ARCHS["gemma3-1b"].cfg)
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
    "run_sequential": lambda: run_sequential(CFG, []),
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
