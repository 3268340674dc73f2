"""The port's configs are the reference's, field for field.

The port keeps its own copy of the configs (importing the reference's
loads jax); the one intended difference is ``attn_impl``, whose values
are the port's own (``"kernel"``/``"ref"``).
"""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import ARCHS as JARCHS                    # noqa: E402
from repro.configs import reduce_cfg as jreduce              # noqa: E402
from repro_torch.configs import ARCHS, reduce_cfg            # noqa: E402


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("attn_impl")
    return d


def test_same_arch_names():
    assert list(ARCHS) == list(JARCHS)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_cfg_matches_reference(arch, reduced):
    cfg, jcfg = ARCHS[arch].cfg, JARCHS[arch].cfg
    if reduced:
        cfg, jcfg = reduce_cfg(cfg), jreduce(jcfg)
    assert _fields(cfg) == _fields(jcfg)
    assert cfg.layer_kinds() == jcfg.layer_kinds()
    assert cfg.attn_impl == "kernel"
    spec, jspec = ARCHS[arch], JARCHS[arch]
    assert (spec.published_params, spec.skip_shapes, spec.microbatches) == (
        jspec.published_params, jspec.skip_shapes, jspec.microbatches)
