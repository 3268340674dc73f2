"""Fault-tolerant elastic trainer coordinated by EDAT events."""

__all__ = ["EventDrivenTrainer", "QuorumCollector", "TrainerCfg",
           "distributed_train", "flatten_params",
           "load_distributed_results", "trainer_program"]


def __getattr__(name):
    # lazy: `python -m repro_torch.runtime_dist.trainer` must be able to
    # import the package without the package importing the module first
    # (runpy double-import warning) — same pattern as repro_torch.net /
    # its launch CLI
    if name in __all__:
        from . import trainer
        return getattr(trainer, name)
    raise AttributeError(name)
