"""Launchers of the port: the train and serve command lines, and the
meta-device dry-run of every (architecture x input shape) cell under the
reference's sharding rules (the counterpart of ``repro.launch``).

  python -m repro_torch.launch.serve --arch gemma3-1b
  python -m repro_torch.launch.train --arch gemma3-1b --steps 3 --batch 2 \
      --seq 512
  python -m repro_torch.launch.dryrun --all

``--device cpu`` runs the first two on the CPU (``--reduced`` for a config
that fits there); the dry-run allocates nothing and runs anywhere.
"""
