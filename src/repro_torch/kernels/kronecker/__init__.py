"""The Graph500 Kronecker generator's draws: the Hopper kernel (ops) and
its plain version (ref)."""
