"""Flash attention: the Hopper kernel (ops) and its plain version (ref)."""
