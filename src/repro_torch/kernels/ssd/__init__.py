"""Mamba-2 SSD chunked scan: the Hopper kernel (ops) and its plain version
(ref)."""
