"""RG-LRU recurrence: the Hopper kernel (ops) and its plain version (ref)."""
