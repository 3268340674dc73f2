"""repro_torch: the PyTorch and CUDA port of ``repro`` for one NVIDIA H100.

It imports torch and numpy, never jax and nothing of the ``repro``
package: it carries its own copy of the EDAT runtime (``core``, ``api``,
``durable``, ``edat``) and of the configs.  Entry points run on the card
unless the caller passes ``device="cpu"``.
"""
