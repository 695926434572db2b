"""Plain references: PyTorch operations only, no kernel, no cache, and
nothing of the program (``repro_torch``), of ``repro`` or of JAX.  Each
works out again from the benchmark's own inputs whatever the program
derived from them."""
