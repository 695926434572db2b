"""repro_torch: 'The Duck's Brain' — in-database NN training/inference, the
PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.  It imports neither JAX
nor ``repro``; the kernels under ``kernels/csrc`` are hand-written CUDA."""
__version__ = "1.0.0"
