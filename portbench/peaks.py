"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W power limit): the prices of the roofline shares and the MFUs.

A product is priced at the fastest tensor-core rate for its precision, so
no float32-accurate implementation (3xTF32 included) can read above its
bound: bf16 at 989 TFLOP/s, float32 at the TF32 rate, 495 TFLOP/s."""
BF16_FLOPS = 989e12
F32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12
