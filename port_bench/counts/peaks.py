"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense, at its full
700 W power limit; a card set below it (``nvidia-smi --query-gpu=
power.limit``) runs slower under load, so a share is stated against these
with the card's limit beside it.

fp32 work has no fp32 tensor-core mode: its fastest route is three TF32
products (the split-fp32 scheme) at a third of the 495 TFLOP/s TF32 peak,
165 TFLOP/s, above the 67 TFLOP/s of the fp32 CUDA cores. That is the peak
an fp32 share is held to.
"""

CARD = "NVIDIA H100 80GB HBM3"
POWER_LIMIT_W = 700.0
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"float32": 495e12 / 3, "bfloat16": 989e12}
