# Hand-written CUDA kernels for Hopper (csrc/), their plain PyTorch
# versions and launch counters:
#   flash_attention.py — causal / sliding-window GQA flash attention
#   quant.py           — int8 block quant / dequant (KV-transfer codec)
# ops.py: model-layout wrappers; ref.py: plain reference functions;
# _build.py: nvcc -> shared library -> ctypes, at first use.
