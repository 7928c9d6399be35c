# Hand-written CUDA kernels for Hopper (csrc/), their plain PyTorch
# versions and launch counters:
#   flash_attention.py — causal / sliding-window GQA flash attention
#   quant.py           — int8 block codecs: local-scale quant / dequant
#                        (KV transfer), shared-scale amax + quant (gradient sync)
#   ssd.py             — the Mamba2 SSD chunk (within-chunk scores and states)
# ops.py: model-layout wrappers; ref.py: plain reference functions;
# _build.py: nvcc -> shared library -> ctypes, at first use.
