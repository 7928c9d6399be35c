"""HetCCL reproduction in PyTorch for NVIDIA Hopper: the port of the JAX
package ``repro``, module for module, with hand-written CUDA kernels in
place of its Pallas kernels."""
