"""PyTorch/CUDA port of the multi-plane fluid network simulator.

`repro_torch` runs the leaf-spine AR/WAR slot engine on an NVIDIA GPU
with hand-written CUDA kernels (`kernels/csrc/netsim_kernels.cu`), and
on the CPU through the kernels' plain PyTorch versions.  It carries its
own copies of the scenario schema, registry and host-side preparation,
so it imports only `torch` and `numpy`.
"""
