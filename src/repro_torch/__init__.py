"""PyTorch/CUDA port of the multi-plane fluid network simulator.

`repro_torch` runs the leaf-spine AR/WAR/ECMP slot engine on an NVIDIA
GPU with hand-written CUDA kernels (`kernels/csrc/netsim_kernels.cu`),
and on the CPU through the kernels' plain PyTorch versions; the
attention and int8-codec kernels (`kernels/csrc/model_kernels.cu`) sit
behind `repro_torch.kernels.ops`.  It carries its
own copies of the scenario schema, registry and host-side preparation,
so it imports only `torch` and `numpy`.
"""
