"""The port's kernels (slot engine, per-packet decisions, attention,
int8 codec): hand-written CUDA for the GPU, plain PyTorch
versions (`ref`) for the CPU.  Importing this package never imports a
compiler or builds anything; `build.library()` does, at first launch."""
