"""segalign_tpu_torch: the pairwise ungapped aligner of segalign_tpu on
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The package stands alone: it keeps its own copy of the host code it needs
(config, constants, io, index, native, output, ops/finalize, ops/dedup,
pipeline/manifest, cli/args) and imports neither jax nor segalign_tpu.
Every function takes its device explicitly: kernels run on CUDA tensors,
and their plain PyTorch versions on CPU tensors. The CUDA sources under
csrc/ and the native host library under native/ are built at first use
(_build.py).
"""
