"""PyTorch/CUDA port of `repro`: the Qm.n smallNet on an NVIDIA H100.

The JAX package `repro` stays the reference; nothing here imports it or
JAX.  Layout mirrors it: `core/` (fixed-point words, backends, the smallNet
graph, training and deployment, the device rule), `kernels/` (CUDA kernels
in `csrc/` with their plain PyTorch versions), `optim/`, `serving/` (the
engine and the replica router), `streaming/`, `obs/`, `data/`.
"""
