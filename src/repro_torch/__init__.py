"""PyTorch/CUDA port of `repro`: the Qm.n smallNet on an NVIDIA H100.

The JAX package `repro` stays the reference; nothing here imports it or
JAX.  Layout mirrors it: `core/` (fixed-point words, backends, the smallNet
graph, training and deployment, the device rule), `kernels/` (CUDA kernels
in `csrc/` with their plain PyTorch versions), `optim/`, `serving/` (the
engine, the replica router and the disaggregated trunk/head server),
`streaming/`, `obs/`, `analysis/` (the device database, the workload
model, kernel launches read by the profiler), `data/`.
"""
