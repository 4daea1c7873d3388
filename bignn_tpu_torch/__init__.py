"""bignn_tpu_torch — the BI-GNN framework in PyTorch and CUDA for NVIDIA
Hopper (H100), beside the JAX package ``bignn_tpu`` it is tested against.

It keeps the JAX package's module layout:
  - sparse/   padded, destination-sorted graph layouts and bucketing (NumPy)
  - data/     dataset schema, synthetic generator, registry
  - ops/      segment sum, block adjacency, dense GAT attention, segment
              softmax and multi-head SpMM (forward and backward), each a
              hand-written CUDA kernel (csrc/) with a plain PyTorch
              version; autograd Functions where gradients flow
  - models/   GIN / GAT / GCN convs, readout, pair scorers, BiGNN, loss
  - train/    the full-graph Trainer, AUC/AP metrics, checkpoints
  - serve.py  the offline-encode / online-scoring server
  - prng.py   jax.random's threefry draws, so a seed means the same run
  - bridge.py JAX parameter trees -> PyTorch state dicts

The package imports no JAX; kernels build with nvcc at first use.
"""

__version__ = "0.1.0"
