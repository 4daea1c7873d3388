"""bignn_tpu_torch — the BI-GNN framework in PyTorch and CUDA for NVIDIA
Hopper (H100), beside the JAX package ``bignn_tpu`` it is tested against.

It keeps the JAX package's module layout:
  - sparse/   padded, destination-sorted graph layouts and bucketing (NumPy)
  - data/     dataset schema, synthetic generator, registry, and the
              hierarchical samplers (host NumPy; on the card in PyTorch)
  - ops/      segment sum, block adjacency, dense GAT attention, segment
              softmax and multi-head SpMM (forward and backward), each a
              hand-written CUDA kernel (csrc/, float32 and bf16; the block
              adjacency also int8/int16 counts) with a plain PyTorch
              version; autograd Functions where gradients flow
  - models/   GIN / GAT / GCN convs, readout, pair scorers, BiGNN, loss
  - train/    the full-graph Trainer, the hierarchical MinibatchTrainer
              (sampled and exact evaluation), AUC/AP metrics, checkpoints
  - parallel/ the edge-partitioned (p2) step over graph shards
  - utils/    metric logging, profiling
  - run.py    the experiment CLI (full, minibatch, p2)
  - serve.py  the offline-encode / online-scoring server and its CLI
  - prng.py   jax.random's threefry draws, so a seed means the same run
  - bridge.py JAX parameter trees -> PyTorch state dicts

The package imports no JAX; kernels build with nvcc at first use.
"""

__version__ = "0.1.0"
