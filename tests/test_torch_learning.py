"""The port's two samplers learn alike: JAX's gate
(tests/test_device_vs_host_learning.py) on the port's ``MinibatchTrainer``.

The device sampler (``data/device_sampler.py``) draws from a
``torch.Generator``, not from JAX's threefry, so no test can hold its
batches to JAX's; the host sampler's are JAX's draws, but its trajectory
is not retraced over 160 steps (the one-step parity is
tests/test_torch_minibatch.py's). So the gate is on learning, as JAX's is:
the same latent-structure synthetic, model, ``TrainConfig``, fanouts,
``calibrate_caps``, ``dispatch_chunk`` and 16 steps an epoch, three seeds
in each mode, and JAX's thresholds unchanged: both 3-seed mean test AUCs at
least 0.58 and within 0.03 of each other. Both means must also lie within
0.03 of JAX's host-sampled 3-seed mean, computed here on the same inputs.
The same gate runs on the card, where the device sampler draws from the
CUDA generator (``chip_smoke.py`` path L).
"""

import numpy as np
import pytest
import torch

from bignn_tpu.data import make_synthetic_ddi as jax_make_synthetic_ddi
from bignn_tpu.models import BiGNN as JaxBiGNN
from bignn_tpu.models import BiGNNConfig as JaxBiGNNConfig
from bignn_tpu.train import MinibatchTrainer as JaxMinibatchTrainer
from bignn_tpu.train import TrainConfig as JaxTrainConfig

from bignn_tpu_torch.data import make_synthetic_ddi
from bignn_tpu_torch.models import BiGNN, BiGNNConfig
from bignn_tpu_torch.train import MinibatchTrainer, TrainConfig

# tests/test_device_vs_host_learning.py:21-40
DATA = dict(num_drugs=150, feat_dim=16, avg_degree=10.0, min_atoms=4,
            max_atoms=12, latent_dim=4, seed=7)
MODEL = dict(feat_dim=16, dim=32, heads=2)
TRAIN = dict(lr=3e-3, epochs=10, batch_size=48, eval_every=10)
TRAINER = dict(fanouts=(6,), calibrate_caps=4, dispatch_chunk=4)
SEEDS = (0, 1, 2)
STEPS = 16
GATE_AUC = 0.58  # both means at least this
GATE_DELTA = 0.03  # |device - host|, and each from JAX's host mean


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these tiny tensors (see
    tests/test_torch_minibatch.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_mean(device_sample: bool) -> float:
    ds = make_synthetic_ddi(**DATA)
    aucs = []
    for seed in SEEDS:
        tr = MinibatchTrainer(
            BiGNN(BiGNNConfig.full_bignn(**MODEL)), ds,
            TrainConfig(seed=seed, **TRAIN), device_sample=device_sample,
            device="cpu", **TRAINER)
        _, result = tr.fit(steps_per_epoch=STEPS)
        aucs.append(result["test_auc"])
    return float(np.mean(aucs))


def _jax_host_mean() -> float:
    ds = jax_make_synthetic_ddi(**DATA)
    model = JaxBiGNN(JaxBiGNNConfig.full_bignn(**MODEL))
    aucs = []
    for seed in SEEDS:
        tr = JaxMinibatchTrainer(model, ds, JaxTrainConfig(seed=seed,
                                                           **TRAIN),
                                 device_sample=False, **TRAINER)
        _, result = tr.fit(steps_per_epoch=STEPS)
        aucs.append(result["test_auc"])
    return float(np.mean(aucs))


def test_device_and_host_samplers_learn_alike():
    device, host = _port_mean(True), _port_mean(False)
    jax_host = _jax_host_mean()
    means = {"device": device, "host": host, "jax_host": jax_host}
    assert device >= GATE_AUC, means
    assert host >= GATE_AUC, means
    assert abs(device - host) <= GATE_DELTA, means
    assert abs(device - jax_host) <= GATE_DELTA, means
    assert abs(host - jax_host) <= GATE_DELTA, means
