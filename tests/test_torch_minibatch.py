"""The port's ``MinibatchTrainer`` against the JAX package on the CPU, at
config4's settings scaled down (a 300-drug ``synthetic-large``, batch 32,
``max_drugs`` 256, fanouts (10,), superrows (4, 32), GIN:32 x2 -> sum ->
GAT:32:4 -> mlp:64).

* One f32 step on the same host-drawn ``CompactBatch``: the loss and every
  gradient equal JAX's ``xla`` backend at rtol 2e-4 / atol 2e-5 x max |g|
  (tests/test_torch_train.py: two f32 paths that sum in other orders), the
  JAX parameters carried over by ``bridge``.
* A chunk of K steps is K single steps (tests/test_dispatch_chunk.py).
* bf16: the forward stays within 0.1 of the f32 forward relative to
  max(|logit|, 1) (tests/test_bf16.py); the plain bf16 versions of the
  segment sum, segment softmax and multi-head SpMM agree with JAX's ``xla``
  path in bf16 within BF16_TOL (JAX rounds every partial sum and every
  message to bf16, the port sums in float32 and rounds once: partial sums
  of unit-scale rows reach ~4, where one bf16 rounding is up to 2**-7, over
  up to a dozen adds).
* ``fit`` on device-drawn batches repeats itself and resumes exactly.
The kernels themselves are held to these plain versions on the card
(tests/test_torch_kernels.py, chip_smoke.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bignn_tpu import ops as jax_ops
from bignn_tpu.data import load_dataset as jax_load_dataset
from bignn_tpu.models import BiGNN as JaxBiGNN
from bignn_tpu.models import BiGNNConfig as JaxBiGNNConfig
from bignn_tpu.ops.multihead import spmm_multihead as jax_spmm_mh
from bignn_tpu.ops.segment import segment_softmax as jax_softmax
from bignn_tpu.ops.segment import segment_sum as jax_segment_sum
from bignn_tpu.train.trainer import MinibatchTrainer as JaxMinibatchTrainer
from bignn_tpu.train.trainer import TrainConfig as JaxTrainConfig

from bignn_tpu_torch import bridge, ops
from bignn_tpu_torch.config import TrainConfig
from bignn_tpu_torch.data import load_dataset
from bignn_tpu_torch.models import BiGNN, BiGNNConfig
from bignn_tpu_torch.train import CheckpointManager, MinibatchTrainer

DATA = dict(num_drugs=300, avg_degree=20.0)
KW = dict(fanouts=(10,), max_drugs=256, calibrate_caps=4)
BF16_TOL = dict(rtol=3e-2, atol=6e-2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's tiny tensors: the test workers
    share a few cores, and PyTorch's default of one thread per core
    oversubscribes them (each small op then waits on descheduled threads)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ds():
    return load_dataset("synthetic-large", **DATA)


def _cfg(dtype="float32"):
    return dataclasses.replace(
        BiGNNConfig.full_bignn(feat_dim=32, dim=32, heads=4), dtype=dtype)


def _trainer(ds, dtype="float32", epochs=2, **kw):
    return MinibatchTrainer(
        BiGNN(_cfg(dtype)), ds,
        TrainConfig(lr=3e-4, epochs=epochs, batch_size=32), **KW,
        device="cpu", **kw)


def test_step_matches_jax(ds):
    jds = jax_load_dataset("synthetic-large", **DATA)
    jtr = JaxMinibatchTrainer(
        JaxBiGNN(JaxBiGNNConfig.full_bignn(feat_dim=32, dim=32, heads=4)),
        jds, JaxTrainConfig(lr=3e-4, batch_size=32), **KW)
    params = jtr.model.init(jax.random.key(1))
    jcb = jax.tree.map(jnp.asarray, jtr.sampler.sample_compact_at(0, 3))
    with jax_ops.backend_scope("xla"):
        loss, grads = jax.value_and_grad(jtr._loss)(params, jcb, jtr.tables)
    tr = _trainer(ds)
    tr.model.load_state_dict(bridge.params_from_jax(
        jax.tree.map(np.asarray, params)))
    got = tr.train_step(tr.sampler.sample_compact_at(0, 3))
    np.testing.assert_allclose(got.item(), float(loss), rtol=2e-4, atol=2e-5)
    want = bridge.params_from_jax(jax.tree.map(np.asarray, grads))
    for name, p in tr.model.named_parameters():
        scale = want[name].abs().max().item()
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=2e-4, atol=2e-5 * max(scale, 1.0),
                                   err_msg=name)


def test_chunks_equal_single_steps(ds):
    """train_chunk (host batches, also through _flush) and
    train_chunk_device each equal K = 4 train_step calls on the same
    batches."""
    a, b = _trainer(ds, dispatch_chunk=4), _trainer(ds, dispatch_chunk=4,
                                                    device_sample=True)
    hbs = [a.sampler.sample_compact_at(0, i) for i in range(4)]
    for tr in (a, b):
        tr.init(0)
    chunk = a.train_chunk(hbs)
    steps = torch.stack([b.train_step(hb) for hb in hbs])
    assert torch.equal(chunk, steps)
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
    a.init(0)
    assert torch.equal(torch.stack(a._flush(list(hbs), [])), chunk)
    a.init(0)
    b.init(0)
    dev, stats = b.train_chunk_device(1, 8)
    steps = torch.stack([
        a.train_step(b.dsampler.sample(b._dev_consts,
                                       b.dsampler.key_at(1, 8 + j))[0])
        for j in range(4)])
    assert torch.equal(dev, steps)
    assert int(stats["batches_sampled"]) == 4


def test_bf16_forward_close_to_f32(ds):
    """The same parameters and batch through the f32 and the bf16 model:
    f32 logits within 0.1 of max(|logit|, 1); a bf16 step keeps float32
    parameters and gradients."""
    f32, bf16 = _trainer(ds), _trainer(ds, dtype="bfloat16")
    f32.init(0)
    bf16.init(0)
    assert bf16.tables.feat.dtype == torch.bfloat16
    cb = f32.sampler.sample_compact_at(2, 1).to("cpu")
    with torch.no_grad():
        o32, o16 = f32._forward(cb), bf16._forward(cb)
    assert o16.dtype == torch.float32
    scale = torch.clamp(o32.abs(), min=1.0)
    assert ((o32 - o16).abs() / scale).max().item() < 0.1
    loss = bf16.train_step(cb)
    assert torch.isfinite(loss)
    for name, p in bf16.model.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all(), name


def _segments(rng, n_seg, rows):
    ids = np.sort(rng.integers(0, n_seg, rows))
    return np.concatenate([ids, np.full(9, n_seg)]).astype(np.int32)


@pytest.mark.parametrize("op", ["segment_sum", "segment_softmax",
                                "spmm_multihead"])
def test_plain_bf16_ops_match_jax_xla(op):
    rng = np.random.default_rng(5)
    bf = jnp.bfloat16

    def both(x):
        return (torch.from_numpy(x).to(torch.bfloat16),
                jnp.asarray(x).astype(bf))

    with jax_ops.backend_scope("xla"):
        if op == "segment_sum":
            ids = _segments(rng, 40, 300)
            x, jx = both(rng.standard_normal((len(ids), 24)).astype(
                np.float32))
            got = ops.segment_sum_plain(x, torch.from_numpy(ids), 40)
            want = jax_segment_sum(jx, jnp.asarray(ids), 40)
        elif op == "segment_softmax":
            ids = _segments(rng, 40, 300)
            x, jx = both(3 * rng.standard_normal((len(ids), 4)).astype(
                np.float32))
            got = ops.segment_softmax_plain(x, torch.from_numpy(ids), 40)
            want = jax_softmax(jx, jnp.asarray(ids), 40)
            keep = ids < 40  # JAX leaves padding rows unspecified
            got, want = got[torch.from_numpy(keep)], np.asarray(want)[keep]
        else:
            dst = _segments(rng, 50, 400)
            src = rng.integers(0, 50, len(dst)).astype(np.int32)
            v, jv = both(rng.standard_normal((50, 4, 8)).astype(np.float32))
            a, ja = both(rng.random((len(dst), 4)).astype(np.float32))
            got = ops.spmm_multihead_plain(v, torch.from_numpy(src),
                                           torch.from_numpy(dst), a, 50)
            want = jax_spmm_mh(jv, jnp.asarray(src), jnp.asarray(dst), ja, 50)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


def _losses(result):
    return [r["loss"] for r in result["history"]]


def test_fit_device_sampled_repeats_and_resumes(ds, tmp_path):
    """Two tiny epochs of device-drawn steps: finite losses, the same run
    twice gives the same losses, and a run killed after epoch 0 and
    resumed from its checkpoint repeats the uninterrupted one."""
    runs = []
    for _ in range(2):
        tr = _trainer(ds, device_sample=True, dispatch_chunk=2)
        runs.append(tr.fit(steps_per_epoch=3)[1])
    assert np.all(np.isfinite(_losses(runs[0])))
    assert _losses(runs[0]) == _losses(runs[1])
    assert runs[0]["test_auc"] == runs[1]["test_auc"]
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    _trainer(ds, epochs=1, device_sample=True, dispatch_chunk=2).fit(
        steps_per_epoch=3, ckpt=ckpt)
    _, resumed = _trainer(ds, device_sample=True, dispatch_chunk=2).fit(
        steps_per_epoch=3, ckpt=ckpt)
    assert [r["epoch"] for r in resumed["history"]] == [1]
    assert _losses(resumed) == _losses(runs[0])[1:]
    assert resumed["history"][0]["val_auc"] == runs[0]["history"][1][
        "val_auc"]
    assert resumed["test_auc"] == runs[0]["test_auc"]


def test_fit_host_sampled_is_independent_of_workers(ds):
    """Host-drawn batches on prefetch threads: a pure function of (seed,
    epoch, step), so the worker count cannot change the run; an epoch of 3
    steps at dispatch_chunk 2 is one chunk and a tail step."""
    runs = [_trainer(ds, epochs=1, dispatch_chunk=2,
                     prefetch_workers=w).fit(steps_per_epoch=3)[1]
            for w in (1, 3)]
    assert np.all(np.isfinite(_losses(runs[0])))
    assert _losses(runs[0]) == _losses(runs[1])


def test_left_out_paths_raise(ds):
    """A mesh without a 'dp' axis (tests/test_torch_dp.py runs the dp
    mesh); device_sample without resident tables."""
    with pytest.raises(ValueError, match="'dp' axis"):
        _trainer(ds, mesh=object())
    with pytest.raises(ValueError, match="resident"):
        _trainer(ds, resident=False, device_sample=True)
