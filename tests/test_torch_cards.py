"""One process driving several cards (``parallel/replicas.py``,
``parallel/comm.py``'s ``CardExchange``, the replicated dp and p2 steps,
the minibatch trainer's replicas, tp and ``run``'s spread of shards), held
on the CPU.

The CPU has no second card, so every replica (or "card") here is a slot
on the one CPU: the code that a mesh over distinct cards runs is run, its
card-to-card copies are copies on the CPU, and its cross-card kernel,
peer access and events are not (``tests/test_torch_kernels.py``'s
``gpu``-marked test and ``chip_smoke.py`` path M hold those on the card).

* Sums across slots add in slot order: ``Replicas.step``,
  ``gather_rows_cards``' backward and tp's ``_Broadcast`` backward, on
  values whose float32 sum shows the order (exact).
* The replicated dp step (4 replicas of one shard, 2 of two) over 3 Adam
  steps against JAX's dp ``Trainer`` on 4 fake CPU devices (rtol 2e-4 /
  atol 2e-5, tests/test_torch_dp.py's TOL) and against the one-replica
  step (loss rtol 1e-5, parameters rtol 1e-4 / atol 1e-6, JAX
  tests/test_dp.py's); the replicas equal to the bit after every step;
  two runs equal to the bit.
* The p2 step over a "card" a shard against JAX's p2 step (one Adam step,
  tests/test_torch_parallel.py's tolerances) and against the one-card
  step; the replicas equal to the bit; two runs equal to the bit; its
  scorer against the one-card scorer (exact: the same forward).
* The minibatch trainer, device-drawn, with 4 replicas against the one
  replica (JAX tests/test_dp_device_sample.py's tolerances); checkpoints
  read replica 0.
* ``spread_devices`` and ``run``'s meshes with 4 cards stubbed (nothing
  runs on a card); ``make_exchange``'s route and ``enable_peer_access``
  (each pair once, a pair without access an error) with peer access
  stubbed.
* The JAX helpers the port keeps its own copies of: ``make_training_pairs``
  (exact), ``EpochPrefetcher``, ``native.in_degrees`` and
  ``native.partition_edges_hash`` (exact, native and NumPy routes).
"""

import dataclasses
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bignn_tpu import native as jax_native
from bignn_tpu import ops as jax_ops
from bignn_tpu.data import make_synthetic_ddi as jax_make_synthetic_ddi
from bignn_tpu.data import prepare_device_data as jax_prepare_device_data
from bignn_tpu.data.prefetch import EpochPrefetcher as JaxEpochPrefetcher
from bignn_tpu.data.sampler import make_training_pairs as jax_training_pairs
from bignn_tpu.models import BiGNN as JaxBiGNN
from bignn_tpu.models import BiGNNConfig as JaxBiGNNConfig
from bignn_tpu.parallel import build_outer_partition as jax_partition
from bignn_tpu.parallel import build_sharded_inner as jax_sharded_inner
from bignn_tpu.parallel import device_put_plan as jax_put_plan
from bignn_tpu.parallel import make_mesh as jax_make_mesh
from bignn_tpu.parallel import make_p2_train_step as jax_p2_step
from bignn_tpu.train import Trainer as JaxTrainer
from bignn_tpu.train import TrainConfig as JaxTrainConfig

from bignn_tpu_torch import bridge, native, prng, run
from bignn_tpu_torch.config import TrainConfig
from bignn_tpu_torch.data import make_synthetic_ddi, prepare_device_data
from bignn_tpu_torch.data.prefetch import EpochPrefetcher
from bignn_tpu_torch.data.sampler import make_training_pairs
from bignn_tpu_torch.models import BiGNN, BiGNNConfig
from bignn_tpu_torch.parallel import (
    CardExchange,
    Mesh,
    Replicas,
    build_outer_partition,
    build_sharded_inner,
    comm,
    device_put_plan,
    gather_rows_cards,
    make_cards_train_step,
    make_exchange,
    make_mesh,
    make_p2_score_fn,
    make_p2_train_step,
    make_replicated_dp_step,
    spread_devices,
)
from bignn_tpu_torch.parallel.tp import _Broadcast
from bignn_tpu_torch.parallel import dp as port_dp
from bignn_tpu_torch.train import CheckpointManager, MinibatchTrainer, Trainer
from bignn_tpu_torch.train.trainer import optimizer_state

TOL = dict(rtol=2e-4, atol=2e-5)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
DP_KW = dict(num_drugs=48, feat_dim=8, avg_degree=6.0, min_atoms=4,
             max_atoms=10, seed=0)  # tests/test_torch_dp.py's
P2_KW = dict(num_drugs=40, feat_dim=8, avg_degree=6.0, min_atoms=4,
             max_atoms=10, seed=0)  # tests/test_torch_parallel.py's
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors (see
    tests/test_torch_minibatch.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _same_bits(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        torch.equal(a[k].view(-1).view(torch.uint8),
                    b[k].view(-1).view(torch.uint8)) for k in a)


def _state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


# ---------------------------------------------------------------------------
# sums across slots, in slot order
# ---------------------------------------------------------------------------

# float32: (1e8 + 1) - 1e8 == 0, while 1e8 + (1 - 1e8) == 1
ORDERED = (1e8, 1.0, -1e8)


def test_replicas_add_gradients_in_slot_order():
    model = torch.nn.Linear(1, 1, bias=False)
    reps = Replicas(model, torch.optim.SGD(model.parameters(), lr=1.0),
                    [CPU] * 3)
    reps.zero_grad()
    for m, g in zip(reps.models, ORDERED):
        m.weight.grad = torch.full((1, 1), g)
    before = model.weight.detach().clone()
    reps.step()
    want = (torch.tensor(ORDERED[0]) + ORDERED[1]) + ORDERED[2]
    assert want.item() == 0.0  # the slot order's sum, not 1
    for m in reps.models:
        assert torch.equal(m.weight.grad.view(()), want)
        assert torch.equal(m.weight.detach(), before - want)
    # a missing gradient counts as zeros, as comm.sum_grads counts it
    reps.zero_grad()
    reps.models[1].weight.grad = torch.full((1, 1), 2.0)
    reps.step()
    assert all(m.weight.grad.item() == 2.0 for m in reps.models)


def test_gather_rows_cards_backward_adds_in_card_order():
    ex = CardExchange([CPU] * 3, card_of=[0, 1, 2])
    h = [torch.full((1, 1), float(j), requires_grad=True) for j in range(3)]
    embs = gather_rows_cards(h, ex)
    assert len(embs) == 3
    for e in embs:
        assert torch.equal(e, torch.tensor([[0.0], [1.0], [2.0]]))
    torch.autograd.backward(embs, [torch.full((3, 1), g) for g in ORDERED])
    for x in h:
        assert x.grad.item() == 0.0


def test_tp_broadcast_backward_adds_in_shard_order():
    x = torch.ones(1, requires_grad=True)
    outs = _Broadcast.apply([CPU] * 3, x)
    torch.autograd.backward(outs, [torch.full((1,), g) for g in ORDERED])
    assert x.grad.item() == 0.0


def test_card_exchange_layout():
    ex = CardExchange([CPU] * 4, card_of=[0, 0, 1, 1])
    assert ex.size == 2 and ex.heads == [0, 2] and ex.cards == [CPU, CPU]
    with pytest.raises(ValueError, match="skip"):
        CardExchange([CPU] * 2, card_of=[0, 2])


# ---------------------------------------------------------------------------
# the replicated dp step
# ---------------------------------------------------------------------------


def _dp_batches(data, n=3):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        pos = data.train_pairs[rng.permutation(len(data.train_pairs))[:32]]
        mask = np.ones(32, np.float32)
        mask[-3:] = 0.0
        out.append((pos, mask))
    return out


def _dp_trajectory(data, params, slot_of=None):
    """3 Adam steps of a dp = 4 Trainer from ``params``: the one-replica
    step (``slot_of`` None) or ``make_replicated_dp_step`` with a replica
    a distinct slot of ``slot_of``. Returns the losses, the parameters
    after each step, and every replica's state at the end."""
    tr = Trainer(BiGNN(BiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2)),
                 data, TrainConfig(lr=1e-3, batch_size=32), device="cpu",
                 mesh=make_mesh(dp=4, devices=["cpu"] * 4))
    tr.model.load_state_dict(params)
    if slot_of is not None:
        tr._step = make_replicated_dp_step(
            tr.model, tr.optimizer, [CPU] * (max(slot_of) + 1), slot_of,
            data.num_drugs)
    losses, states = [], []
    for i, (pos, mask) in enumerate(_dp_batches(data)):
        losses.append(tr.train_step(pos, mask, 0, i).item())
        states.append(tr.params())
        if slot_of is not None:
            for m in tr._step.replicas.models[1:]:
                assert _same_bits(_state(m), states[-1])
    return losses, states


@pytest.fixture(scope="module")
def dp_setup():
    jdata = jax_prepare_device_data(jax_make_synthetic_ddi(**DP_KW))
    data = prepare_device_data(make_synthetic_ddi(**DP_KW))
    jmodel = JaxBiGNN(JaxBiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2))
    jtr = JaxTrainer(jmodel, jdata, JaxTrainConfig(lr=1e-3, batch_size=32),
                     mesh=jax_make_mesh(dp=4, graph=1,
                                        devices=jax.devices()[:4]))
    params = jmodel.init(jax.random.key(1))
    init = bridge.params_from_jax(_np_tree(params))
    opt_state = jtr.optimizer.init(params)
    ekey = jax.random.fold_in(jax.random.key(1), 0)  # key(seed + 1), epoch 0
    want = []
    with jax_ops.backend_scope("xla"):
        for i, (pos, mask) in enumerate(_dp_batches(data)):
            params, opt_state, loss = jtr._train_step(
                params, opt_state, jax.random.fold_in(ekey, i),
                jnp.asarray(pos), jnp.asarray(mask))
            want.append(float(loss))
    one = _dp_trajectory(data, init)
    return data, init, want, bridge.params_from_jax(_np_tree(params)), one


@pytest.mark.parametrize("slot_of", [[0, 1, 2, 3], [0, 0, 1, 1]],
                         ids=["4x1", "2x2"])
def test_replicated_dp_step_matches_jax_and_one_replica(dp_setup, slot_of):
    data, init, want, want_p, (one, one_p) = dp_setup
    got, got_p = _dp_trajectory(data, init, slot_of)
    np.testing.assert_allclose(got, want, **TOL)
    for name, p in got_p[-1].items():
        np.testing.assert_allclose(p.numpy(), want_p[name].numpy(),
                                   err_msg=name, **TOL)
    np.testing.assert_allclose(got, one, rtol=LOSS_RTOL)
    for name, p in got_p[-1].items():
        np.testing.assert_allclose(p.numpy(), one_p[-1][name].numpy(),
                                   err_msg=name, **PARAM_TOL)
    again, again_p = _dp_trajectory(data, init, slot_of)
    assert again == got and all(map(_same_bits, again_p, got_p))


def test_replicas_follow_slot_zero(dp_setup):
    """A state loaded into replica 0 between steps (a resume) reaches the
    others before the next step; so does a fresh optimizer."""
    data, init, *_ = dp_setup
    tr = Trainer(BiGNN(BiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2)),
                 data, TrainConfig(lr=1e-3, batch_size=32), device="cpu",
                 mesh=make_mesh(dp=4, devices=["cpu"] * 4))
    tr.model.load_state_dict(init)
    step = make_replicated_dp_step(tr.model, tr.optimizer, [CPU] * 2,
                                   [0, 0, 1, 1], data.num_drugs)
    batches = _dp_batches(data)
    key = prng.key(5)
    step(key, *batches[0], tr.buckets, tr.graph_index, tr.outer)
    tr.model.load_state_dict(init)
    reps = step.replicas
    reps.refresh()
    assert _same_bits(_state(reps.models[1]), _state(tr.model))
    state = reps.optimizers[0].state_dict()["state"]
    other = reps.optimizers[1].state_dict()["state"]
    assert state.keys() == other.keys() and all(
        torch.equal(state[k]["exp_avg"], other[k]["exp_avg"])
        and state[k]["exp_avg"] is not other[k]["exp_avg"] for k in state)
    fresh = torch.optim.Adam(tr.model.parameters(), lr=1e-3)
    reps.refresh(fresh)
    assert reps.optimizers[0] is fresh and not reps.optimizers[1].state


# ---------------------------------------------------------------------------
# the p2 step over a card a shard
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def p2_datasets():
    return make_synthetic_ddi(**P2_KW), jax_make_synthetic_ddi(**P2_KW)


def _p2_plan(ds, model, graph):
    train = ds.split_edges("train")
    plan = build_outer_partition(train[:, 0], train[:, 1], ds.num_drugs,
                                 graph)
    inner = build_sharded_inner(ds.molecules, plan)
    mesh = make_mesh(dp=1, graph=graph, devices=["cpu"] * graph)
    return mesh, device_put_plan(mesh, plan, inner,
                                 model.config.inner_layers)


def _pos(num_drugs, seed=4, n=16):
    return np.random.default_rng(seed).integers(
        0, num_drugs, (n, 2)).astype(np.int32)


def _p2_cards_step(ds, cfg, init, card_of, steps=1):
    """``steps`` p2 steps (keys 9, 10, ...) of ``make_cards_train_step``
    with a "card" a group of ``card_of``; the losses, replica 0's
    parameters and gradients after step 1 and at the end, and every
    replica's state."""
    model = BiGNN(cfg)
    model.load_state_dict(init)
    _, plan_d = _p2_plan(ds, model, len(card_of))
    step = make_cards_train_step(
        model, torch.optim.Adam(model.parameters(), lr=1e-3),
        CardExchange([CPU] * len(card_of), card_of), ds.num_drugs)
    mask = np.ones(16, np.float32)
    mask[-3:] = 0.0
    losses, first = [], None
    for i in range(steps):
        losses.append(step(prng.key(9 + i), _pos(ds.num_drugs, 4 + i), mask,
                           plan_d).item())
        if first is None:
            first = (_state(model), {k: p.grad.clone()
                                     for k, p in model.named_parameters()})
    return losses, first, [_state(m) for m in step.replicas.models]


OUTERS = [("gin:16", "gat:16:2:identity"), ("gcn:16",)]


@pytest.mark.parametrize("outer", OUTERS, ids=["gin-gat", "gcn"])
def test_cards_p2_step_matches_jax(p2_datasets, outer):
    """One step on 4 shards, a "card" each, against JAX's p2 step on 4 fake
    devices: loss and parameters at STEP_TOL, gradients at TOL x the
    largest (tests/test_torch_parallel.py)."""
    ds, jds = p2_datasets
    cfg = dataclasses.replace(
        JaxBiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2),
        outer_layers=outer)
    jmodel = JaxBiGNN(cfg)
    params = jmodel.init(jax.random.key(1))
    capture = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))
    opt = optax.chain(capture, optax.adam(1e-3))
    train = jds.split_edges("train")
    plan = jax_partition(train[:, 0], train[:, 1], jds.num_drugs, 4)
    jmesh = jax_make_mesh(dp=1, graph=4, devices=jax.devices()[:4])
    jplan = jax_put_plan(jmesh, plan, jax_sharded_inner(jds.molecules, plan))
    pos, mask = _pos(ds.num_drugs), np.ones(16, np.float32)
    mask[-3:] = 0.0
    with jax_ops.backend_scope("xla"), jmesh:
        new_params, (grads, _), loss = jax_p2_step(
            jmodel, opt, jmesh, jds.num_drugs)(
            params, opt.init(params), jax.random.key(9), jnp.asarray(pos),
            jnp.asarray(mask), *jplan)
    init = bridge.params_from_jax(_np_tree(params))
    losses, (got_p, got_g), states = _p2_cards_step(
        ds, BiGNNConfig(**dataclasses.asdict(cfg)), init, [0, 1, 2, 3])
    np.testing.assert_allclose(losses[0], float(loss), **STEP_TOL)
    want_g = bridge.params_from_jax(_np_tree(grads))
    want_p = bridge.params_from_jax(_np_tree(new_params))
    for name, g in got_g.items():
        scale = max(want_g[name].abs().max().item(), 1.0)
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(),
                                   rtol=TOL["rtol"],
                                   atol=TOL["atol"] * scale, err_msg=name)
        np.testing.assert_allclose(got_p[name].numpy(),
                                   want_p[name].numpy(), **STEP_TOL,
                                   err_msg=name)
    assert all(_same_bits(s, states[0]) for s in states[1:])


@pytest.mark.parametrize("card_of", [[0, 1, 2, 3], [0, 0, 1, 1]],
                         ids=["4x1", "2x2"])
def test_cards_p2_step_matches_one_card_and_repeats(p2_datasets, card_of):
    """3 steps against the p2 step of one card named 4 times (losses and
    parameters at STEP_TOL: the gradients are added in another order);
    the replicas equal to the bit; a second run the same bits."""
    ds, _ = p2_datasets
    cfg = dataclasses.replace(
        BiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2),
        outer_layers=OUTERS[0])
    init = _state(BiGNN(cfg, seed=1))
    model = BiGNN(cfg)
    model.load_state_dict(init)
    mesh, plan_d = _p2_plan(ds, model, 4)
    step = make_p2_train_step(
        model, torch.optim.Adam(model.parameters(), lr=1e-3), mesh,
        ds.num_drugs)
    mask = np.ones(16, np.float32)
    mask[-3:] = 0.0
    want = [step(prng.key(9 + i), _pos(ds.num_drugs, 4 + i), mask,
                 plan_d).item() for i in range(3)]
    losses, _, states = _p2_cards_step(ds, cfg, init, card_of, steps=3)
    np.testing.assert_allclose(losses, want, **STEP_TOL)
    for name, p in _state(model).items():
        np.testing.assert_allclose(states[0][name].numpy(), p.numpy(),
                                   **STEP_TOL, err_msg=name)
    assert all(_same_bits(s, states[0]) for s in states[1:])
    again, _, states2 = _p2_cards_step(ds, cfg, init, card_of, steps=3)
    assert again == losses and _same_bits(states2[0], states[0])


def test_cards_p2_score_fn_follows_the_model(p2_datasets, monkeypatch):
    """The scorer over cards (a mesh over distinct devices, here the CPU
    slots of a stubbed exchange) equals the one-card scorer bit for bit,
    also after the model's parameters change."""
    ds, _ = p2_datasets
    model = BiGNN(BiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2),
                  seed=2)
    mesh, plan_d = _p2_plan(ds, model, 4)
    pairs = _pos(ds.num_drugs, seed=6, n=24)
    from bignn_tpu_torch.parallel import step as step_mod

    monkeypatch.setattr(step_mod, "make_exchange",
                        lambda m: CardExchange([CPU] * 4, [0, 1, 2, 3]))
    cards = make_p2_score_fn(model, mesh)
    monkeypatch.undo()
    one = make_p2_score_fn(model, mesh)
    assert torch.equal(cards(pairs, plan_d), one(pairs, plan_d))
    model.load_state_dict(_state(BiGNN(model.config, seed=3)))
    assert torch.equal(cards(pairs, plan_d), one(pairs, plan_d))


# ---------------------------------------------------------------------------
# the minibatch trainer over replicas
# ---------------------------------------------------------------------------


def _device_trainer(ds, replicas: bool, epochs: int = 1):
    tr = MinibatchTrainer(
        BiGNN(BiGNNConfig(feat_dim=8, inner_layers=("gin:16",),
                          outer_layers=("gcn:16:identity",)), seed=0),
        ds, TrainConfig(lr=1e-3, epochs=epochs, batch_size=8, seed=0),
        fanouts=(4,), calibrate_caps=2, device_sample=True,
        dispatch_chunk=2, mesh=make_mesh(dp=4, devices=["cpu"] * 4),
        device="cpu")
    if replicas:  # what a mesh over 4 cards lays out, on CPU slots
        tr._slots, tr._slot_of = [CPU] * 4, [0, 1, 2, 3]
    return tr


def test_minibatch_replicas_match_one_replica():
    """A device-drawn chunk of 2 steps on dp = 4: 4 replicas against one
    (losses rtol 1e-5, parameters rtol 1e-4 / atol 1e-6, JAX
    tests/test_dp_device_sample.py); the replicas equal to the bit;
    checkpoints read replica 0, the trainer's own."""
    ds = make_synthetic_ddi(num_drugs=60, feat_dim=8, avg_degree=6.0,
                            min_atoms=4, max_atoms=10, seed=2)
    results = []
    for replicas in (False, True):
        tr = _device_trainer(ds, replicas)
        losses, stats = tr.train_chunk_device(0, 0)
        assert stats["batches_sampled"].item() == 8
        results.append((losses, tr.params(), tr))
    (l1, p1, _), (l4, p4, tr) = results
    np.testing.assert_allclose(l4.numpy(), l1.numpy(), rtol=LOSS_RTOL)
    for name, p in p4.items():
        np.testing.assert_allclose(p.numpy(), p1[name].numpy(),
                                   **PARAM_TOL, err_msg=name)
    assert all(_same_bits(_state(m), p4) for m in tr._reps.models[1:])
    assert tr._reps.models[0] is tr.model
    assert tr._reps.optimizers[0] is tr.optimizer


def _same_adam(reps) -> bool:
    """Every replica's Adam state equal to replica 0's, bit for bit."""
    want = reps.optimizers[0].state_dict()["state"]
    return all(
        (got := opt.state_dict()["state"]).keys() == want.keys() and all(
            _same_bits(got[k], want[k]) for k in want)
        for opt in reps.optimizers[1:])


@pytest.mark.parametrize("route", ["full", "minibatch"])
def test_resume_over_replicas_starts_every_replica_from_the_state(
        route, dp_setup, tmp_path, monkeypatch):
    """A run resumed over replicas from Adam state made elsewhere: the
    full-graph ``Trainer.fit(params, opt_state)`` over 2 CPU replicas
    (``replica_layout`` stubbed, as a mesh over 2 cards lays out), and the
    minibatch trainer over 4 resuming a checkpoint of a one-replica run,
    its replicas built at the first step after the restore. After the
    resumed steps every replica's parameters and Adam state equal replica
    0's bit for bit, and (minibatch) the parameters equal the same resume
    on one replica (rtol 1e-4 / atol 1e-6, PARAM_TOL)."""
    if route == "full":
        data, init, *_ = dp_setup
        cfg = TrainConfig(lr=1e-3, batch_size=32, epochs=1)
        mesh = make_mesh(dp=4, devices=["cpu"] * 4)
        model = BiGNN(BiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2))
        src = Trainer(model, data, cfg, device="cpu", mesh=mesh)
        src.model.load_state_dict(init)
        src.train_step(*_dp_batches(data)[0], 0, 0)
        state = optimizer_state(src.optimizer, src.model)
        monkeypatch.setattr(port_dp, "replica_layout",
                            lambda mesh: ([CPU] * 2, [0, 0, 1, 1]))
        tr = Trainer(BiGNN(BiGNNConfig.full_bignn(feat_dim=8, dim=16,
                                                  heads=2)),
                     data, cfg, device="cpu", mesh=mesh)
        tr.fit(src.params(), state)
        reps = tr._step.replicas
    else:
        ds = make_synthetic_ddi(num_drugs=60, feat_dim=8, avg_degree=6.0,
                                min_atoms=4, max_atoms=10, seed=2)
        _device_trainer(ds, False).fit(
            steps_per_epoch=2, ckpt=CheckpointManager(str(tmp_path / "src")))
        runs = []
        for replicas in (False, True):  # each resumes its own copy
            run_dir = tmp_path / f"resume{int(replicas)}"
            shutil.copytree(tmp_path / "src", run_dir)
            tr = _device_trainer(ds, replicas, epochs=2)
            tr.fit(steps_per_epoch=2, ckpt=CheckpointManager(str(run_dir)))
            runs.append(tr)
        # the parameters after the resumed steps (fit's end loads the best)
        one, last = (CheckpointManager(str(tmp_path / f"resume{i}"))
                     .restore_state()["params"] for i in (0, 1))
        for name, p in last.items():
            np.testing.assert_allclose(p.numpy(), one[name].numpy(),
                                       **PARAM_TOL, err_msg=name)
        reps = runs[1]._reps
        assert len(reps) == 4
    if route == "full":  # the one epoch is the best: fit ends on its state
        last = tr.params()
    assert reps.models[0] is tr.model and len(reps) > 1
    assert all(_same_bits(_state(m), last) for m in reps.models[1:])
    assert _same_adam(reps)


# ---------------------------------------------------------------------------
# run's spread over cards, make_exchange's route
# ---------------------------------------------------------------------------


def _cards(n):
    return [torch.device("cuda", i) for i in range(n)]


@pytest.mark.parametrize("n,cards,want", [
    (4, 4, [0, 1, 2, 3]), (8, 4, [0, 0, 1, 1, 2, 2, 3, 3]),
    (2, 4, [0, 1]), (1, 4, [0]), (4, 1, [0, 0, 0, 0]),
    (6, 4, [0, 0, 1, 1, 2, 2]), (4, 2, [0, 0, 1, 1])])
def test_spread_devices(n, cards, want):
    assert spread_devices(n, _cards(cards)) == [_cards(4)[i] for i in want]


class _Stop(Exception):
    pass


@pytest.mark.parametrize("argv,kind,devices", [
    (["--config", "config1", "--dp", "4"], "dp", _cards(4)),
    (["--config", "config1", "--dp", "8"], "dp",
     [c for c in _cards(4) for _ in range(2)]),
    (["--config", "config1", "--dp", "2", "--device", "cuda:3"], "dp",
     [torch.device("cuda", 3)] * 2),
    (["--config", "config5", "--graph-shards", "4"], "p2", _cards(4)),
    (["--config", "config5", "--graph-shards", "2"], "p2", _cards(2)),
], ids=["dp4", "dp8", "dp2-one-card", "p2-4", "p2-2"])
def test_run_spreads_shards_over_cards(monkeypatch, argv, kind, devices):
    """``run`` with 4 cards stubbed: ``--dp N`` and p2's shards laid over
    them by ``spread_devices``; the run is stopped at its mesh, before
    anything touches a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(run, "load_dataset", lambda *a, **k: (
        make_synthetic_ddi(num_drugs=30, feat_dim=16, avg_degree=4.0,
                           min_atoms=4, max_atoms=8, seed=0)))
    seen = []

    def stop(*a, mesh=None, devices=None, **k):
        seen.append(make_mesh(*a, devices=devices, **k) if mesh is None
                    else mesh)
        raise _Stop

    if kind == "dp":
        monkeypatch.setattr(run, "Trainer", stop)
        monkeypatch.setattr(run, "prepare_device_data", lambda *a, **k: None)
    else:
        monkeypatch.setattr(run, "make_mesh", stop)
    with pytest.raises(_Stop):
        run.main(argv)
    mesh = seen[0]
    assert list(mesh.devices.flat) == devices


def test_make_exchange_route_by_peer_access(monkeypatch):
    """Across processes of one host on distinct cards: ``PeerExchange``
    where every pair has peer access, ``ProcessExchange`` where one lacks
    it; in one process over distinct cards, ``CardExchange``."""
    built = []
    for name in ("PeerExchange", "ProcessExchange"):
        monkeypatch.setattr(comm, name, lambda *a, _n=name: built.append(_n))
    monkeypatch.setattr(comm, "host_names", lambda: ["h0", "h0"])
    monkeypatch.setattr(comm, "all_gather_object", lambda obj: [obj, obj])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    devices = np.array([[torch.device("cuda", 0), torch.device("cuda", 1)]],
                       dtype=object)
    mesh = Mesh(devices, ("dp", "graph"), np.array([[0, 1]]))
    for access, route in ((True, "PeerExchange"), (False, "ProcessExchange")):
        monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                            lambda a, b, _v=access: _v)
        make_exchange(mesh)
        assert built[-1] == route
    monkeypatch.setattr(comm, "enable_peer_access", lambda cards: None)
    ex = make_exchange(make_mesh(dp=1, graph=4, devices=_cards(4)))
    assert isinstance(ex, CardExchange) and ex.cards == _cards(4)
    assert make_exchange(make_mesh(dp=1, graph=4,
                                   devices=["cuda:0"] * 4)) is None


def test_peer_access_once_a_pair_or_an_error(monkeypatch):
    """Each ordered pair of distinct cards enabled once a process; a pair
    without peer access raises, naming it (no route through the host).
    The runtime call is stubbed: nothing touches a card."""
    from bignn_tpu_torch.ops import collectives, cuda_lib

    calls = []
    monkeypatch.setattr(collectives, "_peer_pairs", set())
    monkeypatch.setattr(cuda_lib, "call", lambda name, dev, peer:
                        calls.append((name, dev.index, peer)))
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: True)
    collectives.enable_peer_access(_cards(3))
    collectives.enable_peer_access(_cards(3))
    assert sorted(c[1:] for c in calls) == [
        (a, b) for a in range(3) for b in range(3) if a != b]
    assert {c[0] for c in calls} == {"bignn_enable_peer_access"}
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: (a, b) != (3, 1))
    with pytest.raises(RuntimeError, match="cuda:3 has no peer access to "
                       "cuda:1"):
        collectives.enable_peer_access(_cards(4))


class _OnCard:
    """A CPU tensor that says it lies on ``device`` (what
    ``all_to_all_cards`` reads of a send buffer), its allocations traced."""

    def __init__(self, t: torch.Tensor, device, trace: list):
        self.t, self.device, self.trace = t, torch.device(device), trace
        self.shape, self.dtype = t.shape, t.dtype

    def __getitem__(self, i):
        return self.t[i]

    def element_size(self):
        return self.t.element_size()

    def data_ptr(self):
        return self.t.data_ptr()

    def new_empty(self, shape):
        self.trace.append(("alloc", str(self.device)))
        return _OnCard(self.t.new_empty(shape), self.device, self.trace)


def _stub_card_runtime(monkeypatch, trace: list) -> list:
    """``cuda_lib.call`` stubbed on the CPU: signal areas and error words in
    host memory, and ``bignn_all_to_all_sync`` done by ``ctypes.memmove``
    on each local card's pairs (the CPU tensors' pointers), each card's
    launch traced with its rows and cols; every synchronisation or
    event of ``torch.cuda`` traced. Returns the host buffers."""
    import ctypes

    from bignn_tpu_torch.ops import collectives, cuda_lib

    keep = []

    def call(name, dev, *args):
        if name == "bignn_all_to_all_sync":
            return launch(*args)
        if name == "bignn_enable_peer_access":
            return
        buf = ctypes.create_string_buffer(collectives.signal_bytes(4))
        keep.append(buf)
        if name == "bignn_ipc_alloc":
            args[2]._obj.value = ctypes.addressof(buf)
        elif name == "bignn_host_alloc":
            args[1]._obj.value = args[2]._obj.value = ctypes.addressof(buf)

    def launch(send, recv, g, card_of, chunk, areas, cards, n_local, me,
               devices, streams, error, timeout, tables):
        assert cards == n_local == 4 and list(me) == list(devices)
        assert list(card_of) == [i * 4 // g for i in range(g)]
        # past INLINE_SHARDS the kernel reads the pointers from each card's
        # table (csrc/all_to_all.cu Table): send[G], recv[G], card_of[G],
        # the card's shards, the signal areas
        assert (tables is None) == (g <= collectives.INLINE_SHARDS)
        for k in range(n_local):
            own = [s for s in range(g) if card_of[s] == me[k]]
            srcs = [send[k * g + i] for i in range(g)]
            dsts, rows, cols = list(recv), own, list(range(g))
            if tables is not None:
                w = list((ctypes.c_int64 * (3 * g + len(own) + cards))
                         .from_address(tables[k]))
                srcs, dsts = w[:g], w[g:2 * g]
                assert w[2 * g:3 * g] == list(card_of)
                rows = w[3 * g:3 * g + len(own)]
                assert w[3 * g + len(own):] == list(
                    areas[k * cards:(k + 1) * cards])
            trace.append(("launch", f"cuda:{devices[k]}", rows, cols))
            for j in rows:
                for i in cols:
                    ctypes.memmove(dsts[j] + i * chunk,
                                   srcs[i] + j * chunk, chunk)

    monkeypatch.setattr(collectives, "_barriers", {})
    monkeypatch.setattr(collectives, "_peer_pairs", set())
    monkeypatch.setattr(cuda_lib, "call", call)
    # the tables stay in host memory: the stub's launch reads them there
    monkeypatch.setattr(collectives, "_table", lambda words, dev: torch.tensor(
        list(words), dtype=torch.int64))
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: True)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    for name in ("synchronize", "Event", "stream", "set_sync_debug_mode"):
        monkeypatch.setattr(torch.cuda, name,
                            lambda *a, _n=name, **k: trace.append((_n,)))
    monkeypatch.setattr(torch.Tensor, "item",
                        lambda self: trace.append(("item",)))
    return keep


@pytest.mark.parametrize("g,dtype", [(4, torch.float32), (8, torch.float32),
                                     (8, torch.bfloat16), (4, torch.int16),
                                     (64, torch.float32)])
def test_cards_exchange_launches_without_host_sync(monkeypatch, g, dtype):
    """``all_to_all_cards`` over 4 cards (a shard or two a card; at 64
    shards, 16 a card, each launch's pointers in its table), with the
    runtime stubbed: every receive buffer allocated before the launches,
    one launch a card, all in one host call, and no synchronisation, event
    or host read anywhere (the semaphores are on the cards); each launch's
    pairs (its destinations x every source) done by a CPU copy give
    ``all_to_all_plain`` exactly. A wait that expired on a card raises at
    the next exchange over the cards, and where the run ends
    (``CardExchange.close``, after it synchronises them), naming the card
    waited on."""
    from bignn_tpu_torch.ops import collectives

    trace = []
    _stub_card_runtime(monkeypatch, trace)
    gen = torch.Generator().manual_seed(g)
    host = [(100 * torch.randn(g, 3, 5, generator=gen)).to(dtype)
            for _ in range(g)]
    cards = [f"cuda:{i * 4 // g}" for i in range(g)]
    got = collectives.all_to_all_cards(
        [_OnCard(h, c, trace) for h, c in zip(host, cards)])
    for a, b in zip(got, collectives.all_to_all_plain(host)):
        assert torch.equal(a.t, b)
    kinds = [t[0] for t in trace]
    assert kinds == ["alloc"] * g + ["launch"] * 4, trace
    own = [[j for j in range(g) if cards[j] == f"cuda:{k}"] for k in range(4)]
    for k, (_, dev, rows, cols) in enumerate(trace[g:]):
        assert dev == f"cuda:{k}"
        assert (rows, cols) == (own[k], list(range(g)))
    distinct = [torch.device(c) for c in dict.fromkeys(cards)]
    barrier = collectives.card_barrier(distinct)
    barrier._words[2] = (1 << 30) | 4  # cuda:2 waited for cuda:3 to arrive
    expired = "all_to_all on cuda:2 waited past 120 s for cuda:3 to arrive"
    with pytest.raises(RuntimeError, match=expired):
        collectives.all_to_all_cards(
            [_OnCard(h, c, trace) for h, c in zip(host, cards)])
    exchange = CardExchange(distinct)
    trace.clear()
    with pytest.raises(RuntimeError, match=expired):
        exchange.close()
    assert trace == [("synchronize",)] * 4


# ---------------------------------------------------------------------------
# the JAX helpers the port keeps its own copies of
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ratio", [1, 3])
def test_make_training_pairs_matches_jax(ratio):
    pos = np.random.default_rng(1).integers(0, 50, (37, 2)).astype(np.int32)
    want_p, want_l = jax_training_pairs(jax.random.key(7), jnp.asarray(pos),
                                        50, ratio)
    got_p, got_l = make_training_pairs(prng.key(7), torch.from_numpy(pos),
                                       50, ratio)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    assert got_l.dtype == torch.float32
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


def test_epoch_prefetcher_matches_jax():
    """The same batches in the same order from a stateful draw, and an
    exception in the thread re-raised in the consumer."""
    def draws():
        rng = np.random.default_rng(3)
        return lambda: rng.integers(0, 100, 5)

    want = list(JaxEpochPrefetcher(draws(), 7, depth=2))
    got = list(EpochPrefetcher(draws(), 7, depth=2))
    assert len(got) == 7 and all(map(np.array_equal, got, want))

    def bad():
        raise KeyError("draw")

    with pytest.raises(KeyError, match="draw"):
        list(EpochPrefetcher(bad, 3))


@pytest.mark.parametrize("lib", ["native", "numpy"])
def test_native_degree_and_hash_match_jax(monkeypatch, lib):
    rng = np.random.default_rng(5)
    src = rng.integers(0, 300, 2000).astype(np.int32)
    dst = rng.integers(0, 300, 2000).astype(np.int32)
    if lib == "numpy":  # both packages' fallbacks
        monkeypatch.setattr(native, "_load", lambda: None)
        monkeypatch.setattr(jax_native, "_load", lambda: None)
    else:
        assert native.available()
    for n_parts in (1, 4, 7):
        want = jax_native.partition_edges_hash(src, dst, n_parts)
        got = native.partition_edges_hash(src, dst, n_parts)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, native.partition_edges_hash(dst, src, n_parts))
    got = native.in_degrees(dst, 300)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jax_native.in_degrees(dst, 300))
