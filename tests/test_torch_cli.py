"""The port's entry points against the JAX package's on the CPU
(``--device cpu``): the ``run`` CLI (full, minibatch with ``--exact-eval``,
p2), checkpoints and exact resume, the ``serve`` CLI, the JAX-checkpoint
converter, and raw-cache conversion.

* ``run.main`` on config1 (2 epochs, batch 256) against JAX's: per-epoch
  losses at rtol 1e-4, the final test AUC within 1e-3; the p2 loop on
  tests/test_run_cli.py's tiny config5 with 4 shards (JAX on its 8 fake CPU
  devices, so dp 2; the port on ``cpu`` named 4 times, dp 1: the same
  global masked mean): losses at rtol 1e-4, the same best epoch.
* A run killed after one epoch and started again resumes to the
  uninterrupted result; ``serve.main`` on its checkpoint gives a hand-built
  ``Scorer``'s scores bit for bit.
* ``scripts/convert_jax_checkpoint.py`` turns a JAX checkpoint into one the
  port serves with the JAX ``Scorer``'s scores (rtol 2e-4 / atol 2e-5) and
  resumes with optax's Adam state (``optax.adam``, ``optax.adamw``, either
  behind ``clip_by_global_norm``): a JAX run checkpointed after its first
  epoch and resumed to 3 epochs against the port's resume of the
  conversion (full and p2 modes, at ``test_run_full_matches_jax``'s and
  ``test_run_p2_matches_jax``'s bounds); the converted moments and step
  count exactly JAX's, and one step from them JAX's step
  (``MinibatchTrainer``, tests/test_torch_minibatch.py's bounds). A state
  without optimizer state (one written by hand) still refuses to resume.
* ``data/convert.py`` gives the JAX converter's arrays, and ``load_dataset``
  converts a raw cache once.
"""

import dataclasses
import importlib.util
import json
import os
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bignn_tpu.config as jax_config_module
from bignn_tpu import ops as jax_ops
from bignn_tpu.config import ExperimentConfig as JaxExperimentConfig
from bignn_tpu.config import get_config as jax_get_config
from bignn_tpu.data.convert import (
    convert_reference_cache as jax_convert_reference_cache,
)
from bignn_tpu.data.datasets import load_dataset as jax_load_dataset
from bignn_tpu.models import BiGNN as JaxBiGNN
from bignn_tpu.models import BiGNNConfig as JaxBiGNNConfig
from bignn_tpu.run import _run_p2 as jax_run_p2
from bignn_tpu.run import main as jax_main
from bignn_tpu.serve import Scorer as JaxScorer
from bignn_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from bignn_tpu.train.trainer import MinibatchTrainer as JaxMinibatchTrainer
from bignn_tpu.train.trainer import TrainConfig as JaxTrainConfig
from bignn_tpu.train.trainer import _fit_state as jax_fit_state
from bignn_tpu.utils import MetricLogger as JaxMetricLogger

from bignn_tpu_torch import bridge, run, serve
from bignn_tpu_torch.config import ExperimentConfig, TrainConfig, get_config
from bignn_tpu_torch.data import load_dataset, prepare_device_data
from bignn_tpu_torch.data.convert import convert_reference_cache
from bignn_tpu_torch.models import BiGNN, BiGNNConfig
from bignn_tpu_torch.serve import Scorer
from bignn_tpu_torch.train import CheckpointManager, MinibatchTrainer, Trainer
from bignn_tpu_torch.train.trainer import load_optimizer_state
from bignn_tpu_torch.utils import MetricLogger

TOL = dict(rtol=2e-4, atol=2e-5)
REPO = Path(__file__).resolve().parents[1]
CONFIG1 = ["--config", "config1", "--epochs", "2", "--batch-size", "256"]
TINY_DATA = dict(num_drugs=40, feat_dim=8, avg_degree=6.0, min_atoms=4,
                 max_atoms=8)  # tests/test_run_cli.py's p2 config


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors (see
    tests/test_torch_minibatch.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _losses(result):
    return [r["loss"] for r in result["history"]]


def _port(argv):
    return run.main([*argv, "--device", "cpu"])


# ---------------------------------------------------------------------------
# run: the full-graph mode, checkpoints, resume, serve
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def config1_run(tmp_path_factory):
    """config1 through both runners; the port's with a checkpoint every
    epoch."""
    run_dir = tmp_path_factory.mktemp("config1")
    ref = jax_main(CONFIG1)
    got = _port([*CONFIG1, "--run-dir", str(run_dir),
                 "--checkpoint-every", "1"])
    return run_dir, got, ref


def test_run_full_matches_jax(config1_run):
    run_dir, got, ref = config1_run
    np.testing.assert_allclose(_losses(got), _losses(ref), rtol=1e-4)
    np.testing.assert_allclose(got["test_auc"], ref["test_auc"], atol=1e-3)
    assert got["best_epoch"] == ref["best_epoch"]
    records = [json.loads(line) for line in
               (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["event"] for r in records if "event" in r] == ["dataset",
                                                             "done"]
    assert [r["epoch"] for r in records if "epoch" in r] == [0, 1]
    summary = json.loads((run_dir / "result.json").read_text())
    assert summary == {k: v for k, v in got.items() if k != "history"}
    assert CheckpointManager(str(run_dir / "ckpt")).steps() == [0, 1]


def test_run_resumes_exactly(config1_run, tmp_path):
    """Killed after epoch 0, the same command with 2 epochs trains epoch 1
    alone and ends where the uninterrupted run ended; run again, it trains
    no epoch and reports the same."""
    _, want, _ = config1_run
    argv = [*CONFIG1, "--run-dir", str(tmp_path), "--checkpoint-every", "1"]
    first = _port([*argv, "--epochs", "1"])
    assert _losses(first) == _losses(want)[:1]
    resumed = _port(argv)
    assert [r["epoch"] for r in resumed["history"]] == [1]
    assert _losses(resumed) == _losses(want)[1:]
    again = _port(argv)
    assert again["history"] == []
    for res in (resumed, again):
        assert res["best_epoch"] == want["best_epoch"]
        assert res["test_auc"] == want["test_auc"]


@pytest.fixture(scope="module")
def hand_scorer(config1_run):
    run_dir, _, _ = config1_run
    cfg = get_config("config1")
    ds = load_dataset(cfg.dataset, **cfg.dataset_kwargs)
    state = CheckpointManager(str(run_dir / "ckpt")).restore_state()
    return Scorer(BiGNN(dataclasses.replace(cfg.model, feat_dim=ds.feat_dim)),
                  ds, state["best_params"], device="cpu")


@pytest.mark.parametrize("topk", ["42", "42,7"])
def test_serve_topk_equals_scorer(config1_run, hand_scorer, topk, capsys):
    run_dir, _, _ = config1_run
    ids, scores = serve.main(["--config", "config1", "--ckpt",
                              str(run_dir / "ckpt"), "--topk", topk, "--k",
                              "20", "--exclude-known", "--device", "cpu"])
    drugs = [int(d) for d in topk.split(",")]
    want_ids, want = hand_scorer.top_k_batch(drugs, 20, exclude_known=True)
    if len(drugs) == 1:
        want_ids, want = want_ids[0], want[0]
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(scores, want)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["drug"] == (drugs[0] if len(drugs) == 1 else drugs)
    assert line["candidates"] == ids.tolist()


def test_serve_pairs_equal_scorer(config1_run, hand_scorer, tmp_path):
    run_dir, _, _ = config1_run
    pairs = np.random.default_rng(3).integers(0, 500, (300, 2))
    np.save(tmp_path / "pairs.npy", pairs)
    scores = serve.main(["--config", "config1", "--ckpt",
                         str(run_dir / "ckpt"), "--pairs",
                         str(tmp_path / "pairs.npy"), "--out",
                         str(tmp_path / "scores.npy"), "--device", "cpu"])
    want = hand_scorer.score_pairs(pairs)
    np.testing.assert_array_equal(scores, want)
    np.testing.assert_array_equal(np.load(tmp_path / "scores.npy"), want)


# ---------------------------------------------------------------------------
# run: the minibatch and p2 modes, on tiny configs
# ---------------------------------------------------------------------------


def _tiny(name, **kw):
    """A registry config cut to tiny sizes, for either package."""
    cfg = (jax_get_config if kw.pop("jax", False) else get_config)(name)
    model = dataclasses.replace(
        cfg.model, feat_dim=8, inner_layers=("gin:16",),
        outer_layers=("gat:16:2",))
    return dataclasses.replace(
        cfg, dataset="synthetic-small", dataset_kwargs=dict(TINY_DATA),
        model=model, train=dataclasses.replace(cfg.train, lr=1e-3,
                                               batch_size=32, **kw))


def test_run_minibatch_exact_eval(monkeypatch, tmp_path):
    cfg = dataclasses.replace(_tiny("config3", epochs=1), fanouts=(4,))
    monkeypatch.setattr(run, "get_config", lambda name: cfg)
    res = _port(["--config", "config3", "--exact-eval", "--run-dir",
                 str(tmp_path)])
    for k in ("exact_val_auc", "exact_val_ap", "exact_test_auc",
              "exact_test_ap"):
        assert np.isfinite(res[k]), res
    records = [json.loads(line) for line in
               (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert any(r.get("event") == "exact_eval" for r in records)


def test_run_p2_matches_jax(monkeypatch, tmp_path):
    """tests/test_run_cli.py's tiny config5 (4 shards), 2 epochs: the port
    through ``run.main`` (``--halo-impl pallas`` runs its one exchange),
    JAX through its ``_run_p2``."""
    jcfg = _tiny("config5", epochs=2, jax=True)
    jds = jax_load_dataset(jcfg.dataset, **jcfg.dataset_kwargs)
    jmodel = JaxBiGNN(dataclasses.replace(jcfg.model, feat_dim=jds.feat_dim))
    _, want = jax_run_p2(jmodel, jds, jcfg, JaxMetricLogger(stdout=False))
    monkeypatch.setattr(run, "get_config",
                        lambda name: _tiny("config5", epochs=2))
    got = _port(["--config", "config5", "--halo-impl", "pallas",
                 "--run-dir", str(tmp_path)])
    np.testing.assert_allclose(_losses(got), _losses(want), rtol=1e-4)
    assert got["best_epoch"] == want["best_epoch"]
    assert np.isfinite(got["final_loss"])
    np.testing.assert_allclose(got["test_auc"], want["test_auc"], atol=1e-3)
    records = [json.loads(line) for line in
               (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert any("ops.all_to_all" in r.get("msg", "") for r in records)
    assert {"event": "mesh", "dp": 1, "graph": 4, "processes": 1}.items() \
        <= next(r for r in records if r.get("event") == "mesh").items()


@pytest.mark.parametrize("argv,error", [
    (["--dp", "2"], None),
    (["--num-processes", "1"], None),
    (["--coordinator", "localhost:1234"], "without a process count"),
    (["--coordinator", "localhost:1234", "--num-processes", "2",
      "--process-id", "2"], "outside"),
])
def test_run_refuses_what_waits(config1_run, tmp_path, argv, error):
    """``--dp 2`` runs config1 on a mesh that names the CPU twice, and
    ``--num-processes 1`` in one process, each with the trajectory of the
    run without it; a coordinator without a process count, or a process id
    out of range, raises ``ValueError`` before anything connects (the
    multi-process run itself: tests/test_torch_multihost.py)."""
    if error is not None:
        with pytest.raises(ValueError, match=error):
            _port(["--config", "config1", *argv])
        return
    _, want, _ = config1_run
    got = _port([*CONFIG1, *argv, "--run-dir", str(tmp_path)])
    np.testing.assert_allclose(_losses(got), _losses(want), rtol=1e-5)
    assert got["best_epoch"] == want["best_epoch"]
    np.testing.assert_allclose(got["test_auc"], want["test_auc"], atol=1e-6)
    records = [json.loads(line) for line in
               (tmp_path / "metrics.jsonl").read_text().splitlines()]
    mesh = [r for r in records if r.get("event") == "mesh"]
    if "--dp" in argv:
        assert {"event": "mesh", "dp": 2, "graph": 1}.items() <= \
            mesh[0].items()
    else:
        assert mesh == []  # no mesh: the single-device Trainer


def test_run_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--config", "config1"])


# ---------------------------------------------------------------------------
# scripts/convert_jax_checkpoint.py
# ---------------------------------------------------------------------------


def _converter():
    spec = importlib.util.spec_from_file_location(
        "convert_jax_checkpoint", REPO / "scripts/convert_jax_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _serve_cfg(cls, cfg_cls, train_cls):
    return cfg_cls(name="tiny", dataset="synthetic-small",
                   dataset_kwargs=dict(TINY_DATA),
                   model=cls.full_bignn(feat_dim=8, dim=16, heads=2),
                   train=train_cls(batch_size=32, epochs=1))


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """A JAX checkpoint of a tiny model (params of key 0, best params of
    key 1, Adam state), and its conversion."""
    root = tmp_path_factory.mktemp("jaxckpt")
    jcfg = _serve_cfg(JaxBiGNNConfig, JaxExperimentConfig, JaxTrainConfig)
    jmodel = JaxBiGNN(jcfg.model)
    params, best = (jmodel.init(jax.random.key(s)) for s in (0, 1))
    mgr = JaxCheckpointManager(str(root / "jax"))
    mgr.save_state(3, jax_fit_state(
        params, optax.adam(1e-3).init(params),
        {"val_auc": 0.625, "params": best, "epoch": 2}, 3))
    mgr.close()
    assert _converter().main([str(root / "jax"), str(root / "port")]) == 3
    return root, jcfg


@pytest.mark.parametrize("use_best", [True, False], ids=["best", "last"])
def test_converted_checkpoint_serves_jax_scores(converted, use_best):
    root, jcfg = converted
    state = CheckpointManager(str(root / "port")).restore_state(3)
    adam = state["opt_state"]
    assert adam.keys() == state["params"].keys()
    for name, p in state["params"].items():
        assert adam[name]["exp_avg"].shape == p.shape
        assert float(adam[name]["step"]) == 0.0
    assert state["meta"] == {"epoch": 3, "best_val_auc": 0.625,
                             "best_epoch": 2}
    cfg = _serve_cfg(BiGNNConfig, ExperimentConfig, TrainConfig)
    got = Scorer.from_checkpoint(cfg, str(root / "port"), use_best=use_best,
                                 device="cpu")
    want = JaxScorer.from_checkpoint(jcfg, str(root / "jax"),
                                     use_best=use_best)
    pairs = np.random.default_rng(5).integers(0, 40, (64, 2))
    np.testing.assert_allclose(got.score_pairs(pairs),
                               want.score_pairs(pairs), **TOL)


@pytest.mark.parametrize("mode", ["full", "minibatch", "p2"])
def test_resume_from_converted_checkpoint_raises(converted, tmp_path, mode):
    """A state without optimizer state (the conversion with it taken out,
    as a hand-written state would lack it) serves but no trainer resumes
    from it."""
    root, _ = converted
    state = CheckpointManager(str(root / "port")).restore_state(3)
    del state["opt_state"]
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save_state(3, state)
    cfg = _serve_cfg(BiGNNConfig, ExperimentConfig, TrainConfig)
    ds = load_dataset(cfg.dataset, **cfg.dataset_kwargs)
    model = BiGNN(cfg.model)
    with pytest.raises(ValueError, match="no optimizer state"):
        if mode == "full":
            Trainer(model, prepare_device_data(ds), cfg.train,
                    device="cpu").fit(ckpt=ckpt)
        elif mode == "minibatch":
            MinibatchTrainer(model, ds, cfg.train, fanouts=(4,),
                             calibrate_caps=2, device="cpu").fit(ckpt=ckpt)
        else:
            run._run_p2(model, ds, dataclasses.replace(cfg, graph_shards=2),
                        MetricLogger(stdout=False), ckpt=ckpt,
                        device="cpu")


# train overrides of the three optimizer stacks (JAX make_optimizer)
OPTIMIZERS = {"adam": {}, "adamw": dict(weight_decay=1e-2),
              "clip": dict(grad_clip=0.1)}
# each optimizer stack's state held exactly, and its next step, in
# minibatch mode; the whole resumed run in full and p2 modes under adam
RESUME_CASES = [("full", "adam"), ("p2", "adam"), ("minibatch", "adam"),
                ("minibatch", "adamw"), ("minibatch", "clip")]


def _resume_run(monkeypatch, tmp_path, mode: str, opt: str) -> None:
    """A JAX ``run.main`` checkpointed after epoch 0 and resumed to 3
    epochs; the port's ``run.main`` on the conversion of that checkpoint,
    to 3 epochs: the same epochs, losses at rtol 1e-4, best epoch, test
    AUC within 1e-3."""
    name = {"full": "config1", "p2": "config5"}[mode]
    kw = OPTIMIZERS[opt]
    jax_dir, run_dir = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(jax_config_module, "get_config",
                        lambda n: _tiny(name, jax=True, **kw))
    argv = ["--config", name, "--checkpoint-every", "1"]
    jax_main([*argv, "--epochs", "1", "--run-dir", str(jax_dir)])
    assert _converter().main([str(jax_dir / "ckpt"),
                              str(run_dir / "ckpt")]) == 0
    want = jax_main([*argv, "--epochs", "3", "--run-dir", str(jax_dir)])
    monkeypatch.setattr(run, "get_config", lambda n: _tiny(name, **kw))
    got = _port([*argv, "--epochs", "3", "--run-dir", str(run_dir)])
    assert [r["epoch"] for r in got["history"]] == [
        r["epoch"] for r in want["history"]] == [1, 2]
    np.testing.assert_allclose(_losses(got), _losses(want), rtol=1e-4)
    assert got["best_epoch"] == want["best_epoch"]
    np.testing.assert_allclose(got["test_auc"], want["test_auc"], atol=1e-3)


def _jax_leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _jax_leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _resume_minibatch(tmp_path, opt: str) -> None:
    """Two JAX steps, checkpointed and converted: every parameter's
    ``exp_avg``/``exp_avg_sq`` in the port's optimizer equals JAX's
    ``mu``/``nu`` exactly, with the parameter's own transposition (leaves
    matched by the parameters' values, not through the converter's
    names), each ``step`` JAX's ``count`` in a tensor of its own. Then the
    third step from it on the same host-drawn batch, at
    tests/test_torch_minibatch.py's bounds (rtol 2e-4 / atol 2e-5 x max):
    the port's loss and gradients (clipped, under the clip) against JAX's,
    and the port's update of JAX's gradients from the converted state
    against optax's update of the same gradients from JAX's state. The
    update is held on one set of gradients because GAT's ``a_l`` gradient
    cancels to rounding noise, which Adam's first steps scale to ~lr
    whatever its size."""
    from bignn_tpu_torch.parallel import Replicas

    kw = OPTIMIZERS[opt]
    jcfg = dataclasses.replace(_tiny("config3", jax=True, **kw),
                               fanouts=(4,))
    cfg = dataclasses.replace(_tiny("config3", **kw), fanouts=(4,))
    jds = jax_load_dataset(jcfg.dataset, **jcfg.dataset_kwargs)
    jtr = JaxMinibatchTrainer(JaxBiGNN(jcfg.model), jds, jcfg.train,
                              fanouts=jcfg.fanouts, calibrate_caps=2)
    params, opt_state = jtr.init()

    def batch(sampler, i):
        return sampler.sample_compact_at(0, i)

    with jax_ops.backend_scope("xla"):
        for i in range(2):
            params, opt_state, _ = jtr.train_step(
                params, opt_state,
                jax.tree.map(jnp.asarray, batch(jtr.sampler, i)))
        mgr = JaxCheckpointManager(str(tmp_path / "jax"))
        mgr.save_state(0, jax_fit_state(
            params, opt_state, {"val_auc": 0.5, "params": params,
                                "epoch": 0}, 0))
        mgr.close()
        assert _converter().main([str(tmp_path / "jax"),
                                  str(tmp_path / "port")]) == 0
        jcb = jax.tree.map(jnp.asarray, batch(jtr.sampler, 2))
        want_loss, jgrads = jax.jit(jax.value_and_grad(jtr._loss))(
            params, jcb, jtr.tables)
    # JAX's step on these gradients (its train_step recomputes them, and
    # GAT's a_l gradient, which cancels, to other noise)
    updates, _ = jax.jit(jtr.optimizer.update)(jgrads, opt_state, params)
    want_params = optax.apply_updates(params, updates)
    adam = opt_state[-1] if opt == "clip" else opt_state
    adam = adam[0]  # ScaleByAdamState, first in adam's and adamw's chains
    ds = load_dataset(cfg.dataset, **cfg.dataset_kwargs)
    tr = MinibatchTrainer(BiGNN(cfg.model), ds, cfg.train,
                          fanouts=cfg.fanouts, calibrate_caps=2,
                          device="cpu")
    ckpt = CheckpointManager(str(tmp_path / "port"))

    def restore():
        state = ckpt.restore_state()
        tr.model.load_state_dict(state["params"])
        load_optimizer_state(tr.optimizer, tr.model, state["opt_state"])

    restore()
    ported = [(p.detach(), tr.optimizer.state[p])
              for p in tr.model.parameters()]
    assert len({id(s["step"]) for _, s in ported}) == len(ported)
    mus, nus = dict(_jax_leaves(adam.mu)), dict(_jax_leaves(adam.nu))
    for path, value in _jax_leaves(params):
        hits = [(p, s, False) for p, s in ported
                if p.shape == value.shape and np.array_equal(p, value)]
        if value.ndim == 2:
            hits += [(p, s, True) for p, s in ported
                     if p.shape == value.shape[::-1]
                     and np.array_equal(p, value.T)]
        assert len(hits) == 1, (path, len(hits))
        p, s, transposed = hits[0]
        t = (lambda a: a.T) if transposed else (lambda a: a)
        np.testing.assert_array_equal(s["exp_avg"].numpy(), t(mus[path]))
        np.testing.assert_array_equal(s["exp_avg_sq"].numpy(), t(nus[path]))
        assert s["step"].dtype == torch.float32
        assert float(s["step"]) == int(adam.count) == 2
        assert s["exp_avg"].device == p.device

    def close(name, got, want):
        scale = max(want.abs().max().item(), 1.0)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                                   atol=2e-5 * scale, err_msg=name)

    grads = bridge.params_from_jax(jax.tree.map(np.asarray, jgrads))
    if cfg.train.grad_clip:
        norm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                    for g in grads.values())))
        grads = {k: g * min(1.0, cfg.train.grad_clip / norm)
                 for k, g in grads.items()}
    loss = tr.train_step(batch(tr.sampler, 2))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=2e-4,
                               atol=2e-5)
    for name, p in tr.model.named_parameters():
        close(name, p.grad, grads[name])
    restore()
    named = dict(tr.model.named_parameters())
    raw = bridge.params_from_jax(jax.tree.map(np.asarray, jgrads))
    Replicas(tr.model, tr.optimizer, [tr.device]).update(lambda: sum(
        (p * raw[name]).sum() for name, p in named.items()),
        cfg.train.grad_clip)
    want = bridge.params_from_jax(jax.tree.map(np.asarray, want_params))
    for name, p in named.items():
        close(name, p.detach(), want[name])


@pytest.mark.parametrize("mode,opt", RESUME_CASES,
                         ids=[f"{m}-{o}" for m, o in RESUME_CASES])
def test_resume_from_converted_checkpoint(monkeypatch, tmp_path, mode, opt):
    """A converted JAX checkpoint resumes in each mode and under each
    optimizer stack of JAX's ``make_optimizer``."""
    if mode == "minibatch":
        _resume_minibatch(tmp_path, opt)
    else:
        _resume_run(monkeypatch, tmp_path, mode, opt)


# ---------------------------------------------------------------------------
# data/convert.py
# ---------------------------------------------------------------------------


class Graph:
    """A networkx-like molecule graph: ``nodes()``, ``nodes(data=True)``,
    ``edges()``."""

    def __init__(self, attrs: dict, edges: list):
        self._attrs, self._edges = attrs, edges

    def nodes(self, data: bool = False):
        return list(self._attrs.items()) if data else list(self._attrs)

    def edges(self):
        return list(self._edges)


class Cache:
    """A reference cache pickled as an object with attributes."""

    def __init__(self, **fields):
        self.__dict__.update(fields)


def _graph(rng, attr):
    n = int(rng.integers(3, 8))
    if attr == "feat":
        attrs = {i: {"feat": rng.random(5).astype(np.float32)}
                 for i in range(n)}
    elif attr == "symbol":
        attrs = {i: {"symbol": "CNOS"[int(rng.integers(4))]}
                 for i in range(n)}
    else:
        attrs = {i: {} for i in range(n)}
    edges = [(i, i + 1) for i in range(n - 1)] + [(0, n - 1)]
    return Graph(attrs, edges)


def _write_raw(path: Path, layout: str) -> Path:
    rng = np.random.default_rng(len(layout))
    if layout == "pickle-feat":
        graphs = {f"drug_{i}": _graph(rng, "feat") for i in range(6)}
        ids = sorted(graphs)
        with open(path / "cache.pkl", "wb") as f:
            pickle.dump({"graphs": graphs, "interactions": [
                (ids[0], ids[1]), (ids[1], ids[2]), (ids[3], ids[4]),
                (ids[0], ids[5]), (ids[2], ids[5])]}, f)
        return path / "cache.pkl"
    if layout == "object-smiles":
        with open(path / "cache.pkl", "wb") as f:
            pickle.dump(Cache(graphs={"x": _graph(rng, None),
                                      "y": _graph(rng, None)},
                              edges=[("x", "y")],
                              smiles={"x": "CCO", "y": "CC(=O)O"}), f)
        return path / "cache.pkl"
    # klepto dir_archive: one pickled object per key directory; graphs as
    # a list featurized from their atoms' symbols
    arch = path / "archive"
    for key, obj in (("graphs", [_graph(rng, "symbol") for _ in range(5)]),
                     ("interactions", [(0, 1), (1, 2), (3, 4), (0, 4)])):
        os.makedirs(arch / f"K_{key}")
        with open(arch / f"K_{key}" / "output.pkl", "wb") as f:
            pickle.dump(obj, f)
    return arch


def _assert_same_dataset(got, want):
    assert got.num_drugs == want.num_drugs
    for name in ("edges", "train_idx", "val_idx", "test_idx"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    for a, b in zip(got.molecules, want.molecules):
        np.testing.assert_array_equal(a.node_feat, b.node_feat)
        np.testing.assert_array_equal(a.src, b.src)
        np.testing.assert_array_equal(a.dst, b.dst)


@pytest.mark.parametrize("layout", ["pickle-feat", "object-smiles",
                                    "klepto-symbols"])
def test_convert_matches_jax(tmp_path, layout):
    raw = _write_raw(tmp_path, layout)
    got = convert_reference_cache(str(raw), str(tmp_path / "port.npz"), "t")
    want = jax_convert_reference_cache(str(raw), str(tmp_path / "jax.npz"),
                                       "t")
    _assert_same_dataset(got, want)
    with np.load(tmp_path / "port.npz") as p, np.load(tmp_path / "jax.npz") as j:
        assert sorted(p.files) == sorted(j.files)
        for name in p.files:
            np.testing.assert_array_equal(p[name], j[name], err_msg=name)


def test_load_dataset_converts_raw_cache_once(tmp_path, monkeypatch):
    raw = _write_raw(tmp_path, "pickle-feat")
    os.replace(raw, tmp_path / "biosnap.pkl")
    ds = load_dataset("biosnap", data_root=str(tmp_path))
    assert (tmp_path / "biosnap.npz").exists()
    _assert_same_dataset(ds, jax_load_dataset("biosnap",
                                              data_root=str(tmp_path)))
    import bignn_tpu_torch.data.convert as port_convert

    def refuse(*args, **kwargs):
        raise AssertionError("converted twice")

    monkeypatch.setattr(port_convert, "convert_reference_cache", refuse)
    _assert_same_dataset(load_dataset("biosnap", data_root=str(tmp_path)), ds)
