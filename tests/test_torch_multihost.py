"""The port's multi-process p2 run on the CPU: two real processes in a gloo
process group (``tcp://127.0.0.1:<free port>``), each driving its graph
shards of a ``make_hybrid_mesh`` mesh that names its CPU, as JAX's
tests/test_multihost.py runs two processes of 2 fake CPU devices each.

The worker is this file run as a script (``python
tests/test_torch_multihost.py --worker --port P --rank R --out DIR``); it
imports no JAX. One pair of workers runs every multi-process check in turn
and leaves its results under DIR; the tests read them:

* (a) dp = 2 x graph = 2 over 2 processes, one p2 step of
  tests/_multihost_prog.py's setup: loss and the post-step parameter
  checksum against JAX's own ``run_once()`` at rtol 1e-5, JAX's bound;
  every gradient and parameter against the port's single-process step on
  ``make_mesh(dp=2, graph=2, devices=["cpu"] * 4)`` at TOL and STEP_TOL
  (the gradients' partial sums are added in another order, so the step
  moves a parameter by rounding at most: tests/test_torch_parallel.py's
  bounds; the gradients are held themselves because Adam's step hides a
  gradient off by a constant factor); both workers equal to the bit.
* (b) graph = 4 over 2 processes (2 shards each, so an exchange mixes local
  and remote pairs): the same against the single-process step on 4 shards;
  the exchange across processes (the host route, ``ProcessExchange``), its
  backward and the embedding all-gather's backward exactly against
  ``all_to_all_plain`` over the whole buffers, each process sending
  through gloo only the chunks of the other's shards (the bytes counted).
* (c) ``make_hybrid_mesh``'s layout and errors against JAX's
  (``bignn_tpu/parallel/mesh.py:102-136``), no processes needed.
* (d) ``run.main`` across 2 processes on tests/test_torch_cli.py's tiny
  config5, 2 epochs: epoch losses against the one-process run within
  RUN_RTOL, the same best epoch, test AUC within RUN_AUC, and only process
  0 writing the run dir; a 2-process run stopped after epoch 0 and
  resumed by the same command ends where the straight run ends, bit for
  bit (losses, result, last checkpoint), as tests/test_torch_cli.py's
  one-process resume.
* (e) ``overlap=True`` and ``remat=True`` across 2 processes, as (b).
* (g) one process over 2 "cards" (CPU slots, ``make_cards_train_step``)
  against 2 processes of one shard each: the same bits.
* (h) several cards a process: 2 processes of 2 CPU "card" slots each.
  graph = 4, a shard a slot: the loss, every gradient and the parameters
  equal one process over 4 slots (``make_cards_train_step``) bit for bit;
  the exchange, its backward and the gather onto every slot (its backward
  one term a slot of every process) exactly; and JAX's own topology
  (dp = 2 x graph = 2, 2 devices a process, ``make_hybrid_mesh(devices=
  [cpu, cpu])``) against ``run_once()``.
* (f) ``make_exchange``'s route by the gathered hosts (the gathered list
  set in turn) and cards: ``PeerExchange`` on one card of one host,
  ``ProcessExchange`` across hosts, across cards and on the CPU; and, with no
  processes, ``init_distributed``'s cards for hosts of 2 cards (2 hosts x 2
  processes and 3 + 1) and of 4 (2 processes split them), ``device_count``
  stubbed, and explicit ``local_device_ids``.
"""

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path.insert(0, str(REPO))

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from bignn_tpu_torch import ops, prng, run  # noqa: E402
from bignn_tpu_torch.config import get_config  # noqa: E402
from bignn_tpu_torch.ops.collectives import ProcessExchange  # noqa: E402
from bignn_tpu_torch.data import make_synthetic_ddi  # noqa: E402
from bignn_tpu_torch.models import BiGNN, BiGNNConfig  # noqa: E402
from bignn_tpu_torch.parallel import (  # noqa: E402
    CardExchange,
    build_outer_partition,
    build_sharded_inner,
    device_put_plan,
    gather_rows,
    gather_rows_cards,
    init_distributed,
    make_exchange,
    make_cards_train_step,
    make_hybrid_mesh,
    make_mesh,
    make_p2_train_step,
    mesh as mesh_mod,
    resolve_distributed,
)

TOL = dict(rtol=2e-4, atol=2e-5)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
# run.main over 2 epochs: the step's rounding compounded over its steps
# (measured here: the epoch losses and the test AUC equal to the bit, the
# one-step parameters at most 7.5e-9 apart), so the one-step bound
RUN_RTOL = 1e-5
RUN_AUC = 1e-6
WORKER_TIMEOUT = 240
KW = dict(num_drugs=40, feat_dim=8, avg_degree=6.0, min_atoms=4,
          max_atoms=10, seed=0)  # tests/test_torch_parallel.py's
TINY_DATA = dict(num_drugs=40, feat_dim=8, avg_degree=6.0, min_atoms=4,
                 max_atoms=8)  # tests/test_torch_cli.py's
# name -> (dataset, outer layers or None for config1, dp, graph, overlap,
# remat, init seed, positives seed, masked tail, negatives key, CPU "card"
# slots a process)
CASES = {
    "a": ("multihost", None, 2, 2, False, False, 0, 0, 0, 1),
    # JAX's topology on 2 devices a process: its one shard on the first
    "a_cards": ("multihost", None, 2, 2, False, False, 0, 0, 0, 1, 2),
    # 2 shards a process, a slot each (the same step as "b")
    "slots": ("parallel", ("gin:16", "gat:16:2:identity"), 1, 4, False,
              False, 1, 4, 3, 9, 2),
    "slots_overlap": ("parallel", ("gcn:16", "gat:16:2:identity"), 1, 4,
                      True, False, 1, 4, 3, 9, 2),
    "b": ("parallel", ("gin:16", "gat:16:2:identity"), 1, 4, False, False,
          1, 4, 3, 9),
    "overlap": ("parallel", ("gcn:16", "gat:16:2:identity"), 1, 4, True,
                False, 1, 4, 3, 9),
    "remat": ("parallel", ("gat:16:2:identity",), 1, 4, False, True, 1, 4,
              3, 9),
    # one shard a process: what one process over 2 cards must repeat
    "cards": ("parallel", ("gin:16", "gat:16:2:identity"), 1, 2, False,
              False, 1, 4, 3, 9),
}


def _dataset(name):
    if name == "multihost":  # tests/_multihost_prog.py's
        return make_synthetic_ddi(num_drugs=32, feat_dim=8, avg_degree=6.0,
                                  min_atoms=4, max_atoms=10, seed=0)
    return make_synthetic_ddi(**KW)


def _slots_exchange(mesh) -> ProcessExchange:
    """The route between hosts over this process's shards of ``mesh``,
    spread over 2 CPU "card" slots (``ProcessExchange``'s ``card_of``)."""
    local = mesh.local_graph
    return ProcessExchange(mesh.shape["graph"], local, ["cpu"] * len(local),
                           [k * 2 // len(local) for k in range(len(local))])


def _p2_case(name: str, multi: bool, cards: bool = False) -> dict:
    """One p2 step of case ``name``, across the group's processes
    (``multi``; a case of 2 slots: ``make_hybrid_mesh`` over 2 CPU devices,
    and the shards on slots of their own where a process holds 2) or in
    this one (with ``cards``, over a "card" a shard:
    ``make_cards_train_step`` on CPU slots); the loss, the parameters after
    the step, their checksum (JAX's: the sum of |p|) and a digest of their
    bits."""
    (data, outer, dp, graph, overlap, remat, seed, pos_seed, tail, key,
     *slots) = CASES[name]
    slots = slots[0] if slots else 1
    ds = _dataset(data)
    if outer is None:
        cfg = BiGNNConfig.config1(feat_dim=8)
    else:
        cfg = dataclasses.replace(
            BiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2),
            outer_layers=outer)
    model = BiGNN(cfg, seed=seed)
    mesh = (make_hybrid_mesh(dp=dp, graph=graph, devices=["cpu"] * slots)
            if multi else
            make_mesh(dp=dp, graph=graph, devices=["cpu"] * (dp * graph)))
    train = ds.split_edges("train")
    plan = build_outer_partition(train[:, 0], train[:, 1], ds.num_drugs,
                                 graph)
    inner = build_sharded_inner(ds.molecules, plan, split_boundary=overlap)
    plan_d = device_put_plan(mesh, plan, inner, cfg.inner_layers)
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3)
    if cards:
        step = make_cards_train_step(
            model, optimizer, CardExchange(["cpu"] * graph, range(graph)),
            ds.num_drugs, overlap=overlap, remat=remat, dp=dp)
    else:
        exchange = (_slots_exchange(mesh)
                    if multi and len(mesh.local_graph) == slots > 1
                    else make_exchange(mesh))
        step = make_p2_train_step(model, optimizer, mesh, ds.num_drugs,
                                  overlap=overlap, remat=remat,
                                  exchange=exchange)
    pos = np.random.default_rng(pos_seed).integers(
        0, ds.num_drugs, (16, 2)).astype(np.int32)
    mask = np.ones(16, np.float32)
    if tail:
        mask[-tail:] = 0.0
    loss = step(prng.key(key), pos, mask, plan_d)
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    grads = {k: v.grad.clone() for k, v in model.named_parameters()}
    digest = hashlib.sha256()
    for v in (*params.values(), *grads.values()):
        digest.update(v.numpy().tobytes())
    return {"loss": float(loss), "params": params, "grads": grads,
            "checksum": sum(float(v.abs().sum()) for v in params.values()),
            "digest": digest.hexdigest()}


def _exchange_case(rank: int) -> dict:
    """(b)'s exchange on 4 shards, 2 a process: whole send buffers and
    cotangents made from a seed in every process, each taking its own."""
    mesh = make_hybrid_mesh(graph=4, device="cpu")
    exchange = make_exchange(mesh)
    local = mesh.local_graph
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(4, 4, 3, 5)).astype(np.float32))
    ct = torch.from_numpy(rng.normal(size=(4, 4, 3, 5)).astype(np.float32))
    bufs = [x[j].clone().requires_grad_() for j in local]
    out = ops.all_to_all(bufs, exchange)
    torch.autograd.backward(out, [ops.all_to_all_plain(list(ct))[j]
                                  for j in local])
    want = ops.all_to_all_plain(list(x))
    want_g = ops.all_to_all_plain(list(ops.all_to_all_plain(list(ct))))
    h = torch.from_numpy(rng.normal(size=(4, 6, 7)).astype(np.float32))
    hl = [h[j].clone().requires_grad_() for j in local]
    emb = gather_rows(hl, exchange)
    g = torch.from_numpy(rng.normal(size=(24, 7)).astype(np.float32))
    emb.backward(g)
    return {
        "local": local,
        "route": type(exchange).__name__,
        "sent_bytes": exchange.sent_bytes,
        "forward": all(torch.equal(o, want[j]) for o, j in zip(out, local)),
        "backward": all(torch.equal(b.grad, want_g[j])
                        for b, j in zip(bufs, local)),
        "gather": torch.equal(emb, h.reshape(24, 7)),
        "gather_backward": all(
            torch.equal(t.grad, 2 * g.view(4, 6, 7)[j])
            for t, j in zip(hl, local)),
        "processes": mesh.processes.tolist(),
        **_slots_exchange_case(rank),
    }


def _slots_exchange_case(rank: int) -> dict:
    """(h): (b)'s exchange with each process's 2 shards on 2 CPU "card"
    slots, and the rows gathered onto both slots: forward and backward
    exactly; the gather's backward adds, for each shard's rows, the 4
    slots' cotangents one at a time in (process, slot) order."""
    mesh = make_hybrid_mesh(graph=4, devices=["cpu", "cpu"])
    exchange = _slots_exchange(mesh)
    local = mesh.local_graph
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(4, 4, 3, 5)).astype(np.float32))
    ct = torch.from_numpy(rng.normal(size=(4, 4, 3, 5)).astype(np.float32))
    bufs = [x[j].clone().requires_grad_() for j in local]
    out = ops.all_to_all(bufs, exchange)
    torch.autograd.backward(out, [ops.all_to_all_plain(list(ct))[j]
                                  for j in local])
    want = ops.all_to_all_plain(list(x))
    want_g = ops.all_to_all_plain(list(ops.all_to_all_plain(list(ct))))
    h = torch.from_numpy(rng.normal(size=(4, 6, 7)).astype(np.float32))
    hl = [h[j].clone().requires_grad_() for j in local]
    embs = gather_rows_cards(hl, exchange)
    # every slot's cotangent, in (process, slot) order
    g = torch.from_numpy(rng.normal(size=(4, 24, 7)).astype(np.float32))
    torch.autograd.backward(embs, [g[2 * rank + c] for c in range(2)])
    fold = ((g[0] + g[1]) + g[2]) + g[3]
    return {
        "slots_cards": [exchange.card_of, exchange.total_cards],
        "slots_forward": all(torch.equal(o, want[j])
                             for o, j in zip(out, local)),
        "slots_backward": all(torch.equal(b.grad, want_g[j])
                              for b, j in zip(bufs, local)),
        "slots_gather": len(embs) == 2 and all(
            torch.equal(e, h.reshape(24, 7)) for e in embs),
        "slots_gather_backward": all(
            torch.equal(t.grad, fold.view(4, 6, 7)[j])
            for t, j in zip(hl, local)),
    }


def _route_case(rank: int) -> dict:
    """(f): the class ``make_exchange`` builds for each pair of hosts (the
    list ``init_distributed`` gathered, set in turn) on the CPU, on one
    card (a ``cuda:0`` mesh) and on a card a process (``cuda:{rank}``):
    building either exchange touches no card. Also the hosts the real
    gather found: one per process, the same."""
    gathered = mesh_mod.host_names()
    routes = {"gathered": len(gathered) == 2 and len(set(gathered)) == 1}
    try:
        for layout, hosts in (("one", ["h0", "h0"]), ("two", ["h0", "h1"])):
            mesh_mod._hosts = hosts
            for name, devs in (("cpu", ["cpu"]), ("card", ["cuda:0"]),
                               ("cards", [f"cuda:{rank}"]),
                               ("two-cards", [f"cuda:{2 * rank}",
                                              f"cuda:{2 * rank + 1}"])):
                exchange = make_exchange(make_hybrid_mesh(graph=4,
                                                          devices=devs))
                routes[f"{layout}-{name}"] = type(exchange).__name__
                exchange.close()
    finally:
        mesh_mod._hosts = gathered
    return routes


def _tiny_config5(epochs: int = 2):
    """tests/test_torch_cli.py's tiny config5 (``_tiny``), port only."""
    cfg = get_config("config5")
    model = dataclasses.replace(
        cfg.model, feat_dim=8, inner_layers=("gin:16",),
        outer_layers=("gat:16:2",))
    return dataclasses.replace(
        cfg, dataset="synthetic-small", dataset_kwargs=dict(TINY_DATA),
        model=model, train=dataclasses.replace(
            cfg.train, lr=1e-3, batch_size=32, epochs=epochs))


def _run_main(run_dir: Path, extra=()) -> dict:
    """``run.main`` on config5 (``run.get_config`` set to
    ``_tiny_config5`` by the caller), on the CPU."""
    res = run.main(["--config", "config5", "--run-dir", str(run_dir),
                    "--device", "cpu", *extra])
    return {"losses": [r["loss"] for r in res["history"]],
            "best_epoch": res["best_epoch"], "test_auc": res["test_auc"]}


def _worker(port: int, rank: int, out: Path) -> None:
    torch.set_num_threads(1)
    flags = ["--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
             "--process-id", str(rank)]
    init_distributed(f"127.0.0.1:{port}", 2, rank)
    results = {"exchange": _exchange_case(rank), "routes": _route_case(rank)}
    for name in CASES:
        res = _p2_case(name, multi=True)
        torch.save({"params": res.pop("params"), "grads": res.pop("grads")},
                   out / f"{name}_{rank}.pt")
        results[name] = res
    run.get_config = lambda name: _tiny_config5()  # this process only
    ckpt = ["--checkpoint-every", "1"]
    results["run"] = _run_main(out / "run", [*flags, *ckpt])
    # killed after epoch 0, then the same command resumes
    results["first"] = _run_main(out / "resume",
                                 [*flags, *ckpt, "--epochs", "1"])
    results["resumed"] = _run_main(out / "resume", [*flags, *ckpt])
    (out / f"results_{rank}.json").write_text(json.dumps(results))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these tiny tensors (see
    tests/test_torch_minibatch.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    """Both workers' results, after both exit 0 (a survivor of a failed
    or hung pair is killed)."""
    out = tmp_path_factory.mktemp("multihost")
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("JAX_")}
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker", "--port", str(port),
         "--rank", str(r), "--out", str(out)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=WORKER_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (_, err)) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {r} failed:\n{err[-3000:]}"
    return out, [json.loads((out / f"results_{r}.json").read_text())
                 for r in range(2)]


@pytest.mark.parametrize("nproc,ici_dp,ici_graph", [
    (2, 1, 1), (2, 2, 1), (2, 1, 2), (4, 2, 2), (3, 2, 3)])
def test_hybrid_mesh_layout_matches_jax(monkeypatch, nproc, ici_dp,
                                        ici_graph):
    """The process of every entry, as JAX's hand layout places its
    processes' devices (its ``mesh_utils`` route refused, as on a CPU)."""
    import jax
    from jax.experimental import mesh_utils

    from bignn_tpu.parallel import mesh as jax_mesh

    nloc = ici_dp * ici_graph

    class Dev:
        def __init__(self, p, i):
            self.process_index, self.id = p, i

    devs = [Dev(p, p * nloc + i) for p in range(nproc) for i in range(nloc)]

    def refuse(**kw):
        raise ValueError("no slice metadata")

    monkeypatch.setattr(jax, "process_count", lambda: nproc)
    monkeypatch.setattr(jax, "local_device_count", lambda: nloc)
    monkeypatch.setattr(jax, "devices", lambda: devs)
    monkeypatch.setattr(mesh_utils, "create_hybrid_device_mesh", refuse)
    monkeypatch.setattr(jax_mesh, "Mesh", lambda arr, axis_names: arr)
    want = jax_mesh.make_hybrid_mesh(dp=ici_dp, graph=nproc * ici_graph)
    monkeypatch.setattr(mesh_mod, "process_count", lambda: nproc)
    monkeypatch.setattr(mesh_mod, "all_gather_object",
                        lambda obj: [obj] * nproc)
    got = make_hybrid_mesh(dp=ici_dp, graph=nproc * ici_graph, device="cpu")
    assert got.shape == {"dp": ici_dp, "graph": nproc * ici_graph}
    np.testing.assert_array_equal(
        got.processes, np.vectorize(lambda d: d.process_index)(want))
    assert set(got.devices.flat) == {torch.device("cpu")}
    for p in range(nproc):  # each process's graph shards, host-major
        monkeypatch.setattr(mesh_mod, "process_index", lambda p=p: p)
        assert got.local_graph == list(range(p * ici_graph,
                                             (p + 1) * ici_graph))
    # distinct local devices, process p's i-th named cuda:{p * nloc + i}:
    # every entry on the (process, local card) JAX places there
    monkeypatch.setattr(mesh_mod, "all_gather_object", lambda obj: [
        [f"cuda:{p * nloc + i}" for i in range(nloc)] for p in range(nproc)])
    cards = make_hybrid_mesh(dp=ici_dp, graph=nproc * ici_graph,
                             devices=[f"cuda:{i}" for i in range(nloc)])
    np.testing.assert_array_equal(cards.processes, got.processes)
    np.testing.assert_array_equal(
        np.vectorize(lambda d: d.index)(cards.devices),
        np.vectorize(lambda d: d.id)(want))


def test_hybrid_mesh_errors_match_jax(monkeypatch):
    import jax

    from bignn_tpu.parallel import mesh as jax_mesh

    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "local_device_count", lambda: 2)
    with pytest.raises(ValueError) as want:
        jax_mesh.make_hybrid_mesh(graph=3)
    monkeypatch.setattr(mesh_mod, "process_count", lambda: 2)
    with pytest.raises(ValueError) as got:
        make_hybrid_mesh(graph=3, device="cpu")
    assert str(got.value) == str(want.value)
    # JAX's two checks against the local devices, on as many CPU devices:
    # a per-host graph dim that does not divide them, and a dp against them
    for nloc, kw in ((3, dict(graph=4)), (2, dict(dp=1, graph=2))):
        monkeypatch.setattr(jax, "local_device_count", lambda n=nloc: n)
        with pytest.raises(ValueError) as want:
            jax_mesh.make_hybrid_mesh(**kw)
        with pytest.raises(ValueError) as got:
            make_hybrid_mesh(**kw, devices=["cpu"] * nloc)
        assert str(got.value) == str(want.value)
    # a single process: make_mesh on its one card
    monkeypatch.setattr(mesh_mod, "process_count", lambda: 1)
    one = make_hybrid_mesh(dp=2, graph=2, device="cpu")
    assert one.shape == {"dp": 2, "graph": 2} and one.process_count == 1
    assert one.local_graph == [0, 1]


@pytest.mark.parametrize("kw", [{}, dict(graph=2), dict(graph=4),
                                dict(dp=3, graph=2)])
def test_single_process_hybrid_mesh_spreads_like_jax(monkeypatch, kw):
    """One process over 8 devices (conftest's 8 host devices for JAX, 8
    CPU slots for the port): JAX's ``make_mesh`` over every local device,
    ``dp`` defaulting to their count over ``graph`` (8 x 1, 4 x 2, 2 x 4),
    and JAX's error where ``dp * graph`` is not the device count."""
    import jax

    from bignn_tpu.parallel import mesh as jax_mesh

    assert jax.process_count() == 1 and jax.local_device_count() == 8
    monkeypatch.setattr(mesh_mod, "process_count", lambda: 1)
    try:
        want = jax_mesh.make_hybrid_mesh(**kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            make_hybrid_mesh(**kw, devices=["cpu"] * 8)
        assert str(got.value) == str(e)
        return
    got = make_hybrid_mesh(**kw, devices=["cpu"] * 8)
    assert got.shape == dict(want.shape)
    assert got.devices.size == 8 and got.process_count == 1
    assert got.local_graph == list(range(want.shape["graph"]))


# processes' cards (their indices on one host of 4 cards) -> whether the
# exchange takes the semaphores on the cards: only where no card is shared
PEER_LAYOUTS = {
    "2x2": ([[0, 1], [2, 3]], True),
    "4x1": ([[0], [1], [2], [3]], True),
    "2_on_one": ([[0], [0]], False),
    "2x2_sharing": ([[0, 1], [1, 2]], False),
}


def _peer_exchange(monkeypatch, rank: int, cards: list):
    """``PeerExchange`` as process ``rank`` of ``len(cards)`` builds it (a
    shard a card), the process group's gathers answered from every
    process's layout and card UUIDs; nothing touches a card."""
    import torch.distributed as dist
    from types import SimpleNamespace

    from bignn_tpu_torch.ops.collectives import PeerExchange

    n = len(cards[0])
    answers = iter([
        [(list(range(p * n, (p + 1) * n)), list(range(n)))
         for p in range(len(cards))],
        [[f"GPU-{c}" for c in theirs] for theirs in cards]])

    def gather(out, obj):
        every = next(answers)
        assert obj == every[rank]
        out[:] = every

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: rank)
    monkeypatch.setattr(dist, "get_world_size", lambda: len(cards))
    monkeypatch.setattr(dist, "all_gather_object", gather)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(uuid=f"GPU-{d.index}"))
    return PeerExchange(len(cards) * n, range(rank * n, (rank + 1) * n),
                        [f"cuda:{c}" for c in cards[rank]])


@pytest.mark.parametrize("layout", sorted(PEER_LAYOUTS))
def test_peer_exchange_takes_device_barrier_only_on_distinct_cards(
        monkeypatch, layout):
    """``PeerExchange`` chooses the semaphores on the cards from the cards'
    UUIDs gathered through the group, every process alike: where every
    card of every process is its own; where processes share a card, the
    host's protocol. ``launch`` then runs, after the staging copies and the
    receive buffers, the launches alone (one ``check`` of the error words
    before them), or the launches between two ``_meet``s (a stream
    synchronisation and a gloo barrier each)."""
    from bignn_tpu_torch.ops import collectives

    cards, want = PEER_LAYOUTS[layout]
    built = [_peer_exchange(monkeypatch, r, cards) for r in range(len(cards))]
    assert [ex.device_barrier for ex in built] == [want] * len(cards)
    ex = built[0]
    trace = []

    class Barrier:
        def check(self):
            trace.append("check")

    ex._barrier = Barrier() if ex.device_barrier else None
    ex.capacity, ex._own = 1 << 30, [0] * len(ex.cards)
    monkeypatch.setattr(ex, "_check_devices", lambda bufs: None)
    monkeypatch.setattr(ex, "_meet", lambda: trace.append("meet"))
    monkeypatch.setattr(ex, "launch_staged",
                        lambda recv, bufs: trace.append("launch"))
    monkeypatch.setattr(collectives, "_view", lambda ptr, like, count=1: (
        trace.append("stage") or torch.empty(count, *like.shape)))
    bufs = [torch.zeros(ex.num_shards, 3, 5) for _ in ex.local]
    assert len(ex.launch(bufs)) == len(bufs)
    assert trace == ["stage"] * len(bufs) + (
        ["check", "launch"] if want else ["meet", "launch", "meet"])


@pytest.mark.parametrize("kw,match", [
    (dict(coordinator_address="127.0.0.1:1"), "without a process count"),
    (dict(num_processes=2, process_id=0), "coordinator"),
    (dict(coordinator_address="h:1", num_processes=2, process_id=2),
     "outside"),
    (dict(coordinator_address="h:1", num_processes=2), "id"),
])
def test_resolve_distributed_refuses(monkeypatch, kw, match):
    for name in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                 "JAX_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match=match):
        resolve_distributed(**kw)


def test_resolve_distributed_reads_jax_environment(monkeypatch):
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "h:9")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "3")
    monkeypatch.setenv("JAX_PROCESS_ID", "2")
    assert resolve_distributed() == ("h:9", 3, 2)
    assert resolve_distributed(num_processes=1, process_id=0,
                               coordinator_address="x:1") == ("x:1", 1, 0)
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS")
    monkeypatch.delenv("JAX_NUM_PROCESSES")
    monkeypatch.delenv("JAX_PROCESS_ID")
    assert resolve_distributed() == (None, 1, 0)
    assert init_distributed() == 0  # one process joins nothing


def test_run_refuses_several_processes_outside_p2():
    with pytest.raises(ValueError, match="p2 is the multi-process mode"):
        run.main(["--config", "config1", "--coordinator", "127.0.0.1:1",
                  "--num-processes", "2", "--process-id", "0",
                  "--device", "cpu"])


@pytest.fixture(scope="module")
def jax_run_once():
    """JAX's own tests/_multihost_prog.py ``run_once()``: (loss,
    checksum)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_multihost_prog", REPO / "tests" / "_multihost_prog.py")
    prog = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prog)
    return prog.run_once()


def test_two_processes_match_jax_run_once(workers, jax_run_once):
    """(a) against JAX's own tests/_multihost_prog.py run_once()."""
    loss_ref, cs_ref = jax_run_once
    _, results = workers
    for r in results:
        assert np.isclose(r["a"]["loss"], loss_ref, rtol=1e-5), (r["a"],
                                                                 loss_ref)
        assert np.isclose(r["a"]["checksum"], cs_ref, rtol=1e-5), (
            r["a"], cs_ref)


def test_two_processes_of_two_devices_match_jax_run_once(workers,
                                                         jax_run_once):
    """(h): JAX's topology itself, 2 processes of 2 devices each
    (``make_hybrid_mesh`` over 2 CPU devices: dp = 2 x graph = 2 by JAX's
    checks), against ``run_once()`` at JAX's rtol 1e-5."""
    loss_ref, cs_ref = jax_run_once
    _, results = workers
    for r in results:
        got = r["a_cards"]
        assert np.isclose(got["loss"], loss_ref, rtol=1e-5), (got, loss_ref)
        assert np.isclose(got["checksum"], cs_ref, rtol=1e-5), (got, cs_ref)


@pytest.mark.parametrize("case", list(CASES))
def test_two_processes_match_one_process(workers, case):
    """(a), (b), (e): the loss, every gradient (summed over the processes:
    Adam's step hides a gradient off by a constant factor, so they are held
    themselves, at tests/test_torch_parallel.py's TOL x the largest) and
    every parameter after the step against the same step in one process;
    both workers to the bit."""
    out, results = workers
    one = _p2_case(case, multi=False)
    a, b = (r[case] for r in results)
    assert a["loss"] == b["loss"] and a["digest"] == b["digest"]
    np.testing.assert_allclose(a["loss"], one["loss"], **STEP_TOL)
    got = torch.load(out / f"{case}_0.pt")
    for name, want in one["grads"].items():
        scale = max(want.abs().max().item(), 1.0)
        np.testing.assert_allclose(got["grads"][name].numpy(), want.numpy(),
                                   rtol=TOL["rtol"], atol=TOL["atol"] * scale,
                                   err_msg=name)
    for name, want in one["params"].items():
        np.testing.assert_allclose(got["params"][name].numpy(),
                                   want.numpy(), **STEP_TOL, err_msg=name)


def test_cards_step_equals_two_processes(workers):
    """One process over 2 "cards" (CPU slots, a graph shard each) takes the
    same step as 2 processes of a shard each, bit for bit: the loss, every
    parameter and every gradient (``parallel/comm.py``: a card plays a
    process's part)."""
    _, results = workers
    got = _p2_case("cards", multi=False, cards=True)
    for r in results:
        assert (r["cards"]["loss"], r["cards"]["digest"]) == (
            got["loss"], got["digest"])


@pytest.mark.parametrize("case", ["slots", "slots_overlap"])
def test_slots_step_equals_one_process_over_four_slots(workers, case):
    """(h): 2 processes of 2 CPU "card" slots, a graph shard a slot, take
    the same step as one process over 4 slots (``make_cards_train_step``),
    bit for bit: the loss, every gradient and every parameter (every sum
    one term a slot in (process, slot) order)."""
    _, results = workers
    got = _p2_case(case, multi=False, cards=True)
    for r in results:
        assert (r[case]["loss"], r[case]["digest"]) == (got["loss"],
                                                        got["digest"])


def test_exchange_across_processes_of_two_slots_is_exact(workers):
    """(h): the exchange with 2 slots a process (the host route: a launch
    a card on the card), its backward, the rows gathered onto both slots
    and the gather's backward exactly."""
    _, results = workers
    for r in results:
        ex = r["exchange"]
        assert ex["slots_cards"] == [[0, 1], 4]
        assert ex["slots_forward"] and ex["slots_backward"], ex
        assert ex["slots_gather"] and ex["slots_gather_backward"], ex


def test_exchange_across_processes_is_exact(workers):
    """(b): 2 local shards a process; the exchange, its backward and the
    embedding all-gather's backward exactly."""
    _, results = workers
    assert [r["exchange"]["local"] for r in results] == [[0, 1], [2, 3]]
    for r in results:
        ex = r["exchange"]
        assert ex["processes"] == [[0, 0, 1, 1]]
        assert ex["forward"] and ex["backward"], ex
        assert ex["gather"] and ex["gather_backward"], ex


def test_host_route_sends_only_other_processes_chunks(workers):
    """(b): the exchange and its backward went the host route, and each
    process sent through gloo the other's two shards' slots of its two
    send buffers, twice: 2 x 2 x 2 chunks of 3 x 5 float32."""
    _, results = workers
    for r in results:
        assert r["exchange"]["route"] == "ProcessExchange"
        assert r["exchange"]["sent_bytes"] == 2 * 2 * 2 * 3 * 5 * 4


def test_make_exchange_routes_by_host_names(workers):
    """(f): IPC only for one card whose processes share one host."""
    _, results = workers
    for r in results:
        assert r["routes"] == {"gathered": True,
                               "one-cpu": "ProcessExchange",
                               "one-card": "PeerExchange",
                               "one-cards": "ProcessExchange",
                               "one-two-cards": "ProcessExchange",
                               "two-cpu": "ProcessExchange",
                               "two-card": "ProcessExchange",
                               "two-cards": "ProcessExchange",
                               "two-two-cards": "ProcessExchange"}


@pytest.mark.parametrize("hosts,count,ids,cards", [
    pytest.param(("a", "a", "b", "b"), 2, None, ((0,), (1,), (0,), (1,)),
                 id="hosts0-cards0"),  # host-major ranks
    pytest.param(("a", "b", "a", "b"), 2, None, ((0,), (0,), (1,), (1,)),
                 id="hosts1-cards1"),  # ranks alternating hosts
    # 3 processes on 2 cards; host b's one process drives both
    pytest.param(("a", "a", "a", "b"), 2, None, ((0,), (1,), (0,), (0, 1)),
                 id="hosts2-cards2"),
    pytest.param(("a", "a"), 4, None, ((0, 1), (2, 3)),
                 id="two-processes-split-four-cards"),
    pytest.param(("a", "a"), 4, (0, 1), ((0, 1), (0, 1)),
                 id="local-device-ids"),
])
def test_init_distributed_card_by_host(monkeypatch, hosts, count, ids,
                                       cards):
    """(f): each process takes its host's cards in rank order, by its
    index among the processes of its host (``count`` cards a host,
    stubbed): its share where the host's processes divide its cards, else
    one; or the ``local_device_ids`` it is given. Its first card becomes
    the current one."""
    import torch.distributed as dist

    chosen = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: None)
    monkeypatch.setattr(mesh_mod, "all_gather_object",
                        lambda obj: list(hosts))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    monkeypatch.setattr(mesh_mod, "_local_devices", None)
    monkeypatch.setattr(mesh_mod, "_hosts", None)
    for rank in range(len(hosts)):
        assert init_distributed("h:1", len(hosts), rank,
                                local_device_ids=ids) == rank
        assert mesh_mod.host_names() == list(hosts)
        assert mesh_mod.local_devices() == [torch.device("cuda", c)
                                            for c in cards[rank]]
        assert mesh_mod.local_device() == torch.device("cuda",
                                                       cards[rank][0])
    assert chosen == [torch.device("cuda", c[0]) for c in cards]


def test_run_main_across_two_processes(workers, monkeypatch, tmp_path):
    """(d): run.main across 2 processes against the one-process run."""
    out, results = workers
    monkeypatch.setattr(run, "get_config", lambda name: _tiny_config5())
    one = _run_main(tmp_path / "one")
    for r in results:
        got = r["run"]
        np.testing.assert_allclose(got["losses"], one["losses"],
                                   rtol=RUN_RTOL)
        assert got["best_epoch"] == one["best_epoch"]
        assert abs(got["test_auc"] - one["test_auc"]) <= RUN_AUC
    assert results[0]["run"] == results[1]["run"]
    records = [json.loads(line) for line in
               (out / "run" / "metrics.jsonl").read_text().splitlines()]
    # process 0 alone wrote the shared run dir: each record once
    assert [r["epoch"] for r in records if "epoch" in r] == [0, 1]
    assert sum(r.get("event") == "done" for r in records) == 1
    assert {"event": "mesh", "dp": 1, "graph": 4, "processes": 2}.items() \
        <= next(r for r in records if r.get("event") == "mesh").items()
    assert json.loads((out / "run" / "result.json").read_text())[
        "best_epoch"] == one["best_epoch"]



def _same_state(a, b) -> bool:
    """Two checkpoint states equal, tensors bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_state(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same_state, a, b))
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.reshape(-1).view(torch.uint8),
                                b.reshape(-1).view(torch.uint8)))
    return a == b


def test_run_main_resumes_across_two_processes(workers):
    """(d): stopped after epoch 0 with a checkpoint, the same two-process
    command trains epoch 1 alone and ends bit for bit where the straight
    two-process run ends: losses, best epoch, test AUC, and process 0's
    last checkpoint (parameters, Adam state, best parameters)."""
    from bignn_tpu_torch.train.checkpoint import CheckpointManager

    out, results = workers
    for r in results:
        assert r["first"]["losses"] == r["run"]["losses"][:1]
        assert r["resumed"]["losses"] == r["run"]["losses"][1:]
        assert r["resumed"]["best_epoch"] == r["run"]["best_epoch"]
        assert r["resumed"]["test_auc"] == r["run"]["test_auc"]
    straight = CheckpointManager(str(out / "run" / "ckpt"))
    resumed = CheckpointManager(str(out / "resume" / "ckpt"))
    assert straight.steps() == resumed.steps() == [0, 1]
    assert _same_state(resumed.restore_state(), straight.restore_state())
    assert not _same_state(resumed.restore_state(0),
                           resumed.restore_state(1))
    records = [json.loads(line) for line in
               (out / "resume" / "metrics.jsonl").read_text().splitlines()]
    # process 0 alone appended each run's records
    assert [r["epoch"] for r in records if "epoch" in r] == [0, 1]
    assert sum(r.get("event") == "done" for r in records) == 2


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true", required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--out", type=Path, required=True)
    a = ap.parse_args()
    _worker(a.port, a.rank, a.out)
