"""The port at widths and head counts above the card kernels' former caps
(8 heads, 256 columns, head_dim 64), against the JAX package on the CPU.

A wide BI-GNN is configs 2 and 4 with wider layer specs, built in both
packages through ``get_config(name, model=dataclasses.replace(...))``:
W1 (config2 and config4) has inner layers ``gin:300`` x2 (OGB's molecular
GIN width) and the outer ``gat:1024:4:identity`` (GAT's PPI layers, 4
heads of 256); W2 (config4) the same inner layers and the outer
``dotattn:768:32:identity`` (Graphormer's base width and heads).

* Ops, forward and VJP, on the same NumPy inputs: ``segment_softmax`` at
  16 and 32 heads, ``spmm_multihead`` at (H, D) = (4, 256), (32, 24) and
  (2, 512), ``block_spmm`` at F 300 and 1024, ``flash_gat_attention`` at
  head_dim 72, 128 and 256. The JAX side runs its ``xla`` backend, and
  ``pallas_interpret`` for ``block_spmm`` at F 300 and the flash-GAT pair at
  head_dim 72 and 256.
* Models, at a few dozen drugs, with the JAX parameters carried over by
  ``bridge.params_from_jax``: W1's forward and one full-graph ``Trainer``
  step on config2 (dense outer), and one ``MinibatchTrainer`` step of
  config4 (bf16, device-style compact batch) with W1 and with W2.

Tolerances: f32 forwards rtol = atol = 1e-5, their gradients 1e-4
(tests/test_torch_ops.py); whole f32 models and steps rtol 1e-5 / atol 1e-5
x max(1, max |ref|) at most (tests/test_torch_train.py holds steps to 2e-4
/ 2e-5 x scale); bf16 1e-2 x max(1, max |ref|) (PERF.md section 6: JAX
rounds every bf16 message and partial sum, the port sums in float32 and
rounds once). On the CPU each op runs its plain version, which has no
width limit; these tests hold the model wiring at width. The kernels at
these shapes are held to the plain versions on the card
(tests/test_torch_kernels.py, ``WIDE_*``; chip_smoke.py path O).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bignn_tpu import ops as jax_ops
from bignn_tpu.config import get_config as jax_get_config
from bignn_tpu.data import load_dataset as jax_load_dataset
from bignn_tpu.data import make_synthetic_ddi as jax_make_synthetic_ddi
from bignn_tpu.data import prepare_device_data as jax_prepare_device_data
from bignn_tpu.models import BiGNN as JaxBiGNN
from bignn_tpu.models.loss import bce_with_logits_loss as jax_bce
from bignn_tpu.ops.multihead import spmm_multihead as jax_spmm_mh
from bignn_tpu.ops.pallas.flash_gat import _fused_fwd_xla
from bignn_tpu.ops.pallas.flash_gat import \
    flash_gat_attention as jax_flash_gat
from bignn_tpu.ops.spmm import spmm_sorted_coo as jax_spmm
from bignn_tpu.train.trainer import MinibatchTrainer as JaxMinibatchTrainer
from bignn_tpu.train.trainer import TrainConfig as JaxTrainConfig

from bignn_tpu_torch import bridge, ops
from bignn_tpu_torch.config import TrainConfig, get_config
from bignn_tpu_torch.data import load_dataset, make_synthetic_ddi
from bignn_tpu_torch.data import prepare_device_data
from bignn_tpu_torch.models import BiGNN
from bignn_tpu_torch.parallel import dp as dp_mod
from bignn_tpu_torch.train import MinibatchTrainer, Trainer

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
INNER = ("gin:300", "gin:300")
OUTER = {"W1": ("gat:1024:4:identity",), "W2": ("dotattn:768:32:identity",)}
SLOPE = 0.2
# The JAX side runs under jax.jit (one compile in place of one an eager
# primitive; an init keeps its bits), a model step with XLA's cheaper CPU
# backend passes: it compiles in ~1.5 s in place of ~2.5 s, and its
# float32 loss moves by 1e-7.
FAST = dict(xla_backend_optimization_level=0,
            xla_llvm_disable_expensive_passes=True)


def _jit(f):
    return jax.jit(f, compiler_options=FAST)


INIT_SEED = 3


@functools.cache
def _jax_params(name: str, wide: str):
    """JAX's init of config ``name`` with ``wide``'s layers for
    ``key(INIT_SEED)``, once a model for every test of the file."""
    model = JaxBiGNN(_wide(jax_get_config, name, wide).model)
    return jax.jit(model.init)(jax.random.key(INIT_SEED))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread (tests/test_torch_minibatch.py): the test workers
    share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(x):
    return torch.from_numpy(np.array(x))


def _wide(get, name: str, wide: str):
    """Config ``name`` of one package with the wide layer specs."""
    cfg = get(name)
    return get(name, model=dataclasses.replace(
        cfg.model, inner_layers=INNER, outer_layers=OUTER[wide]))


def _close(got, want, scale_tol, err_msg=""):
    """|got - want| <= scale_tol x max(1, max |want|)."""
    want = np.asarray(want, np.float32)
    bound = scale_tol * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=bound, err_msg=err_msg)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


def _edges(rng, n, e, pad=37):
    """Dst-sorted edges over n nodes, padding (dst n) last."""
    src = rng.integers(0, n, e).astype(np.int32)
    dst = np.sort(rng.integers(0, n - 2, e)).astype(np.int32)
    return (np.concatenate([src, np.zeros(pad, np.int32)]),
            np.concatenate([dst, np.full(pad, n, np.int32)]))


@pytest.mark.parametrize("heads", [16, 32])
def test_segment_softmax_wide_matches_jax(heads):
    rng = np.random.default_rng(heads)
    n = 40
    _, ids = _edges(rng, n, 500)
    x = (3 * rng.standard_normal((len(ids), heads))).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    valid = ids < n
    want, vjp = jax.vjp(jax.jit(lambda s: jax_ops.segment_softmax(
        s, jnp.asarray(ids), n, backend="xla")), jnp.asarray(x))
    (want_d,) = vjp(jnp.asarray(g))
    xt = t(x).requires_grad_()
    got = ops.segment_softmax(xt, t(ids), n)
    (got_d,) = torch.autograd.grad(got, xt, t(g))
    np.testing.assert_allclose(got.detach().numpy()[valid],
                               np.asarray(want)[valid], **TOL)
    np.testing.assert_allclose(got_d.numpy()[valid],
                               np.asarray(want_d)[valid], **GRAD_TOL)


@pytest.mark.parametrize("heads, head_dim", [(4, 256), (32, 24), (2, 512)])
def test_spmm_multihead_wide_matches_jax(heads, head_dim):
    rng = np.random.default_rng(head_dim)
    n = 40
    src, dst = _edges(rng, n, 400)
    v = rng.standard_normal((n, heads, head_dim)).astype(np.float32)
    alpha = rng.random((len(src), heads)).astype(np.float32)
    g = rng.standard_normal(v.shape).astype(np.float32)
    want, vjp = jax.vjp(jax.jit(lambda v_, a_: jax_spmm_mh(
        v_, jnp.asarray(src), jnp.asarray(dst), a_, n, backend="xla")),
        jnp.asarray(v), jnp.asarray(alpha))
    want_dv, want_da = vjp(jnp.asarray(g))
    vt, at = t(v).requires_grad_(), t(alpha).requires_grad_()
    got = ops.spmm_multihead(vt, t(src), t(dst), at, n)
    got_dv, got_da = torch.autograd.grad(got, (vt, at), t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_dv.numpy(), np.asarray(want_dv),
                               **GRAD_TOL)
    np.testing.assert_allclose(got_da.numpy(), np.asarray(want_da),
                               **GRAD_TOL)


def _block_plan(rng, nblk):
    """Block-local edges over ``nblk`` 128-row blocks (none leaves its
    block), dst-sorted, with the transposed plan and padding edges."""
    n = nblk * 128
    src, dst = [], []
    for b in range(nblk):
        k = int(rng.integers(50, 300))
        src.append(rng.integers(b * 128, (b + 1) * 128, k))
        dst.append(rng.integers(b * 128, (b + 1) * 128, k))
    src, dst = np.concatenate(src), np.concatenate(dst)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order].astype(np.int32), dst[order].astype(np.int32)
    w = rng.random(len(src)).astype(np.float32)
    torder = np.argsort(src, kind="stable")
    bounds = np.arange(nblk + 1) * 128
    pad = 40
    return dict(
        src=np.concatenate([src, np.zeros(pad, np.int32)]),
        dst=np.concatenate([dst, np.full(pad, n, np.int32)]),
        weight=np.concatenate([w, np.zeros(pad, np.float32)]),
        estarts=np.searchsorted(dst, bounds).astype(np.int32),
        tsrc=np.concatenate([dst[torder], np.zeros(pad, np.int32)]),
        tdst=np.concatenate([src[torder], np.full(pad, n, np.int32)]),
        tweight=np.concatenate([w[torder], np.zeros(pad, np.float32)]),
        tstarts=np.searchsorted(src[torder], bounds).astype(np.int32)), n


@pytest.mark.parametrize("feat, backend", [
    (300, "xla"), (1024, "xla"), (300, "pallas_interpret")])
def test_block_spmm_wide_matches_jax(feat, backend):
    """Weighted (the walk's form) forward, d_x and d_w."""
    rng = np.random.default_rng(feat)
    plan, n = _block_plan(rng, 3)
    x = rng.standard_normal((n, feat)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    j = {k: jnp.asarray(v) for k, v in plan.items()}

    def jax_f(xx, ww):
        return jax_spmm(xx, j["src"], j["dst"], ww, n, backend=backend,
                        block_plan=(j["estarts"], j["tsrc"], j["tdst"],
                                    j["tweight"], j["tstarts"]))

    want, vjp = jax.vjp(jax.jit(jax_f), jnp.asarray(x), j["weight"])
    want_dx, want_dw = vjp(jnp.asarray(g))
    p = {k: t(v) for k, v in plan.items()}
    xt, wt = t(x).requires_grad_(), p["weight"].clone().requires_grad_()
    got = ops.block_spmm(xt, p["src"], p["dst"], wt, p["estarts"], p["tsrc"],
                         p["tdst"], p["tweight"], p["tstarts"], n)
    got_dx, got_dw = torch.autograd.grad(got, (xt, wt), t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx),
                               **GRAD_TOL)
    np.testing.assert_allclose(got_dw.numpy(), np.asarray(want_dw),
                               **GRAD_TOL)


def _gat_inputs(rng, n, heads, head_dim):
    cnt = (rng.random((n, n)) < 0.1).astype(np.float32)
    cnt += rng.random((n, n)) < 0.02  # multiplicity 2
    cnt[5] = 0.0  # a row with no edges
    cnt[n - 8:] = 0.0  # an empty tail, as padding gives
    return (rng.standard_normal((n, heads)).astype(np.float32),
            rng.standard_normal((n, heads)).astype(np.float32),
            rng.standard_normal((n, heads, head_dim)).astype(np.float32), cnt)


@pytest.mark.parametrize("head_dim, backend", [
    (72, "xla"), (128, "xla"), (256, "xla"), (72, "pallas_interpret"),
    (256, "pallas_interpret")])
def test_flash_gat_wide_matches_jax(head_dim, backend):
    """Out, and the gradients of (out * g).sum() in the scores and v: XLA's
    fused forward and its autodiff, or the Pallas forward and flash VJP in
    interpret mode."""
    rng = np.random.default_rng(head_dim)
    sl, sr, v, cnt = _gat_inputs(rng, 48, 2, head_dim)
    g = rng.standard_normal(v.shape).astype(np.float32)

    def jax_f(a, b, c):
        if backend == "xla":
            return _fused_fwd_xla(a, b, c, jnp.asarray(cnt), slope=SLOPE)[0]
        return jax_flash_gat(a, b, c, jnp.asarray(cnt), SLOPE, True)

    want, vjp = jax.vjp(jax.jit(jax_f), *map(jnp.asarray, (sl, sr, v)))
    want_d = vjp(jnp.asarray(g))
    leaves = [t(a).requires_grad_() for a in (sl, sr, v)]
    got, _ = ops.flash_gat_attention(*leaves, t(cnt), SLOPE)
    got_d = torch.autograd.grad(got, leaves, t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for a, b, name in zip(got_d, want_d, ("d_score_l", "d_score_r", "d_v")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

DDI = dict(num_drugs=40, feat_dim=64, avg_degree=6.0, min_atoms=4,
           max_atoms=10, seed=0)


def test_config2_w1_forward_and_trainer_step_match_jax():
    """W1 on config2 (f32, dense outer: flash-GAT at head_dim 256): the
    logits of a batch of pairs, then one ``Trainer`` step's loss and every
    gradient, against JAX value_and_grad on the same pairs."""
    jcfg, cfg = _wide(jax_get_config, "config2", "W1"), _wide(
        get_config, "config2", "W1")
    assert cfg.model.feat_dim == DDI["feat_dim"] and cfg.model.dtype == (
        "float32")
    jdata = jax_prepare_device_data(jax_make_synthetic_ddi(**DDI))
    data = prepare_device_data(make_synthetic_ddi(**DDI))
    jmodel = JaxBiGNN(jcfg.model)
    params = _jax_params("config2", "W1")
    buckets = [jax.tree.map(jnp.asarray, b) for b in jdata.bucketing.batches]
    outer = jax.tree.map(jnp.asarray, jdata.outer)
    rng = np.random.default_rng(0)
    pos = data.train_pairs[rng.permutation(len(data.train_pairs))[:32]]
    neg = rng.integers(0, DDI["num_drugs"], (32, 2)).astype(np.int32)
    mask = np.ones(32, np.float32)
    pairs = np.concatenate([pos, neg])

    def loss_fn(p):
        logits = jmodel.apply(p, buckets, jdata.bucketing.graph_index, outer,
                              jnp.asarray(pairs))
        labels = jnp.concatenate([jnp.ones(32), jnp.zeros(32)])
        return jax_bce(logits, labels, jnp.ones(64)), logits

    with jax_ops.backend_scope("xla"):
        (loss, logits), grads = _jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
    trainer = Trainer(BiGNN(cfg.model), data, TrainConfig(lr=1e-3),
                      device="cpu")
    trainer.init(INIT_SEED)
    trainer.model.load_state_dict(bridge.params_from_jax(
        jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got_logits = trainer.model(trainer.buckets, trainer.graph_index,
                                   trainer.outer, t(pairs).long())
    _close(got_logits.numpy(), logits, 1e-5, "logits")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dp_mod, "sample_negative_pairs",
                   lambda key, p, n, r: t(neg))
        got = trainer.train_step(pos, mask, 0, 0)
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5, atol=1e-5)
    want_g = bridge.params_from_jax(jax.tree.map(np.asarray, grads))
    for name, p in trainer.model.named_parameters():
        _close(p.grad.numpy(), want_g[name].numpy(), 1e-5, name)


MB = dict(num_drugs=64, avg_degree=10.0)
MB_KW = dict(fanouts=(10,), max_drugs=64, calibrate_caps=4)


@pytest.fixture(scope="module")
def mb_data():
    return (jax_load_dataset("synthetic-large", **MB),
            load_dataset("synthetic-large", **MB))


def _mb_step(jds, ds, wide, dtype):
    """One step of config4 with ``wide``'s layers in ``dtype`` on the same
    compact batch: (JAX loss, JAX gradients, port loss, port gradients),
    the gradients as the port's named float32 tensors."""
    jcfg, cfg = _wide(jax_get_config, "config4", wide), _wide(
        get_config, "config4", wide)
    assert cfg.model.dtype == "bfloat16"  # config4 as configured
    jmodel = dataclasses.replace(jcfg.model, dtype=dtype)
    jtr = JaxMinibatchTrainer(JaxBiGNN(jmodel), jds,
                              JaxTrainConfig(lr=3e-4, batch_size=16), **MB_KW)
    params = _jax_params("config4", wide)  # the same in either dtype
    jcb = jax.tree.map(jnp.asarray, jtr.sampler.sample_compact_at(0, 2))
    with jax_ops.backend_scope("xla"):
        loss, grads = _jit(jax.value_and_grad(jtr._loss))(params, jcb,
                                                          jtr.tables)
    tr = MinibatchTrainer(BiGNN(dataclasses.replace(cfg.model, dtype=dtype)),
                          ds, TrainConfig(lr=3e-4, batch_size=16), **MB_KW,
                          device="cpu")
    tr.model.load_state_dict(bridge.params_from_jax(
        jax.tree.map(np.asarray, params)))
    got = tr.train_step(tr.sampler.sample_compact_at(0, 2))
    return (float(loss), bridge.params_from_jax(jax.tree.map(np.asarray,
                                                             grads)),
            got.item(), {k: p.grad.clone() for k, p in
                         tr.model.named_parameters()})


def _bf16_readings(j32, jg32, j16, jg16, p32, pg32, p16, pg16) -> dict:
    """The bf16 step's distances from JAX's and their bounds, every bound
    from JAX's own bf16 noise on this batch (its bf16 step against its
    float32 step), none from the port's: ``{what: (distance, bound)}`` for
    the loss, each gradient, and the whole gradient's distance from
    float32 (see test_config4_wide_minibatch_step_matches_jax)."""
    def flat(d):
        return torch.cat([v.flatten() for v in d.values()])

    jax_err = float((flat(jg16) - flat(jg32)).norm())
    step_noise = jax_err / float(flat(jg32).norm())
    out = {"loss": (abs(p16 - j16),
                    1e-2 * max(1.0, abs(j16)) + 2 * abs(j16 - j32))}
    for name, g in pg16.items():
        ref = jg16[name].numpy()
        top = float(np.abs(ref).max())
        noise = max(float(np.abs(ref - jg32[name].numpy()).max()),
                    step_noise * top)
        out[name] = (float(np.abs(g.numpy() - ref).max()),
                     1e-2 * max(1.0, top) + 2 * noise)
    out["2-norm from float32"] = (
        float((flat(pg16) - flat(pg32)).norm()),
        2 * jax_err + 1e-2 * float(flat(jg32).norm()))
    return out


@pytest.mark.parametrize("wide", ["W1", "W2"])
def test_config4_wide_minibatch_step_matches_jax(mb_data, wide):
    """One ``MinibatchTrainer`` step of config4 with W1 (row 6 at F 300,
    row 8 at H.D 1024 under the sparse outer GAT) or W2 (rows 4 and 8 at 32
    heads), on the same compact batch in both packages.

    float32: loss and every gradient within 1e-5 x max(1, max |ref|).
    bf16, config4's compute type: JAX rounds every bf16 message and partial
    sum, the port sums in float32 and rounds once, so the two bf16 steps
    differ by rounding (at 32 heads a gradient moves by up to ~0.4 of its
    scale between JAX's bf16 and float32 steps, 0.15 of the whole step's
    2-norm; the loss by up to 1.2 %). Each bound is 1e-2 x max(1, max
    |ref|) plus twice JAX's bf16 noise on this batch, and the port's own
    bf16 noise enters none: the loss's noise is |bf16 - f32| of JAX's
    loss; a gradient's the larger of that tensor's max |bf16 - f32| and
    the whole step's relative 2-norm distance times the tensor's max |ref|
    (one sample is no measure of a scalar's noise: GIN's eps lands 0.002
    of 1.9 from float32 in JAX's bf16 step and 0.03 in the port's); and
    over all gradients together the port's bf16 step lies no farther from
    float32 than twice JAX's (in the 2-norm, plus 1e-2 of its norm).
    ``python tests/test_torch_wide.py SEED ...`` prints each bound's
    reading for other init seeds."""
    jds, ds = mb_data
    j32, jg32, p32, pg32 = _mb_step(jds, ds, wide, "float32")
    np.testing.assert_allclose(p32, j32, rtol=1e-5, atol=1e-5)
    for name, g in pg32.items():
        _close(g.numpy(), jg32[name].numpy(), 1e-5, name)
    j16, jg16, p16, pg16 = _mb_step(jds, ds, wide, "bfloat16")
    readings = _bf16_readings(j32, jg32, j16, jg16, p32, pg32, p16, pg16)
    for what, (dist, bound) in readings.items():
        assert dist <= bound, (what, dist, bound)


@pytest.mark.parametrize("wide", ["W1", "W2"])
def test_wide_params_map_one_to_one(wide):
    """W1's and W2's parameters: ``bridge.params_from_jax`` of the JAX init
    gives every parameter of the port's model, shape for shape, and the
    port's own init for the same seed is that tree."""
    params = _jax_params("config4", wide)
    got = bridge.params_from_jax(jax.tree.map(np.asarray, params))
    model = BiGNN(_wide(get_config, "config4", wide).model, seed=INIT_SEED)
    want = model.state_dict()
    assert {k: v.shape for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}
    for name, v in want.items():
        assert torch.equal(got[name], v), name


if __name__ == "__main__":
    # the bf16 step's readings (distance / bound, the worst gradient) at
    # the init seeds given, e.g. ``python tests/test_torch_wide.py 1 2 3``,
    # and how many of its gradients, each alone zeroed, negated or scaled
    # by 1.5, the bounds catch
    import sys

    mb = (jax_load_dataset("synthetic-large", **MB),
          load_dataset("synthetic-large", **MB))
    for seed in map(int, sys.argv[1:]):
        INIT_SEED = seed
        _jax_params.cache_clear()
        for wide in OUTER:
            j32, jg32, p32, pg32 = _mb_step(*mb, wide, "float32")
            j16, jg16, p16, pg16 = _mb_step(*mb, wide, "bfloat16")
            readings = _bf16_readings(j32, jg32, j16, jg16, p32, pg32, p16,
                                      pg16)
            ratio = {k: d / b for k, (d, b) in readings.items()}
            grads = [k for k in ratio if k in pg32]
            worst = max(grads, key=ratio.get)
            caught = {}
            for how, f in (("zeroed", lambda g: 0 * g), ("negated",
                           lambda g: -g), ("x1.5", lambda g: 1.5 * g)):
                caught[how] = sum(
                    any(d > b for d, b in _bf16_readings(
                        j32, jg32, j16, jg16, p32, pg32, p16,
                        {**pg16, name: f(pg16[name])}).values())
                    for name in pg16)
            print(f"seed {seed} {wide}: loss {ratio['loss']:.3f}, worst "
                  f"gradient {ratio[worst]:.3f} ({worst}), 2-norm "
                  f"{ratio['2-norm from float32']:.3f}; caught of "
                  f"{len(pg16)}: {caught}", flush=True)
