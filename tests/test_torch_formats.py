"""Host layouts of the PyTorch port against the JAX package: the same seed
or the same NumPy inputs give equal arrays (exact: both sides run the same
NumPy code and load the same native library)."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from bignn_tpu import native as jax_native
from bignn_tpu.data import make_synthetic_ddi as jax_make_synthetic_ddi
from bignn_tpu.data import prepare_device_data as jax_prepare_device_data
from bignn_tpu.data.datasets import load_dataset as jax_load_dataset
from bignn_tpu.data.datasets import save_npz_cache
from bignn_tpu.sparse import bucketing as jax_bucketing
from bignn_tpu.sparse import formats as jax_formats

from bignn_tpu_torch import native
from bignn_tpu_torch.data import load_dataset, make_synthetic_ddi, prepare_device_data
from bignn_tpu_torch.sparse import bucketing, formats

KW = dict(num_drugs=40, feat_dim=8, avg_degree=6.0, min_atoms=4,
          max_atoms=10, seed=3)


def assert_same_fields(port, ref):
    """Every field of the port's container equals the JAX one's."""
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if a is None or b is None:
            assert a is None and b is None, f.name
            continue
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f.name)
        assert np.asarray(a).dtype == np.asarray(b).dtype, f.name


def assert_same_dataset(port, ref):
    assert port.name == ref.name
    for key in ("edges", "train_idx", "val_idx", "test_idx"):
        np.testing.assert_array_equal(getattr(port, key), getattr(ref, key))
    assert len(port.molecules) == len(ref.molecules)
    for a, b in zip(port.molecules, ref.molecules):
        assert_same_fields(a, b)


@pytest.fixture(scope="module")
def datasets():
    return make_synthetic_ddi(**KW), jax_make_synthetic_ddi(**KW)


def test_synthetic_dataset_bit_equal(datasets):
    assert_same_dataset(*datasets)


@pytest.mark.parametrize("block_local", [False, True])
@pytest.mark.parametrize("normalize", [True, False])
def test_padded_batch_equal(datasets, block_local, normalize):
    port_ds, jax_ds = datasets
    mols = slice(0, 17)
    n_nodes = sum(m.num_nodes for m in port_ds.molecules[mols])
    n_edges = sum(m.num_edges for m in port_ds.molecules[mols]) + n_nodes
    node_cap = 512 if block_local else n_nodes + 5
    edge_cap = n_edges + 64
    kw = dict(normalize=normalize, block_local=block_local)
    port = formats.build_padded_batch(port_ds.molecules[mols], node_cap,
                                      edge_cap, **kw)
    ref = jax_formats.build_padded_batch(jax_ds.molecules[mols], node_cap,
                                         edge_cap, **kw)
    assert_same_fields(port, ref)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("dense_max_nodes", [4096, 0])
def test_outer_graph_equal(datasets, normalize, dense_max_nodes):
    port_ds, jax_ds = datasets
    tr = port_ds.split_edges("train")
    port = formats.build_outer_graph(tr[:, 0], tr[:, 1], port_ds.num_drugs,
                                     normalize=normalize,
                                     dense_max_nodes=dense_max_nodes)
    ref = jax_formats.build_outer_graph(tr[:, 0], tr[:, 1], jax_ds.num_drugs,
                                        normalize=normalize,
                                        dense_max_nodes=dense_max_nodes)
    assert_same_fields(port, ref)


def test_bucketing_and_device_data_equal(datasets):
    port_ds, jax_ds = datasets
    n_counts = [m.num_nodes for m in port_ds.molecules]
    assert bucketing.plan_buckets(n_counts) == jax_bucketing.plan_buckets(
        n_counts)
    port = prepare_device_data(port_ds)
    ref = jax_prepare_device_data(jax_ds)
    assert port.bucketing.num_buckets == ref.bucketing.num_buckets > 1
    for a, b in zip(port.bucketing.graph_index, ref.bucketing.graph_index):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(port.bucketing.batches, ref.bucketing.batches):
        assert_same_fields(a, b)
    assert_same_fields(port.outer, ref.outer)
    for key in ("train_pairs", "val_pairs", "test_pairs"):
        np.testing.assert_array_equal(getattr(port, key), getattr(ref, key))


def test_native_library_shared():
    """Both packages load one library: greedy packing would differ between
    the library and the NumPy fallback."""
    assert native.LIB_PATH == Path(jax_native._LIB_PATH).resolve()
    assert native.available() and jax_native.available()
    sizes = np.random.default_rng(0).integers(1, 60, 300).astype(np.int32)
    off, extent = native.greedy_pack_blocks(sizes, 128)
    joff, jextent = jax_native.greedy_pack_blocks(sizes, 128)
    np.testing.assert_array_equal(off, joff)
    assert extent == jextent


def test_standin_and_npz_cache_equal(tmp_path, datasets):
    kw = dict(num_drugs=30, avg_degree=8.0)
    assert_same_dataset(load_dataset("drugbank", data_root=str(tmp_path), **kw),
                        jax_load_dataset("drugbank", data_root=str(tmp_path),
                                         **kw))
    _, jax_ds = datasets
    save_npz_cache(jax_ds, str(tmp_path / "biosnap.npz"))
    port = load_dataset("biosnap", data_root=str(tmp_path))
    ref = jax_load_dataset("biosnap", data_root=str(tmp_path))
    assert_same_dataset(port, ref)
    np.testing.assert_array_equal(port.edges, jax_ds.edges)


def test_unported_datasets_raise(tmp_path):
    """A raw reference cache goes to the converter (data/convert.py), which
    refuses an empty one as JAX's does; an unknown name raises."""
    (tmp_path / "drugbank.pkl").write_bytes(b"")  # an empty raw cache
    with pytest.raises(EOFError):
        jax_load_dataset("drugbank", data_root=str(tmp_path))
    with pytest.raises(EOFError):
        load_dataset("drugbank", data_root=str(tmp_path))
    assert not (tmp_path / "drugbank.npz").exists()
    with pytest.raises(ValueError, match="unknown dataset"):
        load_dataset("no-such-set")
