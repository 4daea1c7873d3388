"""The in-repo real drugs (``ddi-sample``) in the port: the SMILES parse
equals the JAX package's array for array, and config2-real clears the JAX
package's learning gate (tests/test_real_data.py:41-67) through the port's
Trainer on the CPU."""

import dataclasses

import numpy as np
import pytest

from bignn_tpu.data import load_dataset as jax_load_dataset
from bignn_tpu.data.molecules import parse_smiles as jax_parse_smiles

from bignn_tpu_torch.config import get_config
from bignn_tpu_torch.data import load_dataset, prepare_device_data
from bignn_tpu_torch.data.molecules import SmilesError, parse_smiles
from bignn_tpu_torch.data.real_sample import SMILES
from bignn_tpu_torch.models import BiGNN
from bignn_tpu_torch.train import Trainer


@pytest.mark.parametrize("seed", [0, 3])
def test_ddi_sample_matches_jax(seed):
    port, ref = load_dataset("ddi-sample", seed=seed), jax_load_dataset(
        "ddi-sample", seed=seed)
    assert port.name == ref.name and port.drug_names == ref.drug_names
    assert port.num_drugs == ref.num_drugs == len(SMILES)
    for a, b in zip(port.molecules, ref.molecules, strict=True):
        np.testing.assert_array_equal(a.node_feat, b.node_feat)
        np.testing.assert_array_equal(a.src, b.src)
        np.testing.assert_array_equal(a.dst, b.dst)
    for name in ("edges", "train_idx", "val_idx", "test_idx"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))


@pytest.mark.parametrize("smiles", [
    "C1CC%12CC1CC%12", "[NH4+].[Cl-]", "O=[N+]([O-])c1ccccc1", "C/C=C\\C"])
def test_parse_smiles_matches_jax(smiles):
    assert parse_smiles(smiles) == jax_parse_smiles(smiles)


def test_parse_smiles_rejects_bad_input():
    for bad in ("C1CC", "C)C", "", "C$"):
        with pytest.raises(SmilesError):
            parse_smiles(bad)


def test_config2_real_reaches_auc():
    """The JAX gate: config2 (GIN x2 -> sum -> GAT -> mlp) at width 16 on
    the real drugs, 60 epochs, seeds 0 and 1; the means of the best val AUC
    and of the test AUC must both reach 0.70. The port draws the JAX
    package's init and negatives for a seed (prng.py), so it runs the same
    experiment as the JAX gate."""
    cfg = get_config("config2-real")
    ds = load_dataset(cfg.dataset)
    data = prepare_device_data(ds)
    best_vals, tests = [], []
    for seed in (0, 1):
        model = BiGNN(dataclasses.replace(cfg.model, feat_dim=ds.feat_dim))
        trainer = Trainer(model, data, dataclasses.replace(cfg.train,
                                                           seed=seed),
                          device="cpu")
        _, result = trainer.fit()
        best_vals.append(max(r["val_auc"] for r in result["history"]))
        tests.append(result["test_auc"])
    assert np.mean(best_vals) >= 0.70, best_vals
    assert np.mean(tests) >= 0.70, tests
