"""The in-repo sample of real drugs and interactions (counterpart of
``bignn_tpu/data/real_sample.py``, the same data, copied because the port
imports nothing of the JAX package):

  * ``SMILES``: 66 marketed small-molecule drugs with their structures as
    commonly published (stereo is ignored by the featurizer);
  * ``INTERACTIONS``: well-documented pairwise drug-drug interactions from
    the clinical literature, each a positive DDI edge.

A sample for correctness and learning gates, not the full DrugBank graph.
Load it with ``load_dataset("ddi-sample")``.
"""

from __future__ import annotations

import numpy as np

SMILES: dict[str, str] = {
    "aspirin": "CC(=O)Oc1ccccc1C(=O)O",
    "warfarin": "CC(=O)CC(c1ccccc1)c1c(O)c2ccccc2oc1=O",
    "ibuprofen": "CC(C)Cc1ccc(C(C)C(=O)O)cc1",
    "naproxen": "COc1ccc2cc(C(C)C(=O)O)ccc2c1",
    "diclofenac": "O=C(O)Cc1ccccc1Nc1c(Cl)cccc1Cl",
    "acetaminophen": "CC(=O)Nc1ccc(O)cc1",
    "caffeine": "Cn1cnc2c1c(=O)n(C)c(=O)n2C",
    "theophylline": "Cn1c(=O)c2[nH]cnc2n(C)c1=O",
    "metformin": "CN(C)C(=N)NC(=N)N",
    "omeprazole": "COc1ccc2[nH]c(S(=O)Cc3ncc(C)c(OC)c3C)nc2c1",
    "cimetidine": "Cc1nc[nH]c1CSCCNC(=NC#N)NC",
    "simvastatin": "CCC(C)(C)C(=O)OC1CC(C)C=C2C=CC(C)C(CCC3CC(O)CC(=O)O3)C21",
    "gemfibrozil": "Cc1ccc(C)c(OCCCC(C)(C)C(=O)O)c1",
    "amiodarone": "CCCCc1oc2ccccc2c1C(=O)c1cc(I)c(OCCN(CC)CC)c(I)c1",
    "quinidine": "COc1ccc2nccc(C(O)C3CC4CCN3CC4C=C)c2c1",
    "verapamil": "COc1ccc(CCN(C)CCCC(C#N)(C(C)C)c2ccc(OC)c(OC)c2)cc1OC",
    "diltiazem": "CC(=O)OC1C(c2ccc(OC)cc2)Sc2ccccc2N(CCN(C)C)C1=O",
    "metoprolol": "COCCc1ccc(OCC(O)CNC(C)C)cc1",
    "propranolol": "CC(C)NCC(O)COc1cccc2ccccc12",
    "atenolol": "CC(C)NCC(O)COc1ccc(CC(N)=O)cc1",
    "lisinopril": "NCCCCC(NC(CCc1ccccc1)C(=O)O)C(=O)N1CCCC1C(=O)O",
    "losartan": "CCCCc1nc(Cl)c(CO)n1Cc1ccc(-c2ccccc2-c2nn[nH]n2)cc1",
    "furosemide": "NS(=O)(=O)c1cc(C(=O)O)c(NCc2ccco2)cc1Cl",
    "hydrochlorothiazide": "NS(=O)(=O)c1cc2c(cc1Cl)NCNS2(=O)=O",
    "nitroglycerin": "O=[N+]([O-])OCC(O[N+](=O)[O-])CO[N+](=O)[O-]",
    "sildenafil": (
        "CCCc1nn(C)c2c(=O)[nH]c(-c3cc(S(=O)(=O)N4CCN(C)CC4)ccc3OCC)nc12"),
    "clopidogrel": "COC(=O)C(c1ccccc1Cl)N1CCc2sccc2C1",
    "phenytoin": "O=C1NC(=O)C(c2ccccc2)(c2ccccc2)N1",
    "carbamazepine": "NC(=O)N1c2ccccc2C=Cc2ccccc21",
    "valproic_acid": "CCCC(CCC)C(=O)O",
    "phenobarbital": "CCC1(c2ccccc2)C(=O)NC(=O)NC1=O",
    "lamotrigine": "Nc1nnc(-c2cccc(Cl)c2Cl)c(N)n1",
    "diazepam": "CN1C(=O)CN=C(c2ccccc2)c2cc(Cl)ccc21",
    "midazolam": "Cc1ncc2n1-c1ccc(Cl)cc1C(=NC2)c1ccccc1F",
    "alprazolam": "Cc1nnc2n1-c1ccc(Cl)cc1C(=NC2)c1ccccc1",
    "morphine": "CN1CCC23c4c5ccc(O)c4OC2C(O)C=CC3C1C5",
    "tramadol": "COc1cccc(C2(O)CCCCC2CN(C)C)c1",
    "fentanyl": "CCC(=O)N(c1ccccc1)C1CCN(CCc2ccccc2)CC1",
    "gabapentin": "NCC1(CC(=O)O)CCCCC1",
    "fluoxetine": "CNCCC(Oc1ccc(C(F)(F)F)cc1)c1ccccc1",
    "sertraline": "CNC1CCC(c2ccc(Cl)c(Cl)c2)c2ccccc21",
    "paroxetine": "Fc1ccc(C2CCNCC2COc2ccc3c(c2)OCO3)cc1",
    "citalopram": "CN(C)CCCC1(c2ccc(F)cc2)OCc2cc(C#N)ccc21",
    "venlafaxine": "COc1ccc(C(CN(C)C)C2(O)CCCCC2)cc1",
    "duloxetine": "CNCCC(Oc1cccc2ccccc12)c1cccs1",
    "bupropion": "CC(NC(C)(C)C)C(=O)c1cccc(Cl)c1",
    "selegiline": "C#CCN(C)C(C)Cc1ccccc1",
    "phenelzine": "NNCCc1ccccc1",
    "tranylcypromine": "NC1CC1c1ccccc1",
    "linezolid": "CC(=O)NCC1CN(c2ccc(N3CCOCC3)c(F)c2)C(=O)O1",
    "haloperidol": "O=C(CCCN1CCC(O)(c2ccc(Cl)cc2)CC1)c1ccc(F)cc1",
    "clozapine": "CN1CCN(C2=Nc3cc(Cl)ccc3Nc3ccccc32)CC1",
    "olanzapine": "Cc1cc2c(s1)Nc1ccccc1N=C2N1CCN(C)CC1",
    "tamoxifen": "CCC(=C(c1ccccc1)c1ccc(OCCN(C)C)cc1)c1ccccc1",
    "methotrexate": (
        "CN(Cc1cnc2nc(N)nc(N)c2n1)c1ccc(C(=O)NC(CCC(=O)O)C(=O)O)cc1"),
    "azathioprine": "Cn1cnc(Sc2ncnc3[nH]cnc23)c1[N+](=O)[O-]",
    "allopurinol": "O=c1[nH]cnc2[nH]ncc12",
    "trimethoprim": "COc1cc(Cc2cnc(N)nc2N)cc(OC)c1OC",
    "sulfamethoxazole": "Cc1cc(NS(=O)(=O)c2ccc(N)cc2)no1",
    "amoxicillin": "CC1(C)SC2C(NC(=O)C(N)c3ccc(O)cc3)C(=O)N2C1C(=O)O",
    "ciprofloxacin": "O=C(O)c1cn(C2CC2)c2cc(N3CCNCC3)c(F)cc2c1=O",
    "metronidazole": "Cc1ncc([N+](=O)[O-])n1CCO",
    "fluconazole": "OC(Cn1cncn1)(Cn1cncn1)c1ccc(F)cc1F",
    "isoniazid": "NNC(=O)c1ccncc1",
    "levodopa": "NC(Cc1ccc(O)c(O)c1)C(=O)O",
    "ethanol": "CCO",
}

# Well-documented pairwise interactions (positive DDI edges). Grouped by
# mechanism for auditability; each name must appear in SMILES above.
INTERACTIONS: list[tuple[str, str]] = [
    # anticoagulant + NSAIDs / CYP2C9 inhibitors / enzyme inducers
    ("warfarin", "aspirin"), ("warfarin", "ibuprofen"),
    ("warfarin", "naproxen"), ("warfarin", "diclofenac"),
    ("warfarin", "fluconazole"), ("warfarin", "amiodarone"),
    ("warfarin", "metronidazole"), ("warfarin", "trimethoprim"),
    ("warfarin", "sulfamethoxazole"), ("warfarin", "cimetidine"),
    ("warfarin", "omeprazole"), ("warfarin", "phenytoin"),
    ("warfarin", "carbamazepine"), ("warfarin", "phenobarbital"),
    ("warfarin", "quinidine"), ("warfarin", "tamoxifen"),
    ("warfarin", "fluoxetine"), ("warfarin", "sertraline"),
    ("warfarin", "amoxicillin"), ("warfarin", "simvastatin"),
    # antiplatelet combinations
    ("aspirin", "ibuprofen"), ("aspirin", "clopidogrel"),
    ("clopidogrel", "omeprazole"),
    # methotrexate clearance
    ("methotrexate", "aspirin"), ("methotrexate", "ibuprofen"),
    ("methotrexate", "naproxen"), ("methotrexate", "diclofenac"),
    ("methotrexate", "trimethoprim"), ("methotrexate", "sulfamethoxazole"),
    ("methotrexate", "amoxicillin"), ("methotrexate", "omeprazole"),
    # statin myopathy (CYP3A4 / OATP)
    ("simvastatin", "amiodarone"), ("simvastatin", "verapamil"),
    ("simvastatin", "diltiazem"), ("simvastatin", "gemfibrozil"),
    ("simvastatin", "fluconazole"),
    # serotonergic / MAOI combinations
    ("fluoxetine", "selegiline"), ("fluoxetine", "phenelzine"),
    ("fluoxetine", "tranylcypromine"), ("fluoxetine", "tramadol"),
    ("fluoxetine", "linezolid"), ("sertraline", "selegiline"),
    ("sertraline", "phenelzine"), ("sertraline", "tranylcypromine"),
    ("sertraline", "tramadol"), ("sertraline", "linezolid"),
    ("paroxetine", "selegiline"), ("paroxetine", "phenelzine"),
    ("paroxetine", "tranylcypromine"), ("paroxetine", "linezolid"),
    ("citalopram", "selegiline"), ("citalopram", "phenelzine"),
    ("citalopram", "linezolid"), ("venlafaxine", "selegiline"),
    ("venlafaxine", "phenelzine"), ("venlafaxine", "tranylcypromine"),
    ("venlafaxine", "linezolid"), ("duloxetine", "selegiline"),
    ("duloxetine", "phenelzine"), ("duloxetine", "linezolid"),
    ("tramadol", "selegiline"), ("tramadol", "phenelzine"),
    ("bupropion", "selegiline"), ("bupropion", "phenelzine"),
    ("bupropion", "tranylcypromine"), ("bupropion", "tramadol"),
    ("levodopa", "phenelzine"), ("levodopa", "tranylcypromine"),
    # CYP2D6 inhibition
    ("tamoxifen", "fluoxetine"), ("tamoxifen", "paroxetine"),
    ("metoprolol", "fluoxetine"), ("metoprolol", "paroxetine"),
    ("propranolol", "fluoxetine"), ("tramadol", "quinidine"),
    ("haloperidol", "fluoxetine"), ("fentanyl", "fluoxetine"),
    # CYP1A2 (quinolones / cimetidine)
    ("theophylline", "ciprofloxacin"), ("theophylline", "cimetidine"),
    ("theophylline", "phenytoin"), ("theophylline", "carbamazepine"),
    ("caffeine", "ciprofloxacin"), ("caffeine", "cimetidine"),
    ("clozapine", "ciprofloxacin"), ("clozapine", "fluoxetine"),
    ("olanzapine", "ciprofloxacin"),
    # CYP3A4 azole interactions
    ("midazolam", "fluconazole"), ("alprazolam", "fluconazole"),
    ("fentanyl", "fluconazole"), ("phenytoin", "fluconazole"),
    ("losartan", "fluconazole"),
    # anticonvulsant cross-induction / inhibition
    ("carbamazepine", "phenytoin"), ("carbamazepine", "valproic_acid"),
    ("carbamazepine", "verapamil"), ("carbamazepine", "diltiazem"),
    ("carbamazepine", "isoniazid"), ("carbamazepine", "cimetidine"),
    ("carbamazepine", "fluoxetine"), ("phenytoin", "valproic_acid"),
    ("phenytoin", "cimetidine"), ("phenytoin", "isoniazid"),
    ("phenytoin", "sulfamethoxazole"), ("phenytoin", "fluoxetine"),
    ("phenobarbital", "valproic_acid"), ("lamotrigine", "valproic_acid"),
    ("lamotrigine", "carbamazepine"), ("lamotrigine", "phenytoin"),
    # beta-blocker + non-dihydropyridine calcium blockers (bradycardia)
    ("verapamil", "metoprolol"), ("verapamil", "propranolol"),
    ("verapamil", "atenolol"), ("diltiazem", "metoprolol"),
    ("diltiazem", "propranolol"), ("amiodarone", "metoprolol"),
    ("amiodarone", "verapamil"), ("amiodarone", "diltiazem"),
    ("quinidine", "verapamil"), ("quinidine", "propranolol"),
    ("quinidine", "amiodarone"), ("quinidine", "cimetidine"),
    # nitrate + PDE5 (hypotension)
    ("sildenafil", "nitroglycerin"), ("sildenafil", "amiodarone"),
    # diuretic / ACE / NSAID renal axis
    ("furosemide", "ibuprofen"), ("furosemide", "aspirin"),
    ("hydrochlorothiazide", "ibuprofen"), ("lisinopril", "ibuprofen"),
    ("lisinopril", "furosemide"), ("lisinopril", "hydrochlorothiazide"),
    ("losartan", "ibuprofen"),
    # transporters / renal secretion
    ("metformin", "cimetidine"), ("metformin", "trimethoprim"),
    ("metformin", "furosemide"),
    # xanthine oxidase
    ("allopurinol", "azathioprine"), ("allopurinol", "amoxicillin"),
    # CNS depression / sedative additivity
    ("morphine", "diazepam"), ("morphine", "gabapentin"),
    ("fentanyl", "midazolam"), ("tramadol", "carbamazepine"),
    ("diazepam", "omeprazole"), ("diazepam", "cimetidine"),
    ("propranolol", "cimetidine"),
    # ethanol
    ("ethanol", "diazepam"), ("ethanol", "morphine"),
    ("ethanol", "acetaminophen"), ("ethanol", "metronidazole"),
    ("ethanol", "phenobarbital"),
    # hepatotoxicity / misc classics
    ("acetaminophen", "isoniazid"), ("acetaminophen", "warfarin"),
]


def load_real_sample(val_frac: float = 0.15, test_frac: float = 0.15,
                     seed: int = 0):
    """DDIDataset over the curated real sample (SMILES parsed and
    featurized by ``data/molecules.py``)."""
    from bignn_tpu_torch.data.molecules import build_dataset_from_smiles

    names = sorted(SMILES)
    index = {n: i for i, n in enumerate(names)}
    seen = set()
    edges = []
    for u, v in INTERACTIONS:
        if u not in index or v not in index:
            raise KeyError(f"interaction references unknown drug: {(u, v)}")
        key = (min(index[u], index[v]), max(index[u], index[v]))
        if key in seen:
            raise ValueError(f"duplicate interaction {(u, v)}")
        seen.add(key)
        edges.append(key)
    ds = build_dataset_from_smiles(
        [SMILES[n] for n in names],
        np.asarray(edges, np.int64),
        name="ddi-sample",
        val_frac=val_frac,
        test_frac=test_frac,
        seed=seed,
    )
    ds.drug_names = names  # type: ignore[attr-defined]
    return ds
