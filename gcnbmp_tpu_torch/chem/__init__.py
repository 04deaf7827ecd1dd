"""Chemistry layer of the port: SMILES parsing, GGNN featurization, the
dense Weave and DrugFP featurizers, the molecule transforms and mol2vec,
the port's own copy of what it takes from ``gcnbmp_tpu.chem`` (numpy
only)."""

from gcnbmp_tpu_torch.chem.featurize import (
    DrugFPFeaturizer,
    GGNNFeaturizer,
    MolGraph,
    WeaveFeaturizer,
)
from gcnbmp_tpu_torch.chem.mol2vec import (
    Mol2VecFeaturizer,
    identifier_table_from_corpus,
    mol2vec_table,
    morgan_sentence,
)
from gcnbmp_tpu_torch.chem.smiles import SmilesError, mol_from_smiles

__all__ = [
    "Mol2VecFeaturizer",
    "identifier_table_from_corpus",
    "mol2vec_table",
    "morgan_sentence",
    "DrugFPFeaturizer",
    "GGNNFeaturizer",
    "MolGraph",
    "WeaveFeaturizer",
    "SmilesError",
    "mol_from_smiles",
]
