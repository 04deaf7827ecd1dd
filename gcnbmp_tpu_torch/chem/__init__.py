"""Chemistry layer of the port: SMILES parsing, GGNN featurization, the
molecule transforms and mol2vec, the port's own copy of what it takes
from ``gcnbmp_tpu.chem`` (numpy only)."""

from gcnbmp_tpu_torch.chem.featurize import GGNNFeaturizer, MolGraph
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
    "GGNNFeaturizer",
    "MolGraph",
    "SmilesError",
    "mol_from_smiles",
]
