"""Chemistry layer of the port: SMILES parsing and GGNN featurization, the
port's own copy of what its parsing path takes from ``gcnbmp_tpu.chem``
(numpy only)."""

from gcnbmp_tpu_torch.chem.featurize import GGNNFeaturizer, MolGraph
from gcnbmp_tpu_torch.chem.smiles import SmilesError, mol_from_smiles

__all__ = ["GGNNFeaturizer", "MolGraph", "SmilesError", "mol_from_smiles"]
