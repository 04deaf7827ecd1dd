"""CSV pair parsers (the port's copy of gcnbmp_tpu/data/parsers.py's
``CSVPairParser`` and ``get_class_labels``).

Read a CSV of SMILES pairs + label column(s), featurize both molecules,
skip unparseable rows with a fail count.  Multi-label mode accepts
``||``-delimited label strings and binarizes them against a class list
(reference: train_ggnn_hole_multi_class_x37.py:274 ``to_multi_hot_labels``).
The native batch parser (native/smiles.cpp) is used when it builds; the
pure-Python parser gives the same graphs otherwise.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import pandas as pd

from gcnbmp_tpu_torch.chem.featurize import FeaturizeError, GGNNFeaturizer
from gcnbmp_tpu_torch.chem.smiles import mol_from_smiles
from gcnbmp_tpu_torch.data.dataset import PairDataset

logger = logging.getLogger(__name__)


@dataclass
class ParseResult:
    dataset: PairDataset
    is_successful: np.ndarray  # bool per input row
    fail_count: int
    total_count: int


@dataclass
class CSVPairParser:
    """Parse a pair CSV into a PairDataset.

    Args:
        featurizer: callable Mol -> MolGraph (default GGNNFeaturizer()).
        labels: label column name(s).  A single column with numeric values
            gives scalar labels; ``multi_label_classes`` switches to
            multi-hot parsing of ``||``-delimited strings.
        smiles_cols: the two SMILES column names
            (reference default ['smiles_1', 'smiles_2'], parsers.py:137).
    """

    featurizer: Optional[Callable] = None
    labels: Sequence[str] = ("label",)
    smiles_cols: Sequence[str] = ("smiles_1", "smiles_2")
    multi_label_classes: Optional[Sequence[str]] = None
    label_delimiter: str = "||"
    use_native: bool = True  # batch-parse via native/smiles.cpp when possible

    def __post_init__(self):
        self._default_featurizer = self.featurizer is None
        if self.featurizer is None:
            self.featurizer = GGNNFeaturizer()
        self._cls_index = (
            {c: i for i, c in enumerate(self.multi_label_classes)}
            if self.multi_label_classes is not None else None
        )

    def _native_graphs(self, df, c1, c2):
        """Batch-parse all SMILES with the native library.  Returns None
        if it is unavailable or a custom featurizer is in use (the rows
        are then parsed one by one in Python)."""
        if not (self.use_native and self._default_featurizer):
            return None
        from gcnbmp_tpu_torch.chem.native import (
            native_available, parse_smiles_batch_native)

        if not native_available():
            return None
        smiles = list(df[c1].astype(str)) + list(df[c2].astype(str))
        graphs = parse_smiles_batch_native(smiles)
        n = len(df)
        return graphs[:n], graphs[n:]

    def _parse_label(self, row) -> np.ndarray:
        if self.multi_label_classes is not None:
            cls_index = self._cls_index
            vec = np.zeros((len(cls_index),), dtype=np.float32)
            raw = str(row[self.labels[0]])
            for part in raw.split(self.label_delimiter):
                part = part.strip()
                if part in cls_index:
                    vec[cls_index[part]] = 1.0
            return vec
        vals = [np.float32(row[c]) for c in self.labels]
        return np.asarray(vals[0] if len(vals) == 1 else vals, dtype=np.float32)

    def parse(self, filepath_or_df) -> ParseResult:
        if isinstance(filepath_or_df, pd.DataFrame):
            df = filepath_or_df
        else:
            df = pd.read_csv(filepath_or_df)
        ds = PairDataset()
        ok = np.zeros((len(df),), dtype=bool)
        fail = 0
        c1, c2 = self.smiles_cols
        native = self._native_graphs(df, c1, c2)
        if native is not None:
            # graphs already batch-parsed; take the label columns once as
            # plain lists instead of pandas iterrows
            label_cols = {c: df[c].tolist() for c in self.labels}
            for i in range(len(df)):
                g1, g2 = native[0][i], native[1][i]
                if g1 is None or g2 is None:
                    fail += 1
                    continue
                row = {c: label_cols[c][i] for c in self.labels}
                ds.append(g1, g2, self._parse_label(row))
                ok[i] = True
            if fail:
                logger.info(
                    "skipped %d/%d unparseable pair rows", fail, len(df)
                )
            return ParseResult(
                dataset=ds, is_successful=ok, fail_count=fail,
                total_count=len(df),
            )
        for i, (_, row) in enumerate(df.iterrows()):
            smi1, smi2 = str(row[c1]), str(row[c2])
            m1 = mol_from_smiles(smi1)
            m2 = mol_from_smiles(smi2)
            if m1 is None or m2 is None:
                fail += 1
                logger.debug("parse failure at row %d: %r / %r", i, smi1, smi2)
                continue
            try:
                g1 = self.featurizer(m1)
                g2 = self.featurizer(m2)
            except FeaturizeError as e:
                fail += 1
                logger.debug("featurize failure at row %d: %s", i, e)
                continue
            ds.append(g1, g2, self._parse_label(row))
            ok[i] = True
        if fail:
            logger.info("skipped %d/%d unparseable pair rows", fail, len(df))
        return ParseResult(
            dataset=ds, is_successful=ok, fail_count=fail, total_count=len(df)
        )


def get_class_labels(labels_csv: str, column: str = "label") -> List[str]:
    """Read the class list for multi-label tasks (reference:
    train_ggnn_hole_multi_class_x37.py get_class_num over labels.csv)."""
    df = pd.read_csv(labels_csv)
    return [str(x) for x in df[column].tolist()]
