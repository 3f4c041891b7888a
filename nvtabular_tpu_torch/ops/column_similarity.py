"""ColumnSimilarity (counterpart of nvtabular_tpu/ops/column_similarity.py):
the inner-product, cosine or tf-idf similarity of two id columns' rows of
CSR feature matrices (scipy sparse, or an ``(indptr, indices, data[,
ncols])`` tuple). It runs on the host with numpy, as the reference's does;
``on_device`` is accepted and unused there too. (The reference's docstring
names a device kernel, ``kernels/similarity.py``, which does not exist:
ROADMAP.md queue 3.)
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .. import dtypes as md
from ..selector import ColumnSelector
from ..table import Column, TableBatch
from .operator import Operator


class ColumnSimilarity(Operator):
    runs_on_host = True

    def __init__(self, left_features, right_features=None, metric: str = "tfidf", on_device: bool = False):
        super().__init__()
        if metric not in ("inner", "cosine", "tfidf"):
            raise ValueError("metric must be inner|cosine|tfidf")
        self.left_features = _to_csr(left_features)
        self.right_features = _to_csr(right_features) if right_features is not None else self.left_features
        self.metric = metric
        self.on_device = on_device
        self._left_proc = None
        self._right_proc = None

    def _processed(self):
        if self._left_proc is None:
            self._left_proc = _preprocess(self.left_features, self.metric)
            same = self.right_features is self.left_features
            self._right_proc = self._left_proc if same else _preprocess(self.right_features, self.metric)
        return self._left_proc, self._right_proc

    def host_inputs(self, col_selector: ColumnSelector, batch: TableBatch) -> List[str]:
        return list(col_selector.names)

    def column_mapping(self, col_selector: ColumnSelector):
        names = col_selector.names
        if len(names) != 2:
            raise ValueError("ColumnSimilarity requires exactly two id columns")
        return {f"{names[0]}_{names[1]}_sim": list(names)}

    def transform(self, col_selector: ColumnSelector, batch: TableBatch) -> TableBatch:
        left, right = self._processed()
        a, b = col_selector.names
        sims = _rowwise_inner(left, np.asarray(batch[a].values).astype(np.int64), right,
                              np.asarray(batch[b].values).astype(np.int64))
        out = TableBatch()
        out[f"{a}_{b}_sim"] = Column(sims.astype(np.float32))
        return out

    @property
    def output_dtype(self):
        return md.float32


def _to_csr(features) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """→ (indptr, indices, data, ncols) from a scipy-like matrix or a tuple."""
    if isinstance(features, tuple) and len(features) in (3, 4):
        indptr, indices, data = features[:3]
        ncols = features[3] if len(features) == 4 else int(np.max(indices)) + 1 if len(indices) else 0
        return (np.asarray(indptr, dtype=np.int64), np.asarray(indices, dtype=np.int64),
                np.asarray(data, dtype=np.float64), ncols)
    if hasattr(features, "tocsr"):
        csr = features.tocsr()
        return csr.indptr.astype(np.int64), csr.indices.astype(np.int64), csr.data.astype(np.float64), csr.shape[1]
    raise TypeError("features must be a CSR matrix or (indptr, indices, data) tuple")


def _preprocess(csr, metric: str):
    """tf-idf weights, then L2-normalized rows for cosine and tf-idf
    (column_similarity.py:130-147)."""
    indptr, indices, data, ncols = csr
    data = data.copy()
    if metric == "tfidf":
        df = np.bincount(indices, minlength=ncols).astype(np.float64)
        data = data * (np.log((len(indptr) - 1 + 1) / (df + 1)) + 1.0)[indices]
    if metric in ("cosine", "tfidf"):
        norm = np.sqrt(np.add.reduceat(data * data, indptr[:-1])) if len(indptr) > 1 else np.array([])
        data = data / np.repeat(np.where(norm > 0, norm, 1.0), np.diff(indptr))
    return indptr, indices, data, ncols


def _rowwise_inner(left, a_ids, right, b_ids) -> np.ndarray:
    """The sparse inner product of each row pair (a_ids[i], b_ids[i]); 0
    where an id is outside its matrix."""
    l_indptr, l_indices, l_data, _ = left
    r_indptr, r_indices, r_data, _ = right
    out = np.zeros(len(a_ids), dtype=np.float64)
    for i, (a, b) in enumerate(zip(a_ids, b_ids)):
        if not (0 <= a < len(l_indptr) - 1 and 0 <= b < len(r_indptr) - 1):
            continue
        la, lb = slice(l_indptr[a], l_indptr[a + 1]), slice(r_indptr[b], r_indptr[b + 1])
        common, ia, ib = np.intersect1d(l_indices[la], r_indices[lb], return_indices=True)
        if len(common):
            out[i] = np.dot(l_data[la][ia], r_data[lb][ib])
    return out
