"""Record readers and the record -> DataSet bridge (the DataVec seam).

Counterpart of ``deeplearning4j_tpu/datasets/records.py``, kept as the
port's own copy (numpy only): the reference's DataVec integration
(``datasets/datavec/RecordReaderDataSetIterator.java:52``, the sequence
variant, and the ``RecordReader``/``CSVRecordReader`` the reference
consumes as an external dependency).

A record is a list of values (floats or strings); a sequence record is a
list of records (one per time step). Readers iterate records; the
iterators batch records into the port's ``DataSet``s, splitting the label
column(s) out as the reference does (label index, numPossibleLabels,
regression flag). Sequences of unequal length are right-padded with zeros
and masked (features and labels masks, 1 on real steps), the masks the
recurrent layers and the losses read.
"""
from __future__ import annotations

import csv
import os
from typing import Iterator, List, Optional, Sequence

import numpy as np

from .dataset import DataSet, DataSetIterator


# -------------------------------------------------------------------- readers
class RecordReader:
    """DataVec ``RecordReader`` protocol: iterate lists of values."""

    def __iter__(self) -> Iterator[List]:
        self.reset()
        return self

    def __next__(self) -> List:
        raise NotImplementedError

    def reset(self):
        pass


class CollectionRecordReader(RecordReader):
    """In-memory records (DataVec ``CollectionRecordReader``)."""

    def __init__(self, records: Sequence[Sequence]):
        self._records = [list(r) for r in records]
        self._pos = 0

    def __next__(self):
        if self._pos >= len(self._records):
            raise StopIteration
        r = self._records[self._pos]
        self._pos += 1
        return r

    def reset(self):
        self._pos = 0


class CSVRecordReader(RecordReader):
    """CSV file reader (DataVec ``CSVRecordReader``): ``skip_lines`` header rows,
    custom delimiter; numeric fields parsed to float, others kept as str."""

    def __init__(self, path: str, skip_lines: int = 0, delimiter: str = ","):
        self._path = path
        self._skip = skip_lines
        self._delim = delimiter
        self._rows = None
        self._pos = 0

    def _load(self):
        with open(self._path, newline="") as f:
            rows = list(csv.reader(f, delimiter=self._delim))
        self._rows = [self._parse(r) for r in rows[self._skip:] if r]

    @staticmethod
    def _parse(row):
        out = []
        for v in row:
            try:
                out.append(float(v))
            except ValueError:
                out.append(v.strip())
        return out

    def __next__(self):
        if self._rows is None:
            self._load()
        if self._pos >= len(self._rows):
            raise StopIteration
        r = self._rows[self._pos]
        self._pos += 1
        return r

    def reset(self):
        if self._rows is None:
            self._load()
        self._pos = 0


class CSVSequenceRecordReader(RecordReader):
    """One CSV file per sequence (DataVec ``CSVSequenceRecordReader``); the
    reader is given a list of file paths and yields [T, cols] sequences."""

    def __init__(self, paths: Sequence[str], skip_lines: int = 0,
                 delimiter: str = ","):
        self._paths = list(paths)
        self._skip = skip_lines
        self._delim = delimiter
        self._pos = 0

    def __next__(self):
        if self._pos >= len(self._paths):
            raise StopIteration
        path = self._paths[self._pos]
        self._pos += 1
        with open(path, newline="") as f:
            rows = list(csv.reader(f, delimiter=self._delim))
        return [CSVRecordReader._parse(r) for r in rows[self._skip:] if r]

    def reset(self):
        self._pos = 0


# ------------------------------------------------------------------ iterators
class RecordReaderDataSetIterator(DataSetIterator):
    """Reference ``RecordReaderDataSetIterator.java:52``: batches records,
    splits features vs label column.

    - classification: ``label_index`` column holds the class id →
      one-hot [b, num_classes]
    - regression: ``regression=True``; label columns
      [label_index, label_index_to] stay float
    - no labels: ``label_index=None`` → features only
    """

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: Optional[int] = None,
                 num_classes: Optional[int] = None,
                 regression: bool = False,
                 label_index_to: Optional[int] = None):
        self._reader = reader
        self._batch = int(batch_size)
        self._label_index = label_index
        self._num_classes = num_classes
        self._regression = regression
        self._label_index_to = (label_index if label_index_to is None
                                else label_index_to)
        self._it = None

    def __iter__(self):
        self.reset()
        return self

    def reset(self):
        self._reader.reset()
        self._it = iter(self._reader)

    def batch(self):
        return self._batch

    def _split(self, rec):
        if self._label_index is None:
            return [float(v) for v in rec], None
        lo, hi = self._label_index, self._label_index_to
        label = rec[lo:hi + 1]
        feats = list(rec[:lo]) + list(rec[hi + 1:])
        return [float(v) for v in feats], [float(v) for v in label]

    def __next__(self) -> DataSet:
        if self._it is None:
            self.reset()
        feats, labels = [], []
        for _ in range(self._batch):
            try:
                rec = next(self._it)
            except StopIteration:
                break
            f, l = self._split(rec)
            feats.append(f)
            if l is not None:
                labels.append(l)
        if not feats:
            raise StopIteration
        f = np.asarray(feats, np.float32)
        if not labels:
            return DataSet(f, None)
        if self._regression:
            return DataSet(f, np.asarray(labels, np.float32))
        if self._num_classes is None:
            # per-batch inference of the width would give inconsistent label
            # shapes across batches (reference makes numPossibleLabels
            # mandatory for classification for the same reason)
            raise ValueError("num_classes is required for classification "
                             "(label_index set, regression=False)")
        idx = np.asarray(labels, np.int64)[:, 0]
        return DataSet(f, np.eye(self._num_classes, dtype=np.float32)[idx])


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Reference ``SequenceRecordReaderDataSetIterator``: batches sequence
    records into [b, T, f] with per-step labels; unequal lengths are padded and
    masked (reference ``AlignmentMode.ALIGN_END`` ≈ our left-aligned padding +
    mask semantics)."""

    def __init__(self, reader: RecordReader, batch_size: int,
                 num_classes: Optional[int], label_index: int,
                 regression: bool = False):
        self._reader = reader
        self._batch = int(batch_size)
        self._num_classes = num_classes
        self._label_index = label_index
        self._regression = regression
        self._it = None

    def __iter__(self):
        self.reset()
        return self

    def reset(self):
        self._reader.reset()
        self._it = iter(self._reader)

    def batch(self):
        return self._batch

    def __next__(self) -> DataSet:
        if self._it is None:
            self.reset()
        seqs = []
        for _ in range(self._batch):
            try:
                seqs.append(next(self._it))
            except StopIteration:
                break
        if not seqs:
            raise StopIteration
        li = self._label_index
        T = max(len(s) for s in seqs)
        f_dim = len(seqs[0][0]) - 1
        b = len(seqs)
        feats = np.zeros((b, T, f_dim), np.float32)
        mask = np.zeros((b, T), np.float32)
        if self._regression:
            labels = np.zeros((b, T, 1), np.float32)
        else:
            n = self._num_classes
            labels = np.zeros((b, T, n), np.float32)
        for i, seq in enumerate(seqs):
            for t, rec in enumerate(seq):
                lab = rec[li]
                row = list(rec[:li]) + list(rec[li + 1:])
                feats[i, t] = row
                mask[i, t] = 1.0
                if self._regression:
                    labels[i, t, 0] = float(lab)
                else:
                    labels[i, t, int(lab)] = 1.0
        return DataSet(feats, labels, features_mask=mask, labels_mask=mask)
