"""Alignments and column-wise profile tensors.

Array-native equivalent of the reference's ProfileSequence
(/root/reference/common/profile.h:12-76, common/profile.cpp:44-90): a
column-wise nucleotide frequency profile of an alignment, N_RNA+1 floats per
column (A,C,G,U plus the GAP fraction), with IUPAC ambiguity codes contributing
fractional counts.  Here the profile is a dense ``(L, 5)`` float32 array —
the natural operand for matmul-driven expected-substitution scores
(P_x @ S @ P_y^T as a batched matmul).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .alphabet import IUPAC_WEIGHT, N_RNA, RNA_GAP, encode, erase_gap


@dataclass
class Alignment:
    """A multiple alignment: equal-length gapped sequence rows."""

    rows: list[str]
    names: list[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        lengths = {len(r) for r in self.rows}
        if len(lengths) > 1:
            raise ValueError("wrong alignment: rows differ in length")

    @property
    def n_rows(self) -> int:
        return len(self.rows)

    @property
    def length(self) -> int:
        return len(self.rows[0]) if self.rows else 0

    def ungapped_rows(self) -> list[str]:
        return [erase_gap(r) for r in self.rows]


def profile_from_alignment(aln: Alignment | list[str]) -> np.ndarray:
    """Column profile of an alignment: ``(L, N_RNA+1)`` float32 counts.

    Column i holds the summed fractional base counts over rows (A,C,G,U) and
    the gap count in slot RNA_GAP; total per column equals n_rows
    (ProfileSequence::add_sequence, common/profile.cpp:55-74).
    """
    rows = aln.rows if isinstance(aln, Alignment) else aln
    length = len(rows[0])
    prof = np.zeros((length, N_RNA + 1), dtype=np.float32)
    for row in rows:
        codes = encode(row)
        gap_mask = codes == RNA_GAP
        prof[:, :N_RNA] += IUPAC_WEIGHT[codes]
        prof[gap_mask, RNA_GAP] += 1.0
    return prof


def index_map(row: str) -> np.ndarray:
    """Map alignment columns to ungapped positions; -1 at gap columns.

    Equivalent of Profiler::make_idxmap
    (/root/reference/stem_kernel_lite/data.cpp:86-95) and make_index_map
    (/root/reference/common/bpmatrix.cpp:292-304).
    """
    codes = encode(row)
    non_gap = codes != RNA_GAP
    idx = np.cumsum(non_gap) - 1
    return np.where(non_gap, idx, -1).astype(np.int32)
