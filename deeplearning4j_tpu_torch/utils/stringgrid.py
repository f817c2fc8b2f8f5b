"""StringGrid — a grid of strings with filter/dedup/sort operations
(util/StringGrid.java, 748 LoC: fromFile/fromInput, getColumn,
filterRowsByColumn, removeRowsWithEmptyColumn, sortColumnsByWordLikelihood,
split/merge). The useful surface, list-of-lists backed. Port of
``deeplearning4j_tpu/utils/stringgrid.py``."""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence


class StringGrid:
    def __init__(self, sep: str, rows: Optional[Iterable[Sequence[str]]] = None):
        self.sep = sep
        self._rows: List[List[str]] = [list(r) for r in (rows or [])]
        if self._rows:
            width = len(self._rows[0])
            for r in self._rows:
                if len(r) != width:
                    raise ValueError("ragged rows")

    # -- construction ---------------------------------------------------
    @staticmethod
    def from_file(path: str, sep: str = ",") -> "StringGrid":
        with open(path) as f:
            return StringGrid.from_input(f.read().splitlines(), sep)

    @staticmethod
    def from_input(lines: Iterable[str], sep: str = ",") -> "StringGrid":
        rows = [line.split(sep) for line in lines if line.strip()]
        return StringGrid(sep, rows)

    # -- accessors ------------------------------------------------------
    def num_rows(self) -> int:
        return len(self._rows)

    def num_columns(self) -> int:
        return len(self._rows[0]) if self._rows else 0

    def get_row(self, i: int) -> List[str]:
        return list(self._rows[i])

    def get_column(self, j: int) -> List[str]:
        return [r[j] for r in self._rows]

    def rows(self) -> List[List[str]]:
        return [list(r) for r in self._rows]

    # -- transforms (all return new grids; the reference mutates) -------
    def filter_rows_by_column(self, j: int,
                              keep: Callable[[str], bool]) -> "StringGrid":
        return StringGrid(self.sep, [r for r in self._rows if keep(r[j])])

    def filter_by_value(self, j: int, value: str) -> "StringGrid":
        return self.filter_rows_by_column(j, lambda v: v == value)

    def remove_rows_with_empty_column(self, j: int) -> "StringGrid":
        return self.filter_rows_by_column(j, lambda v: v.strip() != "")

    def dedupe_rows(self) -> "StringGrid":
        seen = set()
        out = []
        for r in self._rows:
            key = tuple(r)
            if key not in seen:
                seen.add(key)
                out.append(r)
        return StringGrid(self.sep, out)

    def sort_by_column(self, j: int, reverse: bool = False) -> "StringGrid":
        return StringGrid(self.sep,
                          sorted(self._rows, key=lambda r: r[j],
                                 reverse=reverse))

    def select_columns(self, cols: Sequence[int]) -> "StringGrid":
        return StringGrid(self.sep, [[r[j] for j in cols]
                                     for r in self._rows])

    def append_column(self, values: Sequence[str]) -> "StringGrid":
        if len(values) != len(self._rows):
            raise ValueError("column length mismatch")
        return StringGrid(self.sep, [r + [v] for r, v in
                                     zip(self._rows, values)])

    # -- output ---------------------------------------------------------
    def to_lines(self) -> List[str]:
        return [self.sep.join(r) for r in self._rows]

    def write_file(self, path: str) -> None:
        with open(path, "w") as f:
            f.write("\n".join(self.to_lines()) + "\n")

    def __eq__(self, other):
        return (isinstance(other, StringGrid)
                and self._rows == other._rows)

    def __repr__(self):
        return f"StringGrid({self.num_rows()}x{self.num_columns()})"
