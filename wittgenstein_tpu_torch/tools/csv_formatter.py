"""Column-ordered CSV emitter for scenario results.

Reference semantics: tools/CSVFormatter.java — fixed field order given at
construction, rows appended as dicts, missing values empty."""

from __future__ import annotations

import io
from typing import Dict, List


class CSVFormatter:
    def __init__(self, name: str, fields: List[str]):
        self.name = name
        self.fields = list(fields)
        self.rows: List[Dict] = []

    def add(self, row: Dict) -> None:
        self.rows.append(dict(row))

    def to_string(self) -> str:
        out = io.StringIO()
        out.write(f"{self.name}\n")
        out.write(",".join(self.fields) + "\n")
        for row in self.rows:
            out.write(
                ",".join(
                    "" if row.get(f) is None else str(row.get(f)) for f in self.fields
                )
                + "\n"
            )
        return out.getvalue()

    def save(self, dest: str) -> None:
        with open(dest, "w") as f:
            f.write(self.to_string())

    def __str__(self) -> str:
        return self.to_string()
