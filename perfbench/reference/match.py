"""Plain gallery match: cosine scores of unit queries against the
gallery's rows, each row L2-normalised in f32, in blocks of rows."""

from __future__ import annotations

import torch

from perfbench.reference.precision import Precision


def normalize_rows(rows: torch.Tensor) -> torch.Tensor:
    rows = rows.float()
    return rows / torch.clamp(torch.linalg.vector_norm(rows, dim=1, keepdim=True), min=1e-12)


class Gallery:
    """The enrolled rows (f32, normalised) for scoring queries."""

    def __init__(self, blocks):
        """``blocks``: (start, raw rows) in order, as ``weights.gallery_rows``
        yields them."""
        self.rows = torch.cat([normalize_rows(r) for _, r in blocks])

    def scores_of(self, queries: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """f32 cosine of each query with its own row: [Q], [Q] -> [Q]."""
        return (self.rows[rows.long()] * queries.float()).sum(-1)

    def best(self, p: Precision, queries: torch.Tensor, block: int = 1 << 18
             ) -> tuple[torch.Tensor, torch.Tensor]:
        """(best score [Q], its row [Q], ties to the lower row) over every
        row, in blocks of ``block`` rows."""
        q = p.q(queries)
        best_v = torch.full((len(q),), -float("inf"), device=q.device)
        best_i = torch.zeros(len(q), dtype=torch.long, device=q.device)
        for start in range(0, len(self.rows), block):
            s = q @ p.q(self.rows[start:start + block]).T
            v, i = s.max(dim=1)
            better = v > best_v
            best_v = torch.where(better, v, best_v)
            best_i = torch.where(better, i + start, best_i)
        return best_v, best_i
