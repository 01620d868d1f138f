"""The pattern-masked sparse product in plain PyTorch, in float64.

    out[i, o] = (A @ B)[i, pat[i, o]]     (0 where pat[i, o] is -1)

on padded-ELL slabs: A's values ``Ad`` and columns ``Ac`` (n, w_a), B's
``Bd`` and ``Bc`` (nb, w_b), the pattern's columns ``pat`` (n, w_out).  A
slot whose value is 0 adds nothing, whatever its column names (a padding
slot's column may lie past the other operand's end).

Written from the definition alone, not from the program's loop over A's
slots: a block of A's rows is laid out dense over the B rows it reads, B's
rows dense over the block's pattern columns, and the block's rows of A B
are one dense product, read at the pattern.  Imports torch only.
"""

from __future__ import annotations

import torch

__all__ = ["masked_product"]


def masked_product(Ad, Ac, Bd, Bc, pat, block=32) -> torch.Tensor:
    """The float64 values of ``A @ B`` at the pattern's slots, ``block``
    rows of A at a time."""
    Ad, Bd = Ad.double(), Bd.double()
    Ac, Bc, pat = Ac.long(), Bc.long(), pat.long()
    nb = Bd.shape[0]
    out = torch.zeros(pat.shape, dtype=torch.float64, device=Ad.device)
    for r0 in range(0, pat.shape[0], block):
        a_d, a_c = Ad[r0:r0 + block], Ac[r0:r0 + block]
        p = pat[r0:r0 + block]
        a_ok = (a_d != 0) & (a_c >= 0) & (a_c < nb)
        b_rows = torch.unique(a_c[a_ok])
        cols = torch.unique(p[p >= 0])
        if b_rows.numel() == 0 or cols.numel() == 0:
            continue
        # the block of A, dense over the B rows it reads
        r = torch.arange(a_d.shape[0], device=Ad.device)[:, None] \
            .expand_as(a_d)
        a_dense = torch.zeros((a_d.shape[0], b_rows.numel()),
                              dtype=torch.float64, device=Ad.device)
        a_dense.index_put_((r[a_ok], torch.searchsorted(b_rows, a_c[a_ok])),
                           a_d[a_ok], accumulate=True)
        # those rows of B, dense over the block's pattern columns
        b_d, b_c = Bd[b_rows], Bc[b_rows]
        at = torch.searchsorted(cols, b_c).clamp(max=cols.numel() - 1)
        b_ok = (b_d != 0) & (cols[at] == b_c)
        k = torch.arange(b_rows.numel(), device=Ad.device)[:, None] \
            .expand_as(b_d)
        b_dense = torch.zeros((b_rows.numel(), cols.numel()),
                              dtype=torch.float64, device=Ad.device)
        b_dense.index_put_((k[b_ok], at[b_ok]), b_d[b_ok], accumulate=True)
        c = a_dense @ b_dense
        slot = torch.searchsorted(cols, p.clamp(min=0)) \
            .clamp(max=cols.numel() - 1)
        out[r0:r0 + block] = torch.where(p >= 0, c.gather(1, slot), 0.0)
    return out
