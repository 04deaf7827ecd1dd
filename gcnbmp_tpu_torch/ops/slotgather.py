"""Slot-table gather with a gather-only backward (port of
gcnbmp_tpu/ops/slotgather.py).

``flat[slots] * amask[..., None]`` autodiffs to a scatter-add over the
table's rows (``index_add_``, whose CUDA form sums with atomics in no fixed
order).  The packed layout makes the transpose a gather instead: each
molecule occupies a contiguous run of flat slots and each real slot
belongs to exactly one masked-in table entry, so

    grad_flat[p] = grad_table[row(m), p - start(m)] * amask[row(m), p - start(m)]

for m = ids[p], with start(m) = slots[row(m), 0].  Both directions are
gathers and elementwise masking, so a train step repeats bit for bit.
The backward scales by the mask value, which keeps it exact for
fractional masks.  Correct for every table built by
``models.packed._device_slot_table`` (the two invariants above).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable


class _GatherSlotTable(torch.autograd.Function):

    @staticmethod
    def forward(ctx, flat, slots, amask, ids, mol_row):
        r, n_max = slots.shape
        ctx.save_for_backward(slots, amask, ids, mol_row)
        ctx.n = flat.shape[0]
        atoms = flat[slots.reshape(-1).long()].reshape(r, n_max, -1)
        return atoms * amask[..., None]

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        slots, amask, ids, mol_row = ctx.saved_tensors
        slots, ids, mol_row = slots.long(), ids.long(), mol_row.long()
        r_rows, n_max = slots.shape
        pos = torch.arange(ctx.n, device=g.device)
        m = ids.clamp(0, mol_row.shape[0] - 1)
        row = mol_row[m]                                  # table row or -1
        row_c = row.clamp(0, r_rows - 1)
        off = pos - slots[:, 0][row_c]
        ok = (row >= 0) & (off >= 0) & (off < n_max)
        idx = (row_c * n_max + off.clamp(0, n_max - 1)).clamp(
            0, r_rows * n_max - 1)
        aval = amask.reshape(-1)[idx]
        gathered = g.reshape(r_rows * n_max, -1)[idx] * aval[:, None]
        grad_flat = torch.where(ok[:, None], gathered,
                                torch.zeros_like(gathered))
        return grad_flat, None, None, None, None


def gather_slot_table(flat: torch.Tensor, slots: torch.Tensor,
                      amask: torch.Tensor, ids: torch.Tensor,
                      mol_row: torch.Tensor) -> torch.Tensor:
    """``flat[slots] * amask[..., None]`` with a gather-only backward.

    flat (N, C) node states over the flattened packed layout; slots
    (R, n_max) flat indices (molecule runs, pad entries arbitrary but
    masked out); amask (R, n_max) float; ids (N,) molecule id per flat
    slot (pad slots carry the sentinel id); mol_row (num_mols + 1,)
    molecule id -> table row, or -1 (the sentinel's entry is -1).
    Returns the (R, n_max, C) masked atom table."""
    return _GatherSlotTable.apply(flat, slots, amask, ids, mol_row)


def identity_mol_row(num_mols: int, device=None) -> torch.Tensor:
    """mol_row for a table with one row per molecule in id order (the
    dense Set2Set case): [0, 1, ..., num_mols - 1, -1]."""
    return torch.cat([torch.arange(num_mols, dtype=torch.int64, device=device),
                      torch.full((1,), -1, dtype=torch.int64, device=device)])
