"""Matrix file I/O: binary-triplet format, text↔binary, partitioning order.

Native re-implementation of the reference's matrix-from-file path
(reference: ReadBinary_fread_HypreParCSR src/Misc.cpp:800-915,
src/DMEM_BuildMatrix.cpp:1050-1570, TextToBin src/TextToBin.cpp).

Format (exactly the reference's): packed records of
    (int32 row, int32 col, float64 val)        — 16 bytes, 1-based indices
with the FIRST record's `row` field holding the matrix dimension n.
Options match the reference: symmetrization (mirror each off-diagonal) and
disconnected-row removal.

The reference repartitions file matrices with METIS k-way then reorders
(src/DMEM_BuildMatrix.cpp:1050-1152). The native analog for row-block device
partitions is a bandwidth-minimizing reordering (reverse Cuthill-McKee):
contiguous row blocks of the reordered matrix are exactly the low-cut
partitions METIS would hand back for banded systems.
"""

from __future__ import annotations

import numpy as np

from amg_jax.sparse.csr import CSRMatrix

TRIPLET_DTYPE = np.dtype(
    [("i", "<i4"), ("j", "<i4"), ("val", "<f8")], align=False
)


def write_binary_triplets(path: str, A: CSRMatrix) -> None:
    """Dump a CSR matrix in the reference's binary-triplet format."""
    coo = A.to_scipy().tocoo()
    out = np.empty(coo.nnz + 1, dtype=TRIPLET_DTYPE)
    out[0] = (A.n_rows, A.n_rows, 0.0)
    out["i"][1:] = coo.row + 1
    out["j"][1:] = coo.col + 1
    out["val"][1:] = coo.data
    out.tofile(path)


def read_binary_triplets(
    path: str,
    symmetrize: bool = False,
    remove_disconnected: bool = False,
) -> CSRMatrix:
    raw = np.fromfile(path, dtype=TRIPLET_DTYPE)
    if raw.size == 0:
        raise ValueError(f"empty matrix file {path}")
    n = int(raw["i"][0])
    rows = raw["i"][1:].astype(np.int64) - 1
    cols = raw["j"][1:].astype(np.int64) - 1
    vals = raw["val"][1:].copy()
    if symmetrize:
        off = rows != cols
        rows, cols, vals = (
            np.concatenate([rows, cols[off]]),
            np.concatenate([cols, rows[off]]),
            np.concatenate([vals, vals[off]]),
        )
    import scipy.sparse as sp

    m = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    if remove_disconnected:
        # rows whose only entry is the diagonal (or that are empty) are
        # decoupled points — drop them, matching the reference's
        # remove_disconnected_points_flag
        offdiag = m - sp.diags(m.diagonal())
        offdiag.eliminate_zeros()
        deg = np.asarray((offdiag != 0).sum(axis=1)).reshape(-1)
        keep = deg > 0
        m = m[keep][:, keep].tocsr()
    return CSRMatrix.from_scipy(m)


def text_to_bin(text_path: str, bin_path: str | None = None) -> str:
    """ASCII 'row col val' lines → binary triplets (reference TextToBin).
    The first line must already be the header record (n n 0)."""
    data = np.loadtxt(text_path, ndmin=2)
    out = np.empty(data.shape[0], dtype=TRIPLET_DTYPE)
    out["i"] = data[:, 0].astype(np.int32)
    out["j"] = data[:, 1].astype(np.int32)
    out["val"] = data[:, 2]
    if bin_path is None:
        bin_path = text_path + ".bin"
    out.tofile(bin_path)
    return bin_path


def bin_to_text(bin_path: str, text_path: str) -> None:
    raw = np.fromfile(bin_path, dtype=TRIPLET_DTYPE)
    with open(text_path, "w") as f:
        for rec in raw:
            f.write(f"{int(rec['i'])} {int(rec['j'])} {rec['val']:.16e}\n")


def rcm_reorder(A: CSRMatrix):
    """Bandwidth-minimizing permutation (native METIS-partition analog for
    contiguous row-block device layouts). Returns (A_perm, perm)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    m = A.to_scipy()
    perm = reverse_cuthill_mckee(m, symmetric_mode=True)
    mp = m[perm][:, perm].tocsr()
    return CSRMatrix.from_scipy(mp), np.asarray(perm)


def problem_from_file(
    path: str,
    symmetrize: bool = False,
    remove_disconnected: bool = False,
    reorder: bool = False,
):
    from amg_jax.problems.laplacian import Problem

    A = read_binary_triplets(path, symmetrize, remove_disconnected)
    if reorder:
        A, _ = rcm_reorder(A)
    return Problem(name="file", A=A, stencil=None, grid_shape=None)
