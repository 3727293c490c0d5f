"""K3's launch arithmetic on the host (`kernels.wire_bytes.nnz_grid`).

The kernel runs only on the card; how the wrapper splits a (K, N) cohort
over blocks is plain arithmetic, held here: every row gets blocks that
cover each of its positions exactly once with none empty, a zeroed output
is asked for exactly when a row splits over more than one block, and the
card gets about one wave of blocks when the rows alone are too few.
"""
import pytest

from repro_torch.kernels import wire_bytes as wb

H100_SMS = 132


@pytest.mark.parametrize("k", [1, 2, 132, 1000, 65535])
@pytest.mark.parametrize("n", [1, 3, 4097, 20490, 300001, 2 ** 31 - 1])
def test_nnz_grid_covers_every_row_once(k, n):
    grid = wb.nnz_grid(k, n, H100_SMS)
    assert grid.blocks_per_row >= 1 and grid.chunk >= 1
    # Block b of a row takes [b * chunk, min(n, (b + 1) * chunk)): none
    # empty, together exactly [0, n); grid.y is the row, one per row.
    assert (grid.blocks_per_row - 1) * grid.chunk < n
    assert grid.blocks_per_row * grid.chunk >= n
    assert grid.zeroed == (grid.blocks_per_row > 1)
    assert grid.blocks_per_row * k <= 2 ** 31 - 1
    if grid.zeroed:
        assert grid.chunk % 4 == 0 and grid.chunk >= wb.MIN_CHUNK
    if k >= wb.BLOCKS_PER_SM * H100_SMS:
        assert grid == wb.NnzGrid(1, n, False)


@pytest.mark.parametrize("k", [1, 2, 132])
def test_nnz_grid_fills_the_card_with_few_rows(k):
    """A few long rows split into about one wave of blocks, as far as
    blocks of MIN_CHUNK positions go; short rows stay whole."""
    n = 300001
    grid = wb.nnz_grid(k, n, H100_SMS)
    wave = wb.BLOCKS_PER_SM * H100_SMS
    assert grid.zeroed
    assert k * grid.blocks_per_row <= wave + 2 * k
    assert grid.blocks_per_row >= min(-(-wave // k), n // wb.MIN_CHUNK)
    assert not wb.nnz_grid(k, wb.MIN_CHUNK, H100_SMS).zeroed


def test_nnz_grid_counts_positions_exactly_once_in_a_small_case():
    """Walk the blocks of a small split row and count each position."""
    grid = wb.nnz_grid(1, 5000, 1)
    assert grid.zeroed
    seen = [0] * 5000
    for b in range(grid.blocks_per_row):
        for p in range(b * grid.chunk, min(5000, (b + 1) * grid.chunk)):
            seen[p] += 1
    assert seen == [1] * 5000
