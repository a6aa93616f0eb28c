"""The mask kernel's launch plan (``lass_torch.ops.masking.mask_plan``), on
the CPU: the multiply-shift divisor that splits a row into (n, t), and the
blocks that cover every (row, bin) of a call exactly once with 4 bins a
thread, at the layouts the card tests hold the kernel to. The kernel
itself is held against its plain version in test_torch_kernels_cuda.py.
"""
import numpy as np
import pytest

from lass_torch.ops.masking import BINS, THREADS, mask_plan

# (N, T, F): serving, the variants, F in {1, 5, 257, 512}, T = 1, more
# than 65535 rows at a narrow F
LAYOUTS = [(16, 1001, 512), (16, 1001, 256), (2, 7, 1), (2, 7, 5),
           (3, 37, 257), (4, 101, 512), (5, 1, 512), (1, 70000, 4)]


def _split(plan, t, rows):
    """(n, t) of each row as the kernel's fast path computes them."""
    r = np.asarray(rows, dtype=np.uint64)
    if plan.t_mul == 0:
        return r, np.zeros_like(r)
    q = ((r * np.uint64(plan.t_mul)) >> np.uint64(32)) >> np.uint64(
        plan.t_shift)
    return q, r - q * np.uint64(t)


@pytest.mark.parametrize("t", [1, 2, 3, 5, 7, 256, 257, 1001, 1024, 4001,
                               65535, 65537, 70000, 1 << 20, (1 << 30) + 1,
                               (1 << 31) - 1])
def test_divisor_splits_rows_exactly(t):
    plan = mask_plan(1, t, 4)
    assert plan.fast_rows == 1 << 31
    assert 0 <= plan.t_mul < 1 << 32 and 0 <= plan.t_shift < 32
    rng = np.random.RandomState(t % 1000)
    rows = np.concatenate([
        np.arange(0, 3 * t + 3, max(1, t // 7), dtype=np.uint64),
        np.array([t - 1, t, t + 1, (1 << 31) - 1, (1 << 31) - 2,
                  ((1 << 31) - 1) // t * t, ((1 << 31) - 1) // t * t - 1],
                 dtype=np.uint64),
        rng.randint(0, 1 << 31, size=4096).astype(np.uint64)])
    rows = rows[rows < (1 << 31)]
    q, _ = _split(plan, t, rows)
    np.testing.assert_array_equal(q, rows // np.uint64(t))


def test_rows_past_the_fast_split_divide():
    """A T of 2^31 or more leaves every row to the 64-bit division."""
    assert mask_plan(1, 1 << 31, 1).fast_rows == 0


@pytest.mark.parametrize("n,t,f", LAYOUTS)
def test_plan_covers_every_bin_once(n, t, f):
    plan = mask_plan(n, t, f)
    rows, groups = n * t, -(-f // BINS)
    assert plan.block_x * plan.block_y <= THREADS
    # a whole number of rows a block: threads along a row cover a row's
    # groups (a loop when the row is wider than a block)
    assert plan.block_x == min(groups, THREADS)
    assert plan.block_y == THREADS // plan.block_x
    # every thread takes BINS consecutive bins: no layout runs one bin a
    # thread
    seen = np.zeros((rows, groups * BINS), dtype=np.int32)
    step = plan.blocks * plan.block_y
    first = (np.arange(plan.blocks)[:, None] * plan.block_y
             + np.arange(plan.block_y)[None, :]).ravel()
    for start in range(0, rows, step):
        r = first + start
        r = r[r < rows]
        for g0 in range(0, groups, plan.block_x):
            g = np.arange(g0, min(g0 + plan.block_x, groups))
            cols = (g[:, None] * BINS + np.arange(BINS)[None, :]).ravel()
            seen[np.ix_(r, cols)] += 1
    assert (seen[:, :f] == 1).all()
    n_of, t_of = _split(plan, t, np.arange(rows))
    np.testing.assert_array_equal(n_of * np.uint64(t) + t_of,
                                  np.arange(rows, dtype=np.uint64))
    assert (t_of < t).all()


def test_plan_at_the_serving_and_variant_shapes():
    """Serving (16, 1001, 512): 128 threads a row, 2 rows a block;
    variants (16, 1001, 256): 64 threads a row, 4 rows a block."""
    serving, variants = mask_plan(16, 1001, 512), mask_plan(16, 1001, 256)
    assert (serving.block_x, serving.block_y, serving.blocks) == (128, 2,
                                                                   8008)
    assert (variants.block_x, variants.block_y, variants.blocks) == (
        64, 4, 4004)
    wide = mask_plan(1, 3, 4096)
    assert (wide.block_x, wide.block_y, wide.blocks) == (256, 1, 3)
