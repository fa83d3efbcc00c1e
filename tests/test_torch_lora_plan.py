"""The launch plan of the port's ``lora_matmul`` (B3) that lives in Python:
which body a shape takes, the split-K body's K chunks, and the size of the
work buffer either body is handed. Pure arithmetic, so it runs on the CPU;
the kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import pytest

pytest.importorskip("torch")

from repro_torch.kernels.lora_matmul import (MAX_RANK,  # noqa: E402
                                             SKINNY_ROWS, _split_plan,
                                             _work_floats)

H100_SMS = 132

# (M, K, N, r): the prefill layer of paper-llama3.2-3b (M = 8 × 512) and
# the tiled body's edges; the decode layer (M = 8) and split-K edges
TILED = [(4096, 3072, 3072, 4), (4096, 3072, 1024, 4), (17, 3072, 3072, 4),
         (4095, 3072, 1024, 4), (1000, 777, 333, 16), (300, 5, 130, 4),
         (256, 3076, 512, 4), (4096, 3072, 3072, 0), (4096, 3072, 3072, 1),
         (4096, 3072, 1024, 3), (4096, 3072, 3072, 64)]
SPLIT = [(8, 3072, 3072, 4), (8, 3072, 1024, 4), (7, 777, 333, 1),
         (7, 777, 333, 16), (16, 100, 50, 64), (1, 8, 8, 1), (8, 3072, 3072, 0)]


@pytest.mark.parametrize("case", TILED, ids=str)
def test_tiled_body_gets_x_at_a_work(case):
    """M > 16 takes the tiled body (splits 0): its prepass writes x@a, M·r
    floats, and at r = 0 there is no prepass and no buffer."""
    m, k, n, r = case
    assert m > SKINNY_ROWS and r <= MAX_RANK
    assert _work_floats(m, n, r, 0) == m * r
    assert (_work_floats(m, n, r, 0) == 0) == (r == 0)


@pytest.mark.parametrize("case", SPLIT, ids=str)
def test_split_plan_meets_the_c_entry_checks(case):
    """The split-K plan passes lora_matmul_launch's checks (kc a multiple of
    8, splits·kc ≥ K, no empty chunk) and its work buffer holds every
    chunk's partial product and partial x@a."""
    m, k, n, r = case
    assert m <= SKINNY_ROWS
    splits, kc = _split_plan(n, k, H100_SMS)
    assert splits > 0 and kc > 0 and kc % 8 == 0
    assert splits * kc >= k and (splits - 1) * kc < k
    assert _work_floats(m, n, r, splits) == splits * m * (n + r)
