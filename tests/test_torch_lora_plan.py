"""The launch plan of the port's ``lora_matmul`` (B3) that lives in Python:
which body a shape takes, the split-K body's K chunks and column-block
width, and the size of the work buffer either body is handed. Pure
arithmetic, so it runs on the CPU; the kernel itself runs only on the card
(tests/test_torch_cuda.py).
"""

import pytest

pytest.importorskip("torch")

from repro_torch.kernels.lora_matmul import (MAX_RANK,  # noqa: E402
                                             MAX_SPLITS, SKINNY_ROWS,
                                             _split_plan, _work_floats)

H100_SMS = 132

# (M, K, N, r): the prefill layer of paper-llama3.2-3b (M = 8 × 512) and
# the tiled body's edges; paper-gpt2's prefill layer (K = N = 768, the MLP's
# 768 × 3072 and 3072 × 768 with include_mlp) and both models at the serve
# launcher's default prompt (M = 2 × 32); the decode layers (M = 8) of both
# models and split-K edges
TILED = [(4096, 3072, 3072, 4), (4096, 3072, 1024, 4), (17, 3072, 3072, 4),
         (4095, 3072, 1024, 4), (1000, 777, 333, 16), (300, 5, 130, 4),
         (256, 3076, 512, 4), (4096, 3072, 3072, 0), (4096, 3072, 3072, 1),
         (4096, 3072, 1024, 3), (4096, 3072, 3072, 64),
         (4096, 768, 768, 4), (4096, 768, 3072, 4), (4096, 3072, 768, 4),
         (64, 768, 768, 4), (64, 3072, 3072, 4), (64, 3072, 1024, 4)]
SPLIT = [(8, 3072, 3072, 4), (8, 3072, 1024, 4), (7, 777, 333, 1),
         (7, 777, 333, 16), (16, 100, 50, 64), (1, 8, 8, 1), (8, 3072, 3072, 0),
         (8, 768, 768, 4), (8, 768, 3072, 4), (8, 3072, 768, 4)]


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
    """The split-K plan passes lora_matmul_launch's checks: one cluster of
    at most 8 K chunks (splits·kc ≥ K, no empty chunk), a column-block
    width of 32, 64 or 128, and no work buffer (the chunks fold through
    distributed shared memory)."""
    m, k, n, r = case
    assert m <= SKINNY_ROWS
    splits, kc, bn = _split_plan(n, k, H100_SMS)
    assert 1 <= splits <= MAX_SPLITS and kc > 0
    assert splits * kc >= k and (splits - 1) * kc < k
    assert bn in (32, 64, 128)
    assert _work_floats(m, n, r, splits) == 0


@pytest.mark.parametrize("n,k,plan", [
    (3072, 3072, (4, 768, 128)), (1024, 3072, (8, 384, 128)),
    (333, 777, (8, 98, 64)), (200, 9000, (8, 1125, 32)),
    (8192, 3072, (2, 1536, 128)), (1024, 100, (1, 100, 32)),
    (768, 768, (8, 96, 128)), (3072, 768, (4, 192, 128)),
    (768, 3072, (8, 384, 128))],
    ids=["q_o_proj", "k_v_proj", "odd", "narrow", "wide", "short",
         "gpt2_qkvo_proj", "gpt2_up_proj", "gpt2_down_proj"])
def test_split_plan_fills_half_the_card(n, k, plan):
    """The fewest K chunks (a power of two, at most 8 and one per 64 rows)
    whose grid of 128-column blocks covers half of the 132 SMs, then
    narrower column blocks while the grid at half the width stays within
    half of them: at paper-llama3.2-3b's decode projections (K = 3072)
    4 × 24 blocks at N = 3072 and 8 × 8 at N = 1024; at paper-gpt2's
    (K = N = 768) 8 chunks of 96 rows × 6 column blocks."""
    splits, kc, bn = got = _split_plan(n, k, H100_SMS)
    assert got == plan
    half, most = H100_SMS // 2, max(1, min(MAX_SPLITS, k // 64))
    nb = -(-n // 128)
    assert nb * splits >= half or splits * 2 > most
    assert splits == 1 or nb * (splits // 2) < half
    assert bn == 32 or -(-n // (bn // 2)) * splits > half


@pytest.mark.parametrize("k", [1, 63, 64, 65, 300, 511, 512, 513, 777, 3072,
                               100_000])
def test_split_plan_chunks_hold_at_least_64_rows(k):
    splits, kc, _ = _split_plan(64, k, H100_SMS)
    assert splits & (splits - 1) == 0 and splits <= max(1, k // 64)
    assert kc >= min(k, 64) and (splits - 1) * kc < k <= splits * kc


def test_split_plan_is_cached():
    _split_plan.cache_clear()
    _split_plan(1024, 3072, H100_SMS)
    _split_plan(1024, 3072, H100_SMS)
    assert _split_plan.cache_info().hits == 1
