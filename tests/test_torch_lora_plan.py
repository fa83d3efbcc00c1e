"""The launch plan of the port's ``lora_matmul`` (B3) that lives in Python:
which body a shape takes (tensor-core split-K, SIMT split-K, tensor-core
or tiled), the split-K bodies' K chunks and column-block widths, the
tensor-core bodies' shared memory, and the size of the work buffer each
body is handed. Pure arithmetic, so it runs on the CPU; the kernel itself
runs only on the card (tests/test_torch_cuda.py).
"""

import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.build import CSRC  # noqa: E402
from repro_torch.kernels.lora_matmul import (DC_A_BYTES,  # noqa: E402
                                             DC_BN, DC_STAGES, DC_X_BYTES,
                                             MAX_RANK, MAX_SPLITS,
                                             SKINNY_ROWS, SMEM_PER_BLOCK,
                                             TC_STAGES, _adapter_rows,
                                             _body, _dc_smem, _split_plan,
                                             _tc_smem, _tc_split_plan,
                                             _tc_stages, _work_floats)

H100_SMS = 132


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread, as in the other port test files (the suite runs
    several workers on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

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


def _projections(name):
    """(projection, K, N) of one layer's adapted q/k/v/o of a served model;
    of an MLA model its six attention projections and its two expert
    shapes (up/gate, down); of a hybrid model a Mamba2 layer's in_proj and
    out_proj besides the shared block's q/k/v/o; of an xLSTM model an
    mLSTM block's up_proj, q/k/v and down_proj and the sLSTM's w_gates
    (its FFN's up / down at K or N 2730 take the SIMT bodies: see the
    tests of what TMA cannot describe)."""
    c = get_config(name)
    d, hd = c.d_model, c.resolved_head_dim
    if c.family == "ssm":
        di = c.ssm_expand * d
        return [("up_proj", d, 2 * di), ("q", di, di), ("k", di, di),
                ("v", di, di), ("down_proj", di, d), ("w_gates", d, 4 * d)]
    if c.family == "hybrid":
        di = c.ssm_expand * d
        mamba = [("in_proj", d, 2 * di + 2 * c.ssm_state
                  + di // c.ssm_head_dim), ("out_proj", di, d)]
        return mamba + [("q", d, c.num_heads * hd),
                        ("k", d, c.num_kv_heads * hd),
                        ("v", d, c.num_kv_heads * hd),
                        ("o", c.num_heads * hd, d)]
    if c.mla:
        h, kvr = c.num_heads, c.kv_lora_rank
        nope, rope, dv = (c.qk_nope_head_dim, c.qk_rope_head_dim,
                          c.v_head_dim)
        return [("q_down", d, c.q_lora_rank),
                ("q_up", c.q_lora_rank, h * (nope + rope)),
                ("kv_down", d, kvr + rope), ("k_up", kvr, h * nope),
                ("v_up", kvr, h * dv), ("o", h * dv, d),
                ("expert_up", d, c.moe_d_ff), ("expert_down", c.moe_d_ff, d)]
    return [("q", d, c.num_heads * hd), ("k", d, c.num_kv_heads * hd),
            ("v", d, c.num_kv_heads * hd), ("o", c.num_heads * hd, d)]


# every served q/k/v/o (paper-llama3.2-3b, paper-gpt2 and deepseek-v2-236b
# at batch 8 × prompt 512, gemma3-12b at 2 × 2048: M 4096; deepseek's MLA
# and expert projections) at its prefill rows and at the serve launcher's
# default prompt (M 64)
SERVED = [(name, proj, m, k, n)
          for name in ("paper-llama3.2-3b", "paper-gpt2", "gemma3-12b",
                       "deepseek-v2-236b", "zamba2-7b", "xlstm-1.3b")
          for proj, k, n in _projections(name) for m in (4096, 64)]


@pytest.mark.parametrize("case", SERVED, ids=str)
def test_served_bf16_prefill_takes_the_tensor_core_body(case):
    """Every served shape has K and N multiples of 8, so aligned bf16
    operands go to the tensor cores; f32 operands to the tiled body."""
    _, _, m, k, n = case
    assert k % 8 == 0 and n % 8 == 0
    assert _body(m, k, n, True, True) == "tensor-core"
    assert _body(m, k, n, False, True) == "tiled"


@pytest.mark.parametrize("m,k,n,aligned", [
    (1000, 777, 333, True), (100, 776, 332, True), (4096, 3071, 1024, True),
    (4096, 3072, 1020, True), (4096, 3072, 3072, False),
    (17, 3072, 1024, False), (4096, 2048, 2730, True),
    (4096, 2730, 2048, True)], ids=str)
def test_what_tma_cannot_describe_takes_the_tiled_body(m, k, n, aligned):
    """K or N not a multiple of 8 (a row stride that is no multiple of 16
    bytes; xlstm-1.3b's FFN of int(2048·4/3) = 2730), or an x or W off
    16-byte alignment: the SIMT tiled body."""
    assert _body(m, k, n, True, aligned) == "tiled"


@pytest.mark.parametrize("low,aligned,split", [
    (True, True, "tensor-core split-K"), (False, True, "split-K"),
    (True, False, "split-K"), (False, False, "split-K")], ids=str)
@pytest.mark.parametrize("m", [1, 8, 16, 17], ids=str)
def test_decode_rows_take_split_k(m, low, aligned, split):
    """M ≤ 16 takes a split-K body: the tensor-core one for bf16 that TMA
    can describe, the SIMT one for f32 and the rest; M > 16 the
    tensor-core or the tiled body."""
    tma = low and aligned
    want = split if m <= SKINNY_ROWS else (
        "tensor-core" if tma else "tiled")
    assert _body(m, 3072, 3072, low, aligned) == want
    assert _body(m, 777, 333, low, aligned) == (
        "split-K" if m <= SKINNY_ROWS else "tiled")


@pytest.mark.parametrize("r,na", [(0, 0), (1, 8), (4, 8), (8, 8), (9, 16),
                                  (16, 16), (17, 32), (32, 32), (33, 64),
                                  (64, 64)], ids=str)
def test_adapter_rows_pad_the_rank(r, na):
    """The x@a product's N: r rounded up to 8, 16, 32 or 64 (wgmma's
    m64nNk16 takes N in steps of 8; four instantiations)."""
    assert _adapter_rows(r) == na
    assert na >= r and na % 8 == 0 and na <= MAX_RANK


@pytest.mark.parametrize("na", [0, 8, 16, 32, 64], ids=str)
def test_tensor_core_shared_memory_fits_one_block(na):
    """The ring's stages (x 16 KB, W 16 KB, a^T NA × 128 B each), the x@a
    rows and b's panel (16 KB each) and the mbarriers, after 1 KB of
    alignment: within the 232,448 bytes a block may have, with at least 4
    stages in flight."""
    stages = _tc_stages(na)
    assert stages >= 4
    need = stages * (32768 + 128 * na) + 2 * 16384
    assert need < _tc_smem(na) <= SMEM_PER_BLOCK
    assert _tc_smem(na) == 1024 + need + (2 * stages + 2) * 8


def test_tensor_core_plan_matches_the_source():
    """The stage counts and the sizes behind ``_tc_smem`` are the CUDA
    source's (``tc_stages``, ``TC_XA_BYTES``, ``TC_B_HALF``)."""
    src = (CSRC / "lora_matmul.cu").read_text()
    stages = re.search(r"tc_stages\(int na\) \{ return na >= (\d+) \? (\d+)"
                       r" : (\d+); \}", src)
    assert stages is not None
    at, few, many = (int(v) for v in stages.groups())
    assert (many, few) == (TC_STAGES, _tc_stages(64))
    assert _tc_stages(at) == few and _tc_stages(at // 2) == many
    assert "constexpr int TC_XA_BYTES = TC_BM * 128;" in src
    assert "constexpr int TC_B_HALF = kMaxRank * 128;" in src
    assert "constexpr int kMaxRank = %d;" % MAX_RANK in src


@pytest.mark.parametrize("m,k,n,r", [(4096, 3072, 3072, 4),
                                     (4096, 3840, 4096, 1),
                                     (64, 768, 768, 12), (17, 776, 1000, 17),
                                     (4095, 3072, 1024, 64),
                                     (4096, 3072, 1024, 0)], ids=str)
def test_tensor_core_work_holds_a_transposed(m, k, n, r):
    """The tensor-core body's work buffer holds a^T padded to NA rows, NA·K
    bf16 (two a float), whatever M and N; none without an adapter."""
    floats = _work_floats(m, n, r, 0, k)
    assert 2 * floats >= _adapter_rows(r) * k > 2 * (floats - 1)
    assert (floats == 0) == (r == 0)


# every served q/k/v/o at its decode rows (paper-llama3.2-3b, paper-gpt2
# and deepseek-v2-236b at batch 8, gemma3-12b at batch 2) and at the serve
# launcher's batch 2 (deepseek's k_up and v_up are absorbed in decode, but
# a prefill's expert group of ≤ 16 rows takes the same body)
SERVED_DECODE = [(name, proj, m, k, n)
                 for name, rows in (("paper-llama3.2-3b", (8, 2)),
                                    ("paper-gpt2", (8, 2)),
                                    ("gemma3-12b", (2,)),
                                    ("deepseek-v2-236b", (8, 2)),
                                    ("zamba2-7b", (8, 2)),
                                    ("xlstm-1.3b", (8, 2)))
                 for proj, k, n in _projections(name) for m in rows]


@pytest.mark.parametrize("case", SERVED_DECODE, ids=str)
def test_served_bf16_decode_takes_the_tensor_core_split_k_body(case):
    """Every served decode projection in bf16 (aligned, as the model's
    weights and activations are) goes to the tensor-core split-K body; in
    f32 to the SIMT split-K body."""
    _, _, m, k, n = case
    assert _body(m, k, n, True, True) == "tensor-core split-K"
    assert _body(m, k, n, False, True) == "split-K"


@pytest.mark.parametrize("m,k,n,aligned", [
    (8, 777, 333, True), (8, 776, 332, True), (2, 3071, 1024, True),
    (16, 3072, 1020, True), (8, 3072, 3072, False), (1, 8, 8, False),
    (8, 2048, 2730, True), (8, 2730, 2048, True)],
    ids=str)
def test_what_tma_cannot_describe_takes_the_simt_split_k_body(m, k, n,
                                                              aligned):
    """At decode rows, K or N not a multiple of 8 or an x or W off 16-byte
    alignment: the SIMT split-K body and its own plan."""
    assert _body(m, k, n, True, aligned) == "split-K"


# (N, K) of the tensor-core split-K body: the served decode projections,
# odd and ragged shapes, K under one slice, K past one staging of x
TC_SPLIT = [(3072, 3072), (1024, 3072), (768, 768), (4096, 3840),
            (2048, 3840), (3840, 4096), (1000, 3000), (136, 1000), (8, 40),
            (64, 8), (64, 40000), (200, 20000), (64, 64), (8192, 3072),
            (256, 100_000)]


@pytest.mark.parametrize("n,k", TC_SPLIT, ids=str)
def test_tc_split_plan_meets_the_c_entry_checks(n, k):
    """The plan passes lora_matmul_launch's checks for bit 2: one cluster
    of at most 8 K chunks (splits·kc ≥ K, no empty chunk), kc a multiple of
    64 (no TMA box of W straddles two chunks), columns in blocks of 64, and
    shared memory within a block's at any M ≤ 16 and r ≤ 64."""
    splits, kc, bn = _tc_split_plan(n, k, H100_SMS)
    assert 1 <= splits <= MAX_SPLITS and kc > 0 and kc % 64 == 0
    assert splits * kc >= k and (splits - 1) * kc < k
    assert bn == DC_BN == 64
    for mp in (8, 16):
        for r in (0, 1, 4, 64):
            assert _dc_smem(mp, kc, r) <= SMEM_PER_BLOCK


@pytest.mark.parametrize("n,k,plan", [
    (3072, 3072, (4, 768, 64)), (1024, 3072, (8, 384, 64)),
    (768, 768, (6, 128, 64)), (4096, 3840, (4, 960, 64)),
    (2048, 3840, (6, 640, 64)), (3840, 4096, (4, 1024, 64)),
    (64, 64, (1, 64, 64)), (64, 40000, (8, 5056, 64))],
    ids=["llama_q_o", "llama_k_v", "gpt2_qkvo", "gemma3_q", "gemma3_k_v",
         "gemma3_o", "one_slice", "long_k"])
def test_tc_split_plan_puts_enough_blocks_on_every_sm(n, k, plan):
    """The fewest chunks of at most 1024 rows whose grid of 64-column
    blocks puts at least 1.4 blocks on each of the 132 SMs (at most 8, and
    no more than K's 64-row slices)."""
    splits, kc, _ = got = _tc_split_plan(n, k, H100_SMS)
    assert got == plan
    slices, cols = -(-k // 64), -(-n // 64)
    most = min(MAX_SPLITS, slices)
    # enough blocks, or as many chunks as 8 (or K's slices) allow, after kc
    # is rounded up to whole slices
    assert 5 * cols * splits >= 7 * H100_SMS or kc == 64 * -(-slices // most)
    fewer = splits - 1
    assert fewer < 1 or 5 * cols * fewer < 7 * H100_SMS \
        or -(-slices // fewer) > 16


def test_tc_split_plan_is_cached():
    _tc_split_plan.cache_clear()
    _tc_split_plan(1024, 3072, H100_SMS)
    _tc_split_plan(1024, 3072, H100_SMS)
    assert _tc_split_plan.cache_info().hits == 1


@pytest.mark.parametrize("case", [c for c in SERVED_DECODE if c[1] != "v"],
                         ids=str)
def test_tc_split_shared_memory_fits_four_blocks_an_sm(case):
    """The plan's premise: at the served decode shapes (M ≤ 8, r 4) four
    blocks fit an H100 SM's 228 KB (1 KB of it reserved a block), each
    with its 3 stages of 8 KB of W in flight."""
    _, _, m, k, n = case
    _, kc, _ = _tc_split_plan(n, k, H100_SMS)
    assert m <= 8
    smem = _dc_smem(8, kc, 4)
    assert smem >= 1024 + DC_STAGES * 64 * 128
    assert 4 * (smem + 1024) <= 228 * 1024


def test_tc_split_plan_matches_the_source():
    """The constants behind ``_dc_smem`` and the plan are the CUDA
    source's (``DC_BN``, ``DC_STAGES``, ``DC_X_BYTES``, ``DC_A_BYTES``, the
    portable cluster of ``SK_MAX_CLUSTER``), and its shared memory is
    summed from the same terms."""
    src = (CSRC / "lora_matmul.cu").read_text()
    for name, value in (("DC_BN", DC_BN), ("DC_STAGES", DC_STAGES),
                        ("DC_X_BYTES", DC_X_BYTES),
                        ("DC_A_BYTES", DC_A_BYTES),
                        ("SK_MAX_CLUSTER", MAX_SPLITS)):
        found = re.search(r"constexpr int %s = (\d+);" % name, src)
        assert found is not None and int(found.group(1)) == value, name
    body = src[src.index("constexpr size_t dc_smem("):]
    body = body[:body.index("}")]
    for term in ("DC_STAGES * DC_BOX", "dc_xk(mp, kc) * mp * 2",
                 "(r > 0 ? DC_A_BYTES : 0)", "r * DC_BN * 2",
                 "dc_recv(mp) * 4", "(SK_MAX_CLUSTER + 1) * mp * r * 4",
                 "(2 * DC_STAGES + 3) * 8"):
        assert term in body, term
    assert "constexpr int DC_BOX = 64 * 128;" in src
