"""The shared memory, the body plan and the band rules of the port's
``flash_swa`` (B8).

The wrapper computes a launch's shared memory and picks its body
(``_body``: the tensor cores for bf16 that TMA can describe, else SIMT);
the band rules (which KV tiles a query tile loads, which of them run
unmasked, which key groups of a tile a SIMT block of 8 query rows
computes, which tiles a tensor-core warpgroup leaves out) run on the card,
and ``kernels/flash_swa.py`` keeps a copy of each as the CUDA source
applies it. Here every rule is held against the attention mask by brute
force at a spread of (Sq, Sk, causal, window), with each body's tile: the
SIMT body's (64 query rows, 64 keys, at every padded head dim) and the
tensor-core body's at DP 64, 128 and 256 (its masks decided per
warpgroup of 64 rows). Pure arithmetic on the CPU; the kernel itself runs
only on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.kernels.flash_swa import (BKV, BQ,  # noqa: E402
                                           SMEM_LIMIT, TC_ROWS, _body,
                                           _interior, _key_groups, _kv_band,
                                           _plan, _rows_masked, _smem_bytes,
                                           _tc_bkv, _tc_blocks, _tc_bq,
                                           _tc_skips, _tc_smem)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run the port's CPU ops on one thread (see test_torch_baselines.py)."""
    torch = pytest.importorskip("torch")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SM_SHARED = 233_472  # shared memory of one SM (228 KB), 1 KB kept per block
LENGTHS = [1, 63, 64, 65, 127, 128, 129, 333, 500, 512]
WINDOWS = [0, 1, 64, 200, 1000, 1024]

# (Sq, Sk, causal, window)
CASES = ([(s, s, True, w) for s in LENGTHS for w in WINDOWS]
         + [(s, s, False, w) for s in LENGTHS for w in (0, 1, 64, 200)]
         + [(4096, 4096, True, w) for w in (0, 1, 1024)]
         + [(2048, 2048, True, w) for w in (0, 1024)]  # gemma3's prefill
         + [(4096, 4096, False, 1000)]
         + [(sq, sk, c, w) for sq, sk in ((200, 333), (333, 200), (300, 129),
                                          (65, 500), (500, 65))
            for c in (True, False) for w in (0, 64, 200)])


def _visible(sq, sk, causal, window):
    q = np.arange(sq)[:, None]
    k = np.arange(sk)[None, :]
    mask = np.ones((sq, sk), dtype=bool)
    if causal:
        mask &= k <= q
    if window:
        mask &= q - k < window
    return mask


# (query rows of a block, rows a mask is decided for, keys of a KV tile):
# the SIMT body's tile at every DP, the tensor-core body's at DP 64, 128
# and 256 (a warpgroup of 64 rows decides its own masks)
TILES = {"SIMT": (BQ, BQ, BKV),
         **{f"tc-DP{dp}": (_tc_bq(dp), TC_ROWS, _tc_bkv(dp))
            for dp in (64, 128, 256)}}


def _tiles(mask, bq, bkv):
    """(query tile, KV tile) → any visible pair, over the real rows."""
    sq, sk = mask.shape
    nq, nk = -(-sq // bq), -(-sk // bkv)
    padded = np.zeros((nq * bq, nk * bkv), dtype=bool)
    padded[:sq, :sk] = mask
    return padded.reshape(nq, bq, nk, bkv).any(axis=(1, 3))


@pytest.mark.parametrize("tile", TILES, ids=str)
@pytest.mark.parametrize("case", CASES, ids=str)
def test_band_schedules_exactly_the_visible_tiles(case, tile):
    """A query tile loads every KV tile that holds a visible pair of one of
    its real rows, and no other."""
    sq, sk, causal, window = case
    bq, _, bkv = TILES[tile]
    visible = _tiles(_visible(sq, sk, causal, window), bq, bkv)
    for qt in range(visible.shape[0]):
        lo, hi = _kv_band(qt * bq, sq, sk, causal, window, bq, bkv)
        scheduled = np.zeros(visible.shape[1], dtype=bool)
        scheduled[lo:hi + 1] = True
        assert (scheduled == visible[qt]).all(), (qt, lo, hi)


@pytest.mark.parametrize("tile", TILES, ids=str)
@pytest.mark.parametrize("case", CASES, ids=str)
def test_interior_tiles_hold_no_masked_pair(case, tile):
    """A tile flagged interior for a block of rows (the SIMT body's query
    tile, a tensor-core warpgroup's 64 rows) runs unmasked for them: all
    its keys are real and every real row of the block sees every one of
    them."""
    sq, sk, causal, window = case
    bq, rows, bkv = TILES[tile]
    mask = _visible(sq, sk, causal, window)
    interior = 0
    for q0 in range(0, sq, bq):
        lo, hi = _kv_band(q0, sq, sk, causal, window, bq, bkv)
        for r0 in range(q0, min(q0 + bq, sq), rows):
            r_last = min(r0 + rows - 1, sq - 1)
            for kt in range(lo, hi + 1):
                k0 = kt * bkv
                if _interior(r0, r_last, k0, sk, causal, window, bkv):
                    interior += 1
                    assert k0 + bkv <= sk
                    assert mask[r0:r_last + 1, k0:k0 + bkv].all(), (r0, k0)
    if sq == sk >= 4 * bkv and (not window or window >= 4 * bkv):
        assert interior > 0  # the long cases do run unmasked tiles


@pytest.mark.parametrize("dp", [64, 128, 256])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_tensor_core_warpgroups_skip_only_seen_rows(case, dp):
    """The KV tiles a tensor-core warpgroup leaves out of its block's band
    (``_tc_skips``) are a suffix of it; it has no visible pair in them, and
    every real row of it has seen a visible key in a tile it computed
    before (so computing the tile would give corr = 1, p = 0). A
    warpgroup past Sq computes nothing."""
    sq, sk, causal, window = case
    bq, bkv = _tc_bq(dp), _tc_bkv(dp)
    mask = _visible(sq, sk, causal, window)
    for q0 in range(0, sq, bq):
        lo, hi = _kv_band(q0, sq, sk, causal, window, bq, bkv)
        for r0 in range(q0, q0 + bq, TC_ROWS):
            r_last = min(r0 + TC_ROWS - 1, sq - 1)
            skips = [_tc_skips(r0, r_last, kt * bkv, sq, causal)
                     for kt in range(lo, hi + 1)]
            n = skips.index(True) if True in skips else len(skips)
            assert not any(skips[:n]) and all(skips[n:]), (r0, skips)
            if r0 >= sq:
                assert n == 0
                continue
            rows = mask[r0:r_last + 1]
            if n < len(skips):
                assert not rows[:, (lo + n) * bkv:].any(), (r0, n)
                seen = rows[:, lo * bkv:(lo + n) * bkv].any(axis=1)
                sees_any = rows.any(axis=1)
                assert seen[sees_any].all(), (r0, n)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_row_blocks_skip_and_trim_only_masked_keys(case):
    """The key groups that a block of 8 query rows leaves out of a scheduled
    tile are masked for all its real rows; where it leaves out all of them
    it has no visible pair there; and where it leaves some out without
    having seen a key, each of its rows sees one in the tile (so no row's
    p = 1 wash-out is cut short). Blocks past Sq compute nothing."""
    sq, sk, causal, window = case
    mask = _visible(sq, sk, causal, window)
    for q0 in range(0, sq, BQ):
        lo, hi = _kv_band(q0, sq, sk, causal, window)
        for kt in range(lo, hi + 1):
            k0 = kt * BKV
            masked = not _interior(q0, min(q0 + BQ - 1, sq - 1), k0, sk,
                                   causal, window)
            for r0 in range(q0, q0 + BQ, 8):
                rows = mask[r0:r0 + 8, k0:k0 + BKV]
                if _rows_masked(r0, k0, sk, causal, window):
                    assert not rows.any(), (r0, k0)
                for seen in (True, False):
                    nj = _key_groups(r0, k0, sq, sk, causal, window, masked,
                                     seen)
                    assert 0 <= nj <= 4
                    assert (nj == 0) == (r0 >= sq) or seen
                    assert not rows[:, 16 * nj:].any(), (r0, k0, nj)
                    if 0 < nj < 4 and not seen:
                        assert rows.any(axis=1).all(), (r0, k0, nj)


@pytest.mark.parametrize("dp", [64, 128])
def test_shared_memory_fits_two_blocks_an_sm(dp):
    """A block's shared memory fits the limit, twice over an SM."""
    smem = _smem_bytes(dp)
    assert smem <= SMEM_LIMIT
    assert 2 * (smem + 1024) <= SM_SHARED


# (B, S, H, KVH, d): the serving prefill of paper-gpt2 (MHA 12/12, d 64)
# and of paper-llama3.2-3b (GQA 24/8, d 128), causal, no window
PREFILLS = [(8, 512, 12, 12, 64), (8, 512, 24, 8, 128)]


@pytest.mark.parametrize("case", PREFILLS, ids=["paper-gpt2",
                                                "paper-llama3.2-3b"])
def test_prefill_shapes_plan_a_launch(case):
    """The wrapper plans these launches (no refusal): head dim padded to
    64 or 128, shared memory for two blocks an SM, batch·heads within the
    grid, whole groups of query heads a KV head; query tile t loads KV
    tiles 0..t, and only the diagonal tile is masked."""
    b, s, h, kvh, d = case
    dp, smem = _plan("swa_attention", b, h, d)
    assert dp == (64 if d <= 64 else 128) and smem == _smem_bytes(dp)
    assert 2 * (smem + 1024) <= SM_SHARED and b * h <= 65535
    assert h % kvh == 0
    for t in range(-(-s // BQ)):
        q0 = t * BQ
        assert _kv_band(q0, s, s, True, 0) == (0, t)
        q_last = min(q0 + BQ - 1, s - 1)
        assert [_interior(q0, q_last, j * BKV, s, True, 0)
                for j in range(t + 1)] == [True] * t + [False]


def test_shared_memory_at_head_dim_256_fits_one_block_an_sm():
    """At DP 256 the kernel's 64-row tile takes 213,296 bytes: within the
    limit, one block an SM (the source's ``blocks_per_sm``)."""
    smem = _smem_bytes(256)
    assert smem == 213_296 <= SMEM_LIMIT
    assert 2 * (smem + 1024) > SM_SHARED
    # the K/V ring alone rules out two blocks, whatever the query tile
    assert 2 * 2 * BKV * 256 * 4 > SM_SHARED // 2


@pytest.mark.parametrize("d", [129, 192, 255, 256])
def test_head_dims_above_128_pad_to_256(d):
    assert _plan("swa_attention", 2, 16, d) == (256, _smem_bytes(256))


@pytest.mark.parametrize("window", [0, 1024], ids=["global", "local"])
def test_gemma3_prefill_plans_a_launch(window):
    """gemma3-12b's prefill on the card (B 2, S 2048, GQA 16/8, d 256):
    query tile t loads the KV tiles of its band, [t − 16, t] under the
    window of 1024 and [0, t] without; the tiles below the diagonal run
    unmasked except the band's first one under the window."""
    b, s, h, kvh, d = 2, 2048, 16, 8, 256
    dp, smem = _plan("swa_attention", b, h, d)
    assert (dp, smem) == (256, 213_296) and h % kvh == 0
    span = window // BKV if window else None
    for t in range(s // BQ):
        q0, q_last = t * BQ, t * BQ + BQ - 1
        lo = max(0, t - span) if span else 0
        assert _kv_band(q0, s, s, True, window) == (lo, t)
        flags = [_interior(q0, q_last, j * BKV, s, True, window)
                 for j in range(lo, t + 1)]
        first_masked = bool(span) and t >= span
        assert flags == ([not first_masked] + [True] * (t - lo - 1)
                         + [False] if t > lo else [False])


def test_plan_refuses_what_the_kernel_cannot_hold():
    with pytest.raises(ValueError, match="head dim"):
        _plan("swa_attention", 1, 8, 257)
    with pytest.raises(ValueError, match="grid"):
        _plan("swa_attention", 4096, 32, 64)


@pytest.mark.parametrize("dp", [64, 128, 256])
def test_tensor_core_blocks_fit_an_sm(dp):
    """The tensor-core body's shared memory (``tc_smem``: 1 KB of
    alignment, the Q tile, 2 K and 2 V tiles, the mbarriers) is within a
    block's limit, and its blocks an SM (``tc_blocks``: 4 at DP 64, 1 at
    128 and 256) fit the SM's shared memory together."""
    smem, blocks = _tc_smem(dp), _tc_blocks(dp)
    assert smem == {64: 42_056, 128: 164_936, 256: 197_704}[dp]
    assert smem <= SMEM_LIMIT
    assert blocks * (smem + 1024) <= SM_SHARED
    assert blocks == (4 if dp == 64 else 1)


def _contiguous(b, sq, sk, h, kvh, d):
    """The (batch, position, head) strides and lengths of contiguous q, k,
    v and out, as the serving path's projections give them."""
    strides = (sq * h * d, h * d, d, sk * kvh * d, kvh * d, d,
               sk * kvh * d, kvh * d, d, sq * h * d, h * d, d)
    sizes = (b, sq, h, b, sk, kvh, b, sk, kvh)
    return strides, sizes


# (B, S, H, KVH, d): every served bf16 prefill attention (paper-llama3.2-3b
# and paper-gpt2 at batch 8 × prompt 512, gemma3-12b at batch 2 × 2048, its
# windowed layers alike; deepseek-v2-236b's MLA at batch 8 × 512, q and k
# of nope + rope = 192 and v zero-padded to it; zamba2-7b's shared block at
# batch 8 × 512, MHA at head dim 112, its second column box part past d)
# and Llama's serve launcher at batch 2 × prompt 32
SERVED = {"paper-llama3.2-3b": (8, 512, 24, 8, 128),
          "paper-gpt2": (8, 512, 12, 12, 64),
          "gemma3-12b": (2, 2048, 16, 8, 256),
          "deepseek-v2-236b": (8, 512, 128, 128, 192),
          "zamba2-7b": (8, 512, 32, 32, 112),
          "launcher": (2, 32, 24, 8, 128)}


@pytest.mark.parametrize("name", SERVED, ids=str)
def test_plan_sends_served_bf16_prefills_to_the_tensor_cores(name):
    b, s, h, kvh, d = SERVED[name]
    strides, sizes = _contiguous(b, s, s, h, kvh, d)
    assert _body(True, d, strides, sizes, True) == "tensor-core"
    dp, _ = _plan("swa_attention", b, h, d)
    assert dp == {64: 64, 112: 128, 128: 128, 192: 256, 256: 256}[d]


@pytest.mark.parametrize("why", ["f32", "d 50", "d 66", "view off 16 bytes",
                                 "row off 16 bytes"])
def test_plan_sends_what_tma_cannot_describe_to_simt(why):
    """f32, head dims that are not multiples of 8, a pointer off 16 bytes
    and a row stride that is not a multiple of 8 elements take the SIMT
    body; the flash_swa layout (H = KVH = 1, head stride 0) still takes
    the tensor cores."""
    d = {"d 50": 50, "d 66": 66}.get(why, 128)
    strides, sizes = _contiguous(2, 300, 300, 4, 2, d)
    low, aligned = why != "f32", why != "view off 16 bytes"
    if why == "row off 16 bytes":  # k's positions 129 elements apart
        strides = strides[:4] + (129,) + strides[5:]
    assert _body(low, d, strides, sizes, aligned) == "SIMT"
    flat = (300 * 128, 128, 0) * 4
    assert _body(True, 128, flat, (6, 300, 1) * 3, True) == "tensor-core"
