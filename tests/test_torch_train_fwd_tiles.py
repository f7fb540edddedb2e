"""The redesigned training forward (csrc/flash_train.cu: `flash_train_fwd`,
its TMA / wgmma variant at D 64 and 128 and its cp.async variant at every
other D) on the CPU: its launch plan, and its arithmetic written out here in
torch.

- The launch plan (mirrored here from the source): blocks of 64
  query rows over key tiles of 64, issued from the last query tile (the
  most key tiles) to the first over a (B * H, query tiles) grid; the K / V
  ring's stages (TMA: 2; cp.async: 3 at a padded head dimension <= 64, 2
  above); the shared memory of a block within the card's 227 KB at every
  D, and four TMA blocks a SM at D 64; the TMA variant at D 64 and 128
  only (16-byte head strides), each read against the source's constants.
- `_tiled_fwd` does what both variants do: per block of 64 query rows the
  key tiles of 64 up to the diagonal one; per tile s = q.k in fp32, x = s
  scale log2(e) + bias log2(e) on every tile, the causal mask -1e9 log2(e)
  past the row on the diagonal tile only (the keys past T are zeros, as the
  copies fill them, and the diagonal mask hides them from every row < T),
  the running max from -1e9 log2(e), p = exp2(x - m) rounded to bf16 for
  p.v and summed unrounded into l; out = acc / l, lse = m ln 2 + log l.
  Against the plain version `flash_train_fwd_ref` and the JAX package's
  `flash_attention_train_pallas` in interpret mode, at D 64 / 100 / 128,
  ragged T, B > 1, with and without a caption bias that masks whole rows
  (finite out and lse there; compared on the other rows, as the kernels'
  fully masked rows are junk that depends on the tiles visited).
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlar_tpu.ops import flash_train_pallas as jftp
from controlar_tpu_torch.ops import flash_train as ft

SOURCE = Path(ft.__file__).resolve().parent.parent / "csrc" / "flash_train.cu"
LOG2E = 1.4426950408889634
NEG2 = -1e9 * LOG2E
SMEM_PER_BLOCK = 232448  # 227 KB: the most a block may take on the H100
SMEM_PER_SM = 233472     # 228 KB, 1 KB of it reserved for each resident block

# The tiled arithmetic against the plain version: both round p to bf16
# (2**-9 relative), against the running max here and the row max there, and
# sum in another order: |out| <= max |v| ~ 4 moves by a few 1e-3 at most.
PLAIN_ATOL, PLAIN_RTOL = 1e-2, 1e-2
LSE_ATOL = 1e-4  # fp32 statistics in another order, |lse| ~ 5
# Against the Pallas kernel, as tests/test_torch_flash_train.py states: it
# rounds p against the running max of its 16-key tiles.
PALLAS_ATOL, PALLAS_RTOL = 5e-3, 1e-2

# The forward's launch plan, mirrored from the source (the tests below read
# its constants): blocks of ROWS query rows over key tiles of KEY_TILE keys,
# the head dimension padded as `ft.padded_head_dim` says; the query tiles
# issued last first (the most key tiles first).
ROWS = KEY_TILE = 64
TMA_BOX_BYTES = 64 * 64 * 2  # a TMA box: 64 rows of 64 bf16 columns


def fwd_stages(d):
    """Stages of the forward's K / V ring: 2 in the TMA variant (four blocks
    a SM at D 64); 3 in the cp.async one at a padded head dimension <= 64,
    2 above."""
    if ft.fwd_variant(d) == "tma":
        return 2
    return 3 if ft.padded_head_dim(d) <= 64 else 2


def fwd_smem_bytes(d):
    """Dynamic shared memory of the forward's block at head dimension d."""
    dp, ns = ft.padded_head_dim(d), fwd_stages(d)
    if ft.fwd_variant(d) == "tma":  # alignment slack, Q, K / V stages, mbarriers
        return 1024 + (1 + 2 * ns) * (dp // 64) * TMA_BOX_BYTES + (1 + 2 * ns) * 8
    ld = dp + 8  # rows padded by 8 elements: Q, then per stage K, V and the bias row
    return ROWS * ld * 2 + ns * (2 * KEY_TILE * ld * 2 + KEY_TILE * 4)


def fwd_grid(b, t, h):
    """The forward's grid: (B * H, query tiles)."""
    return b * h, -(-t // ROWS)


def fwd_query_tile(block_y, n_tiles):
    """The query tile of the blocks at blockIdx.y = block_y: the heaviest
    (the last tile, with the most key tiles) first."""
    return n_tiles - 1 - block_y

CASES = [  # b, t, h, d, left padding of each batch row (None: causal only)
    (2, 150, 2, 64, (5, 70)),
    (3, 64, 1, 64, None),
    (2, 1, 2, 64, None),
    (1, 130, 3, 100, None),
    (1, 333, 2, 100, (120,)),
    (2, 65, 2, 128, (3, 0)),
    (1, 200, 2, 128, (40,)),
    (2, 97, 2, 32, (10, 0)),
]
IDS = [f"b{c[0]}_t{c[1]}_d{c[3]}_{'bias' if c[4] else 'causal'}" for c in CASES]


def _constant(name):
    (value,) = re.findall(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    return int(value)


def test_tiles_and_stages_are_the_kernels_own():
    src = SOURCE.read_text()
    assert ROWS == _constant("kRows") and KEY_TILE == _constant("kKeyTile") == 64
    assert TMA_BOX_BYTES == _constant("kBoxCols") * KEY_TILE * 2
    (small, large) = map(int, re.findall(
        r"constexpr int kStages = DP <= 64 \? (\d+) : (\d+);", src)[0])
    for d in range(4, 129, 4):
        want = (_constant("kTmaStages") if ft.fwd_variant(d) == "tma"
                else small if ft.padded_head_dim(d) <= 64 else large)
        assert fwd_stages(d) == want


def test_the_tma_variant_takes_d_64_and_128_only():
    """The variant is a function of D alone, the source's dispatch: a tensor
    map takes 16-byte strides, which D 64 and 128 heads have and D 100 heads
    (200 bytes) do not."""
    assert re.search(r"if constexpr \(DP == 64 \|\| DP == 128\) \{\s*if \(D == DP\)",
                     SOURCE.read_text())
    assert ft.TMA_HEAD_DIMS == (64, 128)
    for d in range(4, 129, 4):
        want = "tma" if d in (64, 128) else "cp.async"
        assert ft.fwd_variant(d) == want
        if want == "tma":
            assert (d * 2) % 16 == 0
    assert (100 * 2) % 16 != 0
    for bad in (0, 6, 132):
        with pytest.raises(ValueError):
            ft.fwd_variant(bad)


@pytest.mark.parametrize("d", list(range(4, 129, 4)))
def test_shared_memory_fits_the_card(d):
    smem = fwd_smem_bytes(d)
    assert smem <= SMEM_PER_BLOCK
    if ft.fwd_variant(d) == "tma":
        # the launch bounds ask for four blocks a SM at D 64, two at 128
        blocks = 4 if d == 64 else 2
        assert re.search(r"__launch_bounds__\(kTmaThreads, DP <= 64 \? 4 : 2\)",
                         SOURCE.read_text())
        assert blocks * (smem + 1024) <= SMEM_PER_SM


@pytest.mark.parametrize("t", [1, 63, 64, 65, 375, 576, 1143])
def test_grid_issues_the_heaviest_query_tiles_first(t):
    b, h = 3, 5
    assert fwd_grid(b, t, h) == (b * h, math.ceil(t / 64))
    n = fwd_grid(b, t, h)[1]
    order = [fwd_query_tile(y, n) for y in range(n)]
    assert sorted(order) == list(range(n))  # every query tile once
    key_tiles = [qt + 1 for qt in order]  # tiles up to the diagonal one
    assert key_tiles == sorted(key_tiles, reverse=True)
    assert re.search(r"const int q0 = \(gridDim\.y - 1 - blockIdx\.y\) \* kRows;",
                     SOURCE.read_text())


def _tiled_fwd(q, k, v, kbias):
    """The kernels' forward in torch: (out (B, T, H, D) in q's dtype, lse
    (B, H, T) f32). T is padded with zeros to whole tiles, as the copies
    fill the rows past T; only the diagonal tile is masked."""
    b, t, h, d = q.shape
    tp = -(-t // ROWS) * ROWS
    pad = (0, 0, 0, 0, 0, tp - t)
    qf, kf, vf = (torch.nn.functional.pad(x.to(torch.bfloat16).float(), pad).permute(0, 2, 1, 3)
                  for x in (q, k, v))  # (B, H, Tp, D)
    bias = torch.zeros(b, tp) if kbias is None else torch.nn.functional.pad(kbias.float(),
                                                                            (0, tp - t))
    scale2 = torch.tensor(LOG2E, dtype=torch.float32) / math.sqrt(d)
    out = torch.zeros(b, h, tp, d)
    lse = torch.zeros(b, h, tp)
    n_q = fwd_grid(b, t, h)[1]
    for y in range(n_q):
        qt = fwd_query_tile(y, n_q)
        rows = slice(qt * ROWS, (qt + 1) * ROWS)
        m = torch.full((b, h, ROWS), NEG2)
        l = torch.zeros(b, h, ROWS)
        acc = torch.zeros(b, h, ROWS, d)
        for j in range(qt + 1):  # key tiles up to the diagonal one
            cols = slice(j * KEY_TILE, (j + 1) * KEY_TILE)
            s = qf[:, :, rows] @ kf[:, :, cols].transpose(-1, -2)
            x = s * scale2 + (bias[:, None, None, cols] * LOG2E)
            if j == qt:
                r = torch.arange(rows.start, rows.stop)[:, None]
                c = torch.arange(cols.start, cols.stop)[None, :]
                x = x.masked_fill(c > r, NEG2)
            mx = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2(m - mx)
            p = torch.exp2(x - mx[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p.to(torch.bfloat16).float() @ vf[:, :, cols]
            m = mx
        out[:, :, rows] = acc / l[..., None]
        lse[:, :, rows] = m * math.log(2) + torch.log(l)
    return out.permute(0, 2, 1, 3)[:, :t].to(q.dtype).contiguous(), lse[:, :, :t]


def _inputs(b, t, h, d, pads, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))
    valid = np.ones((b, t), bool)
    for i, p in enumerate(pads or ()):
        valid[i, :p] = False
    return q, k, v, valid, pads is not None


def _rows(valid):
    """Rows that see at least one unmasked key (a left-padded row sees only
    masked keys and is junk in every kernel)."""
    return torch.from_numpy(valid)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tiled_forward_matches_the_plain_version(case):
    b, t, h, d, pads = case
    q, k, v, valid, with_bias = _inputs(b, t, h, d, pads, seed=t + d)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    kb = ft.key_bias(torch.from_numpy(valid)) if with_bias else None
    out, lse = _tiled_fwd(tq, tk, tv, kb)
    want, want_lse = ft.flash_train_fwd_ref(tq, tk, tv, kb)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    rows = _rows(valid)
    torch.testing.assert_close(out[rows], want[rows], atol=PLAIN_ATOL, rtol=PLAIN_RTOL)
    lrows = rows[:, None, :].expand_as(lse)
    torch.testing.assert_close(lse[lrows], want_lse[lrows], atol=LSE_ATOL, rtol=0)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tiled_forward_matches_the_pallas_kernel(case):
    b, t, h, d, pads = case
    q, k, v, valid, with_bias = _inputs(b, t, h, d, pads, seed=t + d)
    want = np.asarray(jftp.flash_attention_train_pallas(
        *map(jnp.asarray, (q, k, v)), jnp.asarray(valid) if with_bias else None,
        q_block=32, k_block=16, interpret=True))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    kb = ft.key_bias(torch.from_numpy(valid)) if with_bias else None
    out, _ = _tiled_fwd(tq, tk, tv, kb)
    rows = valid[:, :, None, None]
    np.testing.assert_allclose(out.numpy() * rows, want * rows, atol=PALLAS_ATOL,
                               rtol=PALLAS_RTOL)


def test_the_diagonal_mask_hides_the_keys_past_t():
    """Rows < T of a ragged last tile equal the same rows computed with T a
    whole number of tiles whose extra keys are zeros: the zero keys past T
    are masked by the causal test alone."""
    b, t, h, d = 1, 100, 2, 64
    q, k, v, _, _ = _inputs(b, t, h, d, None, seed=3)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = _tiled_fwd(tq, tk, tv, None)
    zeros = torch.zeros(b, 128 - t, h, d)
    full, full_lse = _tiled_fwd(*(torch.cat([x, zeros], 1) for x in (tq, tk, tv)), None)
    assert torch.equal(out, full[:, :t]) and torch.equal(lse, full_lse[:, :, :t])
