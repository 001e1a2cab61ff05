"""The float32 flash kernel's loop order, emulated on the CPU.

``csrc/flash_attention.cu`` runs only on the card.  Its loop order is
emulated here in plain float32 torch: the tile sizes of each template
width (read from the source's ``Tiles<D>`` table, so a change there is
followed), d rounded up to that width with zero columns, one query tile
at a time with the kernel's KV-tile bounds (tiles above the diagonal and
before the window skipped), a ragged last tile of zero rows, the masks
only on tiles that straddle an edge (as the kernel decides it), and the
online-softmax rescaling.  The emulation is held against the JAX
package's ``flash_attention`` (Pallas, interpret mode) and against
``flash_attention_plain`` within ``2e-4``, the float32 gate the kernel is
held to on the card.  Nothing in ``repro_torch`` imports this.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels.flash_attention import flash_attention_plain

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
          "kernels" / "csrc" / "flash_attention.cu")
WIDTHS = (32, 64, 128, 256)
GATE = dict(rtol=2e-4, atol=2e-4)
NEG_INF = -1e30


def kernel_tiles() -> dict:
    """{D: (BQ, BK)} from the kernel source's ``Tiles<D>`` table."""
    found = re.findall(r"struct Tiles<(\d+)> \{ static constexpr int "
                       r"BQ = (\d+), BK = (\d+); \};", SOURCE.read_text())
    return {int(d): (int(bq), int(bk)) for d, bq, bk in found}


def emulate_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, window: int) -> torch.Tensor:
    """The kernel's loop order on float32 (BH, S, d) tensors."""
    bh, s, d = q.shape
    width = next(w for w in WIDTHS if d <= w)
    bq, bk = kernel_tiles()[width]
    pad = (0, width - d)
    qs = torch.nn.functional.pad(q, pad) * (1.0 / math.sqrt(d))
    ks = torch.nn.functional.pad(k, pad)
    vs = torch.nn.functional.pad(v, pad)
    out = torch.empty_like(q)
    for q0 in range(0, s, bq):
        qt = torch.nn.functional.pad(qs[:, q0:q0 + bq],
                                     (0, 0, 0, q0 + bq - min(s, q0 + bq)))
        qi = torch.arange(q0, q0 + bq)[:, None]
        kv_end = min(s, q0 + bq) if causal else s
        kv_begin = max(0, q0 - window + 1) if window > 0 else 0
        kv_begin = kv_begin // bk * bk
        m = torch.full((bh, bq), NEG_INF)
        l = torch.zeros((bh, bq))
        acc = torch.zeros((bh, bq, width))
        for k0 in range(kv_begin, kv_end, bk):
            rows = (0, 0, 0, k0 + bk - min(s, k0 + bk))
            kt = torch.nn.functional.pad(ks[:, k0:k0 + bk], rows)
            vt = torch.nn.functional.pad(vs[:, k0:k0 + bk], rows)
            sc = torch.einsum("bqd,bkd->bqk", qt, kt)
            edge = ((causal and k0 + bk - 1 > q0)
                    or (window > 0 and q0 + bq - 1 - k0 >= window)
                    or k0 + bk > s)
            if edge:
                kj = torch.arange(k0, k0 + bk)[None, :]
                masked = (kj >= s).expand(bq, bk)
                if causal:
                    masked = masked | (kj > qi)
                if window > 0:
                    masked = masked | (qi - kj >= window)
                sc = torch.where(masked, torch.full_like(sc, NEG_INF), sc)
            m_new = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bqk,bkd->bqd", p,
                                                         vt)
            m = m_new
        o = acc / torch.clamp_min(l, 1e-30)[..., None]
        out[:, q0:q0 + bq] = o[:, :min(s, q0 + bq) - q0, :d]
    return out


def test_tile_table_fits_the_card():
    """Every width has its tiles, 16 rows and keys a thread group divides
    them, and Q, two K/V stages and P fit the 227 KB a block may use."""
    tiles = kernel_tiles()
    assert sorted(tiles) == list(WIDTHS)
    for width, (bq, bk) in tiles.items():
        assert bq % 16 == 0 and bk // 16 in (2, 4)
        assert 4 * (bq * width + 4 * bk * width + bq * bk) <= 232448


@pytest.mark.parametrize("d", [8, 16, 40, 128])
@pytest.mark.parametrize("s", [63, 200, 1000])
@pytest.mark.parametrize("window", [-1, 1, 50, 64, 300])
@pytest.mark.parametrize("causal", [True, False])
def test_emulation_matches_pallas_and_plain(causal, window, s, d):
    """Windows smaller than, equal to (64 keys) and larger than a KV tile;
    S ragged to the tiles; d padded to its template width with zeros."""
    rng = np.random.default_rng(s * 1009 + d * 31 + window)
    q, k, v = (torch.as_tensor(rng.normal(size=(2, s, d)),
                               dtype=torch.float32) for _ in range(3))
    got = emulate_f32(q, k, v, causal, window)
    pallas = jax_flash(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                       causal=causal, window=window, block_q=128,
                       block_k=128, interpret=True)
    plain = flash_attention_plain(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **GATE)
    torch.testing.assert_close(got, plain, **GATE)
