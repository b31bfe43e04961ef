"""The port's kernel modules (mgldvsr_tpu_torch.ops.kernels): each plain
version against the JAX Pallas function it replaces, run in interpret
mode on the CPU; each wrapper given a CPU tensor takes its plain version
and launches nothing. The CUDA kernels themselves are held against the
plain versions on the card by ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgldvsr_tpu_torch.ops import kernels
from mgldvsr_tpu_torch.ops.kernels.attention import (
    attention,
    attention_bnhd,
    attention_bnhd_plain,
    attention_plain,
)
from mgldvsr_tpu_torch.ops.kernels.corr_lookup import lookup_corr, lookup_corr_plain
from mgldvsr_tpu_torch.ops.kernels.flow_warp import (
    flow_warp_guided,
    warp_dx,
    warp_dx_plain,
    warp_forward,
    warp_plain,
)
from mgldvsr_tpu_torch.ops.kernels import gn_silu_conv as conv_mod
from mgldvsr_tpu_torch.ops.kernels import groupnorm as gn_mod
from mgldvsr_tpu_torch.ops.kernels import guidance as guide_mod
from mgldvsr_tpu_torch.ops.kernels.gn_silu_conv import gn_silu_conv3x3, gn_silu_conv3x3_plain
from mgldvsr_tpu_torch.ops.kernels.groupnorm import (
    channel_sums,
    channel_sums_plain,
    fused_group_norm,
    fused_group_norm_plain,
)


def _warp_inputs(seed=0, n=3, h=8, w=12, c=4):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, h, w, c).astype(np.float32)
    # displacements up to +-6 px: many samples fall partly or wholly outside
    flow = (rs.rand(n, h, w, 2) * 12 - 6).astype(np.float32)
    g = rs.randn(n, h, w, c).astype(np.float32)
    return x, flow, g


def test_warp_plain_matches_pallas_forward_and_dx():
    """float32, atol 1e-5: the same 4-tap bilinear arithmetic, summed in
    another order (the Pallas kernel as one-hot matmuls)."""
    from mgldvsr_tpu.ops.pallas.flow_warp import flow_warp_guided as jax_guided

    x, flow, g = _warp_inputs()
    want, vjp = jax.vjp(lambda a: jax_guided(a, jnp.asarray(flow), True), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    got = warp_plain(torch.from_numpy(x), torch.from_numpy(flow))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    got_dx = warp_dx_plain(torch.from_numpy(g), torch.from_numpy(flow))
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx), atol=1e-5)


def test_guided_warp_autograd_gives_dx_only():
    """The autograd Function's backward is the dx version; the flow gets no
    gradient, as in the JAX package's contract."""
    x, flow, g = _warp_inputs(seed=1)
    xt = torch.from_numpy(x).requires_grad_(True)
    ft = torch.from_numpy(flow).requires_grad_(True)
    out = flow_warp_guided(xt, ft)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), warp_plain(xt, ft).detach().numpy())
    np.testing.assert_allclose(xt.grad.numpy(),
                               warp_dx_plain(torch.from_numpy(g), ft.detach()).numpy(),
                               atol=1e-6)
    assert ft.grad is None


def test_warp_dx_is_the_transpose_of_autograd():
    """dx equals autograd through the plain gather warp (float32, 1e-5)."""
    x, flow, g = _warp_inputs(seed=2, n=2, h=7, w=9, c=3)
    xt = torch.from_numpy(x).requires_grad_(True)
    warp_plain(xt, torch.from_numpy(flow)).backward(torch.from_numpy(g))
    got = warp_dx_plain(torch.from_numpy(g), torch.from_numpy(flow))
    np.testing.assert_allclose(got.numpy(), xt.grad.numpy(), atol=1e-5)


@pytest.mark.parametrize("n,d", [(200, 16), (130, 64)])
def test_attention_plain_matches_resident_attention(n, d):
    """N not a multiple of 128, so the Pallas kernel pads and masks keys.
    float32, 2e-5: fp32 softmax on both sides, sums in another order."""
    from mgldvsr_tpu.ops.pallas.attention import resident_attention

    rs = np.random.RandomState(n)
    q, k, v = (rs.randn(3, n, d).astype(np.float32) for _ in range(3))
    want = resident_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 128, True)
    got = attention_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def _tiled_attention(q, k, v, q_rows=128, key_tile=128, d_tile=None):
    """The tensor-core kernels' arithmetic, tile by tile, in plain tensor
    code: blocks of ``q_rows`` query rows walk ``key_tile``-key tiles (rows
    past N zero-filled) with a running max and sum in float32; S is summed
    in float32 over ``d_tile``-wide sub-tiles of D where given (the
    head-dim-512 kernel's 64-column sub-tiles); keys >= N are masked to -inf
    before the max; P = exp2(S scale log2e - max) is rounded to the input
    type before P V, while the sum keeps the float32 values; the accumulator
    is rescaled by exp2(old max - new max); query rows >= N are never
    written."""
    bh, n, d = q.shape
    scale_log2 = d ** -0.5 * 1.4426950408889634
    tiles = -(-n // key_tile)
    pad = tiles * key_tile - n
    kp = torch.nn.functional.pad(k, (0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, pad))
    out = torch.full_like(q, float("nan"))
    for q0 in range(0, n, q_rows):
        qt = q[:, q0:q0 + q_rows].float()
        m = torch.full(qt.shape[:2], float("-inf"))
        l = torch.zeros(qt.shape[:2])
        acc = torch.zeros(qt.shape)
        for j in range(tiles):
            kt = kp[:, j * key_tile:(j + 1) * key_tile].float()
            vt = vp[:, j * key_tile:(j + 1) * key_tile]
            if d_tile is None:
                s = qt @ kt.transpose(1, 2)
            else:
                s = sum(qt[..., c:c + d_tile] @ kt[..., c:c + d_tile].transpose(1, 2)
                        for c in range(0, d, d_tile))
            keys = j * key_tile + torch.arange(key_tile)
            s = s.masked_fill(keys >= n, float("-inf"))
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp2((m - m_new) * scale_log2)
            p = torch.exp2((s - m_new[..., None]) * scale_log2)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + p.to(q.dtype).float() @ vt.float()
            m = m_new
        out[:, q0:q0 + q_rows] = (acc / l[..., None]).to(q.dtype)
    assert torch.isfinite(out.float()).all()
    return out


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n", [1024, 1100, 300])
def test_tiled_attention_arithmetic_matches_plain(n, dtype, tol):
    """The kernel's tile-by-tile arithmetic against the plain version.
    float32 1e-5: sums in another order. bfloat16 2e-2: the plain version
    rounds its logits and normalised probabilities to bf16, the tiled form
    the unnormalised ones."""
    rs = np.random.RandomState(n)
    q, k, v = (torch.from_numpy(rs.randn(2, n, 64).astype(np.float32)).to(dtype)
               for _ in range(3))
    got = _tiled_attention(q, k, v)
    np.testing.assert_allclose(got.float().numpy(), attention_plain(q, k, v).float().numpy(),
                               atol=tol, rtol=0)
    if dtype == torch.bfloat16:  # logits of tens: the running max moves, rescales are large
        q8 = q * 8
        want = attention_plain(q8.float(), k.float(), v.float())
        np.testing.assert_allclose(_tiled_attention(q8, k, v).float().numpy(), want.numpy(),
                                   atol=tol, rtol=0)


@pytest.mark.parametrize("n,q_rows", [(300, 128), (1100, 64)])
def test_tiled_attention_arithmetic_matches_resident_attention(n, q_rows):
    """The same against the Pallas kernel in interpret mode, float32, 2e-5
    (fp32 softmax on both sides, sums in another order)."""
    from mgldvsr_tpu.ops.pallas.attention import resident_attention

    rs = np.random.RandomState(n + 1)
    q, k, v = (rs.randn(2, n, 64).astype(np.float32) for _ in range(3))
    want = resident_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 128, True)
    got = _tiled_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), q_rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("scale", [1, 8])
def test_tiled_wide_attention_arithmetic_matches_plain(scale):
    """The bf16 head-dim-512 kernel's arithmetic: 64-row blocks, 64-key
    tiles, S over eight 64-column sub-tiles of D, the fp32 online softmax
    and P rounded to bf16 before P V, on bf16 values at [2,1030,512] (N off
    the tiles) against the plain version in float32 on the same values: 3
    bf16 ulps at max |want|, the card's limit; with q scaled by 8 (logits of
    tens, the max moving from tile to tile) 2e-2, the card's limit there."""
    rs = np.random.RandomState(1030 + scale)
    q, k, v = (torch.from_numpy(rs.randn(2, 1030, 512).astype(np.float32)) for _ in range(3))
    q, k, v = (q * scale).to(torch.bfloat16), k.to(torch.bfloat16), (v + 1).to(torch.bfloat16)
    got = _tiled_attention(q, k, v, q_rows=64, key_tile=64, d_tile=64).float()
    want = attention_plain(q.float(), k.float(), v.float())
    tol = 3 * 2 ** -8 * float(want.abs().max()) if scale == 1 else 2e-2
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol, rtol=0)


def _vae_mid_views(n, dtype):
    """The VAE's mid-attention operands without memory: a [5, 512, N]
    1x1-conv output viewed [5, N, 1, 512], stride N in D."""
    return torch.empty(5, 512, n, dtype=dtype, device="meta").transpose(1, 2)[:, :, None]


@pytest.mark.parametrize("dtype,view,offset,want", [
    (torch.bfloat16, lambda: _vae_mid_views(1024, torch.bfloat16), 0, "dn"),   # 256 px
    (torch.bfloat16, lambda: _vae_mid_views(2304, torch.bfloat16), 0, "dn"),   # 384 px
    (torch.bfloat16, lambda: _vae_mid_views(3249, torch.bfloat16), 0, None),   # 456 px: N odd
    (torch.bfloat16, lambda: _vae_mid_views(1030, torch.bfloat16), 0, None),   # N % 8 = 6
    (torch.float32, lambda: _vae_mid_views(1024, torch.float32), 0, None),     # fp32: rows only
    (torch.bfloat16, lambda: _vae_mid_views(1024, torch.bfloat16), 2, None),   # base off 16 B
    (torch.bfloat16, lambda: torch.empty(5, 3249, 1, 512, dtype=torch.bfloat16), 0, "nd"),
    (torch.float32, lambda: torch.empty(5, 2025, 1, 512), 0, "nd"),
    (torch.bfloat16, lambda: torch.empty(5, 1024, 2, 512, dtype=torch.bfloat16), 0, None),
])
def test_wide_attention_dispatch(dtype, view, offset, want):
    """Head dim 512: which kernel each type takes, and in which layout the
    VAE's views and token rows are read in place (``route`` is whether)."""
    from mgldvsr_tpu_torch.ops.kernels.attention import kernel_variant, route, wide_layout

    z = view()
    assert kernel_variant(dtype, 512) == ("wide_wgmma" if dtype == torch.bfloat16 else "wide_fma")
    assert wide_layout(dtype, z.shape, z.stride(), offset) == want
    assert route(dtype, z.shape, z.stride(), offset) == (want is not None)


@pytest.mark.parametrize("radius", [2, 4])
def test_corr_lookup_plain_matches_pallas(radius):
    """Bilinear blend, level scaling, transposed window order and zeros for
    far-out centres. float32, 1e-5."""
    from mgldvsr_tpu.flow.raft import build_corr_pyramid
    from mgldvsr_tpu.ops.pallas.corr_lookup import lookup_corr_pallas, pad_pyramid

    rs = np.random.RandomState(radius)
    b, h, w, c = 2, 8, 8, 16
    f1 = jnp.asarray(rs.randn(b, h, w, c), jnp.float32)
    f2 = jnp.asarray(rs.randn(b, h, w, c), jnp.float32)
    pyr = build_corr_pyramid(f1, f2, num_levels=3)
    coords = (rs.rand(b, h, w, 2) * 20 - 6).astype(np.float32)
    want = lookup_corr_pallas(pad_pyramid(pyr, radius), jnp.asarray(coords), radius,
                              q_block=16, interpret=True)
    got = lookup_corr_plain([torch.from_numpy(np.array(p)) for p in pyr],
                            torch.from_numpy(coords), radius)
    assert got.shape == (b, h, w, 3 * (2 * radius + 1) ** 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_channel_sums_plain_matches_pallas():
    """bf16 input, float32 sums: both widen each element to float32 first;
    rtol 1e-5 covers the summation order. Also batch 1 with an odd H*W (rows
    that start off the kernel's 16-byte boundary), as text to image decodes."""
    from mgldvsr_tpu.ops.pallas.groupnorm import channel_sums as jax_sums

    rs = np.random.RandomState(0)
    for shape in ((2, 12, 8, 32), (1, 13, 11, 24)):  # NHWC
        x = jnp.asarray(rs.randn(*shape) * 3 + 1, jnp.bfloat16)
        s1, s2 = jax_sums(x, interpret=True)
        xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).permute(0, 3, 1, 2)
        g1, g2 = channel_sums_plain(xt.contiguous())
        np.testing.assert_allclose(g1.numpy(), np.asarray(s1), rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(g2.numpy(), np.asarray(s2), rtol=1e-5, atol=1e-3)


def _sums_parts(hw: int, itemsize: int, offset: int) -> list:
    """The elements of one row that ``channel_sums_kernel``
    (``csrc/groupnorm.cu``) sums, in its arithmetic, for a row that starts
    ``offset`` bytes past a 16-byte boundary: the head before the first
    boundary, the whole vectors from it, and the ragged end."""
    vec = 16 // itemsize
    head = min(hw, (16 - offset % 16) % 16 // itemsize)
    nvec = (hw - head) // vec
    return [range(0, head), range(head, head + nvec * vec), range(head + nvec * vec, hw)]


@pytest.mark.parametrize("hw", [63, 13 * 11, 16380, 16384, 65536, 262144])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_channel_sums_plan_covers_each_element_once(hw, itemsize):
    """For rows from 1 to 1280, the plan's block shape is in the kernel's
    range, and the kernel's parts of every row (each row starting where a
    contiguous [N, C, H, W] tensor puts it) cover each element exactly once.
    The port's shapes (128 rows and more) take the threads that keep 8 MB in
    flight in the last wave of blocks."""
    from mgldvsr_tpu_torch.ops.kernels.groupnorm import channel_sums_plan

    for rows in (1, 3, 16, 64, 128, 255, 256, 512, 640, 1280):
        assert channel_sums_plan(rows, hw, itemsize) in (256, 512, 1024)
        for offset in sorted({(r * hw * itemsize) % 16 for r in range(min(rows, 16))}):
            seen = np.zeros(hw, np.int64)
            for part in _sums_parts(hw, itemsize, offset):
                seen[part.start:part.stop] += 1
            assert (seen == 1).all(), (rows, hw, itemsize, offset)
    assert channel_sums_plan(256, 16384, 2) == 512     # text to image, [1,256,128,128]
    assert channel_sums_plan(128, 262144, 2) == 1024   # [1,128,512,512]: 128 rows
    assert channel_sums_plan(640, 262144, 2) == 256    # the restore, [5,128,512,512]
    assert channel_sums_plan(1280, 262144, 2) == 1024  # [5,256,512,512]: a fifth wave
    assert channel_sums_plan(16, 63, 2) == 256         # rows shorter than a block's threads


def test_channel_sums_loads_match_the_kernel():
    """The plan's loads in flight a thread are the kernel's ``INFLIGHT``."""
    import re
    from pathlib import Path

    from mgldvsr_tpu_torch.ops.kernels import groupnorm as gn_mod

    src = Path(gn_mod.__file__).resolve().parents[2] / "csrc" / "groupnorm.cu"
    found = re.findall(r"constexpr int INFLIGHT = (\d+);", src.read_text())
    assert found == [str(gn_mod.SUMS_LOADS)], found


def _nchw(a):
    """NHWC numpy -> contiguous NCHW float32 tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_group_norm_plain_matches_pallas(dtype, eps):
    """float32: 1e-5 (sums in another order). bfloat16: both round the
    folded scale and shift to bf16 and compute x*a+b in bf16; 2 bf16 ulps of
    max |y| cover a scale or shift that rounds to the neighbouring value."""
    from mgldvsr_tpu.ops.pallas.groupnorm import fused_group_norm as jax_gn

    rs = np.random.RandomState(5)
    x = jnp.asarray(rs.randn(2, 6, 5, 64) * 2 + 0.5, dtype)
    scale, bias = rs.randn(64).astype(np.float32), rs.randn(64).astype(np.float32)
    want = np.asarray(jax_gn(x, jnp.asarray(scale), jnp.asarray(bias), 32, eps, interpret=True),
                      np.float32)
    xt = _nchw(x).to(getattr(torch, dtype))
    got = fused_group_norm_plain(xt, torch.from_numpy(scale), torch.from_numpy(bias), 32, eps)
    assert got.dtype == xt.dtype
    tol = 1e-5 if dtype == "float32" else 2 * 2 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(_nhwc(got), want, atol=tol, rtol=0)


def test_fused_group_norm_plain_5d_matches_lean_group_norm():
    """The port-only 5-D (temporal) case: the plain version against the lean
    GroupNorm the layers use, bf16, 2 ulps of max |y| (x^2 is squared in
    fp32 here and in bf16 there)."""
    from mgldvsr_tpu_torch.models.layers import group_norm_lean

    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(1, 64, 5, 6, 7, generator=gen) * 2 + 0.5).to(torch.bfloat16)
    w, b = torch.randn(64, generator=gen), torch.randn(64, generator=gen)
    want = group_norm_lean(x, w, b, 32, 1e-6, torch.bfloat16).float()
    got = fused_group_norm_plain(x, w, b, 32, 1e-6).float()
    assert got.shape == x.shape
    torch.testing.assert_close(got, want, atol=2 * 2 ** -8 * float(want.abs().max()), rtol=0)


def _conv_inputs(t, h, w, c, co, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(t, h, w, c).astype(np.float32),
            (rs.randn(c) * 0.5 + 1.0).astype(np.float32), (rs.randn(c) * 0.2).astype(np.float32),
            (rs.randn(3, 3, c, co) * 0.05).astype(np.float32),
            (rs.randn(co) * 0.1).astype(np.float32))


def _port_conv_args(x, gw, gb, k, b, dtype=torch.float32):
    """JAX layouts (NHWC, HWIO) -> the port's (NCHW, OIHW)."""
    return (_nchw(x).to(dtype), torch.from_numpy(gw), torch.from_numpy(gb),
            torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))).to(dtype),
            torch.from_numpy(b))


@pytest.mark.parametrize("t,h,w,c,co,groups", [
    (2, 8, 8, 64, 96, 32),     # co not a tile multiple
    (1, 16, 8, 32, 32, 8),     # rectangular
    (3, 8, 8, 64, 128, 32),
])
def test_gn_silu_conv_plain_matches_pallas(t, h, w, c, co, groups):
    """float32 against the Pallas kernel in interpret mode, 2e-4 (the JAX
    package's own limit for this kernel against its composition)."""
    from mgldvsr_tpu.ops.pallas.gn_silu_conv import gn_silu_conv3x3 as jax_fused

    args = _conv_inputs(t, h, w, c, co)
    want = jax_fused(*map(jnp.asarray, args), groups=groups, co_tile=64, interpret=True)
    got = gn_silu_conv3x3_plain(*_port_conv_args(*args), groups=groups, eps=1e-5)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=2e-4, rtol=0)


def test_gn_silu_conv_plain_bf16_matches_pallas():
    """bf16 in and out, fp32 statistics and accumulation on both sides; 0.1
    as in the JAX package's bf16 test."""
    from mgldvsr_tpu.ops.pallas.gn_silu_conv import gn_silu_conv3x3 as jax_fused

    x, gw, gb, k, b = _conv_inputs(2, 8, 8, 64, 64, seed=1)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jax_fused(xb, jnp.asarray(gw), jnp.asarray(gb), jnp.asarray(k, jnp.bfloat16),
                     jnp.asarray(b), groups=16, interpret=True)
    got = gn_silu_conv3x3_plain(
        *_port_conv_args(np.asarray(xb, np.float32), gw, gb, k, b, torch.bfloat16),
        groups=16, eps=1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(got), np.asarray(want, np.float32), atol=0.1, rtol=0)


def test_gn_silu_conv_plain_zero_pads_the_normalised_activation():
    """A constant input normalises to the GroupNorm bias; a corner sees 4
    taps and the centre 9, which only zero padding of the normalised
    activation gives. Against the Pallas kernel: 1e-4, plus 1e-5 relative
    (the outputs reach 90, so float32 rounding alone is 3e-4 there)."""
    from mgldvsr_tpu.ops.pallas.gn_silu_conv import gn_silu_conv3x3 as jax_fused

    c = co = 32
    args = (np.ones((1, 8, 8, c), np.float32), np.ones(c, np.float32),
            np.full(c, 0.5, np.float32), np.ones((3, 3, c, co), np.float32),
            np.zeros(co, np.float32))
    want = np.asarray(jax_fused(*map(jnp.asarray, args), groups=8, interpret=True))
    got = _nhwc(gn_silu_conv3x3_plain(*_port_conv_args(*args), groups=8, eps=1e-5))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(got[0, 0, 0, 0] / got[0, 4, 4, 0], 4 / 9, rtol=1e-5)


def _on_cpu_through_the_function(monkeypatch, which):
    """The card-only autograd Functions, run on the CPU with their kernel
    launch replaced by the plain version: their backward is what is tested."""
    if which == "channel_sums":
        monkeypatch.setattr(gn_mod, "_launch_channel_sums", channel_sums_plain)
        return gn_mod._ChannelSums.apply
    if which == "fused_group_norm":
        monkeypatch.setattr(gn_mod, "_launch_fused_gn", fused_group_norm_plain)
        return lambda x, w, b: gn_mod._FusedGroupNorm.apply(x, w, b, 8, 1e-5)
    monkeypatch.setattr(conv_mod, "_launch", gn_silu_conv3x3_plain)
    return lambda *a: conv_mod._GNSiLUConv.apply(*a, 8, 1e-5)


@pytest.mark.parametrize("which", ["channel_sums", "fused_group_norm", "gn_silu_conv3x3"])
@pytest.mark.parametrize("through", ["wrapper", "function"])
def test_new_wrappers_gradients_match_jax(monkeypatch, which, through):
    """Gradients of sum(out^2) against ``jax.grad`` of the JAX function,
    float32, 2e-3 (the JAX package's limit for the fused conv's gradient).
    ``wrapper`` is the public function on a CPU tensor (autograd through the
    plain version); ``function`` is the autograd Function the card uses."""
    from mgldvsr_tpu.ops.pallas.gn_silu_conv import gn_silu_conv3x3 as jax_fused
    from mgldvsr_tpu.ops.pallas.groupnorm import channel_sums as jax_sums
    from mgldvsr_tpu.ops.pallas.groupnorm import fused_group_norm_vjp

    x, gw, gb, k, b = _conv_inputs(1, 8, 8, 32, 32, seed=2)
    if which == "channel_sums":
        jargs, targs = (x,), (_nchw(x),)
        jfn = lambda a: sum(jnp.sum(s ** 2) for s in jax_sums(a, interpret=True))  # noqa: E731
        tfn = channel_sums
    elif which == "fused_group_norm":
        jargs, targs = (x, gw, gb), _port_conv_args(x, gw, gb, k, b)[:3]
        jfn = lambda *a: jnp.sum(fused_group_norm_vjp(*a, 8, 1e-5) ** 2)  # noqa: E731
        tfn = lambda *a: fused_group_norm(*a, 8, 1e-5)  # noqa: E731
    else:
        jargs, targs = (x, gw, gb, k, b), _port_conv_args(x, gw, gb, k, b)
        jfn = lambda *a: jnp.sum(jax_fused(*a, groups=8, interpret=True) ** 2)  # noqa: E731
        tfn = lambda *a: gn_silu_conv3x3(*a, 8, 1e-5)  # noqa: E731
    if through == "function":
        tfn = _on_cpu_through_the_function(monkeypatch, which)
    want = jax.grad(jfn, argnums=tuple(range(len(jargs))))(*map(jnp.asarray, jargs))
    leaves = [t.clone().requires_grad_(True) for t in targs]
    out = tfn(*leaves)
    sum(o.square().sum() for o in (out if isinstance(out, tuple) else (out,))).backward()
    for i, (leaf, w) in enumerate(zip(leaves, want)):
        got = leaf.grad.numpy()
        if got.ndim == 4:  # NCHW -> NHWC; OIHW -> HWIO
            got = got.transpose(0, 2, 3, 1) if i == 0 else got.transpose(2, 3, 1, 0)
        np.testing.assert_allclose(got, np.asarray(w), atol=2e-3, rtol=1e-4)


def test_wrappers_take_the_plain_path_on_cpu():
    """A CPU tensor goes to the plain version; no launch is counted."""
    kernels.reset_launch_counts()
    x, flow, g = (torch.from_numpy(a) for a in _warp_inputs(seed=3))
    assert torch.equal(warp_forward(x, flow), warp_plain(x, flow))
    assert torch.equal(warp_dx(g, flow), warp_dx_plain(g, flow))
    q = torch.randn(2, 64, 16, generator=torch.Generator().manual_seed(0))
    assert torch.equal(attention(q, q, q), attention_plain(q, q, q))
    q4 = q.reshape(1, 64, 2, 16).to(torch.bfloat16)
    assert torch.equal(attention_bnhd(q4, q4, q4), attention_bnhd_plain(q4, q4, q4))
    pyr = [torch.randn(1, 16, 4, 4), torch.randn(1, 16, 2, 2)]
    coords = torch.rand(1, 4, 4, 2) * 4
    assert torch.equal(lookup_corr(pyr, coords, 2), lookup_corr_plain(pyr, coords, 2))
    xb = torch.randn(2, 8, 16, 16).to(torch.bfloat16)
    for a, b in zip(channel_sums(xb), channel_sums_plain(xb)):
        assert torch.equal(a, b)
    w8, b8 = torch.rand(8) + 0.5, torch.rand(8)
    assert torch.equal(fused_group_norm(xb, w8, b8, 4), fused_group_norm_plain(xb, w8, b8, 4))
    wt, bias = torch.randn(6, 8, 3, 3).to(torch.bfloat16), torch.rand(6)
    assert torch.equal(gn_silu_conv3x3(xb, w8, b8, wt, bias, 4),
                       gn_silu_conv3x3_plain(xb, w8, b8, wt, bias, 4))
    lat, flows, occs = _guidance_inputs(1, 5, 6, 6, 4, seed=3)
    grad, cot = guide_mod.guidance_residual(lat, flows, occs, 5)
    want_grad, want_cot = guide_mod.guidance_residual_plain(lat, flows, occs, 5)
    assert torch.equal(grad, want_grad) and torch.equal(cot, want_cot)
    assert torch.equal(guide_mod.guidance_scatter(grad, cot, flows, 5),
                       guide_mod.guidance_scatter_plain(want_grad, want_cot, flows, 5))
    assert torch.equal(guide_mod.guidance_grad(lat, flows, occs, 5),
                       guide_mod.guidance_grad_plain(lat, flows, occs, 5))
    counts = kernels.launch_counts()
    assert set(kernels.WRAPPERS) <= set(counts) and not any(counts.values())



def _tiled_gn_silu_conv(x, scale, shift, weight, bias):
    """The tensor-core conv kernel's arithmetic, tile by tile, in plain tensor
    code: the weight re-laid ``[9][Co][Cp]`` (Cp = C rounded up to 64, zeros
    beyond C); pixel tiles of 8 x 16 by 128 output channels, or 8 x 8 by 64
    for frames up to 8 pixels wide; per 64-channel stage a halo patch of
    SiLU in the kernel's form ``h + h * tanh(h)``, ``h = (x * scale + shift) /
    2``, rounded to x's dtype, zero outside the frame and for channels >= C;
    nine shifted per-tap products accumulated in float32 over weight rows
    that are zero past Co; where the tiles are few, the stages split among 2,
    4 or 8 partial sums that are added at the end (the blocks of a cluster);
    bias added in float32, one rounding; pixels and channels past the edges
    never written."""
    n, c, h, w = x.shape
    co = weight.shape[0]
    wre = conv_mod.relayout_weight(weight).float()
    cp = wre.shape[2]
    assert wre.shape[:2] == (9, co) and cp % 64 == 0 and 0 <= cp - c < 64
    th, tw, bn = (8, 16, 128) if w > 8 else (8, 8, 64)
    stages = cp // 64
    tiles = -(-h // th) * -(-w // tw)
    blocks = (tiles * n if w > 8 else -(-tiles * n // 2)) * -(-co // bn)
    ksplit = 1
    while ksplit < 8 and blocks * ksplit * 2 <= 264 and ksplit * 2 <= stages:
        ksplit *= 2
    out = torch.full((n, co, h, w), float("nan"), dtype=x.dtype)
    for f in range(n):
        for y0 in range(0, h, th):
            for x0 in range(0, w, tw):
                ys, xs = torch.arange(y0 - 1, y0 + th + 1), torch.arange(x0 - 1, x0 + tw + 1)
                inside = ((ys >= 0) & (ys < h))[:, None] & ((xs >= 0) & (xs < w))[None, :]
                for co0 in range(0, co, bn):
                    parts = torch.zeros(ksplit, th, tw, bn)
                    for stage in range(stages):
                        c0 = stage * 64
                        acc = parts[next(r for r in range(ksplit)
                                         if stage < stages * (r + 1) // ksplit)]
                        cs = min(64, c - c0)
                        raw = x[f, c0:c0 + cs][:, ys.clamp(0, h - 1)][:, :, xs.clamp(0, w - 1)]
                        v = raw.float() * scale[f, c0:c0 + cs, None, None] \
                            + shift[f, c0:c0 + cs, None, None]
                        half = 0.5 * v
                        act = (half + half * torch.tanh(half)).to(x.dtype).float() * inside
                        patch = torch.zeros(th + 2, tw + 2, 64)
                        patch[:, :, :cs] = act.permute(1, 2, 0)
                        for tap in range(9):
                            rows = torch.zeros(bn, 64)
                            live = wre[tap, co0:co0 + bn, c0:c0 + 64]
                            rows[:live.shape[0]] = live
                            acc += patch[tap // 3:tap // 3 + th, tap % 3:tap % 3 + tw] @ rows.T
                    acc = parts[0]
                    for part in parts[1:]:
                        acc = acc + part
                    yv, xv, cv = min(th, h - y0), min(tw, w - x0), min(bn, co - co0)
                    res = acc[:yv, :xv, :cv] + bias[co0:co0 + cv].float()
                    out[f, co0:co0 + cv, y0:y0 + yv, x0:x0 + xv] = res.permute(2, 0, 1).to(x.dtype)
    assert torch.isfinite(out.float()).all()
    return out


_TILED_CASES = [
    (2, 12, 20, 96, 72, 32),    # C off the 64-channel stage, Co under one tile, ragged frame
    (1, 9, 7, 32, 70, 8),       # a narrow frame: 8 x 8 tiles by 64 channels, two column tiles
    (1, 8, 17, 64, 136, 32),    # two column tiles of 128, a one-pixel second tile
    (1, 8, 8, 288, 24, 32),     # 5 stages (the last half full) split among 4 partial sums
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,h,w,c,co,groups", _TILED_CASES)
def test_tiled_gn_silu_conv_arithmetic_matches_plain(t, h, w, c, co, groups, dtype):
    """The kernel's tile-by-tile arithmetic against the plain version.
    float32: 2e-4 of max |y| (sums in another order). bfloat16: 3 ulps of
    max |y| (the plain version rounds the conv's result and again after the
    bias, the tiled form once)."""
    x, gw, gb, wt, bias = _port_conv_args(*_conv_inputs(t, h, w, c, co, seed=c + co), dtype)
    scale, shift = gn_mod.gn_scale_shift(x, gw, gb, groups, 1e-5)
    got = _tiled_gn_silu_conv(x, scale, shift, wt, bias).float()
    want = gn_silu_conv3x3_plain(x, gw, gb, wt, bias, groups, 1e-5).float()
    rel = 2e-4 if dtype == torch.float32 else 3 * 2 ** -8
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=rel * float(want.abs().max()),
                               rtol=0)


@pytest.mark.parametrize("t,h,w,c,co,groups", _TILED_CASES)
def test_tiled_gn_silu_conv_arithmetic_matches_pallas(t, h, w, c, co, groups):
    """The same against the Pallas kernel in interpret mode, float32, 2e-4
    (the JAX package's own limit for this kernel against its composition)."""
    from mgldvsr_tpu.ops.pallas.gn_silu_conv import gn_silu_conv3x3 as jax_fused

    args = _conv_inputs(t, h, w, c, co, seed=c + co)
    want = jax_fused(*map(jnp.asarray, args), groups=groups, co_tile=64, interpret=True)
    x, gw, gb, wt, bias = _port_conv_args(*args)
    scale, shift = gn_mod.gn_scale_shift(x, gw, gb, groups, 1e-5)
    got = _tiled_gn_silu_conv(x, scale, shift, wt, bias)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=2e-4, rtol=0)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gn_scale_shift_plain_matches_the_jax_fold(monkeypatch, dtype, eps):
    """The folded (scale, shift) against the ones ``_fused_fwd_impl`` hands
    its Pallas kernel (caught at the ``pallas_call``), 1e-5: fp32 statistics
    of the input as it is on both sides. Frame 0 is a constant, whose
    variance is exactly 0 (clipped), so its scale is ``weight / sqrt(eps)``."""
    import mgldvsr_tpu.ops.pallas.gn_silu_conv as jax_mod

    caught = {}

    def fake_pallas_call(kernel, out_shape, **kwargs):
        def run(scale_tc, shift_tc, wk, bk, x):
            caught["scale"], caught["shift"] = np.asarray(scale_tc), np.asarray(shift_tc)
            return jnp.zeros(out_shape.shape, out_shape.dtype)
        return run

    monkeypatch.setattr(jax_mod.pl, "pallas_call", fake_pallas_call)
    x, gw, gb, k, b = _conv_inputs(3, 6, 10, 64, 8, seed=9)
    x[0] = 2.0
    x[2] = x[2] * 3 + 5
    xj = jnp.asarray(x, dtype)
    jax_mod._fused_fwd_impl(xj, jnp.asarray(gw), jnp.asarray(gb), jnp.asarray(k, dtype),
                            jnp.asarray(b), 16, eps, 128, True)
    xt = _nchw(np.asarray(xj, np.float32)).to(getattr(torch, dtype))
    scale, shift = gn_mod.gn_scale_shift(xt, torch.from_numpy(gw), torch.from_numpy(gb), 16, eps)
    assert scale.shape == shift.shape == (3, 64) and scale.dtype == torch.float32
    for got, want in ((scale, caught["scale"]), (shift, caught["shift"])):
        want = want.reshape(3, 64)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(scale[0].numpy(), gw * eps ** -0.5, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_relaid_weight_is_a_permute_made_once(dtype):
    """[Co,C,3,3] -> [9,Co,Cp] bit for bit a permute with zeros beyond C;
    reused on a second call; made again after an in-place update and after a
    ``load_state_dict``; the state dict keeps only the module's own layout."""
    torch.manual_seed(0)
    conv = torch.nn.Conv2d(40, 24, 3, padding=1).to(dtype)
    made = conv_mod._derived.made
    relaid = conv_mod.relaid_weight(conv.weight)
    assert relaid.shape == (9, 24, 64) and relaid.dtype == dtype and not relaid.requires_grad
    assert torch.equal(relaid[:, :, :40],
                       conv.weight.detach().permute(2, 3, 0, 1).reshape(9, 24, 40))
    assert not relaid[:, :, 40:].any()
    assert conv_mod.relaid_weight(conv.weight) is relaid
    assert conv_mod._derived.made == made + 1
    with torch.no_grad():
        conv.weight.mul_(2)
    doubled = conv_mod.relaid_weight(conv.weight)
    assert doubled is not relaid and torch.equal(doubled, relaid * 2)
    conv.load_state_dict({k: torch.ones_like(v) for k, v in conv.state_dict().items()})
    ones = conv_mod.relaid_weight(conv.weight)
    assert bool((ones[:, :, :40] == 1).all()) and not ones[:, :, 40:].any()
    assert conv_mod._derived.made == made + 3
    assert set(conv.state_dict()) == {"weight", "bias"}
    # a conv bias cast with its weight gets one cached float32 copy; float32 is itself
    if dtype == torch.float32:
        assert conv_mod.bias_fp32(conv.bias) is conv.bias
    else:
        copy = conv_mod.bias_fp32(conv.bias)
        assert copy.dtype == torch.float32 and conv_mod.bias_fp32(conv.bias) is copy
    # the cache entry goes with its tensor
    key = (id(conv.weight), "relaid")
    assert key in conv_mod._DERIVED
    del conv, relaid, doubled, ones
    assert key not in conv_mod._DERIVED


def _clustered_group_norm(x, weight, bias, groups, eps, split, aligned=True):
    """The fused GroupNorm kernel's arithmetic in plain tensor code: each
    (sample, group) slab split among ``split`` blocks into shares rounded up
    to whole 16-byte vectors (the last ones shorter or empty); per share the
    fp32 sums of its whole vectors and, apart, of the ragged end under one
    vector (of everything where the slab's base is off 16 bytes); the shares'
    sums added in rank order; ``var = max(E[x^2] - E[x]^2, 0)``; a and b
    rounded to x's dtype; the product rounded, then the sum; the channel of
    an element is its offset in the slab over the channel's length."""
    n, c = x.shape[:2]
    cg = c // groups
    s = x[0, 0].numel()
    slab = cg * s
    vec = 16 // x.element_size()
    share = -(-(-(-slab // split)) // vec) * vec
    xs = x.reshape(n * groups, slab)
    out = torch.empty_like(xs)
    for pid in range(n * groups):
        total = torch.zeros(2)
        for rank in range(split):
            begin, end = min(rank * share, slab), min((rank + 1) * share, slab)
            whole = (end - begin) // vec * vec if aligned else 0
            part = torch.zeros(2)
            for seg in (xs[pid, begin:begin + whole].float(), xs[pid, begin + whole:end].float()):
                part = part + torch.stack([seg.sum(), (seg * seg).sum()])
            total = total + part
        mean = total[0] / slab
        var = (total[1] / slab - mean * mean).clamp_min(0.0)
        inv = torch.rsqrt(var + eps)
        g = pid % groups
        a = inv * weight[g * cg:(g + 1) * cg]
        b = bias[g * cg:(g + 1) * cg] - mean * a
        ch = torch.arange(slab) // s
        out[pid] = xs[pid] * a.to(x.dtype)[ch] + b.to(x.dtype)[ch]
    return out.reshape(x.shape)


def _group_norm_limit(want, dtype):
    """float32: 1e-5 (sums in another order). bfloat16: 2 ulps of max |y| (a
    folded scale or shift that rounds to the neighbouring value)."""
    return 1e-5 if dtype == torch.float32 else 2 * 2 ** -8 * float(want.float().abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_clustered_group_norm_arithmetic_matches_plain(split, dtype):
    """Slabs of 3 channels x 35 = 105 elements: shares with ragged ends, empty
    last shares at a split of 8, channels that end inside a vector; aligned and
    off the 16-byte boundary; a constant sample (variance clipped at 0, where
    y is the bias up to the rounding of a and b). Limits as stated in
    ``_group_norm_limit``."""
    rs = np.random.RandomState(split)
    x = torch.from_numpy((rs.randn(3, 96, 5, 7) * 2 + 0.5).astype(np.float32)).to(dtype)
    x[2] = 2.0
    w, b = (torch.from_numpy(rs.randn(96).astype(np.float32)) for _ in range(2))
    want = fused_group_norm_plain(x, w, b, 32, 1e-5)
    for aligned in (True, False):
        got = _clustered_group_norm(x, w, b, 32, 1e-5, split, aligned)
        assert got.dtype == dtype and torch.isfinite(got.float()).all()
        tol = _group_norm_limit(want[:2], dtype)
        np.testing.assert_allclose(got[:2].float().numpy(), want[:2].float().numpy(), atol=tol,
                                   rtol=0)
        # the constant sample: a = w / sqrt(eps), limits at the size of 2 a
        size = 2 * 1e-5 ** -0.5 * float(w.abs().max())
        tol = size * (1e-6 if dtype == torch.float32 else 2 * 2 ** -8)
        np.testing.assert_allclose(got[2].float().numpy(), want[2].float().numpy(), atol=tol,
                                   rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("split", [2, 8])
def test_clustered_group_norm_arithmetic_matches_pallas(split, dtype):
    """The same against the Pallas kernel in interpret mode, on the inputs and
    with the limits of ``test_fused_group_norm_plain_matches_pallas``."""
    from mgldvsr_tpu.ops.pallas.groupnorm import fused_group_norm as jax_gn

    rs = np.random.RandomState(5)
    x = jnp.asarray(rs.randn(2, 6, 5, 64) * 2 + 0.5, dtype)
    scale, bias = rs.randn(64).astype(np.float32), rs.randn(64).astype(np.float32)
    want = np.asarray(jax_gn(x, jnp.asarray(scale), jnp.asarray(bias), 32, 1e-5, interpret=True),
                      np.float32)
    xt = _nchw(x).to(getattr(torch, dtype))
    got = _clustered_group_norm(xt, torch.from_numpy(scale), torch.from_numpy(bias), 32, 1e-5,
                                split)
    tol = 1e-5 if dtype == "float32" else 2 * 2 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(_nhwc(got), want, atol=tol, rtol=0)


def _full_width_group_norms(monkeypatch):
    """{tower: [(shape, groups), ...]}: every GroupNorm input of the full-width
    towers (5 frames, 512px, bfloat16) that goes to the fused GroupNorm kernel
    on the card, in call order, listed from the towers on the meta device."""
    import mgldvsr_tpu_torch.models.unet as unet_mod
    import mgldvsr_tpu_torch.models.vae as vae_mod
    import mgldvsr_tpu_torch.ops.attention as attend_mod
    from mgldvsr_tpu_torch.models import layers

    seen, towers = [], {}

    def record(x, weight, bias, groups, eps, dtype):
        assert weight.dtype == bias.dtype == torch.float32  # what the kernel reads as it is
        if not (x.ndim == 4 and x.shape[2] * x.shape[3] >= 16384):  # else the channel sums
            seen.append((tuple(x.shape), groups))
        return torch.empty_like(x, dtype=dtype)

    def taken():
        shapes = list(seen)
        del seen[:]
        return shapes

    monkeypatch.setenv("MGLD_FUSED_GN_CONV", "0")
    monkeypatch.setattr(layers, "group_norm_lean", record)
    monkeypatch.setattr(attend_mod, "attention_bnhd", lambda q, k, v: torch.empty_like(q))
    dtype, frames = torch.bfloat16, 5
    with torch.device("meta"), torch.no_grad():
        lat, t = torch.empty(frames, 4, 64, 64), torch.empty(frames, dtype=torch.long)
        enc = layers.cast_weights(unet_mod.StructCondEncoder(
            unet_mod.StructCondConfig(num_frames=frames, dtype=dtype)), dtype)
        cond = enc(lat, t)
        towers["structcond"] = taken()
        unet = layers.cast_weights(unet_mod.InflatedUNetDualCond(
            unet_mod.UNetConfig(num_frames=frames, dtype=dtype)), dtype)
        unet(lat, t, torch.empty(1, 77, 1024), cond)
        towers["unet"] = taken()
        vae = layers.cast_weights(vae_mod.VideoAutoencoderKLResi(
            vae_mod.VAEConfig(num_frames=frames, enable_fusion=True, dtype=dtype)), dtype)
        _, enc_fea = vae.encode(torch.empty(frames, 3, 512, 512))
        vae.decode(lat, enc_fea)
        towers["vae"] = taken()
    return towers


def test_fused_group_norm_plan_of_full_width_towers(monkeypatch):
    """The launcher's choice for every GroupNorm of a default restore at full
    width: 35 a step in the struct-cond encoder, 83 in the UNet, 21 a restore
    in the VAE (its larger levels take the channel sums). Every share is
    staged in shared memory and is at most 32 KB, so several blocks fit an
    SM; all four splits occur; a slab of 8 KB or less takes one block; the
    longest slab (960 channels at 64^2: 240 KB) takes a cluster of 8."""
    towers = _full_width_group_norms(monkeypatch)
    assert {k: len(v) for k, v in towers.items()} == {"structcond": 35, "unet": 83, "vae": 21}
    splits = set()
    for shape, groups in (entry for tower in towers.values() for entry in tower):
        cg = shape[1] // groups
        slab = cg * int(np.prod(shape[2:]))
        split, stage_bytes = gn_mod.fused_gn_plan(shape[0] * groups, slab, 2, cg)
        splits.add(split)
        assert -(-slab // split) * 2 <= stage_bytes <= 32 * 1024, (shape, split, stage_bytes)
        assert stage_bytes % 16 == 0 and stage_bytes + 8 * cg <= gn_mod.GN_STAGE_LIMIT
        assert (split == 1) == (slab * 2 < 16 * 1024 or shape[0] * groups >= 4 * gn_mod.SM_COUNT)
        if shape == (5, 960, 64, 64):
            assert (split, stage_bytes) == (8, 30720)
    assert splits == {1, 2, 4, 8}


@pytest.mark.parametrize("shape,itemsize,plan", [
    ((1, 1280, 5, 64, 64), 4, (8, 0)),       # float32 temporal slab of 3.2 MB: walked twice
    ((1, 32, 640, 640), 2, (8, 0)),          # 100 KB shares with a and b beside: not staged
    ((1, 64, 300, 300), 2, (8, 45008)),      # shares rounded up to whole vectors
    ((64, 1280, 8, 8), 2, (1, 5120)),        # many small slabs: one block each
    ((2, 32, 3, 1), 2, (1, 16)),             # a slab under one vector still gets one
])
def test_fused_group_norm_plan_off_the_towers(shape, itemsize, plan):
    """The branch where a share exceeds what is staged, and the small ends."""
    cg = shape[1] // 32
    assert gn_mod.fused_gn_plan(shape[0] * 32, cg * int(np.prod(shape[2:])), itemsize, cg) == plan


def _staged_lookup(pyramid, coords, radius):
    """The one-launch lookup kernel's arithmetic in plain tensor code: per
    query and level the base ``floor(c / 2^level)`` clamped to
    [-r-2, size+r+1] before the cast, a staged (2r+2)^2 integer window read
    from the unpadded map with zeros outside, the (2r+1)^2 samples blended
    from it with the unclamped fractions, cell ``xi * win + yi``, the levels
    one after another in a query's output."""
    b, h, w, _ = coords.shape
    n, r = h * w, radius
    side, win = 2 * r + 2, 2 * r + 1
    offs = torch.arange(side)
    out = torch.empty(b, n, len(pyramid), win * win)
    for lvl, corr in enumerate(pyramid):
        hl, wl = corr.shape[2:]
        c = coords.reshape(b, n, 2) * (1.0 / (1 << lvl))
        fl = torch.floor(c)
        tx, ty = (c - fl)[..., 0, None, None], (c - fl)[..., 1, None, None]
        x0 = fl[..., 0].clamp(-r - 2, wl + r + 1).to(torch.int64) - r
        y0 = fl[..., 1].clamp(-r - 2, hl + r + 1).to(torch.int64) - r
        ys = (y0[..., None] + offs)[..., :, None].expand(b, n, side, side)
        xs = (x0[..., None] + offs)[..., None, :].expand(b, n, side, side)
        inside = (xs >= 0) & (xs < wl) & (ys >= 0) & (ys < hl)
        flat = corr.reshape(b, n, hl * wl)
        index = (ys.clamp(0, max(hl - 1, 0)) * wl + xs.clamp(0, max(wl - 1, 0))).reshape(b, n, -1)
        if hl * wl:
            window = torch.gather(flat, 2, index).reshape(b, n, side, side) * inside
        else:
            window = torch.zeros(b, n, side, side)
        # p = window + yi * side + xi: rows are y, columns x
        val = ((1 - ty) * (1 - tx) * window[..., :win, :win] + (1 - ty) * tx * window[..., :win, 1:]
               + ty * (1 - tx) * window[..., 1:, :win] + ty * tx * window[..., 1:, 1:])
        out[:, :, lvl] = val.transpose(-1, -2).reshape(b, n, win * win)  # cell = xi * win + yi
    return out.reshape(b, h, w, -1)


@pytest.mark.parametrize("radius", [2, 4])
def test_staged_lookup_arithmetic_matches_plain(radius):
    """Ragged and empty level maps, centres outside the maps and far away
    (the clamped base). float32, 1e-6: the same four products in the same
    order."""
    rs = np.random.RandomState(radius)
    pyr = [torch.from_numpy(rs.randn(2, 36, hl, wl).astype(np.float32))
           for hl, wl in ((6, 6), (3, 3), (5, 2), (1, 4), (0, 0))]
    coords = torch.from_numpy((rs.rand(2, 6, 6, 2) * 20 - 6).astype(np.float32))
    coords[0, 0, :3] = torch.tensor([[-3e4, 2.0], [2.0, 4e4], [1e9, -1e9]])
    got = _staged_lookup(pyr, coords, radius)
    want = lookup_corr_plain(pyr, coords, radius)
    assert got.shape == want.shape == (2, 6, 6, 5 * (2 * radius + 1) ** 2)
    assert not got[0, 0, :3].any()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("radius", [2, 4])
def test_staged_lookup_arithmetic_matches_pallas(radius):
    """The same against ``lookup_corr_pallas`` in interpret mode on the inputs
    of ``test_corr_lookup_plain_matches_pallas``, float32, 1e-5."""
    from mgldvsr_tpu.flow.raft import build_corr_pyramid
    from mgldvsr_tpu.ops.pallas.corr_lookup import lookup_corr_pallas, pad_pyramid

    rs = np.random.RandomState(radius)
    b, h, w, c = 2, 8, 8, 16
    f1 = jnp.asarray(rs.randn(b, h, w, c), jnp.float32)
    f2 = jnp.asarray(rs.randn(b, h, w, c), jnp.float32)
    pyr = build_corr_pyramid(f1, f2, num_levels=3)
    coords = (rs.rand(b, h, w, 2) * 20 - 6).astype(np.float32)
    want = lookup_corr_pallas(pad_pyramid(pyr, radius), jnp.asarray(coords), radius,
                              q_block=16, interpret=True)
    got = _staged_lookup([torch.from_numpy(np.array(p)) for p in pyr], torch.from_numpy(coords),
                         radius)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("entry", ["attention", "attention_bnhd"])
def test_attention_gradient_matches_resident_attention_vjp(entry):
    """The attention Function's input gradients (forward the wrapper's call,
    backward autograd of the plain version) against ``jax.grad`` of
    ``resident_attention`` in interpret mode, whose VJP replays the JAX
    ``_reference``. [2,64,16] float32, 1e-5: fp32 softmax on both sides."""
    from mgldvsr_tpu.ops.pallas.attention import resident_attention

    rs = np.random.RandomState(11)
    q, k, v, g = (rs.randn(2, 64, 16).astype(np.float32) for _ in range(4))
    want = jax.grad(lambda *a: jnp.sum(resident_attention(*a, 128, True) * g),
                    argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    if entry == "attention":
        out = attention(*leaves)
        assert "_Attention" in type(out.grad_fn).__name__
        (out * torch.from_numpy(g)).sum().backward()
    else:  # the same heads as [B=1, N, H=2, D]
        out = attention_bnhd(*(z.transpose(0, 1)[None] for z in leaves))
        assert "_AttentionBNHD" in type(out.grad_fn).__name__
        (out[0].transpose(0, 1) * torch.from_numpy(g)).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


def _guidance_inputs(b, t, h, w, c, seed=0, occluded=0.3, flow_px=1.5):
    """latents [b*t,h,w,c], flows (forward, backward) [b,t-1,h,w,2] of about
    ``flow_px`` pixels, occlusions [b,t-1,h,w,1] with that share set."""
    rs = np.random.RandomState(seed)
    lat = torch.from_numpy(rs.randn(b * t, h, w, c).astype(np.float32))
    flows = tuple(torch.from_numpy((rs.randn(b, t - 1, h, w, 2) * flow_px).astype(np.float32))
                  for _ in range(2))
    occs = tuple(torch.from_numpy((rs.rand(b, t - 1, h, w, 1) < occluded).astype(np.float32))
                 for _ in range(2))
    return lat, flows, occs


# (frame, kind, occ, src, flow, slot), written out from the loss's two loops:
# kind 0 is the backward term (fwd_occs, flow_bwd), kind 1 the forward one
_TERMS = {
    ("reference", 2): [(0, 0, 0, -1, -1, -1), (1, 1, 0, -1, -1, -1)],
    ("reference", 3): [(0, 0, 0, 1, 1, 0), (1, 0, 1, -1, -1, -1), (1, 1, 0, -1, -1, -1),
                       (2, 1, 1, 1, 0, 1)],
    ("reference", 4): [(0, 0, 0, 1, 1, 0), (1, 0, 1, 2, 2, 1), (1, 1, 0, -1, -1, -1),
                       (2, 0, 2, -1, -1, -1), (2, 1, 1, 1, 0, 2), (3, 1, 2, 2, 1, 3)],
    ("reference", 5): [(0, 0, 0, 1, 1, 0), (1, 0, 1, 2, 2, 1), (1, 1, 0, -1, -1, -1),
                       (2, 0, 2, 3, 3, 2), (2, 1, 1, 1, 0, 3), (3, 0, 3, -1, -1, -1),
                       (3, 1, 2, 2, 1, 4), (4, 1, 3, 3, 2, 5)],
    ("aligned", 2): [(0, 0, 0, 1, 0, 0), (1, 1, 0, 0, 0, 1)],
    ("aligned", 3): [(0, 0, 0, 1, 0, 0), (1, 0, 1, 2, 1, 1), (1, 1, 0, 0, 0, 2),
                     (2, 1, 1, 1, 1, 3)],
    ("aligned", 4): [(0, 0, 0, 1, 0, 0), (1, 0, 1, 2, 1, 1), (1, 1, 0, 0, 0, 2),
                     (2, 0, 2, 3, 2, 3), (2, 1, 1, 1, 1, 4), (3, 1, 2, 2, 2, 5)],
    ("aligned", 5): [(0, 0, 0, 1, 0, 0), (1, 0, 1, 2, 1, 1), (1, 1, 0, 0, 0, 2),
                     (2, 0, 2, 3, 2, 3), (2, 1, 1, 1, 1, 4), (3, 0, 3, 4, 3, 5),
                     (3, 1, 2, 2, 2, 6), (4, 1, 3, 3, 3, 7)],
}


@pytest.mark.parametrize("mode,t", sorted(_TERMS))
def test_guidance_term_table_matches_the_loss(mode, t):
    """The term table against one written out by hand from the loss, and its
    packed form (what the kernels read) against the table."""
    terms = guide_mod.guidance_terms(t, mode)
    assert [tuple(term) for term in terms] == _TERMS[mode, t]
    assert guide_mod.warp_slots(t, mode) == 2 * (t - 2 if mode == "reference" else t - 1)
    frames, flat = guide_mod.MAX_FRAMES, list(guide_mod._kernel_table(t, mode))
    assert len(flat) == frames * 8 + 2 * frames * 3
    per_term = np.array(flat[:frames * 8]).reshape(frames, 2, 4)
    per_slot = np.array(flat[frames * 8:]).reshape(2 * frames, 3)
    for k in range(frames):
        for kind in range(2):
            hit = [x for x in terms if (x.frame, x.kind) == (k, kind)]
            want = [hit[0].occ, hit[0].src, hit[0].flow, hit[0].slot] if hit else [-1] * 4
            assert per_term[k, kind].tolist() == want
    for x in terms:
        if x.slot >= 0:
            assert per_slot[x.slot].tolist() == [x.src, x.kind, x.flow]


def _fixed_point_taps(g, flow, scale):
    """Launch B's contribution of one slot: each of the 4 weighted taps of
    the cotangent ``g`` [n,h,w,c] (the float product g·weight, the weights
    formed as the kernel forms them) scaled by ``scale`` and rounded to an
    integer, summed per target pixel exactly, int64 [n,h,w,c]."""
    from mgldvsr_tpu_torch.ops.warp import bilinear_taps

    n, h, w, c = g.shape
    x0, y0, tx, ty = bilinear_taps(flow)
    ux, uy = 1.0 - tx, 1.0 - ty
    batch = torch.arange(n)[:, None, None] * (h * w)
    out = torch.zeros(n * h * w, c, dtype=torch.int64)
    for yy, xx, wt in ((y0, x0, ux * uy), (y0, x0 + 1, tx * uy), (y0 + 1, x0, ux * ty),
                       (y0 + 1, x0 + 1, tx * ty)):
        q = torch.round((g * wt[..., None]).double() * scale).long()
        ok = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        out.index_add_(0, (batch + yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1))[ok], q[ok])
    return out.reshape(n, h, w, c)


def _emulate_guidance_kernels(lat, flows, occs, t, mode, slot_order=None):
    """Launches A and B as ``csrc/guidance.cu`` runs them, driven by the
    packed table the kernels read: A walks each frame's two table entries,
    gathers the warped neighbour, stores the direct part -(1/N sgn(r)) m and
    writes the cotangent of each warp to its slot; B adds the 4-tap transpose
    of every slot (in ``slot_order``) into a fixed-point accumulator of its
    source frame, then the finishing kernel adds it to the direct part in
    double and rounds once. Returns (gradient, direct part, cotangent)."""
    frames, flat = guide_mod.MAX_FRAMES, list(guide_mod._kernel_table(t, mode))
    per_term = np.array(flat[:frames * 8]).reshape(frames, 2, 4)
    per_slot = np.array(flat[frames * 8:]).reshape(2 * frames, 3)
    slots = guide_mod.warp_slots(t, mode)
    bt, h, w, c = lat.shape
    b = bt // t
    lat5 = lat.reshape(b, t, h, w, c)
    inv_n = guide_mod._inv_n(b * h * w * c)
    grad = torch.full_like(lat5, float("nan"))
    cot = torch.full((b, slots, h, w, c), float("nan"))
    occ_of = {0: occs[0], 1: occs[1]}    # the backward term's mask is fwd_occs
    flow_of = {0: flows[1], 1: flows[0]}  # and its warp the backward flow
    for k in range(t):  # launch A
        direct = torch.zeros(b, h, w, c)
        for kind in range(2):
            occ, src, flow, slot = per_term[k, kind].tolist()
            if occ < 0:
                continue
            m = 1.0 - occ_of[kind][:, occ]
            prev = (warp_plain(lat5[:, src], flow_of[kind][:, flow]) if src >= 0
                    else torch.zeros(b, h, w, c))
            ct = inv_n * torch.sgn(m * prev - m * lat5[:, k]) * m
            direct = direct - ct
            if src >= 0:
                cot[:, slot] = ct
        grad[:, k] = direct
    direct_part = grad.clone()
    scale = guide_mod._fixed_scale(b * h * w * c)
    acc = torch.zeros(b, t, h, w, c, dtype=torch.int64)
    for slot in (range(slots) if slot_order is None else slot_order):  # launch B
        src, kind, flow = per_slot[slot].tolist()
        acc[:, src] += _fixed_point_taps(cot[:, slot], flow_of[kind][:, flow], scale)
    grad = (direct_part.double() + acc.double() / scale).float()
    return grad.reshape(lat.shape), direct_part.reshape(lat.shape), cot


@pytest.mark.parametrize("mode", ["reference", "aligned"])
@pytest.mark.parametrize("b,t,c,case", [(1, 5, 4, "random"), (2, 3, 4, "random"),
                                        (2, 2, 4, "random"), (1, 5, 3, "random"),
                                        (1, 5, 4, "all occluded"), (1, 5, 4, "none occluded"),
                                        (1, 4, 4, "flows outside"), (1, 1, 4, "one frame")])
def test_guidance_kernel_emulation_matches_plain(mode, b, t, c, case):
    """The two launches emulated from the packed table against
    ``guidance_grad_plain`` (autograd of the loss), float32, 1e-6 of max |want|
    (the transposed taps are summed in fixed point, the plain version sums
    floats in another order), and so is the plain version of launch B; the
    emulated direct part and cotangent equal the launches' plain versions
    bit for bit, and launch B's sum does not depend on the order of its
    slots."""
    occluded = {"all occluded": 1.0, "none occluded": 0.0}.get(case, 0.3)
    lat, flows, occs = _guidance_inputs(b, t, 6, 7, c, seed=b * 10 + t + c, occluded=occluded,
                                        flow_px=40.0 if case == "flows outside" else 1.5)
    got, direct, cot = _emulate_guidance_kernels(lat, flows, occs, t, mode)
    want = guide_mod.guidance_grad_plain(lat, flows, occs, t, mode)
    tol = 1e-6 * float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol, rtol=0)
    plain_direct, plain_cot = guide_mod.guidance_residual_plain(lat, flows, occs, t, mode)
    assert torch.equal(direct, plain_direct) and torch.equal(cot, plain_cot)
    np.testing.assert_allclose(
        guide_mod.guidance_scatter_plain(plain_direct, plain_cot, flows, t, mode).numpy(),
        got.numpy(), atol=tol, rtol=0)
    reordered = _emulate_guidance_kernels(lat, flows, occs, t, mode,
                                          slot_order=range(guide_mod.warp_slots(t, mode))[::-1])
    assert torch.equal(reordered[0], got)
    scaled = guide_mod._inv_n(lat.numel()) * guide_mod._fixed_scale(lat.numel())
    assert 2 ** 31 <= scaled < 2 ** 32
    if case == "all occluded" or t == 1:
        assert not want.any()
    else:
        assert want.abs().max() > 0


@pytest.mark.parametrize("shape,t,mode", [((32, 3000, 3000, 4), 32, "aligned"),
                                          ((32, 5900, 5900, 1), 32, "reference"),
                                          ((1, 46341, 46341, 1), 1, "reference")])
def test_guidance_refuses_tensors_past_32_bit_offsets(shape, t, mode):
    """Latents whose cotangent scratch (t = 32 aligned: 62 warps), flows
    (c = 1) or selves reach 2^31 elements are refused before any launch:
    the kernels' offsets are 32-bit. Shapes only (meta tensors)."""
    lat = torch.empty(shape, device="meta")
    b, h, w = shape[0] // t, shape[1], shape[2]
    flows = tuple(torch.empty(b, t - 1, h, w, 2, device="meta") for _ in range(2))
    occs = tuple(torch.empty(b, t - 1, h, w, 1, device="meta") for _ in range(2))
    with pytest.raises(ValueError, match="32 bits"):
        guide_mod.guidance_grad(lat, flows, occs, t, mode)


def test_guidance_layout_is_dense_with_frames_outermost():
    """The kernels take latents packed NHWC or as NHWC views of NCHW memory,
    and lay each slot of the cotangent scratch out as a frame of them; a
    sliced tensor or one with frames inside is refused."""
    planar = torch.empty(5, 4, 6, 7).permute(0, 2, 3, 1)
    for ok in (planar, torch.empty(5, 6, 7, 4)):
        guide_mod._layout("guidance_grad", ok)
    for bad in (torch.empty(5, 6, 7, 8)[..., :4], torch.empty(6, 5, 7, 4).transpose(0, 1)):
        with pytest.raises(ValueError, match="frames outermost"):
            guide_mod._layout("guidance_grad", bad)
    assert guide_mod._scratch_strides(planar, 6) == (6 * 168, 168, 7, 1, 42)
