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
from mgldvsr_tpu_torch.ops.kernels.attention import attention, attention_plain
from mgldvsr_tpu_torch.ops.kernels.corr_lookup import lookup_corr, lookup_corr_plain
from mgldvsr_tpu_torch.ops.kernels.flow_warp import (
    flow_warp_guided,
    warp_dx,
    warp_dx_plain,
    warp_forward,
    warp_plain,
)
from mgldvsr_tpu_torch.ops.kernels.groupnorm import channel_sums, channel_sums_plain


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
    rtol 1e-5 covers the summation order."""
    from mgldvsr_tpu.ops.pallas.groupnorm import channel_sums as jax_sums

    rs = np.random.RandomState(0)
    x = jnp.asarray(rs.randn(2, 12, 8, 32) * 3 + 1, jnp.bfloat16)  # NHWC
    s1, s2 = jax_sums(x, interpret=True)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).permute(0, 3, 1, 2)
    g1, g2 = channel_sums_plain(xt.contiguous())
    np.testing.assert_allclose(g1.numpy(), np.asarray(s1), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(g2.numpy(), np.asarray(s2), rtol=1e-5, atol=1e-3)


def test_wrappers_take_the_plain_path_on_cpu():
    """A CPU tensor goes to the plain version; no launch is counted."""
    kernels.reset_launch_counts()
    x, flow, g = (torch.from_numpy(a) for a in _warp_inputs(seed=3))
    assert torch.equal(warp_forward(x, flow), warp_plain(x, flow))
    assert torch.equal(warp_dx(g, flow), warp_dx_plain(g, flow))
    q = torch.randn(2, 64, 16, generator=torch.Generator().manual_seed(0))
    assert torch.equal(attention(q, q, q), attention_plain(q, q, q))
    pyr = [torch.randn(1, 16, 4, 4), torch.randn(1, 16, 2, 2)]
    coords = torch.rand(1, 4, 4, 2) * 4
    assert torch.equal(lookup_corr(pyr, coords, 2), lookup_corr_plain(pyr, coords, 2))
    xb = torch.randn(2, 8, 16, 16).to(torch.bfloat16)
    for a, b in zip(channel_sums(xb), channel_sums_plain(xb)):
        assert torch.equal(a, b)
    assert kernels.launch_counts() == {name: 0 for name in kernels.WRAPPERS}

