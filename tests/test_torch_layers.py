"""Port building blocks against the JAX package on the CPU: both GroupNorm
semantics (flax float32, and the one-pass bf16 form with its channel-sums
branch at H*W >= 16384), the MGLD_GN_FP32 knob, and the attention gate and
dispatch.

Tolerances: float32 paths 1e-5. The bf16 GroupNorm rounds its input and
its folded scale and shift to bf16 on both sides, then computes x*a+b in
bf16; outputs of unit scale agree to a few bf16 ulps (3e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgldvsr_tpu_torch.models.layers import GroupNorm
from mgldvsr_tpu_torch.ops import kernels


def _gn_params(c, seed):
    rs = np.random.RandomState(seed)
    return rs.randn(c).astype(np.float32), rs.randn(c).astype(np.float32)


def _port_gn(c, eps, dtype, scale, bias):
    gn = GroupNorm(c, eps=eps, dtype=dtype)
    gn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    return gn


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_group_norm_fp32_matches_flax(eps):
    import flax.linen as nn

    x = (np.random.RandomState(0).randn(2, 6, 7, 64) * 3 + 1).astype(np.float32)
    scale, bias = _gn_params(64, 1)
    want = nn.GroupNorm(num_groups=32, epsilon=eps).apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    got = _port_gn(64, eps, torch.float32, scale, bias)(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("hw", [(6, 5), (128, 128)])
def test_group_norm_bf16_matches_jax_lean_form(hw):
    """(128, 128) takes the channel-sums kernel's branch (its plain version
    on the CPU) in the port and the jnp sums in JAX."""
    from mgldvsr_tpu.models.layers import GroupNorm as JaxGroupNorm

    h, w = hw
    x = (np.random.RandomState(2).randn(2, h, w, 64) * 2 + 0.5).astype(np.float32)
    scale, bias = _gn_params(64, 3)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = JaxGroupNorm(num_groups=32, epsilon=1e-6, dtype=jnp.bfloat16).apply(
        {"params": {"scale": scale, "bias": bias}}, xb)
    xt = torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16).permute(0, 3, 1, 2)
    kernels.reset_launch_counts()
    got = _port_gn(64, 1e-6, torch.bfloat16, scale, bias)(xt.contiguous())
    assert got.dtype == torch.bfloat16
    assert kernels.launch_counts()["channel_sums"] == 0  # CPU: plain version
    np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want, np.float32), atol=3e-2, rtol=1e-2)


def test_gn_fp32_knob_forces_flax_semantics(monkeypatch):
    scale, bias = _gn_params(32, 4)
    x = torch.randn(2, 32, 5, 5, generator=torch.Generator().manual_seed(0))
    monkeypatch.setenv("MGLD_GN_FP32", "1")
    forced = _port_gn(32, 1e-5, torch.bfloat16, scale, bias)
    monkeypatch.delenv("MGLD_GN_FP32")
    lean = _port_gn(32, 1e-5, torch.bfloat16, scale, bias)
    ref = _port_gn(32, 1e-5, torch.float32, scale, bias)
    assert forced.dtype == torch.float32 and lean.dtype == torch.bfloat16
    assert torch.equal(forced(x.to(torch.bfloat16)), ref(x.to(torch.bfloat16)))
    assert lean(x).dtype == torch.bfloat16


@pytest.mark.parametrize("n,d,itemsize", [(4096, 64, 2), (1024, 64, 2), (4096, 512, 2),
                                          (1024, 64, 4), (1000, 16, 4), (4096, 512, 4)])
def test_attention_gate_matches_jax(n, d, itemsize):
    from mgldvsr_tpu.ops.pallas.attention import pick_block_q as jax_pick
    from mgldvsr_tpu_torch.ops.kernels.attention import pick_block_q

    assert pick_block_q(n, d, itemsize) == jax_pick(n, d, itemsize)


@pytest.mark.parametrize("n,m,heads,d", [(1024, 1024, 2, 16), (64, 77, 2, 16), (1030, 1030, 1, 8)])
def test_attend_matches_jax(n, m, heads, d):
    """Gated self-attention (through the kernel wrapper, plain on the CPU)
    and ungated cross-attention against the JAX dispatch, float32."""
    from mgldvsr_tpu.ops.attention import attend as jax_attend
    from mgldvsr_tpu_torch.ops.attention import attend

    rs = np.random.RandomState(n + m)
    q = rs.randn(2, n, heads, d).astype(np.float32)
    k, v = (rs.randn(2, m, heads, d).astype(np.float32) for _ in range(2))
    want = jax.jit(jax_attend)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = attend(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
