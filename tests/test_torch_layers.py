"""Port building blocks against the JAX package on the CPU: both GroupNorm
semantics (flax float32, and the one-pass bf16 form with its channel-sums
branch at H*W >= 16384), the MGLD_GN_FP32 knob, the attention gate and
dispatch, and the MGLD_FUSED_GN_CONV switch (the res blocks with the switch
on against the JAX blocks with it on, float32, 1e-4 as the towers' tests).

Tolerances: float32 paths 1e-5. The bf16 GroupNorm rounds its input and
its folded scale and shift to bf16 on both sides, then computes x*a+b in
bf16; outputs of unit scale agree to a few bf16 ulps (3e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgldvsr_tpu_torch.io import from_jax
from mgldvsr_tpu_torch.models import layers
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


@pytest.mark.parametrize("n,d,itemsize,want", [(1024, 512, 4, True), (1024, 512, 2, True),
                                               (2304, 512, 2, True), (3249, 512, 2, True),
                                               (3364, 512, 2, False), (2116, 512, 4, False),
                                               (4096, 512, 2, False), (1024, 64, 2, True),
                                               (4096, 64, 2, True), (1024, 16, 4, True),
                                               (1000, 64, 2, False)])
def test_attention_gate_passes_the_vae_mid_attention(n, d, itemsize, want):
    """The port's gate is the JAX package's: self-attention with N >= 1024
    that ``pick_block_q`` passes. So the VAE's d=512 mid attention at 32^2
    to 57^2 latents in bf16 (to 45^2 in float32) goes to the kernel, as it
    goes to the TPU kernel; 58^2 and 64^2 (512 px frames) do not."""
    from mgldvsr_tpu.ops.pallas.attention import pick_block_q as jax_pick
    from mgldvsr_tpu_torch.ops.attention import gated
    from mgldvsr_tpu_torch.ops.kernels.attention import SUPPORTED_HEAD_DIMS

    assert gated(n, n, d, itemsize) == want == (n >= 1024 and jax_pick(n, d, itemsize) > 0)
    assert d in SUPPORTED_HEAD_DIMS
    assert not gated(n, 77, d, itemsize)


@pytest.mark.parametrize("n,m,heads,d", [(1024, 1024, 2, 16), (64, 77, 2, 16), (1030, 1030, 1, 8),
                                         (1024, 1024, 1, 512)])
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


def _cross_attention_views(rs, b, n, heads, d, dtype):
    """q, k, v as the UNet's ``CrossAttention`` could hand them over: head
    views of [B, N, H*D] rows, here rows of one wider [B, N, 3*H*D] tensor,
    so no view is contiguous but each has unit stride in D."""
    fused = torch.from_numpy(rs.randn(b, n, 3 * heads * d).astype(np.float32)).to(dtype)
    return [z.reshape(b, n, heads, d) for z in fused.chunk(3, dim=-1)]


def _qkv_block_views(rs, b, n, heads, d, dtype):
    """q, k, v as ``QKVAttentionBlock`` hands them over: [B, 3C, T] conv
    output, head-interleaved, permuted to [B, T, H, d] with stride T in d."""
    qkv = torch.from_numpy(rs.randn(b, 3 * heads * d, n).astype(np.float32)).to(dtype)
    return list(qkv.reshape(b, heads, 3, d, n).permute(2, 0, 4, 1, 3).unbind(0))


@pytest.mark.parametrize("dtype,d", [(torch.float32, 16), (torch.bfloat16, 64)])
@pytest.mark.parametrize("layout", [_cross_attention_views, _qkv_block_views])
def test_attend_on_strided_views(layout, dtype, d):
    """``attend`` on non-contiguous [B,N,H,D] views equals ``attend`` on
    contiguous copies exactly (the same plain arithmetic on the CPU, in both
    kernel variants' routes); float32 also equals the JAX ``attend``, 1e-5."""
    from mgldvsr_tpu.ops.attention import attend as jax_attend
    from mgldvsr_tpu_torch.ops.attention import attend

    q, k, v = layout(np.random.RandomState(d), 2, 1024, 2, d, dtype)
    assert not q.is_contiguous()
    got = attend(q, k, v)
    assert got.shape == q.shape
    assert torch.equal(got, attend(q.contiguous(), k.contiguous(), v.contiguous()))
    if dtype == torch.float32:
        want = jax.jit(jax_attend)(*(jnp.asarray(z.numpy()) for z in (q, k, v)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def _unet_views(b, n, heads, dtype):
    """Shapes and strides of a full-width ``CrossAttention`` self-attention
    call, without memory: three [B, N, H*64] projections viewed per head."""
    return [torch.empty(b, n, heads * 64, dtype=dtype, device="meta").reshape(b, n, heads, 64)
            for _ in range(3)]


def _structcond_views(b, n, heads, dtype):
    """The same for ``QKVAttentionBlock``: slices of its [B, 3C, T] conv."""
    qkv = torch.empty(b, 3 * heads * 64, n, dtype=dtype, device="meta")
    return list(qkv.reshape(b, heads, 3, 64, n).permute(2, 0, 4, 1, 3).unbind(0))


@pytest.mark.parametrize("views,n,heads,dtype,want", [
    (_unet_views, 4096, 5, torch.bfloat16, ("wgmma", True)),      # UNet 64^2, 320 channels
    (_unet_views, 1024, 10, torch.bfloat16, ("wgmma", True)),     # UNet 32^2, 640 channels
    (_structcond_views, 4096, 4, torch.bfloat16, ("wgmma", False)),   # struct-cond 64^2
    (_structcond_views, 1024, 4, torch.bfloat16, ("wgmma", False)),   # struct-cond 32^2
    (_unet_views, 4096, 5, torch.float32, ("fma", False)),        # the same in float32
    (_structcond_views, 1024, 4, torch.float32, ("fma", False)),
])
def test_attention_route_of_full_width_calls(views, n, heads, dtype, want):
    """Every gated call of the full-width UNet and struct-cond encoder (5
    frames): which kernel it takes and whether q, k, v are read in place."""
    from mgldvsr_tpu_torch.ops.kernels.attention import kernel_variant, pick_block_q, route

    for z in views(5, n, heads, dtype):
        assert z.shape == (5, n, heads, 64) and pick_block_q(n, 64, z.element_size())
        in_place = route(z.dtype, z.shape, z.stride(), z.storage_offset() * z.element_size())
        assert (kernel_variant(z.dtype, 64), in_place) == want


@pytest.mark.parametrize("dtype,d,strides,offset,want", [
    (torch.bfloat16, 64, (4096 * 320, 320, 64, 1), 0, ("wgmma", True)),
    (torch.bfloat16, 64, (4096 * 320, 320, 64, 1), 8, ("wgmma", False)),   # base off 16 bytes
    (torch.bfloat16, 64, (4096 * 324, 324, 64, 1), 0, ("wgmma", False)),   # rows off 16 bytes
    (torch.bfloat16, 64, (4096 * 320, 1, 64 * 4096, 4096), 0, ("wgmma", False)),  # stride in D
    (torch.bfloat16, 16, (4096 * 80, 80, 16, 1), 0, ("fma", False)),
    (torch.bfloat16, 128, (1024 * 512, 512, 128, 1), 0, ("fma", False)),
    (torch.float32, 64, (4096 * 320, 320, 64, 1), 0, ("fma", False)),
])
def test_attention_route_is_a_function_of_type_shape_and_strides(dtype, d, strides, offset, want):
    from mgldvsr_tpu_torch.ops.kernels.attention import kernel_variant, route

    assert (kernel_variant(dtype, d), route(dtype, (5, 4096, 5, d), strides, offset)) == want


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _blocks(name):
    """(JAX module, its call arguments in numpy, port module factory, the
    from_jax writer for its parameters)."""
    from mgldvsr_tpu.models.layers import VAEResnetBlock as JaxVAEResnet
    from mgldvsr_tpu.models.unet import DualResBlock as JaxDual
    from mgldvsr_tpu.models.vae import SimpleResBlock as JaxSimple
    from mgldvsr_tpu_torch.models.unet import DualResBlock
    from mgldvsr_tpu_torch.models.vae import SimpleResBlock

    rs = np.random.RandomState(7)
    x = rs.randn(2, 8, 6, 32).astype(np.float32)
    if name == "dual":
        args = (x, rs.randn(2, 16).astype(np.float32),
                {"6": rs.randn(2, 8, 6, 16).astype(np.float32)})
        return (JaxDual(64, 16, 16), args, lambda: DualResBlock(32, 64, 16, 16),
                lambda g, p: from_jax._resblock(g, p, dual=True))
    if name == "vae_resnet":
        return (JaxVAEResnet(64), (x,), lambda: layers.VAEResnetBlock(32, 64),
                from_jax._vae_resnet)
    return JaxSimple(64), (x,), lambda: SimpleResBlock(32, 64, torch.float32), \
        from_jax._simple_resblock


def _to_port(a):
    if isinstance(a, dict):
        return {k: _nchw(v) for k, v in a.items()}
    return _nchw(a) if a.ndim == 4 else torch.from_numpy(a)


@pytest.mark.parametrize("flag", ["0", "1"])
@pytest.mark.parametrize("name", ["dual", "vae_resnet", "simple"])
def test_res_blocks_match_jax_in_both_configurations(monkeypatch, name, flag):
    """MGLD_FUSED_GN_CONV on both sides: the JAX block reaches the Pallas
    kernel in interpret mode, the port the fused function's plain version.
    One JAX parameter tree, converted once, serves both settings."""
    jmod, args, make, write = _blocks(name)
    monkeypatch.setenv("MGLD_FUSED_GN_CONV", "0")
    params = jmod.init(jax.random.PRNGKey(3), *map(jnp.asarray, args)) if name != "dual" else \
        jmod.init(jax.random.PRNGKey(3), jnp.asarray(args[0]), jnp.asarray(args[1]),
                  {k: jnp.asarray(v) for k, v in args[2].items()})
    # zero-initialised convs would hide the second chain: randomise every leaf
    leaves, tree = jax.tree_util.tree_flatten(params)
    rs = np.random.RandomState(11)
    params = jax.tree_util.tree_unflatten(
        tree, [jnp.asarray(rs.randn(*l.shape).astype(np.float32) * 0.2 + (l.ndim == 1))
               for l in leaves])
    sd = {}
    write(from_jax._SD(sd), jax.tree_util.tree_map(np.asarray, params["params"]))
    port = make()
    port.load_state_dict(sd, strict=True)

    monkeypatch.setenv("MGLD_FUSED_GN_CONV", flag)
    jargs = [({k: jnp.asarray(v) for k, v in a.items()} if isinstance(a, dict)
              else jnp.asarray(a)) for a in args]
    want = jmod.apply(params, *jargs)
    with torch.no_grad():
        got = port(*map(_to_port, args))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    assert set(port.state_dict()) == set(sd)


@pytest.mark.parametrize("flag,on_cpu", [("0", False), ("1", True), ("true", True), ("ON", True),
                                         ("auto", False), ("2", False), (None, False)])
def test_fused_switch_values(monkeypatch, flag, on_cpu):
    """The JAX meaning: 1/true/on force it on, ``auto`` follows the device (off
    for a CPU tensor), anything else and the default are off; read at call
    time; 5-D inputs never fuse."""
    if flag is None:
        monkeypatch.delenv("MGLD_FUSED_GN_CONV", raising=False)
    else:
        monkeypatch.setenv("MGLD_FUSED_GN_CONV", flag)
    assert layers.fused_gn_conv_enabled(torch.zeros(1)) is on_cpu
    calls = []
    monkeypatch.setattr(layers, "gn_silu_conv3x3",
                        lambda x, *a: calls.append(x.ndim) or torch.zeros(1))
    norm, conv = GroupNorm(32), layers.conv3x3(32, 8)
    layers.norm_silu_conv(norm, conv, torch.randn(1, 32, 4, 4))
    assert calls == ([4] if on_cpu else [])


_CHAINS = {}


def _full_width_chains(dtype):
    """``tools/bench_fused_conv.chain_shapes``: every fused chain of the
    full-width towers (5 frames, 512px), listed once per dtype."""
    import importlib.util
    import pathlib

    if dtype not in _CHAINS:
        tool = pathlib.Path(__file__).resolve().parents[1] / "tools" / "bench_fused_conv.py"
        spec = importlib.util.spec_from_file_location("bench_fused_conv", tool)
        bench = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(bench)
        _CHAINS[dtype] = bench.chain_shapes(5, dtype)
        assert layers.norm_silu_conv.__name__ == "norm_silu_conv"  # the recorder is gone again
    return _CHAINS[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tower,total,few_channels,widths", [
    ("unet", 45, 1, {64, 32, 16, 8}), ("structcond", 28, 0, {64, 32, 16, 8}),
    ("vae", 58, 2, {512, 256, 128, 64})])
def test_fused_conv_kernel_of_full_width_chains(tower, total, few_channels, widths, dtype):
    """Every gated chain of the full-width UNet, struct-cond encoder and VAE,
    listed from the towers on the meta device: which conv kernel it takes. In
    bfloat16 all run on the tensor-core kernel but the few-channel output
    convs (the UNet's 4, the VAE's 8 and 3), which keep the ``mma.sync``
    tile; in float32 all take the FMA kernel."""
    from mgldvsr_tpu_torch.ops.kernels.gn_silu_conv import kernel_variant

    chains = _full_width_chains(dtype)[tower]
    variants = [kernel_variant(dt, co) for *_, co, dt in chains]
    assert len(chains) == total and all(dt == dtype for *_, dt in chains)
    assert {w for _, _, _, w, _, _ in chains} == widths
    if dtype == torch.float32:
        assert variants == ["fma"] * total
    else:
        assert variants.count("wgmma") == total - few_channels
        assert variants.count("mma") == few_channels
        assert all((co <= 8) == (v == "mma") for (*_, co, _), v in zip(chains, variants))
