"""The heritage slice's ops against the JAX package, on the CPU, float32:
the modulated deformable conv, MaskFlownet's correlation and triangle
resampling, StyleGAN2's upfirdn2d, and the single pieces most likely to be
off by a flip, a crop or a sign (MaskFlownet's transposed conv, StyleGAN2's
upsampling modulated conv, the spectral conv's power step, SwinIR's shifted
windows), each at odd H and W where the shape allows. Limits: 1e-5 for the
ops, 2e-5 of max |output| for the pieces with weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgldvsr_tpu.flow import maskflownet as jmf
from mgldvsr_tpu.ops import dcn as jdcn
from mgldvsr_tpu.ops import stylegan_ops as jsg
from mgldvsr_tpu_torch.flow import maskflownet as pmf
from mgldvsr_tpu_torch.ops import dcn as pdcn
from mgldvsr_tpu_torch.ops import stylegan_ops as psg

torch.set_num_threads(1)


def drawn(module, seed, *args, **kwargs):
    """Parameters of the shapes ``module.init`` gives (traced, not
    compiled): kernels N(0, 1/fan_in), LayerNorm scales about 1, every other
    leaf 0.05 N(0, 1) (a ``spectral`` u: N(0, 1); a batch norm's var in
    [1, 1.1])."""
    shapes = jax.eval_shape(lambda k: module.init(k, *args, **kwargs), jax.random.PRNGKey(0))
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        name = getattr(path[-1], "key", None)
        if name == "scale":
            return (1 + 0.05 * rs.randn(*s.shape)).astype(np.float32)
        if name == "u":
            return rs.randn(*s.shape).astype(np.float32)
        if name == "var":
            return (1 + 0.1 * rs.rand(*s.shape)).astype(np.float32)
        if len(s.shape) >= 2:
            return (rs.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return np.asarray(0.05 * rs.randn(*s.shape), np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), atol=atol, rtol=0)


def rel_close(got, want, rel=2e-5):
    want = np.asarray(want)
    close(got, want, rel * max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("groups,with_mask,dilation", [(1, False, 1), (2, True, 1), (3, True, 2)])
def test_modulated_deform_conv_matches_jax(groups, with_mask, dilation):
    rs = np.random.RandomState(groups)
    n, h, w, cin, cout, k = 2, 7, 9, 6, 5, 9
    x = rs.randn(n, h, w, cin).astype(np.float32)
    offset = (3.0 * rs.randn(n, h, w, 2 * groups * k)).astype(np.float32)  # taps fall outside
    mask = rs.rand(n, h, w, groups * k).astype(np.float32) if with_mask else None
    weight = (rs.randn(3, 3, cin, cout) / 6).astype(np.float32)
    bias = rs.randn(cout).astype(np.float32)
    want = jdcn.modulated_deform_conv2d(
        jnp.asarray(x), jnp.asarray(offset), None if mask is None else jnp.asarray(mask),
        jnp.asarray(weight), jnp.asarray(bias), padding=dilation, dilation=dilation,
        deform_groups=groups)
    got = pdcn.modulated_deform_conv2d(
        torch.from_numpy(x), torch.from_numpy(offset),
        None if mask is None else torch.from_numpy(mask),
        torch.from_numpy(weight.transpose(3, 2, 0, 1).copy()), torch.from_numpy(bias),
        padding=dilation, dilation=dilation, deform_groups=groups)
    close(got, want, 1e-5)


def test_dcnv2_pack_interleaves_like_jax():
    rs = np.random.RandomState(5)
    x = rs.randn(1, 7, 5, 8).astype(np.float32)
    feat = rs.randn(1, 7, 5, 8).astype(np.float32)
    params = {"conv_offset": {"kernel": (rs.randn(3, 3, 8, 3 * 2 * 9) / 8).astype(np.float32),
                              "bias": (0.5 * rs.randn(54)).astype(np.float32)},
              "weight": (rs.randn(3, 3, 8, 4) / 8).astype(np.float32),
              "bias": rs.randn(4).astype(np.float32)}
    want = jdcn.DCNv2Pack.apply(params, jnp.asarray(x), jnp.asarray(feat), deform_groups=2)
    pack = pdcn.DCNv2Pack(8, 4, deform_groups=2)
    with torch.no_grad():
        pack.weight.copy_(torch.from_numpy(params["weight"].transpose(3, 2, 0, 1).copy()))
        pack.bias.copy_(torch.from_numpy(params["bias"]))
        pack.conv_offset.weight.copy_(torch.from_numpy(
            params["conv_offset"]["kernel"].transpose(3, 2, 0, 1).copy()))
        pack.conv_offset.bias.copy_(torch.from_numpy(params["conv_offset"]["bias"]))
        got = pack(torch.from_numpy(x), torch.from_numpy(feat))
    close(got, want, 1e-5)


@pytest.mark.parametrize("md", [1, 4])
def test_local_correlation_matches_jax(md):
    rs = np.random.RandomState(md)
    f1, f2 = (rs.randn(2, 7, 9, 5).astype(np.float32) for _ in range(2))
    want = jmf.local_correlation(jnp.asarray(f1), jnp.asarray(f2), md)
    close(pmf.local_correlation(torch.from_numpy(f1), torch.from_numpy(f2), md), want, 1e-5)


@pytest.mark.parametrize("factor", [2, 4])
def test_triangle_resampling_matches_jax_at_odd_sizes(factor):
    rs = np.random.RandomState(factor)
    x = rs.randn(2, 7, 9, 3).astype(np.float32)
    close(pmf.upsample2d(torch.from_numpy(x), factor), jmf.upsample2d(jnp.asarray(x), factor),
          1e-5)
    y = rs.randn(2, 13, 11, 3).astype(np.float32)
    close(pmf.downsample2d(torch.from_numpy(y), factor),
          jmf.downsample2d(jnp.asarray(y), factor), 1e-5)


def test_centralize_matches_jax():
    rs = np.random.RandomState(3)
    a, b = (rs.rand(2, 5, 7, 3).astype(np.float32) for _ in range(2))
    got = pmf.centralize(torch.from_numpy(a), torch.from_numpy(b))
    want = jmf.centralize(jnp.asarray(a), jnp.asarray(b))
    for g, w in zip(got, want):
        close(g, w, 1e-6)


@pytest.mark.parametrize("up,down,pad", [(2, 1, (2, 1)), (1, 2, (1, 1)), (1, 1, (2, 2)),
                                         (2, 1, (-1, 2)), (1, 2, (0, -1))])
def test_upfirdn2d_matches_jax(up, down, pad):
    rs = np.random.RandomState(up * 10 + down)
    x = rs.randn(2, 7, 9, 4).astype(np.float32)
    k = rs.rand(4, 4).astype(np.float32)  # not symmetric: the flip shows
    want = jsg.upfirdn2d(jnp.asarray(x), jnp.asarray(k), up, down, pad)
    close(psg.upfirdn2d(torch.from_numpy(x), torch.from_numpy(k), up, down, pad), want, 1e-5)


def test_fused_act_and_resample_helpers_match_jax():
    rs = np.random.RandomState(8)
    x = rs.randn(2, 7, 9, 4).astype(np.float32)
    b = rs.randn(4).astype(np.float32)
    close(psg.fused_leaky_relu(torch.from_numpy(x), torch.from_numpy(b)),
          jsg.fused_leaky_relu(jnp.asarray(x), jnp.asarray(b)), 1e-6)
    np.testing.assert_array_equal(psg.make_resample_kernel([1, 3, 3, 1]),
                                  jsg.make_resample_kernel([1, 3, 3, 1]))
    k = psg.make_resample_kernel([1, 3, 3, 1])
    close(psg.upsample2x(torch.from_numpy(x), torch.from_numpy(k)),
          jsg.upsample2x(jnp.asarray(x), jnp.asarray(k)), 1e-5)
    close(psg.downsample2x(torch.from_numpy(x), torch.from_numpy(k)),
          jsg.downsample2x(jnp.asarray(x), jnp.asarray(k)), 1e-5)


def test_maskflownet_deconv_alone_matches_jax():
    """flax ConvTranspose(4, 2, SAME, transpose_kernel=False) with the
    flipped kernel the converter writes against torch's ConvTranspose2d(4,
    2, 1) with upstream's weight, on an odd-sized input."""
    from mgldvsr_tpu.io.ckpt_convert import deconv_kernel

    rs = np.random.RandomState(9)
    x = rs.randn(2, 5, 7, 6).astype(np.float32)
    w_torch = (rs.randn(6, 4, 4, 4) / 6).astype(np.float32)  # [in, out, kh, kw]
    bias = rs.randn(4).astype(np.float32)
    mod = jmf._Deconv(4)
    want = mod.apply({"params": {"deconv": {"kernel": deconv_kernel(w_torch), "bias": bias}}},
                     jnp.asarray(x))
    deconv = torch.nn.ConvTranspose2d(6, 4, 4, 2, 1)
    with torch.no_grad():
        deconv.weight.copy_(torch.from_numpy(w_torch))
        deconv.bias.copy_(torch.from_numpy(bias))
        got = deconv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 10, 14, 4)
    close(got, want, 1e-5)


@pytest.mark.parametrize("mode", ["upsample", "downsample", None])
def test_stylegan_modulated_conv_alone_matches_jax(mode):
    from mgldvsr_tpu.models.heritage import stylegan2 as jsg2
    from mgldvsr_tpu_torch.models.heritage import stylegan2 as psg2

    rs = np.random.RandomState(11)
    x = rs.randn(2, 7, 9, 6).astype(np.float32)
    style = rs.randn(2, 16).astype(np.float32)
    jmod = jsg2.ModulatedConv2d(5, sample_mode=mode)
    params = drawn(jmod, 12, jnp.asarray(x), jnp.asarray(style))
    want = jmod.apply(params, jnp.asarray(x), jnp.asarray(style))
    p = params["params"]
    mod = psg2.ModulatedConv2d(6, 5, 3, 16, sample_mode=mode)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(np.asarray(p["weight"]).transpose(3, 2, 0, 1)[None]))
        mod.modulation.weight.copy_(torch.from_numpy(np.asarray(p["modulation"]["weight"]).T))
        mod.modulation.bias.copy_(torch.from_numpy(np.asarray(p["modulation"]["bias"])))
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(style))
    rel_close(got.permute(0, 2, 3, 1), want)


def test_spectral_conv_power_step_matches_jax():
    """One power-iteration step from the stored u on every call, u stored
    back only under update_sv (not torch's eval-mode spectral norm)."""
    from mgldvsr_tpu.models.heritage import sr_archs as jsr
    from mgldvsr_tpu_torch.models.heritage import sr_archs as psr

    rs = np.random.RandomState(13)
    x = rs.randn(1, 9, 7, 4).astype(np.float32)
    jmod = jsr.SpectralConv(6, 4, 2)
    variables = drawn(jmod, 14, jnp.asarray(x))
    want, new_vars = jmod.apply(variables, jnp.asarray(x), update_sv=True, mutable=["spectral"])
    mod = psr.SpectralConv(4, 6, 4, 2)
    with torch.no_grad():
        mod.weight_orig.copy_(torch.from_numpy(
            np.asarray(variables["params"]["kernel"]).transpose(3, 2, 0, 1).copy()))
        mod.bias.copy_(torch.from_numpy(np.asarray(variables["params"]["bias"])))
        mod.weight_u.copy_(torch.from_numpy(np.asarray(variables["spectral"]["u"])))
        frozen = mod(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert torch.equal(mod.weight_u, torch.from_numpy(np.asarray(variables["spectral"]["u"])))
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2), update_sv=True)
    rel_close(got.permute(0, 2, 3, 1), want)
    torch.testing.assert_close(frozen, got, rtol=0, atol=0)
    close(mod.weight_u, new_vars["spectral"]["u"], 1e-6)


def test_swin_shifted_block_matches_jax():
    """A shifted Swin block alone (the roll's sign and the per-size mask),
    on a 16 x 24 image with 8-pixel windows."""
    from mgldvsr_tpu.models.heritage import swinir as jsw
    from mgldvsr_tpu_torch.models.heritage import swinir as psw

    np.testing.assert_array_equal(psw.shift_attn_mask(16, 24, 8, 4),
                                  jsw.shift_attn_mask(16, 24, 8, 4))
    np.testing.assert_array_equal(psw.relative_position_index(8),
                                  jsw.relative_position_index(8))
    rs = np.random.RandomState(15)
    x = rs.randn(2, 16, 24, 12).astype(np.float32)
    jblk = jsw.SwinBlock(12, 3, 8, shift_size=4)
    p = drawn(jblk, 16, jnp.asarray(x))
    want = jblk.apply(p, jnp.asarray(x))
    blk = psw.SwinBlock(12, 3, 8, shift_size=4)
    q = p["params"]
    sd = {"norm1.weight": q["norm1"]["scale"], "norm1.bias": q["norm1"]["bias"],
          "norm2.weight": q["norm2"]["scale"], "norm2.bias": q["norm2"]["bias"],
          "attn.relative_position_bias_table": q["attn"]["relative_position_bias_table"]}
    for key, node in (("attn.qkv", q["attn"]["qkv"]), ("attn.proj", q["attn"]["proj"]),
                      ("mlp.fc1", q["mlp_fc1"]), ("mlp.fc2", q["mlp_fc2"])):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = np.asarray(node["kernel"]).T, node["bias"]
    blk.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})
    with torch.no_grad():
        got = blk(torch.from_numpy(x))
    rel_close(got, want)
    z = torch.randn(2, 16, 24, 5)
    assert torch.equal(psw.window_reverse(psw.window_partition(z, 8), 8, 16, 24), z)
