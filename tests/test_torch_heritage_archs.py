"""Every BasicSR-heritage architecture against the JAX package on the CPU,
float32, at the JAX tests' tiny widths (odd H and W where the architecture
allows), each port module filled from the JAX module's parameters through
``io.from_jax`` with a plain ``load_state_dict``. Limit: 2e-5 of max
|output|. Each converter of ``mgldvsr_tpu/io/ckpt_convert.py`` that serves
these modules takes the port's state dict back to the JAX tree bit for bit,
consuming every key.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgldvsr_tpu.io import ckpt_convert as cc
from mgldvsr_tpu.models.heritage import face_archs as jfa
from mgldvsr_tpu.models.heritage import misc_archs as jmi
from mgldvsr_tpu.models.heritage import sr_archs as jsr
from mgldvsr_tpu.models.heritage import stylegan2 as jsg
from mgldvsr_tpu.models.heritage import swinir as jsw
from mgldvsr_tpu.models.heritage import video_archs as jva
from mgldvsr_tpu_torch.io import from_jax as fj
from mgldvsr_tpu_torch.models.heritage import face_archs as pfa
from mgldvsr_tpu_torch.models.heritage import misc_archs as pmi
from mgldvsr_tpu_torch.models.heritage import sr_archs as psr
from mgldvsr_tpu_torch.models.heritage import stylegan2 as psg
from mgldvsr_tpu_torch.models.heritage import swinir as psw
from mgldvsr_tpu_torch.models.heritage import video_archs as pva
from tests.test_torch_heritage_ops import drawn, rel_close
from tests.test_torch_maskflownet import _same_tree

torch.set_num_threads(1)


def _frames(seed, *shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _flows(seed, b, t, h, w):
    rs = np.random.RandomState(seed)
    return tuple((1.5 * rs.randn(b, t - 1, h, w, 2)).astype(np.float32) for _ in range(2))


def _to_torch(a):
    if isinstance(a, (list, tuple)):
        return type(a)(_to_torch(x) for x in a)
    return torch.from_numpy(np.ascontiguousarray(a))


def _to_jax(a):
    if isinstance(a, (list, tuple)):
        return type(a)(_to_jax(x) for x in a)
    return jnp.asarray(a)


# name: (JAX module, port module, inputs(seed), state dict of the JAX
#        variables, the JAX converter, JAX apply kwargs)
CASES = {
    "rrdbnet_x4": (lambda: jsr.RRDBNet(num_feat=16, num_block=2, num_grow_ch=8),
                   lambda: psr.RRDBNet(num_feat=16, num_block=2, num_grow_ch=8),
                   lambda s: (_frames(s, 1, 7, 9, 3),),
                   lambda t: fj.rrdbnet_state_dict(t, num_block=2),
                   lambda sd: cc.convert_rrdbnet(sd, num_block=2)),
    "rrdbnet_x2": (lambda: jsr.RRDBNet(scale=2, num_feat=16, num_block=1, num_grow_ch=8),
                   lambda: psr.RRDBNet(scale=2, num_feat=16, num_block=1, num_grow_ch=8),
                   lambda s: (_frames(s, 1, 8, 10, 3),),
                   lambda t: fj.rrdbnet_state_dict(t, num_block=1),
                   lambda sd: cc.convert_rrdbnet(sd, num_block=1)),
    "msrresnet": (lambda: jsr.MSRResNet(num_feat=16, num_block=2),
                  lambda: psr.MSRResNet(num_feat=16, num_block=2),
                  lambda s: (_frames(s, 1, 7, 9, 3),),
                  lambda t: fj.msrresnet_state_dict(t, num_block=2),
                  lambda sd: cc.convert_msrresnet(sd, num_block=2)),
    "srvgg": (lambda: jsr.SRVGGNetCompact(num_feat=16, num_conv=2),
              lambda: psr.SRVGGNetCompact(num_feat=16, num_conv=2),
              lambda s: (_frames(s, 1, 7, 9, 3),),
              lambda t: fj.srvgg_state_dict(t, num_conv=2),
              lambda sd: cc.convert_srvgg(sd, num_conv=2)),
    "unet_discriminator_sn": (lambda: jsr.UNetDiscriminatorSN(num_feat=16),
                              lambda: psr.UNetDiscriminatorSN(num_feat=16),
                              lambda s: (_frames(s, 1, 24, 40, 3),),
                              fj.unet_discriminator_sn_state_dict, None),
    "basicvsr": (lambda: jva.BasicVSR(num_feat=8, num_block=1),
                 lambda: pva.BasicVSR(num_feat=8, num_block=1),
                 lambda s: (_frames(s, 1, 3, 7, 9, 3),) + _flows(s, 1, 3, 7, 9),
                 lambda t: fj.basicvsr_state_dict(t, num_block=1),
                 lambda sd: cc.convert_basicvsr(sd, num_block=1)),
    "basicvsrpp": (lambda: jva.BasicVSRPlusPlus(num_feat=8, num_block=1, deform_groups=2),
                   lambda: pva.BasicVSRPlusPlus(num_feat=8, num_block=1, deform_groups=2),
                   lambda s: (_frames(s, 1, 3, 7, 9, 3),) + _flows(s, 1, 3, 7, 9),
                   lambda t: fj.basicvsrpp_state_dict(t, num_block=1),
                   lambda sd: cc.convert_basicvsrpp(sd, num_block=1)),
    "edvr": (lambda: jva.EDVR(num_feat=8, num_frame=3, num_extract_block=1,
                              num_reconstruct_block=1, deform_groups=1),
             lambda: pva.EDVR(num_feat=8, num_frame=3, num_extract_block=1,
                              num_reconstruct_block=1, deform_groups=1),
             lambda s: (_frames(s, 1, 3, 16, 20, 3),),
             lambda t: fj.edvr_state_dict(t, 1, 1),
             lambda sd: cc.convert_edvr(sd, num_extract_block=1, num_reconstruct_block=1)),
    "coupleprop": (lambda: jva.CouplePropModule(num_ch=4, num_feat=8, num_block=2),
                   lambda: pva.CouplePropModule(num_ch=4, num_feat=8, num_block=2),
                   lambda s: (_frames(s, 1, 4, 7, 9, 4),) + _flows(s, 1, 4, 7, 9),
                   lambda t: fj.coupleprop_state_dict(t, num_block=2),
                   lambda sd: cc.convert_coupleprop(sd, num_block=2)),
    "swinir": (lambda: jsw.SwinIR(upscale=4, embed_dim=16, depths=(2, 2), num_heads=(2, 4)),
               lambda: psw.SwinIR(upscale=4, embed_dim=16, depths=(2, 2), num_heads=(2, 4)),
               lambda s: (_frames(s, 1, 16, 24, 3),),
               lambda t: fj.swinir_state_dict(t, depths=(2, 2)),
               lambda sd: cc.convert_swinir(sd, depths=(2, 2))),
    "rcan": (lambda: jmi.RCAN(num_feat=16, num_group=1, num_block=2),
             lambda: pmi.RCAN(num_feat=16, num_group=1, num_block=2),
             lambda s: (_frames(s, 1, 7, 9, 3),),
             lambda t: fj.rcan_state_dict(t, num_group=1, num_block=2),
             lambda sd: cc.convert_rcan(sd, num_group=1, num_block=2)),
    "toflow": (lambda: jmi.TOFlow(), lambda: pmi.TOFlow(),
               lambda s: (_frames(s, 1, 7, 32, 48, 3),),
               fj.toflow_state_dict, cc.convert_toflow),
    "duf": (lambda: jmi.DUF(scale=4, num_layer=16), lambda: pmi.DUF(scale=4, num_layer=16),
            lambda s: (_frames(s, 1, 7, 7, 9, 3),),
            lambda t: fj.duf_state_dict(t, num_layer=16),
            lambda sd: cc.convert_duf(sd, num_layer=16)),
    "ecbsr": (lambda: jmi.ECBSR(num_feat=8, num_block=2),
              lambda: pmi.ECBSR(num_feat=8, num_block=2),
              lambda s: (_frames(s, 1, 7, 9, 3),),
              lambda t: fj.ecbsr_state_dict(t, num_block=2),
              lambda sd: cc.convert_ecbsr(sd, num_block=2)),
    "ridnet": (lambda: jmi.RIDNet(num_feat=16, num_block=1),
               lambda: pmi.RIDNet(num_feat=16, num_block=1),
               lambda s: (_frames(s, 1, 7, 9, 3),),
               lambda t: fj.ridnet_state_dict(t, num_block=1),
               lambda sd: cc.convert_ridnet(sd, num_block=1)),
    "deresnet": (lambda: jmi.DEResNet(num_feats=(8, 16, 16, 32), num_blocks=(1, 1, 1, 1),
                                      downscales=(2, 2, 1, 1)),
                 lambda: pmi.DEResNet(num_feats=(8, 16, 16, 32), num_blocks=(1, 1, 1, 1),
                                      downscales=(2, 2, 1, 1)),
                 lambda s: (_frames(s, 2, 15, 17, 3),),
                 lambda t: fj.deresnet_state_dict(t, 2, (8, 16, 16, 32), (1, 1, 1, 1),
                                                  (2, 2, 1, 1)),
                 lambda sd: cc.convert_deresnet(sd, num_feats=(8, 16, 16, 32),
                                                num_blocks=(1, 1, 1, 1), downscales=(2, 2, 1, 1))),
    "stylegan2_discriminator": (
        lambda: jsg.StyleGAN2Discriminator(in_size=16, narrow=0.125),
        lambda: psg.StyleGAN2Discriminator(in_size=16, narrow=0.125),
        lambda s: (_frames(s, 4, 16, 16, 3),),
        lambda t: fj.stylegan2_discriminator_state_dict(t, in_size=16),
        lambda sd: cc.convert_stylegan2_discriminator(sd, in_size=16)),
    "hifacegan": (lambda: jfa.HiFaceGAN(jfa.HiFaceGANConfig(num_feat=8)),
                  lambda: pfa.HiFaceGAN(num_feat=8),
                  lambda s: (_frames(s, 1, 64, 64, 3) * 2 - 1,),
                  fj.hifacegan_state_dict, cc.convert_hifacegan),
    "hifacegan_without_lip": (lambda: jfa.HiFaceGAN(jfa.HiFaceGANConfig(num_feat=8,
                                                                        lip_encoder=False)),
                              lambda: pfa.HiFaceGAN(num_feat=8, lip_encoder=False),
                              lambda s: (_frames(s, 1, 64, 64, 3) * 2 - 1,),
                              fj.hifacegan_state_dict, None),
    "hifacegan_discriminator": (
        lambda: jfa.HiFaceGANDiscriminator(num_d=2, n_layers=4, num_feat=8),
        lambda: pfa.HiFaceGANDiscriminator(num_in_ch=6, num_d=2, n_layers=4, num_feat=8),
        lambda s: (_frames(s, 1, 37, 43, 6),),
        fj.hifacegan_discriminator_state_dict,
        lambda sd: cc.convert_hifacegan_discriminator(sd, num_d=2, n_layers=4)),
}


# run jitted: the JAX modules whose eager apply takes longer than a compile
JIT = {"edvr", "hifacegan", "hifacegan_without_lip", "swinir", "toflow",
       "unet_discriminator_sn"}


def _check(jmod, pmod, inputs, variables, sd_fn, convert, jit=False):
    apply = jax.jit(jmod.apply) if jit else jmod.apply
    want = apply(variables, *_to_jax(inputs))
    sd = sd_fn(variables)
    pmod.load_state_dict(sd)
    with torch.no_grad():
        got = pmod.eval()(*_to_torch(inputs))
    fw, fg = jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert len(fw) == len(fg)
    for g, w in zip(fg, fw):
        assert tuple(g.shape) == tuple(w.shape)
        rel_close(g, w)
    if convert is not None:
        used = set()
        back = convert({k: v for k, v in sd.items()}, used=used) if _takes_used(convert) \
            else convert(sd)
        _same_tree(back, {k: v for k, v in variables.items()})
        if used:
            assert used == set(sd), sorted(set(sd) - used)[:8]


def _takes_used(fn) -> bool:
    try:
        fn({}, used=set())
    except TypeError as e:
        return "used" not in str(e)
    except Exception:
        return True
    return True


@pytest.mark.parametrize("name", sorted(CASES))
def test_heritage_arch_matches_jax_and_round_trips(name):
    jfac, pfac, inputs_fn, sd_fn, convert = CASES[name]
    seed = sorted(CASES).index(name)
    inputs = inputs_fn(seed)
    jmod = jfac()
    variables = drawn(jmod, 100 + seed, *_to_jax(inputs))
    _check(jmod, pfac(), inputs, variables, sd_fn, convert, name in JIT)


def test_unet_discriminator_updates_u_like_jax():
    jmod, pmod = jsr.UNetDiscriminatorSN(num_feat=8), psr.UNetDiscriminatorSN(num_feat=8)
    x = _frames(3, 1, 16, 24, 3)
    variables = drawn(jmod, 7, jnp.asarray(x))
    want, new = jax.jit(lambda v, x: jmod.apply(v, x, update_sv=True, mutable=["spectral"]))(
        variables, jnp.asarray(x))
    pmod.load_state_dict(fj.unet_discriminator_sn_state_dict(variables))
    with torch.no_grad():
        got = pmod(torch.from_numpy(x), update_sv=True)
    rel_close(got, want)
    for i in range(1, 9):
        rel_close(getattr(pmod, f"conv{i}").weight_u, new["spectral"][f"conv{i}"]["u"], 1e-5)


def test_stylegan2_generator_with_injected_noise_matches_jax_and_round_trips():
    jmod = jsg.StyleGAN2Generator(out_size=16, num_style_feat=32, num_mlp=2, narrow=0.125)
    pmod = psg.StyleGAN2Generator(out_size=16, num_style_feat=32, num_mlp=2, narrow=0.125)
    z = np.random.RandomState(4).randn(2, 32).astype(np.float32)
    rs = np.random.RandomState(5)
    noises = [rs.randn(1, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2), 1).astype(np.float32)
              for i in range(pmod.num_layers)]
    variables = drawn(jmod, 6, jnp.asarray(z), noises=_to_jax(noises))
    # the noise strengths drawn non-zero, so the injection shows
    tree = {"params": variables["params"], "_noises": noises}
    want = jax.jit(jmod.apply)(variables, jnp.asarray(z), noises=_to_jax(noises))
    sd = fj.stylegan2_state_dict(tree, out_size=16, num_mlp=2)
    pmod.load_state_dict(sd)
    with torch.no_grad():
        got = pmod(torch.from_numpy(z), noises=pmod.stored_noises())
        quiet = pmod(torch.from_numpy(z))
        gen = torch.Generator().manual_seed(0)
        drawn_a = pmod(torch.from_numpy(z), generator=gen)
        drawn_b = pmod(torch.from_numpy(z), generator=torch.Generator().manual_seed(0))
    rel_close(got, want)
    assert float((got - quiet).abs().max()) > 1e-4
    assert torch.equal(drawn_a, drawn_b)
    used = set()
    _same_tree(cc.convert_stylegan2(sd, out_size=16, num_mlp=2, used=used), tree)
    assert used == set(sd)


def _dfdnet_inputs():
    rs = np.random.RandomState(21)
    x = (rs.rand(1, 64, 64, 3) * 2 - 1).astype(np.float32)
    boxes = [[4, 8, 20, 24], [36, 8, 56, 24], [20, 24, 40, 44], [12, 44, 52, 60]]
    # two of the four scales: the others take the path without a swap
    dictionary = {str(fs): {p: rs.randn(3, 6, 8, ch).astype(np.float32) for p in jfa.PARTS}
                  for fs, ch in zip(jfa.FEATURE_SIZES, jfa.CHANNEL_SIZES) if fs in (256, 64)}
    return x, boxes, dictionary


def test_dfdnet_matches_jax_and_round_trips():
    """Batch 1, 64x64 (the boxes, on the 512 scale, land inside the VGG
    maps), dictionaries synthesised at two scales, every part swapped there."""
    x, boxes, dictionary = _dfdnet_inputs()
    jnet = jfa.DFDNet(num_feat=64, dictionary={k: {p: jnp.asarray(v) for p, v in d.items()}
                                               for k, d in dictionary.items()})
    shapes = jax.eval_shape(jnet.init_params, jax.random.PRNGKey(0))
    rs = np.random.RandomState(22)
    params = jax.tree_util.tree_map(
        lambda s: ((rs.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))) if len(s.shape) >= 2
                   else 0.05 * rs.randn(*s.shape)).astype(np.float32), shapes)
    want = jnet(params, jnp.asarray(x), boxes)
    pnet = pfa.DFDNet(num_feat=64, dictionary={k: {p: torch.from_numpy(v) for p, v in d.items()}
                                               for k, d in dictionary.items()})
    sd = fj.dfdnet_state_dict(params)
    pnet.load_state_dict(sd)
    with torch.no_grad():
        got = pnet(torch.from_numpy(x), boxes)
    rel_close(got, want)
    used = set()
    _same_tree(cc.convert_dfdnet(sd, used=used), params)
    assert used == set(sd)
    vgg = {"params": params["vgg"]["params"]}
    _same_tree(cc.convert_vgg_face(fj.vgg_face_state_dict(vgg, prefix=""), prefix=""), vgg)


def test_vgg19_features_taps_match_jax():
    jmod = jfa.VGG19Features(taps=("conv2_1", "relu3_2"), range_norm=False)
    pmod = pfa.VGG19Features(taps=("conv2_1", "relu3_2"), range_norm=False)
    x = _frames(23, 1, 17, 23, 3)
    variables = drawn(jmod, 24, jnp.asarray(x))
    want = jmod.apply(variables, jnp.asarray(x))
    pmod.load_state_dict(fj.vgg_face_state_dict(variables, prefix=""))
    with torch.no_grad():
        got = pmod(torch.from_numpy(x))
    assert sorted(got) == sorted(want) == ["conv2_1", "relu3_2"]
    for k in want:
        rel_close(got[k], want[k])


@pytest.mark.parametrize("with_idt", [False, True])
def test_ecbsr_training_form_folds_like_the_converter(with_idt):
    """The port's ECBs hold the reference's five training branches and fold
    them at every call: with every branch drawn non-zero, the port equals
    the JAX module on ``convert_ecbsr``'s fold of the port's own state dict
    (with and without the identity)."""
    pmod = pmi.ECBSR(num_feat=8, num_block=2, with_idt=with_idt)
    gen = torch.Generator().manual_seed(31)
    with torch.no_grad():
        for p in pmod.parameters():
            if p.requires_grad:
                p.copy_(torch.randn(p.shape, generator=gen) / (p[0].numel() ** 0.5
                                                               if p.dim() >= 2 else 20))
    x = _frames(32, 1, 7, 9, 3)
    params = cc.convert_ecbsr(pmod.state_dict(), num_block=2, with_idt=with_idt)
    want = jmi.ECBSR(num_feat=8, num_block=2).apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = pmod.eval()(torch.from_numpy(x))
    rel_close(got, want)
