"""``VAEConfig.remat_min_res``: with ``use_checkpoint`` the port's decoder
recomputes exactly the res blocks and fusion blocks that the JAX package's
``res_block_cls`` / ``fuse_block_cls`` rule rematerialises (running height
>= ``remat_min_res``), and the decode and its gradients are the same bit
for bit with and without it."""
import dataclasses

import pytest
import torch
import torch.utils.checkpoint

from mgldvsr_tpu.models import vae as jvae
from mgldvsr_tpu.models.layers import VAEResnetBlock as JaxResnetBlock
from mgldvsr_tpu_torch.models.layers import VAEResnetBlock
from mgldvsr_tpu_torch.models.vae import FuseBlock, VAEConfig, VideoAutoencoderKLResi

TINY = dict(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1, num_frames=2, enable_fusion=True,
            num_fuse_block=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _decode_with_grad(vae, seed=0):
    """The decoder's forward and backward on seeded latents and LQ features:
    (output, gradient of the latents, gradients of the parameters)."""
    g = torch.Generator().manual_seed(seed)
    frames = torch.rand(2, 3, 32, 32, generator=g) * 2 - 1
    with torch.no_grad():
        moments, fea = vae.encode(frames)
    z = moments[:, :4].clone().requires_grad_()
    out = vae.decode(z, fea, 0.5)
    out.square().mean().backward()
    return out.detach(), z.grad, {n: p.grad.clone() for n, p in vae.named_parameters()
                                  if p.grad is not None}


@pytest.mark.parametrize("min_res", [0, 8, 16, 64])
def test_recomputed_blocks_follow_the_jax_rule(monkeypatch, min_res):
    cfg = VAEConfig(**TINY, use_checkpoint=True, remat_min_res=min_res)
    jcfg = jvae.VAEConfig(**TINY, use_checkpoint=True, remat_min_res=min_res)
    torch.manual_seed(0)
    vae = VideoAutoencoderKLResi(cfg)
    heights, recomputed = {}, set()

    def height(name):
        def hook(mod, args):  # a fusion block's decoder input is its second argument
            heights.setdefault(name, args[1 if isinstance(mod, FuseBlock) else 0].shape[2])
        return hook

    for name, m in vae.decoder.named_modules():
        if isinstance(m, (VAEResnetBlock, FuseBlock)):
            m.register_forward_pre_hook(height(name))
    names = {m: n for n, m in vae.decoder.named_modules()}
    checkpoint = torch.utils.checkpoint.checkpoint

    def recording(fn, *args, **kwargs):
        recomputed.add(names[fn])
        return checkpoint(fn, *args, **kwargs)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", recording)
    _decode_with_grad(vae)
    assert len(heights) == 2 + 4 * 2 + 2  # mid, (num_res_blocks + 1) a level, two fusions
    want = {name for name, h in heights.items()
            if (jcfg.fuse_block_cls(h) is not jvae.FuseBlock if "fusion" in name
                else jcfg.res_block_cls(h) is not JaxResnetBlock)}
    assert recomputed == want
    assert {0: 12, 8: 8, 16: 5, 64: 0}[min_res] == len(recomputed)


def test_selective_remat_changes_no_bit():
    torch.manual_seed(0)
    plain = VideoAutoencoderKLResi(VAEConfig(**TINY))
    want = _decode_with_grad(plain)
    for min_res in (0, 16):
        remat = VideoAutoencoderKLResi(VAEConfig(**TINY, use_checkpoint=True,
                                                 remat_min_res=min_res))
        remat.load_state_dict(plain.state_dict())
        got = _decode_with_grad(remat)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert got[2].keys() == want[2].keys()
        assert all(torch.equal(got[2][k], want[2][k]) for k in want[2])
    assert not dataclasses.replace(VAEConfig(), remat_min_res=256).remat(512)  # checkpoint off
