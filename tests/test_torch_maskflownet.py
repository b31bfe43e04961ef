"""MaskFlownet_S against the JAX package on the CPU, float32, at its
published widths on a 96x128 pair (the JAX test's size; the frames are
resized to multiples of 64 inside), on weights carried by
``io.from_jax.maskflownet_state_dict``; and that state dict through the
JAX converter and back, bit for bit. Limit: 2e-5 of max |flow|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from mgldvsr_tpu.flow.maskflownet import MaskFlownetS as JMaskFlownetS
from mgldvsr_tpu.io import ckpt_convert as cc
from mgldvsr_tpu_torch.flow import MaskFlownetS
from mgldvsr_tpu_torch.io import from_jax
from tests.test_torch_heritage_ops import drawn, rel_close

torch.set_num_threads(1)


def _pair(seed, h=96, w=128):
    rs = np.random.RandomState(seed)
    return rs.rand(1, h, w, 3).astype(np.float32), rs.rand(1, h, w, 3).astype(np.float32)


def _same_tree(got, want):
    fg = jax.tree_util.tree_flatten_with_path(got)[0]
    fw = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in fg] == [p for p, _ in fw]
    for (path, a), (_, b) in zip(fg, fw):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert np.array_equal(a, b), path


def test_maskflownet_matches_jax_and_round_trips():
    ref, sup = _pair(1)
    net = JMaskFlownetS()
    params = drawn(net, 2, jnp.asarray(ref), jnp.asarray(sup))
    want = jax.jit(net.apply)(params, jnp.asarray(ref), jnp.asarray(sup))
    sd = from_jax.maskflownet_state_dict(params)
    port = MaskFlownetS().eval()
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port(torch.from_numpy(ref), torch.from_numpy(sup))
    assert got.shape == (1, 96, 128, 2)
    rel_close(got, want)
    used = set()
    _same_tree(cc.convert_maskflownet(sd, used=used), params)
    assert used == set(sd)


def test_maskflownet_odd_size_is_brightness_invariant():
    """An odd-sized pair (resized to 64-multiples and back) gives a finite
    flow of its own size, unchanged by a constant added to both frames."""
    ref, sup = _pair(3, 45, 71)
    torch.manual_seed(0)
    port = MaskFlownetS().eval()
    with torch.no_grad():
        for p in port.parameters():
            p.mul_(0.1)
        a = port(torch.from_numpy(ref), torch.from_numpy(sup))
        b = port(torch.from_numpy(ref) + 0.3, torch.from_numpy(sup) + 0.3)
    assert a.shape == (1, 45, 71, 2) and torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
