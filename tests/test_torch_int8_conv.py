"""``MGLD_INT8_CONV=1``: the port's int8 3x3 conv against the JAX package's
``Int8Conv3x3`` on the CPU (the port's plain version; the CUDA kernels are
held to it bit for bit on the card, ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phase 18).

Parity is exact a conv: the levels, the scales and the int32 sums bit for
bit, the output within one float32 ulp. A whole restore cannot be held
tighter than its own chaos: a rounding-level change of any activation
flips int8 levels, and seeded towers amplify the flips (frames moved by
1e-7 move a tiny int8 restore by ~0.7 max, ~0.09 mean). So the slice is
held site by site on JAX's own inputs (teacher forcing), and the end-to-end
restore only to a witness.
"""
import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgldvsr_tpu.infer.pipeline import MGLDVSRPipeline as JaxPipeline
from mgldvsr_tpu.models import classifier as jcls
from mgldvsr_tpu.models.layers import Int8Conv3x3 as JaxInt8Conv3x3
from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline
from mgldvsr_tpu_torch.io import from_jax
from mgldvsr_tpu_torch.models import classifier as pcls
from mgldvsr_tpu_torch.models.layers import Conv2d, Int8Conv3x3, cast_weights, conv3x3
from mgldvsr_tpu_torch.models.unet import InflatedUNetDualCond, StructCondEncoder
from mgldvsr_tpu_torch.models.vae import VideoAutoencoderKLResi
from mgldvsr_tpu_torch.ops.kernels import int8_conv as K
from tests.test_pipeline import tiny_config
from tests.test_torch_models import nchw, numpy_tree, port_config


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def int8(monkeypatch):
    monkeypatch.setenv("MGLD_INT8_CONV", "1")
    monkeypatch.setenv("MGLD_FUSED_GN_CONV", "0")


def ulps(got: np.ndarray, want: np.ndarray) -> float:
    """Largest |got - want| in float32 ulps of the larger magnitude."""
    got, want = got.astype(np.float32), want.astype(np.float32)
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    return float((np.abs(got - want) / ulp).max())


def _jax_levels(x, k):
    """The JAX module's expressions (layers.py:184-196), written out."""
    sx = jnp.maximum(jnp.max(jnp.abs(x)).astype(jnp.float32), 1e-6) / 127.0
    xq = jnp.clip(jnp.round(x.astype(jnp.float32) / sx), -127, 127).astype(jnp.int8)
    sw = jnp.maximum(jnp.max(jnp.abs(k), axis=(0, 1, 2)), 1e-12) / 127.0
    kq = jnp.clip(jnp.round(k / sw), -127, 127).astype(jnp.int8)
    return sx, xq, sw, kq


def _case(kind, cin, cout, seed):
    """(x [2,9,11,cin], k [3,3,cin,cout], b) float32. ``halves``: x on the
    grid (j + 1/2) / 16 with one element at 127/16, so that sx = 1/16 and
    every level is a tie (rounded half to even)."""
    rs = np.random.RandomState(seed)
    x = (rs.randn(2, 9, 11, cin) * 2.5).astype(np.float32)
    k = (rs.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
    b = (0.1 * rs.randn(cout)).astype(np.float32)
    if kind == "halves":
        x = ((rs.randint(-127, 127, size=x.shape) + 0.5) / 16).astype(np.float32)
        x.flat[7] = 127 / 16
    if kind == "zero_kernel":
        k[:] = 0.0
    return x, k, b


CASES = [  # kind, input dtype, Cin, Cout, stride
    ("randn", "float32", 3, 32, 1), ("randn", "bfloat16", 4, 320, 2),
    ("halves", "float32", 32, 8, 1), ("randn", "bfloat16", 160, 32, 2),
    ("zero_kernel", "bfloat16", 288, 128, 1), ("halves", "bfloat16", 160, 64, 1),
]


def _jax_case(xj, k, b, stride):
    """The JAX expressions and the JAX module's output, op by op: under
    ``jax.jit`` XLA on the CPU turns the module's ``/ 127.0`` into a product
    with the rounded reciprocal, a scale an ulp off its source now and
    then; the port, as the module run op by op, divides."""
    sx, xq, sw, kq = _jax_levels(xj, k)
    acc = jax.lax.conv_general_dilated(xq, kq, (stride, stride), [(1, 1), (1, 1)],
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                       preferred_element_type=jnp.int32)
    params = {"params": {"kernel": k, "bias": b}}
    out = JaxInt8Conv3x3(k.shape[-1], strides=stride, dtype=jnp.float32).apply(params, xj)
    return sx, xq, sw, kq, acc, out


@pytest.mark.parametrize("kind,dtype,cin,cout,stride", CASES)
def test_levels_sums_and_output_match_jax(kind, dtype, cin, cout, stride):
    x, k, b = _case(kind, cin, cout, seed=cin + cout)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xj = jnp.asarray(x).astype(jdt)
    sx, xq, sw, kq, acc, want = _jax_case(xj, jnp.asarray(k), jnp.asarray(b), stride)

    xt = nchw(np.asarray(xj.astype(jnp.float32))).to(tdt)
    kt = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    got_xq, got_sx = K.quantize_activation(xt)
    got_kq, got_sw = K.quantize_weight(kt)
    assert got_sx.dtype == got_sw.dtype == torch.float32
    assert got_sx.item() == float(sx)
    np.testing.assert_array_equal(got_xq.permute(0, 2, 3, 1).numpy(), np.asarray(xq))
    np.testing.assert_array_equal(got_sw.numpy(), np.asarray(sw))
    np.testing.assert_array_equal(got_kq.permute(2, 3, 1, 0).numpy(), np.asarray(kq))
    got_acc = K.int8_accumulate(got_xq, got_kq, stride)
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.permute(0, 2, 3, 1).numpy(), np.asarray(acc))

    conv = Int8Conv3x3(cin, cout, stride)
    conv.load_state_dict({"weight": kt, "bias": torch.from_numpy(b)})
    with torch.no_grad():
        got = conv(xt)
    assert got.dtype == torch.float32 and got.shape == (2, cout, *K.output_size(9, 11, stride))
    assert ulps(got.permute(0, 2, 3, 1).numpy(), np.asarray(want)) <= 1.0
    if kind == "halves":  # every level a tie, rounded to even
        assert got_sx.item() == 1 / 16
        assert (got_xq.int() % 2 == 0).float().mean() > 0.99
    if kind == "zero_kernel":
        np.testing.assert_array_equal(got.numpy(), np.broadcast_to(
            b.reshape(1, -1, 1, 1), got.shape))


def test_relaid_levels_give_the_sums_in_the_kernels_order():
    """The conv kernel reads the levels re-laid [9][Co][Cp] (Cp = C rounded
    up to 32, zero beyond C) and sums a stage of 32 channels at a time, tap
    by tap, over a patch (TH-1)*S+3 wide: the same sums, emulated here at
    C = 3, 40 and 160, strides 1 and 2."""
    rs = np.random.RandomState(0)
    for c, stride in ((3, 1), (40, 2), (160, 1)):
        xq = torch.from_numpy(rs.randint(-127, 128, size=(2, c, 7, 9)).astype(np.int8))
        kq = torch.from_numpy(rs.randint(-127, 128, size=(5, c, 3, 3)).astype(np.int8))
        wq = K.relayout_levels(kq)
        cp = wq.shape[2]
        assert cp % 32 == 0 and cp - c < 32 and not wq[:, :, c:].any()
        ho, wo = K.output_size(7, 9, stride)
        pad = torch.zeros(2, cp, 7 + 2, 9 + 2, dtype=torch.int64)
        pad[:, :c, 1:-1, 1:-1] = xq.long()
        acc = torch.zeros(2, 5, ho, wo, dtype=torch.int64)
        for c0 in range(0, cp, 32):
            for tap in range(9):
                ky, kx = divmod(tap, 3)
                a = pad[:, c0:c0 + 32, ky:ky + (ho - 1) * stride + 1:stride,
                        kx:kx + (wo - 1) * stride + 1:stride]
                acc += torch.einsum("nchw,oc->nohw", a, wq[tap, :, c0:c0 + 32].long())
        assert torch.equal(acc.int(), K.int8_accumulate(xq, kq, stride))


def test_switch_is_read_when_the_conv_is_built(monkeypatch):
    monkeypatch.setenv("MGLD_INT8_CONV", "1")
    built_on = conv3x3(8, 16)
    monkeypatch.delenv("MGLD_INT8_CONV")
    built_off = conv3x3(8, 16)
    assert type(built_on) is Int8Conv3x3 and type(built_off) is Conv2d
    x = torch.randn(1, 8, 5, 5)
    built_off.load_state_dict(built_on.state_dict())
    with torch.no_grad():  # still int8 with the variable gone, and the keys are Conv2d's
        assert not torch.equal(built_on(x), built_off(x))
        torch.testing.assert_close(built_on(x), built_off(x), atol=0.05, rtol=0)


# -- the site map ----------------------------------------------------------------


def _root(module):
    while isinstance(module.parent, nn.Module):
        module = module.parent
    return module


def _is_int8_call(context) -> bool:
    return isinstance(context.module, JaxInt8Conv3x3) and context.method_name == "__call__"


def _shapes_and_sites(fn):
    """(``jax.eval_shape(fn)``, JAX module paths of every ``Int8Conv3x3``
    that it calls): traced, not compiled."""
    seen = set()

    def record(next_fun, args, kwargs, context):
        if _is_int8_call(context):
            seen.add(tuple(context.module.path))
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(record):
        return jax.eval_shape(fn), seen


def _port_int8_paths(module, paths):
    """JAX module paths (``paths``: port key -> (JAX leaf path, axis)) of the
    port's ``Int8Conv3x3`` modules."""
    int8 = {name for name, m in module.named_modules() if isinstance(m, Int8Conv3x3)}
    return {paths[f"{name}.weight"][0][1:-1] for name in int8}


@pytest.fixture(scope="module")
def tiny():
    """The tiny pipeline's JAX parameters, traced under the switch (each
    tower's init through ``jax.eval_shape``, as the JAX pipeline's fast init
    does, then filled with its leaf rule), with the JAX ``Int8Conv3x3``
    paths of the UNet, struct-cond and VAE (encode and fusion decode) seen
    on the way; RAFT's last flow-head conv x1e-2 (the guidance stays on)."""
    from mgldvsr_tpu.flow.raft import RAFT
    from mgldvsr_tpu.infer.pipeline import _synthesize_leaves, empty_prompt_tokens

    jcfg = tiny_config(num_frames=5, ddpm_steps=2)
    t = jcfg.num_frames
    frames, lat = jnp.zeros((t, 32, 32, 3)), jnp.zeros((t, 4, 4, 4))
    ts, ctx = jnp.zeros((t,), jnp.int32), jnp.zeros((t, 77, jcfg.clip.width))
    key = jax.random.PRNGKey(0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MGLD_INT8_CONV", "1")
        mp.setenv("MGLD_FUSED_GN_CONV", "0")
        jp = JaxPipeline(jcfg)
        shapes, sites = {}, {}
        shapes["structcond"], sites["structcond"] = _shapes_and_sites(
            lambda: jp.structcond.init(key, lat, ts))
        sc = jax.eval_shape(lambda p: jp.structcond.apply(p, lat, ts), shapes["structcond"])
        sc = jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype), sc)
        shapes["unet"], sites["unet"] = _shapes_and_sites(
            lambda: jp.unet.init(key, lat, ts, ctx, sc))
        shapes["vae"], sites["vae"] = _shapes_and_sites(lambda: jp.vae.init(key, frames, lat))
    shapes["clip"] = jax.eval_shape(
        lambda: jp.clip.init(key, empty_prompt_tokens(t, jcfg.clip.context_length)))
    raft1 = RAFT(dataclasses.replace(jcfg.raft, iters=1))
    shapes["raft"] = jax.eval_shape(lambda: raft1.init(key, frames, frames))
    params = numpy_tree(_synthesize_leaves(shapes, key))
    params["raft"]["params"]["update_scan"]["update_block"]["flow_head_conv2"]["kernel"] *= 1e-2
    cfg = port_config(jcfg)
    return jcfg, params, cfg, from_jax.pipeline_state_dicts(params, cfg), sites


def _towers(cfg):
    return {"unet": InflatedUNetDualCond(cfg.unet), "structcond": StructCondEncoder(
        cfg.structcond), "vae": VideoAutoencoderKLResi(cfg.vae)}


def test_site_map_equals_the_jax_int8_modules(tiny, int8):
    """Every port conv that takes int8 under the switch, by its JAX param
    path, is exactly a JAX ``Int8Conv3x3`` of the tiny pipeline (UNet,
    struct-cond, VAE encode and fusion decode) and of the classifier;
    ``Upsample.conv`` and ``VAEDownsample`` are not among them."""
    _, _, cfg, _, want = tiny
    towers = _towers(cfg)
    for name, module in towers.items():
        got = _port_int8_paths(module, from_jax.jax_paths(name, module))
        assert got == want[name], (name, sorted(got ^ want[name]))
    vae_keys = {n for n, m in towers["vae"].named_modules() if isinstance(m, Int8Conv3x3)}
    assert not any("upsample" in n or "downsample" in n for n in vae_keys)
    assert any("upsample" in n for n, _ in towers["vae"].named_modules())
    assert any(n.endswith(".op") and isinstance(m, Int8Conv3x3)
               for n, m in towers["unet"].named_modules())
    assert sum("encode_enc_2" in n for n in vae_keys) == 5 * 2  # the RDB's five, two fusions

    kw = dict(model_channels=32, num_classes=10, channel_mult=(1, 2), num_res_blocks=1,
              attention_resolutions=(2,), pool="adaptive")
    jm = jcls.NoisyLatentClassifier(jcls.ClassifierConfig(**kw))
    x = jnp.zeros((2, 16, 16, 4))
    _, want = _shapes_and_sites(lambda: jm.init(jax.random.PRNGKey(0), x,
                                                jnp.zeros((2,), jnp.int32)))
    m = pcls.NoisyLatentClassifier(pcls.ClassifierConfig(**kw, image_size=16))
    keys, found = set(m.state_dict()), {}
    from_jax.classifier_state_dict(from_jax._Trace(("classifier",), keys, found), m.cfg)
    assert _port_int8_paths(m, found) == want and ("conv_in",) in want


# -- teacher forcing ---------------------------------------------------------------


def _product(x, k, c127, stride):
    """The JAX module's ``float32(acc) * (sx * sw)`` (``_jax_levels``), with
    127 a traced argument: compiled, XLA keeps the divisions by it (a
    constant 127 becomes a product with its reciprocal); the bias is added
    outside, because the compiled program would fuse the add into an fma."""
    sx = jnp.maximum(jnp.max(jnp.abs(x)).astype(jnp.float32), 1e-6) / c127
    xq = jnp.clip(jnp.round(x.astype(jnp.float32) / sx), -127, 127).astype(jnp.int8)
    sw = jnp.maximum(jnp.max(jnp.abs(k), axis=(0, 1, 2)), 1e-12) / c127
    kq = jnp.clip(jnp.round(k / sw), -127, 127).astype(jnp.int8)
    acc = jax.lax.conv_general_dilated(xq, kq, (stride, stride), [(1, 1), (1, 1)],
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                       preferred_element_type=jnp.int32)
    return acc.astype(jnp.float32) * (sx * sw)


def _jit_captured(fn, keep, *args):
    """``jax.jit(fn)`` on ``args`` and, of every ``Int8Conv3x3`` call whose
    root module is a ``keep`` (calls inside a scan cannot leave it): (root
    class, JAX module path, input, the module's expressions on that input
    with the bias added in float32 outside); and the compiled function
    alone. One compile."""
    sites = []

    def traced(c127, *a):
        vals = []

        def record(next_fun, call_args, kwargs, context):
            out = next_fun(*call_args, **kwargs)
            if _is_int8_call(context) and isinstance(_root(context.module), keep):
                p = context.module.variables["params"]
                sites.append((type(_root(context.module)), tuple(context.module.path)))
                vals.append((call_args[0], _product(call_args[0], p["kernel"], c127,
                                                    context.module.strides), p["bias"]))
            return out

        with nn.intercept_methods(record):
            result = fn(*a)
        return result, vals

    compiled = jax.jit(traced)
    c127 = jnp.float32(127.0)
    result, vals = compiled(c127, *args)
    calls = [(*site, np.asarray(x), np.asarray(prod) + np.asarray(b))
             for site, (x, prod, b) in zip(sites, vals)]
    return np.asarray(result), calls, lambda *a: np.asarray(compiled(c127, *a)[0])


@pytest.fixture(scope="module")
def jax_int8_runs(tiny):
    """Under the switch, in JAX: one struct-cond + UNet call, and the
    deterministic tiny restore (its VAE encode and fusion decode
    captured), then the restore again with the frames moved by 1e-6."""
    from mgldvsr_tpu.models.unet import InflatedUNetDualCond as JU
    from mgldvsr_tpu.models.unet import StructCondEncoder as JS
    from mgldvsr_tpu.models.vae import VideoAutoencoderKLResi as JV

    jcfg, params, _, _, _ = tiny
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MGLD_INT8_CONV", "1")
        mp.setenv("MGLD_FUSED_GN_CONV", "0")
        jp = JaxPipeline(jcfg)
        p = jax.tree_util.tree_map(jnp.asarray, params)
        rs = np.random.RandomState(0)
        x = rs.randn(5, 4, 4, 4).astype(np.float32)
        ts = np.array([999, 500, 10, 0, 250], np.int32)
        ctx = rs.randn(5, 77, 32).astype(np.float32)

        def towers(p, x, ts, ctx):
            sc = jp.structcond.apply(p["structcond"], x, ts)
            return jp.unet.apply(p["unet"], x, ts, ctx, sc)

        _, tower_calls, _ = _jit_captured(towers, (JU, JS), p, x, ts, ctx)
        frames = rs.rand(5, 32, 32, 3).astype(np.float32)
        moved = frames + 1e-6 * rs.randn(*frames.shape).astype(np.float32)
        want, vae_calls, restore = _jit_captured(
            lambda p, f: jp.restore_segment(p, f, jax.random.PRNGKey(0), deterministic=True),
            JV, p, frames)
        witness = restore(p, moved)
    calls = {"unet": [], "structcond": [], "vae": []}
    names = {JU: "unet", JS: "structcond", JV: "vae"}
    for root, path, xin, out in tower_calls + vae_calls:
        calls[names[root]].append((path, xin, out))
    return calls, frames, want, witness


def test_every_site_matches_jax_on_its_jax_input(tiny, jax_int8_runs, int8):
    """One tiny struct-cond + UNet call and one restore's VAE encode and
    fusion decode in JAX under the switch, every ``Int8Conv3x3`` input
    captured with the module's expressions on it (held to the module op by
    op above): each goes through the port's module at that site (the same
    float32 state dict), whose output must be within one float32 ulp.
    Every int8 site of the port's towers is reached."""
    _, _, cfg, sds, _ = tiny
    calls = jax_int8_runs[0]
    for name, module in _towers(cfg).items():
        module.load_state_dict(sds[name], strict=True)
        paths = from_jax.jax_paths(name, module)
        by_path = {paths[f"{n}.weight"][0][1:-1]: m for n, m in module.named_modules()
                   if isinstance(m, Int8Conv3x3)}
        assert {c[0] for c in calls[name]} == set(by_path), name
        worst = 0.0
        for path, xin, want in calls[name]:
            with torch.no_grad():
                got = by_path[path](nchw(xin))
            assert got.dtype == torch.float32
            worst = max(worst, ulps(got.permute(0, 2, 3, 1).numpy(), want))
        assert worst <= 1.0, (name, worst)


# -- the slice -----------------------------------------------------------------------


def test_tiny_restore_under_the_switch_is_wired(tiny, jax_int8_runs, int8):
    """The deterministic tiny restore with the switch on, on both sides:
    shapes, finite, in [0, 1]. Only a wiring check: int8 levels flip at
    rounding-level changes of an activation and seeded towers amplify the
    flips, so the port may stand from JAX only as far as JAX stands from
    itself with the frames moved by 1e-6 (the witness); the mean distance
    must be within twice the witness's."""
    _, _, cfg, sds, _ = tiny
    _, frames, want, witness = jax_int8_runs
    pipe = MGLDVSRPipeline(cfg, device="cpu")
    for name, sd in sds.items():
        pipe.towers()[name].load_state_dict(sd, strict=True)
    assert any(isinstance(m, Int8Conv3x3) for m in pipe.unet.modules())
    got = pipe.restore_segment(torch.from_numpy(frames), deterministic=True).numpy()
    for out in (got, want, witness):
        assert out.shape == (5, 32, 32, 3) and np.isfinite(out).all()
        assert out.min() >= 0.0 and out.max() <= 1.0
    chaos = float(np.abs(witness - want).mean())
    assert chaos > 0
    assert float(np.abs(got - want).mean()) <= 2 * chaos, (np.abs(got - want).mean(), chaos)


# -- what raises ---------------------------------------------------------------------


def test_training_under_the_switch_raises(int8):
    conv = conv3x3(4, 8)
    x = torch.randn(1, 4, 6, 6)
    with pytest.raises(RuntimeError, match="int8 training"):
        conv(x)  # the weight records a gradient
    with pytest.raises(RuntimeError, match="int8 training"):
        conv.requires_grad_(False)(x.requires_grad_())
    with torch.no_grad():
        assert conv(x).shape == (1, 8, 6, 6)


def test_levels_come_from_float32_weights_only(int8):
    """A bf16 weight needs levels taken from its float32 values: by a cast
    (``.to`` / :func:`cast_weights`) or by loading a float32 state dict. A
    bf16 state dict, or a weight changed after the cast, raises."""
    conv = conv3x3(32, 16)
    torch.nn.init.normal_(conv.weight, std=0.3)
    x = torch.randn(2, 32, 6, 6)
    with torch.no_grad():
        want = conv(x)
        kq, sw = K.weight_levels(conv.weight)
        cast_weights(conv, torch.bfloat16)
        torch.testing.assert_close(conv(x).float(), want, atol=1e-2 * want.abs().max(), rtol=0)
        got_kq, got_sw, bias = conv.levels()
        assert torch.equal(got_kq, kq) and torch.equal(got_sw, sw) and bias.dtype == torch.float32
        # the bf16-rounded weight would give other levels
        assert not torch.equal(K.quantize_weight(conv.weight.float())[0], kq)

        other = conv3x3(32, 16).to(torch.bfloat16)
        other.load_state_dict({k: v.float() for k, v in conv.state_dict().items()})
        other.load_state_dict({"weight": want.new_zeros(16, 32, 3, 3), "bias": want.new_zeros(16)})
        assert not other.levels()[0].any()
        other.load_state_dict(conv.state_dict())  # bf16 tensors: no float32 values to take
        with pytest.raises(RuntimeError, match="float32"):
            other(x)
        conv.weight.mul_(2.0)
        with pytest.raises(RuntimeError, match="float32"):
            conv(x)
    with pytest.raises(TypeError, match="float32"):
        K.quantize_weight(conv.weight)


def test_an_int8_conv_has_no_column_parallel_form(int8):
    """Tensor-parallel training splits a conv's output rows; an int8 conv
    refuses by name rather than silently running its float32 form."""
    from mgldvsr_tpu_torch.parallel import mesh, tensor

    net = torch.nn.Sequential(conv3x3(8, 16))
    with pytest.raises(ValueError, match="no column-parallel form"):
        tensor.shard_module(net, {"0.weight": 0}, mesh.Grid(dp=1, tp=2, data_index=0,
                                                            tensor_index=0))
