"""Stage-2 training: the port's loss networks, loss terms, converters and
trainer against the JAX package's on the CPU, at tiny widths, float32.

One JAX reference run per module: the JAX ``Stage2Trainer`` (VAE ch 32,
ch_mult (1,1,2,2), 3 frames, 32x32, grad_accum 2, disc_start 0) takes two
micro-steps from a state whose VAE is the port's seeded weights, jittered by
0.02·N(0,1) on the stage-2 trainables (``jitter_weights``: seeded
temporal blends are zero, which leaves the temporal convs without gradient),
converted by the JAX package's own converter. Its SpyNet's last convs are
scaled by 1e-2, so that random flows leave pixels unoccluded and the swc
term is not zero. The port starts from that state
(``io.from_jax.stage2_state_from_jax``) and takes the same micro-steps.

Limits, each set from a reading on this tiny model (readings in brackets):

- the metrics within 1e-5 relative, or 1e-5 of the logits' scale for the
  GAN terms that are means of logits of either sign [4e-7 relative;
  g_loss, -1.5e-3, 5.5e-8 absolute];
- a generator gradient leaf (the accumulator after micro-step 1) within
  1e-4 of its own max |g| plus 1e-6 of the largest |g| [1.7e-5];
- after the update, the trainables and logvar within 0.1·lr [0.036·lr:
  Adam's first step moves an element by lr·g/(|g| + 1e-8), so an element
  whose gradient is near zero moves by rounding], the generator's Adam
  moments within 1e-4 of each leaf's max [3.6e-5];
- the discriminator's running statistics within 1e-6 [2.4e-7];
- the discriminator's gradient, parameters and moments: each leaf within
  1e-4 of its max (1e-3·lr for the parameters), or within 1.5x the move a
  witness makes. JAX's reconstruction stands 1.5e-6 relative from the
  port's, and one of the discriminator's kinks (a hinge or LeakyReLU input
  at zero) lies within that: the leaves behind it jump by 4.25e-2 of their
  max (``main.5.weight``), in JAX's own eager run of the same pass on the
  port's reconstruction as much as in the port, while a float64 run agrees
  with the port to 1.2e-6. The witness is the port against itself with the
  latents moved by 1e-6 relative, which crosses the same kink (4.25e-2; an
  Adam step of those elements moves by up to 2·lr).

The loss networks alone: LPIPS within 1e-5 relative, the discriminator
within 1e-5 of its largest logit, SpyNet's flows within 5e-6 px [1.4e-6 px
of flows up to 0.88 px]; the loss primitives within 1e-6.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgldvsr_tpu.flow.spynet import SpyNet as JSpyNet
from mgldvsr_tpu.io import ckpt_convert
from mgldvsr_tpu.models.discriminator import NLayerDiscriminator as JDisc
from mgldvsr_tpu.models.lpips import LPIPS as JLPIPS
from mgldvsr_tpu.train import losses as jlosses
from mgldvsr_tpu.train import stage2 as jstage2
from mgldvsr_tpu_torch.flow.spynet import SpyNet
from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline
from mgldvsr_tpu_torch.io import from_jax
from mgldvsr_tpu_torch.io.init_weights import init_pipeline_weights, jitter_weights
from mgldvsr_tpu_torch.models.discriminator import NLayerDiscriminator
from mgldvsr_tpu_torch.models.lpips import LPIPS
from mgldvsr_tpu_torch.models.vae import VideoAutoencoderKLResi
from mgldvsr_tpu_torch.train import losses
from mgldvsr_tpu_torch.train import stage2 as pstage2
from tests.test_pipeline import tiny_config
from tests.test_torch_models import numpy_tree, port_config

torch.set_num_threads(1)
T, SIZE = 3, 32


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _randn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _nchw(a):
    return _t(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _calm_spynet(tree):
    """SpyNet's last conv of each level scaled by 1e-2 (random flows would
    mark every pixel occluded)."""
    tree = jax.tree_util.tree_map(np.array, tree)
    for name, level in tree["params"].items():
        level["conv4"] = {k: v * 1e-2 for k, v in level["conv4"].items()}
    return tree


# ---------------------------------------------------------------------------
# the JAX reference run
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref():
    jcfg = tiny_config(num_frames=T, ddpm_steps=2)
    cfg = port_config(jcfg)
    pipe = MGLDVSRPipeline(cfg, device="cpu")
    init_pipeline_weights(pipe, 0)
    jitter_weights(pipe, 0.02, 0)
    v = jcfg.vae
    sd = {k: t.numpy() for k, t in pipe.vae.state_dict().items()}
    jvae = ckpt_convert.convert_autoencoder(
        sd, prefix="", video=True, fusion=True, ch_mult=v.ch_mult,
        num_res_blocks=v.num_res_blocks, attn_resolutions=v.attn_resolutions,
        resolution=v.resolution)
    jvae = jax.tree_util.tree_map(jnp.asarray, jvae)
    s2cfg = dict(num_frames=T, grad_accum=2, disc_start=0)
    jtr = jstage2.Stage2Trainer(jcfg.vae, jstage2.Stage2Config(**s2cfg))
    state0 = jtr.init_state(jax.random.PRNGKey(0), SIZE, SIZE, vae_params=jvae)
    state0 = state0._replace(aux={**state0.aux, "spynet": jax.tree_util.tree_map(
        jnp.asarray, _calm_spynet(state0.aux["spynet"]))})
    lq, gt = _rand(T, SIZE, SIZE, 3, seed=1), _rand(T, SIZE, SIZE, 3, seed=2)
    lat = _randn(T, SIZE // 8, SIZE // 8, 4, seed=3)
    step = jax.jit(jtr.train_step)
    key = jax.random.PRNGKey(1)
    state1, m1 = step(state0, jnp.asarray(lq), jnp.asarray(gt), jnp.asarray(lat), key)
    state2, m2 = step(state1, jnp.asarray(lq), jnp.asarray(gt), jnp.asarray(lat), key)
    get = jax.device_get
    return dict(cfg=cfg, s2cfg=s2cfg, data=(lq, gt, lat), states=[get(state0), get(state1),
                get(state2)], metrics=[get(m1), get(m2)])


def _port(ref, **over):
    vae = VideoAutoencoderKLResi(ref["cfg"].vae)
    tr = pstage2.Stage2Trainer(vae, pstage2.Stage2Config(**{**ref["s2cfg"], **over}))
    return tr, from_jax.stage2_state_from_jax(ref["states"][0], tr)


def _snap(state, metrics):
    """Copies of what the tests read (the state's tensors change in place)."""
    def copy(tree):
        if isinstance(tree, torch.Tensor):
            return tree.detach().clone()
        if isinstance(tree, dict):
            return {k: copy(v) for k, v in tree.items()}
        return tree

    return dict(trainable=copy(state.trainable), logvar=copy(state.logvar),
                disc=copy(state.disc), opt_g=copy(state.opt_g), opt_d=copy(state.opt_d),
                step=state.step, metrics={k: float(v) for k, v in metrics.items()})


def _run_port(ref, lat=None):
    """Two micro-steps of the port from JAX's start state: snapshots after
    each."""
    lq, gt, lat0 = ref["data"]
    lat = lat0 if lat is None else lat
    tr, state = _port(ref)
    out = [_snap(state, {})]
    for _ in range(2):
        state, metrics = tr.train_step(state, _t(lq), _t(gt), _t(lat))
        out.append(_snap(state, metrics))
    return out


@pytest.fixture(scope="module")
def port(ref):
    return _run_port(ref)


@pytest.fixture(scope="module")
def witness(ref):
    """The port with the latents moved by 1e-6 relative (see the module
    docstring)."""
    lat = ref["data"][2]
    rs = np.random.RandomState(1)
    return _run_port(ref, lat * (1 + 1e-6 * rs.randn(*lat.shape).astype(np.float32)))


def _gen_names(pair, ref):
    """A JAX (trainable tree, logvar) pair -> port tensors with "logvar"."""
    tree, logvar = pair
    out = from_jax._vae_trainable_tensors(numpy_tree(tree), ref["states"][0].gen_frozen,
                                          ref["cfg"].vae)
    out["logvar"] = torch.tensor(float(np.asarray(logvar)))
    return out


def _disc_names(tree, ref):
    sd = from_jax.discriminator_state_dict(
        {"params": numpy_tree(tree), "batch_stats": ref["states"][0].disc["batch_stats"]})
    return {k: v for k, v in sd.items() if "running" not in k}


def _assert_leaves_close(got, want, rel, floor=0.0, witness=None):
    """Each leaf within ``rel`` of its max |want| plus 1e-6 of the largest
    (or ``floor``), or within 1.5x the witness's distance from ``got``."""
    top = max(float(w.abs().max()) for w in want.values())
    assert set(got) == set(want)
    for k, w in want.items():
        tol = max(rel * float(w.abs().max()) + 1e-6 * top, floor)
        if witness is not None:
            tol = max(tol, 1.5 * float((witness[k] - got[k]).abs().max()))
        err = float((got[k].float() - w).abs().max())
        assert err <= tol, (k, err, tol)


METRICS = ("loss_g", "nll_loss", "rec_loss", "temp_loss", "g_loss", "d_weight", "loss_d",
           "logits_real", "logits_fake")


def test_trainable_set_is_the_image_of_jax(ref):
    """The port's trainables are what from_jax makes of JAX's trainable
    leaves: the fusion layers, and every parameter of the temporal mixing
    (conv and blend scalar), nothing of the encoder."""
    tr, state = _port(ref)
    jtrain = ref["states"][0].gen_trainable
    want = set(from_jax._vae_trainable_tensors(jtrain, ref["states"][0].gen_frozen,
                                               ref["cfg"].vae))
    assert set(state.trainable) == want
    assert len(want) == len(jax.tree_util.tree_leaves(jtrain))
    assert "decoder.temporal_mixing.temporal_alpha" in want
    assert "decoder.up.0.temporal_mixing.1.temporal_conv.weight" in want
    assert any(k.startswith("decoder.fusion_layer_2.") for k in want)
    assert all(k.startswith("decoder.") for k in want)
    assert pstage2.LAST_LAYER in state.frozen
    assert set(state.trainable) | set(state.frozen) == {k for k, _ in tr.vae.named_parameters()}


@pytest.mark.parametrize("micro_step", [1, 2])
def test_metrics_match_jax(ref, port, micro_step):
    got, want = port[micro_step]["metrics"], ref["metrics"][micro_step - 1]
    scale = abs(float(want["logits_real"])) + abs(float(want["logits_fake"]))
    for name in METRICS:
        w = float(want[name])
        floor = scale if name in ("g_loss", "logits_fake", "logits_real") else abs(w)
        assert abs(got[name] - w) <= 1e-5 * max(abs(w), floor), (name, got[name], w)
    assert got["temp_loss"] > 0 and got["d_weight"] > 0


def test_generator_gradient_matches_jax(ref, port):
    """Micro-step 1's gradient of every trainable and of logvar (the
    accumulator), and no update before the accumulation boundary."""
    _assert_leaves_close(port[1]["opt_g"]["acc"], _gen_names(ref["states"][1].opt_g.acc_grads,
                                                             ref), 1e-4)
    assert all(torch.equal(port[0]["trainable"][k], v) for k, v in port[1]["trainable"].items())
    assert port[1]["opt_g"]["mini_step"] == int(ref["states"][1].opt_g.mini_step) == 1


def test_discriminator_gradient_matches_jax(ref, port, witness):
    want = _disc_names(ref["states"][1].opt_d.acc_grads, ref)
    got = port[1]["opt_d"]["acc"]
    # the witness crosses the kink that JAX's reconstruction crosses
    jump = max(float((witness[1]["opt_d"]["acc"][k] - got[k]).abs().max())
               / float(w.abs().max()) for k, w in want.items())
    assert jump > 1e-2
    _assert_leaves_close(got, want, 1e-4, witness=witness[1]["opt_d"]["acc"])


@pytest.mark.parametrize("micro_step", [1, 2])
def test_running_statistics_match_jax(ref, port, micro_step):
    """Two training passes a micro-step, the second seeing the statistics
    the first moved."""
    want = from_jax.discriminator_state_dict(numpy_tree(ref["states"][micro_step].disc))
    for k, w in want.items():
        if "running" in k:
            got = port[micro_step]["disc"][k]
            assert float((got - w).abs().max()) <= 1e-6, k
            assert not torch.equal(got, port[micro_step - 1]["disc"][k]), k


def test_update_matches_jax(ref, port, witness):
    """After micro-step 2 (the update): the trainables, logvar and the
    discriminator's parameters; both Adam states and their counts."""
    j2 = ref["states"][2]
    p2, w2 = port[2], witness[2]
    lr = 5e-5
    got = {**p2["trainable"], "logvar": p2["logvar"]}
    want = _gen_names((j2.gen_trainable, j2.logvar), ref)
    for k, w in want.items():
        assert float((got[k] - w).abs().max()) <= 0.1 * lr, k
    assert sum(not torch.equal(port[0]["trainable"][k], v)
               for k, v in p2["trainable"].items()) == len(want) - 1
    params = {k: v for k, v in p2["disc"].items() if "running" not in k}
    _assert_leaves_close(params, _disc_names(j2.disc["params"], ref), 0.0, floor=1e-3 * lr,
                         witness={k: w2["disc"][k] for k in params})
    adam_g = from_jax._find(j2.opt_g, ("count", "mu", "nu"))
    adam_d = from_jax._find(j2.opt_d, ("count", "mu", "nu"))
    assert p2["opt_g"]["count"] == p2["opt_d"]["count"] == int(adam_g.count) == 1
    assert int(adam_d.count) == 1 and p2["step"] == int(j2.step) == 2
    _assert_leaves_close(p2["opt_g"]["mu"], _gen_names(adam_g.mu, ref), 1e-4)
    _assert_leaves_close(p2["opt_g"]["nu"], _gen_names(adam_g.nu, ref), 1e-4)
    _assert_leaves_close(p2["opt_d"]["mu"], _disc_names(adam_d.mu, ref), 1e-4,
                         witness=w2["opt_d"]["mu"])
    _assert_leaves_close(p2["opt_d"]["nu"], _disc_names(adam_d.nu, ref), 1e-4,
                         witness=w2["opt_d"]["nu"])


def test_temp_loss_has_no_gradient_in_the_reconstruction(ref):
    """The generator calls swc_loss(gt, recon): the warped frames are the
    GT's and the reconstruction enters only through the detached Sobel
    weight, so d temp / d recon is exactly zero, in the port (no graph at
    all) and in the JAX package."""
    lq, gt, lat = ref["data"]
    tr, _ = _port(ref)
    flows, occs = tr.frozen_flows(_t(gt))
    recon = _t(_randn(T, SIZE, SIZE, 3, seed=9)).requires_grad_(True)
    temp = losses.swc_loss(_t(gt) * 2 - 1, recon, T, flows, occs)
    assert float(temp) > 0 and not temp.requires_grad
    jflows = tuple(jnp.asarray(f.numpy()) for f in flows)
    joccs = tuple(jnp.asarray(o.numpy()) for o in occs)
    g = jax.grad(lambda r: jlosses.swc_loss(jnp.asarray(gt) * 2 - 1, r, T, jflows, joccs))(
        jnp.asarray(recon.detach().numpy()))
    assert not np.asarray(g).any()


def test_discriminator_warmup_gives_zero_gradient_and_counts_advance(ref):
    """Before disc_start: the discriminator's parameters stay (Adam on a
    zero gradient moves nothing), its running statistics move, and both
    MultiSteps counters and Adam's count advance, as optax's do; the
    generator's d_weight factor is 0 (loss_g is the weighted loss)."""
    tr, state = _port(ref, disc_start=5)
    params0 = {k: v.clone() for k, v in tr.disc_params(state.disc).items()}
    stats0 = {k: v.clone() for k, v in state.disc.items() if "running" in k}
    lq, gt, lat = (_t(a) for a in ref["data"])
    for _ in range(2):
        state, m = tr.train_step(state, lq, gt, lat)
        assert float(m["loss_d"]) == 0.0
    assert state.opt_d["count"] == 1 and state.opt_d["gradient_step"] == 1
    assert state.opt_d["mini_step"] == 0
    assert all(torch.equal(v, state.disc[k]) for k, v in params0.items())
    assert all(not torch.equal(v, state.disc[k]) for k, v in stats0.items())
    assert all(not m_.any() for m_ in state.opt_d["mu"].values())
    want = float(m["nll_loss"]) + 0.5 * float(m["temp_loss"])
    assert float(m["loss_g"]) >= want


def test_use_checkpoint_matches_plain(ref):
    """Recomputed decoder blocks give the same micro-step gradient."""
    accs = []
    for remat in (False, True):
        cfg = dataclasses.replace(ref["cfg"].vae, use_checkpoint=remat)
        tr = pstage2.Stage2Trainer(VideoAutoencoderKLResi(cfg),
                                   pstage2.Stage2Config(**ref["s2cfg"]))
        state = from_jax.stage2_state_from_jax(ref["states"][0], tr)
        state, _ = tr.train_step(state, *(_t(a) for a in ref["data"]))
        accs.append(state.opt_g["acc"])
    for k, v in accs[0].items():
        assert torch.allclose(v, accs[1][k], rtol=0, atol=1e-7 * float(v.abs().max()) + 1e-12), k


# ---------------------------------------------------------------------------
# the loss networks and the converters
# ---------------------------------------------------------------------------


def test_lpips_matches_jax():
    a = jnp.asarray(_rand(2, SIZE, SIZE, 3, seed=4) * 2 - 1)
    b = jnp.asarray(_rand(2, SIZE, SIZE, 3, seed=5) * 2 - 1)
    jl = JLPIPS()
    params = jl.init(jax.random.PRNGKey(3), a, b)
    want = np.asarray(jl.apply(params, a, b))
    net = LPIPS()
    net.load_state_dict(from_jax.lpips_state_dict(numpy_tree(params)), strict=True)
    got = net(_nchw(a), _nchw(b)).numpy()
    assert got.shape == (2,)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("train", [False, True])
def test_discriminator_matches_jax(train):
    """Both modes; in training, the running statistics after two passes."""
    x1 = jnp.asarray(_rand(3, SIZE, SIZE, 3, seed=6) * 2 - 1)
    x2 = jnp.asarray(_randn(3, SIZE, SIZE, 3, seed=7))
    jd = JDisc()
    variables = jax.tree_util.tree_map(np.array, jd.init(jax.random.PRNGKey(4), x1))
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda v: v + 0.1 * np.random.RandomState(8).rand(*v.shape).astype(np.float32),
        variables["batch_stats"])
    net = NLayerDiscriminator()
    net.load_state_dict(from_jax.discriminator_state_dict(variables), strict=True)
    outs = []
    for x in (x1, x2):
        if train:
            y, new = jd.apply(variables, x, train=True, mutable=["batch_stats"])
            variables = {"params": variables["params"], **jax.device_get(new)}
        else:
            y = jd.apply(variables, x, train=False)
        got = net(_nchw(x), train=train).detach().numpy().transpose(0, 2, 3, 1)
        want = np.asarray(y)
        assert got.shape == want.shape == (3, SIZE // 8 - 2, SIZE // 8 - 2, 1)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        outs.append(got)
    sd = from_jax.discriminator_state_dict(numpy_tree(variables))
    for k, v in net.state_dict().items():
        assert float((v - sd[k]).abs().max()) <= 1e-6, k


def test_spynet_matches_jax():
    """32x32 frames through all 6 levels (the coarsest flow at 1x1)."""
    ref_f = jnp.asarray(_rand(2, SIZE, SIZE, 3, seed=10))
    supp = jnp.asarray(_rand(2, SIZE, SIZE, 3, seed=11))
    js = JSpyNet()
    params = numpy_tree(js.init(jax.random.PRNGKey(5), ref_f, supp))
    want = np.asarray(js.apply(params, ref_f, supp))
    net = SpyNet()
    net.load_state_dict(from_jax.spynet_state_dict(params), strict=True)
    got = net(_t(np.asarray(ref_f)), _t(np.asarray(supp))).numpy()
    assert got.shape == want.shape == (2, SIZE, SIZE, 2)
    assert np.abs(want).max() > 0.5
    assert np.abs(got - want).max() <= 5e-6


def test_loss_primitives_match_jax():
    x, y = _randn(6, 9, 7, 3, seed=12), _randn(6, 9, 7, 3, seed=13)
    assert np.abs(losses.sobel_magnitude(_t(x)).numpy()
                  - np.asarray(jlosses.sobel_magnitude(jnp.asarray(x)))).max() <= 1e-6
    assert np.abs(losses.l1_diff(_t(x), _t(y), 3).numpy()
                  - np.asarray(jlosses.l1_diff(jnp.asarray(x), jnp.asarray(y), 3))).max() <= 1e-6
    rs = np.random.RandomState(14)
    flows = tuple(rs.randn(2, 2, 9, 7, 2).astype(np.float32) * 2 for _ in range(2))
    occs = tuple((rs.rand(2, 2, 9, 7, 1) > 0.6).astype(np.float32) for _ in range(2))
    got = float(losses.swc_loss(_t(x), _t(y), 3, tuple(map(_t, flows)), tuple(map(_t, occs))))
    want = float(jlosses.swc_loss(jnp.asarray(x), jnp.asarray(y), 3,
                                  tuple(map(jnp.asarray, flows)), tuple(map(jnp.asarray, occs))))
    assert abs(got - want) <= 1e-6 * abs(want)
    lr_, lf_ = _randn(2, 1, 4, 4, seed=15), _randn(2, 1, 4, 4, seed=16)
    for pf, jf in ((losses.hinge_d_loss, jlosses.hinge_d_loss),
                   (losses.vanilla_d_loss, jlosses.vanilla_d_loss)):
        assert abs(float(pf(_t(lr_), _t(lf_))) - float(jf(jnp.asarray(lr_),
                                                          jnp.asarray(lf_)))) <= 1e-6
    for step in (0, 500, 501, 900):
        assert losses.adopt_weight(1.0, step, 501) == float(jlosses.adopt_weight(1.0, step, 501))
    for a, b in ((3.0, 0.5), (1e9, 1e-3), (0.0, 2.0)):
        want = float(jlosses.adaptive_d_weight(jnp.float32(a), jnp.float32(b), 0.025))
        got = float(losses.adaptive_d_weight(torch.tensor(a), torch.tensor(b), 0.025))
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-6)


def _swc_loss_two_loops(hr, gt, t, flows, occs, w=3.0):
    """The swc loss as the reference's loops write it, one warp an
    iteration, each loop's last warp unread."""
    fwd_flows, bwd_flows = flows
    fwd_occs, bwd_occs = occs
    b = hr.shape[0] // t
    weight = 1.0 + w * losses.sobel_magnitude(gt).detach()
    hrv = hr.reshape(b, t, *hr.shape[1:])
    wv = weight.reshape(b, t, *weight.shape[1:])
    loss = torch.zeros((), dtype=torch.float32)
    prev = torch.zeros_like(hrv[:, 0])
    for i in range(t - 2, -1, -1):
        m = wv[:, i] * (1.0 - fwd_occs[:, i])
        loss = loss + (m * prev - m * hrv[:, i]).abs().mean()
        prev = losses.warp_frames(hrv[:, i], fwd_flows[:, i])
    prev = torch.zeros_like(hrv[:, 0])
    for i in range(1, t):
        m = wv[:, i] * (1.0 - bwd_occs[:, i - 1])
        loss = loss + (m * prev - m * hrv[:, i]).abs().mean()
        prev = losses.warp_frames(hrv[:, i], bwd_flows[:, i - 1])
    return loss


@pytest.mark.parametrize("t", [3, 5])
def test_swc_loss_warps_in_one_call(monkeypatch, t):
    """One warp call of the 2 (t-2) b frames the loss reads; the loss equals
    the two-loop form bit for bit and the JAX package's within 1e-6."""
    b, h, w = 2, 9, 7
    x, y = _randn(b * t, h, w, 3, seed=20 + t), _randn(b * t, h, w, 3, seed=30 + t)
    rs = np.random.RandomState(t)
    flows = tuple(rs.randn(b, t - 1, h, w, 2).astype(np.float32) * 2 for _ in range(2))
    occs = tuple((rs.rand(b, t - 1, h, w, 1) > 0.6).astype(np.float32) for _ in range(2))
    tflows, toccs = tuple(map(_t, flows)), tuple(map(_t, occs))
    calls = []
    warp = losses.warp_frames

    def counted(frames, flow):
        calls.append(frames.shape[0])
        return warp(frames, flow)

    monkeypatch.setattr(losses, "warp_frames", counted)
    got = losses.swc_loss(_t(x), _t(y), t, tflows, toccs)
    assert calls == [2 * (t - 2) * b]
    old = _swc_loss_two_loops(_t(x), _t(y), t, tflows, toccs)
    assert calls[1:] == [b] * (2 * (t - 1)) and torch.equal(got, old)
    want = float(jlosses.swc_loss(jnp.asarray(x), jnp.asarray(y), t,
                                  tuple(map(jnp.asarray, flows)), tuple(map(jnp.asarray, occs))))
    assert abs(float(got) - want) <= 1e-6 * abs(want)


def _seeded(module, seed):
    from mgldvsr_tpu_torch.io.init_weights import init_module_weights

    init_module_weights(module, torch.Generator().manual_seed(seed))
    for v in module.state_dict().values():
        v.add_(0.01 * torch.randn(v.shape, generator=torch.Generator().manual_seed(seed + 1)))
    return module


@pytest.mark.parametrize("name", ["lpips", "discriminator", "spynet"])
def test_converters_round_trip_bit_for_bit(name):
    """port state dict -> the JAX converter -> from_jax gives back every
    tensor bit for bit, and the JAX tree survives the other way round."""
    module, convert, back = {
        "lpips": (LPIPS, ckpt_convert.convert_lpips, from_jax.lpips_state_dict),
        "discriminator": (NLayerDiscriminator, ckpt_convert.convert_discriminator,
                          from_jax.discriminator_state_dict),
        "spynet": (SpyNet, ckpt_convert.convert_spynet, from_jax.spynet_state_dict),
    }[name]
    sd = _seeded(module(), 3).state_dict()
    tree = convert({k: v.numpy() for k, v in sd.items()}, prefix="")
    again = back(tree)
    assert set(again) == set(sd)
    for k, v in sd.items():
        assert torch.equal(again[k], v), k
    tree2 = convert({k: v.numpy() for k, v in again.items()}, prefix="")
    flat1, flat2 = jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(tree2)
    assert len(flat1) == len(flat2) and all(np.array_equal(a, b) for a, b in zip(flat1, flat2))


def test_autoencoder_dataset_reads_windows(tmp_path):
    """REDSAutoencoderDataset: windows aligned to num_frame, RGB frames in
    [0, 1], the latents as stored, against the JAX dataset (cv2 there)."""
    from mgldvsr_tpu.data.datasets import REDSAutoencoderDataset as JDataset
    from mgldvsr_tpu_torch.data.datasets import REDSAutoencoderDataset
    from mgldvsr_tpu_torch.io.frames import write_frame

    rs = np.random.RandomState(17)
    for root in ("gt", "lq", "lat"):
        os.makedirs(tmp_path / root / "007")
    for i in range(7):
        name = f"{i:08d}"
        write_frame(str(tmp_path / "gt" / "007" / f"{name}.png"),
                    rs.randint(0, 256, (16, 12, 3)).astype(np.uint8))
        write_frame(str(tmp_path / "lq" / "007" / f"{name}.png"),
                    rs.randint(0, 256, (4, 3, 3)).astype(np.uint8))
        np.save(str(tmp_path / "lat" / "007" / f"{name}.npy"), rs.randn(2, 2, 4).astype(np.float32))
    args = (str(tmp_path / "gt"), str(tmp_path / "lq"), str(tmp_path / "lat"))
    ds, jds = REDSAutoencoderDataset(*args, num_frame=3), JDataset(*args, num_frame=3)
    assert len(ds) == len(jds) == 2
    assert len(REDSAutoencoderDataset(*args, num_frame=3, load_fix_indices_only=False)) == 5
    for idx in range(2):
        got, want = ds[idx], jds[idx]
        for key in ("gts", "lqs", "lts"):
            assert got[key].shape == want[key].shape and np.array_equal(got[key], want[key]), key
    assert ds[1]["gts"].shape == (3, 16, 12, 3)
