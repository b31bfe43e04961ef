"""Stage-1 training: the port's trainer, optimiser, EMA and checkpoints
against the JAX package's on the CPU, at tiny widths, float32.

One JAX reference run per module: the JAX trainer (grad_accum 2) takes two
micro-steps from a state whose parameters are the port's seeded weights
converted by the JAX package's own converters and jittered by 0.02·N(0,1)
(the JAX trainer tests' jitter; seeded weights leave the temporal blend
scalars at zero and the temporal convs without gradient). The port starts
from that state (``io.from_jax.train_state_from_jax``) and takes the same
micro-steps with the draws rebuilt from the same keys.

Tolerances, measured on this tiny model: the loss within 1e-5 relative
(measured 8e-7). A gradient leaf within 3e-4 of its own max |g| plus 1e-6
of the largest |g| of any leaf. The worst leaf against JAX,
``structcond.input_blocks.2.0.in_layers.0.bias``, stands at 2.3e-4 of its
max, above the 1e-4 first aimed at; float32 rounding alone reaches that
far: the port against itself with the LQ clip moved by one ulp moves its
worst leaf (``structcond.input_blocks.5.0.in_layers.2.weight``) by 1.8e-4
of its max (``test_gradient_limit_witness``). The leaves whose exact
gradient is zero (a bias that a GroupNorm cancels) hold only rounding
noise, measured under 6e-8 absolute. The optimiser driven by the same gradients on both
sides: 1e-7, or one ulp of the value in its stored dtype (XLA fuses some of
optax's products and sums into fused multiply-adds); with a bf16 first
moment, parameters and shadows within 2·lr·2^-8 more.
"""
import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mgldvsr_tpu.infer.pipeline import MGLDVSRPipeline as JaxPipeline
from mgldvsr_tpu.io import ckpt_convert
from mgldvsr_tpu.train import trainer as jtrainer
from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline
from mgldvsr_tpu_torch.io import from_jax
from mgldvsr_tpu_torch.io.checkpoint import CheckpointManager, install_signal_save
from mgldvsr_tpu_torch.io.init_weights import init_pipeline_weights
from mgldvsr_tpu_torch.train import optim
from mgldvsr_tpu_torch.train import trainer as ptrainer
from tests.test_pipeline import tiny_config
from tests.test_torch_models import numpy_tree, port_config
from tests.test_train import _jitter

torch.set_num_threads(1)
N, SIZE = 5, 32
LAT = (N, SIZE // 8, SIZE // 8, 4)


def _clip(seed):
    return np.random.RandomState(seed).rand(N, SIZE, SIZE, 3).astype(np.float32)


def _jax_params(jcfg, cfg, seed=0):
    """The port's seeded weights as a JAX parameter tree (the JAX package's
    converters), jittered on the JAX side."""
    pipe = MGLDVSRPipeline(cfg, device="cpu")
    init_pipeline_weights(pipe, seed)
    sd = {name: {k: v.numpy() for k, v in t.state_dict().items()}
          for name, t in pipe.towers().items()}
    u, s, v = jcfg.unet, jcfg.structcond, jcfg.vae
    params = {
        "unet": ckpt_convert.convert_unet(
            sd["unet"], prefix="", channel_mult=u.channel_mult, num_res_blocks=u.num_res_blocks,
            attention_resolutions=u.attention_resolutions,
            transformer_depth=u.transformer_depth),
        "structcond": ckpt_convert.convert_structcond(
            sd["structcond"], prefix="", channel_mult=s.channel_mult,
            model_channels=s.model_channels, num_res_blocks=s.num_res_blocks,
            attention_resolutions=s.attention_resolutions, num_heads=s.num_heads),
        "vae": ckpt_convert.convert_autoencoder(
            sd["vae"], prefix="", video=True, fusion=True, ch_mult=v.ch_mult,
            num_res_blocks=v.num_res_blocks, attn_resolutions=v.attn_resolutions,
            resolution=v.resolution),
        "clip": ckpt_convert.convert_openclip_text(
            sd["clip"], prefix="", layers=jcfg.clip.layers,
            penultimate=jcfg.clip.layer == "penultimate"),
        "raft": ckpt_convert.convert_raft(sd["raft"], prefix=""),
    }
    params = jax.tree_util.tree_map(jnp.asarray, params)
    return _jitter(params, jax.random.PRNGKey(99))


def _draws(key):
    """The JAX trainer's four draws from ``key``, as a port Stage1Draws."""
    k1, k2, kt, kn = jax.random.split(key, 4)
    arrays = (jax.random.normal(k1, LAT), jax.random.normal(k2, LAT),
              jax.random.randint(kt, (N,), 0, 1000, dtype=jnp.int32), jax.random.normal(kn, LAT))
    return ptrainer.Stage1Draws(*[torch.from_numpy(np.array(a)) for a in arrays])


@pytest.fixture(scope="module")
def ref():
    """The JAX reference: the state before, after one and after two
    micro-steps (numpy leaves), with their metrics."""
    jcfg = tiny_config(ddpm_steps=2)
    cfg = port_config(jcfg)
    jpipe = JaxPipeline(jcfg)
    jtr = jtrainer.Stage1Trainer(jpipe, jtrainer.Stage1Config(grad_accum=2))
    state0 = jtr.init_state(_jax_params(jcfg, cfg))
    step = jax.jit(jtr.train_step)
    lq, gt = jnp.asarray(_clip(0)), jnp.asarray(_clip(1))
    state1, m1 = step(state0, lq, gt, jax.random.PRNGKey(2))
    state2, m2 = step(state1, lq, gt, jax.random.PRNGKey(3))
    get = jax.device_get
    return dict(cfg=cfg, states=[get(state0), get(state1), get(state2)],
                metrics=[get(m1), get(m2)])


def _port(ref, **cfg_kw):
    pipe = MGLDVSRPipeline(ref["cfg"], device="cpu")
    tr = ptrainer.Stage1Trainer(pipe, ptrainer.Stage1Config(grad_accum=2, **cfg_kw))
    return tr, from_jax.train_state_from_jax(ref["states"][0], tr)


def _port_names(tree, ref):
    return from_jax._trainable_tensors(numpy_tree(tree), ref["states"][0].frozen, ref["cfg"])


def _leaf_spread(got, base, want):
    """Each leaf's max |got - base| over the max |g| of JAX's leaf, for the
    leaves whose max |g| is at least 1e-4 of the largest (the others' exact
    gradient is zero)."""
    top = max(float(w.abs().max()) for w in want.values())
    return {k: float((got[k] - base[k]).abs().max()) / float(w.abs().max())
            for k, w in want.items() if float(w.abs().max()) >= 1e-4 * top}


def _acc_after_one_step(ref, lq):
    """The accumulator (micro-step 1's gradient) of the port's first
    micro-step on ``lq``, from JAX's start state and draws."""
    tr, state = _port(ref)
    state, _ = tr.train_step(state, torch.from_numpy(lq), torch.from_numpy(_clip(1)),
                             draws=_draws(jax.random.PRNGKey(2)))
    return state.opt_state["acc"]


def _assert_grads_close(got, want):
    top = max(float(w.abs().max()) for w in want.values())
    assert set(got) == set(want)
    for k, w in want.items():
        tol = 3e-4 * float(w.abs().max()) + 1e-6 * top
        err = float((got[k] - w).abs().max())
        assert err <= tol, (k, err, tol)


def test_trainable_set_is_the_image_of_jax(ref):
    """The port's trainables are exactly what from_jax makes of JAX's
    trainable leaves: SPADE, the temporal convs (not their blend scalars,
    not the temporal attention) and all of the struct-cond encoder."""
    tr, state = _port(ref)
    want = set(_port_names(ref["states"][0].trainable, ref))
    assert set(state.trainable) == want
    n_jax = len(jax.tree_util.tree_leaves(ref["states"][0].trainable))
    assert len(want) == n_jax
    names = set(state.trainable)
    assert "unet.middle_block.1.temporal_conv.weight" in names
    assert "unet.middle_block.1.temporal_alpha" not in names
    assert not any(n.startswith("unet.middle_block.3.") for n in names)
    assert all(n.startswith("structcond.") or ".spade." in n or ".temporal_conv." in n
               for n in names)
    full = set(state.trainable) | set(state.frozen)
    assert {n for n, _ in ptrainer.named_tower_parameters(tr.pipe)} == full


def test_p_losses_matches_jax(ref):
    """The loss of the injected draws, from the port's p_losses on encodes
    made with the same posterior noises, against the JAX step's loss."""
    tr, _ = _port(ref)
    d = _draws(jax.random.PRNGKey(2))
    pipe = tr.pipe
    z_lq, _ = pipe.encode(torch.from_numpy(_clip(0)) * 2 - 1, noise=d.lq_posterior)
    z_gt, _ = pipe.encode(torch.from_numpy(_clip(1)) * 2 - 1, noise=d.gt_posterior)
    ctx = pipe.embed_empty_prompt(N)
    with torch.no_grad():
        loss, metrics = tr.p_losses(z_gt, z_lq, ctx, d.t.long(), d.noise)
    want = float(ref["metrics"][0]["loss"])
    assert abs(float(loss) - want) <= 1e-5 * abs(want)
    assert abs(float(metrics["loss_simple"]) - float(ref["metrics"][0]["loss_simple"])) <= 1e-5 * abs(want)


def test_train_step_matches_jax(ref):
    """One micro-step at grad_accum 2: the loss, the gradient (the
    accumulator holds it after the first micro-step), no update yet, and the
    step count."""
    tr, state = _port(ref)
    before = {k: v.clone() for k, v in state.trainable.items()}
    state, metrics = tr.train_step(state, torch.from_numpy(_clip(0)), torch.from_numpy(_clip(1)),
                                   draws=_draws(jax.random.PRNGKey(2)))
    want = float(ref["metrics"][0]["loss"])
    assert abs(float(metrics["loss"]) - want) <= 1e-5 * abs(want)
    assert abs(float(metrics["grad_norm"]) - float(ref["metrics"][0]["grad_norm"])) <= 1e-4 * want
    jstate1 = ref["states"][1]
    acc = _port_names(jstate1.opt_state.acc_grads, ref)
    _assert_grads_close(state.opt_state["acc"], acc)
    assert state.step == int(jstate1.step) == 1
    assert state.opt_state["mini_step"] == int(jstate1.opt_state.mini_step) == 1
    assert all(torch.equal(before[k], v) for k, v in state.trainable.items())


def test_gradient_limit_witness(ref):
    """Why a gradient leaf is held to 3e-4 of its max |g|: the port against
    itself with every LQ pixel moved by one float32 ulp moves its worst leaf
    by more than 1e-4 of that leaf's max (measured 1.8e-4), and the port
    against JAX (measured 2.3e-4) stands within 3x of that reach."""
    lq = _clip(0)
    away = np.random.RandomState(7).choice([-1.0, 1.0], size=lq.shape).astype(np.float32)
    base = _acc_after_one_step(ref, lq)
    moved = _acc_after_one_step(ref, np.nextafter(lq, lq + away))
    want = _port_names(ref["states"][1].opt_state.acc_grads, ref)
    witness = max(_leaf_spread(moved, base, want).values())
    vs_jax = max(_leaf_spread(base, want, want).values())
    assert 1e-4 < witness <= 3e-4
    assert vs_jax <= 3 * witness


def _jax_grads(ref, k):
    """A gradient tree with JAX's leaf scales: micro-step 1's gradient,
    rescaled and perturbed per micro-step ``k``."""
    g = numpy_tree(ref["states"][1].opt_state.acc_grads)
    rs = np.random.RandomState(k)
    return jax.tree_util.tree_map(
        lambda a: (a * (1 + 0.25 * k) + 0.1 * np.abs(a).max() * rs.randn(*a.shape))
        .astype(np.float32), g)


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("max_grad_norm", [None, 0.05])
def test_optimiser_and_ema_match_optax(ref, mu_dtype, max_grad_norm):
    """MultiSteps(2) around [clip_by_global_norm ->] adamw, driven by the
    same gradients for 4 micro-steps (2 updates), then the EMA: parameters,
    both moments and the shadows within 1e-7, or one ulp of the value in
    its stored dtype where that is larger: XLA fuses some products and sums
    into one rounding, so a parameter near 1 (moved by ~5e-5) or a bf16
    moment may round to the neighbouring value; with a bf16 moment the
    parameters and shadows also within 2·lr·2^-8, what one bf16 ulp of the
    moment moves two updates by."""
    jcfg = jtrainer.Stage1Config(grad_accum=2, adam_mu_dtype=mu_dtype, max_grad_norm=max_grad_norm)
    jtr = jtrainer.Stage1Trainer(_Dummy(), jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, numpy_tree(ref["states"][0].trainable))
    opt = jtr.tx.init(params)
    ema = params

    @jax.jit
    def jstep(params, opt, ema, grads, n):
        upd, opt = jtr.tx.update(grads, opt, params)
        params = optax.apply_updates(params, upd)
        return params, opt, jtrainer.ema_update(ema, params, n, 0.9999)

    ocfg = optim.AdamWConfig(grad_accum=2, max_grad_norm=max_grad_norm,
                             mu_dtype=torch.bfloat16 if mu_dtype else None)
    p = _port_names(params, ref)
    pstate = optim.init_opt_state(p, ocfg)
    pema = {k: v.clone() for k, v in p.items()}
    for k in range(1, 5):
        g = _jax_grads(ref, k)
        params, opt, ema = jstep(params, opt, ema, jax.tree_util.tree_map(jnp.asarray, g),
                                 jnp.int32(k))
        changed = optim.step(_port_names(g, ref), pstate, p, ocfg)
        assert changed == (k % 2 == 0)
        ptrainer.ema_update(pema, p, k, 0.9999)
    adam = from_jax._find(jax.device_get(opt), ("count", "mu", "nu"))
    assert pstate["count"] == int(adam.count) == 2
    # a bf16 first moment that rounds the other way (one bf16 ulp, 2^-8 of
    # it) moves an Adam update of ~lr by up to lr·2^-8, in each of 2 updates
    moved = 2 * ocfg.learning_rate * 2.0 ** -8 if mu_dtype else 0.0
    for got, want, floor in ((p, params, 1e-7 + moved), (pema, ema, 1e-7 + moved),
                             (pstate["mu"], adam.mu, 1e-7), (pstate["nu"], adam.nu, 1e-7)):
        want = _port_names(want, ref)
        for name, w in want.items():
            # one ulp of the stored dtype: 2^16 float32 ulps for a bf16 moment
            scale = 2.0 ** 16 if got[name].dtype == torch.bfloat16 else 1.0
            w, g = w.numpy(), got[name].float().numpy()
            ulp = scale * np.spacing(np.maximum(np.abs(w), np.abs(g)))
            assert (np.abs(g - w) <= np.maximum(floor, ulp)).all(), (name, np.abs(g - w).max())
    if mu_dtype:
        assert all(m.dtype == torch.bfloat16 for m in pstate["mu"].values())


class _Dummy:
    """Stands in for the JAX pipeline: the optimiser needs none of it."""
    cfg = dataclasses.make_dataclass("C", [("timesteps", int, 1000)])()
    base_sched = None


def _tiny_trainer(ref, seed=0, **cfg_kw):
    """The tiny pipeline, seeded and jittered in torch, and its trainer."""
    from mgldvsr_tpu_torch.io.init_weights import jitter_weights

    pipe = MGLDVSRPipeline(dataclasses.replace(ref["cfg"]), device="cpu")
    init_pipeline_weights(pipe, seed)
    jitter_weights(pipe, 0.02, seed)
    return ptrainer.Stage1Trainer(pipe, ptrainer.Stage1Config(grad_accum=2, **cfg_kw))


def _run(tr, state, steps, start=0, seed=7):
    lq, gt = torch.from_numpy(_clip(0)), torch.from_numpy(_clip(1))
    for s in range(start, steps):
        gen = torch.Generator().manual_seed(seed * 1000 + s)
        state, _ = tr.train_step(state, lq, gt, gen)
    return state


def test_micro_steps_update_only_trainables_at_boundaries(ref):
    tr = _tiny_trainer(ref)
    state = tr.init_state()
    frozen0 = {k: v.clone() for k, v in state.frozen.items()}
    t0 = {k: v.clone() for k, v in state.trainable.items()}
    state = _run(tr, state, 1)
    assert all(torch.equal(t0[k], v) for k, v in state.trainable.items())
    state = _run(tr, state, 2, start=1)
    moved = sum(not torch.equal(t0[k], v) for k, v in state.trainable.items())
    assert moved > 0.9 * len(t0)
    assert all(torch.equal(frozen0[k], v) for k, v in state.frozen.items())
    assert any(not torch.equal(state.ema[k], v) for k, v in state.trainable.items())
    # the towers hold the masters (float32 here)
    for name, p in ptrainer.partition_params(tr.pipe)[0].items():
        assert torch.equal(p, state.trainable[name])


def test_use_checkpoint_matches_plain(ref):
    """Rematerialised res blocks and transformers give the same loss and
    gradients."""
    d = _draws(jax.random.PRNGKey(4))
    out = []
    for remat in (False, True):
        tr = _tiny_trainer(ref)
        cfg = tr.pipe.cfg
        tr.pipe.unet.cfg = dataclasses.replace(cfg.unet, use_checkpoint=remat)
        tr.pipe.structcond.cfg = dataclasses.replace(cfg.structcond, use_checkpoint=remat)
        tr.init_state()
        out.append(tr.loss_and_grads(torch.from_numpy(_clip(0)), torch.from_numpy(_clip(1)), d))
    (l0, _, g0), (l1, _, g1) = out
    assert float(l0) == float(l1)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=1e-7)


def test_save_resume_continue_is_bit_for_bit(ref, tmp_path):
    """4 micro-steps straight, against 2, a checkpoint, a fresh pipeline and
    trainer from the same seed, the restore, and 2 more."""
    tr = _tiny_trainer(ref)
    straight = _run(tr, tr.init_state(), 4)

    tr = _tiny_trainer(ref)
    state = _run(tr, tr.init_state(), 2)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.save(state.step, state)
    del tr, state
    tr = _tiny_trainer(ref)
    resumed = mgr.restore(template=tr.init_state())
    assert resumed.step == 2
    resumed = _run(tr, resumed, 4, start=2)
    for a, b in ((straight.trainable, resumed.trainable), (straight.ema, resumed.ema),
                 (straight.opt_state["mu"], resumed.opt_state["mu"]),
                 (straight.opt_state["nu"], resumed.opt_state["nu"]),
                 (straight.opt_state["acc"], resumed.opt_state["acc"])):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert straight.opt_state["count"] == resumed.opt_state["count"] == 2


def test_checkpoint_manager_keeps_and_picks(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2, save_interval_steps=2,
                            best_fn=lambda m: m["loss"], best_mode="min")
    losses = {2: 0.5, 4: 0.1, 6: 0.9, 8: 0.7}
    assert not mgr.save(1, {"x": torch.ones(2)}, metrics={"loss": 0.0})
    for s, loss in losses.items():
        assert mgr.save(s, {"x": torch.full((2,), float(s))}, metrics={"loss": loss})
    assert not mgr.save(8, {"x": torch.zeros(2)}, force=True)  # saved already
    assert mgr.all_steps() == [2, 4, 8]  # the two best and the newest
    assert mgr.best_step() == 4 and mgr.latest_step() == 8
    assert torch.equal(mgr.restore(4)["x"], torch.full((2,), 4.0))
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]
    plain = CheckpointManager(str(tmp_path / "plain"), max_to_keep=2)
    for s in range(1, 5):
        plain.save(s, {"s": s})
    assert plain.all_steps() == [3, 4] and plain.best_step() is None


def test_signal_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    current = [None]
    old = signal.getsignal(signal.SIGUSR1)
    try:
        install_signal_save(lambda: current[0], mgr)
        os.kill(os.getpid(), signal.SIGUSR1)  # in flight: deferred
        assert mgr.signal_pending and mgr.all_steps() == []
        current[0] = (7, {"w": torch.ones(1)})
        os.kill(os.getpid(), signal.SIGUSR1)
        assert mgr.all_steps() == [7]
    finally:
        signal.signal(signal.SIGUSR1, old)
