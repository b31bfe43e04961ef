"""The on-device degradations, the pair pool and BSRGAN against the JAX
package, on the CPU, float32, numpy-seeded inputs.

Tolerances. ``filter2d`` (one kernel and a kernel a sample), ``usm_sharp``
and both noise applies (given JAX's own draws): 1e-5. ``diff_jpeg``: the
scaled DCT coefficients within 1e-4; every 8x8 block whose quantised
coefficients agree gives pixels within 1e-5; a block whose rounding differs
must hold a coefficient within 1e-4 of a half-integer (``diff_round`` jumps
by 0.75 of a step there, so float32 rounding can send it either way), and
at most 0.1% of the blocks may differ. ``synthesize_lq`` at [2,64,64,3],
sf 4, three scale buckets, one case per scale mode (with JAX's draws): the
sharpened GT within 1e-5; the LQ pixels within 1e-5 or one 1/255 level (the
final rounding to levels), at most 0.1% of them a level apart. The pair
pool: bit for bit through the warm-up and three pops. BSRGAN: see its tests.
"""
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgldvsr_tpu.data.bsrgan as jbsrgan
from mgldvsr_tpu.data.pair_queue import TrainingPairQueue as JaxQueue
from mgldvsr_tpu.ops import diffjpeg as jjpeg
from mgldvsr_tpu.ops import img_process as jimg
from mgldvsr_tpu.train import synthesis as jsyn
from mgldvsr_tpu_torch.data import bsrgan, cv_ops
from mgldvsr_tpu_torch.data.pair_queue import TrainingPairQueue
from mgldvsr_tpu_torch.ops import diffjpeg, img_process
from mgldvsr_tpu_torch.train import synthesis

torch.set_num_threads(1)
N, H, W = 2, 64, 64


def _rand(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


# -- img_process ---------------------------------------------------------------


@pytest.mark.parametrize("per_sample", [False, True])
def test_filter2d_matches_jax(per_sample):
    img = _rand((N, 24, 20, 3), 0)
    rs = np.random.RandomState(1)
    kern = rs.rand(*((N, 7, 7) if per_sample else (7, 7))).astype(np.float32)
    kern /= kern.sum(axis=(-2, -1), keepdims=True)
    got = img_process.filter2d(_t(img), _t(kern))
    _close(got, jimg.filter2d(jnp.asarray(img), jnp.asarray(kern)), 1e-5)
    assert got.shape == img.shape


def test_usm_sharp_matches_jax():
    img = _rand((N, H, W, 3), 2)
    _close(img_process.usm_sharp(_t(img)), jimg.usm_sharp(jnp.asarray(img)), 1e-5)


def _jax_noise(key, shape, amount_range, gray_prob, gaussian):
    """The JAX package's draws of ``random_add_*_noise`` from ``key``."""
    k_s, k_g, k_n = jax.random.split(key, 3)
    n = shape[0]
    amount = jax.random.uniform(k_s, (n, 1, 1, 1), minval=amount_range[0],
                                maxval=amount_range[1])
    if gaussian:
        amount = amount / 255.0
    gray = (jax.random.uniform(k_g, (n, 1, 1, 1)) < gray_prob).astype(jnp.float32)
    field = jax.random.normal(k_n, shape, jnp.float32)
    return img_process.NoiseDraw(_t(amount).reshape(n), _t(gray).reshape(n), _t(field))


@pytest.mark.parametrize("gaussian", [True, False])
def test_noise_applies_match_jax_on_its_draws(gaussian):
    """Half the images gray (the key is chosen so), the other half colour."""
    img = _rand((4, 16, 16, 3), 3)
    key = jax.random.PRNGKey(7)
    rng = (1, 30) if gaussian else (0.05, 3.0)
    draw = _jax_noise(key, img.shape, rng, 0.5, gaussian)
    assert 0 < float(draw.gray.sum()) < 4
    if gaussian:
        want = jimg.random_add_gaussian_noise(key, jnp.asarray(img), rng, 0.5)
        got = img_process.add_gaussian_noise(_t(img), draw)
    else:
        want = jimg.random_add_poisson_noise(key, jnp.asarray(img), rng, 0.5)
        got = img_process.add_poisson_noise(_t(img), draw)
    _close(got, want, 1e-5)


def test_noise_draws_are_seeded_and_shaped():
    g = torch.Generator().manual_seed(0)
    a = img_process.draw_noise(g, (3, 8, 8, 3), (1, 30), 0.4, "cpu")
    b = img_process.draw_noise(torch.Generator().manual_seed(0), (3, 8, 8, 3), (1, 30), 0.4,
                               "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a.field.shape == (3, 8, 8, 3) and a.amount.shape == (3,)
    assert float(a.amount.min()) >= 1 / 255 and float(a.amount.max()) <= 30 / 255


# -- DiffJPEG ----------------------------------------------------------------


def _jax_coefficients(x, quality):
    """JAX's scaled coefficients (before the rounding) through its own
    helpers, as ``diff_jpeg`` computes them."""
    n, h, w, _ = x.shape
    factor = jnp.broadcast_to(jnp.atleast_1d(jjpeg.quality_to_factor(quality)),
                              (n,))[:, None, None, None]
    ycc = jjpeg.rgb_to_ycbcr(x * 255.0)

    def down(c):
        return c.reshape(n, h // 2, 2, w // 2, 2).mean(axis=(2, 4)) - 128.0

    planes = [ycc[..., 0] - 128.0, down(ycc[..., 1]), down(ycc[..., 2])]
    tables = (jjpeg._Y_TABLE, jjpeg._C_TABLE, jjpeg._C_TABLE)
    return [np.asarray(jjpeg._dct2d(jjpeg._to_blocks(p)) / (t[None, None] * factor))
            for p, t in zip(planes, tables)]


def assert_jpeg_close(got, want, coefs_got, coefs_want, h, w, pix_atol=1e-5):
    """The diff_jpeg limits of the module docstring, for [N,h,w,3] outputs
    and each side's scaled coefficients [N, blocks, 8, 8] (Y, Cb, Cr)."""
    got, want = np.asarray(got), np.asarray(want)
    differ = np.zeros(got.shape[:3], bool)
    n_blocks = n_diff = 0
    for plane, (cg, cw) in enumerate(zip(coefs_got, coefs_want)):
        cg, cw = np.asarray(cg), np.asarray(cw)
        np.testing.assert_allclose(cg, cw, atol=1e-4, rtol=0)
        flipped = (np.round(cg) != np.round(cw)).any(axis=(2, 3))
        n_blocks += flipped.size
        n_diff += int(flipped.sum())
        near = (np.abs(np.abs(cw - np.floor(cw)) - 0.5) < 1e-4).any(axis=(2, 3))
        assert (near | ~flipped).all(), "a block rounds apart without a coefficient at a half"
        px = 8 if plane == 0 else 16
        bw = (w // px)
        for i, b in zip(*np.nonzero(flipped)):
            r, c = divmod(int(b), bw)
            differ[i, r * px:(r + 1) * px, c * px:(c + 1) * px] = True
    assert n_diff <= 1e-3 * n_blocks, (n_diff, n_blocks)
    d = np.abs(got - want).max(axis=-1)
    assert (d[~differ] <= pix_atol).all(), float(d[~differ].max())
    return n_diff


def test_diff_jpeg_matches_jax():
    x = _rand((N, H, W, 3), 4)
    q = np.array([37.5, 81.25], np.float32)
    got = diffjpeg.diff_jpeg(_t(x), _t(q))
    want = jjpeg.diff_jpeg(jnp.asarray(x), jnp.asarray(q))
    assert_jpeg_close(got, want, diffjpeg.scaled_coefficients(_t(x), _t(q)),
                      _jax_coefficients(jnp.asarray(x), jnp.asarray(q)), H, W)
    # a scalar quality and the hard rounding
    got = diffjpeg.diff_jpeg(_t(x), 50.0, rounding=torch.round)
    want = jjpeg.diff_jpeg(jnp.asarray(x), 50.0, rounding=jnp.round)
    assert_jpeg_close(got, want, diffjpeg.scaled_coefficients(_t(x), 50.0),
                      _jax_coefficients(jnp.asarray(x), 50.0), H, W)


def test_diff_jpeg_is_differentiable_and_lossy():
    x = torch.from_numpy(_rand((1, 32, 32, 3), 5)).requires_grad_(True)
    diffjpeg.diff_jpeg(x, 50).sum().backward()
    assert torch.isfinite(x.grad).all() and float(x.grad.abs().sum()) > 0
    with torch.no_grad():
        assert float((diffjpeg.diff_jpeg(x, 10) - x).abs().mean()) > float(
            (diffjpeg.diff_jpeg(x, 95) - x).abs().mean())
    for q, f in ((50.0, 1.0), (25.0, 2.0), (90.0, 0.2)):
        assert abs(float(diffjpeg.quality_to_factor(q)) - f) < 1e-6


# -- synthesis -----------------------------------------------------------------


def _mode(u, prob):
    return "up" if u < prob[0] else "down" if u < prob[0] + prob[1] else "keep"


def _jax_rescale_draw(key, n_buckets):
    k_mode, k_pick, k_m2 = jax.random.split(key, 3)
    return synthesis.RescaleDraw(
        float(jax.random.uniform(k_mode)),
        int(jax.random.randint(k_pick, (), 0, n_buckets // 2)),
        int(jax.random.randint(k_pick, (), n_buckets // 2 + 1, n_buckets)),
        int(jax.random.randint(k_m2, (), 0, 3)))


def jax_synthesis_draws(rng, n, h, w, cfg):
    """The draws ``mgldvsr_tpu.train.synthesis.synthesize_lq`` makes from
    ``rng``, in the port's form (the chosen noise's field only)."""
    keys = jax.random.split(rng, 12)

    def stage(k_rescale, k_gauss, k_poisson, k_use, k_q, g_prob, g_range, p_range, gray, jpeg):
        use = float(jax.random.uniform(k_use))
        gaussian = use < g_prob
        noise = _jax_noise(k_gauss if gaussian else k_poisson, (n, h, w, 3),
                           g_range if gaussian else p_range, gray, gaussian)
        q = jax.random.uniform(k_q, (n,), minval=jpeg[0], maxval=jpeg[1])
        return synthesis.StageDraw(_jax_rescale_draw(k_rescale, cfg.n_scale_buckets), use,
                                   noise, _t(q))

    s1 = stage(*keys[:5], cfg.gaussian_noise_prob, cfg.noise_range, cfg.poisson_scale_range,
               cfg.gray_noise_prob, cfg.jpeg_range)
    blur2 = float(jax.random.uniform(keys[5]))
    s2 = stage(*keys[6:11], cfg.gaussian_noise_prob2, cfg.noise_range2,
               cfg.poisson_scale_range2, cfg.gray_noise_prob2, cfg.jpeg_range2)
    return synthesis.SynthesisDraws(s1, blur2, s2)


CFG = synthesis.SynthesisConfig(sf=4, n_scale_buckets=3)
JCFG = jsyn.SynthesisConfig(sf=4, n_scale_buckets=3)


def _key_for(mode):
    """The first seed whose two rescales both take ``mode``."""
    for seed in range(500):
        keys = jax.random.split(jax.random.PRNGKey(seed), 12)
        u1 = float(jax.random.uniform(jax.random.split(keys[0], 3)[0]))
        u2 = float(jax.random.uniform(jax.random.split(keys[6], 3)[0]))
        if _mode(u1, CFG.resize_prob) == mode == _mode(u2, CFG.resize_prob2):
            return jax.random.PRNGKey(seed)
    raise AssertionError(mode)


@pytest.fixture(scope="module")
def synthesized():
    """JAX's ``synthesize_lq`` (one jit) on one GT batch, one case per
    scale mode, with each case's draws in the port's form."""
    gt = _rand((N, H, W, 3), 6)
    kernels = {k: np.stack([v, w]) for (k, v), w in zip(
        jsyn.sample_degradation_kernels(np.random.RandomState(8)).items(),
        jsyn.sample_degradation_kernels(np.random.RandomState(9)).values())}
    fn = jax.jit(jsyn.synthesize_lq, static_argnums=3)
    cases = {}
    for mode in ("up", "down", "keep"):
        key = _key_for(mode)
        lq, gt_usm = fn(key, jnp.asarray(gt), {k: jnp.asarray(v) for k, v in kernels.items()},
                        JCFG)
        cases[mode] = (jax_synthesis_draws(key, N, H, W, CFG), np.asarray(lq),
                       np.asarray(gt_usm))
    return gt, kernels, cases


@pytest.mark.parametrize("mode", ["up", "down", "keep"])
def test_synthesize_lq_matches_jax(synthesized, mode):
    gt, kernels, cases = synthesized
    draws, lq_want, gt_want = cases[mode]
    assert _mode(draws.stage1.rescale.u, CFG.resize_prob) == mode
    lq, gt_usm = synthesis.apply_synthesis(_t(gt), {k: _t(v) for k, v in kernels.items()},
                                           draws, CFG)
    _close(gt_usm, gt_want, 1e-5)
    assert lq.shape == (N, H // 4, W // 4, 3)
    d = np.abs(lq.numpy() - lq_want)
    level = np.abs(d - 1 / 255) <= 1e-5
    assert ((d <= 1e-5) | level).all(), float(d.max())
    assert level.sum() <= 1e-3 * d.size, int(level.sum())
    np.testing.assert_array_equal(np.round(lq.numpy() * 255), lq.numpy() * 255)


def test_draw_synthesis_is_seeded_and_picks_one_noise():
    def draw(seed):
        return synthesis.draw_synthesis(torch.Generator().manual_seed(seed), 2, 64, 64, CFG,
                                        "cpu")

    a, b = draw(3), draw(3)
    assert a.stage1.rescale == b.stage1.rescale and a.blur2 == b.blur2
    assert torch.equal(a.stage2.noise.field, b.stage2.noise.field)
    for s in (a.stage1, a.stage2):
        assert 0 <= s.rescale.down_idx < 1 and s.rescale.up_idx == 2
        assert s.noise.field.shape == (2, 64, 64, 3) and s.quality.shape == (2,)
    gt = torch.from_numpy(_rand((2, 64, 64, 3), 10))
    kern = synthesis.sample_degradation_kernels(np.random.RandomState(0))
    lq, _ = synthesis.synthesize_lq(torch.Generator().manual_seed(3), gt, kern, CFG)
    want, _ = synthesis.apply_synthesis(gt, kern, a, CFG)
    assert torch.equal(lq, want) and 0 <= float(lq.min()) and float(lq.max()) <= 1


def test_kernels_equal_jax():
    for seed in range(3):
        got = synthesis.sample_degradation_kernels(np.random.RandomState(seed))
        want = jsyn.sample_degradation_kernels(np.random.RandomState(seed))
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v)


def test_bucketed_rescale_matches_jax_at_seven_buckets():
    """Every bucket of the default K = 7 with every method, down and back
    up, against JAX's ``_bucketed_rescale`` given each case's key."""
    x = _rand((1, 32, 32, 3), 11)
    fn = jax.jit(lambda k, z: jsyn._bucketed_rescale(z, k, (0.2, 0.7, 0.1), (0.15, 1.5), 7))
    seen = set()
    for seed in range(40):
        key = jax.random.PRNGKey(seed)
        draw = _jax_rescale_draw(key, 7)
        b = synthesis.bucket_of(draw, (0.2, 0.7, 0.1), 7)
        got = synthesis.bucketed_rescale(_t(x), draw, (0.2, 0.7, 0.1), (0.15, 1.5), 7)
        _close(got, fn(key, jnp.asarray(x)), 1e-5)
        seen.add((b, draw.method))
    assert len({b for b, _ in seen}) >= 5 and len({m for _, m in seen}) == 3


# -- the pair pool -------------------------------------------------------------


def test_pair_queue_equals_jax_bit_for_bit():
    ours, theirs = TrainingPairQueue(queue_size=6, seed=3), JaxQueue(queue_size=6, seed=3)
    for step in range(6):  # three batches fill the pool, three pop
        lq, gt = _rand((2, 4, 4, 3), 20 + step), _rand((2, 16, 16, 3), 40 + step)
        got = ours(_t(lq), _t(gt))
        want = theirs(lq, gt)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(ValueError, match="multiple"):
        TrainingPairQueue(queue_size=5)(torch.zeros(2, 1), torch.zeros(2, 1))


# -- BSRGAN --------------------------------------------------------------------


def _cv2_shim():
    """cv2 as the JAX module calls it, from ``cv_ops``."""
    shim = types.SimpleNamespace(**{k: getattr(cv_ops, k) for k in dir(cv_ops)
                                    if not k.startswith("_")})

    def resize(img, dsize, fx=None, fy=None, interpolation=cv_ops.INTER_LINEAR):
        if dsize is None:
            dsize = (int(round(img.shape[1] * fx)), int(round(img.shape[0] * fy)))
        return cv_ops.resize(img, dsize, interpolation=interpolation)

    shim.resize = resize
    shim.COLOR_RGB2BGR = shim.COLOR_BGR2RGB = "flip"
    shim.cvtColor = lambda img, code: np.ascontiguousarray(img[..., ::-1])
    return shim


@pytest.fixture
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


def _hq(seed, size=288):
    """A smooth HQ image: bicubic x8 of random 36 px, in [0, 1]."""
    small = _rand((size // 8, size // 8, 3), seed)
    return np.clip(cv_ops.resize(small, (size, size), cv_ops.INTER_CUBIC), 0, 1)


CHAINS = [("bsrgan", s) for s in range(4)] + [("light", s) for s in range(4)]


def _chain(module, which, img, seed):
    rng = np.random.default_rng(seed)
    if which == "bsrgan":
        return module.degradation_bsrgan(img, rng, sf=4, lq_patchsize=64)
    return module.degradation_bsrgan_light(img, rng, sf=4)


@pytest.mark.parametrize("which,seed", CHAINS)
def test_bsrgan_chains_equal_jax_on_the_same_primitives(monkeypatch, which, seed):
    """With the JAX module's cv2 replaced by the ``cv_ops`` shim both sides
    run the same primitives, so the chains, their shuffles and their draws
    from the same ``np.random.Generator`` agree bit for bit."""
    monkeypatch.setattr(jbsrgan, "cv2", _cv2_shim())
    img = _hq(seed)
    for g, w in zip(_chain(bsrgan, which, img, seed), _chain(jbsrgan, which, img, seed)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("which", ["bsrgan", "light"])
def test_bsrgan_chains_against_cv2(no_ipp, which):
    """Against the JAX module on OpenCV itself. ``cv_ops.resize`` sums in
    float64 where OpenCV sums in float32 (about 1e-7 apart), so a pixel
    within that of a half level rounds to the other uint8 level before a
    JPEG; the JPEG then moves the quantised coefficients of that block by
    up to one step. Limit, over four seeds of each chain: the HQ patch
    equal; mean |d| of the LQ within 1/255 and at least 99% of its pixels
    within 2/255 (a flipped coefficient moves one 8x8 block by a few
    levels; the blocks that hold no such pixel agree to within 2 levels)."""
    for seed in range(4):
        img = _hq(seed)
        (lq, hq), (lq_w, hq_w) = _chain(bsrgan, which, img, seed), _chain(jbsrgan, which, img,
                                                                           seed)
        np.testing.assert_array_equal(hq, hq_w)
        assert lq.shape == lq_w.shape
        d = np.abs(lq - lq_w)
        assert d.mean() <= 1 / 255, (seed, d.mean())
        assert (d <= 2 / 255 + 1e-6).mean() >= 0.99, (seed, (d <= 2 / 255 + 1e-6).mean())


def test_bsrgan_atoms_equal_jax():
    for ksize, theta in ((7, 0.3), (15, 2.0)):
        np.testing.assert_array_equal(bsrgan.anisotropic_gaussian_kernel(ksize, theta, 2.0, 5.0),
                                      jbsrgan.anisotropic_gaussian_kernel(ksize, theta, 2.0, 5.0))
    np.testing.assert_array_equal(bsrgan.fspecial_gaussian(25, 1.3),
                                  jbsrgan.fspecial_gaussian(25, 1.3))
    k = bsrgan.fspecial_gaussian(25, 1.3)
    np.testing.assert_array_equal(bsrgan.shift_pixel(k.copy(), 4), jbsrgan.shift_pixel(k.copy(), 4))
    img = _hq(5, 64)
    for fn in ("add_speckle_noise", "add_poisson_noise", "add_gaussian_noise"):
        np.testing.assert_array_equal(getattr(bsrgan, fn)(img, np.random.default_rng(1)),
                                      getattr(jbsrgan, fn)(img, np.random.default_rng(1)))
