"""The port's quality metrics against the JAX package's on the CPU, on
seeded numpy inputs given to both.

Limits, each with its reason:

- PSNR and SSIM on [0, 255] images within 1e-9 (float64 on both sides; SSIM's
  11x11 filter is OpenCV's DFT in JAX and an FFT in the port);
- ``psnr_tensor`` / ``ssim_tensor`` against ``psnr_jnp`` / ``ssim_jnp``
  within 1e-5 (float32 sums in other orders);
- ``fit_niqe_params`` within 1e-6 relative and ``calculate_niqe`` within
  1e-4 relative where the cropped image is whole 96x96 blocks (the window
  filter is bit for bit with OpenCV; the half-size resize rounds in another
  order); elsewhere the port halves the cropped image and the JAX package
  the uncropped size, and the scores differ;
- ``InceptionV3FID`` within 1e-4 of the largest |feature| (float32 convs
  through about 90 layers; flax's ``apply`` runs without ``jit``);
- the Inception state dict's round trip through ``convert_inception`` and
  ``calculate_fid`` bit for bit (the same numpy and scipy calls);
- ``calculate_ewarp`` within 1e-6 relative (float32 sums), and bit for bit
  between chunkings of the pairs.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgldvsr_tpu.io.ckpt_convert import convert_inception
from mgldvsr_tpu.metrics import fid as jfid
from mgldvsr_tpu.metrics import image as jimage
from mgldvsr_tpu.metrics import niqe as jniqe
from mgldvsr_tpu.metrics import temporal as jtemporal
from mgldvsr_tpu.metrics.inception import InceptionV3FID as JaxInception
from mgldvsr_tpu_torch.io.from_jax import inception_state_dict
from mgldvsr_tpu_torch.metrics import fid, image, niqe, temporal
from mgldvsr_tpu_torch.metrics.inception import InceptionV3FID
from mgldvsr_tpu_torch.tools import quality_eval


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _frames(seed: int, n: int, h: int, w: int) -> np.ndarray:
    """[n, h, w, 3] float32 in [0, 1]: smooth blocks plus noise (no flat
    areas)."""
    rs = np.random.RandomState(seed)
    base = rs.rand(n, h // 8 + 2, w // 8 + 2, 3)
    smooth = np.kron(base, np.ones((1, 8, 8, 1)))[:, :h, :w]
    return np.clip(0.7 * smooth + 0.3 * rs.rand(n, h, w, 3), 0, 1).astype(np.float32)


def _img255(seed: int, h: int, w: int) -> np.ndarray:
    return np.round(_frames(seed, 1, h, w)[0] * 255).astype(np.float32)


# -- PSNR / SSIM ---------------------------------------------------------------


@pytest.mark.parametrize("crop", [0, 4])
@pytest.mark.parametrize("y", [False, True])
def test_psnr_ssim_match_jax(crop, y):
    a, b = _img255(1, 40, 48), _img255(2, 40, 48)
    for port_fn, jax_fn in ((image.calculate_psnr, jimage.calculate_psnr),
                            (image.calculate_ssim, jimage.calculate_ssim)):
        got = port_fn(a, b, crop_border=crop, test_y_channel=y)
        want = jax_fn(a, b, crop_border=crop, test_y_channel=y)
        assert abs(got - want) <= 1e-9, (port_fn.__name__, got, want)
    assert image.calculate_psnr(a, a) == float("inf")


@pytest.mark.parametrize("crop", [0, 3])
def test_tensor_psnr_ssim_match_jax(crop):
    a, b = _frames(3, 3, 32, 40), _frames(4, 3, 32, 40)
    got = image.psnr_tensor(torch.from_numpy(a), torch.from_numpy(b), crop_border=crop).numpy()
    want = np.asarray(jimage.psnr_jnp(jnp.asarray(a), jnp.asarray(b), crop_border=crop))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    got = image.ssim_tensor(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jimage.ssim_jnp(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# -- NIQE ----------------------------------------------------------------------


def _gray(seed: int) -> np.ndarray:
    return _img255(seed, 192, 192)[..., 1].astype(np.float64)


def test_fit_niqe_params_matches_jax(tmp_path):
    images = [_gray(s) for s in (10, 11, 12)]
    got = niqe.fit_niqe_params(images, out_path=str(tmp_path / "p.npz"))
    want = jniqe.fit_niqe_params(images)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * np.abs(w).max())
    with np.load(tmp_path / "p.npz") as data:
        np.testing.assert_array_equal(data["mu_pris_param"], got[0])


@pytest.fixture
def no_ipp():
    """OpenCV's own kernels: the port's gray conversion is theirs to the bit,
    while IPP's may round a pixel one ulp apart, which ``np.round`` of the
    gray image can turn into a whole level."""
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


@pytest.mark.parametrize("convert_to", ["y", "gray"])
def test_calculate_niqe_matches_jax(tmp_path, no_ipp, convert_to):
    """Where the cropped image is whole 96x96 blocks (196^2 less a 2-pixel
    border), the two packages halve the same size."""
    path = str(tmp_path / "p.npz")
    jniqe.fit_niqe_params([_gray(s) for s in (20, 21, 22)], out_path=path)
    img = _img255(23, 196, 196)
    got = niqe.calculate_niqe(img, crop_border=2, params_path=path, convert_to=convert_to)
    want = jniqe.calculate_niqe(img, crop_border=2, params_path=path, convert_to=convert_to)
    assert np.isfinite(want) and abs(got - want) <= 1e-4 * abs(want), (got, want)


@pytest.mark.parametrize("convert_to", ["y", "gray"])
def test_niqe_halves_the_cropped_image(tmp_path, no_ipp, monkeypatch, convert_to):
    """192x200 less a 2-pixel border is cropped to one row of two blocks,
    96x192, and the second scale is that image halved, 48x96 (basicsr's
    loop): the score equals the score of the cropped image itself. The JAX
    package halves the uncropped 188x196 to 94x98 instead, so its score
    differs there."""
    path = str(tmp_path / "p.npz")
    jniqe.fit_niqe_params([_gray(s) for s in (20, 21, 22)], out_path=path)
    img = _img255(23, 192, 200)
    sizes = []
    resize = niqe.cv_ops.resize

    def spy(src, dsize, **kwargs):
        sizes.append((src.shape, dsize))
        return resize(src, dsize, **kwargs)

    monkeypatch.setattr(niqe.cv_ops, "resize", spy)
    got = niqe.calculate_niqe(img, crop_border=2, params_path=path, convert_to=convert_to)
    assert sizes == [((96, 192), (96, 48))]
    cropped = niqe.calculate_niqe(img[2:98, 2:194], params_path=path, convert_to=convert_to)
    assert np.isfinite(got) and got == cropped
    want = jniqe.calculate_niqe(img, crop_border=2, params_path=path, convert_to=convert_to)
    assert abs(got - want) > 1e-2 * abs(want), (got, want)


def test_niqe_without_params_raises(monkeypatch):
    monkeypatch.delenv("MGLD_NIQE_PARAMS", raising=False)
    with pytest.raises(ValueError, match="pristine"):
        niqe.calculate_niqe(_img255(1, 96, 192))


# -- Inception / FID -------------------------------------------------------------


def _jax_inception_params(seed: int = 0):
    """JAX InceptionV3FID parameters of the right shapes (``eval_shape``, no
    compile), drawn with numpy: kernels N(0, 1/fan_in), BN statistics and
    affine away from identity."""
    shapes = jax.eval_shape(JaxInception(resize_input=False).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 80, 80, 3)))
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rs.normal(0, 1 / np.sqrt(fan_in), leaf.shape).astype(np.float32)
        if name == "var":
            return rs.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rs.randn(*leaf.shape)).astype(np.float32)
        return (0.1 * rs.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def inception_params():
    return _jax_inception_params()


def test_inception_matches_jax(inception_params):
    sd = inception_state_dict(inception_params)
    rs = np.random.RandomState(5)
    cases = [(False, rs.uniform(-1, 1, (2, 80, 80, 3)).astype(np.float32)),
             (True, rs.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32))]
    for resize, x in cases:
        model = InceptionV3FID(resize_input=resize)
        model.load_state_dict(sd, strict=True)
        with torch.no_grad():
            got = model(torch.from_numpy(x)).numpy()
        want = np.asarray(JaxInception(resize_input=resize).apply(inception_params,
                                                                  jnp.asarray(x)))
        assert got.shape == want.shape == (len(x), 2048)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), resize


def test_inception_state_dict_round_trip(inception_params):
    sd = inception_state_dict(inception_params)
    assert len(sd) == 94 * 5
    back = inception_state_dict(convert_inception({k: v.numpy() for k, v in sd.items()}))
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    InceptionV3FID().load_state_dict(sd, strict=True)


def test_pt_inception_checkpoint_loads_strict(inception_params, tmp_path):
    """A pt_inception-style file (the 1008-class head, AuxLogits and
    BatchNorm step counters beside the tower) loads strictly; a missing key
    raises."""
    sd = inception_state_dict(inception_params)
    full = dict(sd)
    full["fc.weight"] = torch.zeros(1008, 2048)
    full["fc.bias"] = torch.zeros(1008)
    full["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    full["Mixed_5b.branch1x1.bn.num_batches_tracked"] = torch.tensor(0)
    torch.save(full, tmp_path / "pt_inception.pth")
    model = fid.load_patched_inception(str(tmp_path / "pt_inception.pth"), device="cpu")
    assert torch.equal(model.Mixed_7c.branch_pool.conv.weight,
                       sd["Mixed_7c.branch_pool.conv.weight"])
    del full["Mixed_6e.branch7x7dbl_3.bn.running_var"]
    torch.save(full, tmp_path / "missing.pth")
    with pytest.raises(RuntimeError, match="Missing key"):
        fid.load_patched_inception(str(tmp_path / "missing.pth"), device="cpu")


def test_fid_matches_jax_bit_for_bit():
    rs = np.random.RandomState(7)
    f1, f2 = rs.randn(40, 16), rs.randn(33, 16) + 0.3
    got_stats = [fid.calculate_activation_statistics(f) for f in (f1, f2)]
    want_stats = [jfid.calculate_activation_statistics(f) for f in (f1, f2)]
    for g, w in zip(got_stats, want_stats):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
    got = fid.calculate_fid(*got_stats[0], *got_stats[1])
    assert got == jfid.calculate_fid(*want_stats[0], *want_stats[1]) and got > 0
    assert fid.extract_features(lambda b: b[:, :2], [f1[:3], f1[3:5]]).shape == (5, 2)


def test_fid_features_feed_minus_one_to_one(inception_params):
    """The harness's FID input is [-1, 1] (the JAX harness feeds [0, 1] to a
    network that expects [-1, 1]): its feature function on [0, 1] frames is
    the network with ``normalize_input=False`` on 2x - 1."""
    model = InceptionV3FID(resize_input=False)
    model.load_state_dict(inception_state_dict(inception_params))
    x01 = _frames(9, 3, 80, 80)
    got = quality_eval.fid_features(model, x01, "cpu")
    with torch.no_grad():
        want = model(torch.from_numpy(x01) * 2 - 1).numpy()
        half_range = model(torch.from_numpy(x01)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - half_range).max() > 1e-3 * np.abs(want).max()
    tool_model = quality_eval.build_inception("random", "cpu")
    assert not tool_model.normalize_input and tool_model.resize_input


# -- E*warp ----------------------------------------------------------------------


def _flownet(stack):
    """A deterministic sub-pixel flow from the two frames' colours, written
    for both frameworks: mostly consistent forward and backward, a few
    pixels occluded."""
    def net(x, y):
        d = x - y
        return stack([0.9 * d[..., 0] + 0.2 * x[..., 2] - 0.1,
                      0.9 * d[..., 1] - 0.2 * y[..., 0] + 0.1], -1)
    return net


def test_ewarp_matches_jax():
    clip = _frames(11, 5, 32, 32)
    got = temporal.calculate_ewarp(clip, _flownet(torch.stack))
    want = jtemporal.calculate_ewarp(clip, _flownet(jnp.stack))
    assert want > 0 and abs(got - want) <= 1e-6 * want, (got, want)
    # some pixels are occluded and some are not, so the mask matters
    ff, fb = temporal.compute_clip_flows(_flownet(torch.stack), torch.from_numpy(clip)[None])
    occ = temporal.compute_occlusion_masks(ff, fb)[0]
    assert 0 < float(occ.mean()) < 0.5


def test_ewarp_chunking_changes_nothing():
    clip = torch.from_numpy(_frames(12, 5, 32, 32))
    calls = []

    def net(x, y):
        calls.append(x.shape[0])
        return _flownet(torch.stack)(x, y)

    whole = temporal.calculate_ewarp(clip, net, chunk_pairs=None)
    chunked = temporal.calculate_ewarp(clip, net, chunk_pairs=3)
    assert whole == chunked
    assert calls == [8, 3, 3, 2]
