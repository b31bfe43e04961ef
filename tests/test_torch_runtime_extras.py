"""The runtime extras of the port against the JAX package on the same
numpy-seeded inputs: the lmdb and memcached backends (stub client modules),
``DiagonalGaussian.kl`` / ``nll`` (1e-6), the v-parameterisation helpers
(1e-6), ``DegradationsWithShuffle`` (bit for bit and the same ``RandomState``
after, both sides on the same primitives), the config registry, and the
profiling hooks (``pca_components`` within 1e-5, ``dump_pca_features``'
PNG files byte for byte, the timer, memory stats and trace on the CPU).
The JAX package itself is not edited."""
import json
import os
import sys
import types

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mgldvsr_tpu.data.degradations as jdeg
import mgldvsr_tpu.data.file_client as jfc
from mgldvsr_tpu.core import schedules as jsched
from mgldvsr_tpu.models.vae import DiagonalGaussian as JaxGaussian
from mgldvsr_tpu.utils import profiling as jprof
from mgldvsr_tpu_torch.core import schedules as psched
from mgldvsr_tpu_torch.data import cv_ops
from mgldvsr_tpu_torch.data import degradations as pdeg
from mgldvsr_tpu_torch.data import file_client as pfc
from mgldvsr_tpu_torch.io.frames import decode_png, encode_png
from mgldvsr_tpu_torch.models.vae import DiagonalGaussian
from mgldvsr_tpu_torch.utils import config as pconfig
from mgldvsr_tpu_torch.utils import profiling as pprof

# -- file backends ------------------------------------------------------------


class _Txn:
    def __init__(self, store):
        self._store = store

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def get(self, key):
        return self._store.get(key)


class _Env:
    def __init__(self, store):
        self._store = store

    def begin(self, write=False):
        assert not write
        return _Txn(self._store)


def _stub_lmdb(store, opened):
    def open_(path, **kw):
        opened.append((path, kw))
        return _Env(store)

    return types.SimpleNamespace(open=open_)


def test_lmdb_backend_against_jax(monkeypatch):
    store = {b"001/00000003.png": b"\x89PNG payload", b"k": bytes(range(7))}
    opened = []
    monkeypatch.setitem(sys.modules, "lmdb", _stub_lmdb(store, opened))
    port = pfc.FileClient("lmdb", db_path="/data/db")
    jax_side = jfc.FileClient("lmdb", db_path="/data/db")
    assert port.backend == "lmdb"
    for key in ("001/00000003.png", "k"):
        assert port.get(key) == jax_side.get(key) == store[key.encode()]
    assert opened[0] == opened[1] == ("/data/db", dict(readonly=True, lock=False,
                                                       readahead=False))
    monkeypatch.setitem(sys.modules, "lmdb", None)  # the import now fails
    for client in (pfc.FileClient, jfc.FileClient):
        with pytest.raises(ImportError, match="lmdb backend requested"):
            client("lmdb", db_path="/data/db")


class _Client:
    def __init__(self, store):
        self.store = store

    def get(self, key):
        return self.store.get(key)


def test_memcached_backend_against_jax(monkeypatch):
    store = {"k": b"payload", "n": 17}
    port = pfc.FileClient("memcached", client=_Client(store))
    jax_side = jfc.FileClient("memcached", client=_Client(store))
    assert port.get("k") == jax_side.get("k") == b"payload"
    # the port holds an injected client to the backends' contract too
    with pytest.raises(KeyError):
        port.get("missing")
    with pytest.raises(TypeError, match="expected raw bytes"):
        port.get("n")
    # pylibmc (stubbed): a miss raises KeyError and a non-bytes value
    # TypeError on both sides; the server list is split on commas
    servers = []

    def client(server_list):
        servers.append(server_list)
        return _Client(store)

    monkeypatch.setitem(sys.modules, "mc", None)
    monkeypatch.setitem(sys.modules, "pylibmc", types.SimpleNamespace(Client=client))
    for backend in (pfc.FileClient, jfc.FileClient):
        fc = backend("memcached", server_list_cfg="a:1,b:2")
        assert fc.get("k") == b"payload"
        with pytest.raises(KeyError):
            fc.get("missing")
        with pytest.raises(TypeError, match="expected raw bytes"):
            fc.get("n")
    assert servers == [["a:1", "b:2"]] * 2
    monkeypatch.setitem(sys.modules, "pylibmc", None)
    for backend in (pfc.FileClient, jfc.FileClient):
        with pytest.raises(ImportError, match="memcached backend requested"):
            backend("memcached", server_list_cfg="localhost:11211")


# -- DiagonalGaussian ---------------------------------------------------------


def _moments(seed, wide=False):
    rs = np.random.RandomState(seed)
    m = rs.randn(2, 5, 6, 8).astype(np.float32)
    if wide:  # logvar beyond the clamp on both sides
        m[..., 4:] = rs.choice([-45.0, -31.0, 25.0, 3.0], size=m[..., 4:].shape)
    return m


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("deterministic", [False, True])
def test_kl_and_nll_against_jax(wide, deterministic):
    a, b = _moments(1, wide), _moments(2, wide)
    x = np.random.RandomState(3).randn(2, 5, 6, 4).astype(np.float32)
    j = JaxGaussian(jnp.asarray(a), deterministic=deterministic)
    jo = JaxGaussian(jnp.asarray(b))
    p = DiagonalGaussian(torch.from_numpy(a), deterministic=deterministic)
    po = DiagonalGaussian(torch.from_numpy(b))
    nchw = DiagonalGaussian(torch.from_numpy(a).permute(0, 3, 1, 2), dim=1,
                            deterministic=deterministic)
    pairs = [(p.kl(), j.kl()), (p.kl(po), j.kl(jo)), (p.nll(torch.from_numpy(x)),
                                                      j.nll(jnp.asarray(x)))]
    for got, want in pairs:
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape == (() if deterministic else (2,))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * max(
            1.0, float(np.abs(want).max())))
    # NCHW sums the same elements
    po_nchw = DiagonalGaussian(torch.from_numpy(b).permute(0, 3, 1, 2), dim=1)
    np.testing.assert_allclose(nchw.kl().numpy(), p.kl().numpy(), rtol=1e-6)
    np.testing.assert_allclose(nchw.kl(po_nchw).numpy(), p.kl(po).numpy(), rtol=1e-6)
    np.testing.assert_allclose(
        nchw.nll(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy(),
        p.nll(torch.from_numpy(x)).numpy(), rtol=1e-6)
    if deterministic:
        assert torch.equal(p.sample(torch.Generator().manual_seed(0)), p.mean)
        assert float(p.kl()) == 0.0 and float(p.nll(torch.from_numpy(x))) == 0.0


# -- the v-parameterisation ---------------------------------------------------


def test_v_helpers_against_jax_and_round_trip():
    base_j = jsched.DiffusionSchedule.create(1000, "linear", 0.00085, 0.0120,
                                             parameterization="v")
    base_p = psched.DiffusionSchedule.create(device="cpu", timesteps=1000,
                                             beta_schedule="linear", linear_start=0.00085,
                                             linear_end=0.0120, parameterization="v")
    rs = np.random.RandomState(4)
    x0, noise = (rs.randn(3, 8, 8, 4).astype(np.float32) for _ in range(2))
    t = np.array([0, 517, 999], np.int32)
    tt = torch.from_numpy(t.astype(np.int64))
    v_p = psched.get_v(base_p, torch.from_numpy(x0), torch.from_numpy(noise), tt)
    v_j = jsched.get_v(base_j, jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
    np.testing.assert_allclose(v_p.numpy(), np.asarray(v_j), atol=1e-6, rtol=0)
    xt = psched.q_sample(base_p, torch.from_numpy(x0), tt, torch.from_numpy(noise))
    got = psched.predict_start_from_z_and_v(base_p, xt, tt, v_p)
    want = jsched.predict_start_from_z_and_v(base_j, jnp.asarray(xt.numpy()), jnp.asarray(t),
                                             v_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.numpy(), x0, atol=1e-5, rtol=0)  # x0 back
    # an int timestep broadcasts over the batch as the JAX helper's does
    np.testing.assert_allclose(
        psched.get_v(base_p, torch.from_numpy(x0), torch.from_numpy(noise), 300).numpy(),
        np.asarray(jsched.get_v(base_j, jnp.asarray(x0), jnp.asarray(noise), 300)),
        atol=1e-6, rtol=0)


# -- DegradationsWithShuffle --------------------------------------------------


class _NoVideoWriter:
    def __init__(self, *args, **kwargs):
        pass

    def isOpened(self):
        return False

    def release(self):
        pass


@pytest.fixture
def shimmed(monkeypatch):
    """The JAX degradations on the port's cv_ops primitives, which are held
    against cv2 on their own (tests/test_torch_data.py): both sides then run
    the same arithmetic, and the comparison holds the order of transforms
    and draws."""
    shim = types.SimpleNamespace(**{k: getattr(cv_ops, k) for k in dir(cv_ops)
                                    if not k.startswith("_")})
    shim.VideoWriter = _NoVideoWriter
    shim.VideoWriter_fourcc = lambda *codes: 0
    monkeypatch.setattr(jdeg, "cv2", shim)
    monkeypatch.setattr(jdeg, "_av", None)


_BLUR = {"type": "RandomBlur", "params": {
    "kernel_size": [3, 5], "kernel_list": ["iso", "aniso"], "kernel_prob": [0.5, 0.5],
    "sigma_x": [0.2, 1.5], "sigma_y": [0.2, 1.5], "rotate_angle": [-3.14, 3.14],
    "prob": 0.9}}
_RESIZE = {"type": "RandomResize", "params": {
    "resize_mode_prob": [0.3, 0.4, 0.3], "resize_scale": [0.5, 1.5],
    "resize_opt": ["bilinear", "area", "bicubic"], "resize_prob": [0.3, 0.3, 0.4]}}
_NOISE = {"type": "RandomNoise", "params": {
    "noise_type": ["gaussian", "poisson"], "noise_prob": [0.5, 0.5],
    "gaussian_sigma": [1, 20], "gaussian_gray_noise_prob": 0.4, "poisson_scale": [0.05, 2],
    "poisson_gray_noise_prob": 0.4}}
_JPEG = {"type": "RandomJPEGCompression", "params": {"quality": [40, 90]}}
_FINAL = {"type": "RandomResize", "params": {
    "target_size": (24, 28), "resize_opt": ["bilinear", "bicubic"], "resize_prob": [0.5, 0.5]}}


@pytest.mark.parametrize("degradations,shuffle_idx", [
    ([_BLUR, [_RESIZE, _NOISE], _JPEG], None),
    ([_BLUR, _NOISE, [_RESIZE, _JPEG], _FINAL], [0, 1, 2]),
    ([[_BLUR, _RESIZE], _NOISE, _JPEG, _FINAL], []),
])
def test_degradations_with_shuffle_against_jax(shimmed, degradations, shuffle_idx):
    for seed in range(4):
        rs = np.random.RandomState(100 + seed)
        frames = [np.clip(rs.rand(40, 48, 3), 0, 1).astype(np.float32) for _ in range(3)]
        j = jdeg.DegradationsWithShuffle(degradations, keys=("lqs",), shuffle_idx=shuffle_idx)
        p = pdeg.DegradationsWithShuffle(degradations, keys=("lqs",), shuffle_idx=shuffle_idx)
        assert p.shuffle_idx == j.shuffle_idx
        rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
        a = j({"lqs": [f.copy() for f in frames]}, rj)["lqs"]
        b = p({"lqs": [f.copy() for f in frames]}, rp)["lqs"]
        assert len(a) == len(b) == 3
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
        # the same draws were made: the two streams stand at one place
        sj, sp = rj.get_state(), rp.get_state()
        assert sj[2] == sp[2] and np.array_equal(sj[1], sp[1])
    with pytest.raises(KeyError):
        pdeg.DegradationsWithShuffle([{"type": "RandomSharpen", "params": {}}])


# -- the config registry ------------------------------------------------------


def test_registry_and_instantiate(tmp_path):
    @pconfig.register("test.adder")
    def adder(a, b=1):
        return a + b

    assert pconfig.instantiate({"target": "test.adder", "params": {"a": 2}}) == 3
    assert pconfig.instantiate({"target": "test.adder", "params": {"a": 2}}, b=5) == 7
    with pytest.raises(KeyError, match="unknown target 'nope.nothing'; registered"):
        pconfig.instantiate({"target": "nope.nothing"})
    with pytest.raises(KeyError, match="missing 'target'"):
        pconfig.instantiate({"params": {}})
    from mgldvsr_tpu.utils.config import REGISTRY as JAX_REGISTRY

    defaults = {"data.realvsr_recurrent", "data.reds_autoencoder", "data.video_folder",
                "flow.raft", "flow.spynet"}
    assert defaults <= set(pconfig.REGISTRY) and defaults <= set(JAX_REGISTRY)
    from mgldvsr_tpu_torch.data.datasets import RealVSRRecurrentDataset
    from mgldvsr_tpu_torch.data.video_folder import VideoFolderDataset
    from mgldvsr_tpu_torch.flow.raft import RAFT
    from mgldvsr_tpu_torch.flow.spynet import SpyNet

    root = tmp_path / "gt"
    for clip in ("000", "001"):
        (root / clip).mkdir(parents=True)
        cv2.imwrite(str(root / clip / "00000000.png"), np.zeros((8, 8, 3), np.uint8))
    ds = pconfig.instantiate({"target": "data.realvsr_recurrent",
                              "params": {"dataroot_gt": str(root), "gt_size": 8}})
    assert isinstance(ds, RealVSRRecurrentDataset) and ds.clips == [("001", 1)]
    assert isinstance(pconfig.instantiate({"target": "data.video_folder",
                                           "params": {"root": str(root)}}), VideoFolderDataset)
    raft = pconfig.instantiate({"target": "flow.raft", "params": {"iters": 3}})
    assert isinstance(raft, RAFT) and raft.cfg.iters == 3
    assert isinstance(pconfig.instantiate({"target": "flow.spynet"}), SpyNet)


# -- profiling ----------------------------------------------------------------


def test_pca_components_against_jax():
    f = np.random.RandomState(0).rand(12, 10, 16).astype(np.float32)
    for n in (1, 3):
        got, want = pprof.pca_components(f, n), jprof.pca_components(f, n)
        assert got.dtype == np.float32 and got.shape == (12, 10, n)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_dump_pca_features_bytes_equal_jax(tmp_path):
    rs = np.random.RandomState(5)
    steps = [{"64": rs.randn(1, 16, 16, 8).astype(np.float32),
              "32": rs.randn(1, 8, 12, 8).astype(np.float32)} for _ in range(3)]
    steps.append({"64": rs.randn(1, 16, 16, 8).astype(np.float32)})
    jprof.dump_pca_features(steps, str(tmp_path / "jax"))
    pprof.dump_pca_features([{k: torch.from_numpy(v) for k, v in s.items()} for s in steps],
                            str(tmp_path / "port"))
    names = sorted(os.path.relpath(os.path.join(d, n), tmp_path / "jax")
                   for d, _, files in os.walk(tmp_path / "jax") for n in files)
    assert len(names) == 7
    for name in names:
        want = (tmp_path / "jax" / name).read_bytes()
        assert (tmp_path / "port" / name).read_bytes() == want, name
    with pytest.raises(ValueError, match="3 components"):
        pprof.dump_pca_features(steps, str(tmp_path / "x"), n_components=2)


@pytest.mark.parametrize("shape", [(1, 1, 3), (1, 7, 3), (9, 1, 3), (24, 40, 3), (70, 90, 3)])
def test_encode_png_opencv_bytes(shape):
    """``encode_png(opencv=True)`` writes the bytes cv2.imencode does for the
    BGR image: random, flat and smooth content."""
    rs = np.random.RandomState(sum(shape))
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    smooth = np.stack([(3 * xx) % 256, (5 * yy) % 256, (2 * (xx + yy)) % 256], -1)
    for rgb in (rs.randint(0, 256, shape, np.uint8), np.full(shape, 7, np.uint8),
                smooth.astype(np.uint8)):
        got = encode_png(rgb, opencv=True)
        assert got == cv2.imencode(".png", np.ascontiguousarray(rgb[..., ::-1]))[1].tobytes()
        np.testing.assert_array_equal(decode_png(got), rgb)


def _session(*events):
    """A finished profiler session's stand-in: ``events()`` as ``(name,
    device, correlation id)``, device "cuda" or "cpu"."""
    kind = torch.autograd.DeviceType
    return types.SimpleNamespace(events=lambda: [
        types.SimpleNamespace(name=n, device_type=kind.CUDA if d == "cuda" else kind.CPU, id=i)
        for n, d, i in events])


@pytest.mark.parametrize("events,launched,want", [
    ((("cudaLaunchKernel", "cpu", 1),), False, None),
    ((("cudaLaunchKernelExC_v11060", "cpu", 1), ("Memset (Device)", "cuda", 2)), False, None),
    ((("cudaGraphLaunch", "cpu", 1),), False, None),
    ((("aten::mm", "cpu", 1),), True, None),
    ((("cudaLaunchKernel", "cpu", 1), ("void group_norm_kernel<float>", "cuda", 1),
      ("Memcpy HtoD", "cuda", 2)), False, 1),
    ((("aten::mm", "cpu", 1),), False, 0),
    # one launch of two lost its kernel: the device time would read short
    ((("cudaLaunchKernel", "cpu", 1), ("void group_norm_kernel<float>", "cuda", 1),
      ("cudaLaunchKernel", "cpu", 2)), True, None),
    ((("cudaGraphLaunch", "cpu", 1), ("void group_norm_kernel<float>", "cuda", 1),
      ("MulFunctor", "cuda", 1), ("cudaLaunchKernel", "cpu", 2), ("MulFunctor", "cuda", 2)),
     True, 3),
])
def test_check_kernels_raises_on_launches_without_kernels(events, launched, want):
    """A session with a launch call whose kernel it did not record (matched
    by correlation id), or with launch calls (or one the caller says
    launched work) and no device kernel, raises, naming the caller's phase;
    memsets and copies are not kernels; a graph launch's kernels share its
    id; a session of host work alone reads 0."""
    if want is None:
        with pytest.raises(pprof.EmptyTraceError, match="phase 9: the loop"):
            pprof.check_kernels(_session(*events), "phase 9: the loop", launched=launched)
    else:
        assert pprof.check_kernels(_session(*events), "phase 9: the loop",
                                   launched=launched) == want


@pytest.mark.parametrize("empty", [0, 1, 2, 5])
def test_reattach_cupti_tears_down_then_verifies(monkeypatch, empty):
    """One session that stops with ``TEARDOWN_CUPTI=1``; then, each after a
    CUDA call outside any session, sessions that stop with it 0 until one
    records its launch (``empty`` of them record nothing: kineto's finalise
    fell in them); it raises after ``REATTACH_TRIES`` empty ones, and leaves
    ``TEARDOWN_CUPTI=0``."""
    import torch.profiler

    seen = []
    kind = torch.autograd.DeviceType

    class Session:
        def __init__(self, activities):
            assert tuple(activities) == (torch.profiler.ProfilerActivity.CUDA,)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            seen.append(("stop", os.environ.get("TEARDOWN_CUPTI")))

        def events(self):
            stops = sum(1 for e in seen if e[0] == "stop")
            if 1 < stops <= 1 + empty:
                return []
            return [types.SimpleNamespace(name="fill_kernel", device_type=kind.CUDA, id=1)]

    monkeypatch.setattr(torch.profiler, "profile", Session)
    monkeypatch.setattr(torch, "ones", lambda *a, **k: seen.append(("launch",)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: seen.append(("sync",)))
    monkeypatch.setattr(pprof, "REATTACH_WAIT_S", 0.0)
    monkeypatch.delenv("TEARDOWN_CUPTI", raising=False)
    if empty >= pprof.REATTACH_TRIES:
        with pytest.raises(pprof.EmptyTraceError, match="reattach_cupti"):
            pprof.reattach_cupti()
    else:
        pprof.reattach_cupti()
    tries = min(empty + 1, pprof.REATTACH_TRIES)
    session = [("launch",), ("sync",)]
    assert seen == (session + [("stop", "1")]
                    + ([("sync",)] + session + [("stop", "0")]) * tries)
    assert os.environ["TEARDOWN_CUPTI"] == "0"


def test_timer_memory_and_trace_on_the_cpu(tmp_path, monkeypatch):
    timer = pprof.StepTimer()
    assert timer.mean == timer.best == 0.0
    for _ in range(2):
        timer.start()
        x = torch.ones(64, 64) @ torch.ones(64, 64)
        timer.stop(x, "not a tensor")
    assert len(timer.times) == 2 and 0 < timer.best <= timer.mean
    assert pprof.device_memory_stats("cpu") == {"bytes_in_use": 0, "peak_bytes_in_use": 0,
                                                "bytes_limit": 0}
    assert set(pprof.device_memory_stats()) == {"bytes_in_use", "peak_bytes_in_use",
                                                "bytes_limit"}
    monkeypatch.delenv("TEARDOWN_CUPTI", raising=False)
    with pprof.trace(str(tmp_path / "tr")):
        torch.ones(32, 32) @ torch.ones(32, 32)
    assert os.environ["TEARDOWN_CUPTI"] == "0"  # CUPTI stays attached between sessions
    with open(tmp_path / "tr" / "trace.json") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any(n.startswith("aten::") for n in names), sorted(names)[:20]
