"""The port imports without JAX: in a fresh interpreter where ``jax``,
``flax`` and the JAX package cannot be imported, every module of
mgldvsr_tpu_torch (and chip_smoke.py) must import, and none may pull in a
kernel build or Triton (or cv2, av or torchvision). The metrics, BSRGAN,
the synthesis, a stage-1 degradation stage and the heritage path also run
with cv2 unimportable."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "mgldvsr_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import mgldvsr_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(mgldvsr_tpu_torch.__path__, "mgldvsr_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
from mgldvsr_tpu_torch.ops.kernels import _build
assert _build.library.cache_info().currsize == 0, "a kernel library was loaded at import"
assert "triton" not in sys.modules, "triton was imported at import time"
for m in ("cli.infer", "data.video_folder", "utils.config", "io.frames", "io.torch_ckpt",
          "infer.canvas", "cli.train", "train.trainer", "train.optim", "io.checkpoint",
          "data.cv_ops", "data.blur_kernels", "data.degradations", "data.file_client",
          "data.datasets", "utils.tb", "utils.logging", "train.stage2", "train.losses",
          "models.lpips", "models.discriminator", "flow.spynet", "metrics", "metrics.image",
          "metrics.niqe", "metrics.inception", "metrics.fid", "metrics.temporal",
          "tools.quality_eval", "tools.quality_smoke", "parallel.mesh", "parallel.tensor",
          "parallel.sharded_sampler", "tools.multicard_check", "tools.multicard_train_check",
          "cli.prepare_data", "tools.soak_train", "ops.img_process", "ops.diffjpeg",
          "train.synthesis", "data.pair_queue", "data.bsrgan", "core.samplers",
          "data.tokenizer", "infer.txt2img", "models.textual_inversion", "models.encoders",
          "models.classifier", "ops.dcn", "ops.stylegan_ops", "flow.maskflownet",
          "models.heritage", "models.heritage.sr_archs", "models.heritage.video_archs",
          "models.heritage.swinir", "models.heritage.stylegan2", "models.heritage.misc_archs",
          "models.heritage.face_archs", "data.heritage_datasets", "native", "native.loader",
          "utils.profiling", "tools.loader_bench", "ops.kernels.int8_conv", "models.layers"):
    assert "mgldvsr_tpu_torch." + m in mods, m
assert "yaml" not in sys.modules, "yaml was imported at import time"
for m in ("cv2", "av", "torchvision"):
    assert m not in sys.modules, m + " was imported at import time"
print(len(mods))
"""


def _run(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)


def test_every_port_module_imports_without_jax():
    proc = _run(_CHECK)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 103


_METRICS_WITHOUT_CV2 = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "mgldvsr_tpu", "cv2"):
    sys.modules[name] = None  # any import of these now raises ImportError
import numpy as np
from mgldvsr_tpu_torch.metrics import calculate_niqe, calculate_psnr, calculate_ssim
from mgldvsr_tpu_torch.metrics import fit_niqe_params
from mgldvsr_tpu_torch.tools import quality_smoke
rs = np.random.RandomState(0)
img = np.round(rs.rand(96, 192, 3) * 255).astype(np.float32)
assert np.isfinite(calculate_psnr(img, img[::-1], test_y_channel=True))
assert np.isfinite(calculate_ssim(img, img[::-1], test_y_channel=True))
gray = [quality_smoke.gray255(f) for f in quality_smoke.make_clip_frames(0, 2, 192)]
fit_niqe_params(gray, out_path=sys.argv[1])
for convert_to in ("y", "gray"):
    assert np.isfinite(calculate_niqe(img, params_path=sys.argv[1], convert_to=convert_to))
print("ok")
"""


def test_metrics_run_without_cv2(tmp_path):
    """PSNR, SSIM and NIQE (fitting, both colour conversions) and the smoke's
    frame helpers run with cv2 unimportable."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _METRICS_WITHOUT_CV2, str(tmp_path / "n.npz")],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


_DEGRADATIONS_WITHOUT_CV2 = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "mgldvsr_tpu", "cv2"):
    sys.modules[name] = None  # any import of these now raises ImportError
import numpy as np
import torch
from mgldvsr_tpu_torch.data import bsrgan
from mgldvsr_tpu_torch.train import synthesis
img = np.random.default_rng(0).random((288, 288, 3)).astype(np.float32)
for seed in range(3):
    lq, hq = bsrgan.degradation_bsrgan(img, np.random.default_rng(seed), sf=4, lq_patchsize=64)
    assert lq.shape == (64, 64, 3) and hq.shape == (256, 256, 3) and 0 <= lq.min() <= lq.max() <= 1
lq, hq = bsrgan.degradation_bsrgan_light(img, np.random.default_rng(9), sf=4)
assert lq.shape == (72, 72, 3) and hq.shape == (288, 288, 3)
cfg = synthesis.SynthesisConfig(n_scale_buckets=3)
kern = synthesis.sample_degradation_kernels(np.random.RandomState(0))
gt = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(0))
lq, _ = synthesis.synthesize_lq(torch.Generator().manual_seed(1), gt, kern, cfg)
assert lq.shape == (2, 16, 16, 3) and torch.equal(torch.round(lq * 255) / 255, lq)
sys.modules["av"] = None
from mgldvsr_tpu_torch.cli.train import default_degradation_cfg
from mgldvsr_tpu_torch.data.degradations import DegradationStage, RandomVideoCompression
stage = DegradationStage(default_degradation_cfg()[0])
out = stage({"lqs": [img[:64, :48].copy() for _ in range(3)]}, np.random.RandomState(0))["lqs"]
mpeg = [t for t in stage.transforms if isinstance(t, RandomVideoCompression)]
assert len(out) == 3 and all(f.ndim == 3 and np.isfinite(f).all() for f in out)
assert mpeg[0].branch == "identity (neither PyAV nor cv2 imports)", mpeg[0].branch
print("ok")
"""


def test_bsrgan_and_synthesis_run_without_cv2():
    """Both BSRGAN chains, the device synthesis and a stage-1 degradation
    stage with its video compression run with cv2 (and JAX) unimportable."""
    proc = _run(_DEGRADATIONS_WITHOUT_CV2)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


@pytest.mark.parametrize("module", ["jax", "flax", "mgldvsr_tpu"])
def test_port_does_not_import(module):
    """Importing the whole port leaves ``module`` unimported."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mgldvsr_tpu_torch\n"
        "for m in pkgutil.walk_packages(mgldvsr_tpu_torch.__path__, 'mgldvsr_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"print({module!r} in sys.modules)\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "False"


_HERITAGE_WITHOUT_CV2 = r"""
import os, sys
for name in ("jax", "jaxlib", "flax", "optax", "mgldvsr_tpu", "cv2", "torchvision"):
    sys.modules[name] = None  # any import of these now raises ImportError
import numpy as np
import torch
from mgldvsr_tpu_torch.data.heritage_datasets import VideoRecurrentTestDataset
from mgldvsr_tpu_torch.io.frames import write_frame
from mgldvsr_tpu_torch.models.heritage.video_archs import BasicVSRPlusPlus
root = sys.argv[1]
rs = np.random.RandomState(0)
for side, size in (("gt", 32), ("lq", 8)):
    os.makedirs(os.path.join(root, side, "clip"))
    for i in range(3):
        write_frame(os.path.join(root, side, "clip", f"{i:08d}.png"),
                    rs.randint(0, 256, (size, size, 3), np.uint8))
item = VideoRecurrentTestDataset(os.path.join(root, "gt"), os.path.join(root, "lq"))[0]
lqs = torch.from_numpy(item["lqs"])[None]
flows = torch.zeros(1, 2, 8, 8, 2)
with torch.no_grad():
    out = BasicVSRPlusPlus(num_feat=8, num_block=1, deform_groups=2)(lqs, flows, flows)
assert out.shape == (1, 3, 32, 32, 3) and torch.isfinite(out).all()
print("ok")
"""


def test_heritage_path_runs_without_cv2_or_torchvision(tmp_path):
    """A clip through the heritage test dataset and BasicVSR++ (deformable
    convs) with cv2, torchvision and JAX unimportable."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _HERITAGE_WITHOUT_CV2, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


_LOADER_WITHOUT_CV2 = r"""
import os, sys
for name in ("jax", "jaxlib", "flax", "optax", "mgldvsr_tpu", "cv2", "torchvision"):
    sys.modules[name] = None  # any import of these now raises ImportError
import numpy as np
from mgldvsr_tpu_torch.tools import loader_bench
from mgldvsr_tpu_torch.utils.profiling import dump_pca_features
out = loader_bench.run(loader_bench.parse_args(["--iters", "3", "--src-size", "48", "--size",
                                                "16", "--frames", "2"]))
assert out["disk_clips_per_s"] > 0, out
rs = np.random.RandomState(0)
dump_pca_features([{"64": rs.randn(1, 8, 8, 4).astype(np.float32)}], sys.argv[1])
assert os.path.isfile(os.path.join(sys.argv[1], "fea_64", "step_1.png"))
print("ok")
"""


def test_loader_bench_and_pca_dump_run_without_cv2(tmp_path):
    """The loader benchmark (the native pool where it builds) and the PCA
    dump run with cv2, torchvision and JAX unimportable."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _LOADER_WITHOUT_CV2, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"
