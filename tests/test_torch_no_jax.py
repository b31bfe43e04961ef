"""The port imports without JAX: in a fresh interpreter where ``jax``,
``flax`` and the JAX package cannot be imported, every module of
mgldvsr_tpu_torch (and chip_smoke.py) must import, and none may pull in a
kernel build or Triton."""
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
          "models.lpips", "models.discriminator", "flow.spynet"):
    assert "mgldvsr_tpu_torch." + m in mods, m
assert "yaml" not in sys.modules, "yaml was imported at import time"
for m in ("cv2", "av"):
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
    assert int(proc.stdout.strip().splitlines()[-1]) >= 35


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
