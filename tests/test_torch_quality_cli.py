"""The port's quality harness on the CPU: ``tools.quality_eval`` run in
process on two PNG clips, its PSNR, SSIM, NIQE and ``--other`` deltas
against the JAX package's functions on the same loaded frames (the limits
of ``test_torch_metrics.py``), and one ``tools.quality_smoke`` run at the
tiny preset (a restore through the inference command line, then both
scorings with every network seeded, FID included).

The frames are 96x192: NIQE needs at least two 96x96 blocks an image.
FID is taken in the smoke run alone: each FID is a 2048x2048 ``sqrtm``,
about 25 s on one CPU core.
"""
import json
import os

import numpy as np
import pytest
import threadpoolctl
import torch

from mgldvsr_tpu.metrics import image as jimage
from mgldvsr_tpu.metrics import niqe as jniqe
from mgldvsr_tpu_torch.io.frames import read_frame, write_frame
from mgldvsr_tpu_torch.tools import quality_eval, quality_smoke


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch and one BLAS thread: the tests run beside other test
    workers, and FID's ``sqrtm`` with a BLAS thread a core in each of them
    oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """GT, restored and other clips "a" and "b" of 3 frames, the NIQE npz
    fitted from the GT frames by the JAX package."""
    base = tmp_path_factory.mktemp("q")
    rs = np.random.RandomState(0)
    gray = []
    for clip in ("a", "b"):
        coarse = rs.rand(3, 14, 26, 3)
        for t in range(3):
            smooth = np.kron(coarse[t], np.ones((8, 8, 1)))[:96, :192]
            gt = np.clip(0.8 * smooth + 0.2 * rs.rand(96, 192, 3), 0, 1) * 255
            ours = np.clip(gt + rs.normal(0, 6, gt.shape), 0, 255)
            other = np.clip(ours + rs.normal(0, 2, gt.shape), 0, 255)
            for root, img in (("gt", gt), ("ours", ours), ("other", other)):
                os.makedirs(base / root / clip, exist_ok=True)
                write_frame(str(base / root / clip / f"{t:08d}.png"),
                            np.round(img).astype(np.uint8))
            gray.append(np.round(gt[..., 1]))
    jniqe.fit_niqe_params(gray, out_path=str(base / "niqe.npz"))
    return {k: str(base / k) for k in ("gt", "ours", "other")} | {"niqe": str(base / "niqe.npz")}


def _load(root, clip):
    d = os.path.join(root, clip)
    return np.stack([read_frame(os.path.join(d, n)) for n in sorted(os.listdir(d))]
                    ).astype(np.float32)


def test_quality_eval_matches_jax_functions(roots, capsys):
    rows = quality_eval.main([
        "--restored", roots["ours"], "--gt", roots["gt"], "--other", roots["other"],
        "--niqe-params", roots["niqe"], "--lpips-ckpt", "random", "--raft-ckpt", "random",
        "--crop-border", "2", "--device", "cpu"])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == rows
    assert [r["clip"] for r in rows] == ["a", "b", "__mean__"]
    for row in rows:
        assert row["device"] == "cpu" and row["tf32"] is False
    for row in rows[:2]:
        ours, gt, other = (_load(roots[k], row["clip"]) for k in ("ours", "gt", "other"))
        assert row["frames"] == 3
        psnr = np.mean([jimage.calculate_psnr(o, g, 2, test_y_channel=True)
                        for o, g in zip(ours, gt)])
        ssim = np.mean([jimage.calculate_ssim(o, g, 2, test_y_channel=True)
                        for o, g in zip(ours, gt)])
        niqe = np.mean([jniqe.calculate_niqe(o, params_path=roots["niqe"]) for o in ours])
        assert abs(row["psnr"] - psnr) <= 1e-9 and abs(row["ssim"] - ssim) <= 1e-9
        assert abs(row["niqe"] - niqe) <= 1e-4 * abs(niqe)
        assert row["l1_vs_other"] == float(np.mean(np.abs(ours - other)))
        assert row["max_vs_other"] == float(np.max(np.abs(ours - other)))
        assert np.isfinite(row["lpips"]) and np.isfinite(row["ewarp"])
    mean = rows[-1]
    for k in ("psnr", "ssim", "niqe", "lpips", "ewarp", "l1_vs_other", "max_vs_other"):
        assert mean[k] == float(np.mean([rows[0][k], rows[1][k]])), k


def test_quality_eval_needs_a_card_unless_asked_for_the_cpu(roots, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        quality_eval.main(["--restored", roots["ours"], "--gt", roots["gt"]])
    with pytest.raises(SystemExit):
        quality_eval.main(["--restored", roots["ours"], "--fid-against", roots["gt"],
                           "--device", "cpu"])


def test_quality_smoke_tiny(tmp_path, monkeypatch):
    """The smoke at the tiny preset, 2 sampler steps: every metric of both
    scorings finite, FID included, and the bicubic baseline ahead of the
    seeded restore on PSNR."""
    scored = []
    real_main = quality_eval.main

    def recording_main(argv):
        scored.append(real_main(argv)[-1])
        return scored[-1:]

    monkeypatch.setattr(quality_eval, "main", recording_main)
    summary = quality_smoke.main(["--workdir", str(tmp_path), "--preset", "tiny", "--device",
                                  "cpu", "--clips", "1", "--frames", "3", "--gt-size", "192",
                                  "--ddpm-steps", "2"])
    assert summary["ok"] and summary["metrics_finite"] and summary["device"] == "cpu"
    assert summary["bicubic_beats_random_restore_psnr"]
    assert len(scored) == 2
    for row in scored:
        for k in quality_smoke.KEYS:
            assert np.isfinite(row[k]), (k, row)
    assert sorted(os.listdir(tmp_path / "ours" / "000")) == [f"{t:08d}.png" for t in range(3)]
    with open(tmp_path / "quality_smoke.json") as f:
        assert json.load(f) == summary
