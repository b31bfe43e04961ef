"""The port's last two entry points against the JAX package's on the CPU:
``cli/prepare_data.py`` (the REDS sub-image cropper) against the JAX
command line on the same random folder, and ``tools/soak_train.py`` (a
tiny soak: SIGUSR1, SIGKILL, resume) through the port's training command
line.
"""
import json
import os

import cv2
import numpy as np
import pytest

from mgldvsr_tpu.cli import prepare_data as jax_prepare
from mgldvsr_tpu_torch.cli import prepare_data
from mgldvsr_tpu_torch.io import frames as frames_io
from mgldvsr_tpu_torch.tools import soak_train


def _random_folder(root, seed=0):
    """Two layouts (clip folders at the top and one level down), frames of
    sizes that leave remainders on either side of the threshold, and one
    smaller than a crop."""
    rs = np.random.RandomState(seed)
    sizes = {"000": [(100, 130), (100, 130)], "001": [(70, 64)],
             os.path.join("val", "000"): [(40, 30), (90, 97)]}
    for clip, shapes in sizes.items():
        os.makedirs(os.path.join(root, clip))
        for i, (h, w) in enumerate(shapes):
            img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
            cv2.imwrite(os.path.join(root, clip, f"{i:08d}.png"), img[..., ::-1])


@pytest.mark.parametrize("workers", [1, 2])
def test_prepare_data_matches_the_jax_cli(tmp_path, workers):
    src = str(tmp_path / "src")
    _random_folder(src)
    common = ["--input", src, "--crop-size", "48", "--step", "24", "--thresh-size", "8",
              "--workers", str(workers)]
    jax_prepare.main([*common, "--output", str(tmp_path / "jax"),
                      "--meta-info", str(tmp_path / "jax_meta.txt")])
    prepare_data.main([*common, "--output", str(tmp_path / "port"),
                       "--meta-info", str(tmp_path / "port_meta.txt")])
    meta = (tmp_path / "jax_meta.txt").read_text()
    assert (tmp_path / "port_meta.txt").read_text() == meta
    names = meta.split()
    assert len(names) > 20 and "val/000/00000000_s001.png" in names

    def tree(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert tree(str(tmp_path / "port")) == tree(str(tmp_path / "jax")) == sorted(names)
    for name in names:
        want = cv2.imread(str(tmp_path / "jax" / name), cv2.IMREAD_UNCHANGED)[..., ::-1]
        got = frames_io.read_frame(str(tmp_path / "port" / name))
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_crop_positions_match_the_jax_cli():
    for full in range(1, 200, 7):
        for crop, step, thresh in ((48, 24, 8), (64, 64, 0), (30, 20, 25), (480, 240, 48)):
            assert prepare_data.crop_positions(full, crop, step, thresh) == \
                jax_prepare._crop_positions(full, crop, step, thresh)


def test_prepare_data_without_pil(tmp_path, monkeypatch):
    """The numpy + zlib codec reads and writes the crops when PIL is
    missing: the same pixels."""
    src = str(tmp_path / "src")
    _random_folder(src, seed=1)
    common = ["--input", src, "--crop-size", "48", "--step", "24", "--thresh-size", "8",
              "--workers", "1", "--compression", "1"]
    prepare_data.main([*common, "--output", str(tmp_path / "pil")])
    monkeypatch.setattr(frames_io, "codec", lambda: "png")
    prepare_data.main([*common, "--output", str(tmp_path / "png")])
    for d, _, fs in os.walk(tmp_path / "pil"):
        for f in fs:
            rel = os.path.relpath(os.path.join(d, f), tmp_path / "pil")
            np.testing.assert_array_equal(frames_io.read_frame(str(tmp_path / "png" / rel)),
                                          frames_io.read_frame(os.path.join(d, f)))


def test_soak_resumes_after_the_kill(tmp_path, monkeypatch):
    """A tiny stage-1 soak on the CPU: SIGUSR1's checkpoint, SIGKILL, and
    the resumed launch's first step is the checkpoint's next; the step run
    again after the resume logs the loss it logged before the kill. No
    process of either launch (the trainer, its data workers) outlives the
    tool."""
    launched = []
    popen = soak_train.subprocess.Popen

    def spy(*args, **kwargs):
        launched.append(popen(*args, **kwargs))
        assert os.getpgid(launched[-1].pid) == launched[-1].pid  # a group of its own
        return launched[-1]

    monkeypatch.setattr(soak_train.subprocess, "Popen", spy)
    # one thread a trainer: beside the suite's other workers, a trainer
    # with a thread a core runs many times slower
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("MKL_NUM_THREADS", "1")
    work = str(tmp_path / "soak")
    rc = soak_train.main(["--tiny", "--device", "cpu", "--steps", "8", "--sig-frac", "0.25",
                          "--log-every", "1", "--clips", "2", "--frames-per-clip", "6",
                          "--startup-timeout", "300", "--workdir", work])
    with open(os.path.join(work, "soak_summary.json")) as f:
        summary = json.load(f)
    assert rc == 0 and summary["ok"]
    assert summary["ckpt_step"] >= 2 and summary["resume_exact"]
    assert summary["resumed_first_step"] == summary["ckpt_step"] + 1
    steps = [r["step"] for r in soak_train.read_metrics(os.path.join(work, "run",
                                                                     "metrics.jsonl"))]
    killed = summary["killed_at_step"]
    assert summary["ckpt_step"] < killed < 8
    assert steps == list(range(1, killed + 1)) + list(range(summary["ckpt_step"] + 1, 9))
    assert os.path.isfile(os.path.join(work, "run", "export", "mgld_ema.pt"))
    assert len(launched) == 2
    for proc in launched:
        with pytest.raises(ProcessLookupError):
            os.killpg(proc.pid, 0)  # the launch's process group is empty
    assert np.isfinite([summary["loss_head_mean"], summary["loss_tail_mean"]]).all()


def test_soak_packs_what_the_dataset_reads(tmp_path):
    """--packed: the record file holds every frame under the key the
    stage-1 dataset reads, and a sample from it equals the folder's."""
    from mgldvsr_tpu_torch.data.datasets import RealVSRRecurrentDataset
    from mgldvsr_tpu_torch.data.file_client import PackedBackend

    gt = str(tmp_path / "gt")
    soak_train.make_stage1_data(gt, 2, 5, 48)
    assert soak_train.pack_frames(gt, str(tmp_path / "packed")) == 10
    assert sorted(PackedBackend(str(tmp_path / "packed")).keys())[0] == "100/00000000.png"
    kw = dict(num_frame=5, gt_size=32, degradation_1=None, degradation_2=None, seed=3)
    a = RealVSRRecurrentDataset(gt, **kw)[1]
    b = RealVSRRecurrentDataset(gt, packed_root=str(tmp_path / "packed"), **kw)[1]
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])


def test_soak_refuses_packed_stage2():
    with pytest.raises(SystemExit):
        soak_train.parse_args(["--stage", "2", "--packed", "--workdir", "x"])
