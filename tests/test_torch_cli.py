"""The port's inference CLI and what it reads and writes, against the JAX
package on the CPU: the PNG codec against PIL, the clip folder against the
JAX dataset (OpenCV), upstream checkpoints against the JAX converters, the
inference config against the JAX one, and the three CLI modes against the
JAX CLI. Tiny widths, float32, a step or two.
"""
import dataclasses
import os
import struct
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from mgldvsr_tpu.data.datasets import VideoFolderDataset as JaxVideoFolderDataset
from mgldvsr_tpu.io import ckpt_convert
from mgldvsr_tpu.utils import config as jconfig
from mgldvsr_tpu_torch.cli import infer as cli
from mgldvsr_tpu_torch.data.video_folder import VideoFolderDataset
from mgldvsr_tpu_torch.flow.raft import RAFTConfig
from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline, PipelineConfig, upscale_frames
from mgldvsr_tpu_torch.io import frames as frames_io
from mgldvsr_tpu_torch.io import from_jax, torch_ckpt
from mgldvsr_tpu_torch.io.init_weights import init_pipeline_weights
from mgldvsr_tpu_torch.models.cliptext import CLIPTextConfig
from mgldvsr_tpu_torch.models.unet import StructCondConfig, UNetConfig
from mgldvsr_tpu_torch.models.vae import VAEConfig
from mgldvsr_tpu_torch.utils import config as pconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is as fast as many, and the suite
    runs several workers on one machine, whose threads would contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _image(h, w, ch, seed=0):
    """A smooth gradient plus noise: rows that the filters predict well and
    badly."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (3 * xx + 5 * yy)[..., None] + 40 * np.arange(ch)
    return ((base + rs.randint(0, 30, (h, w, ch))) % 256).astype(np.uint8)


def _filtered_png(img: np.ndarray, filters) -> bytes:
    """An 8-bit PNG of ``img`` ([H, W, C], C in 1, 3, 4) whose row y is
    filtered with ``filters[y % len(filters)]``, written out here from the
    PNG specification, independently of the codec under test."""
    h, w, ch = img.shape
    rows = img.reshape(h, w * ch).astype(np.int32)
    out = []
    for y in range(h):
        kind = filters[y % len(filters)]
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
        up_left = np.concatenate([np.zeros(ch, np.int32), up[:-ch]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - up_left
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
        out.append(bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
    colour = {1: 0, 3: 2, 4: 6}[ch]

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("case", ["pil RGB", "pil L", "pil RGBA", "ours to pil",
                                  "filters 0-4 RGB", "filters 0-4 gray", "filters 0-4 RGBA"])
def test_png_codec_matches_pil(case, tmp_path):
    """The numpy + zlib codec reads what PIL writes (gray, RGB, RGBA, with
    PIL's own choice of filters) and what a writer using each of the five
    row filters writes, as PIL reads it; PIL reads what it writes. Bit for
    bit."""
    path = str(tmp_path / "f.png")
    if case.startswith("pil"):
        mode = case.split()[1]
        img = _image(37, 53, {"L": 1, "RGB": 3, "RGBA": 4}[mode])
        Image.fromarray(img[..., 0] if mode == "L" else img, mode).save(path)
        with open(path, "rb") as f:
            got = frames_io.decode_png(f.read())
        np.testing.assert_array_equal(got, np.asarray(Image.open(path).convert("RGB")))
    elif case == "ours to pil":
        img = _image(37, 53, 3)
        with open(path, "wb") as f:
            f.write(frames_io.encode_png(img))
        np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
        np.testing.assert_array_equal(frames_io.decode_png(frames_io.encode_png(img)), img)
    else:
        ch = {"RGB": 3, "gray": 1, "RGBA": 4}[case.split()[-1]]
        img = _image(21, 19, ch, seed=ch)
        data = _filtered_png(img, [0, 1, 2, 3, 4, 4, 3, 1])
        with open(path, "wb") as f:
            f.write(data)
        want = np.asarray(Image.open(path).convert("RGB"))
        np.testing.assert_array_equal(frames_io.decode_png(data), want)
        np.testing.assert_array_equal(want[..., 0], img[..., 0])


def test_frames_without_pil(tmp_path, monkeypatch):
    """Where PIL does not import, PNGs go through the numpy codec and a
    JPEG raises a RuntimeError that says PIL is missing."""
    img = _image(9, 11, 3)
    Image.fromarray(img).save(str(tmp_path / "a.jpg"))
    monkeypatch.setattr(frames_io, "codec", lambda: "png")
    frames_io.write_frame(str(tmp_path / "b.png"), img)
    np.testing.assert_array_equal(np.asarray(Image.open(str(tmp_path / "b.png"))), img)
    np.testing.assert_array_equal(frames_io.read_frame(str(tmp_path / "b.png")), img)
    with pytest.raises(RuntimeError, match="PIL"):
        frames_io.read_frame(str(tmp_path / "a.jpg"))
    with pytest.raises(RuntimeError, match="PIL"):
        frames_io.write_frame(str(tmp_path / "c.jpg"), img)


def _write_clip(root, clip, n, h, w, seed=0):
    d = os.path.join(root, clip)
    os.makedirs(d, exist_ok=True)
    rs = np.random.RandomState(seed)
    for i in rs.permutation(n):  # written out of order
        cv2.imwrite(os.path.join(d, f"{i:08d}.png"), rs.randint(0, 255, (h, w, 3), np.uint8))


def test_video_folder_matches_jax(tmp_path):
    """Clips and frames sorted by name, only .png/.jpg/.jpeg, windows of 5
    with the last padded by its last frame, RGB float32 in [0,1]: the same
    as the JAX dataset (which reads through OpenCV), exactly."""
    root = str(tmp_path)
    _write_clip(root, "b_clip", 7, 12, 10, seed=1)
    _write_clip(root, "a_clip", 5, 8, 6, seed=2)
    open(os.path.join(root, "b_clip", "notes.txt"), "w").close()
    open(os.path.join(root, "stray.png"), "w").close()  # not a clip folder
    got, want = VideoFolderDataset(root, 5), JaxVideoFolderDataset(root, 5)
    assert got.clips == want.clips == ["a_clip", "b_clip"]
    for i in range(len(want)):
        pairs = list(zip(got.segments(i), want.segments(i), strict=True))
        assert len(pairs) == (1 if i == 0 else 2)
        for (gc, gn, gf), (wc, wn, wf) in pairs:
            assert (gc, gn) == (wc, wn)
            assert gf.dtype == np.float32 and gf.shape == wf.shape
            np.testing.assert_array_equal(gf, wf)


def _structural_config():
    """The shipped structure (channel multipliers, blocks, attention levels,
    24 text blocks) at narrow widths, which the JAX converters' defaults
    assume; the struct-cond encoder keeps its 256 channels, which the JAX
    converter uses to split its attention heads."""
    return PipelineConfig(
        unet=UNetConfig(model_channels=32, num_head_channels=16, context_dim=32,
                        semb_channels=32),
        structcond=StructCondConfig(out_channels=32),
        vae=VAEConfig(ch=32, num_frames=5, enable_fusion=True),
        clip=CLIPTextConfig(width=32, heads=2),
        raft=RAFTConfig(iters=1))


def test_checkpoint_loader_matches_jax_converters(tmp_path):
    """Upstream-named checkpoints made from seeded port weights: an MGLD-VSR
    Lightning checkpoint (``state_dict``, the four tower prefixes, LitEma
    shadows of every UNet weight, extra upstream keys), an unprefixed video
    VAE and a DDP-wrapped raft-things. The port's loader fills the towers
    with what the JAX converters make of the same files, inverted by
    ``io.from_jax``, bit for bit; the EMA shadows, not the live weights,
    land in the UNet."""
    cfg = _structural_config()
    src = MGLDVSRPipeline(cfg, device="cpu")
    init_pipeline_weights(src, 3)
    sd = {}
    for name, prefix in torch_ckpt.TOWER_PREFIXES.items():
        sd.update({prefix + k: v for k, v in src.towers()[name].state_dict().items()})
    live = {}
    for k, v in list(sd.items()):
        if k.startswith("model."):
            sd["model_ema." + k[len("model."):].replace(".", "")] = v
            live[k] = torch.randn_like(v)  # the live weights differ from their shadows
    sd.update(live)
    sd.update({"model_ema.decay": torch.tensor(0.999), "model_ema.num_updates": torch.tensor(5),
               "cond_stage_model.model.logit_scale": torch.tensor(1.0),
               "cond_stage_model.model.text_projection": torch.zeros(32, 32),
               "cond_stage_model.model.transformer.resblocks.23.ln_1.weight": torch.ones(32),
               "betas": torch.zeros(1000)})
    vae_sd = {k: v.clone() for k, v in src.vae.state_dict().items()}
    vae_sd["loss.logvar"] = torch.zeros(())
    raft_sd = {"module." + k: v for k, v in src.raft.state_dict().items()}
    raft_sd["module.cnet.norm1.num_batches_tracked"] = torch.tensor(0)
    torch.save({"state_dict": sd, "global_step": 7}, str(tmp_path / "mgld.ckpt"))
    torch.save({"state_dict": vae_sd}, str(tmp_path / "vqgan.ckpt"))
    torch.save(raft_sd, str(tmp_path / "raft.pth"))

    pipe = MGLDVSRPipeline(cfg, device="cpu")
    n_ema = torch_ckpt.load_pipeline_checkpoints(pipe, str(tmp_path / "mgld.ckpt"),
                                                 str(tmp_path / "vqgan.ckpt"),
                                                 str(tmp_path / "raft.pth"))
    assert n_ema == len(live)

    def np_sd(path):
        return {k: v.numpy() for k, v in ckpt_convert.load_torch_state_dict(path).items()}

    params = ckpt_convert.convert_mgld_checkpoint(np_sd(str(tmp_path / "mgld.ckpt")))
    params["vae"] = ckpt_convert.convert_autoencoder(np_sd(str(tmp_path / "vqgan.ckpt")),
                                                     prefix="", video=True, fusion=True)
    params["raft"] = ckpt_convert.convert_raft(np_sd(str(tmp_path / "raft.pth")))
    want = from_jax.pipeline_state_dicts(params, cfg)
    for name, tower in pipe.towers().items():
        got = tower.state_dict()
        assert set(got) == set(want[name]), name
        for k, v in got.items():
            torch.testing.assert_close(v, want[name][k], atol=0, rtol=0, msg=f"{name}.{k}")
    for k, v in src.unet.state_dict().items():
        torch.testing.assert_close(pipe.unet.state_dict()[k], v, atol=0, rtol=0)
    # a key neither tower holds nor the upstream list names fails the strict load
    sd["first_stage_model.encoder.stray"] = torch.zeros(1)
    with pytest.raises(RuntimeError, match="stray"):
        torch_ckpt.load_mgld_checkpoint(pipe, sd)


def test_pipeline_config_matches_jax():
    """configs/infer_mgldvsr.yaml's model subtree, and one with num_frames
    and nested overrides, give the JAX PipelineConfig field by field (dtype
    by name)."""
    path = os.path.join(REPO, "configs", "infer_mgldvsr.yaml")
    sets = ["model.num_frames=3", "model.vae.ch_mult=[1,2]", "model.unet.dtype=float32",
            "model.structcond.num_frames=4", "infer.seed=7"]
    for overrides in ([], sets):
        got_all = pconfig.load_config([path], list(overrides))
        assert got_all == jconfig.load_config([path], list(overrides))
        got = pconfig.pipeline_config_from_dict(got_all["model"])
        want = jconfig.pipeline_config_from_dict(got_all["model"])

        def fields(cfg):
            out = {}
            for f in dataclasses.fields(cfg):
                v = getattr(cfg, f.name)
                if dataclasses.is_dataclass(v):
                    out.update({f"{f.name}.{k}": x for k, x in fields(v).items()})
                elif f.name == "dtype":
                    out[f.name] = str(v).replace("torch.", "")
                else:
                    out[f.name] = v
            return out

        # every field of the port's config is one of the JAX config's (which
        # has training options besides) and holds the same value
        g, w = fields(got), fields(want)
        assert set(g) <= set(w)
        for key in g:
            assert g[key] == w[key], key
    with pytest.raises(KeyError, match="valid"):
        pconfig.pipeline_config_from_dict({"unet": {"widths": 3}})


def _run_both(tmp_path, mode, extra=()):
    """The port's CLI and the JAX CLI on one folder: a clip of 7 frames of
    16x16 (two windows, the last padded), tiny widths, float32, one step."""
    from mgldvsr_tpu.cli.infer import main as jax_main

    seqs = str(tmp_path / "lq")
    _write_clip(seqs, "clip0", 7, 16, 16)
    common = ["--seqs-path", seqs, "--preset", "tiny", "--mode", mode, "--ddpm-steps", "1",
              "--no-bf16", "--size", "32", *extra]
    cli.main([*common, "--out-path", str(tmp_path / "port"), "--device", "cpu"])
    jax_main([*common, "--out-path", str(tmp_path / "jax")])
    return seqs, str(tmp_path / "port" / "clip0"), str(tmp_path / "jax" / "clip0")


@pytest.mark.parametrize("mode", ["fixed", "tile", "latent"])
def test_cli_writes_what_the_jax_cli_writes(tmp_path, mode):
    """The same files, the frames at the same size as 8-bit RGB, the
    latents at the same shape as float32 ([h/8, w/8, 4] NHWC)."""
    extra = ["--min-side", "64", "--vqgantile-size", "64", "--vqgantile-stride", "48"]
    _, port, jax_out = _run_both(tmp_path, mode, extra if mode == "tile" else ())
    names = sorted(os.listdir(jax_out))
    assert sorted(os.listdir(port)) == names
    assert len([n for n in names if n.endswith(".png")]) == 7
    assert len([n for n in names if n.endswith(".npy")]) == (7 if mode == "latent" else 0)
    for n in names:
        if n.endswith(".png"):
            got = frames_io.read_frame(os.path.join(port, n))
            assert got.shape == cv2.imread(os.path.join(jax_out, n)).shape == (64, 64, 3)
        else:
            got, want = np.load(os.path.join(port, n)), np.load(os.path.join(jax_out, n))
            assert got.shape == want.shape == (8, 8, 4) and got.dtype == want.dtype
            assert np.isfinite(got).all()


def test_cli_fixed_equals_restore_segment(tmp_path):
    """Fixed mode with two windows a call (the second padded) writes what
    one ``restore_segment`` of the same frames writes with the generator
    seeded from --seed and the first window's name."""
    seqs = str(tmp_path / "lq")
    _write_clip(seqs, "clip0", 7, 16, 16, seed=4)
    argv = ["--seqs-path", seqs, "--out-path", str(tmp_path / "out"), "--preset", "tiny",
            "--ddpm-steps", "2", "--no-bf16", "--device", "cpu", "--window-batch", "2",
            "--seed", "5", "--flow-chunk", "0"]
    cli.main(argv)
    args = cli.parse_args(argv)
    pipe = cli.build_pipeline(args)
    assert pipe.cfg.flow_chunk_pairs == 0
    cli.load_weights(pipe, args)
    (_, names, f1), (_, _, f2) = VideoFolderDataset(seqs, 5).segments(0)
    gen = torch.Generator().manual_seed(cli.segment_seed(5, "clip0", names[0]))
    frames = upscale_frames(torch.from_numpy(np.concatenate([f1, f2])), 4)
    want = (pipe.restore_segment(frames, gen).clamp(0, 1) * 255).round().to(torch.uint8).numpy()
    for i, name in enumerate(sorted(os.listdir(str(tmp_path / "out" / "clip0")))):
        np.testing.assert_array_equal(
            frames_io.read_frame(str(tmp_path / "out" / "clip0" / name)), want[i])


def _tf32_flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("before", [(True, True), (False, True)])
def test_cli_runs_with_tf32_off_and_restores_it(tmp_path, monkeypatch, capsys, before):
    """The whole run sees TF32 off for matmuls and cuDNN, its first line
    says so, and both flags are back as they were after it."""
    seqs = str(tmp_path / "lq")
    _write_clip(seqs, "clip0", 5, 16, 16)
    inside = []
    build = cli.build_pipeline

    def spy(args):
        inside.append(_tf32_flags())
        return build(args)

    monkeypatch.setattr(cli, "build_pipeline", spy)
    saved = _tf32_flags()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
    try:
        cli.main(["--seqs-path", seqs, "--out-path", str(tmp_path / "out"), "--preset", "tiny",
                  "--ddpm-steps", "1", "--no-bf16", "--device", "cpu"])
        after = _tf32_flags()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    assert inside == [(False, False)] and after == before
    assert capsys.readouterr().out.splitlines()[0] == cli.TF32_LINE
    assert len(os.listdir(tmp_path / "out" / "clip0")) == 5


def test_segment_seed_is_stable_across_processes():
    """The window seed is the same under two string-hash seeds (the JAX
    CLI's ``hash((clip, name))`` is not)."""
    code = ("from mgldvsr_tpu_torch.cli.infer import segment_seed; "
            "print(segment_seed(42, 'clip0', '00000000.png'), hash('clip0'))")
    outs = []
    for hash_seed in ("1", "2"):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONHASHSEED"] = hash_seed
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        outs.append(proc.stdout.split())
    assert outs[0][0] == outs[1][0] and outs[0][1] != outs[1][1]
    assert int(outs[0][0]) == (42 << 32) | zlib.crc32(b"clip0/00000000.png")


def test_cli_device_defaults_to_the_card():
    args = cli.parse_args(["--seqs-path", "x", "--out-path", "y"])
    assert args.device == "cuda" and args.mode == "fixed" and args.bf16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.build_pipeline(args)
