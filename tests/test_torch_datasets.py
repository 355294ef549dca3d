"""The port's loaders against the JAX package's on the CPU: LLFF (NDC and
spiral path, spherified, ``.csv`` poses, ``llff_hold``), Multicam (the
synthesized 4-scale pyramid and ``metadata.json``), the bin dump and the
Blender orbit give byte-equal images, rays, render-path rays, image dims
and ``peek`` / ``next`` batches at the same seed; the native loader's
batches equal JAX's on the same file and seed; ``run eval`` on Multicam
matches JAX's metrics (rtol 1e-4) and ``run render --render-path`` PNGs
are within 1 LSB of JAX's for Blender, LLFF and Multicam.

Scenes: ``write_blender_scene`` / ``write_llff_scene`` of
``tests/test_datasets.py`` (16x16 and 12x12 pixels of seeded noise) and
the port's ``utils/synthetic.write_scene``.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

torch.set_num_threads(2)

from test_datasets import write_blender_scene, write_llff_scene  # noqa: E402

from nerf_or_nothing_tpu import run as jrun  # noqa: E402
from nerf_or_nothing_tpu.config import parse_flags as jparse  # noqa: E402
from nerf_or_nothing_tpu.datasets import bin_dump as jbin  # noqa: E402
from nerf_or_nothing_tpu.datasets import native_loader as jnative  # noqa: E402
from nerf_or_nothing_tpu.datasets.base import (  # noqa: E402
    create_dataset as j_dataset,
)
from nerf_or_nothing_tpu_torch import run as trun  # noqa: E402
from nerf_or_nothing_tpu_torch.config import parse_flags  # noqa: E402
from nerf_or_nothing_tpu_torch.datasets import bin_dump as tbin  # noqa: E402
from nerf_or_nothing_tpu_torch.datasets import (  # noqa: E402
    native_loader as tnative,
)
from nerf_or_nothing_tpu_torch.datasets.base import (  # noqa: E402
    create_dataset,
)
from nerf_or_nothing_tpu_torch.utils.synthetic import write_scene  # noqa: E402

MODEL = ["--num-samples=8", "--net-depth=3", "--net-width=32",
         "--net-width-condition=32", "--skip-layer=2", "--max-deg-point=4",
         "--randomized=false", "--use-pallas=true", "--compute-dtype=float32",
         "--render-chunk-size=128"]


def same_bytes(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                        b.dtype, a.shape,
                                                        b.shape)
    assert a.tobytes() == b.tobytes(), what


def same_pixels(a, b, what, exact):
    """Byte-equal, or, for linear colour (``srgb_to_linear`` in torch and
    in XLA round the power differently in the last bit), within 2 ulp."""
    if exact:
        same_bytes(a, b, what)
    else:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2.4e-7,
                                   atol=1e-12, err_msg=what)


def same_rays(a, b, what):
    for field, x, y in zip(a._fields, a, b):
        same_bytes(x, y, f"{what} {field}")


def write_metadata_scene(root, blender_root):
    """A multiscale ``metadata.json`` layout made from a Blender scene:
    every frame at two scales, with lossmult, per-image near/far and its
    own intrinsics."""
    with open(os.path.join(blender_root, "transforms_train.json")) as f:
        meta = json.load(f)
    os.makedirs(os.path.join(root, "img"), exist_ok=True)
    split = {k: [] for k in ("file_path", "cam2world", "width", "height",
                             "focal", "pix2cam", "lossmult", "near", "far")}
    for i, frame in enumerate(meta["frames"]):
        img = Image.open(os.path.join(blender_root,
                                      frame["file_path"] + ".png"))
        for scale in range(2):
            w, h = img.width >> scale, img.height >> scale
            name = f"img/r_{i}_d{scale}.png"
            img.resize((w, h), Image.BOX).save(os.path.join(root, name))
            focal = 0.5 * w / np.tan(0.5 * meta["camera_angle_x"])
            split["file_path"].append(name)
            split["cam2world"].append(frame["transform_matrix"])
            split["width"].append(w)
            split["height"].append(h)
            split["focal"].append(focal)
            split["pix2cam"].append([[1 / focal, 0, -0.5 * w / focal],
                                     [0, -1 / focal, 0.5 * h / focal],
                                     [0, 0, -1]])
            split["lossmult"].append(4.0 ** scale)
            split["near"].append(2.0 + 0.1 * i)
            split["far"].append(6.0)
    with open(os.path.join(root, "metadata.json"), "w") as f:
        json.dump({"train": split, "test": split}, f)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_datasets")
    blender = str(root / "blender")
    write_blender_scene(blender)
    meta = str(root / "meta")
    write_metadata_scene(meta, blender)
    llff = str(root / "llff")
    write_llff_scene(llff)
    llff_csv = str(root / "llff_csv")
    write_llff_scene(llff_csv, n_images=5)
    arr = np.load(os.path.join(llff_csv, "poses_bounds.npy"))
    os.remove(os.path.join(llff_csv, "poses_bounds.npy"))
    np.savetxt(os.path.join(llff_csv, "poses_bounds.csv"), arr, delimiter=",")
    ds = j_dataset("train", blender, jparse([]))
    dump = str(root / "rays.bin")
    jbin.write_bin_dump(dump, ds._flat_rays, ds._flat_pixels)
    ds.close()
    return {"blender": blender, "meta": meta, "llff": llff,
            "llff_csv": llff_csv, "bin": dump}


LOADERS = {
    "blender_orbit": ("blender", ["--dataset-loader=blender",
                                  "--render-path=true"]),
    "multicam_synthesized": ("blender", ["--dataset-loader=multicam"]),
    "multicam_linear_color": ("blender", ["--dataset-loader=multicam",
                                          "--linear-color=true",
                                          "--white-bkgd=false"]),
    "multicam_metadata": ("meta", ["--dataset-loader=multicam"]),
    "llff_ndc_spiral": ("llff", ["--dataset-loader=llff", "--llff-hold=3",
                                 "--render-path=true"]),
    "llff_spherify": ("llff", ["--dataset-loader=llff", "--llff-hold=3",
                               "--spherify=true"]),
    "llff_csv_poses": ("llff_csv", ["--dataset-loader=llff",
                                    "--llff-hold=2"]),
    "bin_dump": ("bin", ["--dataset-loader=bin"]),
}


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("case", sorted(LOADERS))
def test_loader_byte_equal_to_jax(scenes, monkeypatch, case, split):
    """Images, rays, image dims and rays, render-path rays, and three
    ``next`` batches with a ``peek`` among them (the numpy draw); pixels
    byte-equal unless linear colour."""
    monkeypatch.setattr(tbin, "USE_NATIVE", False)
    monkeypatch.setattr(jbin, "USE_NATIVE", False)
    scene, flags = LOADERS[case]
    flags = [*flags, "--batch-size=64", "--seed=3"]
    data = scenes[scene]
    exact = "--linear-color=true" not in flags
    tds = create_dataset(split, data, parse_flags(flags))
    jds = j_dataset(split, data, jparse(flags))
    try:
        same_pixels(tds.images, jds.images, "images", exact)
        same_rays(tds.rays, jds.rays, "rays")
        assert tds.num_images == jds.num_images
        assert tds.pool_size == jds.pool_size
        for i in range(tds.num_images):
            assert tds.image_dims(i) == jds.image_dims(i)
            (tr, tg), (jr, jg) = tds.image_rays(i), jds.image_rays(i)
            same_rays(tr, jr, f"image_rays({i})")
            same_pixels(tg, jg, f"image_rays({i}) pixels", exact)
        if getattr(jds, "render_poses", 0) is not None and hasattr(
                jds, "render_path_rays"):
            tpath, jpath = tds.render_path_rays(), jds.render_path_rays()
            assert len(tpath) == len(jpath) > 0
            for k, ((tr, tdim), (jr, jdim)) in enumerate(zip(tpath, jpath)):
                assert tdim == jdim
                same_rays(tr, jr, f"render path frame {k}")
        for k in range(3):
            if k == 1:
                same_rays(tds.peek()[0], jds.peek()[0], "peek")
            (tr, tp), (jr, jp) = next(tds), next(jds)
            same_rays(tr, jr, f"batch {k}")
            same_pixels(tp, jp, f"batch {k} pixels", exact)
    finally:
        tds.close()
        jds.close()


def test_llff_path_lengths_and_hold(scenes):
    """The spiral and the spherified circle have 120 frames; llff_hold=3
    holds out images 0 and 3 of 6."""
    for flag in ("--render-path=true", "--spherify=true"):
        cfg = parse_flags(["--dataset-loader=llff", "--llff-hold=3", flag])
        with create_dataset("test", scenes["llff"], cfg) as ds:
            assert ds.num_images == 2
            assert len(ds.render_path_rays()) == 120


def test_native_loader_batches_equal_jax(scenes):
    """One worker: the batches are a function of the file and the seed."""
    if not jnative.native_available() or not tnative.native_available():
        pytest.skip("no C++ toolchain to build native/ray_loader.cpp")
    assert tnative.library_path().parent.name == "build"
    jl = jnative.NativeRayLoader(scenes["bin"], 32, seed=42, workers=1)
    tl = tnative.NativeRayLoader(scenes["bin"], 32, seed=42, workers=1)
    try:
        assert tl.num_records == jl.num_records == 3 * 16 * 16
        for k in range(3):
            (tr, tp), (jr, jp) = next(tl), next(jl)
            same_rays(tr, jr, f"batch {k}")
            same_bytes(tp, jp, f"batch {k} pixels")
    finally:
        tl.close()
        jl.close()
    cfg = parse_flags(["--dataset-loader=bin", "--batch-size=16"])
    with create_dataset("train", scenes["bin"], cfg) as ds:
        assert isinstance(ds._native, tnative.NativeRayLoader)
        rays, pixels = next(ds)
        assert pixels.shape == (16, 3) and rays.origins.shape == (16, 3)
    assert ds._native is None


@pytest.fixture(scope="module")
def multicam_scene(tmp_path_factory):
    """The port's synthetic Blender scene at 32x32 (test view at 32, 16, 8
    and 4 pixels as Multicam) and a JAX checkpoint of the initial state."""
    from nerf_or_nothing_tpu import checkpoint as jckpt
    from nerf_or_nothing_tpu.train import init_train_state

    root = tmp_path_factory.mktemp("torch_multicam")
    scene = str(root / "scene")
    write_scene(scene, n_train=1, n_test=1, size=32)
    ckpt = str(root / "ckpt")
    flags = [f"--data-dir={scene}", f"--checkpoint-dir={ckpt}", *MODEL,
             "--dataset-loader=multicam"]
    jckpt.save_checkpoint(ckpt, init_train_state(jparse(flags)))
    return scene, flags


def test_run_eval_multicam_matches_jax(multicam_scene, capsys):
    _, flags = multicam_scene
    assert trun.main(["eval", *flags, "--device=cpu"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('{"eval"')][-1]
    port = json.loads(line)["eval"]
    ref = jrun.evaluate(jparse(flags))
    assert sorted(port) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("loader", ["blender", "llff", "multicam"])
def test_run_render_path_pngs_match_jax(scenes, multicam_scene, tmp_path,
                                        loader):
    """Two frames of each loader's render path (orbit, spiral, orbit at
    the sharpest scale), from the same JAX checkpoint."""
    _, flags = multicam_scene
    flags = [f for f in flags if not f.startswith(("--data-dir",
                                                   "--dataset-loader"))]
    data = multicam_scene[0] if loader != "llff" else scenes["llff"]
    flags += [f"--data-dir={data}", f"--dataset-loader={loader}",
              "--render-path=true"]
    t_out, j_out = str(tmp_path / "port"), str(tmp_path / "jax")
    assert trun.main(["render", *flags, "--device=cpu", f"--out={t_out}",
                      "--max-images=2"]) == 0
    jrun.render(jparse(flags), j_out, max_images=2)
    names = sorted(os.listdir(j_out))
    assert sorted(os.listdir(t_out)) == names == ["render_000.png",
                                                  "render_001.png"]
    for n in names:
        a = np.asarray(Image.open(os.path.join(t_out, n)), np.int16)
        b = np.asarray(Image.open(os.path.join(j_out, n)), np.int16)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1, n


@pytest.mark.parametrize("shape", [(2, 2), (3, 5), (4, 4), (5, 4), (7, 9)])
def test_perceptual_proxy_small_images_match_jax(shape):
    """Multicam's coarsest scales: under 8 pixels a side JAX gives a value
    (4-7 pixels) or NaN (2-3), and so must the port."""
    import jax.numpy as jnp

    from nerf_or_nothing_tpu.ops.perceptual import perceptual_distance as jp
    from nerf_or_nothing_tpu_torch.ops.perceptual import perceptual_distance

    rng = np.random.default_rng(sum(shape))
    a, b = (rng.uniform(size=(*shape, 3)).astype(np.float32) for _ in "ab")
    port = float(perceptual_distance(torch.from_numpy(a), torch.from_numpy(b)))
    ref = float(jp(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(port, ref, rtol=1e-5)
