"""The port's visualization module (texpose_tpu_torch/utils/vis.py) against
the JAX package's, which draws its heatmaps with matplotlib:

  * the committed colormap tables (utils/colormaps.npz) equal matplotlib's
    plasma, turbo and viridis, so a later matplotlib that moves them fails
    here rather than drifting;
  * preprocess_vis_image is bit-equal to JAX's for every colormap on values
    at and one ulp either side of each k/256 bin edge, 0, 1, out of range
    and NaN, under two value ranges;
  * make_grid, center_crop (pad and crop) and the PNGs of dump_image_grid
    equal JAX's; tb_image hands the writer JAX's grid;
  * without matplotlib the module imports and colormaps, and the camera
    plots raise ImportError.
"""

import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

from texpose_tpu.utils import vis as jvis
from texpose_tpu_torch.utils import vis as tvis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CMAPS = ("plasma", "turbo", "viridis")


@pytest.mark.parametrize("name", CMAPS)
def test_committed_tables_equal_matplotlib(name):
    import matplotlib
    from texpose_tpu_torch.utils.make_colormaps import tables
    want = matplotlib.colormaps[name](np.arange(256))[:, :3]
    got = tvis.colormap_table(name)
    assert got.shape == (256, 3) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tables()[name], got)


def _edge_values():
    """Every bin edge k/256 (f32) and its f32 neighbours, 0, 1, values
    outside [0, 1], NaN, and seeded uniforms; [1, 1, 33, n/33]."""
    k = np.arange(257, dtype=np.float32) / np.float32(256)
    vals = np.concatenate([
        k, np.nextafter(k, np.float32(2)), np.nextafter(k, np.float32(-1)),
        np.array([0.0, 1.0, -0.0, -0.25, 1.25, 7.0, np.nan, np.nan],
                 np.float32),
        np.random.default_rng(0).random(64 * 33 - 3 * 257 - 8,
                                        dtype=np.float32)])
    return vals.reshape(1, 1, 64, 33)


@pytest.mark.parametrize("cmap", (None,) + CMAPS)
@pytest.mark.parametrize("from_range", [(0.0, 1.0), (0.3, 0.5)])
def test_preprocess_vis_image_bit_equal_to_jax(cmap, from_range):
    x = _edge_values()
    if from_range != (0.0, 1.0):
        x = x * np.float32(0.2) + np.float32(0.3)
    got = tvis.preprocess_vis_image(x, from_range, cmap)
    want = jvis.preprocess_vis_image(x, from_range, cmap)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (1, 1 if cmap is None else 3, 64, 33)
    np.testing.assert_array_equal(got, want)
    if cmap is not None:
        # NaN is the maps' "bad" color: black, not index 0's color
        nan = np.isnan(x[0, 0])
        assert nan.sum() == 2 and (got[0][:, nan] == 0).all()


@pytest.mark.parametrize("B,C", [(1, 3), (3, 1), (5, 3)])
def test_make_grid_matches_jax(B, C):
    x = np.random.default_rng(B).random((B, C, 7, 9), dtype=np.float32)
    for kw in ({}, {"num_rows": 1, "pad": 0, "pad_value": 0.5}):
        got, want = tvis.make_grid(x, **kw), jvis.make_grid(x, **kw)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw,size", [((60, 80), 256), ((61, 81), 64),
                                     ((300, 400), 256), ((257, 258), 256),
                                     ((64, 300), 128)])
def test_center_crop_matches_jax(hw, size):
    rng = np.random.default_rng(hw[0])
    for shape in (hw, hw + (1,), hw + (3,)):
        x = rng.random(shape, dtype=np.float32)
        got, want = tvis.center_crop(x, size), jvis.center_crop(x, size)
        assert got.shape == (size, size) + shape[2:]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("C,cmap,rng", [(3, None, (0, 1)),
                                        (1, None, (0, 1)),
                                        (1, "plasma", (0.3, 0.5)),
                                        (1, "turbo", (0, 0.7)),
                                        (1, "viridis", (-1, 2))])
def test_dump_image_grid_png_matches_jax(tmp_path, C, cmap, rng):
    x = np.random.default_rng(C).random((2, C, 12, 10), dtype=np.float32)
    x[0, 0, 0, :3] = np.nan
    p = tvis.dump_image_grid(str(tmp_path / "t" / "a.png"), x, rng, cmap)
    j = jvis.dump_image_grid(str(tmp_path / "j" / "a.png"), x, rng, cmap)
    got, want = cv2.imread(p, -1), cv2.imread(j, -1)
    assert got.shape == want.shape == (2 * 14 + 2, 14, 3)
    np.testing.assert_array_equal(got, want)


def test_tb_image_hands_the_writer_jax_grid():
    class Rec:
        def __init__(self):
            self.calls = []

        def image(self, step, name, img, split="train"):
            self.calls.append((step, name, split, img))

    x = np.random.default_rng(3).random((2, 1, 8, 8), dtype=np.float32)
    t, j = Rec(), Rec()
    tvis.tb_image(t, 5, "val", "depth", x, (0.2, 0.8), "plasma")
    jvis.tb_image(j, 5, "val", "depth", x, (0.2, 0.8), "plasma")
    (ts, tn, tsp, timg), = t.calls
    (js, jn, jsp, jimg), = j.calls
    assert (ts, tn, tsp) == (js, jn, jsp) == (5, "depth", "val")
    np.testing.assert_array_equal(timg, jimg)


def test_metrics_writer_image_goes_to_tensorboard_only(tmp_path):
    from texpose_tpu_torch.utils.metrics import MetricsWriter
    img = np.random.default_rng(0).random((3, 6, 5), dtype=np.float32)
    off = MetricsWriter(str(tmp_path / "off"))
    off.image(1, "rgb", img)
    off.close()
    assert os.listdir(tmp_path / "off") == ["metrics.jsonl"]
    assert open(tmp_path / "off" / "metrics.jsonl").read() == ""
    on = MetricsWriter(str(tmp_path / "on"), use_tb=True)
    assert on.tb is not None
    on.image(1, "rgb", img, split="val")
    on.close()
    events = [f for f in os.listdir(tmp_path / "on")
              if f.startswith("events.out.tfevents")]
    assert len(events) == 1
    assert b"val/rgb" in open(tmp_path / "on" / events[0], "rb").read()
    assert open(tmp_path / "on" / "metrics.jsonl").read() == ""


def test_vis_without_matplotlib(tmp_path):
    """The module imports and colormaps with matplotlib unimportable; the
    camera plots raise ImportError naming it."""
    code = f"""
import sys
sys.modules["matplotlib"] = None
sys.path.insert(0, {REPO!r})
import numpy as np
from texpose_tpu_torch.utils import vis
x = np.linspace(0, 1, 40, dtype=np.float32).reshape(1, 1, 5, 8)
out = vis.preprocess_vis_image(x, cmap="turbo")
assert out.shape == (1, 3, 5, 8) and np.isfinite(out).all()
vis.dump_image_grid({str(tmp_path / "g.png")!r}, x, cmap="viridis")
pose = np.eye(3, 4)[None].repeat(2, 0)
for fn, args in ((vis.plot_cameras, (pose, {str(tmp_path / "c.png")!r})),
                 (vis.plot_pose_trajectory,
                  ([pose], {str(tmp_path / "p.png")!r}))):
    try:
        fn(*args)
    except ImportError as e:
        assert "matplotlib" in str(e), e
    else:
        raise SystemExit(fn.__name__ + " did not raise")
assert "matplotlib.pyplot" not in sys.modules
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(tmp_path), timeout=120)
    assert r.returncode == 0 and r.stdout.split()[-1] == "ok", r.stderr
    assert os.path.exists(tmp_path / "g.png")
    assert not os.path.exists(tmp_path / "c.png")


def test_camera_plots_write_pngs_with_matplotlib(tmp_path):
    rng = np.random.default_rng(0)
    poses = np.concatenate([np.eye(3)[None].repeat(4, 0),
                            rng.normal(size=(4, 3, 1))], axis=2)
    p = tvis.plot_cameras(poses, str(tmp_path / "c" / "cameras.png"),
                          poses_ref=poses + 0.1)
    q = tvis.plot_pose_trajectory([poses, poses * 1.1],
                                  str(tmp_path / "p.png"))
    for path in (p, q):
        img = cv2.imread(path)
        assert img is not None and img.shape[2] == 3
    pts, edges = tvis._camera_wireframe(poses[0], 0.5)
    jpts, jedges = jvis._camera_wireframe(poses[0], 0.5)
    np.testing.assert_array_equal(pts, jpts)
    assert edges == jedges
