"""The port's preprocessing CLIs (``python -m texpose_tpu_torch.compute_box``
and ``.compute_surfelinfo``) against the JAX package's top-level CLIs on the
generated fixture, run as tests/test_preprocess_cli.py runs them:

  * box npz: the same files; max |Δt| ≤ 1e-2 mm where both sides are
    valid, and the valid masks differ only where JAX's t_far or
    t_far − t_near is within 1e-3 mm of 0 (gt, predicted and multi-object
    poses);
  * surfel files through the native backend: identical to the JAX CLI's
    (the same C++ source, built with the same flags);
  * surfel files through the torch rasterizer: within the bounds JAX holds
    its two rasterizers to (tests/test_raster.py: coverage agreement >
    0.999, NOCS median |Δ| < 1e-3 where both cover, which in uint8 PNGs is
    a median of 0; the normals' median |Δ| < 1e-3);
  * ``--vis`` (PNG and violation fraction < 0.05, as JAX's) and the empty
    split.
"""

import os
import sys

import cv2
import numpy as np
import pytest

from texpose_tpu.data.fixture import generate_fixture, generate_fixture_multi

H, W = 120, 160


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return generate_fixture(str(tmp_path_factory.mktemp("bop")),
                            n_train=3, n_test=1, scene="scene_all",
                            image_scale=0.25, crop_res=32)


@pytest.fixture(scope="module")
def root_multi(tmp_path_factory):
    return generate_fixture_multi(str(tmp_path_factory.mktemp("bop_multi")),
                                  n_train=3, n_test=1)


def box_argv(root, out, *extra, scene="scene_all", obj="ball", split=None):
    return ["--data_root", os.path.join(root, "lm"), "--folder", "000001",
            "--split_file", split or os.path.join(
                root, "splits", "lm", obj, scene, "train.txt"),
            "--cad_path", os.path.join(root, "lm", "models",
                                       "obj_000001.ply"),
            "--pred_loop", "init_calib", "--height", str(H),
            "--width", str(W), "--target_folder", out, *extra]


@pytest.mark.parametrize("kind", ["pred", "gt", "multi"])
def test_compute_box_matches_jax(root, root_multi, tmp_path, kind):
    import compute_box as jax_cli
    from texpose_tpu_torch import compute_box as port_cli
    extra = {"pred": (), "gt": ("--use_gt_pose",),
             "multi": ("--multi_obj",)}[kind]
    r, scene = ((root_multi, "scene_multi") if kind == "multi"
                else (root, "scene_all"))
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_cli.main(box_argv(r, jout, *extra, scene=scene))
    port_cli.main(box_argv(r, pout, *extra, "--device=cpu", scene=scene))
    sub = "gt_box" if kind == "gt" else "pred_box_init_calib"
    files = sorted(os.listdir(os.path.join(jout, sub)))
    assert files == sorted(os.listdir(os.path.join(pout, sub)))
    assert len(files) == 3
    if kind == "multi":
        assert all(f.endswith("_000000.npz") for f in files), files
    for f in files:
        j = np.load(os.path.join(jout, sub, f))["data"]
        p = np.load(os.path.join(pout, sub, f))["data"]
        assert p.shape == j.shape == (2, H, W) and p.dtype == np.float32
        vj, vp = j[1] > 0, p[1] > 0
        both = vj & vp
        assert both.sum() > 100
        assert np.abs(p[:, both] - j[:, both]).max() <= 1e-2
        differ = vj != vp
        near_edge = (np.abs(j[1]) < 1e-3) | (np.abs(j[1] - j[0]) < 1e-3)
        assert not (differ & ~near_edge).any(), f


def test_compute_box_vis(root, tmp_path):
    """--vis writes the overlay PNG; the violation fraction, from the
    native and the torch rasterizer's depth, is < 0.05 and within one
    pixel's share of the JAX CLI's."""
    import compute_box as jax_cli
    from texpose_tpu.data.cad import CADModel as JCAD
    from texpose_tpu_torch import compute_box as port_cli
    from texpose_tpu_torch.data import bop
    from texpose_tpu_torch.data.cad import CADModel
    import json
    out = str(tmp_path / "target")
    port_cli.main(box_argv(root, out, "--vis", "--device=cpu"))
    assert os.path.exists(os.path.join(out, "pred_box_init_calib",
                                       "box_vis.png"))
    cad = os.path.join(root, "lm", "models", "obj_000001.ply")
    lines = bop.readlines(os.path.join(root, "splits", "lm", "ball",
                                       "scene_all", "train.txt"))
    frame = int(bop.split_line(lines[-1])[2])
    scene_dir = os.path.join(root, "lm", "000001")
    with open(os.path.join(scene_dir, "scene_pred_init_calib.json")) as f:
        rec = json.load(f)[str(frame)][0]
    with open(os.path.join(scene_dir, "scene_camera.json")) as f:
        K = np.array(json.load(f)[str(frame)]["cam_K"],
                     np.float32).reshape(3, 3)[None]
    pose = np.concatenate(
        [np.array(rec["cam_R_m2c"], np.float32).reshape(3, 3),
         np.array(rec["cam_t_m2c"], np.float32)[:, None]], axis=1)[None]
    box = np.load(os.path.join(out, "pred_box_init_calib",
                               f"{frame:06d}.npz"))["data"]
    frac = port_cli.dump_box_vis(str(tmp_path / "qa.png"), CADModel(cad),
                                 pose, K, box, H, W, "cpu")
    frac_j = jax_cli.dump_box_vis(str(tmp_path / "qa_j.png"), JCAD(cad),
                                  pose, K, box, H, W)
    depth_t = port_cli.render_depth(CADModel(cad), pose, K, H, W, "cpu")
    from texpose_tpu_torch.raster import MeshRenderer
    m = CADModel(cad)
    _, depth_torch = MeshRenderer(m.vertices, m.faces, H=H, W=W,
                                  backend="torch").render(pose, K, "mask")
    frac_torch, obj, _ = port_cli.box_violations(depth_torch[0], box)
    assert frac < 0.05 and frac_torch < 0.05
    assert abs(frac - frac_j) <= 1.0 / max(int((depth_t > 0).sum()), 1)
    assert obj.sum() > 100


def test_compute_box_vis_empty_split(root, tmp_path):
    from texpose_tpu_torch import compute_box as port_cli
    empty = str(tmp_path / "empty.txt")
    open(empty, "w").write("\n")
    out = str(tmp_path / "target")
    port_cli.main(box_argv(root, out, "--vis", "--device=cpu", split=empty))
    assert os.listdir(os.path.join(out, "pred_box_init_calib")) == []


def test_compute_box_vis_without_matplotlib_raises_up_front(root, tmp_path,
                                                           monkeypatch):
    from texpose_tpu_torch import compute_box as port_cli
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = str(tmp_path / "target")
    with pytest.raises(ImportError):
        port_cli.main(box_argv(root, out, "--vis", "--device=cpu"))
    assert not os.path.exists(out)


def surfel_cfg(root, geo_dir, port):
    if port:
        from texpose_tpu_torch.utils.config import Config, process_options
    else:
        from texpose_tpu.utils.config import Config, process_options
    return process_options(Config({
        "data": {
            "root": root, "dataset": "lm", "object": "ball",
            "scene": "scene_all", "image_size": [32, 32],
            "pose_source": "predicted", "pose_loop": "init_calib",
            "erode_mask": None, "mask_visib_source": "mask_visib",
            "scene_info_source": None, "box_format": "wh",
            "multi_obj": None, "train_sub": None,
            "splits_root": os.path.join(root, "splits"),
        },
        "nerf": {"depth": {"scale": 10, "range": [0, 3]}},
        "render": {"geo_save_dir": geo_dir},
        "cad_path": os.path.join(root, "lm", "models", "obj_000001.ply"),
        "model": "nerf_pretrain", "device": "cpu",
    }))


SUBS = ("rgbsyn_init_calib", "nocs_init_calib", "normal_init_calib")


def _read(path):
    if path.endswith(".npz"):
        return np.load(path)["data"]
    return cv2.imread(path, -1)


@pytest.fixture(scope="module")
def jax_surfels(root, tmp_path_factory):
    import compute_surfelinfo as jax_cli
    geo = str(tmp_path_factory.mktemp("geo_jax"))
    jax_cli.compute_surfelinfo(surfel_cfg(root, geo, port=False))
    return geo


@pytest.mark.parametrize("backend", ["native", "torch"])
def test_compute_surfelinfo_matches_jax(root, jax_surfels, tmp_path,
                                        backend):
    from texpose_tpu_torch import compute_surfelinfo as port_cli
    geo = str(tmp_path / "geo")
    cfg = surfel_cfg(root, geo, port=True)
    if backend == "native":
        # --device=cpu: "auto" is the native rasterizer, as JAX's CLI
        port_cli.main([f"--{k}={v}" for k, v in _flat(cfg.to_dict())])
    else:
        port_cli.compute_surfelinfo(cfg, backend="torch")
    for sub in SUBS:
        names = sorted(os.listdir(os.path.join(jax_surfels, sub)))
        assert names == sorted(os.listdir(os.path.join(geo, sub)))
        assert len(names) == 3
        for n in names:
            j = _read(os.path.join(jax_surfels, sub, n))
            p = _read(os.path.join(geo, sub, n))
            assert p.shape == j.shape and p.dtype == j.dtype, (sub, n)
            if backend == "native":
                np.testing.assert_array_equal(p, j, err_msg=f"{sub}/{n}")
                continue
            if sub.startswith("rgbsyn"):
                assert ((p[..., 3] > 0) == (j[..., 3] > 0)).mean() > 0.999
            else:
                cov = np.abs(j).sum(-1) > 0
                cov &= np.abs(p).sum(-1) > 0
                assert cov.sum() > 50
                d = np.abs(p[cov].astype(np.float64) - j[cov])
                assert np.median(d) < (1e-3 if p.dtype == np.float32
                                       else 1e-3 * 255), (sub, n)


def _flat(d, prefix=""):
    """A config dict → (dotted key, value) pairs for the options system's
    command line (lists as [a,b])."""
    out = []
    for k, v in d.items():
        if k in ("H", "W", "output_path"):
            continue
        if isinstance(v, dict):
            out += _flat(v, f"{prefix}{k}.")
        elif isinstance(v, list):
            out.append((prefix + k, "[" + ",".join(map(str, v)) + "]"))
        else:
            out.append((prefix + k, "null" if v is None else v))
    return out
