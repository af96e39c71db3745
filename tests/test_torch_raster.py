"""The port's rasterizer (texpose_tpu_torch.raster) against the JAX
package's, on the analytic sphere of tests/test_raster.py:

  * the numpy shaders (nocs_attrs, vertex_normals, transform_verts,
    normal_from_depth) bit for bit against JAX's copies;
  * torch_raster.rasterize / interpolate against jax_raster with the
    bounds JAX holds its two backends to (coverage agreement > 0.999,
    depth rtol 1e-3 where both cover, NOCS median |Δ| < 1e-3), and
    against the analytic sphere as JAX's native backend is;
  * soft_silhouette at atol 1e-5;
  * the native backend bit for bit against JAX's native backend;
  * a native build that fails raises, and "auto" never swaps backends.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from texpose_tpu.data.fixture import (_icosphere, _orbit_pose,
                                      _render_sphere, CAM_K)
from texpose_tpu.raster import jax_raster
from texpose_tpu.raster import native as jax_native
from texpose_tpu.raster import shaders as jax_shaders
from texpose_tpu_torch.raster import (MeshRenderer, native, shaders,
                                      torch_raster)

H, W = 120, 160
RADIUS = 60.0
DIST = 400.0


@pytest.fixture(scope="module")
def scene():
    K = CAM_K.copy()
    K[:2] *= 0.25
    verts, faces = _icosphere(RADIUS, subdiv=3)
    pose = _orbit_pose(0.7, 0.3, DIST).astype(np.float32)
    analytic = _render_sphere(pose, K, H, W, RADIUS, flat=True)
    colors = np.random.default_rng(0).uniform(
        size=(len(verts), 3)).astype(np.float32)
    return (verts.astype(np.float32), faces.astype(np.int32), pose,
            K.astype(np.float32), analytic, colors)


def _cam(scene):
    verts, faces, pose, K, _, _ = scene
    return shaders.transform_verts(verts, pose).astype(np.float32)


@pytest.mark.parametrize("name", ["nocs_attrs", "vertex_normals",
                                  "transform_verts", "normal_from_depth"])
def test_numpy_shaders_bit_for_bit(scene, name):
    verts, faces, pose, K, analytic, _ = scene
    args = {"nocs_attrs": (verts,), "vertex_normals": (verts, faces),
            "transform_verts": (verts, pose),
            "normal_from_depth": (pose, analytic["depth_mm"].astype(
                np.float32), K, H, W)}[name]
    np.testing.assert_array_equal(getattr(shaders, name)(*args),
                                  getattr(jax_shaders, name)(*args))


def _jax_raster(scene):
    _, faces, _, K, _, _ = scene
    return [np.asarray(a) for a in jax_raster.rasterize(
        jnp.asarray(_cam(scene)), jnp.asarray(faces), jnp.asarray(K), H, W)]


def _torch_raster(scene, **kw):
    _, faces, _, K, _, _ = scene
    return torch_raster.rasterize(torch.as_tensor(_cam(scene)),
                                  torch.as_tensor(faces), torch.as_tensor(K),
                                  H, W, **kw)


def test_rasterize_matches_jax(scene):
    zj, fj, bj = _jax_raster(scene)
    z, f, b = _torch_raster(scene)
    assert z.dtype == torch.float32 and f.dtype == torch.int32
    z, f, b = z.numpy(), f.numpy(), b.numpy()
    assert ((f >= 0) == (fj >= 0)).mean() > 0.999
    both = (f >= 0) & (fj >= 0)
    assert both.sum() > 1000
    np.testing.assert_allclose(z[both], zj[both], rtol=1e-3)
    assert ((f == fj) | ~both).all()
    np.testing.assert_allclose(b[both], bj[both], atol=1e-5)


def test_interpolate_matches_jax(scene):
    _, faces, _, _, _, colors = scene
    zj, fj, bj = _jax_raster(scene)
    nocs = shaders.nocs_attrs(scene[0])
    for attrs in (nocs, colors):
        j = np.asarray(jax_raster.interpolate(
            jnp.asarray(faces), jnp.asarray(fj), jnp.asarray(bj),
            jnp.asarray(attrs)))
        t = torch_raster.interpolate(torch.as_tensor(faces),
                                     torch.as_tensor(fj), torch.as_tensor(bj),
                                     torch.as_tensor(attrs)).numpy()
        cov = fj >= 0
        assert np.median(np.abs(t[cov] - j[cov])) < 1e-3
        np.testing.assert_allclose(t, j, atol=1e-6)


def test_rasterize_bands_and_chunks_give_the_dense_result(scene):
    """The memory bound (row bands of max_elems pairs) and the chunk size
    change only how the work is cut, not the result."""
    z, f, b = _torch_raster(scene)
    for kw in ({"max_elems": 1 << 18}, {"chunk": 128},
               {"chunk": 4096, "max_elems": 1 << 20}):
        z2, f2, b2 = _torch_raster(scene, **kw)
        np.testing.assert_array_equal(f2.numpy(), f.numpy(), err_msg=kw)
        np.testing.assert_allclose(z2.numpy(), z.numpy(), rtol=1e-6)
        np.testing.assert_allclose(b2.numpy(), b.numpy(), atol=1e-6)


def test_rasterize_faces_behind_the_camera_are_skipped(scene):
    """A face with a vertex at z ≤ 0 is not drawn; an all-hidden mesh
    gives an empty frame."""
    _, faces, _, K, _, _ = scene
    vc = _cam(scene)
    vc[:, 2] -= DIST + RADIUS + 1.0             # every vertex behind
    z, f, b = torch_raster.rasterize(torch.as_tensor(vc),
                                     torch.as_tensor(faces),
                                     torch.as_tensor(K), H, W)
    assert (f.numpy() == -1).all() and (z.numpy() == 0).all()
    assert (b.numpy() == 0).all()


def test_soft_silhouette_matches_jax(scene):
    _, faces, _, K, _, _ = scene
    j = np.asarray(jax_raster.soft_silhouette(
        jnp.asarray(_cam(scene)), jnp.asarray(faces), jnp.asarray(K), H, W))
    t = torch_raster.soft_silhouette(
        torch.as_tensor(_cam(scene)), torch.as_tensor(faces),
        torch.as_tensor(K), H, W).numpy()
    np.testing.assert_allclose(t, j, atol=1e-5)
    assert t.max() > 0.99 and t.min() < 0.01


def test_native_bit_for_bit_against_jax_native(scene):
    _, faces, _, K, _, colors = scene
    vc = _cam(scene)
    ours = native.rasterize(vc, faces, K, H, W)
    ref = jax_native.rasterize(vc, faces, K, H, W)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        native.interpolate(faces, ours[1], ours[2], colors),
        jax_native.interpolate(faces, ref[1], ref[2], colors))


@pytest.mark.parametrize("mode", ["mask", "nocs", "color", "normal",
                                  "feature"])
def test_renderer_torch_backend_against_native(scene, mode):
    """MeshRenderer's two backends, mode by mode, under JAX's bounds
    between its backends; the native one bit for bit against JAX's
    renderer."""
    verts, faces, pose, K, _, colors = scene
    kw = dict(features=colors[:, :2]) if mode == "feature" else {}
    rn = MeshRenderer(verts, faces, colors=colors, H=H, W=W,
                      backend="native")
    rt = MeshRenderer(verts, faces, colors=colors, H=H, W=W,
                      backend="torch")
    rj = jax_shaders.MeshRenderer(verts, faces, colors=colors, H=H, W=W,
                                  backend="native")
    n, dn = rn.render(pose[None], K, mode=mode, **kw)
    t, dt = rt.render(pose[None], K, mode=mode, **kw)
    j, dj = rj.render(pose[None], K, mode=mode, **kw)
    np.testing.assert_array_equal(n, j)
    np.testing.assert_array_equal(dn, dj)
    assert t.shape == n.shape and t.dtype == n.dtype == np.float32
    assert ((dn > 0) == (dt > 0)).mean() > 0.999
    both = (dn[0] > 0) & (dt[0] > 0)
    np.testing.assert_allclose(dt[0][both], dn[0][both], rtol=1e-3)
    assert np.median(np.abs(t[0][both] - n[0][both])) < 1e-3


def test_torch_backend_matches_analytic_sphere(scene):
    """JAX's native-backend test against the analytic sphere, run on the
    port's torch rasterizer."""
    verts, faces, pose, K, analytic, _ = scene
    r = MeshRenderer(verts, faces, H=H, W=W, backend="torch")
    mask, depth = r.render(pose[None], K, mode="mask")
    hit = analytic["hit"]
    assert ((mask[0, ..., 0] > 0) == hit).mean() > 0.995
    interior = hit & (mask[0, ..., 0] > 0)
    err = np.abs(depth[0][interior] - analytic["depth_mm"][interior])
    assert np.median(err) / DIST < 0.01
    nocs, _ = r.render(pose[None], K, mode="nocs")
    assert np.median(np.abs(nocs[0][interior]
                            - analytic["nocs"][interior])) < 0.05


def test_auto_backend_by_device():
    v, f = _icosphere(10.0, subdiv=1)
    assert MeshRenderer(v, f, H=8, W=8).backend == "native"
    assert MeshRenderer(v, f, H=8, W=8, device="cpu",
                        backend="torch").backend == "torch"
    with pytest.raises(ValueError, match="backend"):
        MeshRenderer(v, f, H=8, W=8, backend="jax")


def test_native_build_failure_raises(monkeypatch):
    """No g++ (or a failing build): the native backend raises, and "auto"
    on the CPU raises too instead of swapping to the torch rasterizer."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    v, f = _icosphere(10.0, subdiv=1)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.load_library()
    for backend in ("native", "auto"):
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            MeshRenderer(v, f, H=8, W=8, backend=backend)


def test_native_compile_error_raises(monkeypatch, tmp_path):
    bad = tmp_path / "raster.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load_library()
