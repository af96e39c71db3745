// Native host mesh rasterizer.
//
// Fills the role PyTorch3D's C++/CUDA rasterizer plays in the reference
// (the reference TexPose code, tools/mvrenderer.py:33-178): z-buffer triangle
// rasterization with per-pixel face id + barycentric coordinates, used by
// the offline preprocessing CLIs (compute_box / compute_surfelinfo).
//
// Conventions:
//   * verts are CAMERA-frame (x right, y down, z forward — OpenCV), any unit
//   * pinhole projection u = fx*x/z + cx, v = fy*y/z + cy onto pixel centers
//     (pixel (i,j) center at (j+0.5, i+0.5))
//   * no backface culling (matches pytorch3d default cull_backfaces=False)
//   * screen-space barycentrics for attribute/z interpolation (matches
//     pytorch3d default perspective_correct=False)
//   * zbuf: camera z of the nearest face, 0 where no face covers the pixel
//
// Build: g++ -O3 -march=native -shared -fPIC at first use (see native.py,
// which builds it into build/texpose_tpu_torch/); pure C ABI for ctypes.
// A copy of texpose_tpu/raster/csrc/raster.cpp: the port imports nothing
// of the JAX package.

#include <cmath>
#include <cstdint>
#include <algorithm>
#include <vector>

extern "C" {

// Rasterize one mesh view.
//   verts_cam [V*3], faces [F*3], K [9] row-major, out buffers [H*W].
//   face_id initialized to -1, zbuf to 0, bary to 0 by the caller or here.
void rasterize_mesh(const float* verts_cam, const int32_t* faces,
                    int32_t V, int32_t F, const float* K,
                    int32_t H, int32_t W,
                    float* zbuf, int32_t* face_id, float* bary) {
  const float fx = K[0], cx = K[2], fy = K[4], cy = K[5];
  const float eps = 1e-8f;

  const int64_t HW = (int64_t)H * W;
  for (int64_t p = 0; p < HW; ++p) {
    zbuf[p] = 0.0f;
    face_id[p] = -1;
    bary[p * 3] = bary[p * 3 + 1] = bary[p * 3 + 2] = 0.0f;
  }

  // project all vertices once
  std::vector<float> u(V), v(V), z(V);
  for (int32_t i = 0; i < V; ++i) {
    const float x = verts_cam[i * 3], y = verts_cam[i * 3 + 1],
                zz = verts_cam[i * 3 + 2];
    z[i] = zz;
    const float iz = (zz > eps) ? 1.0f / zz : 0.0f;
    u[i] = fx * x * iz + cx;
    v[i] = fy * y * iz + cy;
  }

  for (int32_t f = 0; f < F; ++f) {
    const int32_t i0 = faces[f * 3], i1 = faces[f * 3 + 1],
                  i2 = faces[f * 3 + 2];
    if (z[i0] <= eps || z[i1] <= eps || z[i2] <= eps) continue;  // behind cam
    const float u0 = u[i0], v0 = v[i0], u1 = u[i1], v1 = v[i1],
                u2 = u[i2], v2 = v[i2];

    // screen bbox clamped to the image (pixel centers at +0.5)
    int32_t x_min = (int32_t)std::floor(std::min({u0, u1, u2}) - 0.5f);
    int32_t x_max = (int32_t)std::ceil(std::max({u0, u1, u2}) - 0.5f);
    int32_t y_min = (int32_t)std::floor(std::min({v0, v1, v2}) - 0.5f);
    int32_t y_max = (int32_t)std::ceil(std::max({v0, v1, v2}) - 0.5f);
    x_min = std::max(x_min, 0); x_max = std::min(x_max, W - 1);
    y_min = std::max(y_min, 0); y_max = std::min(y_max, H - 1);
    if (x_min > x_max || y_min > y_max) continue;

    const float area = (u1 - u0) * (v2 - v0) - (u2 - u0) * (v1 - v0);
    if (std::fabs(area) < eps) continue;   // degenerate
    const float inv_area = 1.0f / area;

    for (int32_t py = y_min; py <= y_max; ++py) {
      const float pyc = py + 0.5f;
      for (int32_t px = x_min; px <= x_max; ++px) {
        const float pxc = px + 0.5f;
        // barycentrics via edge functions (sign-normalized by area)
        float w0 = ((u1 - pxc) * (v2 - pyc) - (u2 - pxc) * (v1 - pyc)) * inv_area;
        float w1 = ((u2 - pxc) * (v0 - pyc) - (u0 - pxc) * (v2 - pyc)) * inv_area;
        float w2 = 1.0f - w0 - w1;
        if (w0 < 0.0f || w1 < 0.0f || w2 < 0.0f) continue;
        const float zp = w0 * z[i0] + w1 * z[i1] + w2 * z[i2];
        const int64_t p = (int64_t)py * W + px;
        if (face_id[p] < 0 || zp < zbuf[p]) {
          zbuf[p] = zp;
          face_id[p] = f;
          bary[p * 3] = w0; bary[p * 3 + 1] = w1; bary[p * 3 + 2] = w2;
        }
      }
    }
  }
}

// Interpolate per-vertex attributes at rasterized pixels.
//   attrs [V*C] → out [H*W*C]; background pixels get 0.
void interpolate_attributes(const int32_t* faces, const int32_t* face_id,
                            const float* bary, const float* attrs,
                            int32_t F, int32_t C, int32_t H, int32_t W,
                            float* out) {
  const int64_t HW = (int64_t)H * W;
  for (int64_t p = 0; p < HW; ++p) {
    const int32_t f = face_id[p];
    if (f < 0) {
      for (int32_t c = 0; c < C; ++c) out[p * C + c] = 0.0f;
      continue;
    }
    const int32_t i0 = faces[f * 3], i1 = faces[f * 3 + 1],
                  i2 = faces[f * 3 + 2];
    const float w0 = bary[p * 3], w1 = bary[p * 3 + 1], w2 = bary[p * 3 + 2];
    for (int32_t c = 0; c < C; ++c) {
      out[p * C + c] = w0 * attrs[(int64_t)i0 * C + c]
                     + w1 * attrs[(int64_t)i1 * C + c]
                     + w2 * attrs[(int64_t)i2 * C + c];
    }
  }
}

}  // extern "C"
