"""Mesh rasterization for the preprocessing CLIs (port of
texpose_tpu.raster): the numpy shaders and ``MeshRenderer``, the plain
PyTorch rasterizer (``torch_raster``, on the renderer's device) and the
native C++ z-buffer (``native``, built with g++ at first use)."""

from .shaders import (MeshRenderer, nocs_attrs, vertex_normals,
                      transform_verts, normal_from_depth)
from . import native
from . import torch_raster
