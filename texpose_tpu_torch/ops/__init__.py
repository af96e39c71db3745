"""Tensor ops (port of texpose_tpu.ops)."""

from .posenc import positional_encoding, posenc_with_identity
from .render import sample_depth, composite, composite_static_transient
from .grid_sample import grid_sample, grid_sample_table
from .color import rgb_to_lab, normalize_lab, srgb_to_linear, linear_to_srgb
from .ssim import ssim
from .knn import (pairwise_sqdist, knn_points, knn_gather, p2p_distance,
                  chamfer_distance)
