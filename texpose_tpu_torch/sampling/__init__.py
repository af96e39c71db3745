"""Patch-coordinate and continuous-ray sampling (port of
texpose_tpu/sampling)."""

from .patch import (flex_patch_coords, current_scale_bounds,
                    full_image_coords, rescale_patch_coords)
from .ray_sampler import coords_to_pixels, get_rays, get_bounds, get_image
