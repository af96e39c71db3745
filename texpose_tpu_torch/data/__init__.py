"""Host-side BOP/LineMOD data pipeline and the synthetic fixture: numpy,
OpenCV and JSON only (the port's own copy of the JAX package's jax-free
``texpose_tpu.data``).  Samples are dicts of numpy arrays; the engines
upload them to the device."""

from .ply import load_ply, save_ply
from .cad import CADModel
from .crops import (bbox_to_crop, crop_by_pad, get_center_offset,
                    preprocess_intrinsics, get_edge, smooth_geo, erode_mask)
from . import bop
from .lm import LineMODDataset
from .lmsyn2real import LineMODSyn2RealDataset
from .fixture import generate_fixture
