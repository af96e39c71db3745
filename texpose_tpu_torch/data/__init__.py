"""Host-side BOP/LineMOD data pipeline and the synthetic fixture (the JAX
package's jax-free ``texpose_tpu.data``, shared rather than copied).
Samples are dicts of numpy arrays; the engines upload them to the device."""

from texpose_tpu.data import (  # noqa: F401
    LineMODDataset, LineMODSyn2RealDataset, generate_fixture)
