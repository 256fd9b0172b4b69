"""tpu3drecon — an accelerator-resident 3D-reconstruction optimization framework.

Built from scratch with the capabilities of mokrueger/jaxopt-3D-reconstruction
(see SURVEY.md at the repo root): COLMAP dataset ingestion into packed
device-resident arrays, single-camera pose (PnP) refinement, full bundle
adjustment via a first-party Levenberg-Marquardt engine with an implicit
Schur-complement solve, mesh sharding for multi-chip scale, and a
benchmark/parity harness.
"""

__version__ = "0.2.0"
