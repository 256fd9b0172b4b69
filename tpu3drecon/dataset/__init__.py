"""Dataset layer: object model, COLMAP loading, synthetic scenes, noising.

Public surface mirrors the reference's ``src/dataset`` package (SURVEY.md §1
L1) while the packed problem containers in ``tpu3drecon.problems`` carry the
actual accelerator data path.
"""

from tpu3drecon.dataset.camera_pose import (
    CameraPose,
    CoordinateSystem,
    InvalidInputFormatErr,
    PoseFormat,
    TransformationDirection,
)
from tpu3drecon.dataset.camera_set import CameraSet
from tpu3drecon.dataset.loader import (
    export_in_colmap_format,
    get_intrinsics,
    load_colmap_cameras,
    load_colmap_dataset,
)
from tpu3drecon.dataset.model import (
    Camera,
    CameraIntrinsics,
    DatasetEntry,
    ImageMetadata,
    Point2D,
    Point3D,
    params_to_intrinsics,
)
from tpu3drecon.dataset.scene import Dataset
from tpu3drecon.dataset.synthetic import (
    SyntheticScene,
    make_scene,
    perturb_scene,
    scene_to_ba_problem,
    scene_to_colmap_model,
    scene_to_pose_problem,
)
