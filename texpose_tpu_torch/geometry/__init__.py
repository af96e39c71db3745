"""Camera/ray geometry and pose algebra (port of texpose_tpu.geometry)."""

from .pose import (
    pose_from_Rt, pose_invert, pose_compose, pose_compose_pair, pose_to_hom4,
    skew_symmetric, taylor_A, taylor_B, taylor_C,
    so3_to_SO3, SO3_to_so3, se3_to_SE3, SE3_to_se3,
    q_to_R, R_to_q, q_invert, q_product,
    rotation_6d_to_matrix, matrix_to_rotation_6d, pose_9d_to_matrix,
    rotation_distance, procrustes_analysis,
    angle_to_rotation_matrix, get_novel_view_poses, get_novel_view_poses_obj,
    compose_pose_residual,
)
from .rays import (
    to_hom, world2cam, cam2img, img2cam, cam2world,
    pixel_grid, get_center_and_ray, get_3D_points_from_depth,
    convert_NDC, aabb_ray_intersection, enlarge_diagonal, back_project,
)
