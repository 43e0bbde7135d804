"""Agisoft Metashape ``cameras.xml`` parser
(reference dataLoader/repair_camera_parser.py:43-207, using xml.etree
instead of BeautifulSoup).

Returns per-camera c2w transforms and undistortion-adjusted intrinsics,
recentered (camera-plane fit) and rescaled like the reference. The
intrinsics go through ``cv2.getOptimalNewCameraMatrix`` where cv2 imports,
and stay the calibration's where it does not, as in the JAX package. No
image is read: a label with an extension names its file as it is, and a
label without one is completed from the files that exist.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from iffnerf_tpu_torch.data.pose_utils import recenter_poses, rescale_poses

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".tif", ".tiff", ".bmp",
                    ".webp", ".exr")


def _float_of(elem, tag: str, default: float) -> float:
    child = elem.find(tag)
    return float(child.text) if child is not None else default


def load_cameras_xml(camera_filepath: str, base_dir: str,
                     img_resize_factor: float = 1.0,
                     img_dirname: str = "undistorted_images"):
    """-> ({filenames, metashape_filenames, metashape_masks, cam2world, Ks,
    base_dir}, inv_scale, inv_transformation) or ({}, None, None) when
    malformed."""
    tree = ET.parse(camera_filepath)
    chunks = tree.getroot().findall(".//chunk")
    if len(chunks) != 1:
        print(f"Expected exactly one chunk in {camera_filepath}")
        return {}, None, None
    chunk = chunks[0]
    sensors = chunk.find("sensors")
    cameras = chunk.find("cameras")
    if sensors is None or cameras is None:
        print(f"No sensors/cameras list in {camera_filepath}")
        return {}, None, None

    sensor_by_id = {s.get("id"): s for s in sensors.findall("sensor")}

    filenames, undist, masks, cam2world, Ks = [], [], [], [], []
    for camera in cameras.iter("camera"):
        if camera.get("enabled") == "false":
            continue
        label = camera.get("label")
        transform_el = camera.find("transform")
        sensor = sensor_by_id.get(camera.get("sensor_id"))
        if label is None or transform_el is None or sensor is None:
            continue
        resolution = sensor.find("resolution")
        calibration = sensor.find("calibration")
        if resolution is None or calibration is None:
            continue

        transform = np.array(
            [float(x) for x in transform_el.text.split()], np.float32
        ).reshape(4, -1)

        w = int(resolution.get("width"))
        h = int(resolution.get("height"))
        f = _float_of(calibration, "f", 0.0)
        fx = _float_of(calibration, "fx", f)
        fy = _float_of(calibration, "fy", f)
        cx = _float_of(calibration, "cx", w / 2.0)
        cy = _float_of(calibration, "cy", h / 2.0)
        k1 = _float_of(calibration, "k1", 0.0)
        k2 = _float_of(calibration, "k2", 0.0)
        p = _float_of(calibration, "p", 0.0)
        p1 = _float_of(calibration, "p1", p)
        p2 = _float_of(calibration, "p2", p)

        cam_mat = np.array(
            [[fx / img_resize_factor, 0, cx / img_resize_factor],
             [0, fy / img_resize_factor, cy / img_resize_factor],
             [0, 0, 1]], np.float32,
        )
        try:
            import cv2

            cam_mat, _ = cv2.getOptimalNewCameraMatrix(
                cam_mat, np.asarray([k1, k2, p1, p2]),
                (int(w / img_resize_factor), int(h / img_resize_factor)), 0.0,
            )
        except ImportError:
            pass

        img_path = os.path.join(base_dir, img_dirname, label)
        if not os.path.splitext(label)[1]:
            for ext in IMAGE_EXTENSIONS:
                if os.path.exists(img_path + ext):
                    img_path += ext
                    break
            else:
                continue
        filenames.append(img_path)
        ext = os.path.splitext(img_path)[1]
        # Metashape's undistorted render of the same frame, used when
        # img_dirname holds the raw images (reference
        # repair_camera_parser.py:173-176)
        undist.append(
            img_path if img_dirname == "undistorted_images" else
            os.path.join(base_dir, "undistorted_images",
                         os.path.splitext(label)[0] + ext)
        )
        masks.append(
            os.path.join(base_dir, "masks_metashape",
                         os.path.splitext(label)[0] + ext)
        )
        cam2world.append(transform)
        Ks.append(np.asarray(cam_mat, np.float32))

    if not filenames:
        return {}, None, None

    cam2world = np.stack(cam2world)
    cam2world, inv_transformation = recenter_poses(cam2world)
    cam2world, inv_scale = rescale_poses(cam2world)
    return (
        {
            "filenames": filenames,
            "metashape_filenames": undist,
            "metashape_masks": masks,
            "cam2world": cam2world,
            "Ks": np.stack(Ks),
            "base_dir": base_dir,
        },
        inv_scale,
        inv_transformation,
    )
