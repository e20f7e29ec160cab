"""EurocPlayground: a ground-truth visualization tool.

Port of kimera_vio_tpu/playground.py (the reference playground,
include/kimera-vio/playground/EurocPlayground.h:58): load a EuRoC
sequence's ground truth and render its trajectory through the visualizer
to PNG artifacts — a development tool, not part of the pipeline. The
output folder defaults to one under the working directory (the JAX
package's default lies under /tmp).
"""

from __future__ import annotations

import numpy as np
import torch

from kimera_vio_tpu_torch import resolve_device
from kimera_vio_tpu_torch.common import geometry as geo
from kimera_vio_tpu_torch.dataprovider.euroc import EurocDataProvider
from kimera_vio_tpu_torch.visualizer.visualizer import FileDisplay, Visualizer3D


def visualize_gt_data(dataset_path: str, output_path: str = "./playground_out", every: int = 10,
                      device: str | torch.device = "cuda"):
    """Render every `every`-th ground-truth pose of the sequence (rotations
    from the quaternions in float32 on `device`) to the file display;
    returns `output_path`. Raises ValueError when the dataset has no
    ground truth."""
    dev = resolve_device(device)
    provider = EurocDataProvider(dataset_path)
    if provider.ground_truth is None:
        raise ValueError("dataset has no ground truth")
    viz = Visualizer3D()
    disp = FileDisplay(output_path, save_every=1)
    gt = provider.ground_truth
    idx = np.arange(0, len(gt.stamps_ns), every)
    rots = geo.quat_to_rot(torch.as_tensor(gt.quats_wxyz[idx], dtype=torch.float32,
                                           device=dev)).cpu().numpy()
    for R, k in zip(rots, idx):
        disp.spin_once(viz.spin_once(R, gt.positions[k]))
    return output_path
