"""Optical flow for the alignment's flow term (port of
``das3r_tpu/predictor/flow.py``; the reference's
``PointCloudOptimizer.get_flow``, cloud_opt/optimizer.py:117-151): the
flow network forward and backward over every edge in chunks, and the
forward-backward consistency masks (``warping.occlusion_valid_mask``).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from das3r_tpu_torch.predictor.raft import RAFT, load_reference_weights
from das3r_tpu_torch.predictor.warping import occlusion_valid_mask
from das3r_tpu_torch.utils.device import resolve_device


def load_flow_model(ckpt_path: str):
    """The reference's choice of network (third_party/raft.py:39-73): a
    checkpoint with 'M' in its file name is SEA-RAFT, any other classic
    RAFT. Returns the frozen module with the checkpoint's weights, on the
    CPU."""
    state = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    if "M" in os.path.basename(ckpt_path):
        from das3r_tpu_torch.predictor.searaft import SeaRaft
        model = SeaRaft()
    else:
        model = RAFT()
    load_reference_weights(model, state)
    return model.eval()


def compute_edge_flows(model, images01: np.ndarray, edges: list,
                       iters: int = 20, chunk: int = 12,
                       occ_threshold: float = 3.0, device=None):
    """(flow_ij [E, 2, H, W], flow_ji, valid_i [E, 1, H, W] bool, valid_j)
    on ``device`` (default CUDA; a RuntimeError without it; the model is
    moved there), ready for ``alignment.align(flows=...)``. ``model``: a
    frozen RAFT or SEA-RAFT; images [F, 3, H, W] in [0, 1], H and W
    multiples of 8; ``chunk`` edges per forward call."""
    dev = resolve_device(device)
    model.to(dev)
    imgs = torch.as_tensor(np.asarray(images01, np.float32),
                           device=dev) * 255.0
    ei = torch.as_tensor([i for i, _ in edges], device=dev)
    ej = torch.as_tensor([j for _, j in edges], device=dev)
    f_ij, f_ji = [], []
    for s in range(0, len(edges), chunk):
        a, b = imgs[ei[s:s + chunk]], imgs[ej[s:s + chunk]]
        f_ij.append(model(a, b, iters=iters))
        f_ji.append(model(b, a, iters=iters))
    flow_ij, flow_ji = torch.cat(f_ij), torch.cat(f_ji)
    valid_i = occlusion_valid_mask(flow_ij, flow_ji, th=occ_threshold)
    valid_j = occlusion_valid_mask(flow_ji, flow_ij, th=occ_threshold)
    return flow_ij, flow_ji, valid_i, valid_j
