"""Depth- and pose-based ego-motion flow and flow-consistency masks (port
of ``das3r_tpu/predictor/warping.py``; the CasualSAM-derived ops of the
reference's dynamic_predictor/dust3r/utils/goem_opt.py that the
global-alignment flow loss uses: ``warp_by_disp`` :195-236, ``OccMask``
:575-640, ``WarpImage`` :38-69, ``depth_regularization_si_weighted``
:15-36).
"""
from __future__ import annotations

import torch


def _pixel_coords_hom(h: int, w: int, dtype=torch.float32,
                      device=None) -> torch.Tensor:
    """[3, H*W] homogeneous pixel coordinates (x, y, 1)."""
    yy, xx = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1),
                        torch.ones(h * w, dtype=dtype, device=device)], 0)


def relative_transform(src_R, src_t, tgt_R, tgt_t):
    """R, t of the src camera in the tgt frame (goem_opt.py:150-154).
    src_R [*, 3, 3], src_t [*, 3, 1]."""
    tgt_R_inv = tgt_R.transpose(-1, -2)
    return tgt_R_inv @ src_R, tgt_R_inv @ (src_t - tgt_t)


def ego_flow_from_disp(src_R, src_t, tgt_R, tgt_t, src_disp, K, inv_K,
                       eps: float = 1e-6):
    """Ego-motion flow by homography + parallax (``warp_by_disp``).

    Rotations [B, 3, 3], translations [B, 3, 1], disparity [B, 1, H, W],
    K / inv_K [B, 3, 3] (camera-to-world: x_world = R x_cam + t).
    Returns (flow [B, 3, H, W]: (dx, dy, dw) as in the reference, use
    [:, :2]; tgt_coord [B, 3, H*W]).
    """
    B, _, H, W = src_disp.shape
    coord = _pixel_coords_hom(H, W, src_disp.dtype, src_disp.device)[None]
    rel_R, rel_t = relative_transform(src_R, src_t, tgt_R, tgt_t)
    H_mat = K @ rel_R @ inv_K                                  # [B, 3, 3]
    flat_disp = src_disp.reshape(B, 1, H * W)
    tgt_coord = H_mat @ coord + flat_disp * (K @ rel_t)
    tgt_coord = tgt_coord / (tgt_coord[:, -1:, :] + eps)
    return (tgt_coord - coord).reshape(B, 3, H, W), tgt_coord


def bilinear_sample(img: torch.Tensor, coords_xy: torch.Tensor
                    ) -> torch.Tensor:
    """grid_sample with align_corners=True: img [B, C, H, W], coords_xy
    [B, H', W', 2] in PIXEL units; zero outside."""
    B, C, H, W = img.shape
    x = coords_xy[..., 0]
    y = coords_xy[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[:, None]
    wy = (y - y0)[:, None]
    b = torch.arange(B, device=img.device)[:, None, None]

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        yc = torch.clamp(yi, 0, H - 1).to(torch.int64)
        xc = torch.clamp(xi, 0, W - 1).to(torch.int64)
        out = img.permute(0, 2, 3, 1)[b, yc, xc].permute(0, 3, 1, 2)
        return out * valid[:, None].to(img.dtype)

    top = gather(y0, x0) * (1 - wx) + gather(y0, x0 + 1) * wx
    bot = gather(y0 + 1, x0) * (1 - wx) + gather(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def occlusion_valid_mask(flow_12: torch.Tensor, flow_21: torch.Tensor,
                         th: float = 3.0) -> torch.Tensor:
    """Forward/backward flow consistency (``OccMask``): a pixel is valid
    where |flow_12 + flow_21(warped)| < th and its target is in bounds.
    flows [B, 2, H, W]; returns [B, 1, H, W] bool."""
    B, _, H, W = flow_12.shape
    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=flow_12.dtype, device=flow_12.device),
        torch.arange(W, dtype=flow_12.dtype, device=flow_12.device),
        indexing="ij")
    base = torch.stack([xx, yy], -1)[None]                    # [1, H, W, 2]
    target = base + flow_12.permute(0, 2, 3, 1)
    oob = ((target[..., 0] < 0) | (target[..., 0] > W - 1)
           | (target[..., 1] < 0) | (target[..., 1] > H - 1))
    sampled = bilinear_sample(flow_21, target)                # [B, 2, H, W]
    inconsistency = (sampled + flow_12).sum(1, keepdim=True).abs()
    return (inconsistency < th) & ~oob[:, None]


def smooth_l1_flow_loss(estimate, gt, mask, beta: float = 1.0,
                        per_pixel_thre: float = 50.0):
    """Masked smooth-L1 with per-pixel outlier clipping (reference
    cloud_opt/optimizer.py:18-24)."""
    diff = estimate * mask - gt * mask
    ad = diff.abs()
    raw = torch.where(ad < beta, 0.5 * diff * diff / beta, ad - 0.5 * beta)
    m = (raw < per_pixel_thre) * mask if per_pixel_thre > 0 else mask
    return torch.sum(raw * m) / torch.clamp_min(torch.sum(m), 1.0)


def depth_regularization_si_weighted(depth_pred, depth_init,
                                     pixel_wise_weight=None,
                                     pixel_wise_weight_scale: float = 1.0,
                                     pixel_wise_weight_bias: float = 1.0,
                                     eps: float = 1e-6):
    """Scale-invariant log-depth prior (goem_opt.py:15-36).

    depth_*: [B, 1, H, W]. ``pixel_wise_weight`` (same shape, optional)
    weights pixels by ``weight * scale + bias``: the reference passes the
    binary dynamic mask (optimizer.py:583-585), so dynamic pixels weigh 2
    and static ones 1."""
    dp = torch.log(torch.clamp_min(depth_pred, eps))
    di = torch.log(torch.clamp_min(depth_init, eps))
    _, _, H, W = depth_pred.shape
    scale = torch.sum(di - dp, dim=(1, 2, 3), keepdim=True) / (H * W)
    if pixel_wise_weight is None:
        w = 1.0
    else:
        w = (pixel_wise_weight * pixel_wise_weight_scale
             + pixel_wise_weight_bias)
    si = torch.sum(w * (dp + scale - di) ** 2, dim=(1, 2, 3)) / (H * W)
    return si.mean()
