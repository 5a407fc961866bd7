"""Plain PyTorch reference of the stage-2 render, its loss and one Adam
step, written from 3D Gaussian splatting's equations (the INRIA CUDA
rasterizer's forward semantics with the ``z <= 0.001`` near cull, as the
DAS3R reference uses it) and DAS3R's training step.

Nothing here is fused or hand-written: per tile, the Gaussians whose
screen rectangle touches it, in depth order, evaluated at every pixel of
the tile as one tensor, the transmittance as a cumulative product, and
autograd for every gradient. Blocks of tiles are recomputed in the
backward (``torch.utils.checkpoint``), so a 1.5M-Gaussian view fits.

The screen rectangle is 3 sigma intersected with the box where the
Gaussian can still reach the alpha floor, and a (Gaussian, tile) pair is
kept when the conic's minimum over the tile's pixel box can reach it:
both culls drop only pairs that contribute nothing. ``n_eval`` counts,
per pixel, the entries of its tile evaluated until its transmittance
falls under the cutoff: the blend work these inputs need.

This module imports nothing but torch: it is the yardstick the benchmark
holds the program to, and it must not move with the program.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

TILE = 16
NEAR = 0.001
ALPHA_FLOOR = 1.0 / 255.0
ALPHA_CLIP = 0.99
T_EPS = 1e-4
# elements of one [tiles, pixels, entries] block of the blend
BLOCK_ELEMS = 1 << 26

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


# --- camera -------------------------------------------------------------

def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


# --- per Gaussian ---------------------------------------------------------

def eval_sh(deg: int, sh: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """sh [N, K, 3], unit d [N, 3] -> [N, 3] (before +0.5 and the clamp)."""
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    res = SH_C0 * sh[:, 0]
    if deg >= 1:
        res = (res - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2]
               - SH_C1 * x * sh[:, 3])
    if deg >= 2:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        res = (res + SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5]
               + SH_C2[2] * (2 * zz - xx - yy) * sh[:, 6]
               + SH_C2[3] * xz * sh[:, 7] + SH_C2[4] * (xx - yy) * sh[:, 8])
    if deg >= 3:
        res = (res + SH_C3[0] * y * (3 * xx - yy) * sh[:, 9]
               + SH_C3[1] * xy * z * sh[:, 10]
               + SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
               + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
               + SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
               + SH_C3[5] * z * (xx - yy) * sh[:, 14]
               + SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15])
    return res


class Screen(NamedTuple):
    table: torch.Tensor     # [N, 9] mean x y, conic xx xy yy, rgb, opacity
    depth: torch.Tensor     # [N]
    rect_min: torch.Tensor  # [N, 2] int64 tile rect, inclusive
    rect_max: torch.Tensor  # [N, 2] exclusive
    q_cap: torch.Tensor     # [N] conic level at which alpha meets the floor
    binnable: torch.Tensor  # [N] bool


def project(g: dict, opacity: torch.Tensor, pose: torch.Tensor, fovx, fovy,
            height: int, width: int, sh_degree: int) -> Screen:
    """The Gaussians of ``g`` (xyz, features_dc, features_rest, scaling,
    rotation) seen from the world-to-camera ``pose`` [7] (wxyz, t), with
    the activated ``opacity`` [N]: EWA splatting in the camera frame."""
    fovx = torch.as_tensor(fovx, dtype=torch.float32, device=pose.device)
    fovy = torch.as_tensor(fovy, dtype=torch.float32, device=pose.device)
    tan_x, tan_y = torch.tan(fovx * 0.5), torch.tan(fovy * 0.5)
    R = quat_to_rotmat(pose[:4])
    xyz = g["xyz"] @ R.T + pose[4:7]
    rot = quat_mul(pose[:4], g["rotation"])
    tx, ty, tz = xyz.unbind(-1)
    # perspective divide as the rasterizer's projection matrix does it
    p_w = 1.0 / (tz + 1e-7)
    ndc_x = (tx * (1.0 / tan_x)) * p_w
    ndc_y = (ty * (1.0 / tan_y)) * p_w
    mean2d = torch.stack([((ndc_x + 1) * width - 1) * 0.5,
                          ((ndc_y + 1) * height - 1) * 0.5], -1)
    in_front = tz > NEAR

    q = rot / torch.linalg.vector_norm(rot, dim=-1,
                                       keepdim=True).clamp_min(1e-12)
    M = quat_to_rotmat(q) * torch.exp(g["scaling"])[:, None, :]
    cov3 = M @ M.transpose(1, 2)                          # R S^2 R^T
    fx = width / (2.0 * tan_x)
    fy = height / (2.0 * tan_y)
    safe = torch.where(in_front[:, None], xyz, torch.ones_like(xyz))
    sx, sy, sz = safe.unbind(-1)
    limx, limy = 1.3 * tan_x, 1.3 * tan_y
    txtz = torch.clamp(sx / sz, -limx, limx) * sz
    tytz = torch.clamp(sy / sz, -limy, limy) * sz
    zero = torch.zeros_like(sz)
    J = torch.stack([
        torch.stack([fx / sz, zero, -fx * txtz / (sz * sz)], -1),
        torch.stack([zero, fy / sz, -fy * tytz / (sz * sz)], -1)], -2)
    cov2 = J @ cov3 @ J.transpose(1, 2)
    a = cov2[:, 0, 0] + 0.3
    b = cov2[:, 0, 1]
    d = cov2[:, 1, 1] + 0.3
    det = a * d - b * b
    det_ok = det != 0.0
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([d * inv_det, -b * inv_det, a * inv_det], -1)

    mid = 0.5 * (a + d)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam)).detach()
    op = opacity.detach()
    q_cap = 2.0 * torch.log(torch.clamp_min(op / ALPHA_FLOOR, 1e-12))
    m = mean2d.detach()
    grid = torch.tensor([-(-width // TILE), -(-height // TILE)],
                        device=m.device)
    rmin = torch.floor((m - radius[:, None]) / TILE).long()
    rmax = ((m + radius[:, None] + TILE - 1) // TILE).long()
    rmin, rmax = rmin.clamp(torch.zeros_like(grid), grid), rmax.clamp(
        torch.zeros_like(grid), grid)
    span3 = (rmax - rmin).clamp_min(0).prod(-1)
    r_t = torch.sqrt(q_cap.clamp_min(0.0) * lam.detach())[:, None]
    rmin = torch.maximum(rmin, torch.floor((m - r_t) / TILE).long()).clamp(
        torch.zeros_like(grid), grid)
    rmax = torch.minimum(rmax, torch.floor((m + r_t) / TILE).long() + 1
                         ).clamp(torch.zeros_like(grid), grid)
    n_tiles = (rmax - rmin).clamp_min(0).prod(-1)
    binnable = (in_front & det_ok & (span3 > 0) & (op >= ALPHA_FLOOR)
                & (n_tiles > 0))

    sh = torch.cat([g["features_dc"], g["features_rest"]], 1)
    sq = (xyz * xyz).sum(-1, keepdim=True)
    dirs = torch.where(sq > 0, xyz / torch.sqrt(
        torch.where(sq > 0, sq, torch.ones_like(sq))), torch.zeros_like(xyz))
    color = torch.clamp_min(eval_sh(sh_degree, sh, dirs) + 0.5, 0.0)
    table = torch.cat([mean2d, conic, color, opacity[:, None]], 1)
    return Screen(table, tz.detach(), rmin, rmax, q_cap, binnable)


# --- binning ------------------------------------------------------------

def _pair_keep(m, conic, q_cap, tx, ty):
    """Whether the conic's minimum over the tile's pixel box reaches the
    alpha floor (q_min <= q_cap)."""
    mx, my = m[:, 0], m[:, 1]
    A, B, C = conic[:, 0], conic[:, 1], conic[:, 2]
    A_safe = torch.where(A > 0, A, torch.ones_like(A))
    C_safe = torch.where(C > 0, C, torch.ones_like(C))
    lx = tx.float() * TILE - mx
    hx = lx + (TILE - 1)
    ly = ty.float() * TILE - my
    hy = ly + (TILE - 1)
    inside = (lx <= 0) & (hx >= 0) & (ly <= 0) & (hy >= 0)

    def qx(xh):
        ys = torch.minimum(torch.maximum(-B * xh / C_safe, ly), hy)
        return A * xh * xh + 2.0 * B * xh * ys + C * ys * ys

    def qy(yh):
        xs = torch.minimum(torch.maximum(-B * yh / A_safe, lx), hx)
        return A * xs * xs + 2.0 * B * xs * yh + C * yh * yh

    q_min = torch.minimum(torch.minimum(qx(lx), qx(hx)),
                          torch.minimum(qy(ly), qy(hy)))
    q_min = torch.where(inside, torch.zeros_like(q_min), q_min)
    return q_min <= q_cap + 1e-3


class Bins(NamedTuple):
    gauss: torch.Tensor   # [E] Gaussian of each entry, by (tile, depth)
    start: torch.Tensor   # [T] first entry of each tile
    count: torch.Tensor   # [T] entries of each tile


def bin_tiles(s: Screen, width: int, height: int) -> Bins:
    tiles_x = -(-width // TILE)
    n_tiles = tiles_x * -(-height // TILE)
    idx = s.binnable.nonzero().squeeze(1)
    span = (s.rect_max - s.rect_min)[idx]
    cnt = span[:, 0] * span[:, 1]
    g = torch.repeat_interleave(idx, cnt)
    first = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
    local = torch.arange(g.numel(), device=g.device) - first
    w = span[:, 0].repeat_interleave(cnt)
    tx = s.rect_min[g, 0] + local % w
    ty = s.rect_min[g, 1] + local // w
    t = s.table.detach()
    keep = _pair_keep(t[g, 0:2], t[g, 2:5], s.q_cap[g], tx, ty)
    g, tile = g[keep], (ty * tiles_x + tx)[keep]
    rank = torch.empty_like(s.depth, dtype=torch.long)
    rank[torch.argsort(s.depth, stable=True)] = torch.arange(
        s.depth.numel(), device=g.device)
    order = torch.argsort(tile * s.depth.numel() + rank[g])
    count = torch.bincount(tile, minlength=n_tiles)
    return Bins(g[order], torch.cumsum(count, 0) - count, count)


# --- blending -------------------------------------------------------------

def _blend_block(attrs, live, px, py):
    """attrs [Tb, L, 9], live [Tb, L], px/py [Tb, P] -> colour [Tb, P, 3],
    final transmittance [Tb, P], evaluations [Tb, P]."""
    a = attrs[:, None]                                     # [Tb, 1, L, 9]
    dx = a[..., 0] - px[:, :, None]
    dy = a[..., 1] - py[:, :, None]
    power = -0.5 * (a[..., 2] * dx * dx + a[..., 4] * dy * dy) \
        - a[..., 3] * dx * dy
    alpha = torch.clamp_max(a[..., 8] * torch.exp(power), ALPHA_CLIP)
    valid = (power <= 0.0) & (alpha >= ALPHA_FLOOR) & live[:, None, :]
    alpha = torch.where(valid, alpha, torch.zeros_like(alpha))
    t_after = torch.cumprod(1.0 - alpha, 2)
    t_before = torch.cat([torch.ones_like(t_after[..., :1]),
                          t_after[..., :-1]], 2)
    contrib = valid & (t_after >= T_EPS)
    w = torch.where(contrib, alpha * t_before, torch.zeros_like(alpha))
    color = torch.einsum("tpl,tlc->tpc", w, attrs[..., 5:8])
    t_final = torch.prod(torch.where(contrib, 1.0 - alpha,
                                     torch.ones_like(alpha)), 2)
    n_eval = ((t_before.detach() >= T_EPS) & live[:, None, :]).sum(2)
    return color, t_final, n_eval


def blend(table: torch.Tensor, bins: Bins, width: int, height: int,
          bg: torch.Tensor, grad: bool = True):
    """[3, H, W] image and [H, W] evaluations of the binned ``table``."""
    dev = table.device
    tiles_x = -(-width // TILE)
    n_tiles = bins.count.numel()
    pix = torch.arange(TILE * TILE, device=dev)
    tile_ids = torch.arange(n_tiles, device=dev)
    px_all = ((tile_ids % tiles_x) * TILE)[:, None] + pix % TILE
    py_all = ((tile_ids // tiles_x) * TILE)[:, None] + pix // TILE
    cols, tfin, evals = [], [], []
    t0 = 0
    counts = bins.count.tolist()
    while t0 < n_tiles:
        t1, longest = t0, 1
        while t1 < n_tiles:
            longest_next = max(longest, counts[t1])
            if t1 > t0 and (t1 + 1 - t0) * TILE * TILE * longest_next \
                    > BLOCK_ELEMS:
                break
            longest, t1 = longest_next, t1 + 1
        sl = slice(t0, t1)
        lane = torch.arange(longest, device=dev)
        live = lane < bins.count[sl, None]
        pos = (bins.start[sl, None] + lane).clamp_max(
            max(bins.gauss.numel() - 1, 0))
        gi = bins.gauss[pos] if bins.gauss.numel() else torch.zeros_like(pos)
        attrs = table[gi]
        px, py = px_all[sl].float(), py_all[sl].float()
        if grad and torch.is_grad_enabled():
            c, t, n = checkpoint(_blend_block, attrs, live, px, py,
                                 use_reentrant=False)
        else:
            c, t, n = _blend_block(attrs, live, px, py)
        cols.append(c + t[..., None] * bg)
        tfin.append(t)
        evals.append(n)
        t0 = t1
    tiles_y = n_tiles // tiles_x
    img = torch.cat(cols).reshape(tiles_y, tiles_x, TILE, TILE, 3)
    img = img.permute(4, 0, 2, 1, 3).reshape(3, tiles_y * TILE,
                                             tiles_x * TILE)
    ev = torch.cat(evals).reshape(tiles_y, tiles_x, TILE, TILE)
    ev = ev.permute(0, 2, 1, 3).reshape(tiles_y * TILE, tiles_x * TILE)
    return img[:, :height, :width], ev[:height, :width]


class Render(NamedTuple):
    image: torch.Tensor    # [3, H, W]
    n_eval: torch.Tensor   # [H, W] int64
    entries: int           # (Gaussian, tile) pairs after the culls
    binnable: int          # Gaussians with at least one pair


def render(g: dict, opacity: torch.Tensor, pose, fovx, fovy, height: int,
           width: int, sh_degree: int, bg: torch.Tensor,
           grad: bool = True) -> Render:
    s = project(g, opacity, pose, fovx, fovy, height, width, sh_degree)
    bins = bin_tiles(s, width, height)
    img, ev = blend(s.table, bins, width, height, bg, grad=grad)
    return Render(img, ev, int(bins.gauss.numel()), int(s.binnable.sum()))


# --- training step --------------------------------------------------------

def ssim_map(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """SSIM of two [3, H, W] images per pixel: 11x11 Gaussian window,
    sigma 1.5, zero padding, C1 = 0.01^2, C2 = 0.03^2, as two 1-D passes
    of shifted adds in float32."""
    h, w = p.shape[-2:]
    k = torch.exp(-((torch.arange(11, dtype=torch.float64) - 5) ** 2) / 4.5)
    k = (k / k.sum()).float().tolist()

    def conv(x):
        xp = torch.nn.functional.pad(x, (5, 5, 5, 5))
        yh = sum(k[i] * xp[..., i:i + h, :] for i in range(11))
        return sum(k[j] * yh[..., j:j + w] for j in range(11))

    mu1, mu2, e11, e22, e12 = conv(torch.stack([p, g, p * p, g * g, p * g]))
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return ((2 * mu1 * mu2 + c1) * (2 * (e12 - mu1 * mu2) + c2)) / (
        (mu1 * mu1 + mu2 * mu2 + c1) * (e11 - mu1 * mu1 + e22 - mu2 * mu2
                                        + c2))


def photometric(img, gt, static, lambda_dssim: float):
    """(loss, psnr) of DAS3R's static-weighted L1 + D-SSIM."""
    p, g = img * static, gt * static
    loss = ((1 - lambda_dssim) * torch.abs(p - g)
            + lambda_dssim * (1 - ssim_map(p, g))).mean()
    psnr = 20 * torch.log10(1.0 / torch.sqrt(((p - g) ** 2).mean()))
    return loss, psnr


def expon_lr(step: int, lr_init: float, lr_final: float,
             max_steps: int) -> float:
    """3DGS's log-linear decay (DAS3R sets no delay steps)."""
    t = min(max(step / max_steps, 0.0), 1.0)
    f32 = torch.tensor
    return float(torch.exp(torch.log(f32(lr_init)) * (1 - t)
                           + torch.log(f32(lr_final)) * t))


GAUSS_KEYS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity", "conf_static")
CAM_KEYS = ("Q", "T", "fovx", "fovy")


def lrs(step: int, cfg: dict, spatial: float) -> dict:
    """Per-leaf learning rates of DAS3R's two Adam groups at ``step``."""
    cam = expon_lr(step, cfg["cam_lr_init"], cfg["cam_lr_final"],
                   cfg["cam_lr_max_steps"])
    return dict(
        xyz=expon_lr(step, cfg["position_lr_init"] * spatial,
                     cfg["position_lr_final"] * spatial,
                     cfg["position_lr_max_steps"]),
        features_dc=cfg["feature_lr"], features_rest=cfg["feature_lr"] / 20.0,
        scaling=cfg["scaling_lr"], rotation=cfg["rotation_lr"],
        opacity=cfg["opacity_lr"],
        conf_static=expon_lr(step, cfg["conf_lr_init"], cfg["conf_lr_final"],
                             cfg["iterations"]),
        Q=cam, T=cam, fovx=cfg["fov_lr"], fovy=cfg["fov_lr"])


@torch.no_grad()
def adam(params: dict, grads: dict, state: dict, lr: dict, keys,
         gate: bool) -> None:
    """One Adam step (b1 0.9, b2 0.999, eps 1e-15) on ``keys``, skipped
    whole, bias correction included, when ``gate`` is False."""
    if not gate:
        return
    state["count"] += 1
    c = state["count"]
    bc1, bc2 = 1 - 0.9 ** c, 1 - 0.999 ** c
    for k in keys:
        g = grads[k]
        mu = state["mu"][k]
        nu = state["nu"][k]
        mu.mul_(0.9).add_(g, alpha=0.1)
        nu.mul_(0.999).add_(g * g, alpha=0.001)
        params[k] -= lr[k] * (mu / bc1) / (torch.sqrt(nu / bc2) + 1e-15)


def new_state(params: dict, keys) -> dict:
    return dict(count=0, mu={k: torch.zeros_like(params[k]) for k in keys},
                nu={k: torch.zeros_like(params[k]) for k in keys})


class StepOut(NamedTuple):
    loss: float
    psnr: float
    grads: dict        # every leaf's gradient
    cam_stepped: bool


def train_step(params: dict, opt: dict, opt_cam: dict, step: int, uid: int,
               gt: torch.Tensor, fovx, fovy, pix_id: torch.Tensor,
               height: int, width: int, sh_degree: int, bg: torch.Tensor,
               cfg: dict, spatial: float) -> StepOut:
    """One DAS3R stage-2 iteration on frame ``uid``: render with the
    frame's learnable pose and per-Gaussian opacity x static confidence,
    the static-weighted loss, gradients of every leaf, the Gaussians'
    Adam step and the camera's, gated on the frame's PSNR. ``params`` and
    the optimiser states are updated in place."""
    leaves = {k: params[k].detach().requires_grad_(True)
              for k in GAUSS_KEYS + CAM_KEYS}
    pose = torch.cat([leaves["Q"][uid], leaves["T"][uid]])
    conf = leaves["conf_static"].reshape(-1)[pix_id]
    opacity = torch.sigmoid(leaves["opacity"][:, 0]) * conf
    out = render(leaves, opacity, pose, fovx, fovy, height, width,
                 sh_degree, bg)
    loss, psnr = photometric(out.image, gt, leaves["conf_static"][uid],
                             cfg["lambda_dssim"])
    names = list(leaves)
    got = torch.autograd.grad(loss, [leaves[k] for k in names],
                              allow_unused=True)
    grads = {k: (torch.zeros_like(leaves[k]) if gr is None else gr)
             for k, gr in zip(names, got)}
    lr = lrs(step, cfg, spatial)
    adam(params, grads, opt, lr, GAUSS_KEYS, True)
    gate = bool(psnr.detach() > cfg["psnr_threshold"])
    adam(params, grads, opt_cam, lr, CAM_KEYS, gate)
    return StepOut(float(loss.detach()), float(psnr.detach()), grads, gate)

