"""The program's side of the splat cells: a scene of ``scene.make_scene``
in the port's types (``das3r_tpu_torch``), and the frozen counts of the
blend work the window's views need, from the reference."""
from __future__ import annotations

import torch

from benchmark.reference import splat as ref


def program_state(sc, dev):
    """(GaussianParams, GaussianMeta, PoseParams) of scene ``sc``: copies,
    so the program's in-place updates leave ``sc`` as it was made."""
    from das3r_tpu_torch.models.gaussians import (GaussianMeta,
                                                  GaussianParams, PoseParams)
    p = GaussianParams(**{k: v.clone() for k, v in sc.params.items()})
    n = p.xyz.shape[0]
    meta = GaussianMeta(
        alive=torch.ones(n, dtype=torch.bool, device=dev),
        pix_id=sc.pix_id.clone(),
        max_radii2d=torch.zeros(n, device=dev),
        xyz_grad_accum=torch.zeros(n, device=dev),
        denom=torch.zeros(n, device=dev))
    poses = PoseParams(Q=sc.poses[:, :4].contiguous(),
                       T=sc.poses[:, 4:].contiguous(),
                       fovx=torch.tensor(sc.fovx, device=dev),
                       fovy=torch.tensor(sc.fovy, device=dev))
    return p, meta, poses


def view_work(sc, params: dict, opacity: torch.Tensor, poses: torch.Tensor,
              sh_degree: int, bg) -> list[dict]:
    """Per pose of ``poses`` [V, 7], what the view of the Gaussians
    ``params`` (with ``opacity``) in scene ``sc``'s frame needs: blend
    evaluations, (Gaussian, tile) entries and binnable Gaussians, from
    the reference's render."""
    out = []
    with torch.no_grad():
        for v in range(poses.shape[0]):
            r = ref.render(params, opacity, poses[v], sc.fovx, sc.fovy,
                           sc.height, sc.width, sh_degree, bg, grad=False)
            out.append({"evals": int(r.n_eval.sum()), "entries": r.entries,
                        "binnable": r.binnable})
    return out
