"""Stage-1 trainer: fine-tune the dynamic-mask DPT heads on two-view
batches (port of ``das3r_tpu/predictor/training.py``; the reference's DDP
trainer, dynamic_predictor/dust3r/training.py:173-494).

The freeze set of the reference (``freeze='encoder_and_3d_predictor'``,
model.py:96-106) leaves only the two mask heads trainable; every other
parameter gets ``requires_grad_(False)``, so no gradient of the trunk or
of the pointmap heads is ever computed. Before that, the heads'
``ConvTranspose2d`` biases are untied (``dpt.untie_upsample_bias``): the
JAX package trains each of their k·k taps apart, and the port trains the
same parameters, so each package resumes the other's checkpoints.

The data-parallel step runs on a process group (``parallel.make_mesh``'s
data axis): each rank takes its rows of the batch, every masked mean of
the loss is the global batch's (``losses._masked_mean``), and the
trainable gradients are summed over the group in one all-reduce, as
JAX's ``jit`` over a batch sharded on 'data' computes.

Optimizer: AdamW(beta2=0.95, weight decay 0.05) written out in JAX's
order of operations, with the per-iteration cosine lr and linear warmup
of croco's ``misc.adjust_learning_rate`` (recipe DAS3R_b32_g4.sh: lr 5e-5,
50 epochs, bs 8 x 4 GPUs).
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from das3r_tpu_torch.models.croco.dpt import untie_upsample_bias
from das3r_tpu_torch.parallel import collectives
from das3r_tpu_torch.predictor.losses import (Stage1Batch, Stage1LossOut,
                                              conf_regr3d_mmask_loss)

TRAINABLE_KEYS = ("downstream_head_dynamic_mask1",
                  "downstream_head_dynamic_mask2")


@dataclasses.dataclass(frozen=True)
class Stage1TrainConfig:
    lr: float = 5e-5
    min_lr: float = 1e-8
    warmup_epochs: float = 1.0
    epochs: int = 50
    steps_per_epoch: int = 1250   # 10_000 samples / (8 * 1) default
    weight_decay: float = 0.05
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    alpha: float = 0.2            # ConfLoss alpha
    # Parameter freeze set (reference model.py:96-106 freeze choices):
    # "encoder_and_3d_predictor" = DAS3R recipe, only the mask heads
    # train; "none" = train everything (the from-scratch option for
    # environments without the MonST3R pretrained trunk).
    freeze: str = "encoder_and_3d_predictor"


def split_params(model: nn.Module,
                 freeze: str = "encoder_and_3d_predictor"):
    """(trainable, frozen) parameters of ``model`` by state-dict name,
    per the freeze set, after untying the upsampling biases (module
    docstring); ``requires_grad`` is set to match."""
    if freeze not in ("none", "encoder_and_3d_predictor"):
        raise ValueError(f"unknown freeze set {freeze!r}")
    untie_upsample_bias(model)
    train, frozen = {}, {}
    for name, p in model.named_parameters():
        keep = freeze == "none" or name.split(".")[0] in TRAINABLE_KEYS
        p.requires_grad_(keep)
        (train if keep else frozen)[name] = p
    return train, frozen


@dataclasses.dataclass
class AdamWState:
    count: torch.Tensor  # [] int32
    mu: dict             # name -> tensor, as the parameters
    nu: dict


def adamw_init(params: dict) -> AdamWState:
    dev = next(iter(params.values())).device
    return AdamWState(
        count=torch.zeros((), dtype=torch.int32, device=dev),
        mu={k: torch.zeros_like(p) for k, p in params.items()},
        nu={k: torch.zeros_like(p) for k, p in params.items()})


@torch.no_grad()
def adamw_step(params: dict, grads: dict, state: AdamWState, lr,
               cfg: Stage1TrainConfig) -> None:
    """One AdamW step in place on ``params`` and ``state``, in JAX's
    order of operations (weight decay on every trainable tensor): each
    operation one ``torch._foreach`` call over all the tensors."""
    state.count += 1
    c = state.count.to(torch.float32)
    bc1 = 1 - cfg.b1 ** c
    bc2 = 1 - cfg.b2 ** c
    ps = list(params.values())
    gs = [grads[k] for k in params]
    ms = [state.mu[k] for k in params]
    vs = [state.nu[k] for k in params]
    torch._foreach_mul_(ms, cfg.b1)
    torch._foreach_add_(ms, torch._foreach_mul(gs, 1 - cfg.b1))
    g2 = torch._foreach_mul(gs, 1 - cfg.b2)
    torch._foreach_mul_(g2, gs)
    torch._foreach_mul_(vs, cfg.b2)
    torch._foreach_add_(vs, g2)
    den = torch._foreach_div(vs, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    upd = torch._foreach_div(ms, bc1)
    torch._foreach_div_(upd, den)
    torch._foreach_add_(upd, torch._foreach_mul(ps, cfg.weight_decay))
    torch._foreach_mul_(upd, lr)
    torch._foreach_sub_(ps, upd)


def lr_at(step, cfg: Stage1TrainConfig, device=None) -> torch.Tensor:
    """Per-iteration warmup + half-cosine (croco misc.adjust_learning_rate),
    in float32 as the JAX package computes it."""
    f32 = dict(dtype=torch.float32, device=device)
    epoch = torch.as_tensor(step, **f32) / torch.tensor(cfg.steps_per_epoch,
                                                        **f32)
    warm = cfg.lr * epoch / torch.tensor(max(cfg.warmup_epochs, 1e-8), **f32)
    t = (epoch - cfg.warmup_epochs) / torch.tensor(
        max(cfg.epochs - cfg.warmup_epochs, 1e-8), **f32)
    cos = cfg.min_lr + (cfg.lr - cfg.min_lr) * 0.5 * (
        1.0 + torch.cos(torch.tensor(math.pi, **f32)
                        * torch.clamp(t, 0.0, 1.0)))
    return torch.where(epoch < cfg.warmup_epochs, warm, cos)


def make_train_step(model: nn.Module, cfg: Stage1TrainConfig, group=None):
    """Returns ``step(train_params, opt_state, img1, img2, batch, step_no)
    -> Stage1LossOut``, which updates ``train_params`` (``split_params``'s
    first dict, the model's own tensors) and ``opt_state`` in place.
    Inputs are tensors on the model's device; the learning rate is
    computed on the host (a copy to the device would wait for the queue).

    With ``group`` (a process group: the mesh's data axis), ``img1``,
    ``img2`` and ``batch`` are this rank's rows of the global batch; the
    loss is the global batch's and the gradients are summed over the
    group in one all-reduce (module docstring)."""
    stop_trunk_grad = cfg.freeze != "none"

    def step(train_params: dict, opt_state: AdamWState, img1, img2,
             batch: Stage1Batch, step_no) -> Stage1LossOut:
        res1, res2 = model(img1, img2, stop_trunk_grad=stop_trunk_grad)
        out = conf_regr3d_mmask_loss(batch, res1, res2, alpha=cfg.alpha,
                                     group=group)
        params = list(train_params.values())
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, torch.autograd.grad(
                     out.total, params, allow_unused=True))]
        if collectives.size(group) > 1:
            flat = collectives.all_reduce(
                torch.cat([g.reshape(-1) for g in grads]), group,
                tag="stage1_grads")
            grads = [x.view_as(p) for x, p in zip(
                flat.split([p.numel() for p in params]), params)]
        adamw_step(train_params, dict(zip(train_params, grads)), opt_state,
                   float(lr_at(step_no, cfg)), cfg)
        return Stage1LossOut(*(x.detach() for x in out))

    return step
