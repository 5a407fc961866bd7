"""Stage-1 training loop: epochs, evaluation, checkpointing, JSON-line logs
(port of ``das3r_tpu/predictor/train_loop.py``) — the host orchestration
around ``training.make_train_step`` (reference dynamic_predictor/dust3r/
training.py:173-556: train/train_one_epoch/test_one_epoch, auto-resume
from checkpoint-last, best-checkpoint selection on the test loss,
``log.txt`` JSON lines).

Checkpoints are the JAX package's npz files: each tensor under the
``jax.tree_util.keystr`` of its leaf in the flax tree
(``['params']['downstream_head_dynamic_mask1']['act_0_proj']['kernel']``,
``['mu']...``, ``['nu']...``, ``__count``, ``__epoch``, ``__best``,
``__best_pose``), laid out as JAX lays it out (``convert.to_jax``), so
each package resumes the other's. The port writes them with ``np.savez``
rather than ``np.savez_compressed``: float weights shrink by ~7% under
zlib, which takes ~60x the time of the plain write (a 144 MB array: 8.8
against 0.15 s on one CPU core); ``np.load`` reads either.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from das3r_tpu_torch.models.croco import convert
from das3r_tpu_torch.parallel import collectives
from das3r_tpu_torch.predictor import training
from das3r_tpu_torch.predictor.datasets import batch_iterator
from das3r_tpu_torch.predictor.losses import conf_regr3d_mmask_loss
from das3r_tpu_torch.utils import tblog
from das3r_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class Stage1LoopConfig:
    epochs: int = 50
    batch_size: int = 8
    eval_freq: int = 1          # epochs between test passes
    save_freq: int = 1          # epochs between checkpoint-last saves
    pose_eval_freq: int = 0     # epochs between in-train pose evals
                                # (reference training.py:311-331); 0 = off
    keep_freq: int = 0          # epochs between numbered keep-checkpoints
    save_best_pose: bool = False  # save checkpoint-best_pose.npz on new
                                  # best mean ATE (training.py:352-353)
    out_dir: str = "stage1_ckpt"
    seed: int = 777
    tensorboard: bool = False   # TB scalars next to the JSON lines


def _save_ckpt(path, train_params: dict, opt_state: training.AdamWState,
               epoch, best, best_pose_ate=float("inf")):
    data = {}
    for prefix, tree in (("params", train_params), ("mu", opt_state.mu),
                         ("nu", opt_state.nu)):
        for name, x in tree.items():
            data[convert.keystr((prefix, *convert.jax_path(name)))] = \
                convert.to_jax(name, x)
    data["__count"] = opt_state.count.cpu().numpy()
    data["__epoch"] = np.asarray(epoch)
    data["__best"] = np.asarray(best)
    data["__best_pose"] = np.asarray(best_pose_ate)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **data)


@torch.no_grad()
def _load_ckpt(path, train_params: dict, opt_state: training.AdamWState):
    """Fill ``train_params`` and ``opt_state`` from the checkpoint, in
    place; returns (epoch, best, best_pose)."""
    data = np.load(path)
    for prefix, tree in (("params", train_params), ("mu", opt_state.mu),
                         ("nu", opt_state.nu)):
        for name, x in tree.items():
            y = data[convert.keystr((prefix, *convert.jax_path(name)))]
            x.copy_(torch.from_numpy(convert.from_jax(name, y, x.shape)))
    opt_state.count.copy_(torch.from_numpy(np.asarray(data["__count"])))
    best_pose = (float(data["__best_pose"]) if "__best_pose" in data
                 else float("inf"))
    return int(data["__epoch"]), float(data["__best"]), best_pose


def _state(params) -> dict:
    return params.state_dict() if isinstance(params, nn.Module) else params


def save_params_npz(path: str, params) -> None:
    """A model's parameters (or a dict of state-dict tensors) -> one npz
    keyed by each leaf's keystr in the JAX params tree: the JAX package's
    ``save_params_npz`` format (the stage-1 checkpoint ``quality_e2e
    --stage1_ckpt`` consumes)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{
        convert.keystr(convert.jax_path(k)): convert.to_jax(k, v)
        for k, v in _state(params).items()})


@torch.no_grad()
def load_params_npz(path: str, params):
    """Inverse of ``save_params_npz``, into the tensors of ``params`` (a
    model or a dict of its state-dict tensors) in place; their shapes
    decide a tied or untied upsampling bias. Returns ``params``."""
    data = np.load(path)
    for k, v in _state(params).items():
        y = data[convert.keystr(convert.jax_path(k))]
        v.copy_(torch.from_numpy(convert.from_jax(k, y, v.shape)))
    return params


@torch.no_grad()
def evaluate_stats(model, dataset, batch_size, max_batches=None,
                   device=None, mesh=None):
    """Per-dataset test stats (test_one_epoch, training.py:497-556):
    ``loss`` = mean over batches, ``loss_med`` = median; the reference
    selects the best checkpoint on the MEDIAN (training.py:307-308).

    With ``mesh``, each data rank evaluates its rows of every batch and
    each batch's loss is the global batch's (the group's masked means), so
    every rank returns the same stats: those of the unsharded pass."""
    dev = resolve_device(device)
    rank, ranks, group = _data_axis(mesh)
    losses = []
    for bi, (img1, img2, batch) in enumerate(batch_iterator(
            dataset, batch_size, seed=0, shuffle=False, rank=rank,
            ranks=ranks)):
        if max_batches and bi >= max_batches:
            break
        res1, res2 = model(torch.as_tensor(img1, device=dev),
                           torch.as_tensor(img2, device=dev))
        losses.append(conf_regr3d_mmask_loss(batch.to(dev), res1, res2,
                                             group=group).total)
    if not losses:
        return {"loss": float("nan"), "loss_med": float("nan")}
    arr = torch.stack(losses).cpu().numpy()
    return {"loss": float(arr.mean()), "loss_med": float(np.median(arr))}


def evaluate(model, dataset, batch_size, max_batches=None, device=None):
    """Mean total loss over a dataset (JAX's wrapper for older callers)."""
    return evaluate_stats(model, dataset, batch_size, max_batches,
                          device)["loss"]


def _data_axis(mesh):
    """(this rank's index, the ranks, the process group) of the mesh's
    data axis; (0, 1, None) without a mesh."""
    if mesh is None:
        return 0, 1, None
    group, ranks = mesh.group("data"), mesh.shape["data"]
    if ranks > 1 and group is None:
        raise ValueError("the mesh's data axis has no process group: make "
                         "it with parallel.make_mesh over the ranks, not "
                         "with world_size")
    return mesh.coords["data"], ranks, group


def _log_epoch(log_path, tb, entry: dict) -> None:
    """One epoch's JSON line in ``log.txt`` and its TensorBoard scalars."""
    with open(log_path, "a") as f:
        f.write(json.dumps(entry) + "\n")
    tblog.scalars(tb, entry["epoch"] + 1, **{
        k.replace("test_", "test__").replace("train_", "train__").replace(
            "pose_", "pose__"): v
        for k, v in entry.items()
        if isinstance(v, (int, float)) and k != "epoch"})


def fit(model: nn.Module, train_dataset, test_datasets: dict,
        train_cfg: training.Stage1TrainConfig, loop_cfg: Stage1LoopConfig,
        mesh=None, progress=print, pose_eval_fn=None, device=None):
    """Train ``model`` in place on ``device`` (default CUDA; a RuntimeError
    without it). Returns (model, history).

    ``mesh`` (``parallel.make_mesh(data=R)`` over R ranks, each running
    ``fit`` with the same model and arguments) makes it JAX's
    ``fit(mesh=)``: each data rank takes its rows of every global batch of
    ``loop_cfg.batch_size`` (``batch_iterator``), the loss is the global
    batch's and the gradients are summed over the data axis
    (``training.make_train_step(group=)``), so the parameters and the
    AdamW state stay bitwise equal on every rank. Global rank 0 alone
    writes ``out_dir`` (checkpoints, ``log.txt``, TensorBoard), calls
    ``progress`` and runs ``pose_eval_fn``, whose dict it sends to the
    others; every rank waits
    for each write, reads ``checkpoint-last.npz`` to resume (``out_dir``
    must be one directory that every rank sees), and returns the same
    history (rank 0's clock in ``time_s``).

    ``pose_eval_fn(model, epoch) -> dict`` is the in-train pose evaluation
    hook (reference training.py:311-331 runs ``eval_pose_estimation``
    every ``pose_eval_freq`` epochs): it must return at least
    ``{"mean_ate": float | None}``; ``None`` marks a failed eval (the
    reference's ``bug`` flag) and never updates the best. Wire
    ``das3r_tpu_torch.eval.pose_eval.eval_pose_estimation`` here when
    real dataset roots are available.
    """
    dev = resolve_device(device)
    rank, ranks, group = _data_axis(mesh)
    if loop_cfg.batch_size % ranks:
        raise ValueError(f"batch_size {loop_cfg.batch_size} does not split "
                         f"over {ranks} data ranks")
    # every rank follows global rank 0, the one writer
    world = (dist.group.WORLD if mesh is not None and dist.is_initialized()
             else None)
    writer = collectives.index(world) == 0

    def write(fn, *args):
        """``fn(*args)`` on the writer; every rank returns once it is done."""
        if writer:
            fn(*args)
        collectives.barrier(world, dev, tag="stage1_files")

    model.to(dev)
    train_p, _ = training.split_params(model, freeze=train_cfg.freeze)
    opt = training.adamw_init(train_p)
    step_fn = training.make_train_step(model, train_cfg, group=group)

    start_epoch = 0
    best = float("inf")
    best_pose_ate = float("inf")
    last_path = os.path.join(loop_cfg.out_dir, "checkpoint-last.npz")
    if os.path.exists(last_path):   # auto-resume (training.py:189-192)
        start_epoch, best, best_pose_ate = _load_ckpt(last_path, train_p,
                                                      opt)
        if writer:
            progress(f"resumed from {last_path} at epoch {start_epoch}")
    # every rank resumes from the one file, or every rank raises
    span = collectives.all_reduce(
        torch.tensor([start_epoch, -start_epoch], device=dev), world,
        op=dist.ReduceOp.MAX, tag="stage1_resume")
    if int(span[0]) != -int(span[1]):
        raise RuntimeError(f"the ranks resume at epochs {-int(span[1])} to "
                           f"{int(span[0])}: {loop_cfg.out_dir} is not one "
                           f"directory that every rank sees")

    log_path = os.path.join(loop_cfg.out_dir, "log.txt")
    tb = None
    if writer:
        os.makedirs(loop_cfg.out_dir, exist_ok=True)
        # wandb-equivalent scalar stream (reference training.py:177-183,
        # 266-269): guarded TensorBoard next to the JSON lines
        tb = tblog.make_writer(os.path.join(loop_cfg.out_dir, "tb")
                               if loop_cfg.tensorboard else None)
    history = []
    global_step = start_epoch * max(
        1, len(train_dataset) // loop_cfg.batch_size)

    for epoch in range(start_epoch, loop_cfg.epochs):
        t0 = time.perf_counter()
        handles = []
        for img1, img2, batch in batch_iterator(
                train_dataset, loop_cfg.batch_size,
                seed=loop_cfg.seed + epoch, rank=rank, ranks=ranks):
            out = step_fn(train_p, opt, torch.as_tensor(img1, device=dev),
                          torch.as_tensor(img2, device=dev), batch.to(dev),
                          global_step)
            handles.append(out.total)
            global_step += 1
        train_loss = (float(torch.stack(handles).mean()) if handles
                      else float("nan"))

        entry = {"epoch": epoch, "train_loss": train_loss,
                 "train_lr": float(training.lr_at(float(global_step),
                                                  train_cfg)),
                 "time_s": round(time.perf_counter() - t0, 2)}
        # the losses are the global batches' on every rank; the clock is
        # rank 0's
        entry = collectives.broadcast_object(entry, world, dev,
                                             tag="stage1_log")

        ep1 = epoch + 1
        if test_datasets and ep1 % loop_cfg.eval_freq == 0:
            new_best = False
            for name, ds in test_datasets.items():
                stats = evaluate_stats(model, ds, loop_cfg.batch_size,
                                       max_batches=8, device=dev, mesh=mesh)
                entry[f"test_{name}_loss"] = stats["loss"]
                entry[f"test_{name}_loss_med"] = stats["loss_med"]
                # best over ALL test sets, on the MEDIAN loss
                # (training.py:307-308)
                if stats["loss_med"] < best:
                    best = stats["loss_med"]
                    new_best = True
            if new_best:
                write(_save_ckpt, os.path.join(loop_cfg.out_dir,
                                               "checkpoint-best.npz"),
                      train_p, opt, ep1, best, best_pose_ate)

        if (pose_eval_fn is not None and loop_cfg.pose_eval_freq > 0
                and ep1 % loop_cfg.pose_eval_freq == 0):
            # in-train pose eval (training.py:311-331), on rank 0 alone
            pose_stats = collectives.broadcast_object(
                pose_eval_fn(model, ep1) if writer else None, world, dev,
                tag="stage1_pose")
            ate = pose_stats.get("mean_ate")
            entry.update({f"pose_{k}": v for k, v in pose_stats.items()})
            if ate is not None and ate < best_pose_ate:
                best_pose_ate = ate
                if loop_cfg.save_best_pose:
                    write(_save_ckpt, os.path.join(
                        loop_cfg.out_dir, "checkpoint-best_pose.npz"),
                        train_p, opt, ep1, best, best_pose_ate)

        if loop_cfg.keep_freq and ep1 % loop_cfg.keep_freq == 0:
            # numbered keep-checkpoints (training.py:346-348)
            write(_save_ckpt, os.path.join(loop_cfg.out_dir,
                                           f"checkpoint-{ep1}.npz"),
                  train_p, opt, ep1, best, best_pose_ate)

        if ep1 % loop_cfg.save_freq == 0:
            write(_save_ckpt, last_path, train_p, opt, ep1, best,
                  best_pose_ate)

        write(_log_epoch, log_path, tb, entry)
        if writer:
            progress(f"epoch {epoch}: {entry}")
        history.append(entry)

    write(_save_ckpt, os.path.join(loop_cfg.out_dir, "checkpoint-final.npz"),
          train_p, opt, loop_cfg.epochs, best, best_pose_ate)
    tblog.close(tb)
    return model, history
