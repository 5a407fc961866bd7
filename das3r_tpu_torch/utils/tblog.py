"""Optional TensorBoard scalar logging (port of ``das3r_tpu/utils/tblog.py``).

The reference guards TensorBoard behind an import flag
(train_gui.py:33-37) and logs train/test scalars in ``training_report``.
Here the writer is ``torch.utils.tensorboard``'s; when it cannot be made
(no log dir, or the ``tensorboard`` package is missing) the writer is
``None`` and logging falls back to the plain-text logs.
"""
from __future__ import annotations


def make_writer(logdir: str | None):
    """SummaryWriter for ``logdir``, or None (no dir / tensorboard absent)."""
    if not logdir:
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(logdir)


def scalars(writer, step: int, **values) -> None:
    if writer is None:
        return
    for k, v in values.items():
        if v is not None:
            writer.add_scalar(k.replace("__", "/"), float(v), step)


def close(writer) -> None:
    """Flush and close (the writer buffers scalars on a thread with a
    2-minute flush interval: short runs would lose them)."""
    if writer is not None:
        writer.flush()
        writer.close()
