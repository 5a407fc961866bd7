"""Interactive viewer: port of ``das3r_tpu/gui``.

An in-process panel renderer (``viewer.ViewerScene``) and a
standard-library HTTP server (``server``) that streams its panels to a
browser with drag-to-orbit controls. Each panel is one render of the
scene on the card through the entry stream (kernels A and B)."""
from das3r_tpu_torch.gui.viewer import ViewerScene  # noqa: F401
