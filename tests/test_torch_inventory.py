"""The port's map of the JAX package: every module of ``das3r_tpu`` has a
module of the same path in ``das3r_tpu_torch`` (or the renamed one of
``RENAMED_FILES``), and every public top-level name of a JAX module (a
function, a class or an assigned constant, not starting with ``_``) is a
top-level name of its port, under the same name or the one
``RENAMED_NAMES`` gives, unless ``NOT_PORTED`` says why not.

Both packages are parsed with ``ast``; neither is imported.
"""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "das3r_tpu", ROOT / "das3r_tpu_torch"

# JAX module -> its port, where the port's file has another name
RENAMED_FILES = {
    # the Pallas [T, K] window blend; the port's kernels D, E and their
    # plain versions are named for the window, not for Pallas
    "ops/splat/pallas_blend.py": "ops/splat/window_blend.py",
    # JAX reads collective bytes from compiled HLO; the port counts each
    # collective call as it is made
    "parallel/hlo_stats.py": "parallel/comm_stats.py",
}

# (JAX module, name) -> "port module::name" under another name
RENAMED_NAMES = {
    ("ops/splat/pallas_blend.py", "blend_tiles_pallas"):
        "ops/splat/window_blend.py::blend_tiles_window",
    ("ops/splat/pallas_blend.py", "N_ATTR"):
        "ops/splat/entry_blend.py::N_ATTR",
    ("parallel/hlo_stats.py", "collective_bytes"):
        "parallel/comm_stats.py::CommStats",      # its families() form
    ("predictor/searaft.py", "BasicBlockBN"):
        "predictor/searaft.py::BasicBlock",
}

# (JAX module, name) -> why the port has no counterpart
NOT_PORTED = {
    ("parallel/sharded.py", "batch_sharding"):
        "a JAX NamedSharding spec: the port's ranks hold their rows",
    ("parallel/sharded.py", "gauss_meta_spec"):
        "a JAX PartitionSpec: the port's ranks slice the Gaussians "
        "(sharded.shard_meta)",
    ("parallel/sharded.py", "gauss_state_spec"):
        "a JAX PartitionSpec: the port's ranks slice the state "
        "(sharded.shard_state)",
    ("parallel/sharded.py", "replicated"):
        "a JAX NamedSharding spec: every port rank holds its own copy",
    ("ops/splat/blend.py", "BlendInputs"):
        "the XLA blend's inputs: the port blends in kernels B and D, whose "
        "plain versions are its CPU form",
    ("ops/splat/blend.py", "blend_tiles"):
        "the XLA blend: the port's window path is window_blend, its plain "
        "version the CPU form",
    ("ops/splat/blend.py", "blend_tiles_sharded"):
        "the XLA blend under shard_map: the port's tile ranges are "
        "rasterize.window_range",
    ("models/croco/convert.py", "convert_torch_state_dict"):
        "a torch-state-dict converter: the port loads the reference state "
        "dict as it is",
    ("predictor/raft.py", "convert_raft_state_dict"):
        "a torch-state-dict converter: the port loads the reference state "
        "dict as it is",
    ("predictor/searaft.py", "convert_searaft_state_dict"):
        "a torch-state-dict converter: the port loads the reference state "
        "dict as it is",
    ("predictor/training.py", "merge_params"):
        "JAX splits its params tree in two and merges it for the forward; "
        "the port's trainable tensors are the model's own",
    ("ops/splat/entry_blend.py", "BLOCK"):
        "the Pallas kernel's entries per grid step; kernels B and C tile "
        "in csrc/",
    ("ops/splat/entry_blend.py", "CHUNK"):
        "the Pallas kernel's lane pass; the port's chunk is "
        "binning.CHUNK",
    ("ops/splat/entry_blend.py", "PACK"):
        "the Pallas kernel's (8, 128) HBM row packing; the CUDA kernels "
        "write [T, 3, P] and [T, 1, P]",
    ("parallel/hlo_stats.py", "COLLECTIVE_OPS"):
        "the HLO op names JAX's parser matches",
    ("parallel/hlo_stats.py", "shape_bytes"):
        "parses an HLO shape token",
    ("parallel/hlo_stats.py", "total_collective_bytes"):
        "a sum over HLO text; the port sums CommStats.families()",
    ("predictor/raft.py", "InstanceNorm"):
        "a flax layer: the port uses torch's nn.InstanceNorm2d "
        "(raft.make_norm)",
    ("predictor/raft.py", "FrozenBatchNorm"):
        "a flax layer: the port uses torch's nn.BatchNorm2d in eval mode "
        "(raft.make_norm)",
    ("predictor/raft.py", "bilinear_lookup"):
        "JAX's correlation sampler; the port's pyramid_lookup samples with "
        "grid_sample",
}


def public_names(path: Path) -> set:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def jax_modules() -> list:
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py")
                  if "__pycache__" not in p.parts)


def port_file(module: str) -> Path:
    return PORT_PKG / RENAMED_FILES.get(module, module)


@pytest.mark.parametrize("module", jax_modules())
def test_every_public_name_has_a_port(module):
    port = port_file(module)
    assert port.exists(), f"{module}: no port file {port}"
    have = public_names(port)
    missing = []
    for name in sorted(public_names(JAX_PKG / module)):
        if (module, name) in NOT_PORTED:
            assert name not in have, f"{module}::{name} is ported now"
            continue
        target = RENAMED_NAMES.get((module, name))
        if target:
            path, other = target.split("::")
            assert other in public_names(PORT_PKG / path), target
        elif name not in have:
            missing.append(name)
    assert not missing, f"{module}: no port of {missing}"


def test_the_exceptions_name_real_jax_names():
    """Every exception names a public name of its JAX module, so the
    lists shrink as the JAX package does."""
    for module, name in list(NOT_PORTED) + list(RENAMED_NAMES):
        assert name in public_names(JAX_PKG / module), (module, name)
    for module, port in RENAMED_FILES.items():
        assert (JAX_PKG / module).exists() and (PORT_PKG / port).exists()
        assert not (PORT_PKG / module).exists(), module
