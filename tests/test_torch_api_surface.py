"""The port's public surface against the JAX package's: every public name
that a module or ``__init__`` of ``detr_tensorflow_tpu`` defines or imports
(read with ``ast``, so JAX is not needed for the JAX side) has a same-named
attribute in the port's module at the same path, the port's module imported
(a subpackage counts as an attribute of its package).

The exceptions are ``ALLOWED``, each with its reason, and the one JAX
package with no port path, ``ops/pallas`` (``NO_PORT_PATH``). Stale
exceptions fail too: every allowed name must be public in JAX and absent
from the port, so the list shrinks as the port grows.
"""

import ast
import importlib
import os

import pytest
from torch_ranks import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "detr_tensorflow_tpu")

# JAX module path (relative, without ".py") -> {name: reason}.
_DO_NOT_PORT = "ROADMAP.md's 'Do not port': it works around the TPU stack"
_TYPE_ALIAS = "a type alias of JAX's annotations, not an API"
ALLOWED = {
    "utils/layouts": {"verified_put": _DO_NOT_PORT, "Pytree": _TYPE_ALIAS},
    "models/resnet": {
        "StemConv": "ROADMAP.md's 'Do not port': the TPU's space-to-depth stem",
        "Dtype": _TYPE_ALIAS},
    "models/transformer": {
        "resolve_attn_impl": "ROADMAP.md's 'Do not port': the TPU crossover; the port's "
                             "attn_impl='auto' picks by device",
        "AUTO_PALLAS_MIN_KEYS": "resolve_attn_impl's TPU crossover constant ('Do not port')",
        "AUTO_PALLAS_MIN_KEYS_TRAIN": "resolve_attn_impl's TPU crossover constant ('Do not "
                                      "port')",
        "Dtype": _TYPE_ALIAS},
    "train": {"TrainState": "ROADMAP.md's 'Do not port': the port's Trainer holds the state",
              "create_train_state": "ROADMAP.md's 'Do not port': Trainer(model, config)"},
    "train/engine": {
        "TrainState": "ROADMAP.md's 'Do not port': the port's Trainer holds the state",
        "create_train_state": "ROADMAP.md's 'Do not port': Trainer(model, config)",
        "Array": _TYPE_ALIAS},
    "models/weights": {
        "download_weights": "ROADMAP.md's 'Do not port': nothing can be fetched; load_weights "
                            "reads local files",
        "verify_checksum": "ROADMAP.md's 'Do not port': goes with download_weights"},
    "parallel/multihost": {
        "global_batch": "documented deviation: under DDP each rank keeps its local batch "
                        "(parallel/multihost.py)",
        "Pytree": _TYPE_ALIAS},
    "train/optimizers": {
        "clip_by_leaf_norm": "replaced by name: the in-place clip_by_leaf_norm_ on the "
                             "gradients",
        "scale_updates_by_lr": "replaced: an optax transform; the port's optimizer applies "
                               "each group's rate"},
    "parallel": {"stack_stage_params": "replaced: JAX stacks stage parameters for its SPMD "
                                       "scan; a port rank builds only its stages' layers"},
    "parallel/pp": {"stack_stage_params": "replaced: JAX stacks stage parameters for its SPMD "
                                          "scan; a port rank builds only its stages' layers",
                    "Pytree": _TYPE_ALIAS},
    "data": {"prefetch_to_device": "replaced by name: Trainer.prefetch"},
    "data/pipeline": {"prefetch_to_device": "replaced by name: Trainer.prefetch"},
    "parallel/detr_1f1b": {"Pytree": _TYPE_ALIAS},
    "models/detr": {"Dtype": _TYPE_ALIAS},
    "models/layers": {"Dtype": _TYPE_ALIAS},
    "models/segmentation": {"Dtype": _TYPE_ALIAS},
    "models/quantized": {"Tree": _TYPE_ALIAS},
    "models/position": {"Array": _TYPE_ALIAS},
    "inference": {"Array": _TYPE_ALIAS},
    "ops/boxes": {"Array": _TYPE_ALIAS},
    "ops/losses": {"Array": _TYPE_ALIAS},
    "ops/matcher": {"Array": _TYPE_ALIAS},
    "ops/maxpool": {"Array": _TYPE_ALIAS},
}
# JAX packages whose path the port does not have, with the reason.
NO_PORT_PATH = {
    "ops/pallas": "the Pallas TPU kernels: each one's hand-written CUDA counterpart sits "
                  "beside its wrapper in ops/ (PERF.md section 6 maps them), and a Mosaic "
                  "kernel's entry point is not an API the port mirrors",
}


def jax_modules():
    """Relative module paths of the JAX package ("" for its __init__)."""
    out = []
    for root, _, files in os.walk(JAX_ROOT):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), JAX_ROOT)[:-3].replace(os.sep, "/")
                out.append("" if rel == "__init__" else rel.removesuffix("/__init__"))
    return sorted(out)


def public_names(rel: str) -> set:
    """Names a JAX module defines at its top level, or (an ``__init__``)
    imports from the package, without a leading underscore."""
    package = rel == "" or os.path.isdir(os.path.join(JAX_ROOT, rel))
    path = os.path.join(JAX_ROOT, rel, "__init__.py") if package else os.path.join(
        JAX_ROOT, rel + ".py")
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, ast.ImportFrom) and node.level > 0 and package:
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


def port_has(rel: str, name: str) -> bool:
    module_name = "detr_tensorflow_tpu_torch" + ("." + rel.replace("/", ".") if rel else "")
    try:
        module = importlib.import_module(module_name)
    except ModuleNotFoundError:
        return False
    if hasattr(module, name):
        return True
    try:  # a subpackage or submodule not imported by the package
        importlib.import_module(f"{module_name}.{name}")
        return True
    except ModuleNotFoundError:
        return False


def _covered(rel):
    return not any(rel == p or rel.startswith(p + "/") for p in NO_PORT_PATH)


def _group(rel):
    """The subpackage a module belongs to; "<top>" for the package's own
    modules and its ``__init__``."""
    first = rel.split("/")[0]
    return first if first and os.path.isdir(os.path.join(JAX_ROOT, first)) else "<top>"


@pytest.mark.parametrize("subpackage", sorted({_group(m) for m in jax_modules()}))
def test_every_jax_public_name_has_a_port_counterpart(subpackage):
    modules = [m for m in jax_modules() if _covered(m) and _group(m) == subpackage]
    assert modules
    missing = [f"{rel or '<package>'}: {name}" for rel in modules
               for name in sorted(public_names(rel))
               if name not in ALLOWED.get(rel, {}) and not port_has(rel, name)]
    assert not missing, "public JAX names without a port counterpart:\n" + "\n".join(missing)


def test_allowed_names_are_jax_public_and_absent_from_the_port():
    modules = set(jax_modules())
    for rel, names in ALLOWED.items():
        assert rel in modules, rel
        for name, reason in names.items():
            assert reason and name in public_names(rel), (rel, name)
            assert not port_has(rel, name), f"{rel}.{name} is ported: drop it from ALLOWED"
    for rel in NO_PORT_PATH:
        assert rel in modules and not port_has(os.path.dirname(rel), os.path.basename(rel))
