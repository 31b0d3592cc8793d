"""The port's own configuration against the JAX package's, and the port's
independence from the JAX package.

- ``michigan_tpu_torch/config.py`` is a copy of ``michigan_tpu/config.py``:
  the same Options fields with the same defaults, and the three parsers give
  equal Options for their defaults and for chip_smoke.py's flag sets;
- no module of ``michigan_tpu_torch``, and nothing chip_smoke.py imports,
  loads a module of the JAX package (or jax): with ``michigan_tpu`` and jax
  blocked in a fresh interpreter, every module imports.
"""

import ast
import dataclasses
import os
import pkgutil
import subprocess
import sys

import pytest

import chip_smoke
import michigan_tpu_torch
from michigan_tpu import config as jax_config
from michigan_tpu_torch import config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARSERS = ["train_options", "test_options", "demo_options"]


def fields(opt):
    return {f.name: getattr(opt, f.name) for f in dataclasses.fields(opt)}


def test_options_fields_and_defaults_equal_the_jax_packages():
    want = {f.name: (f.type, f.default) for f in dataclasses.fields(jax_config.Options)}
    got = {f.name: (f.type, f.default) for f in dataclasses.fields(config.Options)}
    assert got == want


@pytest.mark.parametrize("parser", PARSERS)
def test_parser_defaults_equal_the_jax_packages(parser):
    assert fields(getattr(config, parser)([])) == fields(getattr(jax_config, parser)([]))


@pytest.mark.parametrize("parser,argv", [
    ("test_options", chip_smoke.FLAGS + ["--seed", "0"]),
    ("demo_options", chip_smoke.STROKE_FLAGS + ["--seed", "0"]),
    ("train_options", chip_smoke.TRAIN_FLAGS + ["--batchSize", "8", "--crop_size", "512",
                                                "--load_size", "512", "--seed", "0"]),
])
def test_chip_smoke_flags_parse_as_in_the_jax_package(parser, argv):
    got = getattr(config, parser)(list(argv))
    assert fields(got) == fields(getattr(jax_config, parser)(list(argv)))
    assert got.generator_input_size() == getattr(jax_config, parser)(list(argv)) \
        .generator_input_size()


def jax_package_imports(path):
    """Import statements of a source file that name the JAX package."""
    tree = ast.parse(open(path).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return [n for n in names if n.split(".")[0] in ("michigan_tpu", "jax", "jaxlib", "flax")]


def test_no_source_of_the_port_names_the_jax_package():
    root = os.path.dirname(michigan_tpu_torch.__file__)
    found = {}
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs, git-ignored
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                if jax_package_imports(path):
                    found[os.path.relpath(path, REPO)] = jax_package_imports(path)
    assert not found
    assert not jax_package_imports(os.path.join(REPO, "chip_smoke.py"))


BLOCKED = """
import importlib, pkgutil, sys, types
for name in ("jax", "jaxlib", "flax", "michigan_tpu"):
    sys.modules[name] = None
def stand_in(attr):
    if attr.startswith("__"):
        raise AttributeError(attr)
    return type(attr, (), {})
try:
    import PyQt5.QtWidgets
except ImportError:  # the editor's module imports PyQt5: stand-in classes
    for name in ("PyQt5", "PyQt5.QtCore", "PyQt5.QtGui", "PyQt5.QtWidgets"):
        sys.modules[name] = types.ModuleType(name)
        sys.modules[name].__getattr__ = stand_in
import michigan_tpu_torch
for info in pkgutil.walk_packages(michigan_tpu_torch.__path__, "michigan_tpu_torch."):
    if not info.name.endswith("__main__"):
        importlib.import_module(info.name)
exec(compile(sys.argv[1], "chip_smoke.py's imports", "exec"))
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split(".")[0] in ("jax", "jaxlib", "flax", "michigan_tpu"))
assert not leaked, leaked
print("ok")
"""


def test_the_port_and_chip_smoke_import_without_the_jax_package():
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    imports = [ast.unparse(n) for n in ast.walk(tree)
               if isinstance(n, (ast.Import, ast.ImportFrom))
               and getattr(n, "module", None) != "__future__"]
    assert sum("michigan_tpu_torch" in i for i in imports) >= 10
    modules = [i.name for i in pkgutil.walk_packages(michigan_tpu_torch.__path__,
                                                     "michigan_tpu_torch.")]
    assert "michigan_tpu_torch.config" in modules
    assert {"michigan_tpu_torch.serving.session", "michigan_tpu_torch.serving.export",
            "michigan_tpu_torch.evaluate", "michigan_tpu_torch.models.inception",
            "michigan_tpu_torch.parallel.dist",
            "michigan_tpu_torch.tools.replica_objective",
            "michigan_tpu_torch.training.diagnostics", "michigan_tpu_torch.utils.visualizer",
            "michigan_tpu_torch.utils.colormap", "michigan_tpu_torch.utils.coco",
            "michigan_tpu_torch.native", "michigan_tpu_torch.demo.qt_ui"} <= set(modules)
    proc = subprocess.run([sys.executable, "-c", BLOCKED, "\n".join(imports)], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")


SMALL = chip_smoke.FLAGS + ["--crop_size", "64", "--load_size", "64", "--ngf", "8"]


@pytest.mark.parametrize("entry", ["MichiGANModel", "DemoEngine"])
def test_entry_points_take_the_card_unless_asked_for_the_cpu(entry):
    """The default device is the card: without CUDA, placing the nets
    fails instead of falling back to the CPU; device="cpu" runs there."""
    import torch

    from michigan_tpu_torch.demo.engine import DemoEngine
    from michigan_tpu_torch.model import MichiGANModel

    opt = config.test_options(SMALL)
    if entry == "MichiGANModel":
        assert MichiGANModel(opt).device == torch.device("cuda")
        make = lambda *device: MichiGANModel(opt, *device).init_weights(0)
    else:
        make = lambda *device: DemoEngine(opt, *device)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            make()
    make("cpu")


def test_cal_orientation_raises_without_cuda_unless_asked_for_the_cpu(tmp_path):
    import torch

    from michigan_tpu_torch import cal_orientation

    if torch.cuda.is_available():
        pytest.skip("the error needs a machine without CUDA")
    args = ["--image_path", os.path.join(REPO, "datasets/FFHQ_single/val_images/67172.jpg"),
            "--hairmask_path", os.path.join(REPO, "datasets/FFHQ_single/val_labels/67172.png"),
            "--orientation_root", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA"):
        cal_orientation.main(args)
    with pytest.raises(RuntimeError, match="CUDA"):
        cal_orientation.main(args + ["--gpu_ids", "0"])
    assert not os.listdir(tmp_path)
