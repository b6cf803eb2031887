"""Rules the port keeps: no file of ray_lightning_tpu_torch/, nor
chip_smoke.py, imports JAX or anything of the JAX package (the machine with
the card has no JAX), and importing the package builds nothing."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "ray_lightning_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]
BANNED = ("jax", "jaxlib", "flax", "optax", "ray_lightning_tpu", "ml_dtypes")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_no_jax(path):
    bad = [m for m in _imported_roots(path)
           if m.split(".")[0] in BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_without_jax_or_a_build():
    """A fresh interpreter imports every module of the port with JAX made
    unimportable, and no kernel library is loaded or built by the import;
    nor is the native runtime library (``runtime/native/``), and no zygote
    or other process is started."""
    code = (
        "import sys, importlib, pkgutil, os\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ray_lightning_tpu'] = None\n"
        "import ray_lightning_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from ray_lightning_tpu_torch import kernels\n"
        "assert not kernels._LIBS, kernels._LIBS\n"
        "assert len(kernels.KERNELS) == 6, kernels.KERNELS\n"
        "from ray_lightning_tpu_torch.runtime import api, native\n"
        "assert native._lib is None and not native._build_failed\n"
        "assert not any('librlt_shm' in l for l in open('/proc/self/maps'))\n"
        "assert api._state.zygote is None and not api._state.initialized\n"
        "kids = f'/proc/self/task/{os.getpid()}/children'\n"
        "assert not os.path.exists(kids) or not open(kids).read().split()\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("module", ["ray_lightning_tpu_torch.serving.replica",
                                    "ray_lightning_tpu_torch.cli"])
def test_fleet_and_cli_import_without_a_thread_or_process(module):
    """The fleet's module and the command line import with JAX blocked and
    build, load, start and parse nothing: one thread, no child process, no
    kernel library, no runtime, no zygote."""
    code = (
        "import sys, os, threading, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ray_lightning_tpu'] = None\n"
        f"mod = importlib.import_module({module!r})\n"
        "from ray_lightning_tpu_torch import kernels\n"
        "from ray_lightning_tpu_torch.runtime import api, native\n"
        "assert not kernels._LIBS and native._lib is None\n"
        "assert api._state.zygote is None and not api._state.initialized\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "kids = f'/proc/self/task/{os.getpid()}/children'\n"
        "assert not os.path.exists(kids) or not open(kids).read().split()\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code, "--not-an-argument"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
