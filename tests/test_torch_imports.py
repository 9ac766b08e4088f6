"""The port stands alone: ``sagecal_tpu_torch`` imports neither JAX nor
anything of the JAX package ``sagecal_tpu``.

A fresh interpreter imports the port's modules and then looks at
``sys.modules``; a second check reads the sources, so an import hidden
inside a function body is caught too.
"""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "sagecal_tpu_torch")

MODULES = (
    "sagecal_tpu_torch.solvers.sage", "sagecal_tpu_torch.ops.rime_kernel",
    "sagecal_tpu_torch.io.skymodel", "sagecal_tpu_torch.io.solutions",
    "sagecal_tpu_torch.io.simulate", "sagecal_tpu_torch.interop",
    "sagecal_tpu_torch.kernels.build", "sagecal_tpu_torch.kernels.parity",
)


def _port_sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


@pytest.mark.parametrize("module", MODULES)
def test_import_leaves_jax_out_of_sys_modules(module):
    code = (
        "import sys, importlib\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'sagecal_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr


def test_sources_name_no_jax_import():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|sagecal_tpu)\b",
                     re.M)
    hits = [p for p in _port_sources() if pat.search(open(p).read())]
    assert hits == []
