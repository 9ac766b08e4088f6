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
    "sagecal_tpu_torch.solvers.batched", "sagecal_tpu_torch.solvers.lbfgs",
    "sagecal_tpu_torch.serve", "sagecal_tpu_torch.serve.bucket",
    "sagecal_tpu_torch.tools.reproducibility",
    "sagecal_tpu_torch.ops.residual", "sagecal_tpu_torch.parallel.manifold",
    "sagecal_tpu_torch.core.segment", "sagecal_tpu_torch.tools.profile_kernel",
    "sagecal_tpu_torch.tools.kbisect", "sagecal_tpu_torch.tools.smoke_phases",
    "sagecal_tpu_torch.tools.probe_outputs",
    "sagecal_tpu_torch.ops.special", "sagecal_tpu_torch.ops.shapelets",
    "sagecal_tpu_torch.data.simsky", "sagecal_tpu_torch.solvers.rtr",
    "sagecal_tpu_torch.solvers.lbfgsb", "sagecal_tpu_torch.tools.rtr_profile",
    "sagecal_tpu_torch.obs.records", "sagecal_tpu_torch.obs.registry",
    "sagecal_tpu_torch.obs.events", "sagecal_tpu_torch.obs.quality",
    "sagecal_tpu_torch.ops.quality", "sagecal_tpu_torch.utils.ppm",
    "sagecal_tpu_torch.utils.profiling", "sagecal_tpu_torch.io.dataset",
    "sagecal_tpu_torch.io.memh5", "sagecal_tpu_torch.apps.config",
    "sagecal_tpu_torch.apps.fullbatch", "sagecal_tpu_torch.apps.cli",
    "sagecal_tpu_torch.tools.solve_outputs",
    "sagecal_tpu_torch.tools.telemetry_cost",
    "sagecal_tpu_torch.serve.request", "sagecal_tpu_torch.serve.cache",
    "sagecal_tpu_torch.serve.service", "sagecal_tpu_torch.serve.synthetic",
    "sagecal_tpu_torch.apps.serve", "sagecal_tpu_torch.elastic",
    "sagecal_tpu_torch.elastic.checkpoint", "sagecal_tpu_torch.obs.slo",
    "sagecal_tpu_torch.obs.shadow", "sagecal_tpu_torch.obs.drift",
    "sagecal_tpu_torch.obs.aggregate", "sagecal_tpu_torch.solvers.batchmode",
    "sagecal_tpu_torch.ops.transforms", "sagecal_tpu_torch.ops.beam",
    "sagecal_tpu_torch.ops.diagnostics", "sagecal_tpu_torch.obs.trace",
    "sagecal_tpu_torch.obs.flight", "sagecal_tpu_torch.parallel.consensus",
    "sagecal_tpu_torch.parallel.admm", "sagecal_tpu_torch.parallel.mesh",
    "sagecal_tpu_torch.parallel.spatial",
    "sagecal_tpu_torch.parallel.async_consensus",
    "sagecal_tpu_torch.apps.distributed", "sagecal_tpu_torch.apps.minibatch",
    "sagecal_tpu_torch.ops.diffuse", "sagecal_tpu_torch.parallel.federated",
    "sagecal_tpu_torch.apps.spatial", "sagecal_tpu_torch.apps.federated",
    "sagecal_tpu_torch.solvers.sharded", "sagecal_tpu_torch.parallel.multihost",
    "sagecal_tpu_torch.sky", "sagecal_tpu_torch.sky.tree",
    "sagecal_tpu_torch.sky.farfield", "sagecal_tpu_torch.sky.nearfield",
    "sagecal_tpu_torch.sky.predict", "sagecal_tpu_torch.refine",
    "sagecal_tpu_torch.refine.skyparams", "sagecal_tpu_torch.refine.objective",
    "sagecal_tpu_torch.refine.implicit", "sagecal_tpu_torch.refine.outer",
    "sagecal_tpu_torch.apps.widefield", "sagecal_tpu_torch.apps.refine",
    "sagecal_tpu_torch.elastic.faultinject", "sagecal_tpu_torch.fleet",
    "sagecal_tpu_torch.fleet.queue", "sagecal_tpu_torch.fleet.admission",
    "sagecal_tpu_torch.fleet.worker", "sagecal_tpu_torch.fleet.coordinator",
    "sagecal_tpu_torch.obs.timeline", "sagecal_tpu_torch.obs.capacity",
    "sagecal_tpu_torch.serve.aot_store", "sagecal_tpu_torch.apps.fleet",
    "sagecal_tpu_torch.fleet.stream", "sagecal_tpu_torch.apps.stream",
    "sagecal_tpu_torch.fleet.loadgen", "sagecal_tpu_torch.apps.load",
    "sagecal_tpu_torch.obs.ledger", "sagecal_tpu_torch.obs.replay",
    "sagecal_tpu_torch.obs.audit", "sagecal_tpu_torch.analysis",
    "sagecal_tpu_torch.analysis.fsmodel",
    "sagecal_tpu_torch.analysis.protocol_check", "sagecal_tpu_torch.io.fits",
    "sagecal_tpu_torch.tools._native", "sagecal_tpu_torch.tools.buildsky",
    "sagecal_tpu_torch.tools.restore", "sagecal_tpu_torch.tools.uvwriter",
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
