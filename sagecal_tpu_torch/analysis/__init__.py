"""Static analysis of the port (counterpart of ``sagecal_tpu/analysis/``).

- The lint gate: :mod:`.callgraph` parses every module with stdlib
  ``ast``, resolves imports, and computes the *device-reachable*
  functions from the port's roots (every ``instrumented(f, name=...)``
  wrap site and the ``forward``/``backward`` of every
  ``torch.autograd.Function``); :mod:`.cuda` reads the kernel sources in
  ``csrc/``; :mod:`.rules` holds one module per rule, the JAX package's
  IDs re-aimed at the port's own hazards (host reads on the solve path,
  float atomics and narrow arithmetic in the kernels, TF32, incomplete
  backwards, the fleet's protocol writes); :mod:`.engine` runs them and
  applies ``# torchlint: disable=RULE — reason`` pragmas; :mod:`.baseline`
  keeps the committed record (``lint_baseline.json``) of the report-only
  findings with their reasons.  Run it as ``python -m
  sagecal_tpu_torch.analysis [paths]`` or ``diag lint``.
- Protocol analysis: :mod:`.fsmodel`, a deterministic simulated
  filesystem, and :mod:`.protocol_check`, the explicit-state model
  checker that drives the port's own ``fleet/queue.py`` lease protocol
  and ``elastic/checkpoint.py::check_owner_lease`` over it.
- Kernel budgets: :mod:`.kernelmodel` and :mod:`.kernel_check`.

Stdlib only: importing the lint gate imports neither ``torch`` nor
anything of ``sagecal_tpu``, so it runs on any host.
"""

from sagecal_tpu_torch.analysis.engine import (  # noqa: F401
    Finding,
    analyze_paths,
)
from sagecal_tpu_torch.analysis.cli import main  # noqa: F401
