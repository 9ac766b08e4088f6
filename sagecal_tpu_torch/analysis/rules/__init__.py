"""Rule registry: one module per rule (counterpart of
``sagecal_tpu/analysis/rules/``).

The rule IDs are the JAX package's, each re-aimed at the port's own
hazards, so a reader finds each counterpart by its number:

- JL001 ``if``/``while``/``assert`` on a tensor in device-reachable code
  (an implicit ``.item()``), report-only;
- JL002 host reads in device-reachable code, report-only: the baseline
  is the static list of the places where the EM waits on the card;
- JL004 unconditional 64-bit torch dtypes in ``ops/``, ``solvers/``,
  ``parallel/``;
- JL005 data-dependent shapes (``nonzero``, ``unique``, boolean masks)
  in device-reachable code, report-only: each waits on the card;
- JL006 ``torch.distributed`` collectives outside ``parallel/`` and
  ``solvers/sharded.py``;
- JL008, JL010, JL016 the reference's protocol rules (atomic protocol
  writes, injectable clocks, single-write JSONL appends), unchanged,
  over ``fleet/``, ``elastic/``, ``obs/``, ``serve/``;
- JL009 ``pickle.load``/``torch.load`` outside a loader gated by a
  header or sidecar (``serve/aot_store.py``'s pattern);
- JL012 mixed-float-family comparisons, tolerance-less closeness
  checks, report-only;
- JL013 ``torch.autograd.Function`` backward completeness;
- JL014 the kernel numerics contract: no float atomics and no narrow
  (bf16/half) arithmetic in ``csrc/*.cu``, no TF32 and no atomic
  accumulation (``index_add_``...) in Python;
- JL900 unused imports, report-only.

JL003, JL007, JL011 and JL015 have no counterpart (:data:`NO_COUNTERPART`
says why); ``--rules`` naming one exits 2 with that reason.  The port
adds no rule ID the JAX package lacks.  Adding a rule = add a module
here, list its class in ``all_rules``, give it fire and clean cases in
``tests/test_torch_lint.py``.
"""

from __future__ import annotations

from typing import List, Type

from sagecal_tpu_torch.analysis.engine import Rule
from sagecal_tpu_torch.analysis.rules.jl001 import TensorControlFlow
from sagecal_tpu_torch.analysis.rules.jl002 import HostRead
from sagecal_tpu_torch.analysis.rules.jl004 import DtypePolicy
from sagecal_tpu_torch.analysis.rules.jl005 import DataDependentShape
from sagecal_tpu_torch.analysis.rules.jl006 import StrayCollective
from sagecal_tpu_torch.analysis.rules.jl008 import NonAtomicProtocolWrite
from sagecal_tpu_torch.analysis.rules.jl009 import UnguardedLoad
from sagecal_tpu_torch.analysis.rules.jl010 import RawClockInLeaseLogic
from sagecal_tpu_torch.analysis.rules.jl012 import MixedDtypeComparison
from sagecal_tpu_torch.analysis.rules.jl013 import BackwardCompleteness
from sagecal_tpu_torch.analysis.rules.jl014 import KernelNumerics
from sagecal_tpu_torch.analysis.rules.jl016 import BufferedJsonlAppend
from sagecal_tpu_torch.analysis.rules.jl900 import DeadImport

NO_COUNTERPART = {
    "JL003": "PyTorch has no trace-time static arguments, so there is no "
             "undeclared static to recompile on",
    "JL007": "PyTorch has no buffer donation: an entry cannot leave a "
             "carry undonated",
    "JL011": "PyTorch has no buffer donation: no buffer is read after "
             "a call consumed it",
    "JL015": "the port's kernels are CUDA C++ launched with explicit "
             "grids; there is no BlockSpec to mis-shape",
}


def all_rules() -> List[Type[Rule]]:
    return [
        TensorControlFlow,
        HostRead,
        DtypePolicy,
        DataDependentShape,
        StrayCollective,
        NonAtomicProtocolWrite,
        UnguardedLoad,
        RawClockInLeaseLogic,
        MixedDtypeComparison,
        BackwardCompleteness,
        KernelNumerics,
        BufferedJsonlAppend,
        DeadImport,
    ]
