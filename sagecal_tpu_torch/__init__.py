"""sagecal_tpu_torch — the PyTorch/CUDA port of ``sagecal_tpu``.

The JAX package ``sagecal_tpu`` is the reference; this package mirrors
its module paths and function names (``core/types.py`` <->
``core/types.py``, ``solvers/sage.py::sagefit`` <-> ``sagefit``, ...) so
each counterpart is easy to find.  It imports ``torch`` and numpy only,
never ``jax`` or anything of ``sagecal_tpu``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (:mod:`sagecal_tpu_torch.device`).  The fused objective
of the joint LBFGS is a hand-written CUDA kernel pair
(``csrc/fused_cost.cu``), built from source at first use.

Importing this package imports nothing heavy: submodules are imported
where they are used.
"""
