"""Protocol analysis of the port (counterpart of the protocol half of
``sagecal_tpu/analysis/``): :mod:`.fsmodel`, a deterministic simulated
filesystem, and :mod:`.protocol_check`, the explicit-state model checker
that drives the port's own ``fleet/queue.py`` lease protocol and
``elastic/checkpoint.py::check_owner_lease`` over it.  The reference
package's JAX linter (jaxlint) lints JAX source; the port has none
(ROADMAP.md, "Not queued").  Stdlib only.
"""
