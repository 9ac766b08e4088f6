"""Hierarchical sky prediction: tree-clustered far-field coherencies
for wide fields (counterpart of ``sagecal_tpu/sky/``).

- :func:`~sagecal_tpu_torch.sky.predict.predict_coherencies_hier`: the
  differentiable variant of ``ops.rime.predict_coherencies`` with an
  (order, theta) error knob;
- :func:`~sagecal_tpu_torch.sky.predict.build_hier_plan` /
  :class:`~sagecal_tpu_torch.sky.predict.HierPlan`: the host-built
  routing reused across calls;
- :func:`~sagecal_tpu_torch.sky.predict.sampled_error_estimate`: the
  a-posteriori check the quality watchdog gauges;
- :func:`~sagecal_tpu_torch.sky.farfield.apriori_rel_bound`: the
  analytic truncation bound;
- :func:`~sagecal_tpu_torch.sky.tree.build_source_tree` /
  :func:`~sagecal_tpu_torch.sky.tree.partition_by_tree`: the host-side
  tree and the effective-cluster collapse of the widefield app.
"""

from sagecal_tpu_torch.sky.farfield import apriori_rel_bound
from sagecal_tpu_torch.sky.predict import (
    HierPlan,
    build_hier_plan,
    gather_sources,
    predict_coherencies_hier,
    sampled_error_estimate,
)
from sagecal_tpu_torch.sky.tree import (
    SourceTree,
    build_source_tree,
    partition_by_tree,
)

__all__ = [
    "HierPlan",
    "SourceTree",
    "apriori_rel_bound",
    "build_hier_plan",
    "build_source_tree",
    "gather_sources",
    "partition_by_tree",
    "predict_coherencies_hier",
    "sampled_error_estimate",
]
