"""The calibration fleet (counterpart of ``sagecal_tpu/fleet``): many
serve workers draining one shared request queue.

- :mod:`~sagecal_tpu_torch.fleet.queue` — the shared work queue: one item
  file per request, lease epochs published atomically, expiry and
  stealing, done and failure markers;
- :mod:`~sagecal_tpu_torch.fleet.admission` — admission control on the
  ``obs/slo.py`` burn rates: shed or degrade on overload;
- :mod:`~sagecal_tpu_torch.fleet.worker` — the claim-admit-solve-complete
  loop over the calibration service;
- :mod:`~sagecal_tpu_torch.fleet.coordinator` — seeds the queue, spawns
  and watches the workers, reports the merged fleet view.

The stream calibrator and the load generator wait for ROADMAP.md's A9b.
"""

from sagecal_tpu_torch.fleet.queue import (  # noqa: F401
    LeaseLost, LeaseQueue, WorkItem,
)
